// Batch JPEG decode on the GPU with nvJPEG, for the host data pipeline.
//
// Replaces no TPU kernel: it is the port's counterpart of the JAX
// package's native decode worker, native/jpeg_decoder.cpp (libjpeg on a C++
// thread pool, bound by mvfnet_tpu/data/native_io.py), whose API it
// mirrors: decode one JPEG, or a clip's JPEGs in one call, full size, into
// HWC uint8 BGR buffers that the caller owns, with a status per image. The
// header probe is Python's (mvfnet_tpu_torch/data/native_io.py parses the
// SOF segment), so the caller sizes every buffer before the call.
//
// nvJPEG decodes each image to its planes (Y, and Cb and Cr at the image's
// chroma subsampling); ycc_to_bgr, the kernel here, turns them into BGR as
// libjpeg does by default, so that frames agree with cv2.imdecode and the
// JAX worker to the IDCT's rounding: libjpeg-turbo's "fancy" (triangle)
// chroma upsampling for 4:2:0, 4:2:2 and 4:4:0 (jdsample.c: 3/4 of the
// nearer chroma sample and 1/4 of the further, with its rounding biases and
// the image's edge samples repeated; box replication for other factors and
// for chroma 2 samples wide or less), then its fixed-point YCbCr to BGR
// (jdcolor.c, 16 fraction bits). nvJPEG's own BGR output upsamples chroma
// otherwise: it differed from cv2 by 1.7 levels on average at 4:2:0 and by
// 8.4 on a 37 x 53 frame (tools/jpeg_kinds.py on the H100, nvJPEG 12.4).
//
// What bounds it: a frame's entropy (Huffman) decode, which the default
// (hybrid) backend runs on the calling host thread (the JPEG engines'
// hardware backend would not: nvJPEG refuses it on the card's machine,
// mvf_nvjpeg_backend_status); the IDCT and the conversion run on the card.
// The design therefore keeps the host thread on Huffman decoding alone: one
// nvjpegDecodeBatched call for a whole clip on a stream of this context,
// the planes side by side in one device buffer, one ycc_to_bgr launch over
// all of the call's frames into a second, one device-to-host copy of all
// the frames into pinned staging memory, one stream synchronisation, then a
// host copy into each caller buffer. A context (handle, JPEG states,
// stream, device and pinned buffers, grown on demand and kept) serves one
// thread at a time; the Python side keeps a pool of them, so the loader's
// threads decode at once without a shared lock.
//
// ycc_to_bgr reads 1.5 bytes and writes 3 a pixel at 4:2:0 and does some
// 20 integer operations a pixel: it is bound by bytes (a call of 80 frames
// of 455 x 256, 41.9 MB, takes 12.5 us at 3.35 TB/s). A launch a frame
// left a launch of under one wave, mostly ramp and tail, 2.4 us of device
// time a frame (tools/ycc_bench.py, 6.6% of the bound). So one launch
// converts every frame of a call, from a table of frames copied ahead of
// it: a frame is a column of the grid, and a block a tile of 128 x 16
// pixels of it (x 32 where chroma is halved vertically). A block stages its
// tile's chroma, with the neighbours fancy upsampling reads and the image's
// edge samples repeated, in shared memory in 16-byte loads; a thread
// converts a run of 8 pixels of one row, or of two rows that share their
// chroma rows, reading Y in a 16-byte load at any alignment (two aligned
// words and a funnel shift) and its chroma samples once into registers,
// and stages its BGR bytes in shared memory; then a warp a row writes the
// tile's rows out in aligned 16-byte stores, whole 128-byte lines but at
// the row's ends.
//
// Built by nvcc with -lnvjpeg (mvfnet_tpu_torch/ops/_cuda.py links it and
// puts the toolkit's lib64 on the library's run path). Every function
// returns 0 on success, an nvjpegStatus_t (> 0) from nvJPEG, or
// -cudaError_t from the CUDA runtime, and writes the failing call into
// msg.

#include <cuda_runtime.h>
#include <library_types.h>
#include <nvjpeg.h>

#include <cstdio>
#include <algorithm>
#include <cstring>
#include <new>
#include <vector>

namespace {

// ------------------------------------------------------------- the kernel

// One frame of a launch, as the host lays it out (describe): its planes,
// of pitch w and cw (cb and cr null for grayscale), its BGR output, its
// kind, its tiles across and in all.
struct Frame {
  const unsigned char* y;
  const unsigned char* cb;
  const unsigned char* cr;
  unsigned char* out;
  int w, h, cw, ch;
  int kind, tiles_x, tiles;
};

// The upsampling each frame takes: grayscale, box replication at
// (hf, vf), or libjpeg-turbo's fancy upsampling at 2x1, 2x2 and 1x2.
enum Kind {
  kGray, kBox11, kBox21, kBox22, kBox41, kBox42, kFancy21, kFancy22, kFancy12
};

// A block converts a tile of one frame: 16 runs of 8 pixels across (128
// columns) by 16 units, a unit being one row, or two for chroma halved
// vertically (the two rows share their chroma rows); a thread converts a
// unit of one run. (Runs of 16 pixels, or 32 units, took more registers a
// thread and fewer threads an SM, and ran slower; tools/ycc_bench.py.)
constexpr int kRun = 8, kRuns = 16, kUnits = 16;
constexpr int kTileW = kRun * kRuns;
constexpr int kThreads = kRuns * kUnits;
constexpr int kStagePitch = 3 * kTileW + 16;   // a row's BGR, and a word
constexpr int kChromaBytes = (kUnits + 2) * kTileW;
// a warp writes a tile's row in one pass of 16-byte stores
static_assert(3 * kTileW <= 32 * 16, "a tile row takes one warp's stores");

// Bytes s .. s + 15 of the 32 bytes lo, hi (s = 0..15, any thread's own).
__device__ __forceinline__ uint4 funnel16(uint4 lo, uint4 hi, int s) {
  const unsigned v[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
  unsigned u[7], t[5];
#pragma unroll
  for (int j = 0; j < 7; ++j) u[j] = (s & 4) ? v[j + 1] : v[j];
#pragma unroll
  for (int j = 0; j < 5; ++j) t[j] = (s & 8) ? u[j + 2] : u[j];
  const int r = (s & 3) * 8;
  return make_uint4(__funnelshift_r(t[0], t[1], r),
                    __funnelshift_r(t[1], t[2], r),
                    __funnelshift_r(t[2], t[3], r),
                    __funnelshift_r(t[3], t[4], r));
}

// The 16 bytes from p, at any alignment, of which the first n (1..16) are
// wanted: only the aligned 16-byte words that hold a wanted byte are read.
__device__ __forceinline__ uint4 load16(const unsigned char* p, int n) {
  const size_t a = reinterpret_cast<size_t>(p);
  const uint4* q = reinterpret_cast<const uint4*>(a & ~size_t(15));
  const int s = static_cast<int>(a & 15);
  const uint4 lo = __ldg(q);
  const uint4 hi = s + n > 16 ? __ldg(q + 1) : make_uint4(0, 0, 0, 0);
  return funnel16(lo, hi, s);
}

// Four values clamped to 0..255, as the bytes of a word (e0 lowest).
__device__ __forceinline__ unsigned pack4(int e0, int e1, int e2, int e3) {
  unsigned hi, d;
  asm("cvt.pack.sat.u8.s32.b32 %0, %1, %2, %3;"
      : "=r"(hi) : "r"(e3), "r"(e2), "r"(0u));
  asm("cvt.pack.sat.u8.s32.b32 %0, %1, %2, %3;"
      : "=r"(d) : "r"(e1), "r"(e0), "r"(hi));
  return d;
}

__device__ __forceinline__ int byte_of(const unsigned* w, int i) {
  return (w[i >> 2] >> (8 * (i & 3))) & 255;
}

// N staged chroma samples from p in shared memory (in 4-byte words where
// p is 4-byte aligned, ALIGNED).
template <bool ALIGNED, int N>
__device__ __forceinline__ void window(const unsigned char* p, int (&c)[N]) {
  if constexpr (ALIGNED) {
    unsigned w[(N + 3) / 4];
#pragma unroll
    for (int k = 0; k < (N + 3) / 4; ++k)
      w[k] = reinterpret_cast<const unsigned*>(p)[k];
#pragma unroll
    for (int i = 0; i < N; ++i) c[i] = byte_of(w, i);
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) c[i] = p[i];
  }
}

// A run's 3 * kRun BGR bytes (o, in words) into the stage at dst (8-byte
// aligned: 3 * kRun * j into a row).
__device__ __forceinline__ void stage_run(unsigned char* dst,
                                          const unsigned* o) {
  uint2* d = reinterpret_cast<uint2*>(dst);
#pragma unroll
  for (int k = 0; k < 3 * kRun / 8; ++k) d[k] = make_uint2(o[2 * k],
                                                           o[2 * k + 1]);
}

// A grayscale tile: B = G = R = Y.
__device__ void gray_tile(const Frame& f, int tx0, int ty0,
                          unsigned char* stage) {
  const int j = threadIdx.x % kRuns, u = threadIdx.x / kRuns;
  const int x0 = tx0 + kRun * j, y = ty0 + u;
  if (x0 >= f.w || y >= f.h) return;
  const uint4 yv = load16(f.y + static_cast<size_t>(y) * f.w + x0,
                          min(kRun, f.w - x0));
  const unsigned yw[4] = {yv.x, yv.y, yv.z, yv.w};
  unsigned o[3 * kRun / 4];
#pragma unroll
  for (int k = 0; k < kRun / 4; ++k) {
    o[3 * k] = __byte_perm(yw[k], 0, 0x1000);
    o[3 * k + 1] = __byte_perm(yw[k], 0, 0x2211);
    o[3 * k + 2] = __byte_perm(yw[k], 0, 0x3332);
  }
  stage_run(stage + u * kStagePitch + 3 * kRun * j, o);
}

// A colour tile of chroma subsampled by (HF, VF), upsampled by box
// replication or (FANCY) libjpeg-turbo's triangle filter: the tile's chroma
// (and for 2x2 and 1x2 fancy the rows above and below it, for 2x fancy
// the columns beside it) staged in shared memory with the image's edge
// samples repeated, so that a thread reads its samples with no edge test;
// then libjpeg's fixed-point YCbCr to BGR (jdcolor.c, 16 fraction bits).
template <int HF, int VF, bool FANCY>
__device__ void colour_tile(const Frame& f, int tx0, int ty0,
                            unsigned char* stage, unsigned char* chroma) {
  constexpr bool kV2 = FANCY && VF == 2;       // rows above and below
  constexpr int kPad = FANCY && HF == 2;       // a column each side
  constexpr int kCols = kRun / HF + 2 * kPad;  // a thread's samples a row
  constexpr int kPitch = (kTileW / HF + 2 * kPad + 15) / 16 * 16;
  constexpr int kRows = kUnits + 2 * kV2;
  constexpr int kSegs = kPitch / 16;
  constexpr bool kAligned = kRun / HF % 4 == 0;   // a thread's first sample
  static_assert(kRows * kPitch <= kChromaBytes, "chroma tile too large");
  const int c_first = tx0 / HF - kPad;
  const int k_first = ty0 / VF - kV2;
  for (int i = threadIdx.x; i < 2 * kRows * kSegs; i += kThreads) {
    const int plane = i / (kRows * kSegs), r = i / kSegs % kRows;
    const int seg = i % kSegs;
    const unsigned char* src = (plane ? f.cr : f.cb) +
        static_cast<size_t>(min(max(k_first + r, 0), f.ch - 1)) * f.cw;
    const int c = c_first + 16 * seg;
    if (c > f.cw) continue;   // no thread reads it
    uint4 v;
    if (c >= 0 && c + 16 <= f.cw) {
      v = load16(src + c, 16);
    } else {
      unsigned w[4] = {0, 0, 0, 0};
#pragma unroll
      for (int b = 0; b < 16; ++b)
        w[b >> 2] |= static_cast<unsigned>(
            __ldg(src + min(max(c + b, 0), f.cw - 1))) << (8 * (b & 3));
      v = make_uint4(w[0], w[1], w[2], w[3]);
    }
    *reinterpret_cast<uint4*>(chroma + plane * kChromaBytes + r * kPitch +
                              16 * seg) = v;
  }
  __syncthreads();
  const int j = threadIdx.x % kRuns, u = threadIdx.x / kRuns;
  const int x0 = tx0 + kRun * j, y0 = ty0 + VF * u;
  if (x0 >= f.w || y0 >= f.h) return;
  const int n = min(kRun, f.w - x0);
  const int start = kRun / HF * j;
  // the thread's samples of each plane: the nearer chroma row, and for
  // 2x2 and 1x2 fancy the row above and the row below
  int near[2][kCols], above[2][kV2 ? kCols : 1], below[2][kV2 ? kCols : 1];
#pragma unroll
  for (int p = 0; p < 2; ++p) {
    const unsigned char* base = chroma + p * kChromaBytes + start;
    window<kAligned>(base + (u + kV2) * kPitch, near[p]);
    if (kV2) {
      window<kAligned>(base + u * kPitch, above[p]);
      window<kAligned>(base + (u + 2) * kPitch, below[p]);
    }
  }
#pragma unroll
  for (int v = 0; v < VF; ++v) {
    const int y = y0 + v;
    if (y >= f.h) break;
    const uint4 yv = load16(f.y + static_cast<size_t>(y) * f.w + x0, n);
    const unsigned yw[4] = {yv.x, yv.y, yv.z, yv.w};
    int e[3 * kRun];
#pragma unroll
    for (int i = 0; i < kRun; ++i) {
      int up[2];
#pragma unroll
      for (int p = 0; p < 2; ++p) {
        const int* fa = v ? below[p] : above[p];
        if (FANCY && HF == 2) {
          const int w = i / 2 + 1, w2 = (i & 1) ? w + 1 : w - 1;
          up[p] = kV2 ? (3 * (3 * near[p][w] + fa[w]) +
                         (3 * near[p][w2] + fa[w2]) + 8 - (i & 1)) >> 4
                      : (3 * near[p][w] + near[p][w2] + 1 + (i & 1)) >> 2;
        } else if (FANCY) {  // 1x2
          up[p] = (3 * near[p][i] + fa[i] + 1 + v) >> 2;
        } else {
          up[p] = near[p][i / HF];
        }
      }
      const int Y = byte_of(yw, i), cb = up[0], cr = up[1];
      // Y + (FIX(1.772) (Cb - 128) + 2^15) >> 16, and likewise, with the
      // 128s folded into the constants
      e[3 * i] = Y + ((116130 * cb - 14831872) >> 16);
      e[3 * i + 1] = Y + ((-22554 * cb - 46802 * cr + 8910336) >> 16);
      e[3 * i + 2] = Y + ((91881 * cr - 11728000) >> 16);
    }
    unsigned o[3 * kRun / 4];
#pragma unroll
    for (int k = 0; k < 3 * kRun / 4; ++k)
      o[k] = pack4(e[4 * k], e[4 * k + 1], e[4 * k + 2], e[4 * k + 3]);
    stage_run(stage + (VF * u + v) * kStagePitch + 3 * kRun * j, o);
  }
}

// Tile t of frame f.
__device__ void tile(const Frame& f, int t, unsigned char* stage,
                     unsigned char* chroma) {
  const int units = (f.kind == kBox22 || f.kind == kBox42 ||
                     f.kind == kFancy22 || f.kind == kFancy12) ? 2 : 1;
  const int tx0 = t % f.tiles_x * kTileW;
  const int ty0 = t / f.tiles_x * kUnits * units;
  switch (f.kind) {
    case kGray: gray_tile(f, tx0, ty0, stage); break;
    case kBox11: colour_tile<1, 1, false>(f, tx0, ty0, stage, chroma); break;
    case kBox21: colour_tile<2, 1, false>(f, tx0, ty0, stage, chroma); break;
    case kBox22: colour_tile<2, 2, false>(f, tx0, ty0, stage, chroma); break;
    case kBox41: colour_tile<4, 1, false>(f, tx0, ty0, stage, chroma); break;
    case kBox42: colour_tile<4, 2, false>(f, tx0, ty0, stage, chroma); break;
    case kFancy21: colour_tile<2, 1, true>(f, tx0, ty0, stage, chroma); break;
    case kFancy22: colour_tile<2, 2, true>(f, tx0, ty0, stage, chroma); break;
    default: colour_tile<1, 2, true>(f, tx0, ty0, stage, chroma); break;
  }
  __syncthreads();
  const int lane = threadIdx.x % 32;
  const int len = 3 * min(kTileW, f.w - tx0);
  const int rows = min(kUnits * units, f.h - ty0);
  for (int r = threadIdx.x / 32; r < rows; r += kThreads / 32) {
    unsigned char* g = f.out + (static_cast<size_t>(ty0 + r) * f.w + tx0) * 3;
    const unsigned char* s = stage + r * kStagePitch;
    const int head = min(static_cast<int>(-reinterpret_cast<size_t>(g) & 15),
                         len);
    const int body = (len - head) / 16, tail = len - head - 16 * body;
    if (lane < body) {
      const uint4* w = reinterpret_cast<const uint4*>(s) + lane;
      *reinterpret_cast<uint4*>(g + head + 16 * lane) =
          funnel16(w[0], w[1], head);
    }
    if (lane < head) {
      g[lane] = s[lane];
    } else if (lane - head < tail) {
      const int i = head + 16 * body + lane - head;
      g[i] = s[i];
    }
  }
}

// The frames of a launch, a frame a column of the grid and a tile a block
// of the column, the blocks past a frame's tiles idle: a block converts its
// tile into shared memory, then a warp a row writes the tile's BGR rows out
// in 16-byte stores, the few bytes before the first aligned word and after
// the last one singly.
// (6 blocks an SM hold the compiler to 40 registers a thread, which ran
// faster than the 48 it takes alone; tools/ycc_bench.py)
__global__ void __launch_bounds__(kThreads, 6)
    ycc_to_bgr(const Frame* __restrict__ frames) {
  // 16-byte words, for the 16-byte accesses
  __shared__ uint4 stage_words[2 * kUnits * kStagePitch / 16];
  __shared__ uint4 chroma_words[2 * kChromaBytes / 16];
  unsigned char* stage = reinterpret_cast<unsigned char*>(stage_words);
  unsigned char* chroma = reinterpret_cast<unsigned char*>(chroma_words);
  const Frame f = frames[blockIdx.x];
  if (static_cast<int>(blockIdx.y) < f.tiles)
    tile(f, blockIdx.y, stage, chroma);
}

// The kind of a frame of chroma subsampled by (hf, vf), chroma cw samples
// wide (comps 1: grayscale): libjpeg-turbo's choice (jinit_upsampler),
// fancy for 2x1 and 2x2 when the chroma is more than 2 samples wide, and
// for 1x2; box otherwise. -1 for a subsampling no JPEG kind here has.
int kind_of(int comps, int hf, int vf, int cw) {
  if (comps == 1) return kGray;
  if (hf == 2 && vf <= 2 && cw > 2) return vf == 1 ? kFancy21 : kFancy22;
  if (hf == 1 && vf == 2) return kFancy12;
  if (vf == 1) return hf == 1 ? kBox11 : hf == 2 ? kBox21 : hf == 4 ? kBox41
                                                                     : -1;
  if (vf == 2) return hf == 2 ? kBox22 : hf == 4 ? kBox42 : -1;
  return -1;
}

// A frame's entry; its tiles, or -1 for a kind the kernel does not take.
int describe(Frame* f, const unsigned char* y, const unsigned char* cb,
             const unsigned char* cr, unsigned char* out, int h, int w,
             int hf, int vf) {
  std::memset(f, 0, sizeof(*f));
  const int comps = cb ? 3 : 1;
  if (comps == 1) hf = vf = 1;
  if (h <= 0 || w <= 0 || hf <= 0 || vf <= 0) return -1;
  f->y = y;
  f->cb = cb;
  f->cr = cr;
  f->out = out;
  f->w = w;
  f->h = h;
  f->cw = (w + hf - 1) / hf;
  f->ch = (h + vf - 1) / vf;
  f->kind = kind_of(comps, hf, vf, f->cw);
  if (f->kind < 0) return -1;
  const int rows = kUnits * ((comps == 3 && vf == 2) ? 2 : 1);
  f->tiles_x = (w + kTileW - 1) / kTileW;
  f->tiles = f->tiles_x * ((h + rows - 1) / rows);
  return f->tiles;
}

// The kernel on the n frames of a table on the device, given the most
// tiles a frame has (at most 65535: a frame of 2^29 pixels).
int launch(const void* table, int n, int tiles, cudaStream_t stream) {
  if (n == 0) return 0;
  if (tiles > 65535) return static_cast<int>(cudaErrorInvalidValue);
  ycc_to_bgr<<<dim3(n, tiles), kThreads, 0, stream>>>(
      static_cast<const Frame*>(table));
  return static_cast<int>(cudaGetLastError());
}

// -------------------------------------------------------------- decoding

// An image as nvJPEG sees it: components (1 or 3), the chroma planes' size
// and subsampling, where its planes and its BGR frame go.
struct Image {
  int comps = 0, w = 0, h = 0, cw = 0, ch = 0, hf = 1, vf = 1;
  size_t planes = 0, out = 0;
};

struct Context {
  int device = 0;
  nvjpegHandle_t handle = nullptr;
  nvjpegJpegState_t state = nullptr;    // for the batched call
  nvjpegJpegState_t single = nullptr;   // for nvjpegDecode
  cudaStream_t stream = nullptr;
  unsigned char* planes = nullptr;  // nvJPEG's output planes
  size_t planes_bytes = 0;
  unsigned char* dev = nullptr;     // the BGR frames, side by side
  size_t dev_bytes = 0;
  unsigned char* pinned = nullptr;  // their staging copy on the host
  size_t pinned_bytes = 0;
  unsigned char* table = nullptr;   // the launch's frames, on the host
  size_t table_bytes = 0;           // (pinned, so that the copy is async)
  unsigned char* table_dev = nullptr;   // and on the device
  size_t table_dev_bytes = 0;
  std::vector<Image> last;          // the last call's images
};

void note(char* msg, int msg_len, const char* what, int code) {
  if (msg && msg_len > 0) std::snprintf(msg, msg_len, "%s: %d", what, code);
}

#define NVJ(call)                                      \
  do {                                                 \
    nvjpegStatus_t s_ = (call);                        \
    if (s_ != NVJPEG_STATUS_SUCCESS) {                 \
      note(msg, msg_len, #call, static_cast<int>(s_)); \
      return static_cast<int>(s_);                     \
    }                                                  \
  } while (0)

#define CU(call)                                        \
  do {                                                  \
    cudaError_t e_ = (call);                            \
    if (e_ != cudaSuccess) {                            \
      note(msg, msg_len, #call, static_cast<int>(e_));  \
      return -static_cast<int>(e_);                     \
    }                                                   \
  } while (0)

size_t align256(size_t n) { return (n + 255) / 256 * 256; }

int grow(unsigned char** buf, size_t* have, size_t bytes, bool host,
         char* msg, int msg_len) {
  if (bytes <= *have) return 0;
  if (*buf) {
    if (host) CU(cudaFreeHost(*buf));
    else CU(cudaFree(*buf));
  }
  *buf = nullptr;
  *have = 0;
  if (host) CU(cudaMallocHost(buf, bytes));
  else CU(cudaMalloc(buf, bytes));
  *have = bytes;
  return 0;
}

// nvJPEG's view of each image: 1 or 3 components, the probe's size, a
// subsampling of 4:4:4, 4:2:2, 4:2:0, 4:4:0, 4:1:1 or 4:1:0 with chroma
// planes of ceil(w / hf) x ceil(h / vf). status[i] gets
// NVJPEG_STATUS_SUCCESS, nvjpegGetImageInfo's status, or
// NVJPEG_STATUS_JPEG_NOT_SUPPORTED for anything else. Lays out the planes
// and frames; returns the first failing image's status.
int check_images(Context* c, const unsigned char* const* datas,
                 const size_t* lengths, int n, const int* hs, const int* ws,
                 int* status, std::vector<Image>* imgs, size_t* planes_bytes,
                 size_t* out_bytes) {
  static const int kFactors[6][2] = {{1, 1}, {2, 1}, {2, 2},
                                     {1, 2}, {4, 1}, {4, 2}};
  int first = 0;
  imgs->assign(n, Image());
  *planes_bytes = *out_bytes = 0;
  for (int i = 0; i < n; ++i) {
    Image& im = (*imgs)[i];
    nvjpegChromaSubsampling_t css;
    int w[NVJPEG_MAX_COMPONENT] = {0}, h[NVJPEG_MAX_COMPONENT] = {0};
    nvjpegStatus_t s = nvjpegGetImageInfo(c->handle, datas[i], lengths[i],
                                          &im.comps, &css, w, h);
    if (s == NVJPEG_STATUS_SUCCESS) {
      im.w = w[0];
      im.h = h[0];
      bool ok = im.w == ws[i] && im.h == hs[i] &&
                (im.comps == 1 || im.comps == 3);
      if (ok && im.comps == 3) {
        ok = css >= NVJPEG_CSS_444 && css <= NVJPEG_CSS_410;
        if (ok) {
          im.hf = kFactors[css][0];
          im.vf = kFactors[css][1];
          im.cw = w[1];
          im.ch = h[1];
          ok = im.cw == (im.w + im.hf - 1) / im.hf &&
               im.ch == (im.h + im.vf - 1) / im.vf && w[2] == im.cw &&
               h[2] == im.ch;
        }
      }
      if (!ok) s = NVJPEG_STATUS_JPEG_NOT_SUPPORTED;
    }
    status[i] = static_cast<int>(s);
    if (s != NVJPEG_STATUS_SUCCESS) {
      if (first == 0) first = status[i];
      continue;
    }
    im.planes = *planes_bytes;
    *planes_bytes += align256(static_cast<size_t>(im.w) * im.h) +
                     (im.comps == 3 ? 2 * align256(static_cast<size_t>(im.cw)
                                                   * im.ch) : 0);
    im.out = *out_bytes;
    *out_bytes += align256(static_cast<size_t>(im.w) * im.h * 3);
  }
  return first;
}

nvjpegImage_t planes_of(const Context* c, const Image& im) {
  nvjpegImage_t d;
  std::memset(&d, 0, sizeof(d));
  d.channel[0] = c->planes + im.planes;
  d.pitch[0] = im.w;
  if (im.comps == 3) {
    const size_t y_bytes = align256(static_cast<size_t>(im.w) * im.h);
    d.channel[1] = d.channel[0] + y_bytes;
    d.channel[2] = d.channel[1] + align256(static_cast<size_t>(im.cw)
                                           * im.ch);
    d.pitch[1] = d.pitch[2] = im.cw;
  }
  return d;
}

// The decoded planes of imgs to BGR (one ycc_to_bgr launch over all of
// them, its table of frames copied ahead of it on the stream), copied to
// the caller.
int finish(Context* c, const std::vector<Image>& imgs,
           unsigned char* const* outs, size_t out_bytes, int* launches,
           int* frames, char* msg, int msg_len) {
  const int n = static_cast<int>(imgs.size());
  const size_t table_bytes = n * sizeof(Frame);
  int rc = grow(&c->table, &c->table_bytes, table_bytes, true, msg, msg_len);
  if (rc == 0) rc = grow(&c->table_dev, &c->table_dev_bytes, table_bytes,
                         false, msg, msg_len);
  if (rc) return rc;
  Frame* table = reinterpret_cast<Frame*>(c->table);
  int tiles = 0;
  for (int i = 0; i < n; ++i) {
    const nvjpegImage_t d = planes_of(c, imgs[i]);
    const int t = describe(table + i, d.channel[0], d.channel[1],
                           d.channel[2], c->dev + imgs[i].out, imgs[i].h,
                           imgs[i].w, imgs[i].hf, imgs[i].vf);
    if (t < 0) {   // check_images admits no such image: a fault, not a skip
      note(msg, msg_len, "ycc_to_bgr: no kind for image", i);
      return static_cast<int>(NVJPEG_STATUS_INTERNAL_ERROR);
    }
    tiles = std::max(tiles, t);
  }
  CU(cudaMemcpyAsync(c->table_dev, table, table_bytes,
                     cudaMemcpyHostToDevice, c->stream));
  const int err = launch(c->table_dev, n, tiles, c->stream);
  if (err != 0) {
    note(msg, msg_len, "ycc_to_bgr launch", err);
    return -err;
  }
  ++*launches;
  *frames += n;
  CU(cudaMemcpyAsync(c->pinned, c->dev, out_bytes, cudaMemcpyDeviceToHost,
                     c->stream));
  CU(cudaStreamSynchronize(c->stream));
  for (size_t i = 0; i < imgs.size(); ++i)
    std::memcpy(outs[i], c->pinned + imgs[i].out,
                static_cast<size_t>(imgs[i].w) * imgs[i].h * 3);
  c->last = imgs;
  return 0;
}

int prepare(Context* c, const unsigned char* const* datas,
            const size_t* lengths, int n, const int* hs, const int* ws,
            int* status, std::vector<Image>* imgs, size_t* out_bytes,
            char* msg, int msg_len) {
  CU(cudaSetDevice(c->device));
  size_t planes_bytes = 0;
  const int bad = check_images(c, datas, lengths, n, hs, ws, status, imgs,
                               &planes_bytes, out_bytes);
  if (bad) {
    note(msg, msg_len, "nvjpegGetImageInfo", bad);
    return bad;
  }
  int rc = grow(&c->planes, &c->planes_bytes, planes_bytes, false, msg,
                msg_len);
  if (rc == 0) rc = grow(&c->dev, &c->dev_bytes, *out_bytes, false, msg,
                         msg_len);
  if (rc == 0) rc = grow(&c->pinned, &c->pinned_bytes, *out_bytes, true,
                         msg, msg_len);
  return rc;
}

}  // namespace

extern "C" {

int mvf_nvjpeg_version(int* major, int* minor, int* patch) {
  if (nvjpegGetProperty(MAJOR_VERSION, major) != NVJPEG_STATUS_SUCCESS ||
      nvjpegGetProperty(MINOR_VERSION, minor) != NVJPEG_STATUS_SUCCESS ||
      nvjpegGetProperty(PATCH_LEVEL, patch) != NVJPEG_STATUS_SUCCESS)
    return 1;
  return 0;
}

// Whether nvJPEG opens a handle with `backend` (an nvjpegBackend_t) on
// this machine: its status (the census asks for NVJPEG_BACKEND_HARDWARE,
// the JPEG engines).
int mvf_nvjpeg_backend_status(int device, int backend) {
  if (cudaSetDevice(device) != cudaSuccess) return -1;
  nvjpegHandle_t h = nullptr;
  const nvjpegStatus_t s = nvjpegCreateEx(
      static_cast<nvjpegBackend_t>(backend), nullptr, nullptr, 0, &h);
  if (s == NVJPEG_STATUS_SUCCESS) nvjpegDestroy(h);
  return static_cast<int>(s);
}

// A context on CUDA device `device` with the default (hybrid) backend.
int mvf_nvjpeg_create(int device, void** out, char* msg, int msg_len) {
  *out = nullptr;
  Context* c = new (std::nothrow) Context;
  if (!c) {
    note(msg, msg_len, "new Context", 0);
    return static_cast<int>(NVJPEG_STATUS_ALLOCATOR_FAILURE);
  }
  c->device = device;
  *out = c;   // the caller destroys it, also after a failure below
  CU(cudaSetDevice(device));
  CU(cudaStreamCreateWithFlags(&c->stream, cudaStreamNonBlocking));
  NVJ(nvjpegCreateSimple(&c->handle));
  NVJ(nvjpegJpegStateCreate(c->handle, &c->state));
  NVJ(nvjpegJpegStateCreate(c->handle, &c->single));
  return 0;
}

void mvf_nvjpeg_destroy(void* ctx) {
  Context* c = static_cast<Context*>(ctx);
  if (!c) return;
  cudaSetDevice(c->device);
  if (c->stream) cudaStreamSynchronize(c->stream);
  if (c->state) nvjpegJpegStateDestroy(c->state);
  if (c->single) nvjpegJpegStateDestroy(c->single);
  if (c->handle) nvjpegDestroy(c->handle);
  if (c->stream) cudaStreamDestroy(c->stream);
  if (c->planes) cudaFree(c->planes);
  if (c->dev) cudaFree(c->dev);
  if (c->pinned) cudaFreeHost(c->pinned);
  if (c->table) cudaFreeHost(c->table);
  if (c->table_dev) cudaFree(c->table_dev);
  delete c;
}

// Decode n JPEGs (datas[i] of lengths[i] bytes, hs[i] x ws[i] by the probe)
// into outs[i] (hs[i] * ws[i] * 3 bytes, BGR interleaved) with one batched
// call; *launches counts the ycc_to_bgr launches (one) and *frames the
// frames they convert. If an image fails
// nvJPEG's header check, nothing is decoded and its status is returned
// (status[] says which); a batch that mixes grayscale and colour images is
// refused as NVJPEG_STATUS_JPEG_NOT_SUPPORTED (the caller then decodes one
// by one).
int mvf_nvjpeg_decode_batch(void* ctx, const unsigned char* const* datas,
                            const size_t* lengths, int n,
                            unsigned char* const* outs, const int* hs,
                            const int* ws, int* status, int* launches,
                            int* frames, char* msg, int msg_len) {
  Context* c = static_cast<Context*>(ctx);
  std::vector<Image> imgs;
  size_t out_bytes = 0;
  int rc = prepare(c, datas, lengths, n, hs, ws, status, &imgs, &out_bytes,
                   msg, msg_len);
  if (rc) return rc;
  for (int i = 1; i < n; ++i)
    if (imgs[i].comps != imgs[0].comps) {
      note(msg, msg_len, "a batch of grayscale and colour images", 0);
      return static_cast<int>(NVJPEG_STATUS_JPEG_NOT_SUPPORTED);
    }
  std::vector<nvjpegImage_t> dst(n);
  for (int i = 0; i < n; ++i) dst[i] = planes_of(c, imgs[i]);
  NVJ(nvjpegDecodeBatchedInitialize(
      c->handle, c->state, n, 1,
      imgs[0].comps == 3 ? NVJPEG_OUTPUT_YUV : NVJPEG_OUTPUT_Y));
  NVJ(nvjpegDecodeBatched(c->handle, c->state, datas, lengths, dst.data(),
                          c->stream));
  return finish(c, imgs, outs, out_bytes, launches, frames, msg, msg_len);
}

// Decode one JPEG with nvJPEG's single-image API.
int mvf_nvjpeg_decode(void* ctx, const unsigned char* data, size_t length,
                      unsigned char* out, int h, int w, int* launches,
                      int* frames, char* msg, int msg_len) {
  Context* c = static_cast<Context*>(ctx);
  std::vector<Image> imgs;
  size_t out_bytes = 0;
  int status = 0;
  int rc = prepare(c, &data, &length, 1, &h, &w, &status, &imgs, &out_bytes,
                   msg, msg_len);
  if (rc) return rc;
  nvjpegImage_t dst = planes_of(c, imgs[0]);
  NVJ(nvjpegDecode(c->handle, c->single, data, length,
                   imgs[0].comps == 3 ? NVJPEG_OUTPUT_YUV : NVJPEG_OUTPUT_Y,
                   &dst, c->stream));
  return finish(c, imgs, &out, out_bytes, launches, frames, msg, msg_len);
}

// Image i of the context's last decode call: its planes as ycc_to_bgr read
// them, copied to y (h * w bytes) and, for a colour image, cb and cr
// (ceil(h / vf) * ceil(w / hf) bytes each), and its subsampling (hf, vf;
// 0, 0 for grayscale). For checks of the kernel against its plain version
// on decoded frames.
int mvf_nvjpeg_last_planes(void* ctx, int i, unsigned char* y,
                           unsigned char* cb, unsigned char* cr, int* hf,
                           int* vf, char* msg, int msg_len) {
  Context* c = static_cast<Context*>(ctx);
  if (i < 0 || i >= static_cast<int>(c->last.size())) {
    note(msg, msg_len, "no such image in the last call", i);
    return static_cast<int>(NVJPEG_STATUS_INVALID_PARAMETER);
  }
  const Image& im = c->last[i];
  const nvjpegImage_t d = planes_of(c, im);
  CU(cudaSetDevice(c->device));
  CU(cudaMemcpy(y, d.channel[0], static_cast<size_t>(im.w) * im.h,
                cudaMemcpyDeviceToHost));
  *hf = *vf = 0;
  if (im.comps == 3) {
    const size_t bytes = static_cast<size_t>(im.cw) * im.ch;
    CU(cudaMemcpy(cb, d.channel[1], bytes, cudaMemcpyDeviceToHost));
    CU(cudaMemcpy(cr, d.channel[2], bytes, cudaMemcpyDeviceToHost));
    *hf = im.hf;
    *vf = im.vf;
  }
  return 0;
}

// The kernel alone. mvf_ycc_table lays out a launch's table of n frames
// in host memory at `table` (n * mvf_ycc_frame_bytes() bytes): frame i's
// planes y[i] (h[i] x w[i]) and cb[i], cr[i] (ceil(h / vf) x ceil(w / hf),
// both null for grayscale) on the device, unpadded, and its output out[i]
// (h x w x 3). It returns the most tiles a frame has, or -1 for a frame
// the kernel does not take. mvf_ycc_launch converts the frames of a table
// copied to the device, given that count, in one launch on `stream`; it
// returns the cudaError_t.
int mvf_ycc_frame_bytes() { return static_cast<int>(sizeof(Frame)); }

int mvf_ycc_table(int n, const unsigned char* const* y,
                  const unsigned char* const* cb,
                  const unsigned char* const* cr, unsigned char* const* out,
                  const int* h, const int* w, const int* hf, const int* vf,
                  void* table) {
  int tiles = 0;
  for (int i = 0; i < n; ++i) {
    const int t = describe(static_cast<Frame*>(table) + i, y[i], cb[i], cr[i],
                           out[i], h[i], w[i], hf[i], vf[i]);
    if (t < 0) return -1;
    tiles = std::max(tiles, t);
  }
  return tiles;
}

int mvf_ycc_launch(const void* table, int n, int tiles, void* stream) {
  return launch(table, n, tiles, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
