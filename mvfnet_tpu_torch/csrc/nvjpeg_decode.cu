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
// mvf_nvjpeg_backend_status); the IDCT and the
// conversion run on the card, far from any bound of their own (ycc_to_bgr
// reads 1.5 bytes and writes 3 a pixel at 4:2:0: bound by bytes). The
// design therefore keeps the host thread on Huffman decoding alone: one
// nvjpegDecodeBatched call for a whole clip on a stream of this context,
// the planes side by side in one device buffer, a ycc_to_bgr launch a
// frame into a second, one device-to-host copy of all the frames into
// pinned staging memory, one stream synchronisation, then a host copy into
// each caller buffer. A context (handle, JPEG states, stream, device and
// pinned buffers, grown on demand and kept) serves one thread at a time;
// the Python side keeps a pool of them, so the loader's threads decode at
// once without a shared lock.
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
#include <cstring>
#include <new>
#include <vector>

namespace {

// ------------------------------------------------------------- the kernel

// One chroma sample of output pixel (x, y) from a plane of cw x ch samples
// subsampled by (hf, vf): libjpeg-turbo's h2v2/h2v1/h1v2 fancy upsampling
// where `fancy`, else box replication (int_upsample). A sample beyond the
// plane's edge is the edge sample, as libjpeg's context rows and its
// special first and last columns give it.
__device__ __forceinline__ int chroma(const unsigned char* p, int pitch,
                                      int cw, int ch, int hf, int vf,
                                      int fancy, int x, int y) {
  if (!fancy) return p[(y / vf) * pitch + x / hf];
  if (vf == 2) {
    const int k = y >> 1;
    const int nb = (y & 1) ? min(k + 1, ch - 1) : max(k - 1, 0);
    const unsigned char* r0 = p + k * pitch;
    const unsigned char* r1 = p + nb * pitch;
    if (hf == 1)   // h1v2: 3/4 nearer row + 1/4 further row, bias 1 or 2
      return (3 * r0[x] + r1[x] + 1 + (y & 1)) >> 2;
    // h2v2: column sums of the two rows, then 3/4 + 1/4 across columns,
    // bias 8 to the left half of a pair and 7 to the right
    const int c = x >> 1;
    const int c2 = (x & 1) ? min(c + 1, cw - 1) : max(c - 1, 0);
    return (3 * (3 * r0[c] + r1[c]) + (3 * r0[c2] + r1[c2]) + 8 - (x & 1))
           >> 4;
  }
  // h2v1: bias 1 to the left half of a pair, 2 to the right
  const unsigned char* r = p + y * pitch;
  const int c = x >> 1;
  const int c2 = (x & 1) ? min(c + 1, cw - 1) : max(c - 1, 0);
  return (3 * r[c] + r[c2] + 1 + (x & 1)) >> 2;
}

__device__ __forceinline__ unsigned char clamp255(int v) {
  return static_cast<unsigned char>(min(max(v, 0), 255));
}

// BGR from Y (w x h) and Cb, Cr (cw x ch, subsampled by hf, vf), or from Y
// alone where cb is null (grayscale: B = G = R = Y). libjpeg's tables:
// R = Y + (FIX(1.402) (Cr - 128) + 2^15) >> 16, B likewise with
// FIX(1.772) and Cb, G = Y + (-FIX(0.34414) (Cb - 128) + 2^15
// - FIX(0.71414) (Cr - 128)) >> 16, arithmetic shifts, clamped.
__global__ void ycc_to_bgr(const unsigned char* __restrict__ yp, int ypitch,
                           const unsigned char* __restrict__ cb,
                           const unsigned char* __restrict__ cr, int cpitch,
                           int w, int h, int cw, int ch, int hf, int vf,
                           int fancy, unsigned char* __restrict__ out) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y * blockDim.y + threadIdx.y;
  if (x >= w || y >= h) return;
  const int Y = yp[y * ypitch + x];
  unsigned char* o = out + (static_cast<size_t>(y) * w + x) * 3;
  if (cb == nullptr) {
    o[0] = o[1] = o[2] = static_cast<unsigned char>(Y);
    return;
  }
  const int u = chroma(cb, cpitch, cw, ch, hf, vf, fancy, x, y) - 128;
  const int v = chroma(cr, cpitch, cw, ch, hf, vf, fancy, x, y) - 128;
  o[0] = clamp255(Y + ((116130 * u + 32768) >> 16));
  o[1] = clamp255(Y + ((-22554 * u + 32768 - 46802 * v) >> 16));
  o[2] = clamp255(Y + ((91881 * v + 32768) >> 16));
}

// libjpeg-turbo's choice (jinit_upsampler): fancy for 2x1 and 2x2 when the
// chroma is more than 2 samples wide, and for 1x2; box otherwise.
int fancy_for(int hf, int vf, int cw) {
  return (hf == 2 && vf <= 2 && cw > 2) || (hf == 1 && vf == 2);
}

// -------------------------------------------------------------- decoding

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
};

// An image as nvJPEG sees it: components (1 or 3), the chroma planes' size
// and subsampling, where its planes and its BGR frame go.
struct Image {
  int comps = 0, w = 0, h = 0, cw = 0, ch = 0, hf = 1, vf = 1;
  size_t planes = 0, out = 0;
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

int launch(const nvjpegImage_t& d, int cw, int ch, int hf, int vf, int w,
           int h, unsigned char* out, cudaStream_t stream) {
  const dim3 block(32, 8);
  const dim3 grid((w + 31) / 32, (h + 7) / 8);
  ycc_to_bgr<<<grid, block, 0, stream>>>(
      d.channel[0], static_cast<int>(d.pitch[0]), d.channel[1], d.channel[2],
      static_cast<int>(d.pitch[1]), w, h, cw, ch, hf, vf,
      fancy_for(hf, vf, cw), out);
  return static_cast<int>(cudaGetLastError());
}

// The decoded planes of imgs to BGR (a ycc_to_bgr launch each), copied to
// the caller.
int finish(Context* c, const std::vector<Image>& imgs,
           unsigned char* const* outs, size_t out_bytes, int* launches,
           char* msg, int msg_len) {
  for (size_t i = 0; i < imgs.size(); ++i) {
    const Image& im = imgs[i];
    const int err = launch(planes_of(c, im), im.cw, im.ch, im.hf, im.vf,
                           im.w, im.h, c->dev + im.out, c->stream);
    if (err != 0) {
      note(msg, msg_len, "ycc_to_bgr launch", err);
      return -err;
    }
    ++*launches;
  }
  CU(cudaMemcpyAsync(c->pinned, c->dev, out_bytes, cudaMemcpyDeviceToHost,
                     c->stream));
  CU(cudaStreamSynchronize(c->stream));
  for (size_t i = 0; i < imgs.size(); ++i)
    std::memcpy(outs[i], c->pinned + imgs[i].out,
                static_cast<size_t>(imgs[i].w) * imgs[i].h * 3);
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
  delete c;
}

// Decode n JPEGs (datas[i] of lengths[i] bytes, hs[i] x ws[i] by the probe)
// into outs[i] (hs[i] * ws[i] * 3 bytes, BGR interleaved) with one batched
// call; *launches counts the ycc_to_bgr launches. If an image fails
// nvJPEG's header check, nothing is decoded and its status is returned
// (status[] says which); a batch that mixes grayscale and colour images is
// refused as NVJPEG_STATUS_JPEG_NOT_SUPPORTED (the caller then decodes one
// by one).
int mvf_nvjpeg_decode_batch(void* ctx, const unsigned char* const* datas,
                            const size_t* lengths, int n,
                            unsigned char* const* outs, const int* hs,
                            const int* ws, int* status, int* launches,
                            char* msg, int msg_len) {
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
  return finish(c, imgs, outs, out_bytes, launches, msg, msg_len);
}

// Decode one JPEG with nvJPEG's single-image API.
int mvf_nvjpeg_decode(void* ctx, const unsigned char* data, size_t length,
                      unsigned char* out, int h, int w, int* launches,
                      char* msg, int msg_len) {
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
  return finish(c, imgs, &out, out_bytes, launches, msg, msg_len);
}

// The kernel alone, on device planes (cb and cr null for grayscale), into
// out (h x w x 3 on the device), on `stream`; returns the launch's
// cudaError_t.
int mvf_ycc_to_bgr(const unsigned char* y, int ypitch,
                   const unsigned char* cb, const unsigned char* cr,
                   int cpitch, int w, int h, int cw, int ch, int hf, int vf,
                   unsigned char* out, void* stream) {
  nvjpegImage_t d;
  std::memset(&d, 0, sizeof(d));
  d.channel[0] = const_cast<unsigned char*>(y);
  d.channel[1] = const_cast<unsigned char*>(cb);
  d.channel[2] = const_cast<unsigned char*>(cr);
  d.pitch[0] = ypitch;
  d.pitch[1] = cpitch;
  return launch(d, cw, ch, hf, vf, w, h, out,
                static_cast<cudaStream_t>(stream));
}

}  // extern "C"
