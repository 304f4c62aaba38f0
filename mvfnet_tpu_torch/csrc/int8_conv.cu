// Int8 implicit-GEMM convolution for Hopper (sm_90a).
//
// Replaces the int8 convolutions of the JAX package's eval-only int8 path,
// which XLA runs as lax.conv_general_dilated(int8, int8,
// preferred_element_type=int32) with no Pallas kernel of its own:
// mvfnet_tpu/models/common.py QuantConv2d (:303-307) and QuantConv3d
// (:352-356), the MVF block's split conv1 (backbones/resnet.py:255-258) and
// the space-to-depth stem (resnet.py:320-323). PyTorch has no int8
// convolution on CUDA (F.conv2d and F.conv3d refuse int8 tensors), so the
// port's quant='int8' paths run here.
//
// What it computes: x int8 (N, T, H, W, Cin) channels last, w int8
// (Cout, kt, kh, kw, Cin) (each output channel's K contiguous), per-axis
// strides, padding before each axis (the part after it follows from the
// output size) and dilations; acc[m, c] = sum_k A[m, k] * w[c, k] in exact
// int32, with m the output pixel (n, to, ho, wo) and k the tap (ikt, ikh,
// ikw, ci). A 2-D conv is the case T = kt = 1. Epilogues: the int32
// accumulators themselves (the integer carry), or acc as f32 x scale[c]
// (+ bias[c]) cast to f32 or bf16, rounded as the plain version rounds:
// __int2float_rn, then __fmul_rn, then __fadd_rn (with -O3 nvcc would
// otherwise contract the two into an FMA).
//
// What bounds it on this card: at R50's shapes the products are 2 x
// 64-2048 x K MACs a pixel with K = 64-4608, far above the int8 ridge
// (about 590 operations a byte at 1,979 TOPS over 3.35 TB/s) for the 3x3
// convs and near it for the 1x1 ones; so operations, with the bytes of x
// and the output close behind for the 1x1 convs. This first version is
// simple: one block of 8 warps computes a 128 x 64 output tile; x's im2col
// rows (gathered per 16-byte piece, zero-filled outside the image and past
// K) and w's rows stream through two shared-memory stages with cp.async,
// each stage 64 deep in K; each warp runs mma.sync m16n8k32 s8 on a 32 x 32
// sub-tile from 32-bit shared loads. Cin not a multiple of 16 (the 7x7
// stem's Cin = 3, K = 147; X3D's thin layers) gathers byte by byte instead.
// Left for later: wgmma on s8 with TMA and warp specialisation, ldmatrix,
// larger tiles for Cout >= 128, and the quantize pass of the next conv
// fused into this epilogue.
//
// Built by nvcc into a shared library with a plain C interface, loaded by
// mvfnet_tpu_torch/ops/_cuda.py through ctypes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBM = 128;          // output pixels a block
constexpr int kBN = 64;           // output channels a block
constexpr int kBK = 64;           // K bytes a stage
constexpr int kLD = kBK + 16;     // shared row stride: conflict-free frags
constexpr int kThreads = 256;

struct ConvShape {
  int n, t, h, w, cin;            // input
  int to, ho, wo, cout;           // output
  int kt, kh, kw;                 // taps
  int st, sh, sw;                 // strides
  int pt, ph, pw;                 // padding before each axis
  int dt, dh, dw;                 // dilations
  long long m;                    // n * to * ho * wo
  int k;                          // kt * kh * kw * cin
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait1() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait0() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ void mma_s8(int* c, uint32_t a0, uint32_t a1,
                                       uint32_t a2, uint32_t a3, uint32_t b0,
                                       uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// Where output pixel m reads its input: the batch's base pointer offset and
// the first input coordinate of each axis (negative inside the padding).
struct RowOrigin {
  long long base;   // element offset of frame (n, 0, 0, 0)
  int t0, h0, w0;
  bool valid;
};

__device__ __forceinline__ RowOrigin row_origin(const ConvShape& s,
                                                long long m) {
  RowOrigin r;
  r.valid = m < s.m;
  if (!r.valid) m = 0;
  const int wo = static_cast<int>(m % s.wo);
  long long q = m / s.wo;
  const int ho = static_cast<int>(q % s.ho);
  q /= s.ho;
  const int to = static_cast<int>(q % s.to);
  const long long n = q / s.to;
  r.base = n * s.t * s.h * static_cast<long long>(s.w) * s.cin;
  r.t0 = to * s.st - s.pt;
  r.h0 = ho * s.sh - s.ph;
  r.w0 = wo * s.sw - s.pw;
  return r;
}

// Element offset of x at (row, k), or -1 outside the image or past K.
__device__ __forceinline__ long long x_offset(const ConvShape& s,
                                              const RowOrigin& r, int k) {
  if (!r.valid || k >= s.k) return -1;
  const int tap = k / s.cin;
  const int ci = k - tap * s.cin;
  const int ikw = tap % s.kw;
  const int rest = tap / s.kw;
  const int ikh = rest % s.kh;
  const int ikt = rest / s.kh;
  const int ti = r.t0 + ikt * s.dt;
  const int hi = r.h0 + ikh * s.dh;
  const int wi = r.w0 + ikw * s.dw;
  if (ti < 0 || ti >= s.t || hi < 0 || hi >= s.h || wi < 0 || wi >= s.w)
    return -1;
  return r.base + ((static_cast<long long>(ti) * s.h + hi) * s.w + wi) *
                      s.cin + ci;
}

// One K stage of A (kBM x kBK) and B (kBN x kBK) into shared memory.
// vec: Cin and K multiples of 16 and 16-byte aligned operands, so that each
// 16-byte piece lies in one tap: cp.async, zero-filled where it reads
// nothing. Otherwise byte by byte.
__device__ __forceinline__ void load_stage(
    const ConvShape& s, const int8_t* __restrict__ x,
    const int8_t* __restrict__ w, int8_t* As, int8_t* Bs, int k0,
    const RowOrigin (&rows)[2], long long n_base, bool vec) {
  const int tid = threadIdx.x;
  if (vec) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {        // A: 512 pieces of 16 bytes
      const int piece = tid + i * kThreads;
      const int row = piece >> 2, part = piece & 3;
      const long long off = x_offset(s, rows[i], k0 + part * 16);
      cp_async16(As + row * kLD + part * 16, off >= 0 ? x + off : x,
                 off >= 0 ? 16 : 0);
    }
    {                                    // B: 256 pieces
      const int row = tid >> 2, part = tid & 3;
      const long long c = n_base + row;
      const int k = k0 + part * 16;
      const bool ok = c < s.cout && k < s.k;
      cp_async16(Bs + row * kLD + part * 16,
                 ok ? w + c * s.k + k : w, ok ? 16 : 0);
    }
    return;
  }
  {                                      // A: 32 bytes a thread
    const int row = tid >> 1, first = (tid & 1) * 32;
    const RowOrigin& r = rows[0];
    for (int j = 0; j < 32; ++j) {
      const long long off = x_offset(s, r, k0 + first + j);
      As[row * kLD + first + j] = off >= 0 ? x[off] : 0;
    }
  }
  {                                      // B: 16 bytes a thread
    const int row = tid >> 2, first = (tid & 3) * 16;
    const long long c = n_base + row;
    for (int j = 0; j < 16; ++j) {
      const int k = k0 + first + j;
      Bs[row * kLD + first + j] =
          (c < s.cout && k < s.k) ? w[c * s.k + k] : 0;
    }
  }
}

// epilogue: 0 int32, 1 float32, 2 bfloat16 (the latter two rescaled)
__global__ void __launch_bounds__(kThreads)
    int8_conv_kernel(ConvShape s, const int8_t* __restrict__ x,
                     const int8_t* __restrict__ w, void* __restrict__ out,
                     const float* __restrict__ scale,
                     const float* __restrict__ bias, int epilogue, int vec) {
  __shared__ __align__(16) int8_t As[2][kBM * kLD];
  __shared__ __align__(16) int8_t Bs[2][kBN * kLD];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = (lane & 3) * 4;
  const int wm = (warp & 3) * 32, wn = (warp >> 2) * 32;
  const long long m_base = static_cast<long long>(blockIdx.x) * kBM;
  const long long n_base = static_cast<long long>(blockIdx.y) * kBN;

  // the A rows this thread gathers: tid / 4 and tid / 4 + 64 in the
  // 16-byte path, tid / 2 in the byte path
  RowOrigin rows[2];
  rows[0] = row_origin(s, m_base + (vec ? tid >> 2 : tid >> 1));
  rows[1] = row_origin(s, m_base + (tid >> 2) + 64);

  int acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

  const int stages = (s.k + kBK - 1) / kBK;
  load_stage(s, x, w, As[0], Bs[0], 0, rows, n_base, vec);
  cp_async_commit();
  for (int st = 0; st < stages; ++st) {
    const int buf = st & 1;
    if (st + 1 < stages) {
      load_stage(s, x, w, As[buf ^ 1], Bs[buf ^ 1], (st + 1) * kBK, rows,
                 n_base, vec);
      cp_async_commit();
      cp_async_wait1();
    } else {
      cp_async_wait0();
    }
    __syncthreads();
    const int8_t* a = As[buf];
    const int8_t* b = Bs[buf];
#pragma unroll
    for (int ks = 0; ks < kBK; ks += 32) {
      uint32_t af[2][4], bf[4][2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int8_t* lo = a + (wm + i * 16 + g) * kLD + ks + t4;
        const int8_t* hi = lo + 8 * kLD;
        af[i][0] = *reinterpret_cast<const uint32_t*>(lo);
        af[i][1] = *reinterpret_cast<const uint32_t*>(hi);
        af[i][2] = *reinterpret_cast<const uint32_t*>(lo + 16);
        af[i][3] = *reinterpret_cast<const uint32_t*>(hi + 16);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int8_t* p = b + (wn + j * 8 + g) * kLD + ks + t4;
        bf[j][0] = *reinterpret_cast<const uint32_t*>(p);
        bf[j][1] = *reinterpret_cast<const uint32_t*>(p + 16);
      }
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          mma_s8(acc[i][j], af[i][0], af[i][1], af[i][2], af[i][3],
                 bf[j][0], bf[j][1]);
    }
    __syncthreads();   // the buffer is refilled two stages on
  }

  // fragment (i, j): rows wm + i*16 + g (+8), columns wn + j*8 + t4/2 (+1)
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const long long m = m_base + wm + i * 16 + g + half * 8;
      if (m >= s.m) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const long long c = n_base + wn + j * 8 + t4 / 2 + e;
          if (c >= s.cout) continue;
          const int v = acc[i][j][half * 2 + e];
          const long long at = m * s.cout + c;
          if (epilogue == 0) {
            static_cast<int*>(out)[at] = v;
            continue;
          }
          float f = __fmul_rn(__int2float_rn(v), scale[c]);
          if (bias) f = __fadd_rn(f, bias[c]);
          if (epilogue == 1)
            static_cast<float*>(out)[at] = f;
          else
            static_cast<__nv_bfloat16*>(out)[at] = __float2bfloat16_rn(f);
        }
      }
    }
  }
}

}  // namespace

extern "C" {

// dims: n t h w cin, to ho wo cout, kt kh kw, st sh sw, pt ph pw, dt dh dw
// (21 ints). Returns the launch's cudaError_t.
int int8_conv_launch(const void* x, const void* w, void* out,
                     const void* scale, const void* bias, const int* dims,
                     int epilogue, void* stream) {
  ConvShape s;
  s.n = dims[0]; s.t = dims[1]; s.h = dims[2]; s.w = dims[3];
  s.cin = dims[4];
  s.to = dims[5]; s.ho = dims[6]; s.wo = dims[7]; s.cout = dims[8];
  s.kt = dims[9]; s.kh = dims[10]; s.kw = dims[11];
  s.st = dims[12]; s.sh = dims[13]; s.sw = dims[14];
  s.pt = dims[15]; s.ph = dims[16]; s.pw = dims[17];
  s.dt = dims[18]; s.dh = dims[19]; s.dw = dims[20];
  s.m = static_cast<long long>(s.n) * s.to * s.ho * s.wo;
  s.k = s.kt * s.kh * s.kw * s.cin;
  const int vec = (s.cin % 16 == 0 && s.k % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(w) % 16 == 0)
                      ? 1
                      : 0;
  const dim3 grid(static_cast<unsigned>((s.m + kBM - 1) / kBM),
                  static_cast<unsigned>((s.cout + kBN - 1) / kBN));
  int8_conv_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      s, static_cast<const int8_t*>(x), static_cast<const int8_t*>(w), out,
      static_cast<const float*>(scale), static_cast<const float*>(bias),
      epilogue, vec);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
