// Fused eval-time ResNet bottleneck for Hopper (sm_90a).
//
// Replaces the TPU kernel mvfnet_tpu/ops/fused_block.py::bottleneck_eval_pallas
// (body _bottleneck_kernel). Same function, BN already folded into the
// weights by the caller:
//
//     out = relu(x + relu(conv3x3(relu(x.W1 + b1)) + b2).W3 + b3)
//
// x and out are NHWC (N, H, W, Cin); W1t (Cm, Cin), W2t (3, 3, Cm_out, Cm_in)
// and W3t (Cin, Cm) are the transposed (output-channel-major) folded weights
// in x's dtype; b1, b2 (Cm) and b3 (Cin) are fp32. Accumulation is fp32.
// h1 and h2 are rounded to x's dtype before the next product, the residual
// is added in fp32 to the fp32 conv3 accumulator and the result is cast
// once: the rounding points of the TPU kernel.
//
// What bounds it on this card. By its data, bytes: at the flagship's layer1
// mid-block (240 x 64 x 64, Cin 256, Cm 64, bf16) the function does 136.9
// GFLOP and must move 1.007 GB (x read once, out written once), about 136
// FLOP per byte against the H100's bf16 ridge of about 295; an unfused
// composite also writes and re-reads h1, h2 and the conv3 output. So h1 and
// h2 stay in shared memory and x is read, and out written, once per pixel
// (plus conv3's re-read of x, from L2). As built, neither bytes nor math
// bound it: a step of the tiled kernel (see below) takes about 36 us on an
// SM at layer1 (NVIDIA H100 80GB HBM3, 700 W; tools/kernel_stages.py),
// where its products at the card's bf16 peak would take 4.8 us and its
// share of device-memory bandwidth about 10 us. The time goes to latency
// the block does not hide: conv1 waits on its x chunks, each K chunk of 64
// costs about 0.8 us of ldmatrix and mma.sync against 0.28 us of math at
// that peak, and each conv3 pass on its epilogue and stores.
//
// Two kernels, chosen by shape and dtype in fused_bottleneck_path:
//
// The general kernel (any Cin, Cm multiple of 8; bf16 or fp32) computes TH
// output rows of one frame per block, with conv1 recomputed for a one-row
// halo above and below, over a flattened (TH+2) x (W+2) h1 tile in shared
// memory whose pad slots are zero (the 3x3 pads with zeros of h1, never
// with relu(b1)): output slot q reads input slot q + dy*(W+2) + dx, so every
// tap is one plain matrix product. Each product runs per warp as 16 x 32
// tiles of mma.sync (bf16) or scalar FMAs (fp32), weights read through the
// read-only cache.
//
// The tiled bf16 kernel (Cin and Cm multiples of 64, the flagship's; see
// its section below) gives each SM one block that walks an equal run of
// TH-row steps and carries h1's two halo rows from step to step, so conv1
// runs once per row; gathers the 3x3's A rows per lane so that no pad
// column becomes a product row; streams x and weight chunks through shared
// memory with cp.async under the products; and stages conv3's residual and
// result in shared memory, so x is read and out written in coalesced
// 16-byte copies. Left for later: wgmma with its operands in shared memory
// (mma.sync from registers reaches about a third of the card's bf16 peak
// even with every operand already in shared memory), TMA bulk copies, and
// warps specialised to copy while others multiply, which a block of
// barrier-separated stages cannot overlap.
//
// Built by nvcc into a shared library with a plain C interface, loaded by
// mvfnet_tpu_torch/ops/_cuda.py through ctypes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <initializer_list>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kNT = 4;          // n-tiles of 8 columns per warp task
constexpr int kCols = kNT * 8;  // columns per warp task
constexpr int kMaxSmem = 232448;

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t ldg32(const __nv_bfloat16* p) {
  return __ldg(reinterpret_cast<const unsigned int*>(p));
}

__device__ __forceinline__ void mma_k8(float* c, uint32_t a0, uint32_t a1,
                                       uint32_t b0) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5}, {%6}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(b0));
}

__device__ __forceinline__ void mma_k16(float* c, uint32_t a0, uint32_t a1,
                                        uint32_t a2, uint32_t a3, uint32_t b0,
                                        uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// acc[t] += A(16 x K) . B(K x 8) for the t-th n-tile, t < nt.
// a_lo / a_hi: this thread's A rows g and g+8 at k = 0 (nullptr: zero row).
// bt: B transposed (N x K, row stride ldb) at the tile's first column.
// Fragment map (mma.sync): thread (g = lane/4, i = lane%4) owns
// acc[t][0..1] = rows g, columns t*8 + 2i + {0,1}; acc[t][2..3] = row g+8.
template <typename T>
struct TileMma;

template <>
struct TileMma<__nv_bfloat16> {
  static __device__ __forceinline__ void run(float (&acc)[kNT][4],
                                             const __nv_bfloat16* a_lo,
                                             const __nv_bfloat16* a_hi,
                                             const __nv_bfloat16* bt, int ldb,
                                             int kcount, int nt, int lane) {
    const int g = lane >> 2, i2 = (lane & 3) * 2;
    if (kcount % 16 == 0) {
      for (int k = 0; k < kcount; k += 16) {
        const uint32_t a0 = a_lo ? ld32(a_lo + k + i2) : 0u;
        const uint32_t a1 = a_hi ? ld32(a_hi + k + i2) : 0u;
        const uint32_t a2 = a_lo ? ld32(a_lo + k + 8 + i2) : 0u;
        const uint32_t a3 = a_hi ? ld32(a_hi + k + 8 + i2) : 0u;
#pragma unroll
        for (int t = 0; t < kNT; ++t) {
          if (t < nt) {
            const __nv_bfloat16* b = bt + (size_t)(t * 8 + g) * ldb + k + i2;
            mma_k16(acc[t], a0, a1, a2, a3, ldg32(b), ldg32(b + 8));
          }
        }
      }
    } else {
      for (int k = 0; k < kcount; k += 8) {
        const uint32_t a0 = a_lo ? ld32(a_lo + k + i2) : 0u;
        const uint32_t a1 = a_hi ? ld32(a_hi + k + i2) : 0u;
#pragma unroll
        for (int t = 0; t < kNT; ++t) {
          if (t < nt) {
            const __nv_bfloat16* b = bt + (size_t)(t * 8 + g) * ldb + k + i2;
            mma_k8(acc[t], a0, a1, ldg32(b));
          }
        }
      }
    }
  }
};

template <>
struct TileMma<float> {
  static __device__ __forceinline__ void run(float (&acc)[kNT][4],
                                             const float* a_lo,
                                             const float* a_hi,
                                             const float* bt, int ldb,
                                             int kcount, int nt, int lane) {
    const int i2 = (lane & 3) * 2;
    for (int k = 0; k < kcount; k += 8) {
      float al[8], ah[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        al[j] = a_lo ? a_lo[k + j] : 0.f;
        ah[j] = a_hi ? a_hi[k + j] : 0.f;
      }
#pragma unroll
      for (int t = 0; t < kNT; ++t) {
        if (t < nt) {
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const float* b = bt + (size_t)(t * 8 + i2 + c) * ldb + k;
            float lo = acc[t][c], hi = acc[t][2 + c];
#pragma unroll
            for (int j = 0; j < 8; ++j) {
              const float bv = __ldg(b + j);
              lo = fmaf(al[j], bv, lo);
              hi = fmaf(ah[j], bv, hi);
            }
            acc[t][c] = lo;
            acc[t][2 + c] = hi;
          }
        }
      }
    }
  }
};

__device__ __forceinline__ void store2(__nv_bfloat16* p, float v0, float v1) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(v0, v1);
}

__device__ __forceinline__ void store2(float* p, float v0, float v1) {
  *reinterpret_cast<float2*>(p) = make_float2(v0, v1);
}

__device__ __forceinline__ float2 load2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}

__device__ __forceinline__ void zero_acc(float (&acc)[kNT][4]) {
#pragma unroll
  for (int t = 0; t < kNT; ++t) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[t][e] = 0.f;
  }
}

// Shared-memory geometry, in pixel slots of ldh = Cm + 8 elements (the
// 8-element pad spreads the rows of an A fragment over all 32 banks).
struct Geometry {
  int P;      // padded row width, W + 2
  int m2;     // output slots of the tile, TH * P rounded up to 16
  int ns1;    // h1 slots: 1 front slot + (TH+2)*P + 17 tail for tap reads
  int ldh;
  __host__ __device__ Geometry(int W, int Cm, int TH) {
    P = W + 2;
    m2 = (TH * P + 15) / 16 * 16;
    ns1 = (TH + 2) * P + 18;
    ldh = Cm + 8;
  }
};

template <typename T>
size_t smem_bytes(int W, int Cm, int TH) {
  const Geometry geo(W, Cm, TH);
  return (size_t)(geo.ns1 + geo.m2) * geo.ldh * sizeof(T);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
fused_bottleneck_kernel(const T* __restrict__ x, const T* __restrict__ w1t,
                        const float* __restrict__ b1,
                        const T* __restrict__ w2t,
                        const float* __restrict__ b2,
                        const T* __restrict__ w3t,
                        const float* __restrict__ b3, T* __restrict__ out,
                        int H, int W, int Cin, int Cm, int TH) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* h1s = reinterpret_cast<T*>(smem_raw);
  const Geometry geo(W, Cm, TH);
  T* h2s = h1s + (size_t)geo.ns1 * geo.ldh;
  const int P = geo.P, ldh = geo.ldh;

  const int tiles = (H + TH - 1) / TH;
  const int n = blockIdx.x / tiles;
  const int r0 = (blockIdx.x % tiles) * TH;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, i2 = (lane & 3) * 2;
  const T* xn = x + (size_t)n * H * W * Cin;
  T* on = out + (size_t)n * H * W * Cin;

  // zero the h1 tile: pad columns and rows outside the image stay zero
  {
    const int n16 = geo.ns1 * ldh * (int)sizeof(T) / 16;
    int4* p = reinterpret_cast<int4*>(h1s);
    for (int i = threadIdx.x; i < n16; i += kThreads) p[i] = make_int4(0, 0, 0, 0);
  }
  __syncthreads();

  float acc[kNT][4];

  // 1. h1 = relu(x.W1 + b1) for image rows r0-1 .. r0+TH
  {
    const int m1 = (TH + 2) * W;
    const int mt = (m1 + 15) / 16, nch = (Cm + kCols - 1) / kCols;
    for (int task = warp; task < mt * nch; task += kWarps) {
      const int m0 = (task / nch) * 16, n0 = (task % nch) * kCols;
      const int nt = min(kNT, (Cm - n0) / 8);
      const T* a[2];
      int slot[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = m0 + g + 8 * h;
        const int rr = m / W, c = m % W, y = r0 - 1 + rr;
        const bool ok = m < m1 && y >= 0 && y < H;
        a[h] = ok ? xn + ((size_t)y * W + c) * Cin : nullptr;
        slot[h] = ok ? rr * P + c + 2 : -1;
      }
      zero_acc(acc);
      TileMma<T>::run(acc, a[0], a[1], w1t + (size_t)n0 * Cin, Cin, Cin, nt,
                      lane);
#pragma unroll
      for (int t = 0; t < kNT; ++t) {
        if (t < nt) {
          const int col = n0 + t * 8 + i2;
          const float bb0 = b1[col], bb1 = b1[col + 1];
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            if (slot[h] >= 0) {
              store2(h1s + (size_t)slot[h] * ldh + col,
                     fmaxf(acc[t][2 * h] + bb0, 0.f),
                     fmaxf(acc[t][2 * h + 1] + bb1, 0.f));
            }
          }
        }
      }
    }
  }
  __syncthreads();

  // 2. h2 = relu(conv3x3(h1) + b2) over the flattened padded tile
  {
    const int mt = geo.m2 / 16, nch = (Cm + kCols - 1) / kCols;
    for (int task = warp; task < mt * nch; task += kWarps) {
      const int m0 = (task / nch) * 16, n0 = (task % nch) * kCols;
      const int nt = min(kNT, (Cm - n0) / 8);
      zero_acc(acc);
      for (int tap = 0; tap < 9; ++tap) {
        const int off = (tap / 3) * P + tap % 3;
        TileMma<T>::run(acc, h1s + (size_t)(m0 + g + off) * ldh,
                        h1s + (size_t)(m0 + g + 8 + off) * ldh,
                        w2t + ((size_t)tap * Cm + n0) * Cm, Cm, Cm, nt, lane);
      }
#pragma unroll
      for (int t = 0; t < kNT; ++t) {
        if (t < nt) {
          const int col = n0 + t * 8 + i2;
          const float bb0 = b2[col], bb1 = b2[col + 1];
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            store2(h2s + (size_t)(m0 + g + 8 * h) * ldh + col,
                   fmaxf(acc[t][2 * h] + bb0, 0.f),
                   fmaxf(acc[t][2 * h + 1] + bb1, 0.f));
          }
        }
      }
    }
  }
  __syncthreads();

  // 3. out = relu(h2.W3 + b3 + x) for the tile's valid pixels
  {
    const int mt = geo.m2 / 16, nch = (Cin + kCols - 1) / kCols;
    for (int task = warp; task < mt * nch; task += kWarps) {
      const int m0 = (task / nch) * 16, n0 = (task % nch) * kCols;
      const int nt = min(kNT, (Cin - n0) / 8);
      zero_acc(acc);
      TileMma<T>::run(acc, h2s + (size_t)(m0 + g) * ldh,
                      h2s + (size_t)(m0 + g + 8) * ldh,
                      w3t + (size_t)n0 * Cm, Cm, Cm, nt, lane);
      size_t pix[2];
      bool ok[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int q = m0 + g + 8 * h;
        const int y = r0 + q / P, cc = q % P;
        ok[h] = q < TH * P && y < H && cc >= 1 && cc <= W;
        pix[h] = ((size_t)y * W + (cc - 1)) * Cin;
      }
#pragma unroll
      for (int t = 0; t < kNT; ++t) {
        if (t < nt) {
          const int col = n0 + t * 8 + i2;
          const float bb0 = b3[col], bb1 = b3[col + 1];
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            if (ok[h]) {
              const float2 r = load2(xn + pix[h] + col);
              store2(on + pix[h] + col,
                     fmaxf(acc[t][2 * h] + bb0 + r.x, 0.f),
                     fmaxf(acc[t][2 * h + 1] + bb1 + r.y, 0.f));
            }
          }
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// bf16 path for shapes that tile evenly (Cin % 64 == 0 and Cm % 64 == 0, the
// flagship's). The work is N frames of ceil(H / TH) steps of TH rows; each
// block, one per SM, walks an equal run of consecutive steps. The h1 tile
// holds image rows r0-1 .. r0+TH of a step as TH+2 rows of W+2 slots (a
// zero pad slot each side); after a step its last two rows are copied to
// the top, so conv1 runs only for the TH new rows (where a run starts or
// enters a frame, it computes the top two rows first). Each stage is a
// block-level matrix product whose rows are the step's TH*W pixels: the
// 3x3's A rows are gathered per lane (ldmatrix takes a row address per
// lane), so no pad column becomes a row. Each warp owns one 32x64 output
// tile of a pass and keeps its fp32 sums in registers. Weights and conv1's
// x rows stream through two shared-memory buffers in 64-wide K chunks with
// cp.async, each chunk copied while the one before it is multiplied. conv3
// runs in passes of ng3 output columns: the pass's residual rows are copied
// into shared memory (over the x buffers, idle then) under its products,
// the epilogue adds them in fp32 and writes the cast result in place, and
// the pixels leave in coalesced 16-byte stores.

constexpr int kTileWarps = 8;
constexpr int kTileThreads = kTileWarps * 32;
constexpr int kKC = 64;             // K chunk
constexpr int kLDC = kKC + 8;       // chunk row stride: conflict-free ldmatrix
constexpr int kWM = 32, kWN = 64;   // warp tile
// conv3's pass widths are multiples of kWN; res_at permutes a row's 16-byte
// chunks in eights
static_assert(kWN % 64 == 0, "residual stage rows must be 64-value multiples");

__host__ __device__ inline int round_up(int a, int b) {
  return (a + b - 1) / b * b;
}

__host__ __device__ inline int imax(int a, int b) { return a > b ? a : b; }

struct Plan {
  int P, m, mpad, m1pad, ns1, ldh, ng3;
  size_t h1_bytes, h2_bytes, x_bytes, w_bytes, smem;
  bool ok;
  __host__ __device__ Plan(int W, int Cin, int Cm, int TH) {
    P = W + 2;
    m = TH * W;                        // the step's pixels: rows of each product
    mpad = round_up(m, kWM);
    m1pad = round_up(imax(TH, 2) * W, kWM);  // conv1 rows (2 for the top halo)
    ns1 = (TH + 2) * P;
    ldh = Cm + 8;
    const int nt3 = kTileWarps / (mpad / kWM);
    ng3 = nt3 * kWN < Cin ? nt3 * kWN : Cin;
    h1_bytes = (size_t)ns1 * ldh * 2;
    h2_bytes = (size_t)mpad * ldh * 2;
    x_bytes = (size_t)m1pad * kLDC * 2;
    w_bytes = (size_t)imax(Cm, ng3) * kLDC * 2;
    smem = h1_bytes + h2_bytes + 2 * (x_bytes + w_bytes);
    // conv1 and conv2 in one pass each; conv3 in passes of ng3 columns
    // whose residual stage fits the two x buffers
    ok = Cin % kKC == 0 && Cm % kKC == 0 &&
         (m1pad / kWM) * (Cm / kWN) <= kTileWarps && nt3 >= 1 &&
         (size_t)m * ng3 * 2 <= 2 * x_bytes && smem <= (size_t)kMaxSmem;
  }
};

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

// 16-byte async copy; a row outside the image copies nothing and zero-fills
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0));
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

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], unsigned addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// Element (p, col) of the residual stage whose rows hold `width` values: the
// 16-byte chunks of row p are permuted by p % 8, so that the epilogue's
// 8-row fragments and the 16-byte copies both spread over all banks.
__device__ __forceinline__ int res_at(int p, int col, int width) {
  return p * width + ((((col >> 3) ^ p) & 7) | ((col >> 3) & ~7)) * 8 +
         (col & 7);
}

// One pass of a block-level product over `nchunks` K chunks of 64:
// C[mpad x width] = A . B, at most kTileWarps 32x64 tiles, one per warp.
// load(c, buf) copies chunk c (B^T rows to shared address wbuf + buf *
// wstep, and A rows where A streams too), one chunk ahead of the products.
// extra() issues copies that only the epilogue needs, under the first
// chunk's products. a_base(c, buf) is A's element (row 0, k 0) for chunk
// c and a_off(r) row r's offset from it, in elements. The epilogue adds
// bias[col] to column col, computes row(r) once for each of its rows and
// hands epi(row(r), col, v0, v1) each pair of adjacent fp32 results.
template <class Load, class Extra, class ABase, class AOff, class Row,
          class Epi>
__device__ __forceinline__ void gemm_pass(int mpad, int width, int nchunks,
                                          unsigned wbuf, unsigned wstep,
                                          Load load, Extra extra,
                                          ABase a_base, AOff a_off,
                                          const float* bias, Row row,
                                          Epi epi) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int ntn = width / kWN;
  const bool active = warp < (mpad / kWM) * ntn;
  const int mi = warp / ntn, ni = warp % ntn;
  // this lane's ldmatrix rows: A rows mi*kWM + mt*16 + lane%16 at k = 8 *
  // (lane/16); B^T rows ni*kWN + nb*16 + lane%8 + 8*(lane/16) at k = 8 *
  // (lane/8 % 2), in bytes
  unsigned aoff[2];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
    aoff[mt] = 2u * (a_off(mi * kWM + mt * 16 + (lane & 15)) + (lane >> 4) * 8);
  const unsigned boff =
      2u * ((ni * kWN + (lane & 7) + ((lane >> 4) << 3)) * kLDC +
            ((lane >> 3) & 1) * 8);
  float acc[2][kWN / 8][4];
#pragma unroll
  for (int a = 0; a < 2; ++a)
#pragma unroll
    for (int b = 0; b < kWN / 8; ++b)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[a][b][e] = 0.f;

  load(0, 0);
  cp_async_commit();
  for (int c = 0; c < nchunks; ++c) {
    const int buf = c & 1;
    if (c + 1 < nchunks) load(c + 1, buf ^ 1);
    if (c == 0) extra();
    cp_async_commit();
    cp_async_wait1();  // chunk c has landed
    __syncthreads();
    if (active) {
      const unsigned ab = smem_addr(a_base(c, buf));
      const unsigned bb = wbuf + buf * wstep + boff;
#pragma unroll
      for (int ks = 0; ks < kKC; ks += 16) {
        uint32_t af[2][4], bf[kWN / 16][4];
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) ldsm_x4(af[mt], ab + aoff[mt] + 2 * ks);
#pragma unroll
        for (int nb = 0; nb < kWN / 16; ++nb)
          ldsm_x4(bf[nb], bb + 2u * (nb * 16 * kLDC + ks));
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int nt = 0; nt < kWN / 8; ++nt)
            mma_k16(acc[mt][nt], af[mt][0], af[mt][1], af[mt][2], af[mt][3],
                    bf[nt >> 1][(nt & 1) * 2], bf[nt >> 1][(nt & 1) * 2 + 1]);
      }
    }
    if (c + 1 == nchunks) cp_async_wait0();  // extra's copies have landed
    __syncthreads();
  }

  if (active) {
    const int g = lane >> 2, i2 = (lane & 3) * 2;
    float2 bv[kWN / 8];
#pragma unroll
    for (int nt = 0; nt < kWN / 8; ++nt) {
      const float* b = bias + ni * kWN + nt * 8 + i2;
      bv[nt] = make_float2(__ldg(b), __ldg(b + 1));
    }
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const auto rv = row(mi * kWM + mt * 16 + g + 8 * h);
#pragma unroll
        for (int nt = 0; nt < kWN / 8; ++nt)
          epi(rv, ni * kWN + nt * 8 + i2, acc[mt][nt][2 * h] + bv[nt].x,
              acc[mt][nt][2 * h + 1] + bv[nt].y);
      }
  }
}

__global__ void __launch_bounds__(kTileThreads, 1)
fused_bottleneck_bf16_tiled(const __nv_bfloat16* __restrict__ x,
                            const __nv_bfloat16* __restrict__ w1t,
                            const float* __restrict__ b1,
                            const __nv_bfloat16* __restrict__ w2t,
                            const float* __restrict__ b2,
                            const __nv_bfloat16* __restrict__ w3t,
                            const float* __restrict__ b3,
                            __nv_bfloat16* __restrict__ out, int N, int H,
                            int W, int Cin, int Cm, int TH) {
  using bf16 = __nv_bfloat16;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const Plan pl(W, Cin, Cm, TH);
  const int P = pl.P, ldh = pl.ldh;
  unsigned char* sp = smem_raw;
  bf16* const h1s = reinterpret_cast<bf16*>(sp);
  sp += pl.h1_bytes;
  bf16* const h2s = reinterpret_cast<bf16*>(sp);
  sp += pl.h2_bytes;
  // two chunk buffers: x buffer b at xs + b * xstep, weight buffer b at
  // shared address wsa + b * w_bytes; conv3's residual stage over the x
  // buffers
  bf16* const xs = reinterpret_cast<bf16*>(sp);
  const int xstep = (int)(pl.x_bytes / 2);
  sp += 2 * pl.x_bytes;
  const unsigned wsa = smem_addr(sp);
  bf16* const ws = reinterpret_cast<bf16*>(sp);
  const int wstep = (int)(pl.w_bytes / 2);
  bf16* const res = xs;

  // this block's run of steps g0 .. g1-1; step g is rows (g % spf) * TH ..
  // of frame g / spf
  const int spf = (H + TH - 1) / TH;
  const long long steps = (long long)N * spf;
  const long long g0 = steps * blockIdx.x / gridDim.x;
  const long long g1 = steps * (blockIdx.x + 1) / gridDim.x;
  const bf16* xn = x;
  bf16* on = out;
  const int cpt = Cm / kKC;

  {  // pad slots stay zero; rows outside the image are written as zeros
    int4* p = reinterpret_cast<int4*>(h1s);
    const int n16 = (int)(pl.h1_bytes / 16);
    for (int i = threadIdx.x; i < n16; i += kTileThreads)
      p[i] = make_int4(0, 0, 0, 0);
  }

  // copies `rows` B^T rows of 64 values, row stride ld, into buffer buf
  auto load_b = [&](const bf16* src, int ld, int rows, int buf) {
    for (int i = threadIdx.x; i < rows * 8; i += kTileThreads) {
      const int r = i >> 3, seg = (i & 7) * 8;
      cp_async16(ws + buf * wstep + r * kLDC + seg,
                 src + (size_t)r * ld + seg, true);
    }
  };
  // h1 rows row0 .. row0+rows-1 = relu(x.W1 + b1) of image rows y0 ..,
  // zeros for rows outside the image. The rows are consecutive pixels of x.
  auto conv1 = [&](int row0, int y0, int rows) {
    const int m = rows * W, mpad = round_up(m, kWM), p0 = y0 * W;
    gemm_pass(
        mpad, Cm, Cin / kKC, wsa, pl.w_bytes,
        [&](int c, int buf) {
          load_b(w1t + c * kKC, Cin, Cm, buf);
          for (int i = threadIdx.x; i < mpad * 8; i += kTileThreads) {
            const int r = i >> 3, seg = (i & 7) * 8, p = p0 + r;
            const bool ok = r < m && p >= 0 && p < H * W;
            cp_async16(xs + buf * xstep + r * kLDC + seg,
                       ok ? xn + (size_t)p * Cin + c * kKC + seg : xn, ok);
          }
        },
        [] {},
        [&](int, int buf) -> const bf16* { return xs + buf * xstep; },
        [&](int r) { return r * kLDC; }, b1,
        [&](int r) {  // h1 element of pixel r, whether it is in the image
          return make_int2(r < m ? ((row0 + r / W) * P + r % W + 1) * ldh : -1,
                           p0 + r >= 0 && p0 + r < H * W);
        },
        [&](int2 rv, int col, float v0, float v1) {
          if (rv.x >= 0)
            store2(h1s + rv.x + col, rv.y ? fmaxf(v0, 0.f) : 0.f,
                   rv.y ? fmaxf(v1, 0.f) : 0.f);
        });
  };

  for (long long g = g0; g < g1; ++g) {
    const int n = (int)(g / spf), r0 = (int)(g % spf) * TH;
    xn = x + (size_t)n * H * W * Cin;
    on = out + (size_t)n * H * W * Cin;
    if (g == g0 || r0 == 0 || TH < 2) {
      conv1(0, r0 - 1, 2);  // the top two h1 rows: image rows r0-1, r0
    } else {  // carry the last two h1 rows to the top
      const int4* src =
          reinterpret_cast<const int4*>(h1s + (size_t)TH * P * ldh);
      int4* dst = reinterpret_cast<int4*>(h1s);
      const int n16 = 2 * P * ldh / 8;
      for (int i = threadIdx.x; i < n16; i += kTileThreads) dst[i] = src[i];
    }
    // 1. h1 rows 2 .. TH+1: image rows r0+1 .. r0+TH
    conv1(2, r0 + 1, TH);

    // 2. h2 = relu(conv3x3(h1) + b2): per chunk one tap and 64 channels;
    // pixel r reads h1 slot (r/W + dy) * P + r%W + dx
    gemm_pass(
        pl.mpad, Cm, 9 * cpt, wsa, pl.w_bytes,
        [&](int c, int buf) {
          load_b(w2t + (size_t)(c / cpt) * Cm * Cm + (c % cpt) * kKC, Cm, Cm,
                 buf);
        },
        [] {},
        [&](int c, int) -> const bf16* {
          const int tap = c / cpt;
          return h1s + (size_t)((tap / 3) * P + tap % 3) * ldh +
                 (c % cpt) * kKC;
        },
        [&](int r) { return r < pl.m ? ((r / W) * P + r % W) * ldh : 0; }, b2,
        [&](int r) { return r * ldh; },
        [&](int rv, int col, float v0, float v1) {
          store2(h2s + rv + col, fmaxf(v0, 0.f), fmaxf(v1, 0.f));
        });

    // 3. out = relu(h2.W3 + b3 + x) for the step's pixels, which are
    // consecutive in x and out, in passes of ng3 columns. The pass's
    // residual rows are copied into `res` under its first chunk's
    // products; the epilogue adds them in fp32 and writes the cast result
    // in place; the pixels then leave in coalesced 16-byte stores.
    const int npx = min(TH, H - r0) * W;
    const bf16* xt = xn + (size_t)r0 * W * Cin;
    bf16* ot = on + (size_t)r0 * W * Cin;
    for (int n0 = 0; n0 < Cin; n0 += pl.ng3) {
      const int width = min(pl.ng3, Cin - n0), kpr = width / 8;
      gemm_pass(
          pl.mpad, width, cpt, wsa, pl.w_bytes,
          [&](int c, int buf) {
            load_b(w3t + (size_t)n0 * Cm + c * kKC, Cm, width, buf);
          },
          [&] {
            for (int i = threadIdx.x; i < npx * kpr; i += kTileThreads) {
              const int p = i / kpr, k = (i % kpr) * 8;
              cp_async16(res + res_at(p, k, width),
                         xt + (size_t)p * Cin + n0 + k, true);
            }
          },
          [&](int c, int) -> const bf16* { return h2s + c * kKC; },
          [&](int r) { return r * ldh; }, b3 + n0,
          [&](int p) { return p < npx ? p : -1; },
          [&](int p, int col, float v0, float v1) {
            if (p >= 0) {
              bf16* r = res + res_at(p, col, width);
              const float2 xr = load2(r);
              store2(r, fmaxf(v0 + xr.x, 0.f), fmaxf(v1 + xr.y, 0.f));
            }
          });
      __syncthreads();
      for (int i = threadIdx.x; i < npx * kpr; i += kTileThreads) {
        const int p = i / kpr, k = (i % kpr) * 8;
        *reinterpret_cast<int4*>(ot + (size_t)p * Cin + n0 + k) =
            *reinterpret_cast<const int4*>(res + res_at(p, k, width));
      }
      __syncthreads();
    }
  }
}

// the tile height of the general path: 4 rows where shared memory allows
template <typename T>
int general_rows(int H, int W, int Cm) {
  for (int th : {4, 2, 1}) {
    th = th < H ? th : H;
    if (smem_bytes<T>(W, Cm, th) <= (size_t)kMaxSmem) return th;
  }
  return 0;
}

int tiled_rows(int H, int W, int Cin, int Cm) {
  for (int th : {4, 2, 1}) {
    th = th < H ? th : H;
    if (Plan(W, Cin, Cm, th).ok) return th;
  }
  return 0;
}

// The tiled path's grid: one block per SM, or one per step where there are
// fewer steps than SMs.
long long tiled_blocks(int N, int H, int TH) {
  int dev = 0, sms = 132;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const long long steps = (long long)N * ((H + TH - 1) / TH);
  return steps < sms ? steps : sms;
}

}  // namespace

extern "C" {

// Which kernel serves a shape: 2 = the tiled bf16 kernel, 1 = the general
// kernel, 0 = none (the shape does not fit shared memory).
int fused_bottleneck_path(int dtype, int H, int W, int Cin, int Cm) {
  if (Cin % 8 != 0 || Cm % 8 != 0 || H < 1 || W < 1) return 0;
  if (dtype == 1 && tiled_rows(H, W, Cin, Cm) > 0) return 2;
  const int th = dtype == 1 ? general_rows<__nv_bfloat16>(H, W, Cm)
                            : general_rows<float>(H, W, Cm);
  return th > 0 ? 1 : 0;
}

// dtype: 0 = float32, 1 = bfloat16. Launches on `stream` and returns the
// cudaError_t of the launch (0 = ok). Does not synchronize.
int fused_bottleneck_launch(int dtype, const void* x, const void* w1t,
                            const float* b1, const void* w2t, const float* b2,
                            const void* w3t, const float* b3, void* out, int N,
                            int H, int W, int Cin, int Cm, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int path = fused_bottleneck_path(dtype, H, W, Cin, Cm);
  if (path == 0 || (dtype != 0 && dtype != 1)) return (int)cudaErrorInvalidValue;
  int th;
  size_t smem;
  long long blocks;
  if (path == 2) {
    th = tiled_rows(H, W, Cin, Cm);
    smem = Plan(W, Cin, Cm, th).smem;
    blocks = tiled_blocks(N, H, th);
  } else if (dtype == 1) {
    th = general_rows<__nv_bfloat16>(H, W, Cm);
    smem = smem_bytes<__nv_bfloat16>(W, Cm, th);
    blocks = (long long)N * ((H + th - 1) / th);
  } else {
    th = general_rows<float>(H, W, Cm);
    smem = smem_bytes<float>(W, Cm, th);
    blocks = (long long)N * ((H + th - 1) / th);
  }
  if (blocks <= 0 || blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  using bf16 = __nv_bfloat16;
  cudaError_t err;
  if (path == 2) {
    err = cudaFuncSetAttribute(fused_bottleneck_bf16_tiled,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
    fused_bottleneck_bf16_tiled<<<(unsigned)blocks, kTileThreads, smem, s>>>(
        static_cast<const bf16*>(x), static_cast<const bf16*>(w1t), b1,
        static_cast<const bf16*>(w2t), b2, static_cast<const bf16*>(w3t), b3,
        static_cast<bf16*>(out), N, H, W, Cin, Cm, th);
  } else if (dtype == 1) {
    err = cudaFuncSetAttribute(fused_bottleneck_kernel<bf16>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
    fused_bottleneck_kernel<bf16><<<(unsigned)blocks, kThreads, smem, s>>>(
        static_cast<const bf16*>(x), static_cast<const bf16*>(w1t), b1,
        static_cast<const bf16*>(w2t), b2, static_cast<const bf16*>(w3t), b3,
        static_cast<bf16*>(out), H, W, Cin, Cm, th);
  } else {
    err = cudaFuncSetAttribute(fused_bottleneck_kernel<float>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
    fused_bottleneck_kernel<float><<<(unsigned)blocks, kThreads, smem, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(w1t), b1,
        static_cast<const float*>(w2t), b2, static_cast<const float*>(w3t),
        b3, static_cast<float*>(out), H, W, Cin, Cm, th);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
