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
// What bounds it on this card: bytes. At the flagship's layer1 mid-block
// (240 x 64 x 64, Cin 256, Cm 64, bf16) the function does 136.9 GFLOP and
// must move 1.007 GB (x read once, out written once), about 136 FLOP per
// byte against the H100's bf16 ridge of about 295. An unfused composite also
// writes and re-reads h1, h2 and the conv3 output. The design keeps h1 and
// h2 in shared memory so that x is read and out written once per pixel
// (plus the residual re-read of x, which hits L2 right after conv1 read it).
//
// Design. The TPU kernel holds a whole frame's padded h1 in VMEM; a layer1
// frame's padded h1 (66 x 66 x 64 bf16, about 557 KB) does not fit in one
// block's 227 KB of shared memory. So one block computes TH output rows of
// one frame:
//   1. conv1 + b1 + relu for image rows r0-1 .. r0+TH (a recomputed one-row
//      halo) into shared memory laid out as (TH+2) x (W+2) pixels with zero
//      pad columns and zero rows outside the image: the 3x3 pads with zeros
//      of h1, never with relu(b1).
//   2. The 3x3 + b2 + relu over the flattened padded tile: output slot q
//      reads input slot q + dy*(W+2) + dx, so every tap is one plain matrix
//      product over consecutive rows; the two pad columns produce rows that
//      are computed and dropped. Result into an h2 tile in shared memory.
//   3. conv3 + b3 + residual + relu, stored straight to out.
// Each product runs per warp as 16-row by 32-column tiles of mma.sync
// (m16n8k16 when K % 16 == 0, else m16n8k8) for bf16, and as scalar fp32
// FMAs with the same thread-to-element map for fp32. Weights are read from
// global memory through the read-only cache (they are shared by all blocks
// and stay in L2). wgmma, TMA and a persistent schedule are later work.
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
// flagship's). Same three stages over the same flattened padded tile, but
// each stage is a block-level matrix product: the weights (and, for conv1,
// the x rows) stream through shared memory in 64-wide K chunks with
// cp.async, double-buffered so the next chunk loads while this one is
// multiplied; fragments load with ldmatrix; each warp owns up to kTPW
// 32x32 output tiles of a pass and keeps their fp32 sums in registers
// across the chunks. The h1 tile, the h2 tile and the x chunks of conv1
// share the block's shared memory (x chunks and h2 are never live at once).

constexpr int kKC = 64;            // K chunk
constexpr int kLDC = kKC + 8;      // chunk row stride: conflict-free ldmatrix
constexpr int kTPW = 3;            // 32x32 tiles per warp per pass
constexpr int kTilesPerPass = kTPW * kWarps;

__host__ __device__ inline int round_up(int a, int b) {
  return (a + b - 1) / b * b;
}

__host__ __device__ inline int imax(int a, int b) { return a > b ? a : b; }

// widest n-group (a multiple of 32, at most n) whose tiles fit one pass
__host__ __device__ inline int group_width(int mpad, int n) {
  const int ng = (kTilesPerPass / (mpad / 32)) * 32;
  return ng < n ? ng : n;
}

struct Plan {
  int P, m1, m1pad, m2pad, ns1, ldh, ng1, ng2, ng3;
  size_t h1_bytes, mid_bytes, smem;
  bool ok;
  __host__ __device__ Plan(int W, int Cin, int Cm, int TH) {
    P = W + 2;
    m1 = (TH + 2) * W;                 // conv1 rows: the tile and its halo
    m1pad = round_up(m1, 32);
    m2pad = round_up(TH * P, 32);      // conv2/conv3 rows (padded columns)
    ns1 = m2pad + 2 * P + 2;           // h1 slots the taps may read
    ldh = Cm + 8;
    ng1 = group_width(m1pad, Cm);
    ng2 = group_width(m2pad, Cm);
    ng3 = group_width(m2pad, Cin);
    const int ngmax = imax(ng1, imax(ng2, ng3));
    h1_bytes = (size_t)ns1 * ldh * 2;
    const size_t h2 = (size_t)m2pad * ldh * 2;
    const size_t xa = (size_t)2 * m1pad * kLDC * 2;
    mid_bytes = h2 > xa ? h2 : xa;
    smem = h1_bytes + mid_bytes + (size_t)2 * ngmax * kLDC * 2;
    ok = Cin % kKC == 0 && Cm % kKC == 0 && ng1 >= 32 && ng2 >= 32 &&
         ng3 >= 32 && smem <= (size_t)kMaxSmem;
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

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// One pass of a block-level product over `nchunks` K chunks of 64:
// C[mpad x width] = A . B, where B^T rows (width of them) for chunk c are
// copied into bbuf[c % 2] by load(c, buf), and a_row(c, buf, r) points at
// row r of A for chunk c (k = 0) in shared memory. epi(r, col, v0, v1)
// consumes each pair of adjacent fp32 results.
template <class Load, class ARow, class Epi>
__device__ __forceinline__ void gemm_pass(int mpad, int width, int nchunks,
                                          __nv_bfloat16* const (&bbuf)[2],
                                          Load load, ARow a_row, Epi epi) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int ntn = width / 32, tiles = (mpad / 32) * ntn;
  float acc[kTPW][2][4][4];
#pragma unroll
  for (int i = 0; i < kTPW; ++i)
#pragma unroll
    for (int a = 0; a < 2; ++a)
#pragma unroll
      for (int b = 0; b < 4; ++b)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][a][b][e] = 0.f;

  load(0, 0);
  cp_async_commit();
  for (int c = 0; c < nchunks; ++c) {
    if (c + 1 < nchunks) load(c + 1, (c + 1) & 1);
    cp_async_commit();
    cp_async_wait1();
    __syncthreads();
    const __nv_bfloat16* bt = bbuf[c & 1];
#pragma unroll
    for (int ks = 0; ks < kKC; ks += 16) {
#pragma unroll
      for (int i = 0; i < kTPW; ++i) {
        const int t = warp + i * kWarps;
        if (t < tiles) {
          const int mi = t / ntn, ni = t % ntn;
          uint32_t af[2][4], bf[2][4];
#pragma unroll
          for (int mt = 0; mt < 2; ++mt)
            ldsm_x4(af[mt], a_row(c, c & 1, mi * 32 + mt * 16 + (lane & 15)) +
                                ks + (lane >> 4) * 8);
#pragma unroll
          for (int nb = 0; nb < 2; ++nb)
            ldsm_x4(bf[nb], bt + (ni * 32 + nb * 16 + (lane & 7) +
                                  ((lane >> 4) << 3)) * kLDC +
                                ks + ((lane >> 3) & 1) * 8);
#pragma unroll
          for (int mt = 0; mt < 2; ++mt)
#pragma unroll
            for (int nt = 0; nt < 4; ++nt)
              mma_k16(acc[i][mt][nt], af[mt][0], af[mt][1], af[mt][2],
                      af[mt][3], bf[nt >> 1][(nt & 1) * 2],
                      bf[nt >> 1][(nt & 1) * 2 + 1]);
        }
      }
    }
    __syncthreads();
  }

  const int g = lane >> 2, i2 = (lane & 3) * 2;
#pragma unroll
  for (int i = 0; i < kTPW; ++i) {
    const int t = warp + i * kWarps;
    if (t < tiles) {
      const int mi = t / ntn, ni = t % ntn;
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
#pragma unroll
          for (int h = 0; h < 2; ++h)
            epi(mi * 32 + mt * 16 + g + 8 * h, ni * 32 + nt * 8 + i2,
                acc[i][mt][nt][2 * h], acc[i][mt][nt][2 * h + 1]);
    }
  }
}

__global__ void __launch_bounds__(kThreads, 1)
fused_bottleneck_bf16_tiled(const __nv_bfloat16* __restrict__ x,
                            const __nv_bfloat16* __restrict__ w1t,
                            const float* __restrict__ b1,
                            const __nv_bfloat16* __restrict__ w2t,
                            const float* __restrict__ b2,
                            const __nv_bfloat16* __restrict__ w3t,
                            const float* __restrict__ b3,
                            __nv_bfloat16* __restrict__ out, int H, int W,
                            int Cin, int Cm, int TH) {
  using bf16 = __nv_bfloat16;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const Plan pl(W, Cin, Cm, TH);
  const int P = pl.P, ldh = pl.ldh;
  bf16* h1s = reinterpret_cast<bf16*>(smem_raw);
  bf16* mid = reinterpret_cast<bf16*>(smem_raw + pl.h1_bytes);
  bf16* h2s = mid;
  bf16* const abuf[2] = {mid, mid + (size_t)pl.m1pad * kLDC};
  bf16* bb = reinterpret_cast<bf16*>(smem_raw + pl.h1_bytes + pl.mid_bytes);
  const int ngmax = imax(pl.ng1, imax(pl.ng2, pl.ng3));
  bf16* const bbuf[2] = {bb, bb + (size_t)ngmax * kLDC};

  const int tiles = (H + TH - 1) / TH;
  const int n = blockIdx.x / tiles;
  const int r0 = (blockIdx.x % tiles) * TH;
  const bf16* xn = x + (size_t)n * H * W * Cin;
  bf16* on = out + (size_t)n * H * W * Cin;

  {  // pad columns and rows outside the image stay zero
    int4* p = reinterpret_cast<int4*>(h1s);
    const int n16 = (int)(pl.h1_bytes / 16);
    for (int i = threadIdx.x; i < n16; i += kThreads)
      p[i] = make_int4(0, 0, 0, 0);
  }

  // copies `rows` B^T rows of 64 values, row stride ld, into buffer buf
  auto load_b = [&](const bf16* src, int ld, int rows, int buf) {
    for (int i = threadIdx.x; i < rows * 8; i += kThreads) {
      const int r = i >> 3, seg = (i & 7) * 8;
      cp_async16(bbuf[buf] + r * kLDC + seg, src + (size_t)r * ld + seg,
                 true);
    }
  };

  // 1. h1 = relu(x.W1 + b1) for image rows r0-1 .. r0+TH
  for (int n0 = 0; n0 < Cm; n0 += pl.ng1) {
    const int width = min(pl.ng1, Cm - n0);
    gemm_pass(
        pl.m1pad, width, Cin / kKC, bbuf,
        [&](int c, int buf) {
          load_b(w1t + (size_t)n0 * Cin + c * kKC, Cin, width, buf);
          for (int i = threadIdx.x; i < pl.m1pad * 8; i += kThreads) {
            const int m = i >> 3, seg = (i & 7) * 8;
            const int y = r0 - 1 + m / W;
            const bool ok = m < pl.m1 && y >= 0 && y < H;
            const bf16* src =
                ok ? xn + ((size_t)y * W + m % W) * Cin + c * kKC + seg : xn;
            cp_async16(abuf[buf] + m * kLDC + seg, src, ok);
          }
        },
        [&](int, int buf, int r) -> const bf16* {
          return abuf[buf] + r * kLDC;
        },
        [&](int m, int col, float v0, float v1) {
          const int y = r0 - 1 + m / W;
          if (m < pl.m1 && y >= 0 && y < H) {
            col += n0;
            store2(h1s + (size_t)((m / W) * P + m % W + 2) * ldh + col,
                   fmaxf(v0 + b1[col], 0.f), fmaxf(v1 + b1[col + 1], 0.f));
          }
        });
  }

  // 2. h2 = relu(conv3x3(h1) + b2): per chunk one tap and 64 channels
  const int cpt = Cm / kKC;
  for (int n0 = 0; n0 < Cm; n0 += pl.ng2) {
    const int width = min(pl.ng2, Cm - n0);
    gemm_pass(
        pl.m2pad, width, 9 * cpt, bbuf,
        [&](int c, int buf) {
          load_b(w2t + ((size_t)(c / cpt) * Cm + n0) * Cm + (c % cpt) * kKC,
                 Cm, width, buf);
        },
        [&](int c, int, int r) -> const bf16* {
          const int tap = c / cpt;
          return h1s + (size_t)(r + (tap / 3) * P + tap % 3) * ldh +
                 (c % cpt) * kKC;
        },
        [&](int q, int col, float v0, float v1) {
          col += n0;
          store2(h2s + (size_t)q * ldh + col, fmaxf(v0 + b2[col], 0.f),
                 fmaxf(v1 + b2[col + 1], 0.f));
        });
  }

  // 3. out = relu(h2.W3 + b3 + x) for the tile's valid pixels
  for (int n0 = 0; n0 < Cin; n0 += pl.ng3) {
    const int width = min(pl.ng3, Cin - n0);
    gemm_pass(
        pl.m2pad, width, cpt, bbuf,
        [&](int c, int buf) {
          load_b(w3t + (size_t)n0 * Cm + c * kKC, Cm, width, buf);
        },
        [&](int c, int, int r) -> const bf16* {
          return h2s + (size_t)r * ldh + c * kKC;
        },
        [&](int q, int col, float v0, float v1) {
          const int y = r0 + q / P, cc = q % P;
          if (q < TH * P && y < H && cc >= 1 && cc <= W) {
            col += n0;
            const size_t off = ((size_t)y * W + cc - 1) * Cin + col;
            const float2 r = load2(xn + off);
            store2(on + off, fmaxf(v0 + b3[col] + r.x, 0.f),
                   fmaxf(v1 + b3[col + 1] + r.y, 0.f));
          }
        });
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
  if (path == 2) {
    th = tiled_rows(H, W, Cin, Cm);
    smem = Plan(W, Cin, Cm, th).smem;
  } else if (dtype == 1) {
    th = general_rows<__nv_bfloat16>(H, W, Cm);
    smem = smem_bytes<__nv_bfloat16>(W, Cm, th);
  } else {
    th = general_rows<float>(H, W, Cm);
    smem = smem_bytes<float>(W, Cm, th);
  }
  const long long blocks = (long long)N * ((H + th - 1) / th);
  if (blocks <= 0 || blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  using bf16 = __nv_bfloat16;
  cudaError_t err;
  if (path == 2) {
    err = cudaFuncSetAttribute(fused_bottleneck_bf16_tiled,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
    fused_bottleneck_bf16_tiled<<<(unsigned)blocks, kThreads, smem, s>>>(
        static_cast<const bf16*>(x), static_cast<const bf16*>(w1t), b1,
        static_cast<const bf16*>(w2t), b2, static_cast<const bf16*>(w3t), b3,
        static_cast<bf16*>(out), H, W, Cin, Cm, th);
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
