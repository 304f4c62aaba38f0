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
// ikw, ci). A 2-D conv is the case T = kt = 1. Cin is a multiple of 16:
// the wrapper zero-pads thinner channels (zeros add nothing to the sum).
// Epilogues: the int32 accumulators themselves (the integer carry), or acc
// as f32 x scale[c] (+ bias[c]) cast to f32 or bf16, rounded as the plain
// version rounds: __int2float_rn, then __fmul_rn, then __fadd_rn (with -O3
// nvcc would otherwise contract the two into an FMA).
//
// What bounds it on this card: the int8 ridge is about 590 operations a
// byte (1,979 TOPS over 3.35 TB/s). R50's 1x1 convs (2 x Cout MACs a byte
// of x at K = Cin) sit below it and are bound by the bytes of x and of the
// output; its 3x3 convs from layer2 on sit above it and are bound by the
// tensor cores.
//
// The design. Both kernels compute 128 x BN output tiles (BN = 64, 128 or
// 256, a template argument the wrapper chooses per launch: the narrowest
// that covers Cout, so that x is read once for Cout <= 256), 64 rows per
// warpgroup, with wgmma.mma_async m64nBNk32 s32.s8.s8, both operands
// K-major in shared memory in the 128-byte swizzled layout (8-bit wgmma
// takes no transpose) and read through matrix descriptors; K moves in
// stages of 128 bytes, four k32 steps each. The epilogue stages the
// products in shared memory, padded rows against bank conflicts, and
// writes each row out in the widest piece (16, 8, 4 or 2 bytes) that
// divides it, a row's pieces from neighbouring threads.
//
// - int8_conv_tma, for a 1x1 stride-1 unpadded conv, where x is the
//   im2col matrix itself (most of the flagship's launches, all of them
//   bound by bytes), and for a conv whose 128-pixel tiles are whole output
//   rows or images with Cin a multiple of 64 (R50's 3x3 convs and strided
//   shortcuts, I3D's 1x3x3), where a stage's A tile is one box of x at a
//   tap's offset, strided as the conv is, zeros in the padding (stages of
//   64 bytes of K in the 64-byte swizzle where Cin is an odd multiple of
//   64, so that a stage lies in one tap, or where they leave less of the
//   last stage empty): a
//   persistent block per SM, one producer thread that streams A's and B's
//   tiles by tiled TMA into a ring of 3-8 stages (as many as shared memory
//   holds) on full/empty mbarriers, running ahead across tiles, and two
//   consumer warpgroups that keep one stage of wgmma in flight, then stage
//   and write their rows while the producer fills the ring for the next
//   tile.
// - int8_conv_gather, for every other conv (temporal kernels, Cin not a
//   multiple of 64, odd map sizes): all 256 threads gather A's im2col
//   rows (and B's rows) per 16-byte piece with cp.async, zero-filled
//   outside the image and past K, into their swizzled addresses, a ring
//   of up to four stages kept three ahead. The gather's throughput grows
//   with the threads that run it: a single producer warpgroup gathering
//   for two consumers ran these shapes at half this kernel's speed.
//
// Built by nvcc into a shared library with a plain C interface, loaded by
// mvfnet_tpu_torch/ops/_cuda.py through ctypes.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBM = 128;          // output pixels a tile: 64 a warpgroup
constexpr int kBK = 128;          // K bytes a stage: one swizzle row
constexpr int kRowPad = 8;        // staged output row: columns + 8
constexpr int kSmem = 232448;     // a block's shared memory on sm_90

// The gathering kernel: two warpgroups that gather and multiply.
constexpr int kGatherThreads = 256;
constexpr int kGatherStages = 4;  // at most

// The TMA kernel: two consumer warpgroups, then one producer warp.
constexpr int kConsumers = 2;
constexpr int kTmaThreads = 128 * kConsumers + 32;

// The TMA kernel's ring: stages of KB bytes of K (128, or 64 where Cin is
// an odd multiple of 64) for A (128 rows) and B (BN rows), as many as fit
// (up to 8) beside the barriers and the consumers' staging buffers of
// kCols columns: at KB 128, 7-8 stages at BN 64, 4-5 at 128, 3 at 256.
template <int BN, int KB, typename Out>
struct Ring {
  static constexpr int kA = kBM * KB;
  static constexpr int kStage = kA + BN * KB;
  static constexpr int kCols = BN < 128 ? BN : 128;   // staged at a time
  static constexpr int kStaged =
      kConsumers * 64 * (kCols + kRowPad) * static_cast<int>(sizeof(Out));
  static constexpr int kFit = (kSmem - 2048 - kStaged) / kStage;
  static constexpr int kStages = kFit < 8 ? kFit : 8;
  static constexpr int kBytes = 2048 + kStages * kStage + kStaged;
};

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

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// wait until at most `pending` (0-2) of this thread's groups are in flight
__device__ __forceinline__ void cp_async_wait(int pending) {
  if (pending >= 2)
    asm volatile("cp.async.wait_group 2;\n" ::: "memory");
  else if (pending == 1)
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
  else
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// generic-proxy writes (cp.async) made visible to wgmma's async proxy
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Byte offset of 16-byte chunk `chunk` of row `row` in a tile of 128-byte
// rows under the 128-byte swizzle (the tile 1024-byte aligned): the chunk
// index XOR the row's index within its group of 8 rows.
__device__ __forceinline__ int swizzle(int row, int chunk) {
  return row * 128 + ((chunk ^ (row & 7)) << 4);
}

// wgmma matrix descriptor of a K-major operand in that layout, or in the
// 64-byte swizzle of rows of KB = 64 bytes: start address >> 4, leading
// byte offset 1 (unused when K is swizzled), stride byte offset 8 KB >> 4
// (from one group of 8 rows to the next), layout 128-byte (1) or 64-byte
// (2) swizzle. A k32 step adds 32 bytes to the start address.
template <int KB = kBK>
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (1ull << 16) |
         (static_cast<uint64_t>(8 * KB >> 4) << 32) |
         (static_cast<uint64_t>(KB == 128 ? 1 : 2) << 62);
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count));
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

// Wait for the phase of parity `parity` to complete. A wait longer than
// four seconds (a lost transfer, a broken ring) traps, which the next
// synchronize reports, rather than hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  unsigned long long since = 0;
  for (uint32_t spins = 1;; ++spins) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (spins % 1024 == 0) {
      unsigned long long now;
      asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(now));
      if (since == 0)
        since = now;
      else if (now - since > 4000000000ull)
        __trap();
    }
  }
}

// One box of a 2-D tensor map (128 bytes wide, 128-byte swizzle) into
// shared memory, its bytes counted on barrier `bar`.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         int col, int row, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(col), "r"(row), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// The 128 threads of one warpgroup (barrier 1 + its index).
__device__ __forceinline__ void warpgroup_sync(int wg) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
}

// One box of a 4-D tensor map (x as channels x W x H x images, strided
// along W and H) at element (c, w, h, n), its bytes counted on `bar`;
// coordinates outside x read zeros.
__device__ __forceinline__ void tma_load4(uint32_t dst, const CUtensorMap* map,
                                          int c, int w, int h, int n,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c), "r"(w), "r"(h), "r"(n),
      "r"(bar)
      : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_wait1() {
  asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
}

// d[BN / 2] += A (64 x 32, descriptor a) * B (BN x 32, descriptor b)^T;
// thread t of the warpgroup holds rows 16 (t / 32) + (t % 32) / 4 (+ 8) and
// columns 8 j + 2 (t % 4) (+ 1) in d[4 j .. 4 j + 3].
template <int BN>
__device__ __forceinline__ void wgmma_s8(int (&d)[BN / 2], uint64_t a,
                                         uint64_t b);

template <>
__device__ __forceinline__ void wgmma_s8<64>(int (&d)[32], uint64_t a,
                                              uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p;\n}\n"
      :
        "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
        "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
        "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
        "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
        "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31])
      : "l"(a), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_s8<128>(int (&d)[64], uint64_t a,
                                              uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p;\n}\n"
      :
        "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
        "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
        "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
        "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
        "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]),
        "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]),
        "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]), "+r"(d[49]),
        "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]),
        "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(a), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_s8<256>(int (&d)[128], uint64_t a,
                                              uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p;\n}\n"
      :
        "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
        "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
        "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
        "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
        "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]),
        "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]),
        "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]), "+r"(d[49]),
        "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]),
        "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]), "+r"(d[64]),
        "+r"(d[65]), "+r"(d[66]), "+r"(d[67]), "+r"(d[68]), "+r"(d[69]),
        "+r"(d[70]), "+r"(d[71]), "+r"(d[72]), "+r"(d[73]), "+r"(d[74]),
        "+r"(d[75]), "+r"(d[76]), "+r"(d[77]), "+r"(d[78]), "+r"(d[79]),
        "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]), "+r"(d[84]),
        "+r"(d[85]), "+r"(d[86]), "+r"(d[87]), "+r"(d[88]), "+r"(d[89]),
        "+r"(d[90]), "+r"(d[91]), "+r"(d[92]), "+r"(d[93]), "+r"(d[94]),
        "+r"(d[95]), "+r"(d[96]), "+r"(d[97]), "+r"(d[98]), "+r"(d[99]),
        "+r"(d[100]), "+r"(d[101]), "+r"(d[102]), "+r"(d[103]), "+r"(d[104]),
        "+r"(d[105]), "+r"(d[106]), "+r"(d[107]), "+r"(d[108]), "+r"(d[109]),
        "+r"(d[110]), "+r"(d[111]), "+r"(d[112]), "+r"(d[113]), "+r"(d[114]),
        "+r"(d[115]), "+r"(d[116]), "+r"(d[117]), "+r"(d[118]), "+r"(d[119]),
        "+r"(d[120]), "+r"(d[121]), "+r"(d[122]), "+r"(d[123]), "+r"(d[124]),
        "+r"(d[125]), "+r"(d[126]), "+r"(d[127])
      : "l"(a), "l"(b), "r"(1));
}

// Where output pixel m reads its input: the batch's base offset and the
// first input coordinate of each axis (negative inside the padding).
struct RowOrigin {
  long long base;   // element offset of frame (n, 0, 0, 0)
  int t0, h0, w0;
  bool valid;
};

__device__ __forceinline__ RowOrigin row_origin(const ConvShape& s,
                                                long long m64) {
  RowOrigin r;
  r.valid = m64 < s.m;
  const int m = r.valid ? static_cast<int>(m64) : 0;   // M < 2^31
  const int wo = m % s.wo;
  int q = m / s.wo;
  const int ho = q % s.ho;
  q /= s.ho;
  const int to = q % s.to;
  const int n = q / s.to;
  r.base = static_cast<long long>(n) * s.t * s.h * s.w * s.cin;
  r.t0 = to * s.st - s.pt;
  r.h0 = ho * s.sh - s.ph;
  r.w0 = wo * s.sw - s.pw;
  return r;
}

// One stage of the gathering kernel: thread t copies 16-byte chunk t % 8
// of A rows t / 8 + 32 i (i < 4), x's im2col rows, and of B rows t / 8 +
// 32 i (i < BN / 32), to their swizzled addresses, zero-filled outside
// the image and past K: a warp reads four whole rows of 128 contiguous
// bytes wherever a row's 128 bytes lie in one tap.
template <int BN>
__device__ __forceinline__ void gather_stage(
    const ConvShape& s, const int8_t* __restrict__ x,
    const int8_t* __restrict__ w, uint32_t a_smem, uint32_t b_smem, int k0,
    const RowOrigin (&rows)[4], long long n_base) {
  const int chunk = threadIdx.x & 7, row0 = threadIdx.x >> 3;
  const int k = k0 + chunk * 16;
  // the chunk's tap: the same for the thread's four rows
  int ikt = 0, ikh = 0, ikw = 0, ci = 0;
  const bool in_k = k < s.k;
  if (in_k) {
    const int tap = k / s.cin;
    ci = k - tap * s.cin;
    ikw = tap % s.kw;
    const int rest = tap / s.kw;
    ikh = rest % s.kh;
    ikt = rest / s.kh;
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const RowOrigin& r = rows[i];
    const int ti = r.t0 + ikt * s.dt;
    const int hi = r.h0 + ikh * s.dh;
    const int wi = r.w0 + ikw * s.dw;
    const bool ok = in_k && r.valid && ti >= 0 && ti < s.t && hi >= 0 &&
                    hi < s.h && wi >= 0 && wi < s.w;
    const long long off =
        ok ? r.base + ((static_cast<long long>(ti) * s.h + hi) * s.w + wi) *
                          s.cin + ci
           : 0;
    cp_async16(a_smem + swizzle(row0 + 32 * i, chunk), x + off, ok ? 16 : 0);
  }
#pragma unroll
  for (int i = 0; i < BN / 32; ++i) {
    const int row = row0 + 32 * i;
    const long long c = n_base + row;
    const bool ok = in_k && c < s.cout;
    cp_async16(b_smem + swizzle(row, chunk), ok ? w + c * s.k + k : w,
               ok ? 16 : 0);
  }
}

template <int EPI> struct OutType { using T = int; };
template <> struct OutType<1> { using T = float; };
template <> struct OutType<2> { using T = __nv_bfloat16; };

// Two neighbouring output columns of one row, rescaled unless EPI is 0.
template <int EPI>
__device__ __forceinline__ void store_pair(typename OutType<EPI>::T* dst,
                                           int v0, int v1, float s0,
                                           float s1, float b0, float b1,
                                           bool has_bias) {
  if constexpr (EPI == 0) {
    *reinterpret_cast<int2*>(dst) = make_int2(v0, v1);
  } else {
    float f0 = __fmul_rn(__int2float_rn(v0), s0);
    float f1 = __fmul_rn(__int2float_rn(v1), s1);
    if (has_bias) {
      f0 = __fadd_rn(f0, b0);
      f1 = __fadd_rn(f1, b1);
    }
    if constexpr (EPI == 1)
      *reinterpret_cast<float2*>(dst) = make_float2(f0, f1);
    else
      *reinterpret_cast<__nv_bfloat162*>(dst) =
          __halves2bfloat162(__float2bfloat16_rn(f0), __float2bfloat16_rn(f1));
  }
}

// A warpgroup's fragment of columns [8 j0, 8 j0 + kCols) of its 64 x BN
// products, rescaled, into `staged` (rows kCols + kRowPad apart): thread t
// holds rows 16 (t / 32) + (t % 32) / 4 (+ 8), columns 8 j + 2 (t % 4)
// (+ 1) in acc[4 j .. 4 j + 3].
template <int EPI, int BN, int kCols>
__device__ __forceinline__ void stage_fragment(
    typename OutType<EPI>::T* staged, const int (&acc)[BN / 2], int j0,
    long long c0, const ConvShape& s, const float* __restrict__ scale,
    const float* __restrict__ bias) {
  const int t = threadIdx.x & 127, lane = t & 31;
  const int r0 = (t >> 5) * 16 + (lane >> 2);
#pragma unroll
  for (int jj = 0; jj < kCols / 8; ++jj) {
    const int col = jj * 8 + (lane & 3) * 2;
    const long long c = c0 + col;
    float s0 = 0.f, s1 = 0.f, b0 = 0.f, b1 = 0.f;
    if (EPI != 0) {
      if (c < s.cout) {
        s0 = scale[c];
        if (bias) b0 = bias[c];
      }
      if (c + 1 < s.cout) {
        s1 = scale[c + 1];
        if (bias) b1 = bias[c + 1];
      }
    }
#pragma unroll
    for (int half = 0; half < 2; ++half)
      store_pair<EPI>(staged + (r0 + 8 * half) * (kCols + kRowPad) + col,
                      acc[4 * (j0 + jj) + 2 * half],
                      acc[4 * (j0 + jj) + 2 * half + 1], s0, s1, b0, b1,
                      bias != nullptr);
  }
}

// Staged rows (kCols columns, kCols + kRowPad apart) out to device memory
// from `threads` threads (t among them), V (16, 8, 4 or 2 bytes) a
// thread, a row's pieces from neighbouring threads; Cout * sizeof(Out) is
// a multiple of sizeof(V).
template <int kCols, typename Out, typename V>
__device__ __forceinline__ void write_rows(const Out* staged, Out* out,
                                           const ConvShape& s,
                                           long long m_base, long long c0,
                                           int rows, int ncols, int t,
                                           int threads) {
  constexpr int kVec = sizeof(V) / sizeof(Out), kPieces = kCols / kVec;
  for (int idx = t; idx < rows * kPieces; idx += threads) {
    const int row = idx / kPieces, col = (idx % kPieces) * kVec;
    const long long m = m_base + row;
    if (m < s.m && col < ncols)
      *reinterpret_cast<V*>(out + m * s.cout + c0 + col) =
          *reinterpret_cast<const V*>(staged + row * (kCols + kRowPad) + col);
  }
}

// write_rows with the widest piece that divides a row of the output.
template <int kCols, typename Out>
__device__ __forceinline__ void write_out(const Out* staged, Out* out,
                                          const ConvShape& s,
                                          long long m_base, long long c0,
                                          int rows, int t, int threads) {
  const long long left = s.cout - c0;
  const int ncols = left < kCols ? static_cast<int>(left) : kCols;
  const int row_bytes = s.cout * static_cast<int>(sizeof(Out));
  if (row_bytes % 16 == 0) {
    write_rows<kCols, Out, int4>(staged, out, s, m_base, c0, rows, ncols, t,
                                 threads);
  } else if (row_bytes % 8 == 0) {
    write_rows<kCols, Out, int2>(staged, out, s, m_base, c0, rows, ncols, t,
                                 threads);
  } else if (row_bytes % 4 == 0) {
    write_rows<kCols, Out, int>(staged, out, s, m_base, c0, rows, ncols, t,
                                threads);
  } else if constexpr (sizeof(Out) == 2) {
    write_rows<kCols, Out, unsigned short>(staged, out, s, m_base, c0, rows,
                                           ncols, t, threads);
  }
}

// epilogue EPI: 0 int32, 1 float32, 2 bfloat16 (the latter two rescaled).
//
// The gathering kernel, for every conv whose im2col matrix is not x
// itself: block b computes output tile (b / n_tiles, b % n_tiles), so the
// blocks of one row of tiles, which read the same x, run side by side.
// All 256 threads gather each stage of A and B into a ring of `stages`
// (2-4) slots with cp.async, kept stages - 1 ahead; both warpgroups then
// run four k32 wgmma on it, 64 rows each. The epilogue stages the whole
// tile in the ring's memory and writes it out row by row.
template <int BN, int EPI>
__global__ void __launch_bounds__(kGatherThreads, 1)
    int8_conv_gather(ConvShape s, const int8_t* __restrict__ x,
                     const int8_t* __restrict__ w, void* __restrict__ out,
                     const float* __restrict__ scale,
                     const float* __restrict__ bias, int stages,
                     int n_tiles) {
  using Out = typename OutType<EPI>::T;
  constexpr int kA = kBM * kBK, kStage = kA + BN * kBK;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const int tid = threadIdx.x, wg = tid >> 7;
  const long long m_base = static_cast<long long>(blockIdx.x / n_tiles) * kBM;
  const long long n_base = static_cast<long long>(blockIdx.x % n_tiles) * BN;

  RowOrigin rows[4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    rows[i] = row_origin(s, m_base + (tid >> 3) + 32 * i);

  int acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0;

  const uint32_t ring = smem_addr(smem);
  const int nk = (s.k + kBK - 1) / kBK;
  for (int st = 0; st < stages - 1; ++st) {
    if (st < nk)
      gather_stage<BN>(s, x, w, ring + st * kStage, ring + st * kStage + kA,
                       st * kBK, rows, n_base);
    cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait(stages - 2);   // stage kt has landed, for this thread
    fence_proxy_async();         // cp.async wrote, wgmma reads
    __syncthreads();             // for every thread; slot kt - 1 is free
    const int next = kt + stages - 1;
    if (next < nk) {
      const uint32_t slot = ring + (next % stages) * kStage;
      gather_stage<BN>(s, x, w, slot, slot + kA, next * kBK, rows, n_base);
    }
    cp_async_commit();
    const uint32_t a = ring + (kt % stages) * kStage + wg * 64 * kBK;
    const uint32_t b = ring + (kt % stages) * kStage + kA;
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < kBK / 32; ++ks)
      wgmma_s8<BN>(acc, smem_desc(a + ks * 32), smem_desc(b + ks * 32));
    wgmma_commit();
    wgmma_wait0();
  }
  cp_async_wait(0);
  __syncthreads();               // the ring is free: stage the tile there

  Out* tile = reinterpret_cast<Out*>(smem);
  stage_fragment<EPI, BN, BN>(tile + wg * 64 * (BN + kRowPad), acc, 0,
                              n_base, s, scale, bias);
  __syncthreads();
  write_out<BN>(tile, static_cast<Out*>(out), s, m_base, n_base, kBM, tid,
                kGatherThreads);
}

// The TMA kernel, for a conv whose A tiles TMA can copy: a 1x1 stride-1
// unpadded conv, whose im2col matrix is x itself (`taps` 0: a 2-D map of
// M x Cin), or one where a tile's 128 pixels are whole rows of an image
// or whole images and a stage's bytes of K lie in one tap (`taps` 1:
// a 4-D map of x, one box a stage at the tap's offset, strided along W
// and H as the conv is, zeros in the padding). A persistent block walks
// output tiles b, b + gridDim.x, ...; tile i is (i / n_tiles, i %
// n_tiles), so the blocks that run side by side share x's rows. One
// thread of the producer warp fills the ring: for each stage it waits for
// the slot's release, then starts the TMA copies of A's and B's tiles on
// the slot's full barrier, running ahead of the consumers across tiles.
// Each consumer warpgroup waits for a stage, runs four k32 wgmma on its 64
// rows, keeps one stage of products in flight and releases the stage
// before; after a tile's last stage it stages its rows in its own buffer,
// kCols columns at a time, and writes them out while the producer already
// fills the ring for the next tile.
template <int BN, int KB, int EPI>
__global__ void __launch_bounds__(kTmaThreads, 1)
    int8_conv_tma(const __grid_constant__ CUtensorMap map_a,
                  const __grid_constant__ CUtensorMap map_b, ConvShape s,
                  void* __restrict__ out, const float* __restrict__ scale,
                  const float* __restrict__ bias, int n_tiles,
                  long long tiles, int taps) {
  using Out = typename OutType<EPI>::T;
  using R = Ring<BN, KB, Out>;
  constexpr int kCols = R::kCols;
  extern __shared__ uint8_t smem_raw[];
  // the barriers, then (1024-byte aligned) the ring, then the staging
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const uint32_t full = smem_addr(smem), empty = full + 8 * R::kStages;
  const uint32_t ring = full + 1024;
  const int tid = threadIdx.x, wg = tid >> 7;
  const int nk = (s.k + KB - 1) / KB;
  if (tid == 0) {
    for (int i = 0; i < R::kStages; ++i) {
      mbar_init(full + 8 * i, 1);                 // the producer's expect_tx
      mbar_init(empty + 8 * i, 4 * kConsumers);   // each consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == kConsumers) {
    if (tid != 128 * kConsumers) return;   // one thread starts the copies
    int st = 0;
    for (long long tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      const int m_base = static_cast<int>(tile / n_tiles) * kBM;
      const int n_base = static_cast<int>(tile % n_tiles) * BN;
      // the tile's first image (frames count as images) and output row
      const int image = m_base / (s.ho * s.wo);
      const int row = m_base % (s.ho * s.wo) / s.wo;
      for (int kt = 0; kt < nk; ++kt, ++st) {
        const int slot = st % R::kStages;
        const uint32_t a = ring + slot * R::kStage, bar = full + 8 * slot;
        mbar_wait(empty + 8 * slot, ((st / R::kStages) & 1) ^ 1);
        mbar_expect_tx(bar, R::kStage);
        tma_load(a + R::kA, &map_b, kt * KB, n_base, bar);
        if (taps) {
          const int tap = kt * KB / s.cin, c0 = kt * KB - tap * s.cin;
          tma_load4(a, &map_a, c0, tap % s.kw * s.dw - s.pw,
                    row * s.sh - s.ph + tap / s.kw * s.dh, image, bar);
        } else {
          tma_load(a, &map_a, kt * KB, m_base, bar);
        }
      }
    }
    return;
  }

  const int lane = tid & 31;
  Out* staged = reinterpret_cast<Out*>(smem + 1024 + R::kStages * R::kStage) +
                wg * 64 * (kCols + kRowPad);
  int st = 0;
  for (long long tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const long long m_base = tile / n_tiles * kBM + wg * 64;
    const long long n_base = tile % n_tiles * BN;
    int acc[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0;
    for (int kt = 0; kt < nk; ++kt, ++st) {
      const int slot = st % R::kStages;
      mbar_wait(full + 8 * slot, (st / R::kStages) & 1);
      const uint32_t a = ring + slot * R::kStage + wg * 64 * KB;
      const uint32_t b = ring + slot * R::kStage + R::kA;
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < KB / 32; ++ks)
        wgmma_s8<BN>(acc, smem_desc<KB>(a + ks * 32),
                     smem_desc<KB>(b + ks * 32));
      wgmma_commit();
      wgmma_wait1();                     // stage kt - 1's products are done
      if (kt > 0 && lane == 0)
        mbar_arrive(empty + 8 * ((st - 1) % R::kStages));
    }
    wgmma_wait0();
    if (lane == 0) mbar_arrive(empty + 8 * ((st - 1) % R::kStages));
#pragma unroll
    for (int pass = 0; pass < BN / kCols; ++pass) {
      const long long c0 = n_base + pass * kCols;
      stage_fragment<EPI, BN, kCols>(staged, acc, pass * (kCols / 8), c0, s,
                                     scale, bias);
      warpgroup_sync(wg);
      write_out<kCols>(staged, static_cast<Out*>(out), s, m_base, c0, 64,
                       tid & 127, 128);
      warpgroup_sync(wg);                // the buffer is free again
    }
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up through the runtime (no -lcuda).
EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                     cudaEnableDefault, &q);
#else
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                            &q);
#endif
    return q == cudaDriverEntryPointSuccess ? reinterpret_cast<EncodeTiled>(p)
                                            : nullptr;
  }();
  return fn;
}

// The swizzle of rows of kb (128 or 64) bytes.
CUtensorMapSwizzle swizzle_of(int kb) {
  return kb == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B;
}

// A row-major int8 matrix (rows x cols, rows `ld` bytes apart) in boxes of
// box_rows x kb bytes, swizzled; zeros past its edges.
bool tensor_map(CUtensorMap* map, const void* base, long long rows,
                int cols, long long ld, int box_rows, int kb) {
  const EncodeTiled encode = encode_tiled();
  if (!encode) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(ld)};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(kb),
                             static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t elem[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2,
                const_cast<void*>(base), dims, strides, box, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle_of(kb),
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int BN, int EPI>
int launch_gather(const ConvShape& s, const int8_t* x, const int8_t* w,
                  void* out, const float* scale, const float* bias,
                  cudaStream_t stream) {
  using Out = typename OutType<EPI>::T;
  constexpr size_t kStage = static_cast<size_t>(kBM + BN) * kBK;
  const int nk = (s.k + kBK - 1) / kBK;
  const int stages =
      nk < 2 ? 2 : (nk > kGatherStages ? kGatherStages : nk);
  const size_t ring = (nk < stages ? nk : stages) * kStage;
  const size_t staged = static_cast<size_t>(kBM) * (BN + kRowPad) * sizeof(Out);
  const size_t bytes = (ring > staged ? ring : staged) + 1024;  // alignment
  auto kernel = int8_conv_gather<BN, EPI>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kGatherStages * kStage + 1024));
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long m_tiles = (s.m + kBM - 1) / kBM;
  const int n_tiles = (s.cout + BN - 1) / BN;
  if (m_tiles * n_tiles > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  kernel<<<static_cast<unsigned>(m_tiles * n_tiles), kGatherThreads, bytes,
           stream>>>(s, x, w, out, scale, bias, stages, n_tiles);
  return static_cast<int>(cudaGetLastError());
}

// x (N*T images of H x W x Cin) in boxes of kb bytes of Cin x Wo x rows x
// images, strided along W and H by the conv's strides: a tile of 128
// output pixels for one tap. Zeros outside x.
bool taps_map(CUtensorMap* map, const void* x, const ConvShape& s, int kb) {
  const EncodeTiled encode = encode_tiled();
  const int hw = s.ho * s.wo;
  int rows, images;
  if (hw % kBM == 0 && kBM % s.wo == 0) {
    rows = kBM / s.wo;
    images = 1;
  } else if (kBM % hw == 0) {
    rows = s.ho;
    images = kBM / hw;
  } else {
    return false;
  }
  if (!encode) return false;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(s.cin),
                              static_cast<cuuint64_t>(s.w),
                              static_cast<cuuint64_t>(s.h),
                              static_cast<cuuint64_t>(s.n) * s.t};
  const cuuint64_t strides[3] = {
      static_cast<cuuint64_t>(s.cin),
      static_cast<cuuint64_t>(s.w) * s.cin,
      static_cast<cuuint64_t>(s.h) * s.w * s.cin};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(kb),
                             static_cast<cuuint32_t>(s.wo * s.sw),
                             static_cast<cuuint32_t>(rows * s.sh),
                             static_cast<cuuint32_t>(images)};
  const cuuint32_t elem[4] = {1, static_cast<cuuint32_t>(s.sw),
                              static_cast<cuuint32_t>(s.sh), 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 4, const_cast<void*>(x),
                dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                swizzle_of(kb), CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int BN, int KB, int EPI>
int launch_tma_kb(const ConvShape& s, const int8_t* x, const int8_t* w,
                  void* out, const float* scale, const float* bias, int taps,
                  cudaStream_t stream) {
  using Out = typename OutType<EPI>::T;
  const int bytes = Ring<BN, KB, Out>::kBytes;
  auto kernel = int8_conv_tma<BN, KB, EPI>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  alignas(64) CUtensorMap map_a{}, map_b{};
  if (!tensor_map(&map_b, w, s.cout, s.k, s.k, BN, KB) ||
      !(taps ? taps_map(&map_a, x, s, KB)
             : tensor_map(&map_a, x, s.m, s.cin, s.cin, kBM, KB)))
    return static_cast<int>(cudaErrorInvalidValue);
  int device = 0, sms = 0;
  if ((err = cudaGetDevice(&device)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    device)) != cudaSuccess)
    return static_cast<int>(err);
  const int n_tiles = (s.cout + BN - 1) / BN;
  const long long tiles = (s.m + kBM - 1) / kBM * n_tiles;
  const unsigned grid = static_cast<unsigned>(tiles < sms ? tiles : sms);
  kernel<<<grid, kTmaThreads, bytes, stream>>>(map_a, map_b, s, out, scale,
                                               bias, n_tiles, tiles, taps);
  return static_cast<int>(cudaGetLastError());
}

// Stages of 128 bytes of K, or of 64: where a tap's Cin is an odd
// multiple of 64 (a stage lies in one tap), or where 64-byte stages leave
// less of the last one empty (K % 128 in 1-64: Cin 48, 64, 192 at 1x1).
template <int BN, int EPI>
int launch_tma(const ConvShape& s, const int8_t* x, const int8_t* w,
               void* out, const float* scale, const float* bias, int taps,
               cudaStream_t stream) {
  const int tail = s.k % 128;
  return (taps ? s.cin % 128 == 0 : tail == 0 || tail > 64)
             ? launch_tma_kb<BN, 128, EPI>(s, x, w, out, scale, bias, taps,
                                           stream)
             : launch_tma_kb<BN, 64, EPI>(s, x, w, out, scale, bias, taps,
                                          stream);
}

// a_path: 0 gather, 1 TMA of x as a matrix, 2 TMA of x a tap a stage
template <int BN>
int launch_bn(const ConvShape& s, const int8_t* x, const int8_t* w,
              void* out, const float* scale, const float* bias,
              int epilogue, int a_path, cudaStream_t stream) {
  const int taps = a_path == 2;
  switch (epilogue * 2 + (a_path != 0)) {
    case 0: return launch_gather<BN, 0>(s, x, w, out, scale, bias, stream);
    case 1: return launch_tma<BN, 0>(s, x, w, out, scale, bias, taps, stream);
    case 2: return launch_gather<BN, 1>(s, x, w, out, scale, bias, stream);
    case 3: return launch_tma<BN, 1>(s, x, w, out, scale, bias, taps, stream);
    case 4: return launch_gather<BN, 2>(s, x, w, out, scale, bias, stream);
    case 5: return launch_tma<BN, 2>(s, x, w, out, scale, bias, taps, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

// The interface's version: 2 takes the tile width and the A path in
// dims[21..22] and Cin a multiple of 16 (the first kernel took 21 dims and
// any Cin).
int int8_conv_abi(void) { return 2; }

// dims: n t h w cin, to ho wo cout, kt kh kw, st sh sw, pt ph pw, dt dh dw,
// then the tile width BN (64, 128 or 256) and x's path: 0 gathered, 1 by
// TMA as a matrix (a 1x1 stride-1 conv without padding), 2 by TMA a tap a
// stage (kt 1, no temporal stride or padding, Cin a multiple of 64, 128
// output pixels whole rows or whole images) (23 ints). Cin must be a
// multiple of 16 and x and w 16-byte aligned. Returns the launch's
// cudaError_t.
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
  const int a_path = dims[22];
  const bool plain = s.kt * s.kh * s.kw == 1 && s.st * s.sh * s.sw == 1 &&
                     s.pt + s.ph + s.pw == 0;
  const bool taps = s.kt == 1 && s.st == 1 && s.pt == 0 && s.cin % 64 == 0;
  if (s.cin % 16 != 0 || reinterpret_cast<uintptr_t>(x) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(w) % 16 != 0 || a_path < 0 ||
      a_path > 2 || (a_path == 1 && !plain) || (a_path == 2 && !taps))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* xi = static_cast<const int8_t*>(x);
  const auto* wi = static_cast<const int8_t*>(w);
  const auto* sc = static_cast<const float*>(scale);
  const auto* bi = static_cast<const float*>(bias);
  const auto st = static_cast<cudaStream_t>(stream);
  switch (dims[21]) {
    case 64:
      return launch_bn<64>(s, xi, wi, out, sc, bi, epilogue, a_path, st);
    case 128:
      return launch_bn<128>(s, xi, wi, out, sc, bi, epilogue, a_path, st);
    case 256:
      return launch_bn<256>(s, xi, wi, out, sc, bi, epilogue, a_path, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
