// Int8-weight matrix product for Hopper (sm_90a): the int8 backbone tier.
//
// Replaces the Pallas kernel `_qmm_kernel` / `_qmm_call` of
// src/repro/kernels/quant_matmul.py:
//
//   y[m, n] = (sum_k f32(x[m, k]) * f32(q[k, n])) * scale[n]
//
// rounded once to bf16.  The sum is taken in f32 and the per-column scale is
// applied after it, as the Pallas kernel's emit does.  The weight exists in
// device memory only as int8 and is widened to bf16 on chip, which is exact
// (|q| <= 127 has 7 significant bits); a bf16 x bf16 product is exact in
// f32, so the tensor cores form the same products as the TPU kernel and only
// the order of the f32 sum differs.
//
// What bounds it on the H100:
//   * decode (M = 8): the weight bytes, K*N int8 read once, against
//     2*M*K*N operations: about 16 operations per weight byte, far below
//     the ~295 at which bf16 tensor cores become the limit.
//   * prefill and training (M = 4096, 2816): the tensor-core operations,
//     2*M*K*N at 989 TFLOP/s.
//
// Both kernels compute the swapped product y^T = q^T x^T: the weight's
// columns n are the rows of the tensor cores' A operand and the tokens their
// columns.  A's fragments are widened from raw int8 in registers, so no
// bf16 copy of the weight is ever written to shared memory.  A thread's two
// fragment rows (g and g + 8 of a 16-row tile) are taken as the adjacent
// columns n = 2g and 2g + 1, so that one 16-bit load brings both rows at one
// k and two adjacent outputs of y leave as one 4-byte store.  int8 -> bf16
// is integer work plus one bf16x2 subtraction: for a byte b,
// bf16(128 + (b & 0x7f)) - bf16(b < 0 ? 256 : 128), exact.
//
// Prefill and training (M > 64), `qmm_wgmma_kernel`: one block computes
// 128 columns n x 256 tokens over all of K.  One thread of a producer
// warpgroup (which hands most of its registers to the consumers' 128 f32
// accumulators by setmaxnreg) keeps a ring of 4 stages full with TMA
// (cp.async.bulk.tensor): the x tile [256][64] bf16 and the raw q tile
// [64][128] int8, both in the 128-byte swizzle, each stage's arrival
// reported to an mbarrier.  Two consumer warpgroups take 64 columns each:
// per stage they widen their A fragments from the q tile and issue four
// wgmma m64n256k16 (A in registers, B = the x tile through its
// shared-memory descriptor), then free the stage on a second mbarrier.
// The tensor maps are encoded on the host per call through the driver's
// cuTensorMapEncodeTiled, reached by cudaGetDriverEntryPoint (no -lcuda).
// TMA needs K % 8 == 0, N % 16 == 0 and 16-byte aligned x and q (and the
// epilogue an 8-byte aligned scale, read as float2); other operands take
// the mma.sync kernel below at any M.  The other way to widen, into a
// shared-memory bf16 B tile read by wgmma, measured 79% slower: 16 KB more
// written and read a stage, and a barrier between the two warpgroups.
//
// Decode (M <= 64), `qmm_mma_kernel`: mma.sync.m16n8k16 with the tokens on
// the n8 side, so M = 8 wastes no row.  A block computes 128 columns n over
// a share of K; a thread-block cluster of up to 16 blocks splits K, and the
// partial sums meet through distributed shared memory: each block sums a
// slice of the columns over the cluster in rank order, its remote reads
// issued together, then scales and rounds once.  One launch, no f32
// scratch in device memory, no atomics.  Raw int8 q streams through a
// 4-stage 16-byte cp.async ring (3 tiles of 8 KB in flight a block).  The
// time at decode is a floor of about 7 us a launch more than the bytes,
// most of it each cluster's wait for its slowest block: an 8-stage ring,
// 256- or 512-column tiles, an L2 prefetch hint and partials pushed by
// st.async instead of read were no faster, and more blocks than SMs (the
// wrapper doubles the cluster only below that) slower.  Operands that
// forbid 16-byte copies take element loads; M > 64 runs the same kernel
// over slices of 64 tokens (gridDim.z).
//
// Every sum runs in a fixed order: two runs give the same bits.

#include <cooperative_groups.h>
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Two int8 in the low bytes of the 16-bit lanes of t (0x00bb00aa) -> two
// bf16 (low lane = a), exact.
__device__ __forceinline__ uint32_t widen_pair(uint32_t t) {
  const uint32_t v = (t & 0x007F007Fu) | 0x43004300u;  // 128 + (b & 0x7f)
  const uint32_t s = (t & 0x00800080u) | 0x43004300u;  // 128, or 256 where b < 0
  __nv_bfloat162 r = __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&v),
                             *reinterpret_cast<const __nv_bfloat162*>(&s));
  return *reinterpret_cast<uint32_t*>(&r);
}

// A fragment (16 rows n x 16 k, mma.m16n8k16's A layout) of q^T from a raw
// int8 tile [k][128 n] whose 16-byte chunks are swizzled by k % 8: `chunk`
// is the 16-column group of the tile's rows, `k0` the first k.  Rows g and
// g + 8 are the columns 2g and 2g + 1 of the group.
__device__ __forceinline__ void q_frag(uint32_t (&a)[4], const uint8_t* tile, int chunk, int k0) {
  const int lane = threadIdx.x & 31, g = lane >> 2, c = lane & 3;
  uint32_t w[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int k = k0 + 2 * c + (e & 1) + (e >> 1) * 8;
    w[e] = *reinterpret_cast<const uint16_t*>(tile + k * 128 + ((chunk ^ (k & 7)) << 4) + 2 * g);
  }
  a[0] = widen_pair(__byte_perm(w[0], w[1], 0x6420));  // row g:     k 2c, 2c + 1
  a[1] = widen_pair(__byte_perm(w[0], w[1], 0x6521));  // row g + 8: k 2c, 2c + 1
  a[2] = widen_pair(__byte_perm(w[2], w[3], 0x6420));  // row g:     k 2c + 8, 2c + 9
  a[3] = widen_pair(__byte_perm(w[2], w[3], 0x6521));  // row g + 8: k 2c + 8, 2c + 9
}

// ---------------------------------------------------------------------------
// M > 64: wgmma, TMA, mbarriers
// ---------------------------------------------------------------------------

constexpr int WG_BN = 128;     // columns n of a block: 2 consumer warpgroups x 64
constexpr int WG_BT = 256;     // tokens of a block: wgmma's N
constexpr int WG_BK = 64;      // k of a stage: one 128-byte swizzle row of x
constexpr int WG_STAGES = 4;
constexpr int WG_THREADS = 3 * 128;  // two consumer warpgroups, then the producer's
constexpr int WG_X_STAGE = WG_BT * WG_BK * 2;  // bytes
constexpr int WG_Q_STAGE = WG_BK * WG_BN;
constexpr int WG_SMEM = WG_STAGES * (WG_X_STAGE + WG_Q_STAGE) + 1024;  // + alignment slack

__device__ __forceinline__ void mbar_init(uint64_t* b, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(b)), "r"(count));
}

__device__ __forceinline__ void mbar_arrive(uint64_t* b) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(b)) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* b, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(b)),
               "r"(bytes)
               : "memory");
}

// until the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint64_t* b, int parity) {
  uint32_t done = 0;
  while (!done)
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(b)), "r"(parity)
        : "memory");
}

// box of a 2-d tensor map at coordinates (c0 inner, c1 outer) -> shared,
// completion reported to `bar` in bytes
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}

// wgmma descriptor of a K-major bf16 tile in the 128-byte swizzle: rows of
// 64 bf16 (128 bytes), 8-row groups 1024 bytes apart
__device__ __forceinline__ uint64_t desc_sw128(const void* p) {
  return static_cast<uint64_t>((smem_u32(p) & 0x3FFFF) >> 4) | (uint64_t{1} << 16) |
         (uint64_t{1024 >> 4} << 32) | (uint64_t{1} << 62);
}

template <int R>
__device__ __forceinline__ void fence_acc(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (64 x 256 f32: warp w's rows 16w + g and + 8, columns 8j + 2c and + 1
// in d[4j .. 4j + 3]) += a (64 x 16 bf16 in registers, mma.m16n8k16's A
// layout per warp) * B (16 x 256 bf16 in shared memory, K-major, 128-byte
// swizzle), B given by its descriptor
__device__ __forceinline__ void wgmma_rs_m64n256k16(float (&d)[128], const uint32_t (&a)[4],
                                                    uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63,"
      "%64, %65, %66, %67, %68, %69, %70, %71,"
      "%72, %73, %74, %75, %76, %77, %78, %79,"
      "%80, %81, %82, %83, %84, %85, %86, %87,"
      "%88, %89, %90, %91, %92, %93, %94, %95,"
      "%96, %97, %98, %99, %100, %101, %102, %103,"
      "%104, %105, %106, %107, %108, %109, %110, %111,"
      "%112, %113, %114, %115, %116, %117, %118, %119,"
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
        "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]),
        "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]),
        "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]),
        "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]),
        "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// A consumer warp of qmm_wgmma_kernel: rows (columns n) [nl, nl + 16) of
// the block's 128, all 256 tokens; then its outputs.
__device__ __forceinline__ void consume(const uint8_t* xs, const uint8_t* qs, uint64_t* full,
                                        uint64_t* empty, const float* __restrict__ scale,
                                        __nv_bfloat16* __restrict__ y, int M, int N, int n0,
                                        int t0, int nk) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nl = (warp >> 2) * 64 + (warp & 3) * 16;
  float d[128];
#pragma unroll
  for (int i = 0; i < 128; ++i) d[i] = 0.f;
  for (int i = 0; i < nk; ++i) {
    const int s = i % WG_STAGES;
    mbar_wait(&full[s], (i / WG_STAGES) & 1);
    uint32_t a[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) q_frag(a[kk], qs + s * WG_Q_STAGE, nl >> 4, kk * 16);
    const uint8_t* xt = xs + s * WG_X_STAGE;
    fence_acc(d);
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_rs_m64n256k16(d, a[kk], desc_sw128(xt + kk * 32));
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    fence_acc(d);
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);
  }

  // d[4j + e]: tokens t0 + 8j + 2c (+1 for odd e), rows g (e < 2) and g + 8,
  // i.e. columns n and n + 1 (N is even on this path)
  const int g = lane >> 2, c = lane & 3;
  const int n = n0 + nl + 2 * g;
  if (n >= N) return;
  const float2 sc = *reinterpret_cast<const float2*>(scale + n);
#pragma unroll
  for (int j = 0; j < 32; ++j) {
    const int t = t0 + 8 * j + 2 * c;
    if (t < M)
      *reinterpret_cast<__nv_bfloat162*>(y + static_cast<size_t>(t) * N + n) =
          __floats2bfloat162_rn(d[4 * j] * sc.x, d[4 * j + 2] * sc.y);
    if (t + 1 < M)
      *reinterpret_cast<__nv_bfloat162*>(y + static_cast<size_t>(t + 1) * N + n) =
          __floats2bfloat162_rn(d[4 * j + 1] * sc.x, d[4 * j + 3] * sc.y);
  }
}

// grid (ceil(N / 128), ceil(M / 256)).  x and q arrive by TMA from `tmx`
// (x [M, K] bf16, box 64 x 256) and `tmq` (q [K, N] int8, box 128 x 64);
// coordinates past the edges read as zeros.
__global__ void __launch_bounds__(WG_THREADS, 1)
qmm_wgmma_kernel(const __grid_constant__ CUtensorMap tmx, const __grid_constant__ CUtensorMap tmq,
                 const float* __restrict__ scale, __nv_bfloat16* __restrict__ y, int M, int K,
                 int N) {
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full[WG_STAGES], empty[WG_STAGES];
  uint8_t* base = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  uint8_t* xs = base;                            // [stage][256 tokens][64 k] bf16, swizzled
  uint8_t* qs = base + WG_STAGES * WG_X_STAGE;   // [stage][64 k][128 n] int8, swizzled
  const int n0 = blockIdx.x * WG_BN, t0 = blockIdx.y * WG_BT;
  const int nk = (K + WG_BK - 1) / WG_BK;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    for (int s = 0; s < WG_STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // One branch per role, never rejoined, so that ptxas honours setmaxnreg:
  // the producer's warpgroup gives registers to the consumers' accumulators.
  if (warp >= 8) {  // the producer: one thread issues every copy
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (warp == 8 && lane == 0)
      for (int i = 0; i < nk; ++i) {
        const int s = i % WG_STAGES;
        if (i >= WG_STAGES) mbar_wait(&empty[s], (i / WG_STAGES - 1) & 1);
        mbar_expect_tx(&full[s], WG_X_STAGE + WG_Q_STAGE);
        tma_load_2d(xs + s * WG_X_STAGE, &tmx, &full[s], i * WG_BK, t0);
        tma_load_2d(qs + s * WG_Q_STAGE, &tmq, &full[s], n0, i * WG_BK);
      }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    consume(xs, qs, full, empty, scale, y, M, N, n0, t0, nk);
  }
}

// ---------------------------------------------------------------------------
// M <= 64 (and operands TMA cannot take): mma.sync, cluster split of K
// ---------------------------------------------------------------------------

constexpr int MM_BN = 128;    // columns n of a block: 4 warps x 32 (256 and 512 measured slower)
constexpr int MM_BK = 64;     // k of a stage
constexpr int MM_THREADS = 128;
constexpr int MM_XS = MM_BK + 8;  // an x tile row in bf16: ldmatrix-free 32-bit loads, no conflict
constexpr int MM_MAX_CLUSTER = 16;

template <int NT8>
struct MmShape {
  static constexpr int TOK = 8 * NT8;                 // tokens of a slice
  static constexpr int STAGES = 4;
  static constexpr int Q_STAGE = MM_BK * MM_BN;       // bytes
  static constexpr int X_STAGE = TOK * MM_XS * 2;
  static constexpr int STAGE = Q_STAGE + X_STAGE;
  static constexpr int ES = TOK + 4;                  // an exchange row in f32
  static constexpr int SMEM = STAGES * STAGE;
  static_assert(MM_BN * ES * 4 <= SMEM, "the exchange reuses the ring");
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// d += a (16 x 16, row) * b (16 x 8, col), bf16 in, f32 accumulate
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

struct MmArgs {
  const __nv_bfloat16* x;
  const int8_t* q;
  const float* scale;
  __nv_bfloat16* y;
  int M, K, N, k_span, vec;
};

// Stage `i` of this block's K share into its ring slot: the raw q tile
// [64 k][128 n] (16-byte chunks swizzled by k % 8) and the x tile
// [TOK][MM_XS]; zeros outside [kb, ke) x [0, N) and past the slice's tokens.
template <int NT8>
__device__ __forceinline__ void mm_issue(const MmArgs& p, uint8_t* ring, int i, int nk, int kb,
                                         int ke, int n0, int m0, int mn) {
  using S = MmShape<NT8>;
  if (i < nk) {
    uint8_t* qt = ring + (i % S::STAGES) * S::STAGE;
    __nv_bfloat16* xt = reinterpret_cast<__nv_bfloat16*>(qt + S::Q_STAGE);
    const int k0 = kb + i * MM_BK;
    for (int v = threadIdx.x; v < MM_BK * 8; v += MM_THREADS) {
      const int kr = v >> 3, ch = v & 7, k = k0 + kr, n = n0 + ch * 16;
      uint8_t* dst = qt + kr * 128 + ((ch ^ (kr & 7)) << 4);
      const int8_t* src = p.q + static_cast<size_t>(k) * p.N + n;
      if (p.vec) {
        const bool ok = k < ke && n < p.N;
        cp_async16(dst, ok ? src : p.q, ok);
      } else {
#pragma unroll
        for (int e = 0; e < 16; ++e)
          dst[e] = (k < ke && n + e < p.N) ? static_cast<uint8_t>(src[e]) : 0;
      }
    }
    for (int v = threadIdx.x; v < S::TOK * 8; v += MM_THREADS) {
      const int t = v >> 3, k = k0 + (v & 7) * 8;
      __nv_bfloat16* dst = xt + t * MM_XS + (v & 7) * 8;
      const __nv_bfloat16* src = p.x + static_cast<size_t>(m0 + t) * p.K + k;
      if (p.vec) {
        const bool ok = t < mn && k < ke;
        cp_async16(dst, ok ? src : p.x, ok);
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e)
          dst[e] = (t < mn && k + e < ke) ? src[e] : __float2bfloat16(0.f);
      }
    }
  }
  cp_async_commit();
}

// grid (ceil(N / 128) * cluster, 1, ceil(M / TOK)), clusters of `cluster`
// blocks along x split K into shares of k_span.
template <int NT8>
__global__ void __launch_bounds__(MM_THREADS) qmm_mma_kernel(MmArgs p) {
  using S = MmShape<NT8>;
  extern __shared__ __align__(16) uint8_t ring[];
  cg::cluster_group cluster = cg::this_cluster();
  const int cl = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int n0 = (blockIdx.x / cl) * MM_BN;
  const int m0 = blockIdx.z * S::TOK, mn = min(S::TOK, p.M - m0);
  const int kb = min(p.K, rank * p.k_span), ke = min(p.K, kb + p.k_span);
  const int nk = (ke - kb + MM_BK - 1) / MM_BK;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, c = lane & 3;

  float acc[2][NT8][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;

  for (int i = 0; i < S::STAGES - 1; ++i) mm_issue<NT8>(p, ring, i, nk, kb, ke, n0, m0, mn);
  for (int i = 0; i < nk; ++i) {
    cp_async_wait<S::STAGES - 2>();
    __syncthreads();  // stage i landed; slot (i - 1) % STAGES is no longer read
    mm_issue<NT8>(p, ring, i + S::STAGES - 1, nk, kb, ke, n0, m0, mn);
    const uint8_t* qt = ring + (i % S::STAGES) * S::STAGE;
    const __nv_bfloat16* xt = reinterpret_cast<const __nv_bfloat16*>(qt + S::Q_STAGE);
#pragma unroll
    for (int kk = 0; kk < MM_BK / 16; ++kk) {
      uint32_t a[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) q_frag(a[mt], qt, warp * 2 + mt, kk * 16);
#pragma unroll
      for (int nt = 0; nt < NT8; ++nt) {
        const __nv_bfloat16* xr = xt + (nt * 8 + g) * MM_XS + kk * 16 + 2 * c;
        const uint32_t b0 = *reinterpret_cast<const uint32_t*>(xr);
        const uint32_t b1 = *reinterpret_cast<const uint32_t*>(xr + 8);
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) mma_bf16(acc[mt][nt], a[mt], b0, b1);
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring becomes the exchange

  // partials [128 n][TOK] f32: acc rows g and g + 8 of tile mt are the
  // columns 32 warp + 16 mt + 2g and + 1, its columns the tokens 8 nt + 2c (+1)
  float* ex = reinterpret_cast<float*>(ring);
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT8; ++nt) {
      const int nr = warp * 32 + mt * 16 + 2 * g, t = nt * 8 + 2 * c;
      *reinterpret_cast<float2*>(ex + nr * S::ES + t) = make_float2(acc[mt][nt][0], acc[mt][nt][1]);
      *reinterpret_cast<float2*>(ex + (nr + 1) * S::ES + t) =
          make_float2(acc[mt][nt][2], acc[mt][nt][3]);
    }
  cluster.sync();
  // this block's columns [rank * cols, (rank + 1) * cols), summed over the
  // cluster in rank order, scaled and rounded once
  const int cols = MM_BN / cl;
  for (int e = threadIdx.x; e < cols * S::TOK; e += MM_THREADS) {
    const int t = e / cols, nr = rank * cols + e % cols, n = n0 + nr;
    if (t >= mn || n >= p.N) continue;
    float v[MM_MAX_CLUSTER];  // every remote read issued before the first add
#pragma unroll
    for (int q = 0; q < MM_MAX_CLUSTER; ++q)
      v[q] = q < cl ? cluster.map_shared_rank(ex, q)[nr * S::ES + t] : 0.f;
    float s = 0.f;
#pragma unroll
    for (int q = 0; q < MM_MAX_CLUSTER; ++q) s += v[q];  // rank order; past `cl`, + 0
    p.y[static_cast<size_t>(m0 + t) * p.N + n] = __float2bfloat16(s * p.scale[n]);
  }
  cluster.sync();  // no block leaves while another reads its partials
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// the driver's cuTensorMapEncodeTiled, looked up once (null if missing)
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  static bool looked = false;
  if (!looked) {
    looked = true;
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(ptr);
  }
  return fn;
}

// a row-major [rows, cols] tensor, boxes of box_cols x box_rows, 128-byte swizzle
bool encode_2d(EncodeTiled enc, CUtensorMap* map, CUtensorMapDataType type, const void* ptr,
               int rows, int cols, int elem_bytes, int box_cols, int box_rows) {
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(cols) * elem_bytes};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(box_cols), static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t elem_strides[2] = {1, 1};
  return enc(map, type, 2, const_cast<void*>(ptr), dims, strides, box, elem_strides,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

cudaError_t launch_wgmma(const void* x, const void* q, const void* scale, void* y, int M, int K,
                         int N, cudaStream_t st) {
  EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return cudaErrorSymbolNotFound;
  CUtensorMap tmx, tmq;
  if (!encode_2d(enc, &tmx, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, x, M, K, 2, WG_BK, WG_BT) ||
      !encode_2d(enc, &tmq, CU_TENSOR_MAP_DATA_TYPE_UINT8, q, K, N, 1, WG_BN, WG_BK))
    return cudaErrorInvalidValue;
  static bool raised = false;
  if (!raised) {
    const cudaError_t err = cudaFuncSetAttribute(
        qmm_wgmma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, WG_SMEM);
    if (err != cudaSuccess) return err;
    raised = true;
  }
  dim3 grid((N + WG_BN - 1) / WG_BN, (M + WG_BT - 1) / WG_BT);
  qmm_wgmma_kernel<<<grid, WG_THREADS, WG_SMEM, st>>>(
      tmx, tmq, static_cast<const float*>(scale), static_cast<__nv_bfloat16*>(y), M, K, N);
  return cudaGetLastError();
}

template <int NT8>
cudaError_t launch_mma(const MmArgs& p, int cluster, cudaStream_t st) {
  using S = MmShape<NT8>;
  auto kernel = qmm_mma_kernel<NT8>;
  static bool raised = false;
  if (!raised) {
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, S::SMEM);
    if (err != cudaSuccess) return err;
    raised = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((p.N + MM_BN - 1) / MM_BN * cluster, 1, (p.M + S::TOK - 1) / S::TOK);
  cfg.blockDim = dim3(MM_THREADS);
  cfg.dynamicSmemBytes = S::SMEM;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, p);
  return err != cudaSuccess ? err : cudaGetLastError();
}

}  // namespace

// x [M, K] bf16, q [K, N] int8, scale [N] f32 -> y [M, N] bf16, all
// contiguous; one launch.  `route` 1: the wgmma kernel (M > 64; K % 8 == 0,
// N % 16 == 0, x and q 16-byte aligned, scale 8-byte aligned).  `route` 0:
// the mma.sync kernel, `nt8` token tiles of 8 a slice (1, 2, 4 or 8),
// clusters of `cluster` blocks (a power of two up to 16) each summing a
// share of `k_span` (a multiple of 64) of K, in rank order (trailing shares
// may be empty); `vec` = 1 allows 16-byte copies (K % 8 == 0, N % 16 == 0,
// aligned x and q).  Returns cudaGetLastError() after the launch.
extern "C" int quant_matmul_fwd(const void* x, const void* q, const void* scale, void* y, int M,
                                int K, int N, int route, int nt8, int cluster, int k_span,
                                int vec, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (M <= 0 || K <= 0 || N <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const uintptr_t addr = reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(q);
  const bool aligned = K % 8 == 0 && N % 16 == 0 && (addr & 15) == 0;
  if (route == 1) {
    if (!aligned || (reinterpret_cast<uintptr_t>(scale) & 7) != 0 || M <= 64)
      return static_cast<int>(cudaErrorInvalidValue);
    return static_cast<int>(launch_wgmma(x, q, scale, y, M, K, N, st));
  }
  if (cluster < 1 || cluster > MM_MAX_CLUSTER || (cluster & (cluster - 1)) != 0 || k_span <= 0 ||
      k_span % MM_BK != 0 || static_cast<long long>(cluster) * k_span < K || (vec && !aligned))
    return static_cast<int>(cudaErrorInvalidValue);
  MmArgs p{static_cast<const __nv_bfloat16*>(x), static_cast<const int8_t*>(q),
           static_cast<const float*>(scale), static_cast<__nv_bfloat16*>(y), M, K, N, k_span, vec};
  switch (nt8) {
    case 1: return static_cast<int>(launch_mma<1>(p, cluster, st));
    case 2: return static_cast<int>(launch_mma<2>(p, cluster, st));
    case 4: return static_cast<int>(launch_mma<4>(p, cluster, st));
    case 8: return static_cast<int>(launch_mma<8>(p, cluster, st));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" const char* quant_matmul_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
