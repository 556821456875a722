// Int8-weight matrix product for Hopper (sm_90a): the int8 backbone tier.
//
// Replaces the Pallas kernel `_qmm_kernel` / `_qmm_call` of
// src/repro/kernels/quant_matmul.py:
//
//   y[m, n] = (sum_k f32(x[m, k]) * f32(q[k, n])) * scale[n]
//
// rounded once to bf16.  The sum is taken in f32 and the per-column scale is
// applied after it, as the Pallas kernel's emit does.  The weight exists in
// device memory only as int8: each q tile is widened to bf16 in shared
// memory, which is exact (|q| <= 127 has 7 significant bits), and a bf16 x
// bf16 product is exact in f32, so the tensor cores (mma.sync m16n8k16, bf16
// in, f32 accumulate) form the same products as the TPU kernel and only the
// order of the f32 sum differs.
//
// What bounds it on the H100:
//   * decode (M = 8): the weight bytes, K*N int8 read once, against
//     2*M*K*N operations: about 16 operations per weight byte, far below
//     the ~295 at which bf16 tensor cores become the limit.
//   * prefill and training (M = 4096, 2816): the tensor-core operations,
//     2*M*K*N at 989 TFLOP/s.
//
// Design (simple and right first; wgmma, TMA and deeper pipelines are later
// work):
//   * One block computes a BM x BN tile of y over a K range.  Per BK step it
//     reads an x tile (16-byte vectors) and a q tile (16-byte vectors of 16
//     int8), widens q to bf16 as it stores the tile to shared memory, and
//     runs mma.sync on fragments loaded with ldmatrix (.trans for q, whose
//     tile is [k][n] row-major).  Two shared buffers and a register prefetch
//     of the next tile: one barrier per step, and the next tile's loads are
//     in flight while the current one is multiplied.
//   * Two tile shapes.  Small M (decode): BM = 16, BN = 128, BK = 64, four
//     warps side by side along n; all rows of x for the tile stay in one m16
//     fragment, so q is read exactly once per launch.  Large M: BM = BN =
//     128, BK = 32, eight warps of 64 x 32.
//   * Split K.  When the output tiles are too few to fill the SMs (decode,
//     and N = 1024 there above all), the wrapper splits K into chunks across
//     blocks (gridDim.z); each writes its f32 partial tile, and a second
//     kernel sums the partials in split order, applies the scale and rounds.
//     No atomics: the result does not depend on the order blocks run in.
//   * Ragged M, N and K are masked at the loads (zeros) and at the stores.
//     16-byte vector loads need K % 8 == 0, N % 16 == 0 and aligned base
//     pointers; otherwise the wrapper asks for element loads (`vec` = 0).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

template <int BM_, int BN_, int BK_, int WARPS_M_, int WARPS_N_>
struct Tile {
  static constexpr int BM = BM_, BN = BN_, BK = BK_;
  static constexpr int WARPS_M = WARPS_M_, WARPS_N = WARPS_N_;
  static constexpr int THREADS = WARPS_M * WARPS_N * 32;
  static constexpr int WM = BM / WARPS_M, WN = BN / WARPS_N;  // a warp's sub-tile
  static constexpr int MT = WM / 16, NT = WN / 8;             // mma tiles per warp
  static constexpr int AS = BK + 8, BS = BN + 8;  // padded shared row strides (bf16)
  static constexpr int A_VECS = BM * BK / 8 / THREADS;   // 16-byte x vectors per thread
  static constexpr int Q_VECS = BK * BN / 16 / THREADS;  // 16-byte q vectors per thread
  static constexpr int A_STAGE = BM * AS, B_STAGE = BK * BS;
  static constexpr int SMEM = 2 * (A_STAGE + B_STAGE) * 2;  // bytes, two buffers
  static_assert(WM % 16 == 0 && WN % 16 == 0 && BK % 16 == 0, "mma tiling");
  static_assert(A_VECS * THREADS * 8 == BM * BK, "x tile split over threads");
  static_assert(Q_VECS * THREADS * 16 == BK * BN, "q tile split over threads");
  static_assert(SMEM <= 48 * 1024, "static shared memory limit");
};

using SmallM = Tile<16, 128, 64, 1, 4>;
using LargeM = Tile<128, 128, 32, 2, 4>;

union Vec16 {
  uint4 u;
  uint16_t h[8];
  int8_t b[16];
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
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

// two int8 -> two bf16 in one word (low half = the first), exact
__device__ __forceinline__ uint32_t widen2(int8_t lo, int8_t hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(static_cast<float>(lo), static_cast<float>(hi));
  return *reinterpret_cast<uint32_t*>(&v);
}

// Global -> registers: the x tile [BM, BK] at (m0, k0) and the q tile
// [BK, BN] at (k0, n0), zeros outside [0, M) x [k0, ke) x [0, N).
template <class T>
__device__ __forceinline__ void load_tiles(const uint16_t* __restrict__ x,
                                           const int8_t* __restrict__ q, int M, int K, int N,
                                           int m0, int n0, int k0, int ke, bool vec,
                                           uint4 (&ra)[T::A_VECS], uint4 (&rq)[T::Q_VECS]) {
#pragma unroll
  for (int i = 0; i < T::A_VECS; ++i) {
    const int v = threadIdx.x + i * T::THREADS;
    const int m = m0 + v / (T::BK / 8);
    const int k = k0 + (v % (T::BK / 8)) * 8;
    if (vec) {
      ra[i] = (m < M && k < ke)
                  ? *reinterpret_cast<const uint4*>(x + static_cast<size_t>(m) * K + k)
                  : make_uint4(0, 0, 0, 0);
    } else {
      Vec16 t;
#pragma unroll
      for (int j = 0; j < 8; ++j)
        t.h[j] = (m < M && k + j < ke) ? x[static_cast<size_t>(m) * K + k + j] : 0;
      ra[i] = t.u;
    }
  }
#pragma unroll
  for (int i = 0; i < T::Q_VECS; ++i) {
    const int v = threadIdx.x + i * T::THREADS;
    const int k = k0 + v / (T::BN / 16);
    const int n = n0 + (v % (T::BN / 16)) * 16;
    if (vec) {
      rq[i] = (k < ke && n < N)
                  ? *reinterpret_cast<const uint4*>(q + static_cast<size_t>(k) * N + n)
                  : make_uint4(0, 0, 0, 0);
    } else {
      Vec16 t;
#pragma unroll
      for (int j = 0; j < 16; ++j)
        t.b[j] = (k < ke && n + j < N) ? q[static_cast<size_t>(k) * N + n + j] : 0;
      rq[i] = t.u;
    }
  }
}

// Registers -> one shared buffer; q is widened to bf16 here.
template <class T>
__device__ __forceinline__ void store_tiles(__nv_bfloat16* As, __nv_bfloat16* Bs,
                                            const uint4 (&ra)[T::A_VECS],
                                            const uint4 (&rq)[T::Q_VECS]) {
#pragma unroll
  for (int i = 0; i < T::A_VECS; ++i) {
    const int v = threadIdx.x + i * T::THREADS;
    *reinterpret_cast<uint4*>(As + (v / (T::BK / 8)) * T::AS + (v % (T::BK / 8)) * 8) = ra[i];
  }
#pragma unroll
  for (int i = 0; i < T::Q_VECS; ++i) {
    const int v = threadIdx.x + i * T::THREADS;
    Vec16 t;
    t.u = rq[i];
    uint4 lo, hi;
    lo.x = widen2(t.b[0], t.b[1]);
    lo.y = widen2(t.b[2], t.b[3]);
    lo.z = widen2(t.b[4], t.b[5]);
    lo.w = widen2(t.b[6], t.b[7]);
    hi.x = widen2(t.b[8], t.b[9]);
    hi.y = widen2(t.b[10], t.b[11]);
    hi.z = widen2(t.b[12], t.b[13]);
    hi.w = widen2(t.b[14], t.b[15]);
    uint4* dst = reinterpret_cast<uint4*>(Bs + (v / (T::BN / 16)) * T::BS + (v % (T::BN / 16)) * 16);
    dst[0] = lo;
    dst[1] = hi;
  }
}

// One buffer's BK slice into the warp's accumulators.
template <class T>
__device__ __forceinline__ void mma_tile(const __nv_bfloat16* As, const __nv_bfloat16* Bs,
                                         int wm, int wn, int lane,
                                         float (&acc)[T::MT][T::NT][4]) {
#pragma unroll
  for (int kk = 0; kk < T::BK / 16; ++kk) {
    uint32_t af[T::MT][4];
#pragma unroll
    for (int mt = 0; mt < T::MT; ++mt)
      ldsm_x4(af[mt], As + (wm * T::WM + mt * 16 + (lane & 15)) * T::AS + kk * 16 +
                          (lane >> 4) * 8);
    uint32_t bf[T::NT][2];
#pragma unroll
    for (int nt2 = 0; nt2 < T::NT / 2; ++nt2) {
      uint32_t r[4];
      ldsm_x4_trans(r, Bs + (kk * 16 + (lane & 15)) * T::BS + wn * T::WN + nt2 * 16 +
                           (lane >> 4) * 8);
      bf[2 * nt2][0] = r[0];
      bf[2 * nt2][1] = r[1];
      bf[2 * nt2 + 1][0] = r[2];
      bf[2 * nt2 + 1][1] = r[3];
    }
#pragma unroll
    for (int mt = 0; mt < T::MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < T::NT; ++nt) mma_bf16(acc[mt][nt], af[mt], bf[nt][0], bf[nt][1]);
  }
}

// grid (ceil(N / BN), ceil(M / BM), splits); block z sums k in
// [z * k_chunk, min(K, (z + 1) * k_chunk)).  With one split the block writes
// y = bf16(acc * scale); with more it writes its f32 partial to part[z].
template <class T>
__global__ void __launch_bounds__(T::THREADS)
qmm_kernel(const uint16_t* __restrict__ x, const int8_t* __restrict__ q,
           const float* __restrict__ scale, __nv_bfloat16* __restrict__ y,
           float* __restrict__ part, int M, int K, int N, int k_chunk, int vec) {
  __shared__ __align__(16) uint16_t smem[T::SMEM / 2];
  __nv_bfloat16* As = reinterpret_cast<__nv_bfloat16*>(smem);  // [2][BM][AS]
  __nv_bfloat16* Bs = As + 2 * T::A_STAGE;                      // [2][BK][BS]

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm = warp / T::WARPS_N, wn = warp % T::WARPS_N;
  const int n0 = blockIdx.x * T::BN, m0 = blockIdx.y * T::BM;
  const int kb = blockIdx.z * k_chunk;
  const int ke = min(K, kb + k_chunk);
  const int nk = (ke - kb + T::BK - 1) / T::BK;

  float acc[T::MT][T::NT][4];
#pragma unroll
  for (int mt = 0; mt < T::MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < T::NT; ++nt)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[mt][nt][j] = 0.f;

  uint4 ra[T::A_VECS], rq[T::Q_VECS];
  if (nk > 0) {
    load_tiles<T>(x, q, M, K, N, m0, n0, kb, ke, vec, ra, rq);
    store_tiles<T>(As, Bs, ra, rq);
    __syncthreads();
  }
  for (int kt = 0; kt < nk; ++kt) {
    const int cur = kt & 1, nxt = cur ^ 1;
    if (kt + 1 < nk) load_tiles<T>(x, q, M, K, N, m0, n0, kb + (kt + 1) * T::BK, ke, vec, ra, rq);
    mma_tile<T>(As + cur * T::A_STAGE, Bs + cur * T::B_STAGE, wm, wn, lane, acc);
    // the other buffer was last read in step kt - 1, before the barrier
    // that ended it
    if (kt + 1 < nk) store_tiles<T>(As + nxt * T::A_STAGE, Bs + nxt * T::B_STAGE, ra, rq);
    __syncthreads();
  }

  // C fragment: rows g and g + 8, columns 2c and 2c + 1 of each m16 x n8 tile
  const int g = lane >> 2, c2 = (lane & 3) * 2;
  const bool split = gridDim.z > 1;
  float* pz = split ? part + static_cast<size_t>(blockIdx.z) * M * N : nullptr;
#pragma unroll
  for (int mt = 0; mt < T::MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < T::NT; ++nt) {
      const int c = n0 + wn * T::WN + nt * 8 + c2;
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int r = m0 + wm * T::WM + mt * 16 + g + hf * 8;
        if (r >= M || c >= N) continue;
        const float v0 = acc[mt][nt][hf * 2], v1 = acc[mt][nt][hf * 2 + 1];
        const size_t o = static_cast<size_t>(r) * N + c;
        const bool pair = c + 1 < N && (N % 2) == 0;  // o even: 4- and 8-byte aligned
        if (split) {
          if (pair) {
            *reinterpret_cast<float2*>(pz + o) = make_float2(v0, v1);
          } else {
            pz[o] = v0;
            if (c + 1 < N) pz[o + 1] = v1;
          }
        } else if (pair) {
          *reinterpret_cast<__nv_bfloat162*>(y + o) =
              __floats2bfloat162_rn(v0 * scale[c], v1 * scale[c + 1]);
        } else {
          y[o] = __float2bfloat16(v0 * scale[c]);
          if (c + 1 < N) y[o + 1] = __float2bfloat16(v1 * scale[c + 1]);
        }
      }
    }
}

// y = bf16((sum over splits, in split order, of part) * scale)
__global__ void qmm_reduce_kernel(const float* __restrict__ part, const float* __restrict__ scale,
                                  __nv_bfloat16* __restrict__ y, int M, int N, int splits) {
  const size_t mn = static_cast<size_t>(M) * N;
  const size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= mn) return;
  float s = 0.f;
  for (int z = 0; z < splits; ++z) s += part[z * mn + i];
  y[i] = __float2bfloat16(s * scale[i % N]);
}

template <class T>
cudaError_t launch(const void* x, const void* q, const void* scale, void* y, void* part, int M,
                   int K, int N, int k_chunk, int splits, int vec, cudaStream_t st) {
  dim3 grid((N + T::BN - 1) / T::BN, (M + T::BM - 1) / T::BM, splits);
  qmm_kernel<T><<<grid, T::THREADS, 0, st>>>(
      static_cast<const uint16_t*>(x), static_cast<const int8_t*>(q),
      static_cast<const float*>(scale), static_cast<__nv_bfloat16*>(y),
      static_cast<float*>(part), M, K, N, k_chunk, vec);
  return cudaGetLastError();
}

}  // namespace

// x [M, K] bf16, q [K, N] int8, scale [N] f32 -> y [M, N] bf16, all
// contiguous.  `small` picks the small-M tile; `k_chunk` (a multiple of the
// tile's BK) and `splits` = ceil(K / k_chunk) set the split of K; with
// splits > 1, `part` is f32 scratch [splits, M, N].  `vec` = 1 allows
// 16-byte loads.  Returns cudaGetLastError() after the launches.
extern "C" int quant_matmul_fwd(const void* x, const void* q, const void* scale, void* y,
                                void* part, int M, int K, int N, int small, int k_chunk,
                                int splits, int vec, void* stream) {
  const int bk = small ? SmallM::BK : LargeM::BK;
  if (M <= 0 || K <= 0 || N <= 0 || splits <= 0 || k_chunk <= 0 || k_chunk % bk != 0 ||
      (splits > 1 && part == nullptr) || static_cast<long long>(splits - 1) * k_chunk >= K ||
      static_cast<long long>(splits) * k_chunk < K)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = small ? launch<SmallM>(x, q, scale, y, part, M, K, N, k_chunk, splits, vec, st)
                          : launch<LargeM>(x, q, scale, y, part, M, K, N, k_chunk, splits, vec, st);
  if (err != cudaSuccess || splits == 1) return static_cast<int>(err);
  const size_t mn = static_cast<size_t>(M) * N;
  const int threads = 256;
  qmm_reduce_kernel<<<static_cast<unsigned>((mn + threads - 1) / threads), threads, 0, st>>>(
      static_cast<const float*>(part), static_cast<const float*>(scale),
      static_cast<__nv_bfloat16*>(y), M, N, splits);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* quant_matmul_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
