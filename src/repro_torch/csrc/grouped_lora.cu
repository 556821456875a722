// Grouped multi-task LoRA forward for Hopper (sm_90a).
//
// Replaces the Pallas kernel `_fwd_kernel` / `_fwd_call` of
// src/repro/kernels/grouped_lora.py (forward only; no saved h).
//
//   y[m] = (x[m] @ A[t]) @ B[t] * scale[t],   t = row_task[m]
//   a row whose task is outside [0, T) (the -1 "no adapter" rows) gives 0.
//
// What bounds it on the H100: at decode (M = 8 rows) the work is reading
// each present task's A [d_in, r] and B [r, d_out] once, a few MB, so it is
// bound by bytes and by how many SMs share that read.  At prefill (M = 4096)
// x and y dominate the bytes, and the rank-space products are done here on
// the CUDA cores in f32, so the kernel is bound by those operations
// (2*M*r*(d_in + d_out)), far above the tensor-core bound.
//
// Design:
//   * Any row may carry its own task (at decode every row is a different
//     request).  A block of BM rows collects the distinct tasks among its
//     rows and runs one pass per distinct task, with the rows of other tasks
//     zeroed in shared memory, so each present task's A and B tile is read
//     once per block and no per-block task constancy is assumed.
//   * h = x @ A[t] stays in f32 in shared memory, never in device memory.
//     A cluster of CL = 8 blocks splits d_in for h: each block sums its
//     d_in slice, the cluster exchanges the partial h through distributed
//     shared memory, and each block then emits its own d_out slice.  So the
//     row tile is spread over 8 SMs without any redundant work.
//   * The scale of the row's task is applied at the emit, in f32, and y is
//     stored in x's type (bf16), as the Pallas kernel does.
//   * Every sum runs in a fixed order (no atomics): two runs on the same
//     inputs give the same bits.
// Later work: mma/wgmma for the rank-space products, TMA loads.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int THREADS = 256;
constexpr int RMAX = 64;  // largest stack rank the kernel takes
constexpr int BK = 64;    // d_in rows of A per tile
constexpr int BN = 64;    // d_out columns of B per tile (== RMAX: tiles share buffers)
constexpr int CL = 8;     // blocks per cluster, splitting d_in and then d_out
static_assert(BK == RMAX && BN == RMAX, "phase 2 reuses the phase-1 buffers");

template <int BM>
__global__ void __cluster_dims__(1, CL, 1) __launch_bounds__(THREADS)
grouped_lora_fwd_kernel(const __nv_bfloat16* __restrict__ x,
                        const __nv_bfloat16* __restrict__ a,
                        const __nv_bfloat16* __restrict__ b,
                        const int* __restrict__ row_task,
                        const float* __restrict__ scale,
                        __nv_bfloat16* __restrict__ y,
                        int M, int d_in, int d_out, int T, int r) {
  // 16 column quads x 16 row groups.  With BM >= 16 a thread owns BM/16 rows;
  // with BM < 16 the KS = 16/BM threads that share a row split the k loop.
  constexpr int RPT = BM >= 16 ? BM / 16 : 1;
  constexpr int KS = BM >= 16 ? 1 : 16 / BM;

  __shared__ int task_s[BM];
  __shared__ int uniq_s[BM];
  __shared__ int n_uniq_s;
  __shared__ __align__(16) float tile_s[BK * RMAX];  // A tile, then B tile
  __shared__ float rows_s[BM * BK];                  // x tile, then masked h
  __shared__ float part_s[KS * BM * RMAX];           // per k-slice partial sums
  __shared__ float hpart_s[BM * RMAX];               // this block's share of h
  __shared__ float h_s[BM * RMAX];                   // h = x @ A[t], f32

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int tid = threadIdx.x;
  const int cq = tid & 15;
  const int rg = tid >> 4;
  const int ks = BM >= 16 ? 0 : rg / BM;
  const int m0 = blockIdx.x * BM;

  if (tid < BM) {
    const int m = m0 + tid;
    const int t = m < M ? row_task[m] : -1;
    task_s[tid] = (t >= 0 && t < T) ? t : -1;
  }
  __syncthreads();
  if (tid == 0) {
    int n = 0;
    for (int i = 0; i < BM; ++i) {
      const int t = task_s[i];
      bool seen = t < 0;
      for (int j = 0; j < n; ++j) seen |= uniq_s[j] == t;
      if (!seen) uniq_s[n++] = t;
    }
    n_uniq_s = n;
  }
  __syncthreads();
  const int n_uniq = n_uniq_s;

  // ---- phase 1: this block's d_in slice of h = x @ A[t] ----
  const int kspan = (d_in + CL - 1) / CL;
  const int kb = rank * kspan;
  const int ke = min(d_in, kb + kspan);
  float acc[RPT][4];
#pragma unroll
  for (int i = 0; i < RPT; ++i)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[i][c] = 0.f;

  for (int ui = 0; ui < n_uniq; ++ui) {
    const int u = uniq_s[ui];
    const __nv_bfloat16* au = a + static_cast<size_t>(u) * d_in * r;
    for (int k0 = kb; k0 < ke; k0 += BK) {
      for (int i = tid; i < BM * BK; i += THREADS) {
        const int m = i / BK, k = k0 + i % BK;
        rows_s[i] = (task_s[m] == u && k < ke)
                        ? __bfloat162float(x[static_cast<size_t>(m0 + m) * d_in + k])
                        : 0.f;
      }
      for (int i = tid; i < BK * RMAX; i += THREADS) {
        const int k = k0 + i / RMAX, j = i % RMAX;
        tile_s[i] = (j < r && k < ke)
                        ? __bfloat162float(au[static_cast<size_t>(k) * r + j])
                        : 0.f;
      }
      __syncthreads();
      for (int kk = ks; kk < BK; kk += KS) {
        const float4 av = *reinterpret_cast<const float4*>(&tile_s[kk * RMAX + 4 * cq]);
#pragma unroll
        for (int i = 0; i < RPT; ++i) {
          const int m = BM >= 16 ? rg + 16 * i : rg % BM;
          const float xv = rows_s[m * BK + kk];
          acc[i][0] += xv * av.x;
          acc[i][1] += xv * av.y;
          acc[i][2] += xv * av.z;
          acc[i][3] += xv * av.w;
        }
      }
      __syncthreads();
    }
  }
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int m = BM >= 16 ? rg + 16 * i : rg % BM;
#pragma unroll
    for (int c = 0; c < 4; ++c) part_s[(ks * BM + m) * RMAX + 4 * cq + c] = acc[i][c];
  }
  __syncthreads();
  for (int i = tid; i < BM * RMAX; i += THREADS) {
    float s = 0.f;
    for (int q = 0; q < KS; ++q) s += part_s[q * BM * RMAX + i];
    hpart_s[i] = s;
  }
  // exchange the d_in slices across the cluster
  cluster.sync();
  for (int i = tid; i < BM * RMAX; i += THREADS) {
    float s = 0.f;
    for (int q = 0; q < CL; ++q) s += cluster.map_shared_rank(hpart_s, q)[i];
    h_s[i] = s;
  }
  // no block may leave (freeing its hpart_s) while another still reads it
  cluster.sync();

  // ---- phase 2: this block's d_out slice of y = h @ B[t] * scale[t] ----
  const int nspan = (d_out + CL - 1) / CL;
  const int nb = rank * nspan;
  const int ne = min(d_out, nb + nspan);
  for (int n0 = nb; n0 < ne; n0 += BN) {
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[i][c] = 0.f;
    for (int ui = 0; ui < n_uniq; ++ui) {
      const int u = uniq_s[ui];
      const __nv_bfloat16* bu = b + static_cast<size_t>(u) * r * d_out;
      for (int i = tid; i < BM * RMAX; i += THREADS)
        rows_s[i] = task_s[i / RMAX] == u ? h_s[i] : 0.f;
      for (int i = tid; i < RMAX * BN; i += THREADS) {
        const int j = i / BN, n = n0 + i % BN;
        tile_s[i] = (j < r && n < ne)
                        ? __bfloat162float(bu[static_cast<size_t>(j) * d_out + n])
                        : 0.f;
      }
      __syncthreads();
      for (int j = ks; j < r; j += KS) {
        const float4 bv = *reinterpret_cast<const float4*>(&tile_s[j * BN + 4 * cq]);
#pragma unroll
        for (int i = 0; i < RPT; ++i) {
          const int m = BM >= 16 ? rg + 16 * i : rg % BM;
          const float hv = rows_s[m * RMAX + j];
          acc[i][0] += hv * bv.x;
          acc[i][1] += hv * bv.y;
          acc[i][2] += hv * bv.z;
          acc[i][3] += hv * bv.w;
        }
      }
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int m = BM >= 16 ? rg + 16 * i : rg % BM;
#pragma unroll
      for (int c = 0; c < 4; ++c) part_s[(ks * BM + m) * BN + 4 * cq + c] = acc[i][c];
    }
    __syncthreads();
    for (int i = tid; i < BM * BN; i += THREADS) {
      const int m = i / BN, n = n0 + i % BN, row = m0 + m;
      if (row < M && n < ne) {
        float s = 0.f;
        for (int q = 0; q < KS; ++q) s += part_s[q * BM * BN + i];
        const int t = task_s[m];
        const float gate = t >= 0 ? scale[t] : 0.f;
        y[static_cast<size_t>(row) * d_out + n] = __float2bfloat16(s * gate);
      }
    }
    __syncthreads();
  }
}

template <int BM>
cudaError_t launch(const void* x, const void* a, const void* b, const void* row_task,
                   const void* scale, void* y, int M, int d_in, int d_out, int T, int r,
                   cudaStream_t stream) {
  dim3 grid((M + BM - 1) / BM, CL);
  grouped_lora_fwd_kernel<BM><<<grid, THREADS, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(a),
      static_cast<const __nv_bfloat16*>(b), static_cast<const int*>(row_task),
      static_cast<const float*>(scale), static_cast<__nv_bfloat16*>(y), M, d_in, d_out, T,
      r);
  return cudaGetLastError();
}

}  // namespace

// x [M, d_in] bf16, a [T, d_in, r] bf16, b [T, r, d_out] bf16, row_task [M] int32,
// scale [T] f32 -> y [M, d_out] bf16.  All contiguous, on one device.
extern "C" int grouped_lora_fwd(const void* x, const void* a, const void* b,
                                const void* row_task, const void* scale, void* y, int M,
                                int d_in, int d_out, int T, int r, void* stream) {
  if (M <= 0 || d_in <= 0 || d_out <= 0 || T <= 0 || r <= 0 || r > RMAX)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // few rows (decode): 2-row blocks spread the weight reads over more SMs
  if (M <= 64) return static_cast<int>(launch<2>(x, a, b, row_task, scale, y, M, d_in, d_out, T, r, s));
  return static_cast<int>(launch<16>(x, a, b, row_task, scale, y, M, d_in, d_out, T, r, s));
}

extern "C" const char* grouped_lora_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
