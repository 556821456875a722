// Grouped multi-task LoRA for Hopper (sm_90a): forward (optionally saving
// the rank-space activations h) and backward.
//
// Replaces the Pallas kernels of src/repro/kernels/grouped_lora.py:
//   forward   `_fwd_kernel` / `_fwd_call` (with `save_h`);
//   backward  `_bwd_kernel` / `_bwd_call` with its per-task reduction.
//
//   forward   h[m] = x[m] @ A[t],  y[m] = h[m] @ B[t] * scale[t],  t = row_task[m]
//   backward  dh[m] = (g[m] @ B[t]^T) * scale[t],  dx[m] = dh[m] @ A[t]^T
//             dA[t] = sum over rows of task t of x[m]^T dh[m]
//             dB[t] = scale[t] * sum over rows of task t of h[m]^T g[m]
//   a row whose task is outside [0, T) (the -1 "no adapter" rows) gives
//   y = 0, dx = 0 and adds nothing to dA or dB; a slot no row routes to
//   gets exact zeros.  scale is a constant (no dscale).
//
// What bounds it on the H100: at decode (M = 8 rows) the forward reads each
// present task's A [d_in, r] and B [r, d_out] once, a few MB: bound by bytes
// and by how many SMs share that read.  At training and prefill (M ~ 3-4 k)
// the least time is still set by bytes, now the rows of x, g, y and dx: the
// rank-space products (2 M r (d_in + d_out) each way) are a few hundred
// MFLOP.  This first version sits far above that bound: it runs the products
// on the CUDA cores in f32 and does not overlap its tile loads with them.
//
// Design:
//   * One two-phase kernel serves the forward and the first half of the
//     backward: phase 1 reduces rows against W1 into the rank space (x @ A
//     forward, g @ B^T backward), phase 2 expands back (h @ B forward,
//     dh @ A^T backward).  The weights are read through strides, so the
//     backward needs no transposed copy.
//   * Any row may carry its own task (at decode every row is a different
//     request).  A block of BM rows collects the distinct tasks among its
//     rows and runs one pass per distinct task, with the rows of other tasks
//     zeroed in shared memory.
//   * The rank-space activations stay in f32 in shared memory.  A cluster of
//     CL = 8 blocks splits phase 1's reduction, exchanges the partial sums
//     through distributed shared memory, and then splits phase 2's output
//     columns, so a row tile spreads over 8 SMs without redundant work.
//     Only when asked does the kernel also write them out ([M, r] f32: h
//     forward, dh backward).
//   * The per-task sums dA and dB run in a second kernel: one block per
//     (64 output columns, slot, dA or dB) walks all rows in order, skipping
//     32-row chunks that hold no row of its slot.
//   * Every sum runs in a fixed order (no atomics): two runs on the same
//     inputs give the same bits.
// Later work: mma/wgmma for the rank-space products, TMA loads.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int THREADS = 256;
constexpr int RMAX = 64;  // largest stack rank the kernels take
constexpr int BK = 64;    // phase-1 reduction rows of W1 per tile
constexpr int BN = 64;    // phase-2 output columns of W2 per tile (== RMAX: tiles share buffers)
constexpr int CL = 8;     // blocks per cluster, splitting phase 1 and then phase 2
static_assert(BK == RMAX && BN == RMAX, "phase 2 reuses the phase-1 buffers");

// W1[t][k][j] = w1[t * K1 * r + k * s1k + j * s1j] for k < K1, j < r;
// W2[t][j][n] = w2[t * r * N2 + j * s2j + n * s2n] for j < r, n < N2.
struct PairArgs {
  const __nv_bfloat16* u;  // [M, K1] rows (x forward, g backward)
  const __nv_bfloat16* w1;
  const __nv_bfloat16* w2;
  const int* row_task;
  const float* scale;
  __nv_bfloat16* out;  // [M, N2] (y forward, dx backward)
  float* hout;         // [M, r] f32 or null (h forward, dh backward)
  int M, K1, N2, T, r;
  int s1k, s1j, s2j, s2n;
  int backward;  // scale applied to the rank-space rows (dh) instead of the output
};

template <int BM>
__global__ void __cluster_dims__(1, CL, 1) __launch_bounds__(THREADS)
grouped_lora_pair_kernel(PairArgs p) {
  // 16 column quads x 16 row groups.  With BM >= 16 a thread owns BM/16 rows;
  // with BM < 16 the KS = 16/BM threads that share a row split the k loop.
  constexpr int RPT = BM >= 16 ? BM / 16 : 1;
  constexpr int KS = BM >= 16 ? 1 : 16 / BM;

  __shared__ int task_s[BM];
  __shared__ int uniq_s[BM];
  __shared__ int n_uniq_s;
  __shared__ __align__(16) float tile_s[BK * RMAX];  // W1 tile, then W2 tile
  __shared__ float rows_s[BM * BK];                  // u tile, then masked rank rows
  __shared__ float part_s[KS * BM * RMAX];           // per k-slice partial sums
  __shared__ float hpart_s[BM * RMAX];               // this block's share of phase 1
  __shared__ float h_s[BM * RMAX];                   // phase-1 result, f32

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int tid = threadIdx.x;
  const int cq = tid & 15;
  const int rg = tid >> 4;
  const int ks = BM >= 16 ? 0 : rg / BM;
  const int m0 = blockIdx.x * BM;
  const int M = p.M, K1 = p.K1, N2 = p.N2, r = p.r;

  if (tid < BM) {
    const int m = m0 + tid;
    const int t = m < M ? p.row_task[m] : -1;
    task_s[tid] = (t >= 0 && t < p.T) ? t : -1;
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

  // ---- phase 1: this block's K1 slice of h = u @ W1[t] ----
  const int kspan = (K1 + CL - 1) / CL;
  const int kb = rank * kspan;
  const int ke = min(K1, kb + kspan);
  const bool w1_kfast = p.s1k == 1;  // which W1 index runs along memory
  float acc[RPT][4];
#pragma unroll
  for (int i = 0; i < RPT; ++i)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[i][c] = 0.f;

  for (int ui = 0; ui < n_uniq; ++ui) {
    const int u = uniq_s[ui];
    const __nv_bfloat16* wu = p.w1 + static_cast<size_t>(u) * K1 * r;
    for (int k0 = kb; k0 < ke; k0 += BK) {
      for (int i = tid; i < BM * BK; i += THREADS) {
        const int m = i / BK, k = k0 + i % BK;
        rows_s[i] = (task_s[m] == u && k < ke)
                        ? __bfloat162float(p.u[static_cast<size_t>(m0 + m) * K1 + k])
                        : 0.f;
      }
      for (int i = tid; i < BK * RMAX; i += THREADS) {
        const int kk = w1_kfast ? i % BK : i / RMAX;
        const int j = w1_kfast ? i / BK : i % RMAX;
        const int k = k0 + kk;
        tile_s[kk * RMAX + j] =
            (j < r && k < ke)
                ? __bfloat162float(wu[static_cast<size_t>(k) * p.s1k + static_cast<size_t>(j) * p.s1j])
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
  // exchange the phase-1 slices across the cluster
  cluster.sync();
  for (int i = tid; i < BM * RMAX; i += THREADS) {
    float s = 0.f;
    for (int q = 0; q < CL; ++q) s += cluster.map_shared_rank(hpart_s, q)[i];
    if (p.backward) {  // dh = (g @ B^T) * scale
      const int t = task_s[i / RMAX];
      s *= t >= 0 ? p.scale[t] : 0.f;
    }
    h_s[i] = s;
  }
  // no block may leave (freeing its hpart_s) while another still reads it
  cluster.sync();
  if (p.hout != nullptr && rank == 0) {
    for (int i = tid; i < BM * r; i += THREADS) {
      const int m = i / r, j = i % r;
      if (m0 + m < M) p.hout[static_cast<size_t>(m0 + m) * r + j] = h_s[m * RMAX + j];
    }
  }

  // ---- phase 2: this block's N2 slice of out = h @ W2[t] (* scale[t] forward) ----
  const int nspan = (N2 + CL - 1) / CL;
  const int nb = rank * nspan;
  const int ne = min(N2, nb + nspan);
  const bool w2_jfast = p.s2j == 1 && p.s2n != 1;
  for (int n0 = nb; n0 < ne; n0 += BN) {
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[i][c] = 0.f;
    for (int ui = 0; ui < n_uniq; ++ui) {
      const int u = uniq_s[ui];
      const __nv_bfloat16* wu = p.w2 + static_cast<size_t>(u) * r * N2;
      for (int i = tid; i < BM * RMAX; i += THREADS)
        rows_s[i] = task_s[i / RMAX] == u ? h_s[i] : 0.f;
      for (int i = tid; i < RMAX * BN; i += THREADS) {
        const int j = w2_jfast ? i % RMAX : i / BN;
        const int nn = w2_jfast ? i / RMAX : i % BN;
        const int n = n0 + nn;
        tile_s[j * BN + nn] =
            (j < r && n < ne)
                ? __bfloat162float(wu[static_cast<size_t>(j) * p.s2j + static_cast<size_t>(n) * p.s2n])
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
        const float gate = t < 0 ? 0.f : (p.backward ? 1.f : p.scale[t]);
        p.out[static_cast<size_t>(row) * N2 + n] = __float2bfloat16(s * gate);
      }
    }
    __syncthreads();
  }
}

template <int BM>
cudaError_t launch_pair(const PairArgs& p, cudaStream_t stream) {
  dim3 grid((p.M + BM - 1) / BM, CL);
  grouped_lora_pair_kernel<BM><<<grid, THREADS, 0, stream>>>(p);
  return cudaGetLastError();
}

cudaError_t run_pair(const PairArgs& p, cudaStream_t stream) {
  // few rows (decode): 2-row blocks spread the weight reads over more SMs
  if (p.M <= 64) return launch_pair<2>(p, stream);
  return launch_pair<16>(p, stream);
}

constexpr int RC = 64;  // output columns per reduction block
constexpr int RM = 32;  // rows per reduction chunk

// blockIdx.z == 0: da[t][c][j] = sum_m x[m][c] dh[m][j]          (c < d_in)
// blockIdx.z == 1: db[t][j][c] = scale[t] sum_m h[m][j] g[m][c]  (c < d_out)
// over the rows m of task t, in row order.
__global__ void __launch_bounds__(THREADS)
grouped_lora_reduce_kernel(const __nv_bfloat16* __restrict__ x,
                           const __nv_bfloat16* __restrict__ g,
                           const float* __restrict__ dh, const float* __restrict__ h,
                           const int* __restrict__ row_task, const float* __restrict__ scale,
                           float* __restrict__ da, float* __restrict__ db, int M, int d_in,
                           int d_out, int r) {
  __shared__ float u_s[RM * RC];
  __shared__ float v_s[RM * RMAX];
  __shared__ int any_s;
  const int dB = blockIdx.z;
  const int C = dB ? d_out : d_in;
  const int c0 = blockIdx.x * RC;
  if (c0 >= C) return;
  const int t = blockIdx.y;
  const __nv_bfloat16* U = dB ? g : x;
  const float* V = dB ? h : dh;
  const int tid = threadIdx.x;
  const int c = tid % RC;
  const int jg = tid / RC;  // this thread's ranks: jg, jg + 4, ...
  float acc[RMAX / 4];
#pragma unroll
  for (int q = 0; q < RMAX / 4; ++q) acc[q] = 0.f;

  for (int m0 = 0; m0 < M; m0 += RM) {
    __syncthreads();  // the previous chunk is no longer read
    if (tid == 0) any_s = 0;
    __syncthreads();
    if (tid < RM && m0 + tid < M && row_task[m0 + tid] == t) any_s = 1;
    __syncthreads();
    if (!any_s) continue;
    for (int i = tid; i < RM * RC; i += THREADS) {
      const int mm = i / RC, cc = i % RC, m = m0 + mm;
      u_s[i] = (m < M && row_task[m] == t && c0 + cc < C)
                   ? __bfloat162float(U[static_cast<size_t>(m) * C + c0 + cc])
                   : 0.f;
    }
    for (int i = tid; i < RM * RMAX; i += THREADS) {
      const int mm = i / RMAX, j = i % RMAX, m = m0 + mm;
      v_s[i] = (m < M && row_task[m] == t && j < r) ? V[static_cast<size_t>(m) * r + j] : 0.f;
    }
    __syncthreads();
    for (int mm = 0; mm < RM; ++mm) {
      const float uv = u_s[mm * RC + c];
#pragma unroll
      for (int q = 0; q < RMAX / 4; ++q)
        if (jg + 4 * q < r) acc[q] += uv * v_s[mm * RMAX + jg + 4 * q];
    }
  }
  if (c0 + c >= C) return;
  const float f = dB ? scale[t] : 1.f;
#pragma unroll
  for (int q = 0; q < RMAX / 4; ++q) {
    const int j = jg + 4 * q;
    if (j >= r) continue;
    if (dB)
      db[(static_cast<size_t>(t) * r + j) * d_out + c0 + c] = acc[q] * f;
    else
      da[(static_cast<size_t>(t) * d_in + c0 + c) * r + j] = acc[q] * f;
  }
}

bool bad_sizes(int M, int d_in, int d_out, int T, int r) {
  return M <= 0 || d_in <= 0 || d_out <= 0 || T <= 0 || r <= 0 || r > RMAX;
}

}  // namespace

// x [M, d_in] bf16, a [T, d_in, r] bf16, b [T, r, d_out] bf16, row_task [M] int32,
// scale [T] f32 -> y [M, d_out] bf16 and, when h is not null, h = x @ A[t]
// [M, r] f32 (0 on rows without a task).  All contiguous, on one device.
extern "C" int grouped_lora_fwd(const void* x, const void* a, const void* b,
                                const void* row_task, const void* scale, void* y, void* h,
                                int M, int d_in, int d_out, int T, int r, void* stream) {
  if (bad_sizes(M, d_in, d_out, T, r)) return static_cast<int>(cudaErrorInvalidValue);
  PairArgs p{};
  p.u = static_cast<const __nv_bfloat16*>(x);
  p.w1 = static_cast<const __nv_bfloat16*>(a);
  p.w2 = static_cast<const __nv_bfloat16*>(b);
  p.row_task = static_cast<const int*>(row_task);
  p.scale = static_cast<const float*>(scale);
  p.out = static_cast<__nv_bfloat16*>(y);
  p.hout = static_cast<float*>(h);
  p.M = M;
  p.K1 = d_in;
  p.N2 = d_out;
  p.T = T;
  p.r = r;
  p.s1k = r;      // A[t][k][j]
  p.s1j = 1;
  p.s2j = d_out;  // B[t][j][n]
  p.s2n = 1;
  p.backward = 0;
  return static_cast<int>(run_pair(p, static_cast<cudaStream_t>(stream)));
}

// The forward's x, a, b, row_task, scale, its saved h [M, r] f32 and the output
// gradient g [M, d_out] bf16 -> dx [M, d_in] bf16, da [T, d_in, r] f32,
// db [T, r, d_out] f32; dh [M, r] f32 is scratch.  Two launches on the stream.
extern "C" int grouped_lora_bwd(const void* x, const void* a, const void* b,
                                const void* row_task, const void* scale, const void* h,
                                const void* g, void* dx, void* dh, void* da, void* db, int M,
                                int d_in, int d_out, int T, int r, void* stream) {
  if (bad_sizes(M, d_in, d_out, T, r)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  PairArgs p{};
  p.u = static_cast<const __nv_bfloat16*>(g);
  p.w1 = static_cast<const __nv_bfloat16*>(b);  // W1[t][n][j] = B[t][j][n]
  p.w2 = static_cast<const __nv_bfloat16*>(a);  // W2[t][j][k] = A[t][k][j]
  p.row_task = static_cast<const int*>(row_task);
  p.scale = static_cast<const float*>(scale);
  p.out = static_cast<__nv_bfloat16*>(dx);
  p.hout = static_cast<float*>(dh);
  p.M = M;
  p.K1 = d_out;
  p.N2 = d_in;
  p.T = T;
  p.r = r;
  p.s1k = 1;
  p.s1j = d_out;
  p.s2j = 1;
  p.s2n = r;
  p.backward = 1;
  cudaError_t err = run_pair(p, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int widest = d_in > d_out ? d_in : d_out;
  dim3 grid((widest + RC - 1) / RC, T, 2);
  grouped_lora_reduce_kernel<<<grid, THREADS, 0, st>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(g),
      static_cast<const float*>(dh), static_cast<const float*>(h),
      static_cast<const int*>(row_task), static_cast<const float*>(scale),
      static_cast<float*>(da), static_cast<float*>(db), M, d_in, d_out, r);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* grouped_lora_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
