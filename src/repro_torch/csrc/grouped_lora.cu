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
// MFLOP.
//
// The pair kernel serves the forward and the first half of the backward:
// phase 1 reduces rows against W1 into the rank space (x @ A forward,
// g @ B^T backward), phase 2 expands back (h @ B forward, dh @ A^T
// backward).  The weights are read through strides, so the backward needs
// no transposed copy: each weight tile is copied along the index that runs
// along memory, and the tensor cores read it as their B operand by
// ldmatrix or ldmatrix.trans, as that index is the contraction or not.
//   * Tensor cores: both products run as mma.sync.m16n8k16 on bf16
//     operands with f32 accumulators.  Each k-step's products go into
//     zeroed accumulators and are added in f32 with round-to-nearest (the
//     tensor cores truncate their own sums).  Phase 2's left factor is h
//     in f32, fed as three bf16 terms whose sum is h to f32 precision, as
//     the Pallas kernel multiplies f32 h by B cast to f32.
//   * Loads: one stream of tiles per block (phase 1's row and weight tiles,
//     then phase 2's weight tiles) through a ring of STAGES slots filled by
//     16-byte cp.async STAGES - 1 tiles ahead, one barrier per tile; phase
//     2's first tiles arrive while phase 1 ends.  Rows are padded to 72
//     bf16, so the eight rows an ldmatrix reads fall in distinct banks.
//   * Clusters: the blocks of a cluster (8 at training) split phase 1's
//     reduction (K) and phase 2's output columns (N).  The rank-space
//     partials meet through distributed shared memory: each block sums its
//     share of the rows over the cluster in rank order, then every block
//     gathers the sums into its h [BM][r] f32; the barrier that guards the
//     exchange's reuse is waited on only before the next exchange.  Only
//     when asked does the kernel also write h out ([M, r] f32: h forward,
//     dh backward).
//   * Training and prefill (M > 64): 64-row tiles, 4 warps x 16 rows.  A
//     tile whose rows carry several tasks runs one pass per distinct task,
//     the rows of the other tasks zero in that pass.
//   * Decode (M <= 64): a cluster per distinct task of the call gathers that
//     task's rows into a 16-row tile (the 4 warps split its 64 columns), so
//     each task's A and B are read once per call, spread over the cluster's
//     SMs: 16 (a size past the portable 8, which the H100 schedules), with
//     an 8-slot ring.  The first cluster writes the zero rows.  The time
//     there is latency, not bytes: a call is a few tiles per block, three
//     cluster barriers and the launch.
//   * Any stack rank up to RANK_LIMIT, in rank tiles of RT = 64 columns:
//     phase 1 computes and exchanges one rank tile at a time, phase 2 sums
//     over every rank tile in f32 before it rounds an output to bf16 once.
//     Above 256 the 16-row form takes every M (its h fits shared memory).
//   * The per-task sums dA and dB run in a second kernel on the tensor
//     cores: a cluster per (slot, 128 columns, rank tile) whose blocks share
//     the slot's 64-row chunks and meet through distributed shared memory;
//     it writes bf16 dA and dB itself (see `grouped_lora_reduce_kernel`).
//   * Registers: `__launch_bounds__(128, 1)` lets ptxas take what the
//     pair kernel needs (up to 255, no spill); with the thread count alone
//     it held every instantiation to 128 registers or fewer and spilled.
//   * Every sum runs in a fixed order (no atomics): two runs on the same
//     inputs give the same bits.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int THREADS = 128;  // pair kernel: 4 warps
constexpr int RT = 64;    // rank columns per rank tile
constexpr int BK = 64;    // phase-1 reduction rows of W1 per tile
constexpr int BN = 64;    // phase-2 output columns of W2 per tile
constexpr int CL = 8;     // blocks per cluster (the portable size), splitting phase 1's K
                          // and phase 2's N
constexpr int TP = 72;    // a bf16 tile row: 64 columns and 8 of padding (ldmatrix banks)
constexpr int XS = 72;    // an f32 exchange row: 64 columns and 8 of padding
constexpr int MAXROWS = 64;  // rows of a call that the gathered (decode) form takes
// The largest stack rank: a 16-row tile's rank rows, 16 x 3072 f32, with
// a two-stage ring fit the 227 KB of shared memory a block can have.  Every
// LoRA site of the ported models has a side of at most 3072 (d_model), and
// a rank above a site's narrower side adds nothing.
constexpr int RANK_LIMIT = 3072;

// the rank rounded up to whole rank tiles: the row length of h in shared memory
__host__ __device__ constexpr int rank_pad(int r) { return (r + RT - 1) / RT * RT; }

// W1[t][k][j] = w1[t * K1 * r + k * s1k + j * s1j] for k < K1, j < r;
// W2[t][j][n] = w2[t * r * N2 + j * s2j + n * s2n] for j < r, n < N2.
// One stride of each is 1; the tile copies follow that index along memory.
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
  int gather;    // a cluster per distinct task of the call (M <= MAXROWS), its rows gathered
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, zero-filled when !valid (src is then not read)
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// d += a (16x16 bf16, row) * b (16x8 bf16, col), f32 accumulators
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The two halves of a cluster barrier: arrive (release this block's shared
// memory writes) now, wait (for every block's arrival) later.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// x0, x1 as three bf16 pairs, hi + mid + lo, whose sum is x0, x1 to f32
// precision (each term takes the next 8 significant bits)
__device__ __forceinline__ void split3(float2 x, uint32_t& hi, uint32_t& mid, uint32_t& lo) {
  __nv_bfloat162 t = __floats2bfloat162_rn(x.x, x.y);
  hi = *reinterpret_cast<const uint32_t*>(&t);
  float2 back = __bfloat1622float2(t);
  x.x -= back.x;
  x.y -= back.y;
  t = __floats2bfloat162_rn(x.x, x.y);
  mid = *reinterpret_cast<const uint32_t*>(&t);
  back = __bfloat1622float2(t);
  lo = pack_bf16(x.x - back.x, x.y - back.y);
}

// x0, x1 as two bf16 pairs, hi + lo, whose sum is x0, x1 to 16 significant
// bits (as split3, one term fewer)
__device__ __forceinline__ void split2(float2 x, __nv_bfloat162& hi, __nv_bfloat162& lo) {
  hi = __floats2bfloat162_rn(x.x, x.y);
  const float2 back = __bfloat1622float2(hi);
  lo = __floats2bfloat162_rn(x.x - back.x, x.y - back.y);
}

// B fragments of two n-tiles (16 columns from n0) for one k-step (16 rows
// of the contraction from k0) of a [64][TP] bf16 tile: `trans` when the
// tile's rows are the contraction ([k][n]), else its rows are the columns
// ([n][k]).  b[0], b[1] feed n-tile n0, b[2], b[3] n-tile n0 + 8.
__device__ __forceinline__ void b_frags(uint32_t (&b)[4], const __nv_bfloat16* tile, bool trans,
                                        int k0, int n0) {
  const int lane = threadIdx.x & 31;
  if (trans)
    ldmatrix_x4_trans(b, tile + (k0 + (lane & 7) + ((lane >> 3) & 1) * 8) * TP + n0 +
                             (lane >> 4) * 8);
  else
    ldmatrix_x4(b, tile + (n0 + (lane & 7) + ((lane >> 4) << 3)) * TP + k0 +
                       ((lane >> 3) & 1) * 8);
}

// A 64 x 64 tile of a bf16 matrix into a [64][TP] shared tile:
// dst[o - o0][i - i0] = src[o * ld + i] for o in [o0, o1), i in [i0, i1)
// (i runs along memory), zero elsewhere.  16-byte cp.async where `vec`
// (ld, i0 and i1 multiples of 8, src 16-byte aligned); else plain loads.
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                          size_t ld, int o0, int o1, int i0, int i1, bool vec) {
  for (int c = threadIdx.x; c < 64 * 8; c += THREADS) {
    const int oo = c >> 3, ii = (c & 7) * 8;
    const int o = o0 + oo, i = i0 + ii;
    __nv_bfloat16* d = dst + oo * TP + ii;
    if (vec) {
      const bool ok = o < o1 && i < i1;
      cp_async16(d, ok ? src + o * ld + i : src, ok);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e)
        d[e] = (o < o1 && i + e < i1) ? src[o * ld + i + e] : __float2bfloat16(0.f);
    }
  }
}

// Shared memory of one block: the ring of STAGES tiles (BM rows of u and a
// 64 x 64 weight tile each), h [BM][rank_pad(r) + 8] f32, the exchange
// [BM][XS] and this block's reduced slice [BM / CLN][XS] f32.
template <int BM, int STAGES, int CLN>
__host__ __device__ constexpr int pair_smem(int r) {
  return STAGES * (BM + 64) * TP * 2 + BM * (rank_pad(r) + 8) * 4 + BM * XS * 4 +
         BM / CLN * XS * 4;
}

// One block's stream of tiles: phase 1's (rank tile, task, k tile), then
// phase 2's (n tile, task, rank tile), in the order the products take them.
struct Stream {
  int nu, nk, nn, nrt, P1, total;  // tasks, k tiles, n tiles, rank tiles; counts
  int kb, ke, nb, ne;              // this block's K and N slices
  int ld1, ld2;                    // the weights' strides across their tile rows
  bool w1_kfast, w2_nfast;         // which index of each weight runs along memory
  bool vec_u, vec_w1, vec_w2;      // 16-byte copies
};

// Issues the copies of tile i of the stream into its ring slot (nothing
// past the end) and commits them as one group.
template <int BM, int STAGES>
__device__ __forceinline__ void issue_tile(const PairArgs& p, const Stream& s,
                                           __nv_bfloat16* ring, const int* row_s,
                                           const int* task_s, const int* uniq_s, int i) {
  if (i < s.total) {
    __nv_bfloat16* st = ring + (i % STAGES) * ((BM + 64) * TP);
    const int r = p.r;
    if (i < s.P1) {
      const int jt = i / (s.nu * s.nk), ui = i % (s.nu * s.nk) / s.nk, kt = i % s.nk;
      const int u = uniq_s[ui], k0 = s.kb + kt * BK, j0 = jt * RT;
      for (int c = threadIdx.x; c < BM * 8; c += THREADS) {  // the rows of task u
        const int mm = c >> 3, k = k0 + (c & 7) * 8, m = row_s[mm];
        const bool ok = m >= 0 && task_s[mm] == u;
        __nv_bfloat16* d = st + mm * TP + (c & 7) * 8;
        const __nv_bfloat16* src = p.u + static_cast<size_t>(ok ? m : 0) * p.K1 + k;
        if (s.vec_u) {
          cp_async16(d, ok && k < s.ke ? src : p.u, ok && k < s.ke);
        } else {
#pragma unroll
          for (int e = 0; e < 8; ++e)
            d[e] = ok && k + e < s.ke ? src[e] : __float2bfloat16(0.f);
        }
      }
      const __nv_bfloat16* w = p.w1 + static_cast<size_t>(u) * p.K1 * r;
      if (s.w1_kfast)
        load_tile(st + BM * TP, w, s.ld1, j0, r, k0, s.ke, s.vec_w1);
      else
        load_tile(st + BM * TP, w, s.ld1, k0, s.ke, j0, r, s.vec_w1);
    } else {
      const int i2 = i - s.P1;
      const int nt = i2 / (s.nu * s.nrt), ui = i2 % (s.nu * s.nrt) / s.nrt, jt = i2 % s.nrt;
      const int u = uniq_s[ui], n0 = s.nb + nt * BN, j0 = jt * RT;
      const __nv_bfloat16* w = p.w2 + static_cast<size_t>(u) * r * p.N2;
      if (s.w2_nfast)
        load_tile(st + BM * TP, w, s.ld2, j0, r, n0, s.ne, s.vec_w2);
      else
        load_tile(st + BM * TP, w, s.ld2, n0, s.ne, j0, r, s.vec_w2);
    }
  }
  cp_async_commit();
}

// The next tile of the stream, landed for every thread; the ring slot of
// the tile before it is refilled, STAGES - 1 tiles ahead.
template <int BM, int STAGES>
__device__ __forceinline__ const __nv_bfloat16* next_tile(const PairArgs& p, const Stream& s,
                                                          __nv_bfloat16* ring, const int* row_s,
                                                          const int* task_s, const int* uniq_s,
                                                          int& issued, int& cur) {
  cp_async_wait<STAGES - 2>();
  __syncthreads();
  issue_tile<BM, STAGES>(p, s, ring, row_s, task_s, uniq_s, issued++);
  return ring + (cur++ % STAGES) * ((BM + 64) * TP);
}

// Phase 1 (rank space) and phase 2 (back out) of one task group on tensor
// cores; see the header.  BM rows per block: 4 warps of 16 rows (BM = 64,
// each warp all 64 columns of a tile) or one 16-row tile whose 64 columns
// the warps split (BM = 16).
// CLN blocks form a cluster along y (the launch sets it).
template <int BM, int STAGES, int CLN>
__global__ void __launch_bounds__(THREADS, 1) grouped_lora_pair_kernel(PairArgs p) {
  constexpr int WM = BM / 16, WN = 4 / WM, NT = 8 / WN, NP = NT / 2;
  constexpr int SLICE = BM / CLN;  // rows whose cluster-wide sum this block takes
  constexpr int STAGE = (BM + 64) * TP;
  static_assert(BM % CLN == 0 && WM * WN == 4, "tile shape");

  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int row_s[BM], task_s[BM], uniq_s[MAXROWS], rows_all[MAXROWS], rt_s[MAXROWS];
  __shared__ int n_uniq_s, n_rows_s, want_s;

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp / WN, wn = warp % WN;
  const int g8 = lane >> 2, t4 = lane & 3;
  const int M = p.M, K1 = p.K1, N2 = p.N2, r = p.r;
  const int rp = rank_pad(r), HS = rp + 8, nrt = rp / RT;

  __nv_bfloat16* ring = reinterpret_cast<__nv_bfloat16*>(smem);
  float* h_s = reinterpret_cast<float*>(ring + STAGES * STAGE);
  float* xchg_s = h_s + BM * HS;
  float* red_s = xchg_s + BM * XS;

  // this block's slices: phase 1 reduces K1 rows [kb, ke), phase 2 writes
  // N2 columns [nb, ne); both in whole tiles of 64
  Stream sm;
  const int kspan = ((K1 + CLN - 1) / CLN + BK - 1) / BK * BK;
  sm.kb = min(K1, rank * kspan);
  sm.ke = min(K1, sm.kb + kspan);
  sm.nk = (sm.ke - sm.kb + BK - 1) / BK;
  const int nspan = ((N2 + CLN - 1) / CLN + BN - 1) / BN * BN;
  sm.nb = min(N2, rank * nspan);
  sm.ne = min(N2, sm.nb + nspan);
  sm.nn = (sm.ne - sm.nb + BN - 1) / BN;
  sm.nrt = nrt;
  const int nb = sm.nb, ne = sm.ne, nn = sm.nn, nk = sm.nk;

  // which index of each weight runs along memory, and whether its tiles
  // take 16-byte copies
  sm.w1_kfast = p.s1k == 1;  // tile [j][k]: B operand without .trans
  sm.w2_nfast = p.s2n == 1;  // tile [j][n]: B operand by .trans
  sm.ld1 = sm.w1_kfast ? p.s1j : p.s1k;
  sm.ld2 = sm.w2_nfast ? p.s2j : p.s2n;
  const bool aligned_w =
      ((reinterpret_cast<uintptr_t>(p.w1) | reinterpret_cast<uintptr_t>(p.w2)) & 15) == 0 &&
      (static_cast<size_t>(K1) * r) % 8 == 0 && (static_cast<size_t>(N2) * r) % 8 == 0;
  sm.vec_u = K1 % 8 == 0 && (reinterpret_cast<uintptr_t>(p.u) & 15) == 0;
  sm.vec_w1 = aligned_w && sm.ld1 % 8 == 0 && (sm.w1_kfast ? K1 : r) % 8 == 0;
  sm.vec_w2 = aligned_w && sm.ld2 % 8 == 0 && (sm.w2_nfast ? N2 : r) % 8 == 0;

  // ---- which rows: a tile of BM consecutive rows, or a task's rows gathered ----
  int n_groups = 1;
  bool arrived = false;  // a cluster barrier this block arrived at and has not waited on
  if (p.gather) {
    if (tid < M) {  // the call's row tasks, -1 outside [0, T)
      const int t = p.row_task[tid];
      rt_s[tid] = t >= 0 && t < p.T ? t : -1;
    }
    __syncthreads();
    if (tid == 0) {
      int n = 0;  // the call's distinct tasks, in order of first appearance
      for (int m = 0; m < M; ++m) {
        const int t = rt_s[m];
        bool seen = t < 0;
        for (int j = 0; j < n && !seen; ++j) seen = uniq_s[j] == t;
        if (!seen) uniq_s[n++] = t;
      }
      const int want = blockIdx.x < n ? uniq_s[blockIdx.x] : -1;
      int c = 0;
      for (int m = 0; m < M && want >= 0; ++m)
        if (rt_s[m] == want) rows_all[c++] = m;
      want_s = want;
      n_rows_s = c;
    }
    __syncthreads();
    if (blockIdx.x == 0) {  // the rows without a task: zeros (h too)
      for (int m = 0; m < M; ++m) {
        if (rt_s[m] >= 0) continue;
        for (int n = nb + tid; n < ne; n += THREADS)
          p.out[static_cast<size_t>(m) * N2 + n] = __float2bfloat16(0.f);
        if (p.hout != nullptr && rank == 0)
          for (int j = tid; j < r; j += THREADS) p.hout[static_cast<size_t>(m) * r + j] = 0.f;
      }
    }
    if (n_rows_s == 0) return;  // the whole cluster: every block saw the same rows
    n_groups = (n_rows_s + BM - 1) / BM;
  }

  for (int grp = 0; grp < n_groups; ++grp) {
    __syncthreads();  // the previous group's tiles and rows are no longer read
    if (tid < BM) {
      int m, t;
      if (p.gather) {
        const int i = grp * BM + tid;
        m = i < n_rows_s ? rows_all[i] : -1;
        t = m >= 0 ? want_s : -1;
      } else {
        m = blockIdx.x * BM + tid;
        t = m < M ? p.row_task[m] : -1;
        if (m >= M) m = -1;
        if (t >= p.T) t = -1;
      }
      row_s[tid] = m;
      task_s[tid] = t < 0 ? -1 : t;
    }
    __syncthreads();
    if (tid == 0) {
      int n = 0;
      for (int i = 0; i < BM; ++i) {
        const int t = task_s[i];
        bool seen = t < 0;
        for (int j = 0; j < n && !seen; ++j) seen = uniq_s[j] == t;
        if (!seen) uniq_s[n++] = t;
      }
      n_uniq_s = n;
    }
    __syncthreads();
    const int nu = n_uniq_s;

    sm.nu = nu;
    sm.P1 = nrt * nu * nk;
    sm.total = sm.P1 + nn * nu * nrt;
    int issued = 0, cur = 0;
    for (int i = 0; i < STAGES - 1; ++i)
      issue_tile<BM, STAGES>(p, sm, ring, row_s, task_s, uniq_s, issued++);

    const int row0 = wm * 16 + g8;  // this thread's rows: row0 and row0 + 8
    float acc[NT][4];

    // ---- phase 1: h = u @ W1[t] over this block's K slice, a rank tile at a time ----
    for (int jt = 0; jt < nrt; ++jt) {
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;
      for (int ui = 0; ui < nu; ++ui)
        for (int kt = 0; kt < nk; ++kt) {
          const __nv_bfloat16* st =
              next_tile<BM, STAGES>(p, sm, ring, row_s, task_s, uniq_s, issued, cur);
#pragma unroll
          for (int kk = 0; kk < BK / 16; ++kk) {
            uint32_t a[4];
            ldmatrix_x4(a, st + (wm * 16 + (lane & 15)) * TP + kk * 16 + (lane >> 4) * 8);
#pragma unroll
            for (int np = 0; np < NP; ++np) {
              uint32_t b[4];
              b_frags(b, st + BM * TP, !sm.w1_kfast, kk * 16, wn * NT * 8 + np * 16);
              // each k-step's products into zeroed accumulators, then added
              // in f32 with round-to-nearest (the tensor cores truncate their
              // own sums)
              float t0[4] = {0.f, 0.f, 0.f, 0.f}, t1[4] = {0.f, 0.f, 0.f, 0.f};
              mma_bf16(t0, a, b[0], b[1]);
              mma_bf16(t1, a, b[2], b[3]);
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                acc[2 * np][e] += t0[e];
                acc[2 * np + 1][e] += t1[e];
              }
            }
          }
        }
      // the cluster's K slices summed: this block's partial into the
      // exchange, each block sums a slice of the rows over the cluster in
      // rank order, then every block gathers the sums into its h
      const int j0 = jt * RT;
      if (arrived) cluster_wait();  // every block has read the last exchange
      arrived = false;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int c = wn * NT * 8 + nt * 8 + 2 * t4;
        *reinterpret_cast<float2*>(xchg_s + row0 * XS + c) = make_float2(acc[nt][0], acc[nt][1]);
        *reinterpret_cast<float2*>(xchg_s + (row0 + 8) * XS + c) =
            make_float2(acc[nt][2], acc[nt][3]);
      }
      cluster.sync();
      for (int i = tid; i < SLICE * RT; i += THREADS) {
        const int rr = i / RT, c = i % RT, row = rank * SLICE + rr;
        float v[CLN];
#pragma unroll
        for (int q = 0; q < CLN; ++q) v[q] = cluster.map_shared_rank(xchg_s, q)[row * XS + c];
        float s = 0.f;
#pragma unroll
        for (int q = 0; q < CLN; ++q) s += v[q];
        if (p.backward) {  // dh = (g @ B^T) * scale
          const int t = task_s[row];
          s *= t >= 0 ? p.scale[t] : 0.f;
        }
        red_s[rr * XS + c] = s;
        if (p.hout != nullptr && row_s[row] >= 0 && j0 + c < r)
          p.hout[static_cast<size_t>(row_s[row]) * r + j0 + c] = s;
      }
      cluster.sync();
      for (int i = tid; i < BM * RT / 4; i += THREADS) {
        const int row = i / (RT / 4), c = i % (RT / 4) * 4;
        *reinterpret_cast<float4*>(h_s + row * HS + j0 + c) = *reinterpret_cast<const float4*>(
            cluster.map_shared_rank(red_s, row / SLICE) + (row % SLICE) * XS + c);
      }
      // no block refills its exchange, or leaves, while another reads it:
      // the wait comes before the next exchange or the kernel's end
      cluster_arrive();
      arrived = true;
    }

    // ---- phase 2: out = h @ W2[t] (* scale[t] forward) over this block's N slice ----
    const int t_r0 = task_s[row0], t_r1 = task_s[row0 + 8];
    const float gate0 = t_r0 < 0 ? 0.f : (p.backward ? 1.f : p.scale[t_r0]);
    const float gate1 = t_r1 < 0 ? 0.f : (p.backward ? 1.f : p.scale[t_r1]);
    for (int ntile = 0; ntile < nn; ++ntile) {
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;
      for (int ui = 0; ui < nu; ++ui) {
        const int u = uniq_s[ui];
        const bool on0 = t_r0 == u, on1 = t_r1 == u;
        for (int jt = 0; jt < nrt; ++jt) {
          const __nv_bfloat16* st =
              next_tile<BM, STAGES>(p, sm, ring, row_s, task_s, uniq_s, issued, cur);
#pragma unroll
          for (int kk = 0; kk < RT / 16; ++kk) {
            // h's rows of this task as three bf16 terms: A operands that
            // keep h's f32 precision (the Pallas kernel multiplies f32 h by
            // B cast to f32)
            const float* h0 = h_s + row0 * HS + jt * RT + kk * 16 + 2 * t4;
            const float2 zero = make_float2(0.f, 0.f);
            uint32_t a[3][4];
            split3(on0 ? *reinterpret_cast<const float2*>(h0) : zero, a[0][0], a[1][0], a[2][0]);
            split3(on1 ? *reinterpret_cast<const float2*>(h0 + 8 * HS) : zero, a[0][1], a[1][1],
                   a[2][1]);
            split3(on0 ? *reinterpret_cast<const float2*>(h0 + 8) : zero, a[0][2], a[1][2],
                   a[2][2]);
            split3(on1 ? *reinterpret_cast<const float2*>(h0 + 8 * HS + 8) : zero, a[0][3],
                   a[1][3], a[2][3]);
#pragma unroll
            for (int np = 0; np < NP; ++np) {
              uint32_t b[4];
              b_frags(b, st + BM * TP, sm.w2_nfast, kk * 16, wn * NT * 8 + np * 16);
              float t0[4] = {0.f, 0.f, 0.f, 0.f}, t1[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
              for (int term = 2; term >= 0; --term) {  // the smallest first
                mma_bf16(t0, a[term], b[0], b[1]);
                mma_bf16(t1, a[term], b[2], b[3]);
              }
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                acc[2 * np][e] += t0[e];
                acc[2 * np + 1][e] += t1[e];
              }
            }
          }
        }
      }
      // one rounding to bf16 per output, the gate applied to the f32 sum
      const int m0 = row_s[row0], m1 = row_s[row0 + 8];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int n = nb + ntile * BN + wn * NT * 8 + nt * 8 + 2 * t4;
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {  // rows row0 and row0 + 8
          const int m = hf ? m1 : m0;
          const float gate = hf ? gate1 : gate0;
          if (m < 0 || n >= ne) continue;
          __nv_bfloat16* o = p.out + static_cast<size_t>(m) * N2 + n;
          const float v0 = acc[nt][2 * hf] * gate, v1 = acc[nt][2 * hf + 1] * gate;
          if (n + 1 < ne && N2 % 2 == 0) {
            *reinterpret_cast<__nv_bfloat162*>(o) = __floats2bfloat162_rn(v0, v1);
          } else {
            o[0] = __float2bfloat16(v0);
            if (n + 1 < ne) o[1] = __float2bfloat16(v1);
          }
        }
      }
    }
    cp_async_wait<0>();  // the stream's trailing (empty) groups
  }
  if (arrived) cluster_wait();
}

template <int BM, int STAGES, int CLN>
cudaError_t launch_pair(const PairArgs& p, cudaStream_t stream) {
  auto kernel = grouped_lora_pair_kernel<BM, STAGES, CLN>;
  const int smem = pair_smem<BM, STAGES, CLN>(p.r);
  static int raised = 0;  // the largest shared memory granted so far
  if (smem > raised) {
    cudaError_t err = cudaSuccess;
    if (CLN > 8 && raised == 0)  // past the portable cluster size
      err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    raised = smem;
  }
  const int tiles = p.gather ? (p.M < p.T ? p.M : p.T) : (p.M + BM - 1) / BM;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(tiles, CLN);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = CLN;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, p);
  return err != cudaSuccess ? err : cudaGetLastError();
}

cudaError_t run_pair(PairArgs p, cudaStream_t stream) {
  p.gather = p.M <= MAXROWS;
  if (rank_pad(p.r) > 256) return launch_pair<16, 2, CL>(p, stream);  // h of 16 rows only
  // decode: a task's A and B read by clusters of 16 blocks (past the
  // portable 8; the H100 schedules 16): the time there is set by tiles per
  // block, not by bytes, and 16 blocks halve them
  if (p.gather) return launch_pair<16, 8, 16>(p, stream);
  return launch_pair<64, 3, CL>(p, stream);
}

// ---- the per-task reduction: dA and dB ----
//
//   dA[t][c][j] = sum over rows m of task t of x[m][c] dh[m][j]           (c < d_in)
//   dB[t][j][c] = scale[t] sum over rows m of task t of h[m][j] g[m][c]   (c < d_out)
//
// Both are out[j][c] = sum_m V[m][j] U[m][c] with U the bf16 rows (x or g)
// and V the f32 rank-space rows (dh or h).  A cluster of RD_CL blocks takes
// one (task, 128 columns c, rank tile of RJ): each block finds the 64-row
// chunks that hold a row of its task (a pass over row_task on the device)
// and sums a contiguous share of them on the tensor cores, mma.m16n8k16 with
// A = V^T (rank rows; f32 V as two bf16 terms, hi + lo, which keep it to
// 16 significant bits) and B = U (columns c), both by ldmatrix.trans from
// row-major chunk tiles.  Chunks stream through a 3-stage cp.async ring;
// rows of other tasks are zero-filled and never read.  The shares meet
// through distributed shared memory: each block sums a slice of the columns
// over the cluster in rank order and writes it as bf16 straight from the f32
// sum, once.  A slot with no rows sums nothing and writes exact zeros.
// Rank tiles are 16 wide for r <= 16 (the training path's stacks) and 64
// wide above, one per grid z.  What bounds it on the H100: bytes, the
// slot's rows of x and g (each read once, by the cluster of its column
// tile) and of dh and h (once per column tile), against 2 M r (d_in +
// d_out) operations a term.

constexpr int RD_THREADS = 128;  // 4 warps x 32 columns
constexpr int RD_CT = 128;       // columns c of a block
constexpr int RD_CHUNK = 64;     // rows of a chunk
constexpr int RD_STAGES = 3;
constexpr int RD_CL = 4;         // blocks of a cluster
constexpr int RD_US = RD_CT + 8;  // a U tile row in bf16 (ldmatrix rows on distinct banks)
constexpr int RD_MAX_M = 1 << 20;

template <int RJ>
struct RdShape {
  static constexpr int JT = RJ / 16;                      // rank m16 tiles
  static constexpr int U_TILE = RD_CHUNK * RD_US * 2;      // bytes
  static constexpr int V_TILE = RD_CHUNK * RJ * 4;         // f32 [64][RJ]
  static constexpr int STAGE = U_TILE + V_TILE;
  static constexpr int VS = RJ + 8;                       // a split-V row in bf16
  static constexpr int SPLIT = RD_CHUNK * VS * 2;          // bytes, one term
  static constexpr int ES = RD_CT + 4;                    // an exchange row in f32
  static constexpr int FIXED = RD_STAGES * STAGE + 2 * SPLIT;
  static_assert(RJ * ES * 4 <= RD_STAGES * STAGE, "the exchange reuses the ring");
};

template <int RJ>
__host__ __device__ constexpr int rd_smem(int M) {
  const int nch = (M + RD_CHUNK - 1) / RD_CHUNK;
  return RdShape<RJ>::FIXED + (nch + 15) / 16 * 16 + 4 * nch;  // + chunk flags and list
}

struct RdArgs {
  const __nv_bfloat16* x;
  const __nv_bfloat16* g;
  const float* dh;
  const float* h;
  const int* row_task;
  const float* scale;
  __nv_bfloat16* da;
  __nv_bfloat16* db;
  int M, d_in, d_out, T, r;
  int tiles_a;  // column tiles of dA; those of dB follow
};

// The copies of one chunk (rows [m0, m0 + 64)) into a ring slot: U's
// columns [c0, c0 + 128) and V's [j0, j0 + RJ), rows of task t only, zeros
// elsewhere; one commit group.
template <int RJ>
__device__ __forceinline__ void rd_issue(const __nv_bfloat16* U, const float* V, int C,
                                         const RdArgs& p, int t, int m0, int c0, int j0,
                                         uint8_t* slot, bool vec_u, bool vec_v) {
  using S = RdShape<RJ>;
  __nv_bfloat16* ut = reinterpret_cast<__nv_bfloat16*>(slot);
  float* vt = reinterpret_cast<float*>(slot + S::U_TILE);
  for (int v = threadIdx.x; v < RD_CHUNK * (RD_CT / 8); v += RD_THREADS) {
    const int row = v / (RD_CT / 8), c = c0 + v % (RD_CT / 8) * 8, m = m0 + row;
    const bool mine = m < p.M && p.row_task[m] == t;
    __nv_bfloat16* d = ut + row * RD_US + v % (RD_CT / 8) * 8;
    const __nv_bfloat16* src = U + static_cast<size_t>(m) * C + c;
    if (vec_u) {
      const bool ok = mine && c < C;
      cp_async16(d, ok ? src : U, ok);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e) d[e] = mine && c + e < C ? src[e] : __float2bfloat16(0.f);
    }
  }
  for (int v = threadIdx.x; v < RD_CHUNK * (RJ / 4); v += RD_THREADS) {
    const int row = v / (RJ / 4), j = j0 + v % (RJ / 4) * 4, m = m0 + row;
    const bool mine = m < p.M && p.row_task[m] == t;
    float* d = vt + row * RJ + v % (RJ / 4) * 4;
    const float* src = V + static_cast<size_t>(m) * p.r + j;
    if (vec_v) {
      const bool ok = mine && j < p.r;
      cp_async16(d, ok ? src : V, ok);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) d[e] = mine && j + e < p.r ? src[e] : 0.f;
    }
  }
  cp_async_commit();
}

// grid ((tiles of dA + tiles of dB) * RD_CL, T, rank tiles); see above.
template <int RJ>
__global__ void __launch_bounds__(RD_THREADS) grouped_lora_reduce_kernel(RdArgs p) {
  using S = RdShape<RJ>;
  extern __shared__ __align__(16) uint8_t smem[];
  __shared__ int n_list_s;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int tile = blockIdx.x / RD_CL, t = blockIdx.y, j0 = blockIdx.z * RJ;
  const bool is_b = tile >= p.tiles_a;
  const int C = is_b ? p.d_out : p.d_in;
  const int c0 = (is_b ? tile - p.tiles_a : tile) * RD_CT;
  const __nv_bfloat16* U = is_b ? p.g : p.x;
  const float* V = is_b ? p.h : p.dh;
  const bool vec_u = C % 8 == 0 && (reinterpret_cast<uintptr_t>(U) & 15) == 0;
  const bool vec_v = p.r % 4 == 0 && (reinterpret_cast<uintptr_t>(V) & 15) == 0;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  uint8_t* ring = smem;
  __nv_bfloat16* vhi = reinterpret_cast<__nv_bfloat16*>(smem + RD_STAGES * S::STAGE);
  __nv_bfloat16* vlo = vhi + RD_CHUNK * S::VS;
  const int nch = (p.M + RD_CHUNK - 1) / RD_CHUNK;
  uint8_t* flag = smem + S::FIXED;
  int* list = reinterpret_cast<int*>(flag + (nch + 15) / 16 * 16);

  // the chunks that hold a row of task t, in row order
  for (int i = tid; i < nch; i += RD_THREADS) flag[i] = 0;
  __syncthreads();
  for (int m = tid; m < p.M; m += RD_THREADS)
    if (p.row_task[m] == t) flag[m / RD_CHUNK] = 1;
  __syncthreads();
  if (warp == 0) {
    int n = 0;
    for (int base = 0; base < nch; base += 32) {
      const bool f = base + lane < nch && flag[base + lane];
      const unsigned bal = __ballot_sync(0xffffffffu, f);
      if (f) list[n + __popc(bal & ((1u << lane) - 1))] = base + lane;
      n += __popc(bal);
    }
    if (lane == 0) n_list_s = n;
  }
  __syncthreads();
  const int n_all = n_list_s;
  const int lo = rank * n_all / RD_CL, n = (rank + 1) * n_all / RD_CL - lo;

  float acc[S::JT][4][4];
#pragma unroll
  for (int jt = 0; jt < S::JT; ++jt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[jt][nt][e] = 0.f;

  for (int i = 0; i < RD_STAGES - 1; ++i) {
    if (i < n)
      rd_issue<RJ>(U, V, C, p, t, list[lo + i] * RD_CHUNK, c0, j0, ring + i * S::STAGE, vec_u,
                   vec_v);
    else
      cp_async_commit();
  }
  const int row_s = tid >> 1, half = tid & 1;  // this thread's share of the split
  for (int i = 0; i < n; ++i) {
    cp_async_wait<RD_STAGES - 2>();
    __syncthreads();  // chunk i landed; chunk i - 1's slot and split terms are free
    const int nx = i + RD_STAGES - 1;
    if (nx < n)
      rd_issue<RJ>(U, V, C, p, t, list[lo + nx] * RD_CHUNK, c0, j0,
                   ring + (nx % RD_STAGES) * S::STAGE, vec_u, vec_v);
    else
      cp_async_commit();
    const uint8_t* slot = ring + (i % RD_STAGES) * S::STAGE;
    const __nv_bfloat16* ut = reinterpret_cast<const __nv_bfloat16*>(slot);
    const float* vt = reinterpret_cast<const float*>(slot + S::U_TILE);
    // V's rows as two bf16 terms
#pragma unroll
    for (int jj = 0; jj < RJ / 2; jj += 2) {
      const int j = half * (RJ / 2) + jj;
      split2(*reinterpret_cast<const float2*>(vt + row_s * RJ + j),
             *reinterpret_cast<__nv_bfloat162*>(vhi + row_s * S::VS + j),
             *reinterpret_cast<__nv_bfloat162*>(vlo + row_s * S::VS + j));
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < RD_CHUNK / 16; ++kk) {
      const int mrow = kk * 16 + (lane & 7);
      uint32_t b[2][4];  // U's columns warp * 32 + [0, 16) and [16, 32)
#pragma unroll
      for (int np = 0; np < 2; ++np)
        ldmatrix_x4_trans(b[np], ut + (mrow + ((lane >> 3) & 1) * 8) * RD_US + warp * 32 +
                                     np * 16 + (lane >> 4) * 8);
#pragma unroll
      for (int jt = 0; jt < S::JT; ++jt) {
        uint32_t ah[4], al[4];  // V^T's rank rows jt * 16 + [0, 16)
        const int off = (mrow + (lane >> 4) * 8) * S::VS + jt * 16 + ((lane >> 3) & 1) * 8;
        ldmatrix_x4_trans(ah, vhi + off);
        ldmatrix_x4_trans(al, vlo + off);
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          const uint32_t b0 = b[nt >> 1][(nt & 1) * 2], b1 = b[nt >> 1][(nt & 1) * 2 + 1];
          mma_bf16(acc[jt][nt], al, b0, b1);
          mma_bf16(acc[jt][nt], ah, b0, b1);
        }
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring becomes the exchange

  // partials [RJ][RD_CT] f32: acc[jt][nt] holds rank rows jt * 16 + g (+8)
  // and columns warp * 32 + nt * 8 + 2c (+1)
  float* ex = reinterpret_cast<float*>(ring);
  const int g = lane >> 2, c = lane & 3;
#pragma unroll
  for (int jt = 0; jt < S::JT; ++jt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const int j = jt * 16 + g, cc = warp * 32 + nt * 8 + 2 * c;
      *reinterpret_cast<float2*>(ex + j * S::ES + cc) = make_float2(acc[jt][nt][0], acc[jt][nt][1]);
      *reinterpret_cast<float2*>(ex + (j + 8) * S::ES + cc) =
          make_float2(acc[jt][nt][2], acc[jt][nt][3]);
    }
  cluster.sync();
  // this block's columns [rank * cols, (rank + 1) * cols), summed over the
  // cluster in rank order, rounded once to bf16
  constexpr int cols = RD_CT / RD_CL;
  const float f = is_b ? p.scale[t] : 1.f;
  for (int e = tid; e < cols * RJ; e += RD_THREADS) {
    // dA is [c][j] in memory, dB [j][c]: the faster index runs along memory
    const int j = is_b ? e / cols : e % RJ, cl = is_b ? e % cols : e / RJ;
    const int cc = rank * cols + cl;
    if (c0 + cc >= C || j0 + j >= p.r) continue;
    float sum = 0.f;
#pragma unroll
    for (int q = 0; q < RD_CL; ++q) sum += cluster.map_shared_rank(ex, q)[j * S::ES + cc];
    const __nv_bfloat16 out = __float2bfloat16(sum * f);
    if (is_b)
      p.db[(static_cast<size_t>(t) * p.r + j0 + j) * p.d_out + c0 + cc] = out;
    else
      p.da[(static_cast<size_t>(t) * p.d_in + c0 + cc) * p.r + j0 + j] = out;
  }
  cluster.sync();  // no block leaves while another reads its partials
}

template <int RJ>
cudaError_t launch_reduce(const RdArgs& p, cudaStream_t stream) {
  auto kernel = grouped_lora_reduce_kernel<RJ>;
  const int smem = rd_smem<RJ>(p.M);
  static int raised = 0;  // the largest shared memory granted so far
  if (smem > raised) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    raised = smem;
  }
  const int tiles_b = (p.d_out + RD_CT - 1) / RD_CT;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((p.tiles_a + tiles_b) * RD_CL, p.T, (p.r + RJ - 1) / RJ);
  cfg.blockDim = dim3(RD_THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = RD_CL;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, p);
  return err != cudaSuccess ? err : cudaGetLastError();
}

bool bad_sizes(int M, int d_in, int d_out, int T, int r) {
  return M <= 0 || d_in <= 0 || d_out <= 0 || T <= 0 || r <= 0 || r > RANK_LIMIT ||
         M > RD_MAX_M;
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
// gradient g [M, d_out] bf16 -> dx [M, d_in] bf16, da [T, d_in, r] bf16,
// db [T, r, d_out] bf16; dh [M, r] f32 is scratch.  Two launches on the stream:
// the pair kernel (dh, dx), then the per-task reduction (dA, dB).
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
  RdArgs q{static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(g),
           static_cast<const float*>(dh), static_cast<const float*>(h),
           static_cast<const int*>(row_task), static_cast<const float*>(scale),
           static_cast<__nv_bfloat16*>(da), static_cast<__nv_bfloat16*>(db), M, d_in, d_out,
           T, r, (d_in + RD_CT - 1) / RD_CT};
  err = r <= 16 ? launch_reduce<16>(q, st) : launch_reduce<64>(q, st);
  return static_cast<int>(err);
}

extern "C" const char* grouped_lora_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
