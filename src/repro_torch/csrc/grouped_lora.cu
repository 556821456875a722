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
//   * The per-task sums dA and dB run in a second kernel: one block per
//     (64 output columns, slot, dA or dB) walks all rows in order, skipping
//     32-row chunks that hold no row of its slot, once per rank tile.
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

constexpr int THREADS = 128;      // pair kernel: 4 warps
constexpr int RED_THREADS = 256;  // reduce kernel
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

constexpr int RC = 64;  // output columns per reduction block
constexpr int RM = 32;  // rows per reduction chunk

// blockIdx.z == 0: da[t][c][j] = sum_m x[m][c] dh[m][j]          (c < d_in)
// blockIdx.z == 1: db[t][j][c] = scale[t] sum_m h[m][j] g[m][c]  (c < d_out)
// over the rows m of task t, in row order, a rank tile of RT columns j at a
// time.
__global__ void __launch_bounds__(RED_THREADS)
grouped_lora_reduce_kernel(const __nv_bfloat16* __restrict__ x,
                           const __nv_bfloat16* __restrict__ g,
                           const float* __restrict__ dh, const float* __restrict__ h,
                           const int* __restrict__ row_task, const float* __restrict__ scale,
                           float* __restrict__ da, float* __restrict__ db, int M, int d_in,
                           int d_out, int r) {
  __shared__ float u_s[RM * RC];
  __shared__ float v_s[RM * RT];
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
  const int jg = tid / RC;  // this thread's ranks in the tile: jg, jg + 4, ...
  const float f = dB ? scale[t] : 1.f;
  for (int j0 = 0; j0 < r; j0 += RT) {
    const int jn = min(RT, r - j0);
    float acc[RT / 4];
#pragma unroll
    for (int q = 0; q < RT / 4; ++q) acc[q] = 0.f;

    for (int m0 = 0; m0 < M; m0 += RM) {
      __syncthreads();  // the previous chunk is no longer read
      if (tid == 0) any_s = 0;
      __syncthreads();
      if (tid < RM && m0 + tid < M && row_task[m0 + tid] == t) any_s = 1;
      __syncthreads();
      if (!any_s) continue;
      for (int i = tid; i < RM * RC; i += RED_THREADS) {
        const int mm = i / RC, cc = i % RC, m = m0 + mm;
        u_s[i] = (m < M && row_task[m] == t && c0 + cc < C)
                     ? __bfloat162float(U[static_cast<size_t>(m) * C + c0 + cc])
                     : 0.f;
      }
      for (int i = tid; i < RM * RT; i += RED_THREADS) {
        const int mm = i / RT, j = i % RT, m = m0 + mm;
        v_s[i] = (m < M && row_task[m] == t && j < jn) ? V[static_cast<size_t>(m) * r + j0 + j]
                                                       : 0.f;
      }
      __syncthreads();
      for (int mm = 0; mm < RM; ++mm) {
        const float uv = u_s[mm * RC + c];
#pragma unroll
        for (int q = 0; q < RT / 4; ++q)
          if (jg + 4 * q < jn) acc[q] += uv * v_s[mm * RT + jg + 4 * q];
      }
    }
    if (c0 + c < C) {
#pragma unroll
      for (int q = 0; q < RT / 4; ++q) {
        const int j = j0 + jg + 4 * q;
        if (jg + 4 * q >= jn) continue;
        if (dB)
          db[(static_cast<size_t>(t) * r + j) * d_out + c0 + c] = acc[q] * f;
        else
          da[(static_cast<size_t>(t) * d_in + c0 + c) * r + j] = acc[q] * f;
      }
    }
  }
}

bool bad_sizes(int M, int d_in, int d_out, int T, int r) {
  return M <= 0 || d_in <= 0 || d_out <= 0 || T <= 0 || r <= 0 || r > RANK_LIMIT;
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
  grouped_lora_reduce_kernel<<<grid, RED_THREADS, 0, st>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(g),
      static_cast<const float*>(dh), static_cast<const float*>(h),
      static_cast<const int*>(row_task), static_cast<const float*>(scale),
      static_cast<float*>(da), static_cast<float*>(db), M, d_in, d_out, r);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* grouped_lora_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
