// Chunked SSD / gated-linear-attention scan for Hopper (sm_90a): forward
// (optionally saving each chunk's entry state) and the two backward kernels.
//
// Replaces the Pallas kernels of src/repro/kernels/mamba_scan.py:
//   forward        `_kernel`            (`_fwd_call`, with `save_states`);
//   state backward `_bwd_state_kernel`  (`_bwd_call`, first pallas_call);
//   chunk backward `_bwd_chunk_kernel`  (`_bwd_call`, second pallas_call).
//
// Per (batch row b, head h) and chunk of Q positions, with
//   cum_i = inclusive sum of la over the chunk's rows up to i,
//   gain_i = exp(li_i), seg_i = inclusive count of reset rows up to i,
//   dec(i, j) = exp(cum_i - cum_j) gain_j  for j <= i and seg_i == seg_j, else 0,
//   ec_i = exp(cum_i) [seg_i == 0],  w_j = exp(cum_last - cum_j) gain_j [seg_j == seg_last],
//   cdec = exp(cum_last) [seg_last == 0]:
// forward     y_i = sum_j dec(i, j) (q_i . k_j) v_j + ec_i q_i H
//             H  <- cdec H + sum_j w_j k_j (x) v_j        (H [dk, dv] f32, from h0)
// state bwd   G_exit(c) is saved per chunk, then G <- cdec G + sum_i ec_i q_i (x) dy_i,
//             from G = dhf at the last chunk; dh0 = G after the first chunk
// chunk bwd   dq_i = sum_j dec(i, j) (dy_i . v_j) k_j + ec_i H_in dy_i
//             dk_t = sum_i dec(i, t) (dy_i . v_t) q_i + w_t G_exit v_t
//             dv_t = sum_i dec(i, t) (q_i . k_t) dy_i + w_t G_exit^T k_t
//             dcum_t = q_t . dq_t - k_t . dk_t,  dli_t = k_t . dk_t
// Without reset rows every gate is 1.  The gates are exact comparisons of
// reset counts, never a -1e9 log-decay sentinel; the caller has zeroed la at
// the reset rows.  The in-chunk cumsums run sequentially in one thread, in
// the order of a plain loop.
//
// What bounds them on the H100: at the training shapes (B = rows of one
// micro-batch, S = 256, H = 80 heads, dk = dv = 64, Q = 256) the forward
// reads q, k, v (bf16), la, li and writes y, the final state and the entry
// states; about 2 Q^2 (dk + dv) / 2 + 2 Q dk dv operations per chunk and
// head, well under 295 per byte: bound by bytes.  The chunk backward does
// about three times the forward's products on four tiles (q, k, v, dy) in
// and three out, and is bound by bytes too; the state backward reads q and
// dy only.  These first versions run every product on the CUDA cores in f32
// and sit far above that bound; mma/wgmma and TMA come later.
//
// Design.  The Pallas grid runs its chunk axis in order on one core and
// carries the [dk, dv] state in VMEM scratch.  CUDA blocks run in no order,
// so the forward and the state backward run one block per (b, h) with a
// loop over that row's chunks; the state (16 KB f32) stays in shared memory
// (forward) or in registers (state backward).  The chunk backward carries
// nothing and runs one block per (chunk, b, h).  A chunk's q, k, v and dy
// tiles sit in shared memory as bf16 (exact), rows padded to 66 values so
// that column reads hit 16 banks.  The [Q, Q] decay-masked products do not
// fit (256 KB f32 at Q = 256): they run in 64 x 64 sub-blocks, building
// dec(i, j) on the fly from the [Q] vectors cum and gain, and only for
// j <= i (which is also what keeps the upper triangle's exponent from
// overflowing).  The backward's dq sums over keys j <= i and dk, dv over
// queries i >= t: one pass over query sub-blocks for dq, a second over key
// sub-blocks for dk and dv, both in the same block, so no sum needs atomics
// and every sum runs in a fixed order.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int THREADS = 256;  // 16 x 16: a thread owns 4 x 4 of a 64 x 64 tile
constexpr int D = 64;         // dk = dv
constexpr int SB = 64;        // sub-block rows
constexpr int TP = D + 2;     // bf16 tile row stride (33 words)
constexpr int FP = SB + 1;    // f32 64 x 64 tile row stride

struct Args {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  const float* la;
  const float* li;
  const int* r;        // [B, S] reset rows, or null: no gates
  const float* h0;     // forward initial state [B, H, D, D]
  bf16* y;
  float* hout;         // forward final state [B, H, D, D]
  float* hin;          // entry states [B * H, n, D, D] (forward out, chunk bwd in)
  const bf16* dy;
  const float* dhf;    // final-state cotangent [B, H, D, D]
  float* gexit;        // chunk-exit adjoints [B * H, n, D, D] (state bwd out, chunk bwd in)
  float* dh0;
  bf16* dq;
  bf16* dk;
  bf16* dv;
  float* dcum;         // [B, S, H]
  float* dli;
  int S, H, Q, n, QP;
};

__device__ __forceinline__ size_t row_off(const Args& a, int b, int t, int h) {
  return (static_cast<size_t>(b) * a.S + t) * a.H + h;
}

// Rows t0 .. t0 + Q - 1 of head h of x [B, S, H, D] into a [QP][TP] bf16
// tile, 16 bytes a load; rows past Q are zero.
__device__ void load_tile(const Args& a, bf16* dst, const bf16* src, int b, int t0, int h) {
  for (int i = threadIdx.x; i < a.QP * 8; i += THREADS) {
    const int row = i >> 3, part = i & 7;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row < a.Q) val = *reinterpret_cast<const uint4*>(src + row_off(a, b, t0 + row, h) * D + part * 8);
    uint32_t* w = reinterpret_cast<uint32_t*>(dst + row * TP + part * 8);
    w[0] = val.x;
    w[1] = val.y;
    w[2] = val.z;
    w[3] = val.w;
  }
}

// The chunk's vectors: cum and seg (sequential inclusive sums), ec, and, when
// gain is not null, gain and w.  Ends with a barrier.
__device__ void chunk_vectors(const Args& a, int b, int t0, int h, float* cum, int* seg,
                              float* gain, float* ec, float* w) {
  const int Q = a.Q, tid = threadIdx.x;
  for (int i = tid; i < Q; i += THREADS) {
    const size_t g = row_off(a, b, t0 + i, h);
    cum[i] = a.la[g];
    if (gain != nullptr) gain[i] = expf(a.li[g]);
    seg[i] = a.r != nullptr ? a.r[static_cast<size_t>(b) * a.S + t0 + i] : 0;
  }
  __syncthreads();
  if (tid == 0) {
    float c = 0.f;
    int s = 0;
    for (int i = 0; i < Q; ++i) {
      c += cum[i];
      cum[i] = c;
      s += seg[i];
      seg[i] = s;
    }
  }
  __syncthreads();
  const float total = cum[Q - 1];
  const int last = seg[Q - 1];
  for (int i = tid; i < Q; i += THREADS) {
    ec[i] = seg[i] == 0 ? expf(cum[i]) : 0.f;
    if (gain != nullptr) w[i] = seg[i] == last ? expf(total - cum[i]) * gain[i] : 0.f;
  }
  __syncthreads();
}

// exp(cum_last) when no reset row lies in the chunk, else 0
__device__ __forceinline__ float chunk_decay(const Args& a, const float* cum, const int* seg) {
  return seg[a.Q - 1] == 0 ? expf(cum[a.Q - 1]) : 0.f;
}

// s[i][j] = A[a0 + ty + 16 i] . B[b0 + tx + 16 j] over D, two values a load
__device__ __forceinline__ void tile_dots(const bf16* A, int a0, const bf16* Bm, int b0,
                                          float s[4][4]) {
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < D; d += 2) {
    float2 av[4], bv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      av[i] = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(A + (a0 + ty + 16 * i) * TP + d));
#pragma unroll
    for (int j = 0; j < 4; ++j)
      bv[j] = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(Bm + (b0 + tx + 16 * j) * TP + d));
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = fmaf(av[i].y, bv[j].y, fmaf(av[i].x, bv[j].x, s[i][j]));
  }
}

// acc[i][c] += sum_j P[ty + 16 i][j] X[x0 + j][tx + 16 c]  (P a [64][FP] f32 tile)
__device__ __forceinline__ void tile_pv(const float* P, const bf16* X, int x0, float acc[4][4]) {
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
#pragma unroll 4
  for (int j = 0; j < SB; ++j) {
    float p[4], x[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) p[i] = P[(ty + 16 * i) * FP + j];
#pragma unroll
    for (int c = 0; c < 4; ++c) x[c] = __bfloat162float(X[(x0 + j) * TP + tx + 16 * c]);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[i][c] = fmaf(p[i], x[c], acc[i][c]);
  }
}

// out[i][c] = sum_e X[x0 + ty + 16 i][e] M[tx + 16 c][e]   (X rows times M^T)
__device__ __forceinline__ void rows_times_mt(const bf16* X, int x0, const float* M,
                                              float out[4][4]) {
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < 4; ++c) out[i][c] = 0.f;
#pragma unroll 4
  for (int e = 0; e < D; ++e) {
    float x[4], m[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) x[i] = __bfloat162float(X[(x0 + ty + 16 * i) * TP + e]);
#pragma unroll
    for (int c = 0; c < 4; ++c) m[c] = M[(tx + 16 * c) * FP + e];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c) out[i][c] = fmaf(x[i], m[c], out[i][c]);
  }
}

// out[i][c] = sum_d (X[x0 + ty + 16 i][d] * sc[i]) M[d][tx + 16 c]   (scaled X rows times M)
__device__ __forceinline__ void rows_times_m(const bf16* X, int x0, const float sc[4],
                                             const float* M, float out[4][4]) {
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < 4; ++c) out[i][c] = 0.f;
#pragma unroll 4
  for (int d = 0; d < D; ++d) {
    float x[4], m[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) x[i] = __bfloat162float(X[(x0 + ty + 16 * i) * TP + d]) * sc[i];
#pragma unroll
    for (int c = 0; c < 4; ++c) m[c] = M[d * FP + tx + 16 * c];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c) out[i][c] = fmaf(x[i], m[c], out[i][c]);
  }
}

// acc[dd][e] += sum_j (X[j][ty + 16 dd] * sc[j]) Y[j][tx + 16 e] over the chunk's rows:
// the outer-product sums of the state updates.
__device__ __forceinline__ void outer_sum(const bf16* X, const float* sc, const bf16* Y, int Q,
                                          float acc[4][4]) {
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
#pragma unroll 4
  for (int j = 0; j < Q; ++j) {
    float x[4], y[4];
    const float s = sc[j];
#pragma unroll
    for (int i = 0; i < 4; ++i) x[i] = __bfloat162float(X[j * TP + ty + 16 * i]) * s;
#pragma unroll
    for (int c = 0; c < 4; ++c) y[c] = __bfloat162float(Y[j * TP + tx + 16 * c]);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[i][c] = fmaf(x[i], y[c], acc[i][c]);
  }
}

// dec(i, j) times s, or 0 where the pair is not live
__device__ __forceinline__ float decayed(const Args& a, int i, int j, float s, const float* cum,
                                         const int* seg, const float* gain) {
  return (j <= i && i < a.Q && seg[i] == seg[j]) ? s * (expf(cum[i] - cum[j]) * gain[j]) : 0.f;
}

// sum of v over the 16 threads of a half warp (the tx lanes of one ty)
__device__ __forceinline__ float row_sum16(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

size_t tile_bytes(int QP) { return static_cast<size_t>(QP) * TP * sizeof(bf16); }
constexpr size_t kStateBytes = static_cast<size_t>(SB) * FP * sizeof(float);

size_t fwd_smem(int QP) { return 3 * tile_bytes(QP) + 2 * kStateBytes + 5 * QP * sizeof(float); }
size_t state_smem(int QP) { return 2 * tile_bytes(QP) + 3 * QP * sizeof(float); }
size_t chunk_smem(int QP) { return 4 * tile_bytes(QP) + 3 * kStateBytes + 6 * QP * sizeof(float); }

__global__ void __launch_bounds__(THREADS) mamba_scan_fwd_kernel(Args a) {
  extern __shared__ float4 smem4[];
  const int QP = a.QP;
  bf16* qs = reinterpret_cast<bf16*>(smem4);
  bf16* ks = qs + QP * TP;
  bf16* vs = ks + QP * TP;
  float* hs = reinterpret_cast<float*>(vs + QP * TP);  // [D][FP] carried state
  float* ps = hs + SB * FP;                            // [SB][FP] decay-masked scores
  float* cum = ps + SB * FP;
  float* gain = cum + QP;
  float* ec = gain + QP;
  float* w = ec + QP;
  int* seg = reinterpret_cast<int*>(w + QP);

  const int bh = blockIdx.x, b = bh / a.H, h = bh % a.H;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int Q = a.Q, nsb = (Q + SB - 1) / SB;
  for (int i = tid; i < D * D; i += THREADS)
    hs[(i / D) * FP + i % D] = a.h0[static_cast<size_t>(bh) * D * D + i];

  for (int c = 0; c < a.n; ++c) {
    const int t0 = c * Q;
    __syncthreads();  // the previous chunk's tiles, vectors and state update are done
    load_tile(a, qs, a.q, b, t0, h);
    load_tile(a, ks, a.k, b, t0, h);
    load_tile(a, vs, a.v, b, t0, h);
    chunk_vectors(a, b, t0, h, cum, seg, gain, ec, w);
    if (a.hin != nullptr) {  // this chunk's entry state: the backward's residual
      float* dst = a.hin + (static_cast<size_t>(bh) * a.n + c) * D * D;
      for (int i = tid; i < D * D; i += THREADS) dst[i] = hs[(i / D) * FP + i % D];
    }
    for (int ib = 0; ib < nsb; ++ib) {
      float acc[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
      for (int jb = 0; jb <= ib; ++jb) {
        float s[4][4];
        tile_dots(qs, ib * SB, ks, jb * SB, s);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            ps[(ty + 16 * i) * FP + tx + 16 * j] =
                decayed(a, ib * SB + ty + 16 * i, jb * SB + tx + 16 * j, s[i][j], cum, seg, gain);
        __syncthreads();
        tile_pv(ps, vs, jb * SB, acc);
        __syncthreads();
      }
      float sc[4], inter[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = ib * SB + ty + 16 * i;
        sc[i] = row < Q ? ec[row] : 0.f;
      }
      rows_times_m(qs, ib * SB, sc, hs, inter);  // (ec_i q_i) H
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = ib * SB + ty + 16 * i;
        if (row >= Q) continue;
        bf16* dst = a.y + row_off(a, b, t0 + row, h) * D;
#pragma unroll
        for (int j = 0; j < 4; ++j) dst[tx + 16 * j] = __float2bfloat16(acc[i][j] + inter[i][j]);
      }
    }
    __syncthreads();  // every read of the entry state is done
    const float cdec = chunk_decay(a, cum, seg);
    float upd[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) upd[i][j] = 0.f;
    outer_sum(ks, w, vs, Q, upd);  // sum_j (w_j k_j) (x) v_j
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float* hp = hs + (ty + 16 * i) * FP + tx + 16 * j;
        *hp = cdec * *hp + upd[i][j];
      }
  }
  __syncthreads();
  for (int i = tid; i < D * D; i += THREADS)
    a.hout[static_cast<size_t>(bh) * D * D + i] = hs[(i / D) * FP + i % D];
}

__global__ void __launch_bounds__(THREADS) mamba_scan_bwd_state_kernel(Args a) {
  extern __shared__ float4 smem4[];
  const int QP = a.QP;
  bf16* qs = reinterpret_cast<bf16*>(smem4);
  bf16* dys = qs + QP * TP;
  float* cum = reinterpret_cast<float*>(dys + QP * TP);
  float* ec = cum + QP;
  int* seg = reinterpret_cast<int*>(ec + QP);

  const int bh = blockIdx.x, b = bh / a.H, h = bh % a.H;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  float g[4][4];  // G[ty + 16 i][tx + 16 j], carried in registers
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) g[i][j] = a.dhf[static_cast<size_t>(bh) * D * D + (ty + 16 * i) * D + tx + 16 * j];

  for (int c = a.n - 1; c >= 0; --c) {
    const int t0 = c * a.Q;
    __syncthreads();  // the previous chunk's tiles and vectors are no longer read
    load_tile(a, qs, a.q, b, t0, h);
    load_tile(a, dys, a.dy, b, t0, h);
    chunk_vectors(a, b, t0, h, cum, seg, nullptr, ec, nullptr);
    float* gx = a.gexit + (static_cast<size_t>(bh) * a.n + c) * D * D;
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) gx[(ty + 16 * i) * D + tx + 16 * j] = g[i][j];
    const float cdec = chunk_decay(a, cum, seg);
    float upd[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) upd[i][j] = 0.f;
    outer_sum(qs, ec, dys, a.Q, upd);  // sum_i (ec_i q_i) (x) dy_i
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) g[i][j] = cdec * g[i][j] + upd[i][j];
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) a.dh0[static_cast<size_t>(bh) * D * D + (ty + 16 * i) * D + tx + 16 * j] = g[i][j];
}

__global__ void __launch_bounds__(THREADS) mamba_scan_bwd_chunk_kernel(Args a) {
  extern __shared__ float4 smem4[];
  const int QP = a.QP;
  bf16* qs = reinterpret_cast<bf16*>(smem4);
  bf16* ks = qs + QP * TP;
  bf16* vs = ks + QP * TP;
  bf16* dys = vs + QP * TP;
  float* st = reinterpret_cast<float*>(dys + QP * TP);  // [D][FP]: H_in, then G_exit
  float* p1 = st + SB * FP;
  float* p2 = p1 + SB * FP;
  float* cum = p2 + SB * FP;
  float* gain = cum + QP;
  float* ec = gain + QP;
  float* w = ec + QP;
  float* qdq = w + QP;
  int* seg = reinterpret_cast<int*>(qdq + QP);

  const int bh = blockIdx.x, c = blockIdx.y, b = bh / a.H, h = bh % a.H;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int Q = a.Q, nsb = (Q + SB - 1) / SB, t0 = c * Q;
  const size_t soff = (static_cast<size_t>(bh) * a.n + c) * D * D;
  load_tile(a, qs, a.q, b, t0, h);
  load_tile(a, ks, a.k, b, t0, h);
  load_tile(a, vs, a.v, b, t0, h);
  load_tile(a, dys, a.dy, b, t0, h);
  for (int i = tid; i < D * D; i += THREADS) st[(i / D) * FP + i % D] = a.hin[soff + i];
  chunk_vectors(a, b, t0, h, cum, seg, gain, ec, w);

  // ---- pass 1, per query sub-block: dq and the rows q . dq ----
  for (int ib = 0; ib < nsb; ++ib) {
    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
    for (int jb = 0; jb <= ib; ++jb) {
      float s[4][4];
      tile_dots(dys, ib * SB, vs, jb * SB, s);  // dy_i . v_j
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          p1[(ty + 16 * i) * FP + tx + 16 * j] =
              decayed(a, ib * SB + ty + 16 * i, jb * SB + tx + 16 * j, s[i][j], cum, seg, gain);
      __syncthreads();
      tile_pv(p1, ks, jb * SB, acc);
      __syncthreads();
    }
    float inter[4][4];
    rows_times_mt(dys, ib * SB, st, inter);  // dy_i H_in^T
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = ib * SB + ty + 16 * i;
      const float e = row < Q ? ec[row] : 0.f;
      float part = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        acc[i][j] += e * inter[i][j];
        part += __bfloat162float(qs[row * TP + tx + 16 * j]) * acc[i][j];
      }
      part = row_sum16(part);
      if (row >= Q) continue;
      bf16* dst = a.dq + row_off(a, b, t0 + row, h) * D;
#pragma unroll
      for (int j = 0; j < 4; ++j) dst[tx + 16 * j] = __float2bfloat16(acc[i][j]);
      if (tx == 0) qdq[row] = part;
    }
  }
  __syncthreads();  // every read of H_in is done
  for (int i = tid; i < D * D; i += THREADS) st[(i / D) * FP + i % D] = a.gexit[soff + i];
  __syncthreads();

  // ---- pass 2, per key sub-block: dk, dv and the rows k . dk ----
  for (int tb = 0; tb < nsb; ++tb) {
    float adk[4][4], adv[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) adk[i][j] = adv[i][j] = 0.f;
    for (int ib = tb; ib < nsb; ++ib) {
      float s1[4][4], s2[4][4];
      tile_dots(vs, tb * SB, dys, ib * SB, s1);  // v_t . dy_i
      tile_dots(ks, tb * SB, qs, ib * SB, s2);   // k_t . q_i
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int t = tb * SB + ty + 16 * i, qi = ib * SB + tx + 16 * j;
          p1[(ty + 16 * i) * FP + tx + 16 * j] = decayed(a, qi, t, s1[i][j], cum, seg, gain);
          p2[(ty + 16 * i) * FP + tx + 16 * j] = decayed(a, qi, t, s2[i][j], cum, seg, gain);
        }
      __syncthreads();
      tile_pv(p1, qs, ib * SB, adk);
      tile_pv(p2, dys, ib * SB, adv);
      __syncthreads();
    }
    float ik[4][4], iv[4][4], sc[4];
    rows_times_mt(vs, tb * SB, st, ik);  // v_t G_exit^T
#pragma unroll
    for (int i = 0; i < 4; ++i) sc[i] = 1.f;
    rows_times_m(ks, tb * SB, sc, st, iv);  // k_t G_exit
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = tb * SB + ty + 16 * i;
      const float wt = row < Q ? w[row] : 0.f;
      float part = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        adk[i][j] += wt * ik[i][j];
        adv[i][j] += wt * iv[i][j];
        part += __bfloat162float(ks[row * TP + tx + 16 * j]) * adk[i][j];
      }
      part = row_sum16(part);
      if (row >= Q) continue;
      const size_t ro = row_off(a, b, t0 + row, h);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        a.dk[ro * D + tx + 16 * j] = __float2bfloat16(adk[i][j]);
        a.dv[ro * D + tx + 16 * j] = __float2bfloat16(adv[i][j]);
      }
      if (tx == 0) {
        a.dli[ro] = part;
        a.dcum[ro] = qdq[row] - part;
      }
    }
  }
}

enum class Kind { kFwd, kBwdState, kBwdChunk };

int launch(Kind kind, Args a, int B, int dk, int dv, void* stream) {
  if (B <= 0 || a.S <= 0 || a.H <= 0 || dk != D || dv != D || a.Q <= 0 || a.Q > 256 ||
      a.S % a.Q != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  a.n = a.S / a.Q;
  a.QP = (a.Q + SB - 1) / SB * SB;
  void (*fn)(Args);
  size_t smem;
  dim3 grid(B * a.H);
  if (kind == Kind::kFwd) {
    fn = mamba_scan_fwd_kernel;
    smem = fwd_smem(a.QP);
  } else if (kind == Kind::kBwdState) {
    fn = mamba_scan_bwd_state_kernel;
    smem = state_smem(a.QP);
  } else {
    fn = mamba_scan_bwd_chunk_kernel;
    smem = chunk_smem(a.QP);
    grid.y = a.n;
  }
  cudaError_t err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  fn<<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

Args make_args(int S, int H, int Q) {
  Args a{};
  a.S = S;
  a.H = H;
  a.Q = Q;
  return a;
}

}  // namespace

// q, k [B, S, H, 64] bf16, v [B, S, H, 64] bf16, la, li [B, S, H] f32, r [B, S]
// int32 or null, h0 [B, H, 64, 64] f32 -> y [B, S, H, 64] bf16, hout
// [B, H, 64, 64] f32 and, when hin is not null, hin [B * H, S / Q, 64, 64] f32.
// All contiguous, 16-byte aligned; Q <= 256 divides S.
extern "C" int mamba_scan_fwd(const void* q, const void* k, const void* v, const void* la,
                              const void* li, const void* r, const void* h0, void* y,
                              void* hout, void* hin, int B, int S, int H, int dk, int dv, int Q,
                              void* stream) {
  Args a = make_args(S, H, Q);
  a.q = static_cast<const bf16*>(q);
  a.k = static_cast<const bf16*>(k);
  a.v = static_cast<const bf16*>(v);
  a.la = static_cast<const float*>(la);
  a.li = static_cast<const float*>(li);
  a.r = static_cast<const int*>(r);
  a.h0 = static_cast<const float*>(h0);
  a.y = static_cast<bf16*>(y);
  a.hout = static_cast<float*>(hout);
  a.hin = static_cast<float*>(hin);
  return launch(Kind::kFwd, a, B, dk, dv, stream);
}

// q [B, S, H, 64] bf16, la [B, S, H] f32, r or null, dy [B, S, H, 64] bf16,
// dhf [B, H, 64, 64] f32 -> gexit [B * H, S / Q, 64, 64] f32 (each chunk's
// exit adjoint), dh0 [B, H, 64, 64] f32.
extern "C" int mamba_scan_bwd_state(const void* q, const void* la, const void* r,
                                    const void* dy, const void* dhf, void* gexit, void* dh0,
                                    int B, int S, int H, int dk, int dv, int Q, void* stream) {
  Args a = make_args(S, H, Q);
  a.q = static_cast<const bf16*>(q);
  a.la = static_cast<const float*>(la);
  a.r = static_cast<const int*>(r);
  a.dy = static_cast<const bf16*>(dy);
  a.dhf = static_cast<const float*>(dhf);
  a.gexit = static_cast<float*>(gexit);
  a.dh0 = static_cast<float*>(dh0);
  return launch(Kind::kBwdState, a, B, dk, dv, stream);
}

// The forward's inputs, dy, hin and gexit -> dq, dk, dv [B, S, H, 64] bf16 and
// the rows dcum = q . dq - k . dk, dli = k . dk [B, S, H] f32.
extern "C" int mamba_scan_bwd_chunk(const void* q, const void* k, const void* v, const void* la,
                                    const void* li, const void* r, const void* dy,
                                    const void* hin, const void* gexit, void* dq, void* dk,
                                    void* dv, void* dcum, void* dli, int B, int S, int H,
                                    int dkdim, int dvdim, int Q, void* stream) {
  Args a = make_args(S, H, Q);
  a.q = static_cast<const bf16*>(q);
  a.k = static_cast<const bf16*>(k);
  a.v = static_cast<const bf16*>(v);
  a.la = static_cast<const float*>(la);
  a.li = static_cast<const float*>(li);
  a.r = static_cast<const int*>(r);
  a.dy = static_cast<const bf16*>(dy);
  a.hin = const_cast<float*>(static_cast<const float*>(hin));
  a.gexit = const_cast<float*>(static_cast<const float*>(gexit));
  a.dq = static_cast<bf16*>(dq);
  a.dk = static_cast<bf16*>(dk);
  a.dv = static_cast<bf16*>(dv);
  a.dcum = static_cast<float*>(dcum);
  a.dli = static_cast<float*>(dli);
  return launch(Kind::kBwdChunk, a, B, dkdim, dvdim, stream);
}

extern "C" const char* mamba_scan_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
