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
// the reset rows.
//
// What bounds them on the H100: at the training shapes (B = rows of one
// micro-batch, S = 256, H = 80 heads, dk = dv = 64, Q = 256) the forward
// reads q, k, v (bf16), la, li and writes y, the final state and the entry
// states; about 2 Q^2 (dk + dv) / 2 + 2 Q dk dv operations per chunk and
// head, well under 295 per byte: bound by bytes.  The chunk backward does
// about three times the forward's products on four tiles (q, k, v, dy) in
// and three out, and is bound by bytes too; the state backward reads q and
// dy only where a chunk's products feed its outputs (rows before the
// chunk's first reset), and dhf, and writes gexit and dh0: on a packed
// training batch, whose rows open with a reset, the three states alone.
// The forward and the chunk backward stay several times above their bound
// at the training shape: each warp's chain of products, decays and splits
// for a pair of slabs waits on latency, with 8 warps to an SM.
//
// All three kernels run on the tensor cores: every product
// is mma.sync.m16n8k16 on bf16 operands with f32 accumulators, fed by
// ldmatrix (.trans where the operand's rows are the contraction), as in
// packed_attention.cu.  q, k, v and dy are bf16 and exact as operands.  The
// f32 factors -- the decay-masked scores P, the states H, H_in and G_exit,
// and w_j k_j and ec_i q_i of the state updates -- enter as three bf16
// terms whose sum is the f32 value (`split3`), so every product keeps f32 precision: h, hin,
// dli, dcum and dh0 are held to 1e-5 of their largest magnitude.  Per-row
// scales go on the f32 result where the algebra allows (ec_i (q_i H),
// ec_i (dy_i H_in^T), w_t (v_t G_exit^T), w_t (k_t G_exit)): the state term
// is taken first into zeroed accumulators and scaled there.  Each k-step's
// products go into zeroed accumulators and are then added to the sums in
// f32 with round-to-nearest: the tensor cores truncate their own sums, and
// a chain of a few hundred of them would bias the f32 outputs.
//
// Layout.  A block is 4 warps; each warp owns a 16-row slab of the chunk.
// The block walks the chunk's 64-row tiles in rounds: the forward's and
// dq's rounds are query tiles, the last first (most keys), and stream the
// key tiles at or before them; dk/dv's rounds are key tiles, the first
// first, and stream the query tiles at or after them.  A warp's own slab
// goes from device memory straight into A fragments; the streamed operands
// (k and v, or q and dy) come through a ring of three 64-row tiles that
// cp.async fills two tiles ahead of the one in use (`Ring`, after the K/V
// ring of packed_attention.cu), rows padded to 72 values so that the rows
// an ldmatrix reads fall in distinct banks.  The f32 state sits in shared
// memory as its three bf16 terms, read by ldmatrix like the tiles.  98,464
// bytes a block, so two blocks share an SM.  The state backward's k-steps
// are the ring's 16-row slabs, its rows are the contraction, and its warps
// own 16 rows of the [dk, dv] state each.
//
// Tile classes.  The reset counts are sorted within a chunk, so a 64 x 64
// tile whose key rows all lie in earlier segments than its query rows has
// no live pair, and the ring never loads it; inside a tile each warp skips
// a 16 x 16 pair of slabs with no live pair, skips the per-element gate
// where every pair is live (one segment, keys before queries), and applies
// it element by element otherwise.  The state terms are skipped on slabs
// where ec, or w, is 0 on every row, and where the state is 0 everywhere (a
// block-wide OR over it: h0 = 0 in training, and G_exit = 0 there, the final
// state getting no gradient).  On a packed training batch many off-diagonal
// tiles are dead, and the state backward, whose products stop at a chunk's
// first reset row, has no live tile at all.
//
// A chunk's set-up (`chunk_prologue`): the reset counts by a shuffle scan
// over the lanes, then the warps in order; cum in the plain version's
// sequential order, lane after lane of one warp (see there), while the
// other warps build the ring's work list and split the state; exp(cum),
// gain, ec and w once per row.  The decays dec(i, j) are taken once per live
// element (exp2 of the difference times log2 e, one MUFU instruction) and
// serve both products that share them (P1 and P2 of the chunk backward's
// key pass).  dq, dk, dv and y leave through a per-warp
// stage in shared memory as 16-byte rows; dcum and dli come from the f32
// accumulators with the quad shuffles of the fragment layout.  Every sum
// runs in a fixed order (no atomics): two runs give the same bits.
//
// The forward runs one block per (b, h) with a loop over that row's chunks,
// the state carried in f32 registers between chunks (each warp holds 16 of
// its 64 rows) and, during one, as its three bf16 terms in shared memory
// (their sum is exact); the state backward runs the same way from the last
// chunk, G in f32 registers throughout, the next chunk's tiles in flight
// while a chunk's update and set-up run, gexit and dh0 leaving as 16-byte
// rows through a per-warp f32 stage; the chunk backward runs one block per
// (chunk, b, h) and carries nothing.  All three share one shared-memory
// layout.
//
// The tiled forward (`mamba_scan_fwd_tiled_kernel`) takes a state of any
// [dk, dv] in 64 x 64 tiles (xlstm's mLSTM: dk = 1024, dv = 1025 padded to
// 1088 by the caller, 4.2 MB a (row, head), far past an SM's shared memory).
// The scan is bilinear in (q, k) over dk and acts on v column by column, so
// tile (kd, vd)'s share of it is the (64, 64) scan of q and k's columns
// kd * 64 .. + 63 and v's columns vd * 64 .. + 63 from that tile of h0: it
// carries that tile, and its share of y's columns vd is an f32 partial.  One
// block per (tile, b, h) runs the forward's body unchanged but for the
// strides (`fwd_body<true>`); the partials go to plane kd of a scratch
// [dk / 64][B, S, H, dv], and `mamba_scan_tile_sum_kernel` sums the planes
// in order kd = 0, 1, ... and rounds once to bf16 (no atomics: the same bits
// each run).  Every tile recomputes its chunk's decays and the q . k scores
// of its 64 columns, so the work is dv / 64 times the scores and dk / 64
// times the P v products of one pass over the whole state.
//
// The tiled backward takes the same tiles.  The state backward's update
// G <- cdec G + sum_i ec_i q_i (x) dy_i is an outer product of q's dk columns
// and dy's dv columns, so tile (kd, vd) of G is the (64, 64) state backward
// of q's columns kd and dy's columns vd from that tile of dhf, exactly, with
// no sum across blocks (`bwd_state_body<true>`; dy is padded to dv like v).
// The chunk backward is bilinear like the forward: p = dy . v sums over dv
// and s = q . k over dk, so tile (kd, vd) of a chunk gives the share of dv
// tile vd in dq and dk (their columns kd) and the share of dk tile kd in dv
// (its columns vd), from its tiles of H_in and G_exit.  One block per (tile,
// b, h, chunk) runs the chunk backward's body on its strides
// (`bwd_chunk_body<true>`) and writes those shares in f32: dq and dk to
// plane vd of [dv / 64][B, S, H, dk] scratches, dv to plane kd of a
// [dk / 64][B, S, H, dv] one.  `mamba_scan_bwd_tile_sum_kernel` then sums
// each row's planes in order (vd = 0, 1, ... for dq and dk, kd = 0, 1, ...
// for dv), rounds once to bf16 and forms dcum = q . dq - k . dk and dli =
// k . dk from the f32 sums over the whole dk (no atomics: the same bits
// each run).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int D = 64;  // dk = dv

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
  float* ypart;        // tiled forward: partial y [dk / 64][B, S, H, dv] f32
  float* dqpart;       // tiled chunk bwd: partial dq [dv / 64][B, S, H, dk] f32
  float* dkpart;       // tiled chunk bwd: partial dk [dv / 64][B, S, H, dk] f32
  float* dvpart;       // tiled chunk bwd: partial dv [dk / 64][B, S, H, dv] f32
  int S, H, Q, n;
  int kdim, vdim;      // tiled kernels: the state's dk, dv (multiples of 64); else 64
  int want_dh0;        // state bwd: dh0 is wanted (else the first chunk's products are skipped)
};

__device__ __forceinline__ size_t row_off(const Args& a, int b, int t, int h) {
  return (static_cast<size_t>(b) * a.S + t) * a.H + h;
}

// ---- tensor-core building blocks (as in packed_attention.cu) -----------------

constexpr int MMA_THREADS = 128;  // 4 warps, one 16-row slab each
constexpr int TR = 64;            // rows per tile of a round / of the ring
constexpr int DP = D + 8;         // bf16 row stride of the tiles in shared memory
constexpr int STAGES = 3;         // ring tiles: two in flight while one is used
constexpr int QMAX = 256;         // the largest chunk
constexpr int MAX_ITEMS = 32;     // ring items of a chunk: at most 2 x (4 + 3 + 2 + 1)

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

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// a bf16 pair (the lower half first) widened to f32: bf16 is f32's upper half
__device__ __forceinline__ float2 bf16x2_to_float2(uint32_t v) {
  return make_float2(__uint_as_float(v << 16), __uint_as_float(v & 0xffff0000u));
}

// x0, x1 as three bf16 pairs, hi + mid + lo, whose sum is x0, x1 to f32
// precision (each term takes the next 8 significant bits)
__device__ __forceinline__ void split3(float x0, float x1, uint32_t& hi, uint32_t& mid,
                                       uint32_t& lo) {
  __nv_bfloat162 t = __floats2bfloat162_rn(x0, x1);
  hi = *reinterpret_cast<const uint32_t*>(&t);
  float2 back = __bfloat1622float2(t);
  x0 -= back.x;
  x1 -= back.y;
  t = __floats2bfloat162_rn(x0, x1);
  mid = *reinterpret_cast<const uint32_t*>(&t);
  back = __bfloat1622float2(t);
  lo = pack_bf16(x0 - back.x, x1 - back.y);
}

// The A operands (16 rows x 16 of the contraction) of a product whose left
// factor is held as two m16n8 accumulator tiles c0 (columns 0-7) and c1
// (8-15): the accumulator pairs have the A fragment's layout.  The f32
// factor becomes three bf16 operands a[0] + a[1] + a[2].
__device__ __forceinline__ void acc_to_a(uint32_t (&a)[3][4], const float (&c0)[4],
                                         const float (&c1)[4]) {
  split3(c0[0], c0[1], a[0][0], a[1][0], a[2][0]);
  split3(c0[2], c0[3], a[0][1], a[1][1], a[2][1]);
  split3(c1[0], c1[1], a[0][2], a[1][2], a[2][2]);
  split3(c1[2], c1[3], a[0][3], a[1][3], a[2][3]);
}

constexpr float LOG2E = 1.4426950408889634f;

// 2^x in one MUFU instruction (about 2 ulp; results below 2^-126 flush to
// 0): the decays exp(cum_i - cum_j) as exp2((cum_i - cum_j) log2 e), the
// difference taken first, as the plain version takes it
__device__ __forceinline__ float exp2_fast(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

template <int N>
__device__ __forceinline__ void zero(float (&acc)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;
}

__device__ __forceinline__ void add4(float (&acc)[4], const float (&t)[4]) {
#pragma unroll
  for (int e = 0; e < 4; ++e) acc[e] += t[e];
}

// A warp's 16 rows x 64 of a chunk's [rows, stride] bf16 matrix (row r at
// src + r * stride) straight from device memory as m16k16 A fragments, one
// per k-step of 16 columns; rows at or past Q give zeros.  a0: (g, 2t4),
// a1: (g + 8, 2t4), a2, a3: the same 8 columns on.
__device__ __forceinline__ void load_a_rows(uint32_t (&f)[4][4], const bf16* src, size_t stride,
                                            int r0, int Q) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int row = r0 + g + 8 * (j & 1);
      f[kk][j] = row < Q ? *reinterpret_cast<const uint32_t*>(
                               src + row * stride + kk * 16 + (j >> 1) * 8 + 2 * t4)
                         : 0u;
    }
}

// f = g: a slab's A fragments, taken over from the ones loaded a round ahead
__device__ __forceinline__ void take(uint32_t (&f)[4][4], const uint32_t (&g)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int j = 0; j < 4; ++j) f[kk][j] = g[kk][j];
}

// acc (16 rows x 64, f32) += a (16 rows x 64 of bf16 A fragments) times M,
// where M [64][64] is the f32 state held in shared memory as three bf16
// terms (`split`, three [D][DP] tiles) and enters the product transposed
// (TRANS = false: acc = a M^T, M's rows are the output columns) or as it
// is (TRANS = true: acc = a M, M's rows are the contraction).  Each
// k-step's three products go into zeroed accumulators first.
template <bool TRANS>
__device__ __forceinline__ void state_product(float (&acc)[8][4], const uint32_t (&a)[4][4],
                                              const bf16* split) {
  const int lane = threadIdx.x & 31;
#pragma unroll 1
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int np = 0; np < 4; ++np) {
      float t0[4] = {0.f, 0.f, 0.f, 0.f}, t1[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int term = 2; term >= 0; --term) {  // the smallest first
        const bf16* m = split + term * D * DP;
        uint32_t b[4];
        if (TRANS)
          ldmatrix_x4_trans(b, m + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * DP +
                                   np * 16 + (lane >> 4) * 8);
        else
          ldmatrix_x4(b, m + (np * 16 + (lane & 7) + ((lane >> 4) << 3)) * DP + kk * 16 +
                             ((lane >> 3) & 1) * 8);
        mma_bf16(t0, a[kk], b[0], b[1]);
        mma_bf16(t1, a[kk], b[2], b[3]);
      }
      add4(acc[2 * np], t0);
      add4(acc[2 * np + 1], t1);
    }
}

// s (16 rows x 16, f32) = a (16 x 64 A fragments) times the 16 rows at t of
// a [*][DP] tile, transposed (the tile's rows are the output columns)
__device__ __forceinline__ void slab_scores(float (&s)[2][4], const uint32_t (&a)[4][4],
                                            const bf16* t) {
  const int lane = threadIdx.x & 31;
  zero(s);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    uint32_t b[4];
    ldmatrix_x4(b, t + ((lane & 7) + ((lane >> 4) << 3)) * DP + kk * 16 + ((lane >> 3) & 1) * 8);
    float t0[4] = {0.f, 0.f, 0.f, 0.f}, t1[4] = {0.f, 0.f, 0.f, 0.f};
    mma_bf16(t0, a[kk], b[0], b[1]);
    mma_bf16(t1, a[kk], b[2], b[3]);
    add4(s[0], t0);
    add4(s[1], t1);
  }
}

// acc (16 rows x 64) += p (16 x 16, three bf16 terms) times the 16 rows at t
// of a [*][DP] tile (the tile's rows are the contraction)
__device__ __forceinline__ void slab_apply(float (&acc)[8][4], const uint32_t (&p)[3][4],
                                           const bf16* t) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int dp = 0; dp < 4; ++dp) {
    uint32_t b[4];
    ldmatrix_x4_trans(b, t + ((lane & 7) + ((lane >> 3) & 1) * 8) * DP + dp * 16 + (lane >> 4) * 8);
    float t0[4] = {0.f, 0.f, 0.f, 0.f}, t1[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int term = 2; term >= 0; --term) {
      mma_bf16(t0, p[term], b[0], b[1]);
      mma_bf16(t1, p[term], b[2], b[3]);
    }
    add4(acc[2 * dp], t0);
    add4(acc[2 * dp + 1], t1);
  }
}

// Writes a warp's 16 rows x 64 f32 accumulators as bf16 through its own
// [16][DP] stage, then to rows r0 .. r0 + 15 of dst (row r at dst + r *
// stride), 16-byte stores, rows at or past Q dropped.
__device__ __forceinline__ void store_rows(const float (&acc)[8][4], bf16* stage, bf16* dst,
                                           size_t stride, int r0, int Q) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t4 = lane & 3;
  __syncwarp();  // the stage's previous rows have left
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    const int c = nt * 8 + 2 * t4;
    *reinterpret_cast<__nv_bfloat162*>(stage + g * DP + c) =
        __floats2bfloat162_rn(acc[nt][0], acc[nt][1]);
    *reinterpret_cast<__nv_bfloat162*>(stage + (g + 8) * DP + c) =
        __floats2bfloat162_rn(acc[nt][2], acc[nt][3]);
  }
  __syncwarp();
#pragma unroll
  for (int i = lane; i < 16 * 8; i += 32) {
    const int r = i >> 3, c = i & 7;
    if (r0 + r < Q)
      *reinterpret_cast<uint4*>(dst + (r0 + r) * stride + c * 8) =
          *reinterpret_cast<const uint4*>(stage + r * DP + c * 8);
  }
}

// The dot of a warp's 16 rows x 64 of A fragments (bf16) with its f32
// accumulators of the same rows, per row, summed over the row's quad in a
// fixed order: out[0] for row g, out[1] for row g + 8.
__device__ __forceinline__ void row_dots(const uint32_t (&a)[4][4], const float (&acc)[8][4],
                                         float (&out)[2]) {
  out[0] = out[1] = 0.f;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int j = 0; j < 4; ++j) {  // a[kk][j]: row g + 8 (j & 1), n-tile 2 kk + (j >> 1)
      const float2 x = bf16x2_to_float2(a[kk][j]);
      const float* c = acc[2 * kk + (j >> 1)] + 2 * (j & 1);
      out[j & 1] += x.x * c[0] + x.y * c[1];
    }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    out[i] += __shfl_xor_sync(0xffffffffu, out[i], 1);
    out[i] += __shfl_xor_sync(0xffffffffu, out[i], 2);
  }
}

// ---- the chunk's vectors, the work list, the ring ------------------------------

// A block's shared memory (the same layout for the forward and the chunk
// backward; the forward leaves qdq unused)
struct Smem {
  bf16* ring;   // [STAGES][2][TR][DP]: two streamed tiles per stage
  bf16* split;  // [3][D][DP]: the f32 state as three bf16 terms
  bf16* stage;  // [4][16][DP]: each warp's output rows
  float* cum;   // [QMAX] per row of the chunk
  float* gain;
  float* ec;
  float* w;
  float* qdq;   // q . dq (chunk backward)
  int* seg;
  int* wseg;    // [4] the scan's warp totals
  int* items;   // [MAX_ITEMS + 1]: the ring's tiles, then their count
};

constexpr size_t kRingBytes = sizeof(bf16) * STAGES * 2 * TR * DP;
constexpr size_t kSplitBytes = sizeof(bf16) * 3 * D * DP;
constexpr size_t kStageBytes = sizeof(bf16) * 4 * 16 * DP;
constexpr size_t kMmaSmem = kRingBytes + kSplitBytes + kStageBytes + 6 * QMAX * sizeof(float) +
                            4 * sizeof(int) + (MAX_ITEMS + 4) * sizeof(int);

// (the state backward's f32 output stages, [4][16][D + 8], in the split's room)
static_assert(4 * 16 * (D + 8) * sizeof(float) <= kSplitBytes, "state stage");

__device__ Smem carve(unsigned char* base) {
  Smem s;
  s.ring = reinterpret_cast<bf16*>(base);
  s.split = s.ring + STAGES * 2 * TR * DP;
  s.stage = s.split + 3 * D * DP;
  s.cum = reinterpret_cast<float*>(s.stage + 4 * 16 * DP);
  s.gain = s.cum + QMAX;
  s.ec = s.gain + QMAX;
  s.w = s.ec + QMAX;
  s.qdq = s.w + QMAX;
  s.seg = reinterpret_cast<int*>(s.qdq + QMAX);
  s.wseg = s.seg + QMAX;
  s.items = s.wseg + 4;
  return s;
}

// a key tile kt at or before query tile qt holds a live pair: the diagonal
// always; below it, where the key tile's last row shares the query tile's
// first row's segment (the counts are sorted, so no later key row is in an
// earlier segment than an earlier query row)
__device__ __forceinline__ bool tile_live(const int* seg, int qt, int kt) {
  return kt == qt || seg[kt * TR + TR - 1] == seg[qt * TR];
}

// The ring's work list, by one thread: the forward's and dq's rounds (query
// tiles, the last first) with their live key tiles; with `dkv`, then dk/dv's
// rounds (key tiles, the first first) with their live query tiles.  An item
// is tile | round << 3 | pass << 6.
__device__ void fill_items(const Smem& s, int nt, bool dkv) {
  int n = 0;
  for (int qt = nt - 1; qt >= 0; --qt)
    for (int kt = 0; kt <= qt; ++kt)
      if (tile_live(s.seg, qt, kt)) s.items[n++] = kt | qt << 3;
  if (dkv)
    for (int kt = 0; kt < nt; ++kt)
      for (int qt = kt; qt < nt; ++qt)
        if (tile_live(s.seg, qt, kt)) s.items[n++] = qt | kt << 3 | 1 << 6;
  s.items[MAX_ITEMS] = n;
}

// Three bf16 terms of two f32 values of the state into the split tiles, at
// the element pair i of the row-major [D][D] state
__device__ __forceinline__ void split_pair(bf16* split, int i, float2 x) {
  const int row = (2 * i) / D, col = (2 * i) % D;
  uint32_t t[3];
  split3(x.x, x.y, t[0], t[1], t[2]);
#pragma unroll
  for (int term = 0; term < 3; ++term)
    *reinterpret_cast<uint32_t*>(split + (term * D + row) * DP + col) = t[term];
}

// cum over a chunk's QMAX rows (la of rows at or past Q read as 0), by one
// warp in the plain version's order: a sequential f32 sum from the first
// row, each lane adding its eight rows in turn and handing the sum on
// (exp(cum_i - cum_j) and exp(cum_last - cum_j) magnify a change of cum by
// |cum|, up to a few hundred at the end of a chunk, so a sum in another
// order moves h by about F32_TOL)
__device__ void warp_cumsum(const Args& a, int b, int t0, int h, float* cum) {
  const int lane = threadIdx.x & 31;
  float v[QMAX / 32];
#pragma unroll
  for (int i = 0; i < QMAX / 32; ++i) {
    const int row = QMAX / 32 * lane + i;
    v[i] = row < a.Q ? a.la[row_off(a, b, t0 + row, h)] : 0.f;
  }
  float c = 0.f;
#pragma unroll 1
  for (int src = 0; src < 32; ++src) {
    if (lane == src) {
#pragma unroll
      for (int i = 0; i < QMAX / 32; ++i) {
        c += v[i];
        v[i] = c;
      }
    }
    c = __shfl_sync(0xffffffffu, c, src);
  }
#pragma unroll
  for (int i = 0; i < QMAX / 32; ++i) cum[QMAX / 32 * lane + i] = v[i];
}

// A chunk's set-up, ending with a barrier: the vectors over its QMAX rows
// (two per thread), the ring's work list and, when `state` is not null, the
// f32 state [D][D] there (STRIDED: rows `srow` apart, a tile of a larger
// state) as three bf16 terms; returns whether any value of
// that state is not 0 (a state of zeros adds nothing, and its products are
// skipped).  The reset counts' inclusive
// sums seg come from a shuffle scan (the lanes' runs, then the warps in
// order); cum is taken in the plain version's order by warp 0
// (`warp_cumsum`).  Meanwhile the other warps build the work list and
// split the state.  Then gain, ec and w once
// per row.  Rows at or past Q read la = 0 and no reset, so they carry
// cum_last and seg_last; their gain, ec and w are 0.
template <bool STRIDED = false>
__device__ bool chunk_prologue(const Args& a, int b, int t0, int h, const Smem& s, int nt,
                               bool dkv, const float* state, size_t srow = D) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, Q = a.Q;
  float li[2] = {0.f, 0.f};
  int rc[2] = {0, 0};
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = 2 * tid + i;
    if (row < Q) {
      li[i] = a.li[row_off(a, b, t0 + row, h)];
      if (a.r != nullptr) rc[i] = a.r[static_cast<size_t>(b) * a.S + t0 + row];
    }
  }
  int y = rc[0] + rc[1];
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int yo = __shfl_up_sync(0xffffffffu, y, off);
    if (lane >= off) y += yo;
  }
  int seg = __shfl_up_sync(0xffffffffu, y, 1);  // the lanes before this one
  if (lane == 0) seg = 0;
  if (lane == 31) s.wseg[warp] = y;
  __syncthreads();
  for (int k = 0; k < warp; ++k) seg += s.wseg[k];
  s.seg[2 * tid] = seg + rc[0];
  s.seg[2 * tid + 1] = seg + rc[0] + rc[1];
  __syncthreads();
  if (warp == 0) warp_cumsum(a, b, t0, h, s.cum);
  bool nonzero = false;
  if (warp != 0) {
    if (tid == 32) fill_items(s, nt, dkv);
    if (state != nullptr)
      for (int i = tid - 32; i < D * D / 2; i += MMA_THREADS - 32) {
        const float2 x = STRIDED
                             ? *reinterpret_cast<const float2*>(state + (2 * i / D) * srow + 2 * i % D)
                             : reinterpret_cast<const float2*>(state)[i];
        nonzero |= x.x != 0.f || x.y != 0.f;
        split_pair(s.split, i, x);
      }
  }
  nonzero = __syncthreads_or(nonzero);
  const float total = s.cum[Q - 1];
  const int last = s.seg[Q - 1];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = 2 * tid + i;
    const float gain = row < Q ? expf(li[i]) : 0.f;
    const float cum = s.cum[row];
    const int sg = s.seg[row];
    s.gain[row] = gain;
    s.ec[row] = row < Q && sg == 0 ? expf(cum) : 0.f;
    s.w[row] = row < Q && sg == last ? expf(total - cum) * gain : 0.f;
  }
  __syncthreads();
  return nonzero;
}

// The ring over a chunk's rows: item it loads tile (items[it] & 7) of two
// tensors, (x0, x1) for pass 0 and (y0, y1) for pass 1, into stage it % STAGES.
// With TWO_STRIDES the second tensor of a pass has rows `stride1` apart (the
// tiled forward's v, whose rows are dv wide where k's are dk wide).
template <bool TWO_STRIDES>
struct RingT {
  const Smem& s;
  const bf16* x0;
  const bf16* x1;
  const bf16* y0;
  const bf16* y1;
  size_t stride;
  int Q, n;
  size_t stride1;

  __device__ const bf16* tile(int it, int which) const {
    return s.ring + ((it % STAGES) * 2 + which) * TR * DP;
  }

  __device__ void load(int it) const {
    const int item = s.items[it], r0 = (item & 7) * TR;
    const bool second = item >> 6;
    bf16* dst = s.ring + (it % STAGES) * 2 * TR * DP;
    for (int i = threadIdx.x; i < 2 * TR * 8; i += MMA_THREADS) {
      const int which = i / (TR * 8), r = (i >> 3) % TR, c = i & 7, row = r0 + r;
      const bf16* src = which ? (second ? y1 : x1) : (second ? y0 : x0);
      const bool ok = row < Q;
      const size_t st = TWO_STRIDES && which ? stride1 : stride;
      cp_async16(dst + (which * TR + r) * DP + c * 8, ok ? src + row * st + c * 8 : src, ok);
    }
  }

  // the first STAGES - 1 items (a group each, empty past the last)
  __device__ void start() const {
#pragma unroll
    for (int it = 0; it < STAGES - 1; ++it) {
      if (it < n) load(it);
      cp_async_commit();
    }
  }

  // waits for item it and refills the stage of item it - 1 with item
  // it + STAGES - 1: every part of item it has landed, and every warp is
  // done with item it - 1, past the barrier
  __device__ void advance(int it) const {
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    if (it + STAGES - 1 < n) load(it + STAGES - 1);
    cp_async_commit();
  }
};

typedef RingT<false> Ring;

// What the decays are on a pair of 16-row slabs, query rows from i0 and key
// rows from j0 <= i0: 0 no live pair, 2 every pair live (one segment, every
// key before every query), 1 test each element
__device__ __forceinline__ int slab_kind(const int* seg, int i0, int j0) {
  if (seg[j0 + 15] < seg[i0]) return 0;
  if (j0 < i0 && seg[j0] == seg[i0 + 15]) return 2;
  return 1;
}

// ---- forward ---------------------------------------------------------------

// f32 accumulators of a warp's 16 rows x 64 straight to rows r0 .. r0 + 15
// of dst (row r at dst + r * stride), 8-byte stores, rows at or past Q
// dropped (the tiled forward's partial y)
__device__ __forceinline__ void store_rows_f32(const float (&acc)[8][4], float* dst,
                                               size_t stride, int r0, int Q) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = r0 + g + 8 * i;
    if (row >= Q) continue;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
      *reinterpret_cast<float2*>(dst + row * stride + nt * 8 + 2 * t4) =
          make_float2(acc[nt][2 * i], acc[nt][2 * i + 1]);
  }
}

// The forward of one (b, h) over its chunks.  TILED: the block computes one
// 64 x 64 tile (kd, vd) of a [dk, dv] state (blockIdx.x = kd * dv / 64 + vd,
// blockIdx.y = b * H + h): the scan over q, k's columns kd * 64 .. + 63 and
// v's columns vd * 64 .. + 63 from that tile of h0, which is the exact
// share of that tile in the whole scan (the scan is bilinear in (q, k) over
// dk and acts on v column by column); its y, the share of those dk columns
// in y's columns vd, goes out in f32 to plane kd of `ypart`, which
// `mamba_scan_tile_sum_kernel` sums over kd.  Otherwise dk = dv = 64 and y
// leaves as bf16.
template <bool TILED>
__device__ __forceinline__ void fwd_body(const Args& a, unsigned char* smem_raw) {
  const Smem s = carve(smem_raw);
  int bh = blockIdx.x, kd = 0, vd = 0;
  if (TILED) {
    bh = blockIdx.y;
    kd = blockIdx.x / (a.vdim / D);
    vd = blockIdx.x % (a.vdim / D);
  }
  const int b = bh / a.H, h = bh % a.H;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t4 = lane & 3;
  const int Q = a.Q, nt = (Q + TR - 1) / TR;
  const size_t stride = static_cast<size_t>(a.H) * (TILED ? a.kdim : D);  // q, k rows
  const size_t vstride = TILED ? static_cast<size_t>(a.H) * a.vdim : stride;  // v, y rows
  const size_t srow = TILED ? a.vdim : D;  // a state's rows
  const size_t sstate = TILED ? static_cast<size_t>(a.kdim) * a.vdim : D * D;  // one (b, h) state
  const size_t soff = TILED ? static_cast<size_t>(kd) * D * a.vdim + vd * D : 0;  // the tile's
  const int d0 = warp * 16;  // this warp's rows of the state

  // H [d0 + g (+ 8)][nt * 8 + 2 t4 (+ 1)], this warp's rows of the carried
  // state: in f32 registers between chunks; during a chunk's rounds only as
  // its three bf16 terms in shared memory, whose sum is H exactly
  float hs[8][4];
  {
    const float* src = a.h0 + static_cast<size_t>(bh) * sstate + soff;
#pragma unroll
    for (int nt8 = 0; nt8 < 8; ++nt8)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const float2 x =
            *reinterpret_cast<const float2*>(src + (d0 + g + 8 * i) * srow + nt8 * 8 + 2 * t4);
        hs[nt8][2 * i] = x.x;
        hs[nt8][2 * i + 1] = x.y;
      }
  }

  for (int c = 0; c < a.n; ++c) {
    const int t0 = c * Q;
    const size_t base = row_off(a, b, t0, h) * (TILED ? a.kdim : D) + (TILED ? kd * D : 0);
    const size_t vbase = TILED ? row_off(a, b, t0, h) * a.vdim + vd * D : base;
    __syncthreads();  // the previous chunk's vectors, split and stage are no longer read
    // each round's q fragments are loaded a round ahead, the first round's
    // while the set-up runs
    uint32_t qn[4][4];
    load_a_rows(qn, a.q + base, stride, (nt - 1) * TR + warp * 16, Q);
    chunk_prologue(a, b, t0, h, s, nt, false, nullptr);
    // this chunk's entry state: the backward's residual, and its three terms
    float* hin =
        a.hin != nullptr ? a.hin + (static_cast<size_t>(bh) * a.n + c) * sstate + soff : nullptr;
    bool nonzero = false;
#pragma unroll
    for (int nt8 = 0; nt8 < 8; ++nt8)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int row = d0 + g + 8 * i, col = nt8 * 8 + 2 * t4;
        if (hin != nullptr)
          *reinterpret_cast<float2*>(hin + row * srow + col) =
              make_float2(hs[nt8][2 * i], hs[nt8][2 * i + 1]);
        nonzero |= hs[nt8][2 * i] != 0.f || hs[nt8][2 * i + 1] != 0.f;
        uint32_t t[3];
        split3(hs[nt8][2 * i], hs[nt8][2 * i + 1], t[0], t[1], t[2]);
#pragma unroll
        for (int term = 0; term < 3; ++term)
          *reinterpret_cast<uint32_t*>(s.split + (term * D + row) * DP + col) = t[term];
      }
    // (the split is written) a state of zeros adds nothing to y
    const bool h_live = __syncthreads_or(nonzero);
    const RingT<TILED> ring{s,       a.k + base, a.v + vbase,         nullptr,
                            nullptr, stride,     Q,           s.items[MAX_ITEMS], vstride};
    ring.start();
    const int last = s.seg[Q - 1];
    float upd[8][4];  // sum_j w_j k_j (x) v_j over the chunk, this warp's rows d
    zero(upd);

    int it = 0;
    for (int qt = nt - 1; qt >= 0; --qt) {
      const int i0 = qt * TR + warp * 16;
      uint32_t qf[4][4];
      take(qf, qn);
      if (qt > 0) load_a_rows(qn, a.q + base, stride, i0 - TR, Q);
      float cum_r[2];
      int seg_r[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        cum_r[i] = s.cum[i0 + g + 8 * i];
        seg_r[i] = s.seg[i0 + g + 8 * i];
      }
      float y[8][4];
      zero(y);
      if (h_live && s.seg[i0] == 0) {  // some row of the slab reads the entry state: ec_i (q_i H)
        state_product<true>(y, qf, s.split);
        const float e0 = s.ec[i0 + g], e1 = s.ec[i0 + g + 8];
#pragma unroll
        for (int nt8 = 0; nt8 < 8; ++nt8) {
          y[nt8][0] *= e0;
          y[nt8][1] *= e0;
          y[nt8][2] *= e1;
          y[nt8][3] *= e1;
        }
      }
      for (; it < ring.n && ((s.items[it] >> 3) & 7) == qt; ++it) {
        ring.advance(it);
        const int kt = s.items[it] & 7;
        const bf16* kt_s = ring.tile(it, 0);
        const bf16* vt_s = ring.tile(it, 1);
#pragma unroll 1
        for (int sb = 0; sb < 4; ++sb) {
          const int j0 = kt * TR + sb * 16;
          if (j0 > i0) break;
          const int kind = slab_kind(s.seg, i0, j0);
          if (kind == 0) continue;
          float sc[2][4];
          slab_scores(sc, qf, kt_s + sb * 16 * DP);  // q_i . k_j
#pragma unroll
          for (int n2 = 0; n2 < 2; ++n2)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int ri = e >> 1, j = j0 + n2 * 8 + 2 * t4 + (e & 1);
              const bool live = kind == 2 || (j <= i0 + g + 8 * ri && s.seg[j] == seg_r[ri]);
              sc[n2][e] = live ? sc[n2][e] * (exp2_fast((cum_r[ri] - s.cum[j]) * LOG2E) * s.gain[j]) : 0.f;
            }
          uint32_t pa[3][4];
          acc_to_a(pa, sc[0], sc[1]);
          slab_apply(y, pa, vt_s + sb * 16 * DP);  // P v_j
        }
        if (qt == nt - 1) {
          // the state update's share of this key tile (every tile with a
          // row of the last segment is live in the first round):
          // upd[d][e] += sum_j (w_j k_j[d]) v_j[e], w_j k_j as three terms
#pragma unroll 1
          for (int sb = 0; sb < 4; ++sb) {
            const int j0 = kt * TR + sb * 16;
            if (s.seg[j0 + 15] != last) continue;  // w is 0 on every row
            uint32_t kr[4];
            ldmatrix_x4_trans(kr, kt_s + (sb * 16 + (lane & 7) + ((lane >> 4) & 1) * 8) * DP +
                                      d0 + ((lane >> 3) & 1) * 8);
            const float wa = s.w[j0 + 2 * t4], wb = s.w[j0 + 2 * t4 + 1];
            const float wc = s.w[j0 + 8 + 2 * t4], wd = s.w[j0 + 9 + 2 * t4];
            uint32_t ka[3][4];
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              const float2 x = bf16x2_to_float2(kr[j]);
              const bool hi8 = j >> 1;  // k index 8 + 2 t4 (a2, a3)
              split3(x.x * (hi8 ? wc : wa), x.y * (hi8 ? wd : wb), ka[0][j], ka[1][j], ka[2][j]);
            }
            slab_apply(upd, ka, vt_s + sb * 16 * DP);
          }
        }
      }
      if (TILED)  // plane kd of the partial y, [dk / 64][B * H * S * dv]
        store_rows_f32(y, a.ypart + kd * (static_cast<size_t>(gridDim.y) * a.S * a.vdim) + vbase,
                       vstride, i0, Q);
      else
        store_rows(y, s.stage + warp * 16 * DP, a.y + base, stride, i0, Q);
    }
    cp_async_wait<0>();  // (only empty groups are left)
    const float cdec = last == 0 ? expf(s.cum[Q - 1]) : 0.f;
#pragma unroll
    for (int nt8 = 0; nt8 < 8; ++nt8)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const bf16* m = s.split + (d0 + g + 8 * i) * DP + nt8 * 8 + 2 * t4;
        float2 x[3];
#pragma unroll
        for (int term = 0; term < 3; ++term)
          x[term] = bf16x2_to_float2(*reinterpret_cast<const uint32_t*>(m + term * D * DP));
        hs[nt8][2 * i] = cdec * ((x[0].x + x[1].x) + x[2].x) + upd[nt8][2 * i];
        hs[nt8][2 * i + 1] = cdec * ((x[0].y + x[1].y) + x[2].y) + upd[nt8][2 * i + 1];
      }
  }
  float* hout = a.hout + static_cast<size_t>(bh) * sstate + soff;
#pragma unroll
  for (int nt8 = 0; nt8 < 8; ++nt8)
#pragma unroll
    for (int i = 0; i < 2; ++i)
      *reinterpret_cast<float2*>(hout + (d0 + g + 8 * i) * srow + nt8 * 8 + 2 * t4) =
          make_float2(hs[nt8][2 * i], hs[nt8][2 * i + 1]);
}

__global__ void __launch_bounds__(MMA_THREADS, 2) mamba_scan_fwd_kernel(Args a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  fwd_body<false>(a, smem_raw);
}

__global__ void __launch_bounds__(MMA_THREADS, 2) mamba_scan_fwd_tiled_kernel(Args a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  fwd_body<true>(a, smem_raw);
}

// y = the sum of the tiled forward's dk / 64 partial planes, kd = 0, 1, ...
// in turn (a fixed order: two runs give the same bits), rounded once to
// bf16; four values a thread (`plane`, the values of one plane, is a
// multiple of 64)
__global__ void mamba_scan_tile_sum_kernel(const float* __restrict__ part, bf16* __restrict__ y,
                                           size_t plane, int nk) {
  const size_t i = (static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x) * 4;
  if (i >= plane) return;
  float4 acc = *reinterpret_cast<const float4*>(part + i);
  for (int kd = 1; kd < nk; ++kd) {
    const float4 x = *reinterpret_cast<const float4*>(part + kd * plane + i);
    acc.x += x.x;
    acc.y += x.y;
    acc.z += x.z;
    acc.w += x.w;
  }
  *reinterpret_cast<uint2*>(y + i) = make_uint2(pack_bf16(acc.x, acc.y), pack_bf16(acc.z, acc.w));
}


// ---- chunk backward ----------------------------------------------------------

// The chunk backward of one (b, h) and chunk.  TILED: the block computes
// tile (kd, vd) of a [dk, dv] state (blockIdx.x = kd * dv / 64 + vd,
// blockIdx.y = b * H + h, blockIdx.z = the chunk): the (64, 64) body on q
// and k's columns kd * 64 .. + 63, v and dy's columns vd * 64 .. + 63 and
// those tiles of H_in and G_exit.  Its dq and dk (columns kd) are the share
// of dv tile vd, its dv (columns vd) the share of dk tile kd; they leave in
// f32 to plane vd of `dqpart` / `dkpart` and plane kd of `dvpart`, and
// `mamba_scan_bwd_tile_sum_kernel` sums the planes and forms dcum and dli.
// Otherwise dk = dv = 64: dq, dk and dv leave as bf16, dcum and dli are
// formed here.
template <bool TILED>
__device__ __forceinline__ void bwd_chunk_body(const Args& a, unsigned char* smem_raw) {
  const Smem s = carve(smem_raw);
  int bh = blockIdx.x, c = blockIdx.y, kd = 0, vd = 0;
  if (TILED) {
    bh = blockIdx.y;
    c = blockIdx.z;
    kd = blockIdx.x / (a.vdim / D);
    vd = blockIdx.x % (a.vdim / D);
  }
  const int b = bh / a.H, h = bh % a.H;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t4 = lane & 3;
  const int Q = a.Q, nt = (Q + TR - 1) / TR, t0 = c * Q;
  const size_t stride = static_cast<size_t>(a.H) * (TILED ? a.kdim : D);  // q, k rows
  const size_t vstride = TILED ? static_cast<size_t>(a.H) * a.vdim : stride;  // v, dy rows
  const size_t base = row_off(a, b, t0, h) * (TILED ? a.kdim : D) + (TILED ? kd * D : 0);
  const size_t vbase = TILED ? row_off(a, b, t0, h) * a.vdim + vd * D : base;
  const size_t srow = TILED ? a.vdim : D;  // a state's rows
  const size_t soff =
      (static_cast<size_t>(bh) * a.n + c) * (TILED ? static_cast<size_t>(a.kdim) * a.vdim : D * D) +
      (TILED ? static_cast<size_t>(kd) * D * a.vdim + vd * D : 0);  // the tile of H_in / G_exit
  // one [B, S, H, dk] (or dv) plane of the tiled partials
  const size_t plane = static_cast<size_t>(gridDim.y) * a.S;

  // each dq round's dy (and, untiled, q) fragments are loaded a round
  // ahead, the first round's while the set-up runs
  uint32_t dyn[4][4], qn[4][4];
  load_a_rows(dyn, a.dy + vbase, vstride, (nt - 1) * TR + warp * 16, Q);
  if (!TILED) load_a_rows(qn, a.q + base, stride, (nt - 1) * TR + warp * 16, Q);
  const bool hin_live = chunk_prologue<TILED>(a, b, t0, h, s, nt, true, a.hin + soff, srow);
  const RingT<TILED> ring{s, a.k + base, a.v + vbase, a.q + base, a.dy + vbase, stride, Q,
                          s.items[MAX_ITEMS], TILED ? vstride : 0};
  ring.start();
  const int last = s.seg[Q - 1];
  bf16* stage = s.stage + warp * 16 * DP;

  // ---- pass 1, per query tile (the last first): dq and the rows q . dq ----
  int it = 0;
  bool nonzero = false;  // G_exit holds a value that is not 0
  for (int qt = nt - 1; qt >= 0; --qt) {
    const int i0 = qt * TR + warp * 16;
    uint32_t dyf[4][4], qf[4][4];
    take(dyf, dyn);
    if (!TILED) take(qf, qn);
    if (qt > 0) {
      load_a_rows(dyn, a.dy + vbase, vstride, i0 - TR, Q);
      if (!TILED) load_a_rows(qn, a.q + base, stride, i0 - TR, Q);
    }
    // the last round also brings G_exit into registers; its split replaces
    // H_in's once every warp has read H_in (past the round's first barrier)
    constexpr int GP = D * D / 2 / MMA_THREADS;
    float2 gpre[GP];
    if (qt == 0)
#pragma unroll
      for (int i = 0; i < GP; ++i) {
        const int p = threadIdx.x + i * MMA_THREADS;  // the element pair (2p / D, 2p % D)
        gpre[i] = TILED
                      ? *reinterpret_cast<const float2*>(a.gexit + soff + (2 * p / D) * srow + 2 * p % D)
                      : reinterpret_cast<const float2*>(a.gexit + soff)[p];
      }
    float cum_r[2];
    int seg_r[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      cum_r[i] = s.cum[i0 + g + 8 * i];
      seg_r[i] = s.seg[i0 + g + 8 * i];
    }
    float dq[8][4];
    zero(dq);
    if (hin_live && s.seg[i0] == 0) {  // ec_i (dy_i H_in^T)
      state_product<false>(dq, dyf, s.split);
      const float e0 = s.ec[i0 + g], e1 = s.ec[i0 + g + 8];
#pragma unroll
      for (int nt8 = 0; nt8 < 8; ++nt8) {
        dq[nt8][0] *= e0;
        dq[nt8][1] *= e0;
        dq[nt8][2] *= e1;
        dq[nt8][3] *= e1;
      }
    }
    for (bool first = true; it < ring.n && (s.items[it] >> 3) == qt; ++it, first = false) {
      ring.advance(it);
      if (qt == 0 && first)
#pragma unroll
        for (int i = 0; i < GP; ++i) {
          nonzero |= gpre[i].x != 0.f || gpre[i].y != 0.f;
          split_pair(s.split, threadIdx.x + i * MMA_THREADS, gpre[i]);
        }
      const int kt = s.items[it] & 7;
      const bf16* kt_s = ring.tile(it, 0);
      const bf16* vt_s = ring.tile(it, 1);
#pragma unroll 1
      for (int sb = 0; sb < 4; ++sb) {
        const int j0 = kt * TR + sb * 16;
        if (j0 > i0) break;
        const int kind = slab_kind(s.seg, i0, j0);
        if (kind == 0) continue;
        float sc[2][4];
        slab_scores(sc, dyf, vt_s + sb * 16 * DP);  // dy_i . v_j
#pragma unroll
        for (int n2 = 0; n2 < 2; ++n2)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int ri = e >> 1, j = j0 + n2 * 8 + 2 * t4 + (e & 1);
            const bool live = kind == 2 || (j <= i0 + g + 8 * ri && s.seg[j] == seg_r[ri]);
            sc[n2][e] = live ? sc[n2][e] * (exp2_fast((cum_r[ri] - s.cum[j]) * LOG2E) * s.gain[j]) : 0.f;
          }
        uint32_t pa[3][4];
        acc_to_a(pa, sc[0], sc[1]);
        slab_apply(dq, pa, kt_s + sb * 16 * DP);  // P k_j
      }
    }
    if (TILED) {  // plane vd of the partial dq
      store_rows_f32(dq, a.dqpart + vd * plane * a.kdim + base, stride, i0, Q);
    } else {
      float qdq[2];
      row_dots(qf, dq, qdq);
      if (t4 == 0) {
        s.qdq[i0 + g] = qdq[0];
        s.qdq[i0 + g + 8] = qdq[1];
      }
      store_rows(dq, stage, a.dq + base, stride, i0, Q);
    }
  }

  // (G_exit's split and every warp's q . dq rows are written) a zero G_exit
  // (as in training, where the final state gets no gradient) adds nothing
  const bool gexit_live = __syncthreads_or(nonzero);

  // ---- pass 2, per key tile (the first first): dk, dv and the rows k . dk ----
  for (int kt = 0; kt < nt; ++kt) {
    const int j0 = kt * TR + warp * 16;
    uint32_t vf[4][4], kf[4][4];
    load_a_rows(vf, a.v + vbase, vstride, j0, Q);
    load_a_rows(kf, a.k + base, stride, j0, Q);
    float cum_r[2], gain_r[2];
    int seg_r[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      cum_r[i] = s.cum[j0 + g + 8 * i];
      gain_r[i] = s.gain[j0 + g + 8 * i];
      seg_r[i] = s.seg[j0 + g + 8 * i];
    }
    float dk[8][4], dv[8][4];
    zero(dk);
    zero(dv);
    if (gexit_live && s.seg[j0 + 15] == last) {  // w_t (v_t G_exit^T), w_t (k_t G_exit)
      state_product<false>(dk, vf, s.split);
      state_product<true>(dv, kf, s.split);
      const float w0 = s.w[j0 + g], w1 = s.w[j0 + g + 8];
#pragma unroll
      for (int nt8 = 0; nt8 < 8; ++nt8) {
        dk[nt8][0] *= w0;
        dk[nt8][1] *= w0;
        dk[nt8][2] *= w1;
        dk[nt8][3] *= w1;
        dv[nt8][0] *= w0;
        dv[nt8][1] *= w0;
        dv[nt8][2] *= w1;
        dv[nt8][3] *= w1;
      }
    }
    for (; it < ring.n && ((s.items[it] >> 3) & 7) == kt; ++it) {
      ring.advance(it);
      const int qt = s.items[it] & 7;
      const bf16* qt_s = ring.tile(it, 0);
      const bf16* dyt_s = ring.tile(it, 1);
#pragma unroll 1
      for (int sb = 0; sb < 4; ++sb) {
        const int i0 = qt * TR + sb * 16;
        if (i0 < j0) continue;
        const int kind = slab_kind(s.seg, i0, j0);
        if (kind == 0) continue;
        // transposed scores: rows the keys t, columns the queries i
        float s1[2][4], s2[2][4];
        slab_scores(s1, vf, dyt_s + sb * 16 * DP);  // v_t . dy_i
        slab_scores(s2, kf, qt_s + sb * 16 * DP);   // k_t . q_i
#pragma unroll
        for (int n2 = 0; n2 < 2; ++n2)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int ri = e >> 1, i = i0 + n2 * 8 + 2 * t4 + (e & 1);
            const bool live = kind == 2 || (j0 + g + 8 * ri <= i && s.seg[i] == seg_r[ri]);
            const float dec = live ? exp2_fast((s.cum[i] - cum_r[ri]) * LOG2E) * gain_r[ri] : 0.f;
            s1[n2][e] *= dec;
            s2[n2][e] *= dec;
          }
        uint32_t pa[3][4];
        acc_to_a(pa, s1[0], s1[1]);
        slab_apply(dk, pa, qt_s + sb * 16 * DP);   // P1^T q_i
        acc_to_a(pa, s2[0], s2[1]);
        slab_apply(dv, pa, dyt_s + sb * 16 * DP);  // P2^T dy_i
      }
    }
    if (TILED) {  // plane vd of the partial dk, plane kd of the partial dv
      store_rows_f32(dk, a.dkpart + vd * plane * a.kdim + base, stride, j0, Q);
      store_rows_f32(dv, a.dvpart + kd * plane * a.vdim + vbase, vstride, j0, Q);
    } else {
      float kdk[2];
      row_dots(kf, dk, kdk);
      if (t4 == 0) {
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int row = j0 + g + 8 * i;
          if (row < Q) {
            const size_t ro = row_off(a, b, t0 + row, h);
            a.dli[ro] = kdk[i];
            a.dcum[ro] = s.qdq[row] - kdk[i];
          }
        }
      }
      store_rows(dk, stage, a.dk + base, stride, j0, Q);
      store_rows(dv, stage, a.dv + base, stride, j0, Q);
    }
  }
  cp_async_wait<0>();  // (only empty groups are left)
}

__global__ void __launch_bounds__(MMA_THREADS, 2) mamba_scan_bwd_chunk_kernel(Args a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bwd_chunk_body<false>(a, smem_raw);
}

__global__ void __launch_bounds__(MMA_THREADS, 2) mamba_scan_bwd_chunk_tiled_kernel(Args a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bwd_chunk_body<true>(a, smem_raw);
}

constexpr int SUM_THREADS = 256;  // the tiled chunk backward's sum: a block a row

// The tiled chunk backward's second launch, one block per row (b, t, h):
// dq and dk as the sums of their dv / 64 partial planes (vd = 0, 1, ... in
// turn) and dv of its dk / 64 planes (kd = 0, 1, ...), each rounded once to
// bf16; dli = k . dk and dcum = q . dq - dli from the f32 sums over the whole
// dk: each thread's four-column groups in order, then the lanes by a shuffle
// tree, then the warps in order (a fixed order: the same bits each run).
__global__ void __launch_bounds__(SUM_THREADS) mamba_scan_bwd_tile_sum_kernel(Args a) {
  __shared__ float part[2][SUM_THREADS / 32];
  const size_t row = blockIdx.x, rows = gridDim.x;
  const int nk = a.kdim / D, nv = a.vdim / D, lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const size_t pk = rows * a.kdim, pv = rows * a.vdim;  // one plane
  float qdq = 0.f, kdk = 0.f;
  for (int i = threadIdx.x * 4; i < a.kdim; i += SUM_THREADS * 4) {
    const size_t o = row * a.kdim + i;
    float4 dq = *reinterpret_cast<const float4*>(a.dqpart + o);
    float4 dk = *reinterpret_cast<const float4*>(a.dkpart + o);
    for (int vd = 1; vd < nv; ++vd) {
      const float4 x = *reinterpret_cast<const float4*>(a.dqpart + vd * pk + o);
      const float4 y = *reinterpret_cast<const float4*>(a.dkpart + vd * pk + o);
      dq.x += x.x;
      dq.y += x.y;
      dq.z += x.z;
      dq.w += x.w;
      dk.x += y.x;
      dk.y += y.y;
      dk.z += y.z;
      dk.w += y.w;
    }
    const uint2 qr = *reinterpret_cast<const uint2*>(a.q + o);
    const uint2 kr = *reinterpret_cast<const uint2*>(a.k + o);
    const float2 q0 = bf16x2_to_float2(qr.x), q1 = bf16x2_to_float2(qr.y);
    const float2 k0 = bf16x2_to_float2(kr.x), k1 = bf16x2_to_float2(kr.y);
    qdq += ((q0.x * dq.x + q0.y * dq.y) + q1.x * dq.z) + q1.y * dq.w;
    kdk += ((k0.x * dk.x + k0.y * dk.y) + k1.x * dk.z) + k1.y * dk.w;
    *reinterpret_cast<uint2*>(a.dq + o) = make_uint2(pack_bf16(dq.x, dq.y), pack_bf16(dq.z, dq.w));
    *reinterpret_cast<uint2*>(a.dk + o) = make_uint2(pack_bf16(dk.x, dk.y), pack_bf16(dk.z, dk.w));
  }
  for (int i = threadIdx.x * 4; i < a.vdim; i += SUM_THREADS * 4) {
    const size_t o = row * a.vdim + i;
    float4 dv = *reinterpret_cast<const float4*>(a.dvpart + o);
    for (int kd = 1; kd < nk; ++kd) {
      const float4 x = *reinterpret_cast<const float4*>(a.dvpart + kd * pv + o);
      dv.x += x.x;
      dv.y += x.y;
      dv.z += x.z;
      dv.w += x.w;
    }
    *reinterpret_cast<uint2*>(a.dv + o) = make_uint2(pack_bf16(dv.x, dv.y), pack_bf16(dv.z, dv.w));
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    qdq += __shfl_xor_sync(0xffffffffu, qdq, off);
    kdk += __shfl_xor_sync(0xffffffffu, kdk, off);
  }
  if (lane == 0) {
    part[0][warp] = qdq;
    part[1][warp] = kdk;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float sq = 0.f, sk = 0.f;
    for (int w = 0; w < SUM_THREADS / 32; ++w) {
      sq += part[0][w];
      sk += part[1][w];
    }
    a.dli[row] = sk;
    a.dcum[row] = sq - sk;
  }
}

// ---- state backward -------------------------------------------------------------

// A chunk's first reset row (Q when it has none) by a block-wide min, and
// the ring's work list for its products: the 64-row tiles whose first row
// comes before that row (ec is 0 from there on), none when `want` is false.
// Ends with a barrier.
__device__ int chunk_first_reset(const Args& a, int b, int t0, const Smem& s, bool want) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  int fr = a.Q;
  if (a.r != nullptr)
    for (int i = tid; i < a.Q; i += MMA_THREADS)
      if (a.r[static_cast<size_t>(b) * a.S + t0 + i] > 0) fr = min(fr, i);
  fr = __reduce_min_sync(0xffffffffu, fr);
  if (lane == 0) s.wseg[warp] = fr;
  __syncthreads();
  fr = min(min(s.wseg[0], s.wseg[1]), min(s.wseg[2], s.wseg[3]));
  if (tid == 0) {
    const int n = want ? (fr + TR - 1) / TR : 0;
    for (int i = 0; i < n; ++i) s.items[i] = i;
    s.items[MAX_ITEMS] = n;
  }
  __syncthreads();
  return fr;
}

// A warp's 16 rows x 64 of an f32 [D][D] state (C fragments) to dst (its
// rows `drow` apart) through its own [16][D + 8] f32 stage, 16-byte stores
// of whole rows
__device__ __forceinline__ void store_state_rows(const float (&acc)[8][4], float* stage,
                                                 float* dst, size_t drow) {
  constexpr int SP = D + 8;
  const int lane = threadIdx.x & 31, g = lane >> 2, t4 = lane & 3;
  __syncwarp();  // the stage's previous rows have left
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int i = 0; i < 2; ++i)
      *reinterpret_cast<float2*>(stage + (g + 8 * i) * SP + nt * 8 + 2 * t4) =
          make_float2(acc[nt][2 * i], acc[nt][2 * i + 1]);
  __syncwarp();
#pragma unroll
  for (int i = lane; i < 16 * D / 4; i += 32) {
    const int r = i / (D / 4), c = i % (D / 4);
    *reinterpret_cast<float4*>(dst + r * drow + c * 4) =
        *reinterpret_cast<const float4*>(stage + r * SP + c * 4);
  }
}

// Per (b, h), the chunks from the last to the first: gexit[c] = G, then
// G <- cdec G + sum_i (ec_i q_i) (x) dy_i, from G = dhf; dh0 = G at the end.
// Warp w owns rows 16 w .. 16 w + 15 of G (q's columns), all 64 columns
// (dy's), in f32 C fragments carried across the chunks.  A k-step is a
// 16-row slab of the chunk: ec_i q_i (q's tile read by ldmatrix.trans, so
// the rows are the contraction) enters as three bf16 terms, dy as it is.
// Slabs from the chunk's first reset row on are skipped (ec is 0 there),
// and the ring loads only tiles that start before it: on a packed training
// batch, whose rows open with a reset, no q or dy is read at all.  Without
// want_dh0 the first chunk's products, which feed only dh0, are skipped.
// TILED: the block carries tile (kd, vd) of a [dk, dv] G (blockIdx.x = kd *
// dv / 64 + vd, blockIdx.y = b * H + h) from that tile of dhf, on q's
// columns kd * 64 .. + 63 and dy's columns vd * 64 .. + 63: the update is an
// outer product, so the tile is exact on its own, and gexit and dh0 are
// written tile by tile.
template <bool TILED>
__device__ __forceinline__ void bwd_state_body(const Args& a, unsigned char* smem_raw) {
  const Smem s = carve(smem_raw);
  int bh = blockIdx.x, kd = 0, vd = 0;
  if (TILED) {
    bh = blockIdx.y;
    kd = blockIdx.x / (a.vdim / D);
    vd = blockIdx.x % (a.vdim / D);
  }
  const int b = bh / a.H, h = bh % a.H;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t4 = lane & 3;
  const int Q = a.Q;
  const size_t stride = static_cast<size_t>(a.H) * (TILED ? a.kdim : D);  // q rows
  const size_t ystride = TILED ? static_cast<size_t>(a.H) * a.vdim : stride;  // dy rows
  const size_t srow = TILED ? a.vdim : D;  // a state's rows
  const size_t sstate = TILED ? static_cast<size_t>(a.kdim) * a.vdim : D * D;  // one (b, h) state
  const size_t soff = TILED ? static_cast<size_t>(kd) * D * a.vdim + vd * D : 0;  // the tile's
  const int d0 = warp * 16;
  // the state split's room, unused here, is each warp's f32 output stage
  float* stage = reinterpret_cast<float*>(s.split) + warp * 16 * (D + 8);

  float gs[8][4];  // G [d0 + g (+ 8)][nt * 8 + 2 t4 (+ 1)]
  {
    const float* src = a.dhf + static_cast<size_t>(bh) * sstate + soff;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const float2 x =
            *reinterpret_cast<const float2*>(src + (d0 + g + 8 * i) * srow + nt * 8 + 2 * t4);
        gs[nt][2 * i] = x.x;
        gs[nt][2 * i + 1] = x.y;
      }
  }
  int fr = chunk_first_reset(a, b, (a.n - 1) * Q, s, a.n > 1 || a.want_dh0);
  // a chunk's first row of q (its dk columns) and of dy (its dv columns)
  const size_t qlast = row_off(a, b, (a.n - 1) * Q, h) * (TILED ? a.kdim : D) + (TILED ? kd * D : 0);
  const size_t ylast = TILED ? row_off(a, b, (a.n - 1) * Q, h) * a.vdim + vd * D : qlast;
  RingT<TILED> ring{s,      a.q + qlast, a.dy + ylast,        nullptr,
                    nullptr, stride,     Q,            s.items[MAX_ITEMS], ystride};
  ring.start();

  for (int c = a.n - 1; c >= 0; --c) {
    const int t0 = c * Q;
    const bool want = c > 0 || a.want_dh0;  // this chunk's update feeds gexit or dh0
    // the chunk's vectors, while its tiles land: ec_i = exp(cum_i) before
    // the first reset row, cdec = exp(cum_last) when there is none
    float cdec = 0.f;
    if (want && fr > 0) {
      if (warp == 0) warp_cumsum(a, b, t0, h, s.cum);
      __syncthreads();
      for (int i = threadIdx.x; i < QMAX; i += MMA_THREADS)
        s.ec[i] = i < fr ? expf(s.cum[i]) : 0.f;
      if (fr == Q) cdec = expf(s.cum[Q - 1]);
      __syncthreads();
    }
    store_state_rows(gs, stage,
                     a.gexit + (static_cast<size_t>(bh) * a.n + c) * sstate + soff + d0 * srow,
                     srow);

    float upd[8][4];  // sum_i (ec_i q_i[d]) dy_i[e] over the chunk, this warp's rows d
    zero(upd);
    for (int it = 0; it < ring.n; ++it) {
      ring.advance(it);
      const bf16* qt_s = ring.tile(it, 0);
      const bf16* dyt_s = ring.tile(it, 1);
#pragma unroll 1
      for (int sb = 0; sb < 4; ++sb) {
        const int j0 = it * TR + sb * 16;
        if (j0 >= fr) break;
        uint32_t qr[4];
        ldmatrix_x4_trans(qr, qt_s + (sb * 16 + (lane & 7) + ((lane >> 4) & 1) * 8) * DP + d0 +
                                  ((lane >> 3) & 1) * 8);
        const float ea = s.ec[j0 + 2 * t4], eb = s.ec[j0 + 2 * t4 + 1];
        const float ec8a = s.ec[j0 + 8 + 2 * t4], ec8b = s.ec[j0 + 9 + 2 * t4];
        uint32_t qa[3][4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float2 x = bf16x2_to_float2(qr[j]);
          const bool hi8 = j >> 1;  // k index 8 + 2 t4 (a2, a3)
          split3(x.x * (hi8 ? ec8a : ea), x.y * (hi8 ? ec8b : eb), qa[0][j], qa[1][j], qa[2][j]);
        }
        slab_apply(upd, qa, dyt_s + sb * 16 * DP);
      }
    }
    cp_async_wait<0>();  // (only empty groups are left)
    if (c > 0) {
      // the next chunk's tiles start landing while this one's update runs
      __syncthreads();  // every warp is done with the ring and the vectors
      fr = chunk_first_reset(a, b, t0 - Q, s, c > 1 || a.want_dh0);
      const size_t qrow = row_off(a, b, t0 - Q, h) * (TILED ? a.kdim : D) + (TILED ? kd * D : 0);
      ring.x0 = a.q + qrow;
      ring.x1 = a.dy + (TILED ? row_off(a, b, t0 - Q, h) * a.vdim + vd * D : qrow);
      ring.n = s.items[MAX_ITEMS];
      ring.start();
    }
    if (want)
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e)  // as the plain version rounds: the product, then the sum
          gs[nt][e] = __fadd_rn(__fmul_rn(cdec, gs[nt][e]), upd[nt][e]);
  }
  if (a.want_dh0)
    store_state_rows(gs, stage, a.dh0 + static_cast<size_t>(bh) * sstate + soff + d0 * srow, srow);
}

__global__ void __launch_bounds__(MMA_THREADS, 2) mamba_scan_bwd_state_kernel(Args a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bwd_state_body<false>(a, smem_raw);
}

__global__ void __launch_bounds__(MMA_THREADS, 2) mamba_scan_bwd_state_tiled_kernel(Args a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bwd_state_body<true>(a, smem_raw);
}

enum class Kind { kFwd, kBwdState, kBwdChunk, kFwdTiled, kBwdStateTiled, kBwdChunkTiled };

// the kernel of a kind, its dynamic shared memory (one layout for the
// six) and block size; the attributes it launches with are set
cudaError_t prepare(Kind kind, void (**fn)(Args), size_t* smem, int* threads) {
  switch (kind) {
    case Kind::kFwd: *fn = mamba_scan_fwd_kernel; break;
    case Kind::kBwdState: *fn = mamba_scan_bwd_state_kernel; break;
    case Kind::kBwdChunk: *fn = mamba_scan_bwd_chunk_kernel; break;
    case Kind::kFwdTiled: *fn = mamba_scan_fwd_tiled_kernel; break;
    case Kind::kBwdStateTiled: *fn = mamba_scan_bwd_state_tiled_kernel; break;
    default: *fn = mamba_scan_bwd_chunk_tiled_kernel;
  }
  *smem = kMmaSmem;
  *threads = MMA_THREADS;
  cudaError_t err = cudaFuncSetAttribute(*fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(*smem));
  if (err != cudaSuccess) return err;
  // room for two blocks' tiles per SM
  return cudaFuncSetAttribute(*fn, cudaFuncAttributePreferredSharedMemoryCarveout,
                              cudaSharedmemCarveoutMaxShared);
}

int launch(Kind kind, Args a, int B, int dk, int dv, void* stream) {
  if (B <= 0 || a.S <= 0 || a.H <= 0 || dk != D || dv != D || a.Q <= 0 || a.Q > QMAX ||
      a.S % a.Q != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  a.n = a.S / a.Q;
  void (*fn)(Args);
  size_t smem;
  int threads;
  cudaError_t err = prepare(kind, &fn, &smem, &threads);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(B * a.H);
  if (kind == Kind::kBwdChunk) grid.y = a.n;
  fn<<<grid, threads, smem, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// A tiled kernel: one block per (64 x 64 tile of the state, b, h) (and
// chunk, for the chunk backward); then the forward's sum of the partial y
// over the dk tiles, or the chunk backward's sum of the partial dq, dk, dv
constexpr long long kMaxRows = 2147483647;

int launch_tiled(Kind kind, Args a, int B, void* stream) {
  if (B <= 0 || a.S <= 0 || a.H <= 0 || a.kdim <= 0 || a.vdim <= 0 || a.kdim % D || a.vdim % D ||
      a.Q <= 0 || a.Q > QMAX || a.S % a.Q != 0 || B * a.H > 65535 || a.S / a.Q > 65535 ||
      static_cast<long long>(B) * a.S * a.H > kMaxRows)
    return static_cast<int>(cudaErrorInvalidValue);
  a.n = a.S / a.Q;
  void (*fn)(Args);
  size_t smem;
  int threads;
  cudaError_t err = prepare(kind, &fn, &smem, &threads);
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  fn<<<dim3((a.kdim / D) * (a.vdim / D), B * a.H, kind == Kind::kBwdChunkTiled ? a.n : 1), threads,
       smem, st>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t rows = static_cast<size_t>(B) * a.S * a.H;
  if (kind == Kind::kFwdTiled) {
    const size_t plane = rows * a.vdim;
    const int sum_threads = 256;
    const size_t blocks = (plane / 4 + sum_threads - 1) / sum_threads;
    mamba_scan_tile_sum_kernel<<<static_cast<unsigned>(blocks), sum_threads, 0, st>>>(
        a.ypart, a.y, plane, a.kdim / D);
  } else if (kind == Kind::kBwdChunkTiled) {
    mamba_scan_bwd_tile_sum_kernel<<<static_cast<unsigned>(rows), SUM_THREADS, 0, st>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}

Args make_args(int S, int H, int Q) {
  Args a{};
  a.S = S;
  a.H = H;
  a.Q = Q;
  a.kdim = a.vdim = D;
  return a;
}

// the state backward's arguments
Args state_args(const void* q, const void* la, const void* r, const void* dy, const void* dhf,
                void* gexit, void* dh0, int S, int H, int Q, int want_dh0) {
  Args a = make_args(S, H, Q);
  a.q = static_cast<const bf16*>(q);
  a.la = static_cast<const float*>(la);
  a.r = static_cast<const int*>(r);
  a.dy = static_cast<const bf16*>(dy);
  a.dhf = static_cast<const float*>(dhf);
  a.gexit = static_cast<float*>(gexit);
  a.dh0 = static_cast<float*>(dh0);
  a.want_dh0 = want_dh0 != 0;
  return a;
}

// the chunk backward's arguments
Args chunk_args(const void* q, const void* k, const void* v, const void* la, const void* li,
                const void* r, const void* dy, const void* hin, const void* gexit, void* dq,
                void* dk, void* dv, void* dcum, void* dli, int S, int H, int Q) {
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

// The forward at a [dk, dv] state of 64 x 64 tiles (dk, dv multiples of
// 64): q, k [B, S, H, dk] bf16, v [B, S, H, dv] bf16, la, li, r as above,
// h0 [B, H, dk, dv] f32 -> y [B, S, H, dv] bf16 (through ypart, scratch of
// dk / 64 x B x S x H x dv f32), hout [B, H, dk, dv] f32 and, when hin is
// not null, hin [B * H, S / Q, dk, dv] f32.  Two launches on the stream:
// the tiles, then their sum over dk.
extern "C" int mamba_scan_fwd_tiled(const void* q, const void* k, const void* v,
                                    const void* la, const void* li, const void* r,
                                    const void* h0, void* y, void* ypart, void* hout, void* hin,
                                    int B, int S, int H, int dk, int dv, int Q, void* stream) {
  Args a = make_args(S, H, Q);
  a.q = static_cast<const bf16*>(q);
  a.k = static_cast<const bf16*>(k);
  a.v = static_cast<const bf16*>(v);
  a.la = static_cast<const float*>(la);
  a.li = static_cast<const float*>(li);
  a.r = static_cast<const int*>(r);
  a.h0 = static_cast<const float*>(h0);
  a.y = static_cast<bf16*>(y);
  a.ypart = static_cast<float*>(ypart);
  a.hout = static_cast<float*>(hout);
  a.hin = static_cast<float*>(hin);
  a.kdim = dk;
  a.vdim = dv;
  return launch_tiled(Kind::kFwdTiled, a, B, stream);
}

// q [B, S, H, 64] bf16, la [B, S, H] f32, r or null, dy [B, S, H, 64] bf16,
// dhf [B, H, 64, 64] f32 -> gexit [B * H, S / Q, 64, 64] f32 (each chunk's
// exit adjoint) and, when want_dh0, dh0 [B, H, 64, 64] f32 (else dh0 may be
// null and the first chunk's products are skipped).
extern "C" int mamba_scan_bwd_state(const void* q, const void* la, const void* r,
                                    const void* dy, const void* dhf, void* gexit, void* dh0,
                                    int B, int S, int H, int dk, int dv, int Q, int want_dh0,
                                    void* stream) {
  if (want_dh0 && dh0 == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return launch(Kind::kBwdState, state_args(q, la, r, dy, dhf, gexit, dh0, S, H, Q, want_dh0), B,
                dk, dv, stream);
}

// The state backward at a [dk, dv] state of 64 x 64 tiles (dk, dv multiples
// of 64): q [B, S, H, dk], dy [B, S, H, dv] bf16, la, r as above, dhf
// [B, H, dk, dv] f32 -> gexit [B * H, S / Q, dk, dv] f32 and, when
// want_dh0, dh0 [B, H, dk, dv] f32.  One launch, a block per tile.
extern "C" int mamba_scan_bwd_state_tiled(const void* q, const void* la, const void* r,
                                          const void* dy, const void* dhf, void* gexit,
                                          void* dh0, int B, int S, int H, int dk, int dv, int Q,
                                          int want_dh0, void* stream) {
  if (want_dh0 && dh0 == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  Args a = state_args(q, la, r, dy, dhf, gexit, dh0, S, H, Q, want_dh0);
  a.kdim = dk;
  a.vdim = dv;
  return launch_tiled(Kind::kBwdStateTiled, a, B, stream);
}

// The forward's inputs, dy, hin and gexit -> dq, dk, dv [B, S, H, 64] bf16 and
// the rows dcum = q . dq - k . dk, dli = k . dk [B, S, H] f32.
extern "C" int mamba_scan_bwd_chunk(const void* q, const void* k, const void* v, const void* la,
                                    const void* li, const void* r, const void* dy,
                                    const void* hin, const void* gexit, void* dq, void* dk,
                                    void* dv, void* dcum, void* dli, int B, int S, int H,
                                    int dkdim, int dvdim, int Q, void* stream) {
  return launch(Kind::kBwdChunk,
                chunk_args(q, k, v, la, li, r, dy, hin, gexit, dq, dk, dv, dcum, dli, S, H, Q), B,
                dkdim, dvdim, stream);
}

// The chunk backward at a [dk, dv] state of 64 x 64 tiles: the arguments of
// mamba_scan_bwd_chunk at (dk, dv) (dy like v), and the f32 scratches
// dqpart, dkpart [dv / 64, B, S, H, dk] and dvpart [dk / 64, B, S, H, dv].
// Two launches on the stream: the tiles, then the sums and dcum, dli.
extern "C" int mamba_scan_bwd_chunk_tiled(const void* q, const void* k, const void* v,
                                          const void* la, const void* li, const void* r,
                                          const void* dy, const void* hin, const void* gexit,
                                          void* dq, void* dk, void* dv, void* dcum, void* dli,
                                          void* dqpart, void* dkpart, void* dvpart, int B, int S,
                                          int H, int dkdim, int dvdim, int Q, void* stream) {
  Args a = chunk_args(q, k, v, la, li, r, dy, hin, gexit, dq, dk, dv, dcum, dli, S, H, Q);
  a.dqpart = static_cast<float*>(dqpart);
  a.dkpart = static_cast<float*>(dkpart);
  a.dvpart = static_cast<float*>(dvpart);
  a.kdim = dkdim;
  a.vdim = dvdim;
  return launch_tiled(Kind::kBwdChunkTiled, a, B, stream);
}

// kind 0 forward, 1 state backward, 2 chunk backward, 3 tiled forward, 4
// tiled state backward, 5 tiled chunk backward, at chunk length Q: the
// dynamic shared memory of a block and how many blocks an SM holds
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor, with the launch's
// attributes set).
extern "C" int mamba_scan_occupancy(int kind, int Q, int* smem_bytes, int* blocks_per_sm) {
  if (kind < 0 || kind > 5 || Q <= 0 || Q > QMAX) return static_cast<int>(cudaErrorInvalidValue);
  void (*fn)(Args);
  size_t smem;
  int threads;
  cudaError_t err = prepare(static_cast<Kind>(kind), &fn, &smem, &threads);
  if (err != cudaSuccess) return static_cast<int>(err);
  *smem_bytes = static_cast<int>(smem);
  return static_cast<int>(
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, fn, threads, smem));
}

extern "C" const char* mamba_scan_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
