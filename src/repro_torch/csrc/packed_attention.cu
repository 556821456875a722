// Packed (segment-masked) flash attention for Hopper (sm_90a): forward, with
// an optional logsumexp output, and the two backward kernels.
//
// Replaces the Pallas kernels of src/repro/kernels/packed_attention.py:
//   forward  `_fwd_kernel` / `_tile_mask` / `_fwd_call` (with `save_lse`);
//   dq       `_dq_kernel`  (`_bwd_call`, first pallas_call);
//   dk / dv  `_dkv_kernel` (`_bwd_call`, second pallas_call).
//
//   o[b, s, h] = softmax_k(q[b, s, h] . k[b, k, h // G] / sqrt(dh)) @ v
//   over the keys kk visible to query s:
//     (qseg[s] == kseg[kk] or kseg[kk] == -1)            segment rule
//     and, when causal,
//     qpos[s] >= kpos[kk]                                  position rule
//     (kk / bk) * bk <= (s / bq + 1) * bq - 1 + (Sk - S)   tile rule
//   kseg == -1 marks a wildcard key row (a learned prefix) seen by every
//   query of the batch row; any other negative kseg that no query carries
//   (-2) is seen by none.  A query that sees no key gives 0, and its
//   logsumexp is the sentinel 1e30.
//
// The tile rule is the Pallas kernel's: it runs a key tile only when the
// tile starts at or before the last index of the query tile, with its own
// tiles bq = gcd(S, min(block_q, S)) and bk = gcd(Sk, min(block_k, Sk)),
// which the caller passes.  Layouts whose positions do not rise with the
// index (a packed segment's padding sits at position 0) make it visible.
// These kernels apply it key by key and skip only tiles of their own that
// it masks completely, so their result never depends on their own tiling.
//
// What bounds them on the H100: the work is 4 dh flops per visible (query,
// key, head) forward, 6 dh for dq and 8 dh for dk/dv.  At the training shape
// (B = 11, S = 256, H = 24, Hkv = 8, dh = 128: short packed segments, few
// visible pairs), at zamba2's (H = Hkv = 32, dh = 80) and at the prefill
// shape (B = 8, S = 512) the least time is set by the bytes of q/k/v/o/do
// (14-30 us at 3.35 TB/s), not by the tensor cores' rate.
//
// Forward and dk/dv (redesigned for Hopper's tensor cores).  The products
// run as mma.sync.m16n8k16 on bf16 operands with f32 accumulators, fed by
// ldmatrix (.trans where the operand's rows are the contraction).  Tiles
// stay bf16 in shared memory, copied by cp.async in 16-byte chunks (a row
// of dh = 80 is 10 of them) with rows padded to dh + 8 elements, so the
// eight rows an ldmatrix reads fall in distinct banks.  mma.sync rather
// than wgmma with TMA: it takes dh = 64, 80 and 128 with no special case
// (dh = 80 is 5 k-steps of 16 and 10 n-tiles of 8, and its 160-byte rows
// are not one 128-byte-swizzled TMA box), and the byte bound, not the issue
// rate, is the limit at these shapes.  Each warp owns 16 rows; blocks are
// 4 warps, two per SM.
//
// Tile classes.  Per warp and tile, the ranges of the rows' ids (positions,
// segments, indices; `Span`) decide whether no pair can be visible (the
// warp skips the tile: segment ranges disjoint with no -1 key, or every key
// past the position or tile rule), every pair is (no mask at all), or the
// mask is taken element by element.  The test is conservative for any ids;
// on the training layout's short packed segments it removes most tiles.
//
// Numerics.  P (and dS in dk/dv) leave the f32 accumulators as three bf16
// operands whose sum is the f32 value, so P V, P^T dO and dS^T Q keep f32
// precision: a single bf16 P rounds each weight by up to 2^-9, which adds
// up over a model's layers (the served logits moved further from the plain
// path's).  The forward adds each k-step's S products to S in f32 with
// round-to-nearest (the tensor cores truncate their sums) and takes
// exp(s scale - m) with expf, as the plain version does.
//
//   forward: one block per (64-query tile, head, batch row), the longest
//     tiles first.  Q goes from device memory straight into registers as
//     A fragments.  A ring of three K/V tiles (two copies in flight while
//     one is used, one barrier per tile) runs up to the tile rule's
//     frontier (`key_end`).  S = Q K^T stays in registers and is masked
//     from the row ids (each thread holds its two query rows' ids, the key
//     ids come from shared memory); online softmax with quad shuffles; P is
//     fed back as the A operand of P V (the m16n8 accumulator pairs have
//     the m16k16 A layout), so it never touches shared memory.  O is
//     accumulated in f32 registers and written through shared memory as
//     16-byte stores.
//   dk/dv: one block per (64-key tile, kv head, batch row); K and V stay
//     resident in shared memory.  The block walks the G query heads of its
//     kv head and their 32-query tiles (q, do, o, lse, row ids in a
//     double-buffered ring), skipping the tiles whose frontier ends before
//     the key tile.  Per tile: D = rowsum(do * o) from the stored bf16 o
//     (as `_dkv_kernel` does), S^T = K Q^T and dP^T = V dO^T,
//     P^T = exp(S^T scale - lse) masked, dS^T = P^T (dP^T - D), then
//     dV += P^T dO and dK += dS^T Q with P^T and dS^T reused from
//     registers; dK takes the scale at the end.  dK and dV stay in f32
//     registers across the whole walk, so the GQA group sum runs in
//     registers, in a fixed order, and every output element is written
//     once.
//
// dq (not redesigned yet): one block per (64-query tile, head, batch row),
// walking the 64-key tiles up to the frontier with the recomputed
// p = exp(s - lse), products on the CUDA cores in f32 from tiles widened to
// f32 in shared memory; DH / 16 output columns per thread (101,504 bytes of
// shared memory at DH = 80).  Every sum in the three kernels runs in a fixed
// order (no atomics).  They are built for DH = 64, 80 (zamba2's shared
// attention block) and 128.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;
constexpr int BKV = 64;
constexpr int THREADS = 256;
constexpr float NEG_INF = -1e30f;
constexpr float LSE_MASKED = 1e30f;

struct Args {
  const __nv_bfloat16* q;
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  const int* qpos;
  const int* qseg;
  const int* kpos;
  const int* kseg;
  const __nv_bfloat16* o;   // forward output (backward only)
  const float* lse_in;      // [B, H, S] (backward only)
  const __nv_bfloat16* d_o; // [B, S, H, dh] (backward only)
  __nv_bfloat16* out0;      // o (forward), dq, or dk
  __nv_bfloat16* out1;      // dv (dk/dv kernel)
  float* lse_out;           // [B, H, S] or null (forward)
  int S, Sk, H, Hkv, causal, bq, bk;
  float scale;
};

// last index (plus the prefix offset) that the tile rule lets query s reach
__device__ __forceinline__ int query_frontier(const Args& a, int s) {
  return (s / a.bq + 1) * a.bq - 1 + (a.Sk - a.S);
}

// one past the last key any query of [q0, q0 + BQ) can see
__device__ __forceinline__ int key_end(const Args& a, int q0) {
  if (!a.causal) return a.Sk;
  const int qe = query_frontier(a, min(q0 + BQ, a.S) - 1);
  return min(a.Sk, (qe / a.bk + 1) * a.bk);
}

__device__ __forceinline__ bool visible(const Args& a, int key, int qpos, int qseg, int qend,
                                        int kpos, int kseg) {
  return key < a.Sk && (kseg == qseg || kseg == -1) &&
         (!a.causal || (qpos >= kpos && (key / a.bk) * a.bk <= qend));
}

// ---- tensor-core building blocks (forward and dk/dv) ----------------------

constexpr int MMA_THREADS = 128;  // 4 warps, 16 rows each
constexpr float LOG2E = 1.4426950408889634f;

// one past the last key the tile rule lets a query with frontier qend reach:
// (key / bk) * bk <= qend  <=>  key < (qend / bk + 1) * bk  (qend >= 0)
__device__ __forceinline__ int key_limit(const Args& a, int qend) {
  return (qend / a.bk + 1) * a.bk;
}

// the mask from ids held in registers or shared memory
__device__ __forceinline__ bool sees(const Args& a, int key, int qpos, int qseg, int qlim,
                                     int kpos, int kseg) {
  return key < a.Sk && (kseg == qseg || kseg == -1) &&
         (!a.causal || (qpos >= kpos && key < qlim));
}

// The ids of a warp's rows of one side of a tile, over its valid rows:
// ranges of positions, segments and indices (the key index for keys, the
// tile rule's key limit for queries); lo > hi when no row is valid.
struct Span {
  int pos_lo, pos_hi, seg_lo, seg_hi, idx_lo, idx_hi;
  bool all;   // every row of the tile is valid
  bool wild;  // some valid row has segment -1 (keys)
};

__device__ __forceinline__ void warp_range(int v0, bool ok0, int v1, bool ok1, int& lo, int& hi) {
  lo = __reduce_min_sync(0xffffffffu, min(ok0 ? v0 : INT_MAX, ok1 ? v1 : INT_MAX));
  hi = __reduce_max_sync(0xffffffffu, max(ok0 ? v0 : INT_MIN, ok1 ? v1 : INT_MIN));
}

// the span of up to two rows per lane (pass ok = false for a missing one)
__device__ __forceinline__ Span warp_span(int pos0, int seg0, int idx0, bool ok0, int pos1,
                                          int seg1, int idx1, bool ok1, bool all) {
  Span sp;
  warp_range(pos0, ok0, pos1, ok1, sp.pos_lo, sp.pos_hi);
  warp_range(seg0, ok0, seg1, ok1, sp.seg_lo, sp.seg_hi);
  warp_range(idx0, ok0, idx1, ok1, sp.idx_lo, sp.idx_hi);
  sp.all = all;
  sp.wild = __any_sync(0xffffffffu, (ok0 && seg0 == -1) || (ok1 && seg1 == -1));
  return sp;
}

// What the mask is on a (query rows) x (key rows) tile, from the two spans:
// 0 when no pair can be visible, 2 when every pair is, 1 otherwise (test
// each element).  Conservative for any ids: 0 and 2 follow from the ranges.
__device__ __forceinline__ int tile_kind(bool causal, const Span& q, const Span& k) {
  if (q.pos_lo > q.pos_hi || k.pos_lo > k.pos_hi) return 0;
  if (!k.wild && (k.seg_hi < q.seg_lo || k.seg_lo > q.seg_hi)) return 0;
  if (causal && (k.pos_lo > q.pos_hi || k.idx_lo >= q.idx_hi)) return 0;
  if (q.all && k.all && q.seg_lo == q.seg_hi && k.seg_lo == k.seg_hi && k.seg_lo == q.seg_lo &&
      (!causal || (k.pos_hi <= q.pos_lo && k.idx_hi < q.idx_lo)))
    return 2;
  return 1;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, zero-filled when !valid (src is then not read)
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}

// 4 bytes global -> shared, zero-filled when !valid
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 4 : 0));
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

// 2^x in one MUFU instruction (the library's exp2f adds a denormal path);
// results below 2^-126 flush to 0
__device__ __forceinline__ float exp2_fast(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
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
// factor becomes three bf16 operands a[0] + a[1] + a[2], each multiplied on
// the tensor cores, so the product keeps its f32 precision: one bf16
// operand would round each weight by up to 2^-9, and that rounding
// compounds over a model's layers.
__device__ __forceinline__ void acc_to_a(uint32_t (&a)[3][4], const float (&c0)[4],
                                         const float (&c1)[4]) {
  split3(c0[0], c0[1], a[0][0], a[1][0], a[2][0]);
  split3(c0[2], c0[3], a[0][1], a[1][1], a[2][1]);
  split3(c1[0], c1[1], a[0][2], a[1][2], a[2][2]);
  split3(c1[2], c1[3], a[0][3], a[1][3], a[2][3]);
}

// Copies rows [r0, r0 + ROWS) of a [rows, stride] bf16 matrix (row r at
// src + r * stride) into a [ROWS][DH + 8] tile, zeros past `rows`.
template <int DH, int ROWS>
__device__ __forceinline__ void copy_tile(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                          size_t stride, int r0, int rows) {
  constexpr int CH = DH / 8;  // 16-byte chunks per row
  for (int i = threadIdx.x; i < ROWS * CH; i += MMA_THREADS) {
    const int r = i / CH, c = i % CH;
    const bool ok = r0 + r < rows;
    cp_async16(dst + r * (DH + 8) + c * 8, ok ? src + (r0 + r) * stride + c * 8 : src, ok);
  }
}

// Writes a warp's 16 rows x DH f32 accumulators (n-tiles of 8 columns) as
// bf16 through the warp's own rows of a [*][DH + 8] shared tile, then to
// rows [r0, r0 + 16) of dst (row r at dst + r * stride), 16-byte stores,
// rows past `rows` dropped.
template <int DH>
__device__ __forceinline__ void store_rows(const float (&acc)[DH / 8][4], float mul0, float mul1,
                                           __nv_bfloat16* stage, __nv_bfloat16* dst,
                                           size_t stride, int r0, int rows) {
  constexpr int DP = DH + 8, CH = DH / 8;
  const int lane = threadIdx.x & 31, g = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int nt = 0; nt < DH / 8; ++nt) {
    const int c = nt * 8 + 2 * t4;
    *reinterpret_cast<__nv_bfloat162*>(stage + g * DP + c) =
        __floats2bfloat162_rn(acc[nt][0] * mul0, acc[nt][1] * mul0);
    *reinterpret_cast<__nv_bfloat162*>(stage + (g + 8) * DP + c) =
        __floats2bfloat162_rn(acc[nt][2] * mul1, acc[nt][3] * mul1);
  }
  __syncwarp();
  for (int i = lane; i < 16 * CH; i += 32) {
    const int r = i / CH, c = i % CH;
    if (r0 + r < rows)
      *reinterpret_cast<uint4*>(dst + (r0 + r) * stride + c * 8) =
          *reinterpret_cast<const uint4*>(stage + r * DP + c * 8);
  }
}

// ---- forward ---------------------------------------------------------------

constexpr int FWD_BK = 64;   // keys per tile


constexpr int FWD_BQ = BQ;     // queries per block (16 per warp; key_end's tile)
constexpr int FWD_STAGES = 3;  // ring of k / v tiles: two in flight while one is used

template <int DH>
constexpr size_t fwd_smem() {
  // the ring of k and v tiles (bf16, rows padded) and their key ids
  return FWD_STAGES * (sizeof(__nv_bfloat16) * 2 * FWD_BK * (DH + 8) + sizeof(int) * 2 * FWD_BK);
}

template <int DH>
__global__ void __launch_bounds__(MMA_THREADS, 2) packed_attention_fwd_kernel(Args a) {
  constexpr int DP = DH + 8;
  constexpr int KS = DH / 16;  // k-steps over dh
  constexpr int NT = DH / 8;   // n-tiles of the output
  static_assert(FWD_BQ <= FWD_STAGES * FWD_BK, "the epilogue stages o in the k tiles");
  static_assert(MMA_THREADS == 2 * FWD_BK, "one thread per key id");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* k_s = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [STAGES][BK][DP]
  __nv_bfloat16* v_s = k_s + FWD_STAGES * FWD_BK * DP;              // [STAGES][BK][DP]
  int* kpos_s = reinterpret_cast<int*>(v_s + FWD_STAGES * FWD_BK * DP);  // [STAGES][BK]
  int* kseg_s = kpos_s + FWD_STAGES * FWD_BK;                            // [STAGES][BK]

  const int S = a.S, Sk = a.Sk, H = a.H, Hkv = a.Hkv;
  // the longest query tiles (most keys under the causal frontier) first
  const int q0 = (gridDim.x - 1 - blockIdx.x) * FWD_BQ;
  const int h = blockIdx.y;
  const int bi = blockIdx.z;
  const int kvh = h / (H / Hkv);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const size_t q_stride = static_cast<size_t>(H) * DH, kv_stride = static_cast<size_t>(Hkv) * DH;
  const __nv_bfloat16* qg = a.q + (static_cast<size_t>(bi) * S * H + h) * DH;
  const __nv_bfloat16* kg = a.k + (static_cast<size_t>(bi) * Sk * Hkv + kvh) * DH;
  const __nv_bfloat16* vg = a.v + (static_cast<size_t>(bi) * Sk * Hkv + kvh) * DH;
  const int* kposg = a.kpos + static_cast<size_t>(bi) * Sk;
  const int* ksegg = a.kseg + static_cast<size_t>(bi) * Sk;

  auto load_kv = [&](int it) {
    const int buf = it % FWD_STAGES, k0 = it * FWD_BK;
    copy_tile<DH, FWD_BK>(k_s + buf * FWD_BK * DP, kg, kv_stride, k0, Sk);
    copy_tile<DH, FWD_BK>(v_s + buf * FWD_BK * DP, vg, kv_stride, k0, Sk);
    const int r = threadIdx.x % FWD_BK, key = k0 + r;
    const bool ok = key < Sk;
    if (threadIdx.x < FWD_BK)
      cp_async4(kpos_s + buf * FWD_BK + r, ok ? kposg + key : kposg, ok);
    else
      cp_async4(kseg_s + buf * FWD_BK + r, ok ? ksegg + key : ksegg, ok);
  };

  // the ring's first two tiles (a group each, empty past the last tile)
  const int n_kt = (key_end(a, q0) + FWD_BK - 1) / FWD_BK;
#pragma unroll
  for (int it = 0; it < FWD_STAGES - 1; ++it) {
    if (it < n_kt) load_kv(it);
    cp_async_commit();
  }

  // this thread's two query rows (g and g + 8 of its warp's 16): ids, and
  // the Q fragments straight from device memory into registers
  const int s_lo = q0 + warp * 16;
  int qpos[2], qseg[2], qlim[2];
  bool qok[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int s = s_lo + g + 8 * i;
    qok[i] = s < S;
    qpos[i] = qok[i] ? a.qpos[static_cast<size_t>(bi) * S + s] : 0;
    qseg[i] = qok[i] ? a.qseg[static_cast<size_t>(bi) * S + s] : 0;
    qlim[i] = key_limit(a, query_frontier(a, s));
  }
  uint32_t qf[KS][4];
#pragma unroll
  for (int kk = 0; kk < KS; ++kk)
#pragma unroll
    for (int j = 0; j < 4; ++j) {  // a0: (g, 2t4), a1: (g + 8, 2t4), a2, a3: columns + 8
      const int i = j & 1;
      qf[kk][j] = qok[i] ? *reinterpret_cast<const uint32_t*>(
                               qg + (s_lo + g + 8 * i) * q_stride + kk * 16 + (j >> 1) * 8 + 2 * t4)
                         : 0u;
    }
  const Span q_span = warp_span(qpos[0], qseg[0], qlim[0], qok[0], qpos[1], qseg[1], qlim[1],
                                qok[1], s_lo + 15 < S);

  float m_i[2] = {NEG_INF, NEG_INF}, l_i[2] = {0.f, 0.f};
  float o_acc[NT][4];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) o_acc[nt][e] = 0.f;

  for (int it = 0; it < n_kt; ++it) {
    const int buf = it % FWD_STAGES, k0 = it * FWD_BK;
    cp_async_wait<FWD_STAGES - 2>();  // tile it has landed (this thread's part)
    // every part of tile it has landed, and every warp is done with tile
    // it - 1, whose buffer the next copy refills
    __syncthreads();
    if (it + FWD_STAGES - 1 < n_kt) load_kv(it + FWD_STAGES - 1);
    cp_async_commit();

    const __nv_bfloat16* kt = k_s + buf * FWD_BK * DP;
    const __nv_bfloat16* vt = v_s + buf * FWD_BK * DP;
    const int* kp = kpos_s + buf * FWD_BK;
    const int* ks = kseg_s + buf * FWD_BK;
    const int kind = tile_kind(
        a.causal, q_span,
        warp_span(kp[lane], ks[lane], k0 + lane, k0 + lane < Sk, kp[lane + 32], ks[lane + 32],
                  k0 + lane + 32, k0 + lane + 32 < Sk, k0 + FWD_BK <= Sk));
    // kind 0: this warp's rows see no key of the tile, and nothing changes
    if (kind == 0) continue;

    // S = Q K^T: 16 rows x 64 keys per warp, 8 n-tiles
    float sc[8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[nt][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      uint32_t b[4][4];  // all fragments of the k-step first, then the products
#pragma unroll
      for (int np = 0; np < 4; ++np)
        ldmatrix_x4(b[np], kt + (np * 16 + (lane & 7) + ((lane >> 4) << 3)) * DP + kk * 16 +
                               ((lane >> 3) & 1) * 8);
      // each k-step's 16 products into zeroed accumulators, then added to
      // S in f32 with round-to-nearest: the tensor cores truncate their
      // own sums, and a chain of KS of them would bias S toward zero
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        float t0[4] = {0.f, 0.f, 0.f, 0.f}, t1[4] = {0.f, 0.f, 0.f, 0.f};
        mma_bf16(t0, qf[kk], b[np][0], b[np][1]);
        mma_bf16(t1, qf[kk], b[np][2], b[np][3]);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          sc[2 * np][e] += t0[e];
          sc[2 * np + 1][e] += t1[e];
        }
      }
    }

    // mask (element by element only on a partly visible tile), online
    // softmax on raw scores (each row's 64 scores sit in one quad)
    if (kind == 1) {
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = e >> 1, c = nt * 8 + 2 * t4 + (e & 1);
          if (!sees(a, k0 + c, qpos[i], qseg[i], qlim[i], kp[c], ks[c])) sc[nt][e] = NEG_INF;
        }
    }
    float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], sc[nt][e]);
    float m_sc[2], alpha[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      const float m_new = fmaxf(m_i[i], mx[i]);
      // a row that has seen no key yet keeps exp(NEG_INF * scale) = 0
      m_sc[i] = m_new > NEG_INF * 0.5f ? m_new * a.scale : 0.f;
      alpha[i] = expf(m_i[i] * a.scale - m_sc[i]);
      m_i[i] = m_new;
      l_i[i] *= alpha[i];
    }
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      o_acc[nt][0] *= alpha[0];
      o_acc[nt][1] *= alpha[0];
      o_acc[nt][2] *= alpha[1];
      o_acc[nt][3] *= alpha[1];
    }
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        sc[nt][e] = expf(sc[nt][e] * a.scale - m_sc[e >> 1]);
        l_i[e >> 1] += sc[nt][e];
      }

    // O += P V, P from registers as three bf16 terms, V^T fragments by
    // ldmatrix.trans
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t pa[3][4];
      acc_to_a(pa, sc[2 * kk], sc[2 * kk + 1]);
      uint32_t b[DH / 16][4];
#pragma unroll
      for (int dp = 0; dp < DH / 16; ++dp)
        ldmatrix_x4_trans(b[dp], vt + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * DP +
                                     dp * 16 + (lane >> 4) * 8);
#pragma unroll
      for (int dp = 0; dp < DH / 16; ++dp)
#pragma unroll
        for (int t = 0; t < 3; ++t) {
          mma_bf16(o_acc[2 * dp], pa[t], b[dp][0], b[dp][1]);
          mma_bf16(o_acc[2 * dp + 1], pa[t], b[dp][2], b[dp][3]);
        }
    }
  }
  cp_async_wait<0>();  // (only empty groups are left)
  __syncthreads();     // every warp is done with the ring

  float inv[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l_i[i] += __shfl_xor_sync(0xffffffffu, l_i[i], 1);
    l_i[i] += __shfl_xor_sync(0xffffffffu, l_i[i], 2);
    inv[i] = 1.f / fmaxf(l_i[i], 1e-20f);
    if (a.lse_out != nullptr && t4 == 0 && qok[i])
      a.lse_out[(static_cast<size_t>(bi) * H + h) * S + s_lo + g + 8 * i] =
          m_i[i] > NEG_INF * 0.5f ? m_i[i] * a.scale + logf(fmaxf(l_i[i], 1e-30f)) : LSE_MASKED;
  }
  // each warp stages its rows in its own rows of the first k tile
  store_rows<DH>(o_acc, inv[0], inv[1], k_s + warp * 16 * DP,
                 a.out0 + (static_cast<size_t>(bi) * S * H + h) * DH, q_stride, s_lo, S);
}

// Loads one 64-query tile of head h (q and do in f32, row ids, lse) and
// computes D = rowsum(do * o) from the stored o, four threads per row.
template <int DH>
__device__ void load_query_tile(const Args& a, int bi, int h, int q0, float* q_s, float* do_s,
                                int* qpos_s, int* qseg_s, int* qend_s, float* lse_s,
                                float* d_s) {
  constexpr int QP = DH + 1;
  const int S = a.S, H = a.H, tid = threadIdx.x;
  for (int i = tid; i < BQ * DH; i += THREADS) {
    const int r = i / DH, d = i % DH, s = q0 + r;
    const size_t off = ((static_cast<size_t>(bi) * S + s) * H + h) * DH + d;
    q_s[r * QP + d] = s < S ? __bfloat162float(a.q[off]) : 0.f;
    do_s[r * QP + d] = s < S ? __bfloat162float(a.d_o[off]) : 0.f;
  }
  for (int i = tid; i < BQ; i += THREADS) {
    const int s = q0 + i;
    qpos_s[i] = s < S ? a.qpos[static_cast<size_t>(bi) * S + s] : 0;
    qseg_s[i] = s < S ? a.qseg[static_cast<size_t>(bi) * S + s] : 0;
    qend_s[i] = query_frontier(a, s);
    lse_s[i] = s < S ? a.lse_in[(static_cast<size_t>(bi) * H + h) * S + s] : LSE_MASKED;
  }
  __syncthreads();
  {
    const int r = tid >> 2, part = tid & 3, s = q0 + r;
    constexpr int SPAN = DH / 4;
    float dsum = 0.f;
    if (s < S) {
      const __nv_bfloat16* orow = a.o + ((static_cast<size_t>(bi) * S + s) * H + h) * DH;
      for (int d = part * SPAN; d < (part + 1) * SPAN; ++d)
        dsum += do_s[r * QP + d] * __bfloat162float(orow[d]);
    }
    dsum += __shfl_xor_sync(0xffffffffu, dsum, 1);
    dsum += __shfl_xor_sync(0xffffffffu, dsum, 2);
    if (part == 0) d_s[r] = dsum;
  }
  __syncthreads();
}

template <int DH>
constexpr size_t dq_smem() {
  return sizeof(float) * (2 * BQ * (DH + 1) + 2 * DH * (BKV + 1) + BQ * (BKV + 1) + 2 * BQ) +
         sizeof(int) * (3 * BQ + 2 * BKV);
}

template <int DH>
__global__ void __launch_bounds__(THREADS) packed_attention_dq_kernel(Args a) {
  constexpr int QP = DH + 1;
  constexpr int KP = BKV + 1;
  constexpr int CPT = DH / 16;
  extern __shared__ float smem[];
  float* q_s = smem;              // [BQ][QP]
  float* do_s = q_s + BQ * QP;    // [BQ][QP]
  float* kt_s = do_s + BQ * QP;   // [DH][KP]
  float* vt_s = kt_s + DH * KP;   // [DH][KP]
  float* ds_s = vt_s + DH * KP;   // [BQ][KP]
  float* lse_s = ds_s + BQ * KP;  // [BQ]
  float* d_s = lse_s + BQ;        // [BQ]
  int* qpos_s = reinterpret_cast<int*>(d_s + BQ);
  int* qseg_s = qpos_s + BQ;
  int* qend_s = qseg_s + BQ;
  int* kpos_s = qend_s + BQ;
  int* kseg_s = kpos_s + BKV;

  const int S = a.S, Sk = a.Sk, H = a.H;
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int bi = blockIdx.z;
  const int kvh = h / (H / a.Hkv);
  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;

  load_query_tile<DH>(a, bi, h, q0, q_s, do_s, qpos_s, qseg_s, qend_s, lse_s, d_s);

  float acc[4][CPT];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < CPT; ++c) acc[i][c] = 0.f;

  const int kv_end = key_end(a, q0);
  for (int k0 = 0; k0 < kv_end; k0 += BKV) {
    __syncthreads();  // the previous tile's k, v and ds are no longer read
    for (int i = tid; i < BKV * DH; i += THREADS) {
      const int kr = i / DH, d = i % DH, key = k0 + kr;
      const size_t off = ((static_cast<size_t>(bi) * Sk + key) * a.Hkv + kvh) * DH + d;
      kt_s[d * KP + kr] = key < Sk ? __bfloat162float(a.k[off]) : 0.f;
      vt_s[d * KP + kr] = key < Sk ? __bfloat162float(a.v[off]) : 0.f;
    }
    for (int i = tid; i < BKV; i += THREADS) {
      const int key = k0 + i;
      kpos_s[i] = key < Sk ? a.kpos[static_cast<size_t>(bi) * Sk + key] : 0;
      kseg_s[i] = key < Sk ? a.kseg[static_cast<size_t>(bi) * Sk + key] : 0;
    }
    __syncthreads();

    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < DH; ++d) {
      float qv[4], ov[4], kv[4], vv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        qv[i] = q_s[(ty * 4 + i) * QP + d];
        ov[i] = do_s[(ty * 4 + i) * QP + d];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        kv[j] = kt_s[d * KP + tx + 16 * j];
        vv[j] = vt_s[d * KP + tx + 16 * j];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] += qv[i] * kv[j];
          dp[i][j] += ov[i] * vv[j];
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty * 4 + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        float ds = 0.f;
        if (visible(a, k0 + c, qpos_s[r], qseg_s[r], qend_s[r], kpos_s[c], kseg_s[c])) {
          const float p = expf(s[i][j] * a.scale - lse_s[r]);
          ds = p * (dp[i][j] - d_s[r]) * a.scale;
        }
        ds_s[r * KP + c] = ds;
      }
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < BKV; ++c) {
      float dv[4], kv[CPT];
#pragma unroll
      for (int i = 0; i < 4; ++i) dv[i] = ds_s[(ty * 4 + i) * KP + c];
#pragma unroll
      for (int cc = 0; cc < CPT; ++cc) kv[cc] = kt_s[(tx + 16 * cc) * KP + c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int cc = 0; cc < CPT; ++cc) acc[i][cc] += dv[i] * kv[cc];
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int s = q0 + ty * 4 + i;
    if (s >= S) continue;
#pragma unroll
    for (int c = 0; c < CPT; ++c) {
      const int d = tx + 16 * c;
      a.out0[((static_cast<size_t>(bi) * S + s) * H + h) * DH + d] = __float2bfloat16(acc[i][c]);
    }
  }
}

// ---- dk / dv -----------------------------------------------------------------

constexpr int DKV_BK = 64;  // keys per block (16 per warp)
constexpr int DKV_BQ = 32;  // queries per tile of the walk

template <int DH>
__host__ __device__ constexpr size_t dkv_stage_bytes() {
  // q, do, o tiles (bf16, rows padded), then lse, qpos, qseg
  return sizeof(__nv_bfloat16) * 3 * DKV_BQ * (DH + 8) + sizeof(int) * 3 * DKV_BQ;
}

template <int DH>
constexpr size_t dkv_smem() {
  // resident k and v tiles, two stages of the walk, D and the key limits
  return sizeof(__nv_bfloat16) * 2 * DKV_BK * (DH + 8) + 2 * dkv_stage_bytes<DH>() +
         sizeof(float) * 2 * DKV_BQ;
}

template <int DH>
__global__ void __launch_bounds__(MMA_THREADS, 2) packed_attention_dkv_kernel(Args a) {
  constexpr int DP = DH + 8;
  constexpr int KS = DH / 16;  // k-steps over dh
  constexpr int NT = DH / 8;   // n-tiles of dk / dv
  static_assert(MMA_THREADS == 4 * DKV_BQ, "D takes 4 threads per query row");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* k_s = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [BK][DP]
  __nv_bfloat16* v_s = k_s + DKV_BK * DP;                            // [BK][DP]
  unsigned char* stages = reinterpret_cast<unsigned char*>(v_s + DKV_BK * DP);
  float* d_s = reinterpret_cast<float*>(stages + 2 * dkv_stage_bytes<DH>());  // [BQ]
  int* qlim_s = reinterpret_cast<int*>(d_s + DKV_BQ);                         // [BQ]

  const int S = a.S, Sk = a.Sk, H = a.H, Hkv = a.Hkv;
  const int G = H / Hkv;
  const int k0 = blockIdx.x * DKV_BK;
  const int kvh = blockIdx.y;
  const int bi = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const size_t q_stride = static_cast<size_t>(H) * DH, kv_stride = static_cast<size_t>(Hkv) * DH;
  const size_t kv_off = (static_cast<size_t>(bi) * Sk * Hkv + kvh) * DH;
  const float scale2 = a.scale * LOG2E;  // exp(x scale) = exp2(x scale2)

  auto q_tile = [&](int st) {
    return reinterpret_cast<__nv_bfloat16*>(stages + st * dkv_stage_bytes<DH>());
  };
  auto ids = [&](int st) {  // lse (as int bits), qpos, qseg of a stage
    return reinterpret_cast<int*>(q_tile(st) + 3 * DKV_BQ * DP);
  };

  // the walk: heads kvh * G + hg, query tiles qt_first .. n_qt - 1 of each;
  // a query tile whose frontier ends before this key tile's first rule tile
  // sees none of its keys
  const int n_qt = (S + DKV_BQ - 1) / DKV_BQ;
  const int key_tile_start = (k0 / a.bk) * a.bk;
  int qt_first = 0;
  if (a.causal)
    while (qt_first < n_qt &&
           key_tile_start > query_frontier(a, min((qt_first + 1) * DKV_BQ, S) - 1))
      ++qt_first;
  const int per_head = n_qt - qt_first;
  const int n_it = G * per_head;

  auto load_query = [&](int st, int it) {
    const int h = kvh * G + it / per_head;
    const int q0 = (qt_first + it % per_head) * DKV_BQ;
    const size_t off = (static_cast<size_t>(bi) * S * H + h) * DH;
    __nv_bfloat16* t = q_tile(st);
    copy_tile<DH, DKV_BQ>(t, a.q + off, q_stride, q0, S);
    copy_tile<DH, DKV_BQ>(t + DKV_BQ * DP, a.d_o + off, q_stride, q0, S);
    copy_tile<DH, DKV_BQ>(t + 2 * DKV_BQ * DP, a.o + off, q_stride, q0, S);
    if (tid < 3 * DKV_BQ) {
      const int which = tid / DKV_BQ, r = tid % DKV_BQ, s = q0 + r;
      const bool ok = s < S;
      const void* src =
          which == 0 ? static_cast<const void*>(a.lse_in + (static_cast<size_t>(bi) * H + h) * S)
          : which == 1 ? static_cast<const void*>(a.qpos + static_cast<size_t>(bi) * S)
                       : static_cast<const void*>(a.qseg + static_cast<size_t>(bi) * S);
      cp_async4(ids(st) + which * DKV_BQ + r,
                static_cast<const int*>(src) + (ok ? s : 0), ok);
    }
  };

  copy_tile<DH, DKV_BK>(k_s, a.k + kv_off, kv_stride, k0, Sk);
  copy_tile<DH, DKV_BK>(v_s, a.v + kv_off, kv_stride, k0, Sk);
  if (n_it > 0) load_query(0, 0);
  cp_async_commit();

  // this thread's two key rows (g and g + 8 of its warp's 16)
  int key[2], kpos[2], kseg[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    key[i] = k0 + warp * 16 + g + 8 * i;
    const bool ok = key[i] < Sk;
    kpos[i] = ok ? a.kpos[static_cast<size_t>(bi) * Sk + key[i]] : 0;
    kseg[i] = ok ? a.kseg[static_cast<size_t>(bi) * Sk + key[i]] : 0;
  }

  float dk[NT][4], dv[NT][4];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[nt][e] = dv[nt][e] = 0.f;

  const __nv_bfloat16* kw = k_s + warp * 16 * DP;
  const __nv_bfloat16* vw = v_s + warp * 16 * DP;
  for (int it = 0; it < n_it; ++it) {
    const int st = it & 1;
    const int q0 = (qt_first + it % per_head) * DKV_BQ;
    if (it + 1 < n_it) {
      load_query(st ^ 1, it + 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const __nv_bfloat16* qt = q_tile(st);
    const __nv_bfloat16* dot = qt + DKV_BQ * DP;
    const __nv_bfloat16* ot = qt + 2 * DKV_BQ * DP;
    float* lse_s = reinterpret_cast<float*>(ids(st));
    const int* qpos_s = ids(st) + DKV_BQ;
    const int* qseg_s = ids(st) + 2 * DKV_BQ;

    // D = rowsum(do * o) from the stored bf16 o, 4 threads per query row;
    // the tile rule's key limit per query
    {
      constexpr int CH = DH / 8;
      const int r = tid >> 2, part = tid & 3;
      float sum = 0.f;
      for (int c = part; c < CH; c += 4) {
        const uint4 x = *reinterpret_cast<const uint4*>(dot + r * DP + c * 8);
        const uint4 y = *reinterpret_cast<const uint4*>(ot + r * DP + c * 8);
        const __nv_bfloat162* xp = reinterpret_cast<const __nv_bfloat162*>(&x);
        const __nv_bfloat162* yp = reinterpret_cast<const __nv_bfloat162*>(&y);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float2 xf = __bfloat1622float2(xp[j]), yf = __bfloat1622float2(yp[j]);
          sum += xf.x * yf.x + xf.y * yf.y;
        }
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      if (part == 0) {
        d_s[r] = sum;
        qlim_s[r] = key_limit(a, query_frontier(a, q0 + r));
        lse_s[r] *= LOG2E;  // exp(x scale - lse) = exp2(x scale2 - lse2)
      }
    }
    __syncthreads();
    // kind 0: this warp's keys are seen by no query of the tile (the keys'
    // span is taken anew each tile: it would hold 8 registers across the walk)
    const int kind = tile_kind(
        a.causal,
        warp_span(qpos_s[lane], qseg_s[lane], qlim_s[lane], q0 + lane < S, 0, 0, 0, false,
                  q0 + DKV_BQ <= S),
        warp_span(kpos[0], kseg[0], key[0], key[0] < Sk, kpos[1], kseg[1], key[1], key[1] < Sk,
                  key[0] - g + 15 < Sk));
    if (kind != 0) {
      // S^T = K Q^T and dP^T = V dO^T: 16 keys x 32 queries per warp
      float st_acc[4][4], dpt[4][4];
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) st_acc[nt][e] = dpt[nt][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        uint32_t ka[4], va[4];
        ldmatrix_x4(ka, kw + (lane & 15) * DP + kk * 16 + (lane >> 4) * 8);
        ldmatrix_x4(va, vw + (lane & 15) * DP + kk * 16 + (lane >> 4) * 8);
#pragma unroll
        for (int np = 0; np < 2; ++np) {
          const int row = np * 16 + (lane & 7) + ((lane >> 4) << 3);
          const int col = kk * 16 + ((lane >> 3) & 1) * 8;
          uint32_t b[4];
          ldmatrix_x4(b, qt + row * DP + col);
          mma_bf16(st_acc[2 * np], ka, b[0], b[1]);
          mma_bf16(st_acc[2 * np + 1], ka, b[2], b[3]);
          ldmatrix_x4(b, dot + row * DP + col);
          mma_bf16(dpt[2 * np], va, b[0], b[1]);
          mma_bf16(dpt[2 * np + 1], va, b[2], b[3]);
        }
      }

      // P^T = exp(S^T scale - lse) where visible (element by element only on
      // a partly visible tile), dS^T / scale = P^T (dP^T - D); dK takes the
      // scale at the end
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = nt * 8 + 2 * t4 + (e & 1);
          st_acc[nt][e] = exp2_fast(fmaf(st_acc[nt][e], scale2, -lse_s[c]));
          dpt[nt][e] = st_acc[nt][e] * (dpt[nt][e] - d_s[c]);
        }
      if (kind == 1) {
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int i = e >> 1, c = nt * 8 + 2 * t4 + (e & 1);
            if (q0 + c >= S ||
                !sees(a, key[i], qpos_s[c], qseg_s[c], qlim_s[c], kpos[i], kseg[i]))
              st_acc[nt][e] = dpt[nt][e] = 0.f;
          }
      }

      // dV += P^T dO and dK += dS^T Q; do and q fragments by ldmatrix.trans
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
        uint32_t pa[3][4], dsa[3][4];
        acc_to_a(pa, st_acc[2 * kk], st_acc[2 * kk + 1]);
        acc_to_a(dsa, dpt[2 * kk], dpt[2 * kk + 1]);
        const int row = kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
#pragma unroll
        for (int dp = 0; dp < DH / 16; ++dp) {
          const int col = dp * 16 + (lane >> 4) * 8;
          uint32_t b[4];
          ldmatrix_x4_trans(b, dot + row * DP + col);
#pragma unroll
          for (int t = 0; t < 3; ++t) {
            mma_bf16(dv[2 * dp], pa[t], b[0], b[1]);
            mma_bf16(dv[2 * dp + 1], pa[t], b[2], b[3]);
          }
          ldmatrix_x4_trans(b, qt + row * DP + col);
#pragma unroll
          for (int t = 0; t < 3; ++t) {
            mma_bf16(dk[2 * dp], dsa[t], b[0], b[1]);
            mma_bf16(dk[2 * dp + 1], dsa[t], b[2], b[3]);
          }
        }
      }
    }
    __syncthreads();  // this stage is refilled two tiles on; D is rewritten
  }
  cp_async_wait<0>();  // (n_it == 0: the k / v copy)
  __syncthreads();

  // each warp stages its own rows of k_s / v_s
  store_rows<DH>(dk, a.scale, a.scale, k_s + warp * 16 * DP, a.out0 + kv_off, kv_stride,
                 k0 + warp * 16, Sk);
  store_rows<DH>(dv, 1.f, 1.f, v_s + warp * 16 * DP, a.out1 + kv_off, kv_stride,
                 k0 + warp * 16, Sk);
}

enum class Kind { kFwd, kDq, kDkv };

template <int DH>
cudaError_t launch(Kind kind, const Args& a, int B, cudaStream_t stream) {
  void (*fn)(Args);
  size_t smem;
  dim3 grid;
  int threads = MMA_THREADS;
  if (kind == Kind::kFwd) {
    fn = packed_attention_fwd_kernel<DH>;
    smem = fwd_smem<DH>();
    grid = dim3((a.S + FWD_BQ - 1) / FWD_BQ, a.H, B);
  } else if (kind == Kind::kDq) {
    fn = packed_attention_dq_kernel<DH>;
    smem = dq_smem<DH>();
    grid = dim3((a.S + BQ - 1) / BQ, a.H, B);
    threads = THREADS;
  } else {
    fn = packed_attention_dkv_kernel<DH>;
    smem = dkv_smem<DH>();
    grid = dim3((a.Sk + DKV_BK - 1) / DKV_BK, a.Hkv, B);
  }
  cudaError_t err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  if (kind != Kind::kDq) {  // room for two blocks' tiles per SM
    err = cudaFuncSetAttribute(fn, cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return err;
  }
  fn<<<grid, threads, smem, stream>>>(a);
  return cudaGetLastError();
}

int dispatch(Kind kind, Args a, int B, int dh, void* stream) {
  if (B <= 0 || a.S <= 0 || a.Sk < a.S || a.Hkv <= 0 || a.H % a.Hkv != 0 || a.bq <= 0 ||
      a.bk <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  a.scale = static_cast<float>(1.0 / sqrt(static_cast<double>(dh)));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dh == 128) return static_cast<int>(launch<128>(kind, a, B, st));
  if (dh == 80) return static_cast<int>(launch<80>(kind, a, B, st));
  if (dh == 64) return static_cast<int>(launch<64>(kind, a, B, st));
  return static_cast<int>(cudaErrorInvalidValue);
}

Args make_args(const void* q, const void* k, const void* v, const void* qpos, const void* qseg,
               const void* kpos, const void* kseg, int S, int Sk, int H, int Hkv, int causal,
               int bq, int bk) {
  Args a{};
  a.q = static_cast<const __nv_bfloat16*>(q);
  a.k = static_cast<const __nv_bfloat16*>(k);
  a.v = static_cast<const __nv_bfloat16*>(v);
  a.qpos = static_cast<const int*>(qpos);
  a.qseg = static_cast<const int*>(qseg);
  a.kpos = static_cast<const int*>(kpos);
  a.kseg = static_cast<const int*>(kseg);
  a.S = S;
  a.Sk = Sk;
  a.H = H;
  a.Hkv = Hkv;
  a.causal = causal;
  a.bq = bq;
  a.bk = bk;
  return a;
}

}  // namespace

// q [B, S, H, dh], k/v [B, Sk, Hkv, dh] bf16; qpos/qseg [B, S], kpos/kseg [B, Sk]
// int32; bq/bk the tile rule's tiles -> o [B, S, H, dh] bf16 and, when lse is
// not null, lse [B, H, S] f32.  All contiguous.  dh in {64, 80, 128}.
extern "C" int packed_attention_fwd(const void* q, const void* k, const void* v,
                                    const void* qpos, const void* qseg, const void* kpos,
                                    const void* kseg, void* o, void* lse, int B, int S, int Sk,
                                    int H, int Hkv, int dh, int causal, int bq, int bk,
                                    void* stream) {
  Args a = make_args(q, k, v, qpos, qseg, kpos, kseg, S, Sk, H, Hkv, causal, bq, bk);
  a.out0 = static_cast<__nv_bfloat16*>(o);
  a.lse_out = static_cast<float*>(lse);
  return dispatch(Kind::kFwd, a, B, dh, stream);
}

// The forward's arguments plus o, lse and do [B, S, H, dh] -> dq [B, S, H, dh] bf16.
extern "C" int packed_attention_dq(const void* q, const void* k, const void* v,
                                   const void* qpos, const void* qseg, const void* kpos,
                                   const void* kseg, const void* o, const void* lse,
                                   const void* d_o, void* dq, int B, int S, int Sk, int H,
                                   int Hkv, int dh, int causal, int bq, int bk, void* stream) {
  Args a = make_args(q, k, v, qpos, qseg, kpos, kseg, S, Sk, H, Hkv, causal, bq, bk);
  a.o = static_cast<const __nv_bfloat16*>(o);
  a.lse_in = static_cast<const float*>(lse);
  a.d_o = static_cast<const __nv_bfloat16*>(d_o);
  a.out0 = static_cast<__nv_bfloat16*>(dq);
  return dispatch(Kind::kDq, a, B, dh, stream);
}

// The forward's arguments plus o, lse and do -> dk, dv [B, Sk, Hkv, dh] bf16,
// summed over the G query heads of each kv head.
extern "C" int packed_attention_dkv(const void* q, const void* k, const void* v,
                                    const void* qpos, const void* qseg, const void* kpos,
                                    const void* kseg, const void* o, const void* lse,
                                    const void* d_o, void* dk, void* dv, int B, int S, int Sk,
                                    int H, int Hkv, int dh, int causal, int bq, int bk,
                                    void* stream) {
  Args a = make_args(q, k, v, qpos, qseg, kpos, kseg, S, Sk, H, Hkv, causal, bq, bk);
  a.o = static_cast<const __nv_bfloat16*>(o);
  a.lse_in = static_cast<const float*>(lse);
  a.d_o = static_cast<const __nv_bfloat16*>(d_o);
  a.out0 = static_cast<__nv_bfloat16*>(dk);
  a.out1 = static_cast<__nv_bfloat16*>(dv);
  return dispatch(Kind::kDkv, a, B, dh, stream);
}

extern "C" const char* packed_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
