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
// visible pairs) and at the prefill shape the least time is set by the
// bytes of q/k/v/o/do at the tensor cores' rate.  This first version runs
// the products on the CUDA cores in f32 and sits far above that bound;
// mma/wgmma and TMA come later.
//
// Design.  Forward and dq: one block per (64-query tile, head, batch row),
// walking the 64-key tiles up to the tile rule's frontier; online softmax
// (forward) or the recomputed p = exp(s - lse) (dq) in f32.  dk/dv: one
// block per (64-key tile, kv head, batch row); it walks the G query heads
// of its kv head and their query tiles, so the GQA group sum happens in
// registers and every output element is written once.  D = rowsum(do * o)
// is recomputed from the forward's stored bf16 o, as `_dkv_kernel` does.
// Every sum runs in a fixed order (no atomics).  Each thread owns DH / 16
// output columns, so any DH that is a multiple of 16 maps; the kernels are
// built for DH = 64, 80 (zamba2's shared attention block) and 128.  At
// DH = 80 the forward takes 79,936 bytes of shared memory, dq 101,504 and
// dk/dv 118,016, under the 232,448 a block may use.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

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

template <int DH>
constexpr size_t fwd_smem() {
  return sizeof(float) * (BQ * (DH + 1) + DH * (BKV + 1) + BKV * DH + BQ * (BKV + 1)) +
         sizeof(int) * (3 * BQ + 2 * BKV);
}

template <int DH>
__global__ void __launch_bounds__(THREADS) packed_attention_fwd_kernel(Args a) {
  constexpr int QP = DH + 1;   // padded row stride of the q tile
  constexpr int KP = BKV + 1;  // padded row stride of the transposed k tile and of p
  constexpr int CPT = DH / 16; // output columns per thread
  extern __shared__ float smem[];
  float* q_s = smem;             // [BQ][QP]
  float* kt_s = q_s + BQ * QP;   // [DH][KP]
  float* v_s = kt_s + DH * KP;   // [BKV][DH]
  float* p_s = v_s + BKV * DH;   // [BQ][KP]
  int* qpos_s = reinterpret_cast<int*>(p_s + BQ * KP);
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

  for (int i = tid; i < BQ * DH; i += THREADS) {
    const int r = i / DH, d = i % DH, s = q0 + r;
    q_s[r * QP + d] =
        s < S ? __bfloat162float(a.q[((static_cast<size_t>(bi) * S + s) * H + h) * DH + d]) : 0.f;
  }
  for (int i = tid; i < BQ; i += THREADS) {
    const int s = q0 + i;
    qpos_s[i] = s < S ? a.qpos[static_cast<size_t>(bi) * S + s] : 0;
    qseg_s[i] = s < S ? a.qseg[static_cast<size_t>(bi) * S + s] : 0;
    qend_s[i] = query_frontier(a, s);
  }

  float m_i[4], l_i[4], acc[4][CPT];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m_i[i] = NEG_INF;
    l_i[i] = 0.f;
#pragma unroll
    for (int c = 0; c < CPT; ++c) acc[i][c] = 0.f;
  }

  const int kv_end = key_end(a, q0);
  for (int k0 = 0; k0 < kv_end; k0 += BKV) {
    __syncthreads();  // the previous tile's k, v and p are no longer read
    for (int i = tid; i < BKV * DH; i += THREADS) {
      const int kr = i / DH, d = i % DH, key = k0 + kr;
      const size_t off = ((static_cast<size_t>(bi) * Sk + key) * a.Hkv + kvh) * DH + d;
      kt_s[d * KP + kr] = key < Sk ? __bfloat162float(a.k[off]) : 0.f;
      v_s[kr * DH + d] = key < Sk ? __bfloat162float(a.v[off]) : 0.f;
    }
    for (int i = tid; i < BKV; i += THREADS) {
      const int key = k0 + i;
      kpos_s[i] = key < Sk ? a.kpos[static_cast<size_t>(bi) * Sk + key] : 0;
      kseg_s[i] = key < Sk ? a.kseg[static_cast<size_t>(bi) * Sk + key] : 0;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < DH; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = q_s[(ty * 4 + i) * QP + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = kt_s[d * KP + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] += qv[i] * kv[j];
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty * 4 + i;
      bool vis[4];
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        vis[j] = visible(a, k0 + c, qpos_s[r], qseg_s[r], qend_s[r], kpos_s[c], kseg_s[c]);
        s[i][j] = vis[j] ? s[i][j] * a.scale : NEG_INF;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m_i[i], mx);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = vis[j] ? expf(s[i][j] - m_new) : 0.f;
        p_s[r * KP + tx + 16 * j] = p;
        sum += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
      const float alpha = expf(m_i[i] - m_new);
      l_i[i] = l_i[i] * alpha + sum;
      m_i[i] = m_new;
#pragma unroll
      for (int c = 0; c < CPT; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < BKV; ++c) {
      float pv[4], vv[CPT];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = p_s[(ty * 4 + i) * KP + c];
#pragma unroll
      for (int cc = 0; cc < CPT; ++cc) vv[cc] = v_s[c * DH + tx + 16 * cc];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int cc = 0; cc < CPT; ++cc) acc[i][cc] += pv[i] * vv[cc];
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int s = q0 + ty * 4 + i;
    if (s >= S) continue;
    const float l = fmaxf(l_i[i], 1e-20f);
#pragma unroll
    for (int c = 0; c < CPT; ++c) {
      const int d = tx + 16 * c;
      a.out0[((static_cast<size_t>(bi) * S + s) * H + h) * DH + d] =
          __float2bfloat16(acc[i][c] / l);
    }
    if (a.lse_out != nullptr && tx == 0)
      a.lse_out[(static_cast<size_t>(bi) * H + h) * S + s] =
          m_i[i] > NEG_INF * 0.5f ? m_i[i] + logf(fmaxf(l_i[i], 1e-30f)) : LSE_MASKED;
  }
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

template <int DH>
constexpr size_t dkv_smem() {
  return sizeof(float) * (2 * BKV * (DH + 1) + 2 * BQ * (DH + 1) + 2 * BKV * (BQ + 1) +
                          2 * BQ) +
         sizeof(int) * (3 * BQ + 2 * BKV);
}

template <int DH>
__global__ void __launch_bounds__(THREADS) packed_attention_dkv_kernel(Args a) {
  constexpr int QP = DH + 1;
  constexpr int PP = BQ + 1;
  constexpr int CPT = DH / 16;
  extern __shared__ float smem[];
  float* k_s = smem;               // [BKV][QP]
  float* v_s = k_s + BKV * QP;     // [BKV][QP]
  float* q_s = v_s + BKV * QP;     // [BQ][QP]
  float* do_s = q_s + BQ * QP;     // [BQ][QP]
  float* pt_s = do_s + BQ * QP;    // [BKV][PP]  p transposed
  float* dst_s = pt_s + BKV * PP;  // [BKV][PP]  ds transposed
  float* lse_s = dst_s + BKV * PP; // [BQ]
  float* d_s = lse_s + BQ;         // [BQ]
  int* qpos_s = reinterpret_cast<int*>(d_s + BQ);
  int* qseg_s = qpos_s + BQ;
  int* qend_s = qseg_s + BQ;
  int* kpos_s = qend_s + BQ;
  int* kseg_s = kpos_s + BKV;

  const int S = a.S, Sk = a.Sk, H = a.H, Hkv = a.Hkv;
  const int G = H / Hkv;
  const int k0 = blockIdx.x * BKV;
  const int kvh = blockIdx.y;
  const int bi = blockIdx.z;
  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;

  for (int i = tid; i < BKV * DH; i += THREADS) {
    const int kr = i / DH, d = i % DH, key = k0 + kr;
    const size_t off = ((static_cast<size_t>(bi) * Sk + key) * Hkv + kvh) * DH + d;
    k_s[kr * QP + d] = key < Sk ? __bfloat162float(a.k[off]) : 0.f;
    v_s[kr * QP + d] = key < Sk ? __bfloat162float(a.v[off]) : 0.f;
  }
  for (int i = tid; i < BKV; i += THREADS) {
    const int key = k0 + i;
    kpos_s[i] = key < Sk ? a.kpos[static_cast<size_t>(bi) * Sk + key] : 0;
    kseg_s[i] = key < Sk ? a.kseg[static_cast<size_t>(bi) * Sk + key] : 0;
  }

  float dk[4][CPT], dv[4][CPT];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < CPT; ++c) dk[i][c] = dv[i][c] = 0.f;

  // a query tile whose frontier ends before this key tile's first rule tile
  // sees none of its keys
  const int key_tile_start = (k0 / a.bk) * a.bk;
  const int n_qt = (S + BQ - 1) / BQ;
  for (int g = 0; g < G; ++g) {
    const int h = kvh * G + g;
    for (int qt = 0; qt < n_qt; ++qt) {
      const int q0 = qt * BQ;
      if (a.causal && key_tile_start > query_frontier(a, min(q0 + BQ, S) - 1)) continue;
      __syncthreads();  // the previous tile's q, do, p and ds are no longer read
      load_query_tile<DH>(a, bi, h, q0, q_s, do_s, qpos_s, qseg_s, qend_s, lse_s, d_s);

      // s^T and dp^T: 4 keys (rows ty*4+i) x 4 queries (columns tx+16j)
      float st[4][4], dpt[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) st[i][j] = dpt[i][j] = 0.f;
#pragma unroll 4
      for (int d = 0; d < DH; ++d) {
        float kv[4], vv[4], qv[4], ov[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          kv[i] = k_s[(ty * 4 + i) * QP + d];
          vv[i] = v_s[(ty * 4 + i) * QP + d];
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          qv[j] = q_s[(tx + 16 * j) * QP + d];
          ov[j] = do_s[(tx + 16 * j) * QP + d];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            st[i][j] += kv[i] * qv[j];
            dpt[i][j] += vv[i] * ov[j];
          }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int kr = ty * 4 + i;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int qr = tx + 16 * j;
          float p = 0.f, ds = 0.f;
          if (q0 + qr < S &&
              visible(a, k0 + kr, qpos_s[qr], qseg_s[qr], qend_s[qr], kpos_s[kr], kseg_s[kr])) {
            p = expf(st[i][j] * a.scale - lse_s[qr]);
            ds = p * (dpt[i][j] - d_s[qr]) * a.scale;
          }
          pt_s[kr * PP + qr] = p;
          dst_s[kr * PP + qr] = ds;
        }
      }
      __syncthreads();

#pragma unroll 4
      for (int qr = 0; qr < BQ; ++qr) {
        float pv[4], dsv[4], ov[CPT], qv[CPT];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          pv[i] = pt_s[(ty * 4 + i) * PP + qr];
          dsv[i] = dst_s[(ty * 4 + i) * PP + qr];
        }
#pragma unroll
        for (int cc = 0; cc < CPT; ++cc) {
          ov[cc] = do_s[qr * QP + tx + 16 * cc];
          qv[cc] = q_s[qr * QP + tx + 16 * cc];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int cc = 0; cc < CPT; ++cc) {
            dv[i][cc] += pv[i] * ov[cc];
            dk[i][cc] += dsv[i] * qv[cc];
          }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int key = k0 + ty * 4 + i;
    if (key >= Sk) continue;
#pragma unroll
    for (int c = 0; c < CPT; ++c) {
      const size_t off = ((static_cast<size_t>(bi) * Sk + key) * Hkv + kvh) * DH + tx + 16 * c;
      a.out0[off] = __float2bfloat16(dk[i][c]);
      a.out1[off] = __float2bfloat16(dv[i][c]);
    }
  }
}

enum class Kind { kFwd, kDq, kDkv };

template <int DH>
cudaError_t launch(Kind kind, const Args& a, int B, cudaStream_t stream) {
  void (*fn)(Args);
  size_t smem;
  dim3 grid;
  if (kind == Kind::kFwd) {
    fn = packed_attention_fwd_kernel<DH>;
    smem = fwd_smem<DH>();
    grid = dim3((a.S + BQ - 1) / BQ, a.H, B);
  } else if (kind == Kind::kDq) {
    fn = packed_attention_dq_kernel<DH>;
    smem = dq_smem<DH>();
    grid = dim3((a.S + BQ - 1) / BQ, a.H, B);
  } else {
    fn = packed_attention_dkv_kernel<DH>;
    smem = dkv_smem<DH>();
    grid = dim3((a.Sk + BKV - 1) / BKV, a.Hkv, B);
  }
  cudaError_t err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  fn<<<grid, THREADS, smem, stream>>>(a);
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
