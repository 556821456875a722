// Packed (segment-masked) flash attention forward for Hopper (sm_90a).
//
// Replaces the Pallas kernel `_fwd_kernel` / `_tile_mask` / `_fwd_call` of
// src/repro/kernels/packed_attention.py (forward; no logsumexp output).
//
//   o[b, s, h] = softmax_k(q[b, s, h] . k[b, k, h // G] / sqrt(dh)) @ v
//   over the keys k visible to query s:
//     (not causal or qpos[s] >= kpos[k])  and  (qseg[s] == kseg[k] or kseg[k] == -1)
//   kseg == -1 marks a wildcard key row (a learned prefix) seen by every
//   query of the batch row; any other negative kseg that no query carries
//   (-2) is seen by none.  A query that sees no key gives 0.
//
// What bounds it on the H100: at the prefill shape (B = 8, S = 512, H = 24,
// dh = 128) the work is 4*dh flops per visible (query, key) pair, about 13
// GFLOP per layer, against 25 MB of q/k/v/o: operations bound.  This first
// version runs the products on the CUDA cores in f32, so it sits far above
// the tensor-core bound; mma/wgmma and TMA come later.
//
// Design: one block per (64-query tile, head, batch row).  It walks the
// 64-key tiles up to the causal frontier (key tile start <= last query
// index + Sk - S, the prefix offset), keeping the online-softmax state
// (m, l) and the f32 output tile in registers.  Each thread owns 4 query
// rows; the 16 threads of a row group reduce max and sum with shuffles.
// Masked scores are -1e30 and p is masked again after exp, so a key that is
// not visible never enters l or the output, and a row with no visible key
// ends with l = 0 -> clamped at 1e-20 -> output 0.  S and Sk need not be
// multiples of 64: the ragged edge is masked.  Scores, softmax and the
// output sum are f32; the output is stored in q's type (bf16).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int BQ = 64;
constexpr int BKV = 64;
constexpr int THREADS = 256;
constexpr float NEG_INF = -1e30f;

template <int DH>
constexpr size_t smem_bytes() {
  return sizeof(float) * (BQ * (DH + 1) + DH * (BKV + 1) + BKV * DH + BQ * (BKV + 1)) +
         sizeof(int) * (2 * BQ + 2 * BKV);
}

template <int DH>
__global__ void __launch_bounds__(THREADS)
packed_attention_fwd_kernel(const __nv_bfloat16* __restrict__ q,
                            const __nv_bfloat16* __restrict__ k,
                            const __nv_bfloat16* __restrict__ v,
                            const int* __restrict__ qpos, const int* __restrict__ qseg,
                            const int* __restrict__ kpos, const int* __restrict__ kseg,
                            __nv_bfloat16* __restrict__ o, int S, int Sk, int H, int Hkv,
                            int causal, float scale) {
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
  int* kpos_s = qseg_s + BQ;
  int* kseg_s = kpos_s + BKV;

  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int bi = blockIdx.z;
  const int kvh = h / (H / Hkv);
  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;

  for (int i = tid; i < BQ * DH; i += THREADS) {
    const int r = i / DH, d = i % DH, s = q0 + r;
    q_s[r * QP + d] =
        s < S ? __bfloat162float(q[((static_cast<size_t>(bi) * S + s) * H + h) * DH + d]) : 0.f;
  }
  for (int i = tid; i < BQ; i += THREADS) {
    const int s = q0 + i;
    qpos_s[i] = s < S ? qpos[static_cast<size_t>(bi) * S + s] : 0;
    qseg_s[i] = s < S ? qseg[static_cast<size_t>(bi) * S + s] : 0;
  }

  float m_i[4], l_i[4], acc[4][CPT];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m_i[i] = NEG_INF;
    l_i[i] = 0.f;
#pragma unroll
    for (int c = 0; c < CPT; ++c) acc[i][c] = 0.f;
  }

  // causal frontier: key tiles that start past the last query of this tile
  // (shifted by the Sk - S leading prefix rows) hold no visible key
  int kv_end = Sk;
  if (causal) kv_end = min(Sk, min(q0 + BQ, S) - 1 + (Sk - S) + 1);

  for (int k0 = 0; k0 < kv_end; k0 += BKV) {
    __syncthreads();  // the previous tile's k, v and p are no longer read
    for (int i = tid; i < BKV * DH; i += THREADS) {
      const int kr = i / DH, d = i % DH, key = k0 + kr;
      const size_t off = ((static_cast<size_t>(bi) * Sk + key) * Hkv + kvh) * DH + d;
      kt_s[d * KP + kr] = key < Sk ? __bfloat162float(k[off]) : 0.f;
      v_s[kr * DH + d] = key < Sk ? __bfloat162float(v[off]) : 0.f;
    }
    for (int i = tid; i < BKV; i += THREADS) {
      const int key = k0 + i;
      kpos_s[i] = key < Sk ? kpos[static_cast<size_t>(bi) * Sk + key] : 0;
      kseg_s[i] = key < Sk ? kseg[static_cast<size_t>(bi) * Sk + key] : 0;
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
        vis[j] = (k0 + c < Sk) && (kseg_s[c] == qseg_s[r] || kseg_s[c] == -1) &&
                 (!causal || qpos_s[r] >= kpos_s[c]);
        s[i][j] = vis[j] ? s[i][j] * scale : NEG_INF;
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
      o[((static_cast<size_t>(bi) * S + s) * H + h) * DH + d] = __float2bfloat16(acc[i][c] / l);
    }
  }
}

template <int DH>
cudaError_t launch(const void* q, const void* k, const void* v, const void* qpos,
                   const void* qseg, const void* kpos, const void* kseg, void* o, int B, int S,
                   int Sk, int H, int Hkv, int causal, cudaStream_t stream) {
  const size_t smem = smem_bytes<DH>();
  cudaError_t err = cudaFuncSetAttribute(packed_attention_fwd_kernel<DH>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const float scale = static_cast<float>(1.0 / sqrt(static_cast<double>(DH)));
  dim3 grid((S + BQ - 1) / BQ, H, B);
  packed_attention_fwd_kernel<DH><<<grid, THREADS, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const int*>(qpos),
      static_cast<const int*>(qseg), static_cast<const int*>(kpos),
      static_cast<const int*>(kseg), static_cast<__nv_bfloat16*>(o), S, Sk, H, Hkv, causal,
      scale);
  return cudaGetLastError();
}

}  // namespace

// q [B, S, H, dh], k/v [B, Sk, Hkv, dh] bf16; qpos/qseg [B, S], kpos/kseg [B, Sk]
// int32 -> o [B, S, H, dh] bf16.  All contiguous.  dh in {64, 128}.
extern "C" int packed_attention_fwd(const void* q, const void* k, const void* v,
                                    const void* qpos, const void* qseg, const void* kpos,
                                    const void* kseg, void* o, int B, int S, int Sk, int H,
                                    int Hkv, int dh, int causal, void* stream) {
  if (B <= 0 || S <= 0 || Sk < S || Hkv <= 0 || H % Hkv != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dh == 128)
    return static_cast<int>(launch<128>(q, k, v, qpos, qseg, kpos, kseg, o, B, S, Sk, H, Hkv, causal, st));
  if (dh == 64)
    return static_cast<int>(launch<64>(q, k, v, qpos, qseg, kpos, kseg, o, B, S, Sk, H, Hkv, causal, st));
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* packed_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
