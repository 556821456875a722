// Split-KV decode attention for Hopper (sm_90a), forward only.
//
// Replaces the Pallas kernel `_stage1_kernel` / `decode_attention_pallas` of
// src/repro/kernels/decode_attention.py, and its stage-2 combine (plain XLA
// there, lines 130-136) with a second small kernel.
//
//   out[b, h] = softmax over cache rows p in [start[b], len[b]) of
//               q[b, h] . k[b, p, h // G] / sqrt(dh), applied to v
//   an empty window gives finite zeros.
//
// What bounds it on the H100: one query token per head against the cache,
// 4*dh flops per (head, cache row) against 2*dh*2 bytes per (kv head, cache
// row): bytes bound.  The bytes this run needs are the cache rows inside the
// rows' windows, which the kernel reads once each.
//
// Design:
//   * Stage 1: one block per (split of SPLIT cache rows, kv head, row).  A
//     split that lies wholly outside its row's window writes (m = -1e30,
//     l = 0, o = 0) and reads nothing.  Otherwise a warp per cache row forms
//     the G dot products with coalesced loads and shuffles; the window is
//     masked before the max and again after exp, so a masked row never
//     enters l; then one thread per head dimension sums p @ v.  Any Smax is
//     taken: the last split is masked, not required to divide Smax.
//   * Stage 2: one block per (head, row) combines the splits with the
//     online-softmax rescale and divides by l clamped at 1e-20.
//   The partials are f32 scratch the caller allocates.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int THREADS = 128;
constexpr int MAX_SPLIT = 128;  // cache rows per stage-1 block, at most
constexpr int GMAX = 16;        // query heads per kv head, at most
constexpr int DMAX = 128;       // head dim, at most
constexpr float NEG_INF = -1e30f;

__global__ void __launch_bounds__(THREADS)
decode_stage1_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ kc,
                     const __nv_bfloat16* __restrict__ vc, const int* __restrict__ len,
                     const int* __restrict__ start, float* __restrict__ o_part,
                     float* __restrict__ m_part, float* __restrict__ l_part, int Smax, int H,
                     int Hkv, int dh, int split, int n_splits, float scale) {
  __shared__ float q_s[GMAX][DMAX];
  __shared__ float p_s[GMAX][MAX_SPLIT];
  __shared__ float m_s[GMAX];
  __shared__ float l_s[GMAX];

  const int sp = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int G = H / Hkv;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const size_t part = (static_cast<size_t>(b) * Hkv + kvh) * n_splits + sp;
  const int s0 = sp * split;
  const int k_lo = max(s0, start[b]);
  const int k_hi = min(min(s0 + split, Smax), len[b]);

  if (k_lo >= k_hi) {  // nothing of this split is in the row's window
    for (int i = tid; i < G * dh; i += THREADS) o_part[part * G * dh + i] = 0.f;
    for (int g = tid; g < G; g += THREADS) {
      m_part[part * G + g] = NEG_INF;
      l_part[part * G + g] = 0.f;
    }
    return;
  }

  for (int i = tid; i < G * dh; i += THREADS) {
    const int g = i / dh, d = i % dh;
    q_s[g][d] = __bfloat162float(q[(static_cast<size_t>(b) * H + kvh * G + g) * dh + d]);
  }
  __syncthreads();

  // scores: one warp per cache row
  for (int key = k_lo + warp; key < k_hi; key += THREADS / 32) {
    const __nv_bfloat16* kr = kc + ((static_cast<size_t>(b) * Smax + key) * Hkv + kvh) * dh;
    float dot[GMAX];
#pragma unroll
    for (int g = 0; g < GMAX; ++g) dot[g] = 0.f;
    for (int d = lane; d < dh; d += 32) {
      const float kv = __bfloat162float(kr[d]);
#pragma unroll
      for (int g = 0; g < GMAX; ++g)
        if (g < G) dot[g] += q_s[g][d] * kv;
    }
#pragma unroll
    for (int g = 0; g < GMAX; ++g) {
      if (g >= G) break;
      float s = dot[g];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
      if (lane == 0) p_s[g][key - s0] = s * scale;
    }
  }
  __syncthreads();

  // max over the window, p = exp(s - m) inside it, l = sum p: one warp per head
  for (int g = warp; g < G; g += THREADS / 32) {
    float mx = NEG_INF;
    for (int key = k_lo + lane; key < k_hi; key += 32) mx = fmaxf(mx, p_s[g][key - s0]);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    float sum = 0.f;
    for (int key = k_lo + lane; key < k_hi; key += 32) {
      const float p = expf(p_s[g][key - s0] - mx);
      p_s[g][key - s0] = p;
      sum += p;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
    if (lane == 0) {
      m_s[g] = mx;
      l_s[g] = sum;
    }
  }
  __syncthreads();

  // partial output p @ v: one thread per head dimension
  for (int d = tid; d < dh; d += THREADS) {
    float acc[GMAX];
#pragma unroll
    for (int g = 0; g < GMAX; ++g) acc[g] = 0.f;
    for (int key = k_lo; key < k_hi; ++key) {
      const float vv =
          __bfloat162float(vc[((static_cast<size_t>(b) * Smax + key) * Hkv + kvh) * dh + d]);
#pragma unroll
      for (int g = 0; g < GMAX; ++g)
        if (g < G) acc[g] += p_s[g][key - s0] * vv;
    }
#pragma unroll
    for (int g = 0; g < GMAX; ++g)
      if (g < G) o_part[(part * G + g) * dh + d] = acc[g];
  }
  for (int g = tid; g < G; g += THREADS) {
    m_part[part * G + g] = m_s[g];
    l_part[part * G + g] = l_s[g];
  }
}

__global__ void decode_stage2_kernel(const float* __restrict__ o_part,
                                     const float* __restrict__ m_part,
                                     const float* __restrict__ l_part,
                                     __nv_bfloat16* __restrict__ out, int H, int Hkv, int dh,
                                     int n_splits) {
  const int h = blockIdx.x, b = blockIdx.y, d = threadIdx.x;
  const int G = H / Hkv, kvh = h / G, g = h % G;
  const size_t base = (static_cast<size_t>(b) * Hkv + kvh) * n_splits;
  float m_star = NEG_INF;
  for (int sp = 0; sp < n_splits; ++sp) m_star = fmaxf(m_star, m_part[(base + sp) * G + g]);
  float l_star = 0.f, acc = 0.f;
  for (int sp = 0; sp < n_splits; ++sp) {
    const size_t i = (base + sp) * G + g;
    const float alpha = expf(m_part[i] - m_star);
    l_star += l_part[i] * alpha;
    acc += o_part[i * dh + d] * alpha;
  }
  out[(static_cast<size_t>(b) * H + h) * dh + d] = __float2bfloat16(acc / fmaxf(l_star, 1e-20f));
}

}  // namespace

// q [B, 1, H, dh] bf16, k/v caches [B, Smax, Hkv, dh] bf16, len/start [B] int32,
// scratch o_part [B, Hkv, n_splits, G, dh], m_part/l_part [B, Hkv, n_splits, G]
// f32 with n_splits = ceil(Smax / split) -> out [B, 1, H, dh] bf16.
extern "C" int decode_attention_fwd(const void* q, const void* kc, const void* vc,
                                    const void* len, const void* start, void* o_part,
                                    void* m_part, void* l_part, void* out, int B, int Smax,
                                    int H, int Hkv, int dh, int split, void* stream) {
  if (B <= 0 || Smax <= 0 || Hkv <= 0 || H % Hkv != 0 || H / Hkv > GMAX || dh <= 0 ||
      dh > DMAX || split <= 0 || split > MAX_SPLIT)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int n_splits = (Smax + split - 1) / split;
  const float scale = static_cast<float>(1.0 / sqrt(static_cast<double>(dh)));
  decode_stage1_kernel<<<dim3(n_splits, Hkv, B), THREADS, 0, st>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(kc),
      static_cast<const __nv_bfloat16*>(vc), static_cast<const int*>(len),
      static_cast<const int*>(start), static_cast<float*>(o_part), static_cast<float*>(m_part),
      static_cast<float*>(l_part), Smax, H, Hkv, dh, split, n_splits, scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  decode_stage2_kernel<<<dim3(H, B), dh, 0, st>>>(
      static_cast<const float*>(o_part), static_cast<const float*>(m_part),
      static_cast<const float*>(l_part), static_cast<__nv_bfloat16*>(out), H, Hkv, dh, n_splits);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* decode_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
