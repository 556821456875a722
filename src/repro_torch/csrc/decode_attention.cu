// Split-KV decode attention for Hopper (sm_90a), forward only.
//
// Replaces the Pallas kernel `_stage1_kernel` / `decode_attention_pallas` of
// src/repro/kernels/decode_attention.py together with its stage-2 combine
// (plain XLA there, lines 130-136), in one launch.
//
//   out[b, h] = softmax over cache rows p in [start[b], len[b]) of
//               q[b, h] . k[b, p, h // G] / sqrt(dh), applied to v
//   in f32 (the Pallas kernel casts q, k and v to f32); an empty window
//   gives finite zeros.
//
// What bounds it on the H100: one query token per head against the cache,
// 4*dh flops per (head, cache row) against 2*dh*2 bytes per (kv head, cache
// row): about G flops per byte, far under the CUDA cores' f32 rate per byte
// of device memory, so bytes and latency bound it, not arithmetic.  The
// bytes this run needs are the cache rows inside the rows' windows, which
// the kernel reads once each.
//
// Design:
//   * One block per (split of the cache, kv head, row); the n_splits <= 8
//     splits of one (row, kv head) form a thread-block cluster.  A split is
//     `split` cache rows (128, widened to a multiple of 128 so that a
//     cluster holds at most 8 blocks); the last one is masked, so any Smax
//     is taken.  A split runs in chunks of CHUNK rows, merged by the
//     online-softmax rescale (one chunk at split = 128).
//   * Per chunk, the window's K rows and then its V rows are copied into
//     shared memory with 16-byte cp.async in two commit groups: V arrives
//     while the scores run.  A split wholly outside its row's window reads
//     no cache row.
//   * Scores: each key's dot product is spread over 16 lanes of 8 dims each
//     (q of those dims for all G heads in registers) and summed by shuffles.
//     Per head the chunk's max, p = exp(s - max) and l = sum p are taken
//     over the window's rows only (the mask before the max and after exp).
//   * P V: each thread owns 8 consecutive dims and every KG-th key of the
//     chunk; the KG key groups' partial sums are added in shared memory in
//     a fixed order.  No thread runs a chain over every key.
//   * The cluster combines the splits' (m, l, o) through distributed shared
//     memory with the online-softmax rescale (each block a slice of the
//     outputs, its remote reads issued together), divides by l clamped at
//     1e-20 and writes bf16.  Every block, even one with no row of the
//     window, takes part in both cluster barriers, so none leaves while the
//     combine reads its shared memory.
//   No partials go to device memory; the wrapper allocates only the output.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int THREADS = 128;
constexpr int CHUNK = 128;         // cache rows in shared memory at a time
constexpr int MAX_SPLITS = 8;      // blocks per cluster (the portable limit)
constexpr int GMAX = 16;           // query heads per kv head, at most
constexpr int DMAX = 128;          // head dim, at most
constexpr int LPK = 16;            // lanes per key in the scores, 8 dims each
constexpr int KG = THREADS / LPK;  // key groups in P V (a thread owns 8 dims)
constexpr float NEG_INF = -1e30f;

struct Args {
  const __nv_bfloat16* q;   // [B, H, dh]
  const __nv_bfloat16* kc;  // [B, Smax, Hkv, dh]
  const __nv_bfloat16* vc;
  const int* len;
  const int* start;
  __nv_bfloat16* out;  // [B, H, dh]
  int Smax, H, Hkv, dh, split;
  float scale;
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)), "l"(src));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// 8 bf16 (16 bytes) widened to f32: bf16 is f32's upper half
__device__ __forceinline__ void widen8(const uint4& u, float (&f)[8]) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

// Rows [c0, c1) of one kv head's cache (row p at src + p * stride) into a
// [CHUNK][DP] tile at row p - c0.  16-byte cp.async where the rows allow it
// (dh a multiple of 8, the caches 16-byte aligned); else plain loads.  The
// columns past dh are zero either way, so q's zeros there meet no NaN.
__device__ __forceinline__ void load_rows(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                          size_t stride, int c0, int c1, int dh, int DP,
                                          bool vec) {
  const int tid = threadIdx.x;
  if (vec) {
    const int ch = dh / 8;
    for (int i = tid; i < (c1 - c0) * ch; i += THREADS) {
      const int p = c0 + i / ch, c = i % ch;
      cp_async16(dst + (p - c0) * DP + 8 * c, src + p * stride + 8 * c);
    }
  } else {
    for (int i = tid; i < (c1 - c0) * DP; i += THREADS) {
      const int p = c0 + i / DP, d = i % DP;
      dst[(p - c0) * DP + d] = d < dh ? src[p * stride + d] : __float2bfloat16(0.f);
    }
  }
}

// The P V partials [KG][G][dh] f32 reuse the K tile (no longer read once the
// scores are taken) where they fit: G <= 8.
__host__ __device__ constexpr bool red_in_k(int G, int dh) {
  return sizeof(float) * KG * G * dh <= sizeof(__nv_bfloat16) * CHUNK * ((dh + 7) / 8 * 8);
}

// Dynamic shared memory of one block: K and V tiles, the chunk's scores,
// the split's o and, where they do not fit the K tile, the P V partials
// (68.6 KB at G = 3, dh = 128: three blocks an SM).
__host__ __device__ constexpr size_t smem_bytes(int G, int dh) {
  return 2 * sizeof(__nv_bfloat16) * CHUNK * ((dh + 7) / 8 * 8) +
         sizeof(float) * (G * CHUNK + G * dh + (red_in_k(G, dh) ? 0 : KG * G * dh));
}

template <int GP>  // G rounded up to a power of two
__global__ void __launch_bounds__(THREADS) decode_attention_kernel(Args a) {
  constexpr int PVG = GP < 4 ? GP : 4;  // heads per P V pass
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float m_s[GMAX], l_s[GMAX], r_s[GMAX];
  __shared__ float alpha_s[GMAX][MAX_SPLITS], inv_l_s[GMAX];

  cg::cluster_group cluster = cg::this_cluster();
  const int sp = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int G = a.H / a.Hkv, dh = a.dh;
  const int DP = (dh + 7) / 8 * 8;  // a tile row, in bf16
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int s0 = sp * a.split;
  const int k_lo = max(s0, a.start[b]);
  const int k_hi = min(min(s0 + a.split, a.Smax), a.len[b]);

  __nv_bfloat16* k_s = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* v_s = k_s + CHUNK * DP;
  float* s_s = reinterpret_cast<float*>(v_s + CHUNK * DP);  // [G][CHUNK] scores, then p
  float* o_s = s_s + G * CHUNK;                             // [G][dh] the split's o
  float* red_s = red_in_k(G, dh) ? reinterpret_cast<float*>(k_s)  // [KG][G][dh] P V partials
                                 : o_s + G * dh;

  for (int i = tid; i < G * dh; i += THREADS) o_s[i] = 0.f;
  if (tid < G) {
    m_s[tid] = NEG_INF;
    l_s[tid] = 0.f;
  }

  const size_t stride = static_cast<size_t>(a.Hkv) * dh;
  const size_t head0 =
      static_cast<size_t>(b) * a.Smax * a.Hkv * dh + static_cast<size_t>(kvh) * dh;
  const bool vec = dh % 8 == 0 &&
                   ((reinterpret_cast<uintptr_t>(a.kc) | reinterpret_cast<uintptr_t>(a.vc) |
                     reinterpret_cast<uintptr_t>(a.q)) & 15) == 0;

  // scores: this lane's 8 dims of q for every head of the kv head
  const int sub = lane % LPK, d0 = 8 * sub;
  float qr[GP][8];
#pragma unroll
  for (int g = 0; g < GP; ++g) {
    const __nv_bfloat16* qg = a.q + (static_cast<size_t>(b) * a.H + kvh * G + g) * dh;
    if (g < G && vec && d0 < dh) {
      widen8(*reinterpret_cast<const uint4*>(qg + d0), qr[g]);
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j)
        qr[g][j] = (g < G && d0 + j < dh) ? __bfloat162float(qg[d0 + j]) : 0.f;
    }
  }
  // P V: this thread's 8 dims and key group
  const int pv_d0 = 8 * (tid % LPK), kg = tid / LPK;

  for (int c0 = k_lo; c0 < k_hi; c0 += CHUNK) {
    const int c1 = min(c0 + CHUNK, k_hi);
    __syncthreads();  // the previous chunk's tiles and partials are no longer read
    load_rows(k_s, a.kc + head0, stride, c0, c1, dh, DP, vec);
    cp_async_commit();
    load_rows(v_s, a.vc + head0, stride, c0, c1, dh, DP, vec);
    cp_async_commit();
    cp_async_wait<1>();  // this thread's K copies
    __syncthreads();

    // scores: a key per LPK lanes, every lane of a warp in every pass
    for (int base = c0 + warp * (32 / LPK); base < c1; base += THREADS / LPK) {
      const int p = base + lane / LPK;
      const bool ok = p < c1;
      float kf[8];
      if (ok && d0 < dh) {
        widen8(*reinterpret_cast<const uint4*>(k_s + (p - c0) * DP + d0), kf);
      } else {
#pragma unroll
        for (int j = 0; j < 8; ++j) kf[j] = 0.f;
      }
#pragma unroll
      for (int g = 0; g < GP; ++g) {
        if (g >= G) break;  // uniform over the block
        float s = 0.f;
#pragma unroll
        for (int j = 0; j < 8; ++j) s = fmaf(qr[g][j], kf[j], s);
#pragma unroll
        for (int off = LPK / 2; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
        if (ok && sub == 0) s_s[g * CHUNK + (p - c0)] = s * a.scale;
      }
    }
    __syncthreads();

    // per head (a warp each): the chunk's max, p = exp(s - m) and l = sum p
    // over the window's rows, merged into the split's running (m, l); the
    // split's o rescales by r_s
    for (int g = warp; g < G; g += THREADS / 32) {
      float* sg = s_s + g * CHUNK;
      float mx = NEG_INF;
      for (int p = lane; p < c1 - c0; p += 32) mx = fmaxf(mx, sg[p]);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m_s[g], mx);
      float sum = 0.f;
      for (int p = lane; p < c1 - c0; p += 32) {
        const float e = expf(sg[p] - m_new);
        sg[p] = e;
        sum += e;
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
      if (lane == 0) {
        const float r = expf(m_s[g] - m_new);  // 0 on the first chunk, where o and l are 0
        l_s[g] = l_s[g] * r + sum;
        m_s[g] = m_new;
        r_s[g] = r;
      }
    }
    cp_async_wait<0>();  // this thread's V copies
    __syncthreads();

    // P V: 8 dims x every KG-th key of the chunk per thread, PVG heads at a
    // time (q's registers stay live across the chunks)
    for (int g0 = 0; g0 < G && pv_d0 < dh; g0 += PVG) {
      float acc[PVG][8];
#pragma unroll
      for (int g = 0; g < PVG; ++g)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[g][j] = 0.f;
      for (int p = c0 + kg; p < c1; p += KG) {
        float vf[8];
        widen8(*reinterpret_cast<const uint4*>(v_s + (p - c0) * DP + pv_d0), vf);
#pragma unroll
        for (int g = 0; g < PVG; ++g) {
          const float pg = g0 + g < G ? s_s[(g0 + g) * CHUNK + (p - c0)] : 0.f;
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[g][j] = fmaf(pg, vf[j], acc[g][j]);
        }
      }
#pragma unroll
      for (int g = 0; g < PVG; ++g) {
        if (g0 + g >= G) break;
        float* dst = red_s + (kg * G + g0 + g) * dh + pv_d0;
        if (dh % 8 == 0) {
          float4* d4 = reinterpret_cast<float4*>(dst);
          d4[0] = make_float4(acc[g][0], acc[g][1], acc[g][2], acc[g][3]);
          d4[1] = make_float4(acc[g][4], acc[g][5], acc[g][6], acc[g][7]);
        } else {
#pragma unroll
          for (int j = 0; j < 8; ++j)
            if (pv_d0 + j < dh) dst[j] = acc[g][j];
        }
      }
    }
    __syncthreads();
    // the key groups' partials in order, merged into the split's o
    for (int i = tid; i < G * dh; i += THREADS) {
      float s = 0.f;
      for (int q = 0; q < KG; ++q) s += red_s[q * G * dh + i];
      o_s[i] = o_s[i] * r_s[i / dh] + s;
    }
  }

  // the cluster's splits combined (the Pallas wrapper's stage 2): each
  // block takes a slice of the G x dh outputs; every remote read of a
  // thread is issued at once (the loops over the splits unroll)
  cluster.sync();
  const int n = static_cast<int>(cluster.num_blocks());
  if (tid < G) {
    float m[MAX_SPLITS], l[MAX_SPLITS];
#pragma unroll
    for (int r = 0; r < MAX_SPLITS; ++r) {
      m[r] = r < n ? cluster.map_shared_rank(m_s, r)[tid] : NEG_INF;
      l[r] = r < n ? cluster.map_shared_rank(l_s, r)[tid] : 0.f;
    }
    float m_star = NEG_INF;
#pragma unroll
    for (int r = 0; r < MAX_SPLITS; ++r) m_star = fmaxf(m_star, m[r]);
    float l_star = 0.f;
#pragma unroll
    for (int r = 0; r < MAX_SPLITS; ++r) {
      const float alpha = expf(m[r] - m_star);  // 0 for the padding splits
      alpha_s[tid][r] = alpha;
      l_star += l[r] * alpha;
    }
    inv_l_s[tid] = fmaxf(l_star, 1e-20f);
  }
  __syncthreads();
  const int per = (G * dh + n - 1) / n;
  const int i0 = static_cast<int>(cluster.block_rank()) * per;
  for (int i = i0 + tid; i < min(i0 + per, G * dh); i += THREADS) {
    const int g = i / dh;
    float o[MAX_SPLITS];
#pragma unroll
    for (int r = 0; r < MAX_SPLITS; ++r) o[r] = r < n ? cluster.map_shared_rank(o_s, r)[i] : 0.f;
    float acc = 0.f;
#pragma unroll
    for (int r = 0; r < MAX_SPLITS; ++r) acc += o[r] * alpha_s[g][r];
    a.out[(static_cast<size_t>(b) * a.H + kvh * G + g) * dh + i % dh] =
        __float2bfloat16(acc / inv_l_s[g]);
  }
  cluster.sync();  // no block leaves while another reads its shared memory
}

template <int GP>
cudaError_t launch(const Args& a, int n_splits, int B, cudaStream_t st) {
  const int G = a.H / a.Hkv;
  const size_t smem = smem_bytes(G, a.dh);
  static bool raised = false;  // the largest size this instantiation takes, once
  if (!raised) {
    const cudaError_t err =
        cudaFuncSetAttribute(decode_attention_kernel<GP>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem_bytes(GP, DMAX) + sizeof(float) * KG * GP *
                                              DMAX));
    if (err != cudaSuccess) return err;
    raised = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(n_splits, a.Hkv, B);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = n_splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, decode_attention_kernel<GP>, a);
}

}  // namespace

// q [B, 1, H, dh] bf16, k/v caches [B, Smax, Hkv, dh] bf16, len/start [B]
// int32 -> out [B, 1, H, dh] bf16; all contiguous on one device.  `split`
// is the split size; it is widened to a multiple of itself so that the
// splits of one (row, kv head) are at most MAX_SPLITS.  One launch.
extern "C" int decode_attention_fwd(const void* q, const void* kc, const void* vc,
                                    const void* len, const void* start, void* out, int B,
                                    int Smax, int H, int Hkv, int dh, int split, void* stream) {
  if (B <= 0 || Smax <= 0 || Hkv <= 0 || H % Hkv != 0 || H / Hkv > GMAX || dh <= 0 ||
      dh > DMAX || split <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  int n_splits = (Smax + split - 1) / split;
  if (n_splits > MAX_SPLITS) {
    split *= (n_splits + MAX_SPLITS - 1) / MAX_SPLITS;
    n_splits = (Smax + split - 1) / split;
  }
  Args a;
  a.q = static_cast<const __nv_bfloat16*>(q);
  a.kc = static_cast<const __nv_bfloat16*>(kc);
  a.vc = static_cast<const __nv_bfloat16*>(vc);
  a.len = static_cast<const int*>(len);
  a.start = static_cast<const int*>(start);
  a.out = static_cast<__nv_bfloat16*>(out);
  a.Smax = Smax;
  a.H = H;
  a.Hkv = Hkv;
  a.dh = dh;
  a.split = split;
  a.scale = static_cast<float>(1.0 / sqrt(static_cast<double>(dh)));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int G = H / Hkv;
  cudaError_t err;
  if (G <= 1)
    err = launch<1>(a, n_splits, B, st);
  else if (G <= 2)
    err = launch<2>(a, n_splits, B, st);
  else if (G <= 4)
    err = launch<4>(a, n_splits, B, st);
  else if (G <= 8)
    err = launch<8>(a, n_splits, B, st);
  else
    err = launch<16>(a, n_splits, B, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* decode_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
