// Ragged paged attention for Hopper (sm_90a), CUDA C++ with a plain C entry
// point loaded through ctypes.
//
// Replaces the TPU Pallas kernel `_mega_kernel`
// (dynamo_tpu/engine/attention/megakernel.py, launched by
// `ragged_paged_attention`). One launch serves a whole step's ragged batch:
// every query row attends, under one online softmax, over
//   1. its row's paged prefix: pages tables[meta[0,nq], w], key positions
//      < meta[1,nq] (capped at W*BS), then
//   2. the fresh keys k_extra[meta[2,nq] : meta[3,nq]] (the causal frontier).
// Dead queries (meta[4,nq] == 0) read nothing and write zeros. The result is
// acc / max(l, 1e-30) in q's dtype; scores are scaled by HD^-0.5 and masked
// with -1e30, as in the TPU kernel.
//
// What bounds it on this card: attention over a paged cache moves far more
// bytes than it does operations per byte (one query row reads every key of
// its context once), so the roofline bound is the memory rate. This first
// version is the simple, right design, not yet a fast one:
// - grid (NQ, KVH): one block per (query, KV head) owns the G = H/KVH query
//   heads of that KV head side by side, so each K/V element staged in shared
//   memory serves G heads. This takes the place of the TPU kernel's
//   block-diagonal GQA fold, which existed only to feed a 128x128 matrix unit.
// - The TPU grid's sequential (query, page) axis, which carried the softmax
//   state across grid steps in VMEM scratch, becomes a loop inside the block
//   over the row's pages, then over the fresh keys in tiles of BS; m, l and
//   acc stay in f32 in shared memory.
// - The loop is bounded by the true prefix length, never by the table width:
//   table slots past it hold scratch page 0.
// - Page offsets are computed in 64 bits: a layer-flat pool L*N*BS*KVH*HD
//   overflows int32 at large caches.
// - p stays in f32 for the PV product (the TPU kernel casts p to v's dtype
//   first), so in bf16 the two differ by at most p's bf16 rounding.
// Each block re-reads its row's pages from L2/HBM, and the products run on
// CUDA cores; wgmma, TMA, query tiling and split-KV are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kThreads = 128;

template <typename T>
__device__ __forceinline__ float load_f(const T* p);
template <>
__device__ __forceinline__ float load_f<float>(const float* p) {
  return *p;
}
template <>
__device__ __forceinline__ float load_f<__nv_bfloat16>(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

struct Smem {
  float* q;      // [G][HD]
  float* k;      // [BS][HD + 1] (padded: threads of one warp read distinct rows)
  float* v;      // [BS][HD]
  float* s;      // [G][BS] scores, then probabilities
  float* acc;    // [G][HD]
  float* m;      // [G]
  float* l;      // [G]
  float* alpha;  // [G]
};

__host__ __device__ inline size_t smem_floats(int G, int HD, int BS) {
  return (size_t)G * HD + (size_t)BS * (HD + 1) + (size_t)BS * HD + (size_t)G * BS +
         (size_t)G * HD + 3 * (size_t)G;
}

// Fold the first n_valid rows of the staged K/V tile into the online
// softmax state. Rows past n_valid are masked and never read.
__device__ void fold_tile(const Smem& sm, int G, int HD, int BS, int n_valid, float scale) {
  const int tid = threadIdx.x;
  for (int i = tid; i < G * BS; i += blockDim.x) {
    const int g = i / BS, t = i - g * BS;
    float s = kNegInf;
    if (t < n_valid) {
      const float* qr = sm.q + g * HD;
      const float* kr = sm.k + t * (HD + 1);
      float dot = 0.f;
      for (int d = 0; d < HD; ++d) dot = fmaf(qr[d], kr[d], dot);
      s = dot * scale;
    }
    sm.s[i] = s;
  }
  __syncthreads();
  for (int g = tid; g < G; g += blockDim.x) {
    float* sr = sm.s + g * BS;
    const float m_prev = sm.m[g];
    float m_new = m_prev;
    for (int t = 0; t < BS; ++t) m_new = fmaxf(m_new, sr[t]);
    float sum = 0.f;
    for (int t = 0; t < BS; ++t) {
      const float p = expf(sr[t] - m_new);
      sr[t] = p;
      sum += p;
    }
    const float a = expf(m_prev - m_new);
    sm.alpha[g] = a;
    sm.m[g] = m_new;
    sm.l[g] = sm.l[g] * a + sum;
  }
  __syncthreads();
  for (int i = tid; i < G * HD; i += blockDim.x) {
    const int g = i / HD, d = i - g * HD;
    const float* pr = sm.s + g * BS;
    float a = sm.acc[i] * sm.alpha[g];
    for (int t = 0; t < n_valid; ++t) a = fmaf(pr[t], sm.v[t * HD + d], a);
    sm.acc[i] = a;
  }
  __syncthreads();
}

template <typename T>
__global__ void __launch_bounds__(kThreads) ragged_paged_attention_kernel(
    const T* __restrict__ q,        // [NQ, H, HD]
    const T* __restrict__ k_extra,  // [CK, KVH, HD]
    const T* __restrict__ v_extra,  // [CK, KVH, HD]
    const T* __restrict__ k_pages,  // [NP, BS, KVH, HD]
    const T* __restrict__ v_pages,  // [NP, BS, KVH, HD]
    const int* __restrict__ tables, // [R, W]
    const int* __restrict__ meta,   // [5, NQ]
    T* __restrict__ out,            // [NQ, H, HD]
    int NQ, int H, int KVH, int HD, int CK, int W, int BS, float scale) {
  extern __shared__ float smem[];
  const int nq = blockIdx.x, kvh = blockIdx.y, tid = threadIdx.x;
  const int G = H / KVH;
  // The G query heads of KV head kvh are contiguous: [nq, kvh*G .. kvh*G+G).
  const int64_t q_off = ((int64_t)nq * H + (int64_t)kvh * G) * HD;

  if (meta[4 * NQ + nq] == 0) {
    for (int i = tid; i < G * HD; i += blockDim.x) out[q_off + i] = from_f<T>(0.f);
    return;
  }
  const int row = meta[nq];
  const int prefix_len = min(meta[NQ + nq], W * BS);
  const int e_start = max(meta[2 * NQ + nq], 0);
  const int e_end = min(meta[3 * NQ + nq], CK);

  Smem sm;
  sm.q = smem;
  sm.k = sm.q + G * HD;
  sm.v = sm.k + BS * (HD + 1);
  sm.s = sm.v + BS * HD;
  sm.acc = sm.s + G * BS;
  sm.m = sm.acc + G * HD;
  sm.l = sm.m + G;
  sm.alpha = sm.l + G;

  for (int i = tid; i < G * HD; i += blockDim.x) {
    sm.q[i] = load_f(q + q_off + i);
    sm.acc[i] = 0.f;
  }
  for (int g = tid; g < G; g += blockDim.x) {
    sm.m[g] = kNegInf;
    sm.l[g] = 0.f;
  }
  __syncthreads();

  const int64_t tok_stride = (int64_t)KVH * HD;  // one token's K row, all heads
  const int64_t page_stride = (int64_t)BS * tok_stride;
  const int64_t head_off = (int64_t)kvh * HD;

  // 1. Paged prefix, bounded by the true prefix length.
  const int n_pages = prefix_len > 0 ? (prefix_len + BS - 1) / BS : 0;
  for (int w = 0; w < n_pages; ++w) {
    const int64_t page = tables[(int64_t)row * W + w];
    const int64_t base = page * page_stride + head_off;
    const int n_valid = min(BS, prefix_len - w * BS);
    for (int i = tid; i < n_valid * HD; i += blockDim.x) {
      const int t = i / HD, d = i - t * HD;
      const int64_t off = base + t * tok_stride + d;
      sm.k[t * (HD + 1) + d] = load_f(k_pages + off);
      sm.v[t * HD + d] = load_f(v_pages + off);
    }
    __syncthreads();
    fold_tile(sm, G, HD, BS, n_valid, scale);
  }

  // 2. Fresh keys [e_start, e_end), in tiles of BS.
  for (int c0 = e_start; c0 < e_end; c0 += BS) {
    const int n_valid = min(BS, e_end - c0);
    for (int i = tid; i < n_valid * HD; i += blockDim.x) {
      const int t = i / HD, d = i - t * HD;
      const int64_t off = (int64_t)(c0 + t) * tok_stride + head_off + d;
      sm.k[t * (HD + 1) + d] = load_f(k_extra + off);
      sm.v[t * HD + d] = load_f(v_extra + off);
    }
    __syncthreads();
    fold_tile(sm, G, HD, BS, n_valid, scale);
  }

  for (int i = tid; i < G * HD; i += blockDim.x) {
    const int g = i / HD;
    out[q_off + i] = from_f<T>(sm.acc[i] / fmaxf(sm.l[g], 1e-30f));
  }
}

template <typename T>
cudaError_t launch(const void* q, const void* k_extra, const void* v_extra,
                   const void* k_pages, const void* v_pages, const int* tables,
                   const int* meta, void* out, int NQ, int H, int KVH, int HD,
                   int CK, int W, int BS, cudaStream_t stream) {
  const size_t smem = smem_floats(H / KVH, HD, BS) * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(ragged_paged_attention_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
    if (e != cudaSuccess) return e;
  }
  const dim3 grid(NQ, KVH);
  ragged_paged_attention_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_extra),
      static_cast<const T*>(v_extra), static_cast<const T*>(k_pages),
      static_cast<const T*>(v_pages), tables, meta, static_cast<T*>(out), NQ, H,
      KVH, HD, CK, W, BS, rsqrtf((float)HD));
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Shared-memory bytes one block needs; the wrapper refuses shapes past the
// card's per-block limit before launching.
size_t dtt_ragged_paged_attention_smem(int G, int HD, int BS) {
  return smem_floats(G, HD, BS) * sizeof(float);
}

// dtype: 0 = float32, 1 = bfloat16. Returns cudaGetLastError() after the
// launch (0 = success). Launches on `stream` and does not synchronise.
int dtt_ragged_paged_attention(int dtype, const void* q, const void* k_extra,
                               const void* v_extra, const void* k_pages,
                               const void* v_pages, const void* tables,
                               const void* meta, void* out, int NQ, int H, int KVH,
                               int HD, int CK, int W, int BS, void* stream) {
  if (NQ == 0) return 0;
  const int* t = static_cast<const int*>(tables);
  const int* m = static_cast<const int*>(meta);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(q, k_extra, v_extra, k_pages, v_pages, t, m, out, NQ, H, KVH, HD,
                         CK, W, BS, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k_extra, v_extra, k_pages, v_pages, t, m, out, NQ, H,
                                 KVH, HD, CK, W, BS, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
