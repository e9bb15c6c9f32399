// Paged flash-decode partials for Hopper (sm_90a), CUDA C++ with a plain C
// entry point loaded through ctypes.
//
// Replaces the TPU Pallas kernel `_paged_kernel`
// (dynamo_tpu/engine/attention/decode.py, launched by
// `paged_decode_partials`). One query per row (the current decode token)
// attends the row's cached prefix through its block table: key positions
// < min(lengths[b], W*BS), pages tables[b, w]. The result is the
// UNnormalized online-softmax state (m, l, acc) in f32, merged with the
// current token's piece outside the kernel. A row of length 0 returns
// m = -1e30 (finite, the TPU kernel's initial value), l = 0 and acc = 0, and
// drops out of that merge. Scores are scaled by HD^-0.5; p is rounded to v's
// dtype before the PV product (as the TPU kernel does), l sums it unrounded.
//
// What bounds it on this card: one query reads every key of its context
// once, two multiply-adds per element read, so the bound is the memory
// rate. This first version is the simple, right design:
// - grid (B, KVH): one block per (row, KV head) owns the G query heads of
//   that KV head, so each staged K/V element serves G heads. This takes the
//   place of the TPU wrapper's block-diagonal Wq fold and merged-lane
//   reshape, which existed only to feed the TPU's matrix unit.
// - the TPU grid's sequential page axis, which carried the softmax state in
//   VMEM across grid steps, becomes a loop inside the block over tiles of 64
//   keys (several pages). A tile's K and V are loaded as 16-byte vectors
//   into registers, all in flight together, and the next tile's loads are
//   issued before the current tile's products, so the products hide them.
// - the loop is bounded by the true length (and by W*BS), never by the
//   table width: slots past the length hold scratch page 0 and are never
//   read. Page offsets are 64-bit: a layer-flat pool L*N*BS*KVH*HD overflows
//   int32 at large caches.
// Split-KV across blocks (more blocks than B*KVH for long contexts), TMA and
// wgmma are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kKeys = 64;  // keys per staged tile (two per lane in the softmax)

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
__device__ __forceinline__ float round_to(float x);
template <>
__device__ __forceinline__ float round_to<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ float round_to<__nv_bfloat16>(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

// Widen one 16-byte vector of T into VEC floats.
__device__ __forceinline__ void widen(const uint4& raw, float* out, float) {
  out[0] = __uint_as_float(raw.x);
  out[1] = __uint_as_float(raw.y);
  out[2] = __uint_as_float(raw.z);
  out[3] = __uint_as_float(raw.w);
}
__device__ __forceinline__ void widen(const uint4& raw, float* out, __nv_bfloat16) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}

__host__ __device__ inline size_t smem_floats(int G, int HD) {
  return (size_t)G * HD             // q
         + (size_t)kKeys * (HD + 1) // K tile (padded: a warp reads distinct rows)
         + (size_t)kKeys * HD       // V tile
         + (size_t)G * kKeys        // scores, then p
         + (size_t)G * HD           // acc
         + 3 * (size_t)G;           // m, l, alpha
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads) paged_decode_kernel(
    const T* __restrict__ q,          // [B, H, HD]
    const T* __restrict__ k_pages,    // [NP, BS, KVH, HD]
    const T* __restrict__ v_pages,    // [NP, BS, KVH, HD]
    const int* __restrict__ tables,   // [B, W]
    const int* __restrict__ lengths,  // [B]
    float* __restrict__ m_out,        // [B, KVH, G]
    float* __restrict__ l_out,        // [B, KVH, G]
    float* __restrict__ acc_out,      // [B, KVH, G, HD]
    int H, int KVH, int W, int BS, float scale) {
  constexpr int VEC = 16 / sizeof(T);       // elements per 16-byte vector
  constexpr int RV = HD / VEC;              // vectors per key row of one head
  constexpr int NV = kKeys * RV / kThreads; // vectors per thread per tile, each of K and V
  static_assert(HD % VEC == 0 && (kKeys * RV) % kThreads == 0, "tile does not split over the threads");
  constexpr int KS = HD + 1;
  extern __shared__ float smem[];
  const int b = blockIdx.x, kvh = blockIdx.y;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int G = H / KVH;
  const int64_t st = ((int64_t)b * KVH + kvh) * G;  // first (b, kvh, g) state slot
  const int len = min(max(lengths[b], 0), W * BS);

  if (len == 0) {
    for (int g = tid; g < G; g += kThreads) {
      m_out[st + g] = kNegInf;
      l_out[st + g] = 0.f;
    }
    for (int i = tid; i < G * HD; i += kThreads) acc_out[st * HD + i] = 0.f;
    return;
  }

  float* sq = smem;
  float* sk = sq + G * HD;
  float* sv = sk + kKeys * KS;
  float* ss = sv + kKeys * HD;
  float* sacc = ss + G * kKeys;
  float* sm = sacc + G * HD;
  float* sl = sm + G;
  float* sa = sl + G;

  // The G query heads of KV head kvh are contiguous: q[b, kvh*G .. kvh*G+G).
  const T* qb = q + ((int64_t)b * H + (int64_t)kvh * G) * HD;
  for (int i = tid; i < G * HD; i += kThreads) {
    sq[i] = load_f(qb + i);
    sacc[i] = 0.f;
  }
  for (int g = tid; g < G; g += kThreads) {
    sm[g] = kNegInf;
    sl[g] = 0.f;
  }

  const int64_t tok_stride = (int64_t)KVH * HD;
  const int64_t page_stride = (int64_t)BS * tok_stride;
  const int* row_table = tables + (int64_t)b * W;

  // Registers holding one tile's K and V vectors; vector i of this thread
  // is key (tid + i*kThreads) / RV, columns ((tid + i*kThreads) % RV)*VEC.
  uint4 rk[NV], rv[NV];
  auto load_tile = [&](int n0) {
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int e = tid + i * kThreads;
      const int j = e / RV, c = e % RV;
      const int n = n0 + j;
      rk[i] = rv[i] = make_uint4(0u, 0u, 0u, 0u);
      if (n < len) {
        const int64_t off = (int64_t)row_table[n / BS] * page_stride + (int64_t)(n % BS) * tok_stride +
                            (int64_t)kvh * HD + c * VEC;
        rk[i] = *reinterpret_cast<const uint4*>(k_pages + off);
        rv[i] = *reinterpret_cast<const uint4*>(v_pages + off);
      }
    }
  };
  load_tile(0);

  for (int n0 = 0; n0 < len; n0 += kKeys) {
    const int nk = min(kKeys, len - n0);
    __syncthreads();  // the previous tile's products are done with K, V and the scores
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int e = tid + i * kThreads;
      const int j = e / RV, c = e % RV;
      float fk[VEC], fv[VEC];
      widen(rk[i], fk, T());
      widen(rv[i], fv, T());
#pragma unroll
      for (int x = 0; x < VEC; ++x) {
        sk[j * KS + c * VEC + x] = fk[x];
        sv[j * HD + c * VEC + x] = fv[x];
      }
    }
    __syncthreads();
    if (n0 + kKeys < len) load_tile(n0 + kKeys);  // in flight during this tile's products

    for (int i = tid; i < G * kKeys; i += kThreads) {
      const int g = i / kKeys, j = i - g * kKeys;
      float s = kNegInf;
      if (j < nk) {
        const float* qr = sq + g * HD;
        const float* kr = sk + j * KS;
        float dot = 0.f;
#pragma unroll 16
        for (int d = 0; d < HD; ++d) dot = fmaf(qr[d], kr[d], dot);
        s = dot * scale;
      }
      ss[i] = s;
    }
    __syncthreads();

    // Online-softmax update, one warp per head; keys past nk get p = 0.
    for (int g = warp; g < G; g += kWarps) {
      float* sr = ss + g * kKeys;
      const float x0 = sr[lane], x1 = sr[lane + 32];
      float mx = fmaxf(x0, x1);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_prev = sm[g];
      const float m_new = fmaxf(m_prev, mx);
      const float p0 = lane < nk ? expf(x0 - m_new) : 0.f;
      const float p1 = lane + 32 < nk ? expf(x1 - m_new) : 0.f;
      float sum = p0 + p1;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
      sr[lane] = round_to<T>(p0);
      sr[lane + 32] = round_to<T>(p1);
      if (lane == 0) {
        const float a = expf(m_prev - m_new);
        sa[g] = a;
        sm[g] = m_new;
        sl[g] = sl[g] * a + sum;
      }
    }
    __syncthreads();

    for (int i = tid; i < G * HD; i += kThreads) {
      const int g = i / HD, d = i - g * HD;
      const float* pr = ss + g * kKeys;
      float a = sacc[i] * sa[g];
      for (int j = 0; j < nk; ++j) a = fmaf(pr[j], sv[j * HD + d], a);
      sacc[i] = a;
    }
  }
  __syncthreads();

  for (int g = tid; g < G; g += kThreads) {
    m_out[st + g] = sm[g];
    l_out[st + g] = sl[g];
  }
  for (int i = tid; i < G * HD; i += kThreads) acc_out[st * HD + i] = sacc[i];
}

template <typename T, int HD>
cudaError_t launch_hd(const void* q, const void* k_pages, const void* v_pages, const int* tables,
                      const int* lengths, float* m, float* l, float* acc, int B, int H, int KVH,
                      int W, int BS, cudaStream_t stream) {
  const size_t smem = smem_floats(H / KVH, HD) * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(paged_decode_kernel<T, HD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  const dim3 grid(B, KVH);
  paged_decode_kernel<T, HD><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_pages), static_cast<const T*>(v_pages),
      tables, lengths, m, l, acc, H, KVH, W, BS, rsqrtf((float)HD));
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* q, const void* k_pages, const void* v_pages, const int* tables,
                   const int* lengths, float* m, float* l, float* acc, int B, int H, int KVH,
                   int HD, int W, int BS, cudaStream_t s) {
  switch (HD) {
    case 16: return launch_hd<T, 16>(q, k_pages, v_pages, tables, lengths, m, l, acc, B, H, KVH, W, BS, s);
    case 32: return launch_hd<T, 32>(q, k_pages, v_pages, tables, lengths, m, l, acc, B, H, KVH, W, BS, s);
    case 64: return launch_hd<T, 64>(q, k_pages, v_pages, tables, lengths, m, l, acc, B, H, KVH, W, BS, s);
    case 128: return launch_hd<T, 128>(q, k_pages, v_pages, tables, lengths, m, l, acc, B, H, KVH, W, BS, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// Shared-memory bytes one block needs; the wrapper refuses shapes past the
// card's per-block limit before launching.
size_t dtt_paged_decode_partials_smem(int G, int HD) { return smem_floats(G, HD) * sizeof(float); }

// dtype: 0 = float32, 1 = bfloat16; HD in {16, 32, 64, 128}. Returns
// cudaGetLastError() after the launch (0 = success); launches on `stream`
// and does not synchronise.
int dtt_paged_decode_partials(int dtype, const void* q, const void* k_pages, const void* v_pages,
                              const void* tables, const void* lengths, void* m, void* l, void* acc,
                              int B, int H, int KVH, int HD, int W, int BS, void* stream) {
  if (B == 0) return 0;
  if (KVH <= 0 || H % KVH != 0 || BS <= 0 || W < 0) return (int)cudaErrorInvalidValue;
  const int* t = static_cast<const int*>(tables);
  const int* n = static_cast<const int*>(lengths);
  float* mf = static_cast<float*>(m);
  float* lf = static_cast<float*>(l);
  float* af = static_cast<float*>(acc);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(q, k_pages, v_pages, t, n, mf, lf, af, B, H, KVH, HD, W, BS, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k_pages, v_pages, t, n, mf, lf, af, B, H, KVH, HD, W, BS, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
