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
// rate (3.35 TB/s). The first version ran one block per (row, KV head),
// 64 blocks on 132 SMs at 8 rows, each walking up to 4096 keys alone, and
// reached 81 GB/s. This one keeps enough blocks and loads in flight:
// - split-KV in one launch: grid (B, KVH, S), S = ceil(W*BS / KS) from the
//   table width (the host never reads `lengths`), KS keys per split (the
//   wrapper's `split_keys`: 256 at BS = 16, more for tables past 64 splits
//   of 256, so S <= 64). A block takes keys [s*KS, min((s+1)*KS, len)) of
//   its row; a split at or past the row's length returns at once and reads
//   nothing. Slots past the length hold scratch page 0 and are never read.
//   Page offsets are 64-bit.
// - each block keeps G query heads of one KV head, so a staged K/V element
//   serves G heads (the TPU wrapper's block-diagonal Wq fold existed only
//   to feed its matrix unit).
// - K/V stay in their own dtype in shared memory (bf16 is not widened), in
//   a ring of 3 stages of 64 keys (2 at 32 KB a stage) filled by 16-byte
//   cp.async copies, the next stages in flight during a tile's products,
//   three block barriers a tile. Each row's 16-byte chunks are
//   XOR-swizzled so a warp's reads fall in distinct banks; keys past the
//   split are zero-filled.
// - scores on CUDA cores: two threads per key, each half of HD, f32 FMAs
//   over the widened 16-byte chunks, 8 heads per pass, joined by a
//   shuffle; the softmax takes one warp per head; PV has each thread own
//   (head, column pair) outputs. At G <= 8 a tile is a few thousand FMAs
//   per block, far under the bytes' time, so tensor cores would buy
//   nothing here.
// - merge in the same launch: with more than one live split, each writes
//   (m_s, l_s, acc_s) to scratch, then __threadfence and an atomicAdd on
//   the (row, KV head)'s counter; the last to arrive resets the counter to
//   0 for the next launch and merges the splits in order s = 0, 1, ...
//   (m = max m_s, l = sum l_s e^(m_s - m), acc likewise, the weights taken
//   once into shared memory), so the result is the same on every call. A
//   row with one live split writes its result directly. p is rounded
//   against the split's running max (the first version: the row's).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kKeys = 64;    // keys per stage (two per lane in the softmax)
constexpr int kGPass = 8;    // query heads per pass of the score loop

// Widen one 16-byte vector of T into 16 / sizeof(T) floats.
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

// Two neighbouring elements of T as floats.
__device__ __forceinline__ float2 pair_f(const float* p) { return *reinterpret_cast<const float2*>(p); }
__device__ __forceinline__ float2 pair_f(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
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

__device__ __forceinline__ float load_f(const float* p) { return *p; }
__device__ __forceinline__ float load_f(const __nv_bfloat16* p) { return __bfloat162float(*p); }

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool copy) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src), "r"(copy ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

template <typename T, int HD>
struct Shape {
  static constexpr int kVec = 16 / sizeof(T);  // elements per 16-byte chunk
  static constexpr int kRv = HD / kVec;        // chunks per key row
  static constexpr int kSwz = kRv < 8 ? kRv - 1 : 7;  // chunk index XOR (key & kSwz)
  static constexpr int kStageBytes = 2 * kKeys * HD * (int)sizeof(T);  // K and V
  static constexpr int kStages = kStageBytes <= 16384 ? 3 : 2;
};

// Shared memory: the K/V ring, then f32 q [G, HD], scores [G, 64],
// acc [G, HD], m, l, alpha [G].
template <typename T, int HD>
__host__ __device__ inline size_t smem_bytes(int G) {
  using S = Shape<T, HD>;
  return (size_t)S::kStages * S::kStageBytes + sizeof(float) * ((size_t)G * (2 * HD + kKeys) + 3 * (size_t)G);
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
    float* __restrict__ scratch,      // [B*KVH, S, G] m, then l, then [B*KVH, S, G, HD] acc
    int* __restrict__ counters,       // [B*KVH], zero between launches
    int H, int KVH, int W, int BS, int KS, float scale) {
  using S = Shape<T, HD>;
  constexpr int VEC = S::kVec, RV = S::kRv;
  static_assert(HD % VEC == 0 && (kKeys * RV) % kThreads == 0, "a stage does not split over the threads");
  constexpr int NV = kKeys * RV / kThreads;  // chunks per thread per stage, each of K and V
  extern __shared__ __align__(16) uint8_t smem_raw[];
  const int b = blockIdx.x, kvh = blockIdx.y, s = blockIdx.z, NS = gridDim.z;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int G = H / KVH;
  const int bk = b * KVH + kvh;
  const int64_t st = (int64_t)bk * G;  // first (b, kvh, g) state slot
  const int len = min(max(lengths[b], 0), W * BS);
  const int live = (len + KS - 1) / KS;  // splits holding keys
  if (s >= max(live, 1)) return;

  if (len == 0) {
    for (int g = tid; g < G; g += kThreads) {
      m_out[st + g] = kNegInf;
      l_out[st + g] = 0.f;
    }
    for (int i = tid; i < G * HD; i += kThreads) acc_out[st * HD + i] = 0.f;
    return;
  }

  T* ring = reinterpret_cast<T*>(smem_raw);
  float* sq = reinterpret_cast<float*>(smem_raw + S::kStages * S::kStageBytes);
  float* ss = sq + G * HD;
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

  const int n_begin = s * KS, n_end = min(n_begin + KS, len);
  const int nt = (n_end - n_begin + kKeys - 1) / kKeys;
  const int64_t tok_stride = (int64_t)KVH * HD;
  const int64_t page_stride = (int64_t)BS * tok_stride;
  const int* row_table = tables + (int64_t)b * W;

  // Stage a tile: chunk e of this thread is key e / RV, chunk e % RV,
  // stored at chunk (e % RV) ^ (key & kSwz) of its row.
  auto issue = [&](int tile) {
    T* sk = ring + (size_t)(tile % S::kStages) * (S::kStageBytes / sizeof(T));
    T* sv = sk + kKeys * HD;
    const int n0 = n_begin + tile * kKeys;
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int e = tid + i * kThreads;
      const int j = e / RV, c = e % RV;
      const int n = n0 + j;
      const bool in = n < n_end;
      int64_t off = 0;
      if (in) off = (int64_t)row_table[n / BS] * page_stride + (int64_t)(n % BS) * tok_stride + (int64_t)kvh * HD + c * VEC;
      const int dst = j * HD + ((c ^ (j & S::kSwz)) * VEC);
      cp_async16(sk + dst, k_pages + off, in);
      cp_async16(sv + dst, v_pages + off, in);
    }
  };
#pragma unroll
  for (int t = 0; t < S::kStages - 1; ++t) {
    if (t < nt) issue(t);
    cp_async_commit();
  }
  __syncthreads();  // q, acc, m, l staged

  const int jk = tid / 2, half = tid % 2;  // score loop: key jk, columns of this half
  for (int tile = 0; tile < nt; ++tile) {
    cp_async_wait<S::kStages - 2>();  // this thread's copies of `tile` have landed
    // Every thread's copies of `tile` are in, and every thread is past the
    // previous tile's PV: its stage may take the next copy.
    __syncthreads();
    if (tile + S::kStages - 1 < nt) issue(tile + S::kStages - 1);
    cp_async_commit();
    const T* sk = ring + (size_t)(tile % S::kStages) * (S::kStageBytes / sizeof(T));
    const T* sv = sk + kKeys * HD;
    const int nk = min(kKeys, n_end - n_begin - tile * kKeys);

    // Scores: the thread pair of key jk splits HD in halves.
    for (int g0 = 0; g0 < G; g0 += kGPass) {
      float dot[kGPass];
#pragma unroll
      for (int x = 0; x < kGPass; ++x) dot[x] = 0.f;
#pragma unroll
      for (int cc = 0; cc < RV / 2; ++cc) {
        const int c = half * (RV / 2) + cc;
        float kf[VEC];
        widen(*reinterpret_cast<const uint4*>(sk + jk * HD + ((c ^ (jk & S::kSwz)) * VEC)), kf, T());
#pragma unroll
        for (int x = 0; x < kGPass; ++x) {
          if (g0 + x < G) {
            const float* qr = sq + (g0 + x) * HD + c * VEC;
#pragma unroll
            for (int y = 0; y < VEC; ++y) dot[x] = fmaf(qr[y], kf[y], dot[x]);
          }
        }
      }
#pragma unroll
      for (int x = 0; x < kGPass; ++x) {
        const float d = dot[x] + __shfl_xor_sync(0xffffffffu, dot[x], 1);
        if (half == (x & 1) && g0 + x < G) ss[(g0 + x) * kKeys + jk] = jk < nk ? d * scale : kNegInf;
      }
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

    // PV: output pair (g, 2d, 2d+1) per thread per pass.
    for (int i = tid; i < G * HD / 2; i += kThreads) {
      const int g = i / (HD / 2), d = 2 * (i % (HD / 2));
      const int c = d / VEC, x = d % VEC;
      const float* pr = ss + g * kKeys;
      float2 a = *reinterpret_cast<float2*>(sacc + g * HD + d);
      const float al = sa[g];
      a.x *= al;
      a.y *= al;
      for (int j = 0; j < nk; ++j) {
        const float2 v = pair_f(sv + j * HD + ((c ^ (j & S::kSwz)) * VEC) + x);
        a.x = fmaf(pr[j], v.x, a.x);
        a.y = fmaf(pr[j], v.y, a.y);
      }
      *reinterpret_cast<float2*>(sacc + g * HD + d) = a;
    }
  }
  __syncthreads();

  if (live == 1) {
    for (int g = tid; g < G; g += kThreads) {
      m_out[st + g] = sm[g];
      l_out[st + g] = sl[g];
    }
    for (int i = tid; i < G * HD; i += kThreads) acc_out[st * HD + i] = sacc[i];
    return;
  }

  // Several live splits: leave this one's partials, then the last to
  // arrive merges them all.
  const int NSG = NS * G;
  float* sc_m = scratch;
  float* sc_l = scratch + (size_t)gridDim.x * gridDim.y * NSG;
  float* sc_acc = sc_l + (size_t)gridDim.x * gridDim.y * NSG;
  const int64_t slot = (int64_t)bk * NSG;  // this (row, KV head)'s first split slot
  for (int g = tid; g < G; g += kThreads) {
    sc_m[slot + s * G + g] = sm[g];
    sc_l[slot + s * G + g] = sl[g];
  }
  for (int i = tid; i < G * HD; i += kThreads) sc_acc[(slot + s * G) * HD + i] = sacc[i];
  __threadfence();
  __syncthreads();
  __shared__ int last;
  if (tid == 0) {
    last = atomicAdd(&counters[bk], 1) == live - 1;
    if (last) counters[bk] = 0;  // ready for the next launch
  }
  __syncthreads();
  if (!last) return;
  __threadfence();

  // The merge: m = max m_s, then each split's weight e^(m_s - m) once, in
  // the score tile (free now; live <= kKeys splits, see the entry point),
  // then l and acc as weighted sums, each thread's loads independent.
  float* w = ss;
  for (int g = tid; g < G; g += kThreads) {
    float m = kNegInf;
    for (int x = 0; x < live; ++x) m = fmaxf(m, __ldcg(sc_m + slot + x * G + g));
    sm[g] = m;
    m_out[st + g] = m;
  }
  __syncthreads();
  for (int i = tid; i < live * G; i += kThreads) w[i] = expf(__ldcg(sc_m + slot + i) - sm[i % G]);
  __syncthreads();
  for (int g = tid; g < G; g += kThreads) {
    float l = 0.f;
    for (int x = 0; x < live; ++x) l += __ldcg(sc_l + slot + x * G + g) * w[x * G + g];
    l_out[st + g] = l;
  }
  for (int i = tid; i < G * HD; i += kThreads) {
    const int g = i / HD;
    float a = 0.f;
#pragma unroll 4
    for (int x = 0; x < live; ++x) a += __ldcg(sc_acc + (slot + x * G) * HD + i) * w[x * G + g];
    acc_out[st * HD + i] = a;
  }
}

template <typename T, int HD>
cudaError_t launch_hd(const void* q, const void* k_pages, const void* v_pages, const int* tables,
                      const int* lengths, float* m, float* l, float* acc, float* scratch, int* counters, int B,
                      int H, int KVH, int W, int BS, int KS, int NS, cudaStream_t stream) {
  const size_t smem = smem_bytes<T, HD>(H / KVH);
  // The attribute is per function; raised only when a larger G needs it
  // (a driver call on every launch costs the host as much as the kernel).
  static size_t opted_in = 48 * 1024;
  if (smem > opted_in) {
    cudaError_t e = cudaFuncSetAttribute(paged_decode_kernel<T, HD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
    opted_in = smem;
  }
  const dim3 grid(B, KVH, NS);
  paged_decode_kernel<T, HD><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_pages), static_cast<const T*>(v_pages),
      tables, lengths, m, l, acc, scratch, counters, H, KVH, W, BS, KS, rsqrtf((float)HD));
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(int HD, const void* q, const void* kp, const void* vp, const int* t, const int* n, float* m,
                   float* l, float* acc, float* scratch, int* counters, int B, int H, int KVH, int W, int BS,
                   int KS, int NS, cudaStream_t s) {
  switch (HD) {
    case 16: return launch_hd<T, 16>(q, kp, vp, t, n, m, l, acc, scratch, counters, B, H, KVH, W, BS, KS, NS, s);
    case 32: return launch_hd<T, 32>(q, kp, vp, t, n, m, l, acc, scratch, counters, B, H, KVH, W, BS, KS, NS, s);
    case 64: return launch_hd<T, 64>(q, kp, vp, t, n, m, l, acc, scratch, counters, B, H, KVH, W, BS, KS, NS, s);
    case 128: return launch_hd<T, 128>(q, kp, vp, t, n, m, l, acc, scratch, counters, B, H, KVH, W, BS, KS, NS, s);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
size_t smem_for(int G, int HD) {
  switch (HD) {
    case 16: return smem_bytes<T, 16>(G);
    case 32: return smem_bytes<T, 32>(G);
    case 64: return smem_bytes<T, 64>(G);
    case 128: return smem_bytes<T, 128>(G);
    default: return 0;
  }
}

}  // namespace

extern "C" {

// Shared-memory bytes one block needs (dtype 0 = float32, 1 = bfloat16);
// the wrapper refuses shapes past the card's per-block limit before
// launching. 0 for a head dim the kernel does not take.
size_t dtt_paged_decode_partials_smem(int dtype, int G, int HD) {
  return dtype == 0 ? smem_for<float>(G, HD) : smem_for<__nv_bfloat16>(G, HD);
}

// dtype: 0 = float32, 1 = bfloat16; HD in {16, 32, 64, 128}. KS keys per
// split, NS = ceil(W*BS / KS) splits (1 to 64); `scratch` holds
// B*KVH*NS*G*(HD + 2) floats (unread when NS = 1) and `counters` B*KVH
// ints that are 0 before the launch (and are again after it). Returns
// cudaGetLastError() after the launch (0 = success); launches on `stream`
// and does not synchronise.
int dtt_paged_decode_partials(int dtype, const void* q, const void* k_pages, const void* v_pages,
                              const void* tables, const void* lengths, void* m, void* l, void* acc,
                              void* scratch, void* counters, int B, int H, int KVH, int HD, int W, int BS,
                              int KS, int NS, void* stream) {
  if (B == 0) return 0;
  // NS <= kKeys: the merge keeps one weight per split and head in the
  // [G, kKeys] score tile.
  if (KVH <= 0 || H % KVH != 0 || BS <= 0 || W < 0 || KS <= 0 || NS < 1 || NS > kKeys)
    return (int)cudaErrorInvalidValue;
  const int* t = static_cast<const int*>(tables);
  const int* n = static_cast<const int*>(lengths);
  float* mf = static_cast<float*>(m);
  float* lf = static_cast<float*>(l);
  float* af = static_cast<float*>(acc);
  float* sc = static_cast<float*>(scratch);
  int* ct = static_cast<int*>(counters);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(HD, q, k_pages, v_pages, t, n, mf, lf, af, sc, ct, B, H, KVH, W, BS, KS, NS, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(HD, q, k_pages, v_pages, t, n, mf, lf, af, sc, ct, B, H, KVH, W, BS, KS, NS, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
