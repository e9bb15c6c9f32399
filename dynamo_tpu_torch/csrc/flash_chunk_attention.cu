// Flash chunk attention for Hopper (sm_90a), CUDA C++ with a plain C entry
// point loaded through ctypes.
//
// Replaces the TPU Pallas kernel `_chunk_kernel`
// (dynamo_tpu/engine/attention/prefill.py, launched by
// `flash_chunk_attention`). Causal self-attention inside one prefill chunk
// with grouped-query heads: query t sees key j iff j <= t and j < valid_len,
// so padded queries (t >= valid_len) attend every valid key and return real
// numbers. Returns the normalized output acc / max(l, 1e-30) in q's dtype and
// the online-softmax state (m, l) in f32 per (query, head), m in natural-log
// units of the scaled scores (HD^-0.5), for a cached-prefix piece to merge
// with outside the kernel. Masking uses the finite -1e30 of the TPU kernel;
// p is rounded to v's dtype before the PV product (as the TPU kernel does),
// while l sums it unrounded.
//
// What bounds it on this card: at the chunk sizes prefill uses (T 512-2048)
// a causal chunk does ~T/2 multiply-adds per byte it reads, so the bound is
// the arithmetic rate. This first version runs the products on CUDA cores in
// f32; wgmma (the tensor cores) and TMA are later work. Its design:
// - grid (query tiles, KVH): a block owns 64 query rows, i.e. 64/G queries
//   times the G query heads of one KV head, so every K/V element staged in
//   shared memory serves G heads (the TPU kernel's grouped-query rows, read
//   straight from the [T, H, HD] / [T, KVH, HD] layouts without the JAX
//   wrapper's head-major transposes, which existed for the TPU's MXU).
// - the block walks K/V tiles of 64 keys up to its queries' causal frontier
//   (and valid_len), never past it: the upper triangle is not computed.
// - 256 threads as a 16x16 grid; each thread keeps a 4x4 tile of scores and
//   a 4x(HD/16) tile of the f32 accumulator in registers, so each value read
//   from shared memory feeds 4 multiply-adds. Row strides are padded by one
//   float so a warp's reads fall in distinct banks.
// - a K/V tile is loaded as 16-byte vectors into registers, and the next
//   tile's loads are issued before the current tile's products.
// - the online-softmax update takes one warp per row (shuffle reductions).
// - the latest query tiles, which walk the most keys, are scheduled first.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 64;  // query rows (query, grouped head) per block
constexpr int kKeys = 64;  // keys per staged K/V tile (two per lane in the softmax)

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

// x rounded to T and back: the cast of p to v's dtype.
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  const T y = from_f<T>(x);
  return load_f(&y);
}

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

__host__ __device__ inline size_t smem_floats(int HD) {
  return (size_t)kRows * (HD + 1)     // q tile
         + (size_t)kKeys * (HD + 1)   // K tile
         + (size_t)kKeys * HD         // V tile
         + (size_t)kRows * (kKeys + 1)  // scores, then p
         + 3 * (size_t)kRows;         // m, l, alpha
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads) flash_chunk_kernel(
    const T* __restrict__ q,      // [T, H, HD]
    const T* __restrict__ k,      // [T, KVH, HD]
    const T* __restrict__ v,      // [T, KVH, HD]
    T* __restrict__ out,          // [T, H, HD]
    float* __restrict__ m_out,    // [T, KVH, G]
    float* __restrict__ l_out,    // [T, KVH, G]
    int T_, int H, int KVH, int valid_len, float scale) {
  static_assert(HD % 16 == 0, "HD must be a multiple of 16");
  static_assert(kKeys == 64 && kRows == 64, "the thread layout assumes 64x64 tiles");
  constexpr int QS = HD + 1;     // padded row stride of the q and K tiles
  constexpr int SS = kKeys + 1;  // padded row stride of the score tile
  constexpr int DJ = HD / 16;    // accumulator columns per thread
  constexpr int VEC = 16 / sizeof(T);  // elements per 16-byte vector
  constexpr int RV = HD / VEC;         // vectors per key row of one head
  constexpr int NV = (kKeys * RV + kThreads - 1) / kThreads;  // per thread per tile, each of K and V
  extern __shared__ float smem[];
  float* sq = smem;
  float* sk = sq + kRows * QS;
  float* sv = sk + kKeys * QS;
  float* ss = sv + kKeys * HD;
  float* sm = ss + kRows * SS;
  float* sl = sm + kRows;
  float* sa = sl + kRows;

  const int G = H / KVH;
  const int BQ = kRows / G;  // queries per block; rows BQ*G .. 63 stay unused
  const int rows = BQ * G;
  const int kvh = blockIdx.y;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;  // latest tiles first
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int tr = tid / 16, tc = tid % 16;  // thread's rows tr+16i, columns tc+16j

  // Stage the tile's queries: row r is query q0 + r/G, head kvh*G + r%G; the
  // G rows of one query are contiguous in q.
  for (int i = tid; i < kRows * HD; i += kThreads) {
    const int r = i / HD, d = i - r * HD;
    const int t = q0 + r / G;
    float x = 0.f;
    if (r < rows && t < T_) x = load_f(q + ((int64_t)t * H + (int64_t)kvh * G + r % G) * HD + d);
    sq[r * QS + d] = x;
  }
  for (int r = tid; r < kRows; r += kThreads) {
    sm[r] = kNegInf;
    sl[r] = 0.f;
  }
  float acc[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = 0.f;
  int row_t[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) row_t[i] = q0 + (tr + 16 * i) / G;

  // Keys this tile needs: up to its last query's causal frontier, and
  // never past valid_len.
  const int t_last = min(q0 + BQ, T_) - 1;
  const int n_keys = min(t_last + 1, valid_len);

  // Registers holding one K/V tile; vector i of this thread is key
  // (tid + i*kThreads) / RV, columns ((tid + i*kThreads) % RV)*VEC.
  uint4 rk[NV], rv[NV];
  auto load_tile = [&](int k0) {
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int e = tid + i * kThreads;
      const int j = e / RV, c = e % RV;
      rk[i] = rv[i] = make_uint4(0u, 0u, 0u, 0u);
      if (e < kKeys * RV && k0 + j < n_keys) {
        const int64_t off = ((int64_t)(k0 + j) * KVH + kvh) * HD + c * VEC;
        rk[i] = *reinterpret_cast<const uint4*>(k + off);
        rv[i] = *reinterpret_cast<const uint4*>(v + off);
      }
    }
  };
  load_tile(0);

  for (int k0 = 0; k0 < n_keys; k0 += kKeys) {
    const int nk = min(kKeys, n_keys - k0);
    __syncthreads();  // the previous tile's products are done with K, V and the scores
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int e = tid + i * kThreads;
      if (e < kKeys * RV) {
        const int j = e / RV, c = e % RV;
        float fk[VEC], fv[VEC];
        widen(rk[i], fk, T());
        widen(rv[i], fv, T());
#pragma unroll
        for (int x = 0; x < VEC; ++x) {
          sk[j * QS + c * VEC + x] = fk[x];
          sv[j * HD + c * VEC + x] = fv[x];
        }
      }
    }
    __syncthreads();
    if (k0 + kKeys < n_keys) load_tile(k0 + kKeys);  // in flight during this tile's products

    // Scores of the thread's 4x4 (row, key) tile.
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < HD; ++d) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = sq[(tr + 16 * i) * QS + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = sk[(tc + 16 * j) * QS + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(a[i], b[j], s[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int key = k0 + tc + 16 * j;
        const bool seen = (tc + 16 * j) < nk && key <= row_t[i] && key < valid_len;
        ss[(tr + 16 * i) * SS + tc + 16 * j] = seen ? s[i][j] * scale : kNegInf;
      }
    __syncthreads();

    // Online-softmax update, one warp per row.
    for (int r = warp; r < kRows; r += kWarps) {
      float* sr = ss + r * SS;
      const float x0 = sr[lane], x1 = sr[lane + 32];
      float mx = fmaxf(x0, x1);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_prev = sm[r];
      const float m_new = fmaxf(m_prev, mx);
      const float p0 = expf(x0 - m_new), p1 = expf(x1 - m_new);
      float sum = p0 + p1;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
      sr[lane] = round_to<T>(p0);
      sr[lane + 32] = round_to<T>(p1);
      if (lane == 0) {
        const float a = expf(m_prev - m_new);
        sa[r] = a;
        sm[r] = m_new;
        sl[r] = sl[r] * a + sum;
      }
    }
    __syncthreads();

    // Rescale the accumulator and add this tile's PV product.
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float a = sa[tr + 16 * i];
#pragma unroll
      for (int j = 0; j < DJ; ++j) acc[i][j] *= a;
    }
    for (int j = 0; j < nk; ++j) {
      float a[4], b[DJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = ss[(tr + 16 * i) * SS + j];
#pragma unroll
      for (int c = 0; c < DJ; ++c) b[c] = sv[j * HD + tc + 16 * c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < DJ; ++c) acc[i][c] = fmaf(a[i], b[c], acc[i][c]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = tr + 16 * i;
    const int t = row_t[i];
    if (r >= rows || t >= T_) continue;
    const int g = r % G;
    const float l = fmaxf(sl[r], 1e-30f);
    T* o = out + ((int64_t)t * H + (int64_t)kvh * G + g) * HD;
#pragma unroll
    for (int c = 0; c < DJ; ++c) o[tc + 16 * c] = from_f<T>(acc[i][c] / l);
    if (tc == 0) {
      const int64_t st = ((int64_t)t * KVH + kvh) * G + g;
      m_out[st] = sm[r];
      l_out[st] = sl[r];
    }
  }
}

template <typename T, int HD>
cudaError_t launch_hd(const void* q, const void* k, const void* v, void* out, float* m,
                      float* l, int T_, int H, int KVH, int valid_len, cudaStream_t stream) {
  const size_t smem = smem_floats(HD) * sizeof(float);
  static bool opted_in = false;  // the attribute is per function, set once
  if (!opted_in) {
    cudaError_t e = cudaFuncSetAttribute(flash_chunk_kernel<T, HD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
    opted_in = true;
  }
  const int BQ = kRows / (H / KVH);
  const dim3 grid((T_ + BQ - 1) / BQ, KVH);
  flash_chunk_kernel<T, HD><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), m, l, T_, H, KVH, valid_len, rsqrtf((float)HD));
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v, void* out, float* m, float* l,
                   int T_, int H, int KVH, int HD, int valid_len, cudaStream_t s) {
  switch (HD) {
    case 16: return launch_hd<T, 16>(q, k, v, out, m, l, T_, H, KVH, valid_len, s);
    case 32: return launch_hd<T, 32>(q, k, v, out, m, l, T_, H, KVH, valid_len, s);
    case 64: return launch_hd<T, 64>(q, k, v, out, m, l, T_, H, KVH, valid_len, s);
    case 128: return launch_hd<T, 128>(q, k, v, out, m, l, T_, H, KVH, valid_len, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// Shared-memory bytes one block needs at head dim HD.
size_t dtt_flash_chunk_attention_smem(int HD) { return smem_floats(HD) * sizeof(float); }

// dtype: 0 = float32, 1 = bfloat16. Needs H % KVH == 0, G = H/KVH <= 64,
// HD in {16, 32, 64, 128}, 1 <= valid_len <= T, and k and v on 16-byte
// boundaries. Returns
// cudaGetLastError() after the launch (0 = success); launches on `stream`
// and does not synchronise.
int dtt_flash_chunk_attention(int dtype, const void* q, const void* k, const void* v, void* out,
                              void* m, void* l, int T, int H, int KVH, int HD, int valid_len,
                              void* stream) {
  if (T == 0) return 0;
  if (KVH <= 0 || H % KVH != 0 || H / KVH > kRows || valid_len < 1 || valid_len > T)
    return (int)cudaErrorInvalidValue;
  float* mf = static_cast<float*>(m);
  float* lf = static_cast<float*>(l);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(q, k, v, out, mf, lf, T, H, KVH, HD, valid_len, s);
  if (dtype == 1) return launch<__nv_bfloat16>(q, k, v, out, mf, lf, T, H, KVH, HD, valid_len, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
