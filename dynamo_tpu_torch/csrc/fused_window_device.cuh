// Device code shared by the fused decode window (fused_decode_window.cu) and
// the fused spec window (fused_spec_window.cu), both persistent cooperative
// kernels over a dense llama's weights and paged KV cache: the argument
// block, the GEMV building blocks (column tiles of [in, out] weights, row
// tiles of the tied head), RMS norms, rope + K/V write + split paged
// attention, the sampled pick (exact top-k / top-p filter and inverse-CDF
// draw), the timer stamps, and one layer and the head of a one-token step.
// fused_decode_window.cu's header comment describes the design.

#pragma once

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include "attention_tc.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 16;        // output columns (vocab rows, tied head) per GEMV tile
constexpr int kXFloats = 32768;  // staged GEMV input per chunk: B * KC floats (128 KB)
constexpr int kKeys = 64;        // keys per staged attention tile
constexpr int kMaxNV = 8;        // 16-byte K (and V) vectors per thread per tile: HD 128 in f32
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

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

template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return to_f(from_f<T>(x));
}

// Loads of data written inside this kernel: through L2, coherent across SMs.
__device__ __forceinline__ float ld_scratch(const float* p) { return __ldcg(p); }
__device__ __forceinline__ float ld_scratch(const __nv_bfloat16* p) {
  const unsigned short raw = __ldcg(reinterpret_cast<const unsigned short*>(p));
  return __uint_as_float(((unsigned)raw) << 16);
}

// N 32-bit words of T -> floats (bf16: the low half is the first element).
template <typename T, int N>
__device__ __forceinline__ void unpack(const unsigned* w, float* out) {
  if constexpr (sizeof(T) == 4) {
#pragma unroll
    for (int i = 0; i < N; ++i) out[i] = __uint_as_float(w[i]);
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) {
      out[2 * i] = __uint_as_float(w[i] << 16);
      out[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
}

// VEC consecutive weights (4, 8 or 16 bytes, aligned) -> floats, read-only path.
template <typename T, int VEC>
__device__ __forceinline__ void load_w(const T* p, float* out) {
  constexpr int kBytes = VEC * (int)sizeof(T);
  if constexpr (kBytes == 16) {
    const uint4 r = __ldg(reinterpret_cast<const uint4*>(p));
    const unsigned w[4] = {r.x, r.y, r.z, r.w};
    unpack<T, 4>(w, out);
  } else if constexpr (kBytes == 8) {
    const uint2 r = __ldg(reinterpret_cast<const uint2*>(p));
    const unsigned w[2] = {r.x, r.y};
    unpack<T, 2>(w, out);
  } else {
    static_assert(kBytes == 4, "weight vectors are 4, 8 or 16 bytes");
    const unsigned w[1] = {__ldg(reinterpret_cast<const unsigned*>(p))};
    unpack<T, 1>(w, out);
  }
}

// The tensor maps of one model's weights: [L, in, out] as 3-D boxes of 128
// rows x 64 columns (128-byte swizzle), the untied head [D, V] likewise
// (L = 1), or the tied head's embedding [V, D] as boxes of 64 vocab rows x
// 64 of D (K-major, two to a ring slot).
struct TcMaps {
  CUtensorMap wq, wk, wv, wo, wg, wu, wd, head;
};

template <typename T>
struct Args {
  const T* embed;  // [V, D]
  const T* head;   // [D, V], or null: tied, embed read row by row
  const T* fnorm;  // [D]
  const T* anorm;  // [L, D]
  const T* mnorm;  // [L, D]
  const T* wq;     // [L, D, HQ]
  const T* wk;     // [L, D, HKV]
  const T* wv;     // [L, D, HKV]
  const T* wo;     // [L, HQ, D]
  const T* wg;     // [L, D, F]
  const T* wu;     // [L, D, F]
  const T* wd;     // [L, F, D]
  T* kc;           // [L, N, BS, KVH, HD]
  T* vc;
  const int* tokens;     // [B]
  const int* positions;  // [B]
  const int* tables;     // [B, W]
  const int* active;     // [B]
  int* tokens_out;       // [steps, B]
  T* h;                  // [B, D] residual carry
  T* qkv;                // [B, HQ + 2 HKV], before rope
  T* attn;               // [B, HQ]
  float* part_acc;       // [B, KVH, S, G, HD] attention partials per key split
  float* part_ml;        // [B, KVH, S, G, 2]: their (max, sum)
  int* split_cnt;        // [B, KVH] splits done, zero between layers
  T* gu;                 // [B, 2F]: gate | up
  int* tok;              // [B] token carry
  float* part_val;       // [grid, B] per-block argmax partials
  int* part_idx;
  unsigned long long* prof;  // [1 + steps * (5 L + 2)] timer stamps, or null
  const float* temps;    // [B] (0 = greedy), or null: every row greedy
  const int* top_ks;     // [B] (0 = off)
  const float* top_ps;   // [B] (1 = off)
  const float* unif;     // [steps, B] the draws' uniforms
  float* logits;         // [B, V] head logits / temps scratch (sampled only)
  const int* rows0;       // [B] guided FSM rows at window start (0 = allow-all)
  int* grow;              // [B] the rows' carry, and the rows after the window
  const unsigned* mask;   // [P, W32] packed allow bits, or null: no row is guided
  const int* next_pool;   // [P, V] the row after each token
  int steps, L, N, BS, H, KVH, HD, W, D, F, V, S, W32;
  float eps, theta;
  // bf16 products on the tensor cores (unused in f32): one tensor map per
  // weight, each phase's split plan (splits, 64-row boxes per split; see
  // megakernel.product_plan), the splits' f32 partials and the per-tile
  // arrival counters (zero between phases).
  TcMaps maps;
  int plan[5][2];
  float* tc_part;
  int* tc_cnt;
};

// ---------------------------------------------------------------------------
// GEMV building blocks
// ---------------------------------------------------------------------------

template <typename T, int B>
struct Gemv {
  static constexpr int kVecMax = 16 / (int)sizeof(T);
  static constexpr int VEC = kVecMax < 64 / B ? kVecMax : 64 / B;  // columns per thread
  static constexpr int CT = kTile / VEC;                           // threads across a tile
  static constexpr int KG = kThreads / CT;                         // k-rows per pass
  static constexpr int KC = kXFloats / B;                          // staged columns of x
  static_assert(CT >= 1 && CT <= 16 && kTile % VEC == 0, "bad GEMV tiling");
};

__host__ __device__ constexpr size_t gemv_floats(int B) {
  // xs, warp partials, inv, tile logits, best value, best index, guided rows
  return (size_t)kXFloats + (size_t)kWarps * B * kTile + B + (size_t)kTile * B + 3 * (size_t)B;
}

__host__ __device__ inline size_t attn_floats(int G, int HD) {
  return (size_t)G * HD + (size_t)kKeys * (HD + 1) + (size_t)kKeys * HD + (size_t)G * kKeys +
         (size_t)G * HD + 3 * (size_t)G;
}

__host__ __device__ inline size_t smem_floats(int B, int G, int HD) {
  const size_t a = gemv_floats(B), b = attn_floats(G, HD);
  return a > b ? a : b;
}

// Stage x[:, k0 : k0 + kn] as floats: xs[b * KC + k]. Each thread takes
// 16 bytes of an input row at a time (kn and k0 are multiples of 16), so
// its loads are in flight together.
template <typename T, int B, int KC, class X>
__device__ __forceinline__ void stage(float* xs, int k0, int kn, const X& x) {
  constexpr int VEC = 16 / (int)sizeof(T);
  const int nv = kn / VEC;
#pragma unroll 4
  for (int i = threadIdx.x; i < B * nv; i += kThreads) {
    const int b = i / nv, k = (i - b * nv) * VEC;
    float v[VEC];
    x.vec(b, k0 + k, v);
    float4* dst = reinterpret_cast<float4*>(xs + b * KC + k);
#pragma unroll
    for (int j = 0; j < VEC / 4; ++j) dst[j] = make_float4(v[4 * j], v[4 * j + 1], v[4 * j + 2], v[4 * j + 3]);
  }
}

// 16 bytes of T written inside the kernel -> floats, through L2.
template <typename T>
__device__ __forceinline__ void ld_scratch_vec(const T* p, float* out) {
  const uint4 r = __ldcg(reinterpret_cast<const uint4*>(p));
  const unsigned w[4] = {r.x, r.y, r.z, r.w};
  unpack<T, 4>(w, out);
}

// Rows r0 .. r0 + B of a GEMV input with n rows; rows at or past n read as 0.
template <typename T, class X>
struct XRange {
  const X& x;
  int r0, n;
  __device__ void vec(int b, int k, float* out) const {
    if (r0 + b < n) {
      x.vec(r0 + b, k, out);
    } else {
#pragma unroll
      for (int v = 0; v < 16 / (int)sizeof(T); ++v) out[v] = 0.f;
    }
  }
};

// y[b, c] = sum_k x(b, k) * W[k, c] for the n rows b of x, over the column
// tiles t = blockIdx.x, + gridDim.x, ... of a phase. wsel(t, W, ldw, c0)
// gives the tile's weight ([K, ldw] row-major) and first column in it;
// out(b, col, y) takes each result (col over the phase's columns); after(t)
// runs once the tile is out. A decode step has n = B rows, one per register
// accumulator. With kPasses the rows (the spec kernel's verify, n = B
// (gamma + 1)) go in passes of B, the later passes reading the tile from
// L1/L2; without it n is B and the code is the one pass.
template <typename T, int B, bool kPasses = false, class X, class WSel, class Out, class After>
__device__ void gemv_cols(float* smem, int K, int ntiles, int n, const X& x, const WSel& wsel, const Out& out,
                          const After& after) {
  using G = Gemv<T, B>;
  float* xs = smem;
  float* red = smem + kXFloats;  // [kWarps][B][kTile]
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int cx = tid % G::CT, ky = tid / G::CT;
  if (!kPasses) n = B;
  const bool once = n <= B && K <= G::KC;  // one staging serves every tile
  bool staged = false;
  for (int t = blockIdx.x; t < ntiles; t += gridDim.x) {
    const T* W;
    int ldw, c0;
    wsel(t, W, ldw, c0);
    for (int r0 = 0; r0 < (kPasses ? n : B); r0 += B) {
      float acc[B][G::VEC];
#pragma unroll
      for (int b = 0; b < B; ++b)
#pragma unroll
        for (int v = 0; v < G::VEC; ++v) acc[b][v] = 0.f;
      for (int k0 = 0; k0 < K; k0 += G::KC) {
        const int kn = min(G::KC, K - k0);
        if (!(once && staged)) {
          __syncthreads();  // earlier readers of xs are done
          if constexpr (kPasses) {
            stage<T, B, G::KC>(xs, k0, kn, XRange<T, X>{x, r0, n});
          } else {
            stage<T, B, G::KC>(xs, k0, kn, x);
          }
          __syncthreads();
          staged = true;
        }
        const T* wp = W + (int64_t)k0 * ldw + c0 + cx * G::VEC;
#pragma unroll 4
        for (int k = ky; k < kn; k += G::KG) {
          float w[G::VEC];
          load_w<T, G::VEC>(wp + (int64_t)k * ldw, w);
#pragma unroll
          for (int b = 0; b < B; ++b) {
            const float xv = xs[b * G::KC + k];
#pragma unroll
            for (int v = 0; v < G::VEC; ++v) acc[b][v] = fmaf(xv, w[v], acc[b][v]);
          }
        }
      }
      // Reduce over the k-groups: the lanes of a warp with the same cx, then the warps.
#pragma unroll
      for (int b = 0; b < B; ++b)
#pragma unroll
        for (int v = 0; v < G::VEC; ++v) {
          float s = acc[b][v];
#pragma unroll
          for (int o = G::CT; o < 32; o <<= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
          acc[b][v] = s;
        }
      if (lane < G::CT) {
#pragma unroll
        for (int b = 0; b < B; ++b)
#pragma unroll
          for (int v = 0; v < G::VEC; ++v) red[(warp * B + b) * kTile + lane * G::VEC + v] = acc[b][v];
      }
      __syncthreads();
      for (int i = tid; i < B * kTile; i += kThreads) {
        const int b = i / kTile, c = i - b * kTile;
        if (kPasses && r0 + b >= n) continue;
        float s = 0.f;
        for (int w = 0; w < kWarps; ++w) s += red[(w * B + b) * kTile + c];
        out(r0 + b, t * kTile + c, s);
      }
      __syncthreads();
    }
    after(t);
  }
}

// y[b, r] = sum_k x(b, k) * Wr[r, k] for the n rows b of x, over row tiles
// of Wr [ntiles * 16, K] (the tied head: embed rows), with kPasses in
// passes of B rows as gemv_cols. out(b, row, y); after(t) once the tile is
// out.
template <typename T, int B, bool kPasses = false, class X, class Out, class After>
__device__ void gemv_rows(float* smem, const T* Wr, int K, int ntiles, int n, const X& x, const Out& out,
                          const After& after) {
  constexpr int VEC = 16 / (int)sizeof(T);
  constexpr int KC = kXFloats / B;
  float* xs = smem;
  const int tid = threadIdx.x, r = tid / 16, kl = tid % 16;
  if (!kPasses) n = B;
  const bool once = n <= B && K <= KC;
  bool staged = false;
  for (int t = blockIdx.x; t < ntiles; t += gridDim.x) {
    const T* wr = Wr + ((int64_t)t * kTile + r) * K;
    for (int r0 = 0; r0 < (kPasses ? n : B); r0 += B) {
      float acc[B];
#pragma unroll
      for (int b = 0; b < B; ++b) acc[b] = 0.f;
      for (int k0 = 0; k0 < K; k0 += KC) {
        const int kn = min(KC, K - k0);
        if (!(once && staged)) {
          __syncthreads();
          if constexpr (kPasses) {
            stage<T, B, KC>(xs, k0, kn, XRange<T, X>{x, r0, n});
          } else {
            stage<T, B, KC>(xs, k0, kn, x);
          }
          __syncthreads();
          staged = true;
        }
#pragma unroll 2
        for (int k = kl * VEC; k < kn; k += 16 * VEC) {
          float w[VEC];
          load_w<T, VEC>(wr + k0 + k, w);
#pragma unroll
          for (int b = 0; b < B; ++b)
#pragma unroll
            for (int v = 0; v < VEC; ++v) acc[b] = fmaf(xs[b * KC + k + v], w[v], acc[b]);
        }
      }
#pragma unroll
      for (int b = 0; b < B; ++b)
#pragma unroll
        for (int o = 8; o > 0; o >>= 1) acc[b] += __shfl_xor_sync(0xffffffffu, acc[b], o);
      if (kl == 0) {
#pragma unroll
        for (int b = 0; b < B; ++b)
          if (!kPasses || r0 + b < n) out(r0 + b, t * kTile + r, acc[b]);
      }
      __syncthreads();
    }
    after(t);
    __syncthreads();
  }
}

// inv[b] = rsqrt(mean(h[b]^2) + eps) for rows b < n, one warp per row, 16
// bytes per load.
template <typename T>
__device__ void row_inv_rows(const T* h, int n, int D, float eps, float* inv) {
  constexpr int VEC = 16 / (int)sizeof(T);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  __syncthreads();  // the previous phase is done with inv
  for (int b = warp; b < n; b += kWarps) {
    float s = 0.f;
#pragma unroll 4
    for (int d = lane * VEC; d < D; d += 32 * VEC) {
      float x[VEC];
      ld_scratch_vec<T>(h + (int64_t)b * D + d, x);
#pragma unroll
      for (int v = 0; v < VEC; ++v) s = fmaf(x[v], x[v], s);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
    if (lane == 0) inv[b] = rsqrtf(s / (float)D + eps);
  }
  __syncthreads();
}

template <typename T, int B>
__device__ void row_inv(const T* h, int D, float eps, float* inv) {
  row_inv_rows<T>(h, B, D, eps, inv);
}

// GEMV inputs: vec(b, k, out) gives the 16 bytes' worth of elements
// x[b, k : k + 16 / sizeof(T)] as floats.
template <typename T>
struct XNorm {  // RMS-normed residual rows, rounded to T
  static constexpr int VEC = 16 / (int)sizeof(T);
  const T* h;
  int D;
  const float* inv;
  const T* w;
  __device__ void vec(int b, int k, float* out) const {
    float x[VEC], g[VEC];
    ld_scratch_vec<T>(h + (int64_t)b * D + k, x);
    load_w<T, VEC>(w + k, g);
#pragma unroll
    for (int v = 0; v < VEC; ++v) out[v] = round_to<T>(x[v] * inv[b] * g[v]);
  }
};

template <typename T>
struct XRows {  // rows of a scratch matrix [B, K]
  const T* x;
  int K;
  __device__ void vec(int b, int k, float* out) const { ld_scratch_vec<T>(x + (int64_t)b * K + k, out); }
};

template <typename T>
struct XSiluUp {  // silu(gate) * up from gate | up rows [B, 2F], each rounded to T
  static constexpr int VEC = 16 / (int)sizeof(T);
  const T* gu;
  int F;
  __device__ void vec(int b, int k, float* out) const {
    float g[VEC], u[VEC];
    ld_scratch_vec<T>(gu + (int64_t)b * 2 * F + k, g);
    ld_scratch_vec<T>(gu + (int64_t)b * 2 * F + F + k, u);
#pragma unroll
    for (int v = 0; v < VEC; ++v) out[v] = round_to<T>(round_to<T>(g[v] / (1.f + expf(-g[v]))) * u[v]);
  }
};

// GEMV outputs.
template <typename T>
struct OutRows {  // y rounded to T into rows [B, ld]
  T* y;
  int ld;
  __device__ void operator()(int b, int c, float v) const { y[(int64_t)b * ld + c] = from_f<T>(v); }
};

template <typename T>
struct OutResidual {  // h += T(y), in T
  T* h;
  int D;
  __device__ void operator()(int b, int c, float v) const {
    T* p = h + (int64_t)b * D + c;
    *p = from_f<T>(ld_scratch(p) + round_to<T>(v));
  }
};

// The head's logits of this tile, lgs[(c % 16) * B + b], -inf where a
// guided row's FSM row disallows token c (JAX `apply_token_masks`): one
// 32-bit word of the row's allow bits covers the whole 16-column tile, and
// the mask pool is never written in the kernel (read-only path).
template <int B>
struct OutLogits {
  float* lgs;
  const unsigned* mask;  // [P, W32], or null: no row is guided
  const int* rows;       // [B] in shared memory: each row's mask-pool row this step
  int W32;
  __device__ void operator()(int b, int c, float v) const {
    if (mask != nullptr && !((__ldg(mask + (int64_t)rows[b] * W32 + (c >> 5)) >> (c & 31)) & 1u)) v = -INFINITY;
    lgs[(c % kTile) * B + b] = v;
  }
};

template <int B>
struct ArgmaxTile {  // fold a tile's logits into the block's (max, first index) per row
  const float* lgs;
  float* best_v;
  int* best_i;
  float* out;          // [B, V]: the tile's logits / temps[b] are stored here too, or null
  const float* temps;  // [B] (a row with temps <= 0 is stored unscaled)
  int V;
  __device__ void operator()(int t) const {
    if (out != nullptr) {
      for (int e = threadIdx.x; e < B * kTile; e += kThreads) {
        const int b = e / kTile, c = e - b * kTile;
        const float x = lgs[c * B + b], tb = temps[b];
        out[(int64_t)b * V + t * kTile + c] = tb > 0.f ? x / tb : x;  // a division, as JAX scales
      }
    }
    const int b = threadIdx.x;
    if (b >= B) return;
    float bv = best_v[b];
    int bi = best_i[b];
    for (int c = 0; c < kTile; ++c) {  // ascending index: strict > keeps the first maximum
      const float v = lgs[c * B + b];
      if (v > bv) {
        bv = v;
        bi = t * kTile + c;
      }
    }
    best_v[b] = bv;
    best_i[b] = bi;
  }
};

struct NoAfter {
  __device__ void operator()(int) const {}
};

// ---------------------------------------------------------------------------
// Attention: rope, write K/V, attend the row's pages
// ---------------------------------------------------------------------------

// With write_kv false the rows' K/V are already in the cache (the spec
// kernel's verify writes a whole chunk before any of it is attended), and
// no split writes. Positions are read through L2: the spec kernel advances
// them on the device between rounds.
template <typename T>
__device__ void attention(const Args<T>& a, float* smem, int l, int i, int B, bool write_kv = true) {
  const int H = a.H, KVH = a.KVH, HD = a.HD, G = H / KVH, BS = a.BS, W = a.W;
  const int HQ = H * HD, HKV = KVH * HD, NQKV = HQ + 2 * HKV, half = HD / 2;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  constexpr int VEC = 16 / (int)sizeof(T);
  const int RV = HD / VEC;                            // vectors per key row of one head
  const int NV = (kKeys * RV + kThreads - 1) / kThreads;  // <= kMaxNV
  const int KS = HD + 1;
  const float scale = (float)(1.0 / sqrt((double)HD));  // HD**-0.5 rounded once, as the host's
  float* sq = smem;
  float* sk = sq + G * HD;
  float* sv = sk + kKeys * KS;
  float* ss = sv + kKeys * HD;
  float* sacc = ss + G * kKeys;
  float* sm = sacc + G * HD;
  float* sl = sm + G;
  float* sa = sl + G;
  const int64_t tok_stride = (int64_t)KVH * HD;
  const int64_t page_stride = (int64_t)BS * tok_stride;
  const int64_t layer_off = (int64_t)l * a.N * page_stride;
  T* kc = a.kc + layer_off;
  T* vc = a.vc + layer_off;

  const int S = a.S;
  for (int item = blockIdx.x; item < B * KVH * S; item += gridDim.x) {
    const int b = item / (KVH * S), kvh = (item / S) % KVH, sp = item % S;
    const bool live = a.active[b] != 0;
    const int pos = __ldcg(a.positions + b) + i;
    const int slot = live ? pos : 0;
    const int* row_table = a.tables + (int64_t)b * W;
    const int64_t blk = (live && slot / BS < W) ? row_table[slot / BS] : 0;
    const int64_t dst = blk * page_stride + (int64_t)(slot % BS) * tok_stride + (int64_t)kvh * HD;
    const T* row = a.qkv + (int64_t)b * NQKV;
    // This split's keys [n_lo, n_hi): the row's len keys cut into S runs of
    // whole tiles. The split holding the row's last key (a dead row: split
    // 0) writes the step's K/V row, so it alone reads it.
    const int len = live ? min(pos + 1, W * BS) : 0;
    const int chunk = ((len + S - 1) / S + kKeys - 1) / kKeys * kKeys;
    const int n_lo = sp * chunk, n_hi = min(len, n_lo + chunk);
    const bool writer = write_kv && (live ? (len - 1) / chunk == sp : sp == 0);

    // Rope the G query heads (into shared memory) and the key (into the
    // cache), each rounded to T; the value goes to the cache as it is.
    for (int e = tid; e < (G + writer) * half; e += kThreads) {
      const int hh = e / half, j = e - hh * half;
      const float freq = 1.f / powf(a.theta, (float)(2 * j) / (float)HD);
      float sn, cs;
      sincosf((float)pos * freq, &sn, &cs);
      const T* src = hh < G ? row + (int64_t)(kvh * G + hh) * HD : row + HQ + (int64_t)kvh * HD;
      const float x1 = ld_scratch(src + j), x2 = ld_scratch(src + j + half);
      const float o1 = round_to<T>(x1 * cs - x2 * sn), o2 = round_to<T>(x2 * cs + x1 * sn);
      if (hh < G) {
        sq[hh * HD + j] = o1;
        sq[hh * HD + j + half] = o2;
      } else {
        kc[dst + j] = from_f<T>(o1);
        kc[dst + j + half] = from_f<T>(o2);
      }
    }
    for (int d = tid; d < HD * writer; d += kThreads)
      vc[dst + d] = from_f<T>(ld_scratch(row + HQ + HKV + (int64_t)kvh * HD + d));
    for (int e = tid; e < G * HD; e += kThreads) sacc[e] = 0.f;
    for (int g = tid; g < G; g += kThreads) {
      sm[g] = kNegInf;
      sl[g] = 0.f;
    }
    __threadfence();
    __syncthreads();  // the step's K/V row is in the cache before any key is read

    uint4 rk[kMaxNV], rv[kMaxNV];
    auto load_tile = [&](int n0) {
#pragma unroll
      for (int x = 0; x < kMaxNV; ++x) {
        rk[x] = rv[x] = make_uint4(0u, 0u, 0u, 0u);
        const int e = tid + x * kThreads;
        if (x < NV && e < kKeys * RV) {
          const int j = e / RV, c = e - j * RV;
          const int n = n0 + j;
          if (n < n_hi) {
            const int64_t off = (int64_t)row_table[n / BS] * page_stride + (int64_t)(n % BS) * tok_stride +
                                (int64_t)kvh * HD + c * VEC;
            rk[x] = __ldcg(reinterpret_cast<const uint4*>(kc + off));
            rv[x] = __ldcg(reinterpret_cast<const uint4*>(vc + off));
          }
        }
      }
    };
    if (n_lo < n_hi) load_tile(n_lo);
    for (int n0 = n_lo; n0 < n_hi; n0 += kKeys) {
      const int nk = min(kKeys, n_hi - n0);
      __syncthreads();  // the previous tile's products are done with sk, sv, ss
#pragma unroll
      for (int x = 0; x < kMaxNV; ++x) {
        const int e = tid + x * kThreads;
        if (x < NV && e < kKeys * RV) {
          const int j = e / RV, c = e - j * RV;
          float fk[VEC], fv[VEC];
          const unsigned wk[4] = {rk[x].x, rk[x].y, rk[x].z, rk[x].w};
          const unsigned wv[4] = {rv[x].x, rv[x].y, rv[x].z, rv[x].w};
          unpack<T, 4>(wk, fk);
          unpack<T, 4>(wv, fv);
#pragma unroll
          for (int y = 0; y < VEC; ++y) {
            sk[j * KS + c * VEC + y] = fk[y];
            sv[j * HD + c * VEC + y] = fv[y];
          }
        }
      }
      __syncthreads();
      if (n0 + kKeys < n_hi) load_tile(n0 + kKeys);  // in flight during this tile's products

      for (int e = tid; e < G * kKeys; e += kThreads) {
        const int g = e / kKeys, j = e - g * kKeys;
        float s = kNegInf;
        if (j < nk) {
          const float* qr = sq + g * HD;
          const float* kr = sk + j * KS;
          float dot = 0.f;
          for (int d = 0; d < HD; ++d) dot = fmaf(qr[d], kr[d], dot);
          s = round_to<T>(dot) * scale;
        }
        ss[e] = s;
      }
      __syncthreads();
      for (int g = warp; g < G; g += kWarps) {  // online softmax, one warp per head
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
        sr[lane] = p0;
        sr[lane + 32] = p1;
        if (lane == 0) {
          const float al = expf(m_prev - m_new);
          sa[g] = al;
          sm[g] = m_new;
          sl[g] = sl[g] * al + sum;
        }
      }
      __syncthreads();
      for (int e = tid; e < G * HD; e += kThreads) {
        const int g = e / HD, d = e - g * HD;
        const float* pr = ss + g * kKeys;
        float acc = sacc[e] * sa[g];
        for (int j = 0; j < nk; ++j) acc = fmaf(pr[j], sv[j * HD + d], acc);
        sacc[e] = acc;
      }
    }
    __syncthreads();
    T* out = a.attn + (int64_t)b * HQ + (int64_t)kvh * G * HD;
    if (S == 1) {
      for (int e = tid; e < G * HD; e += kThreads) out[e] = from_f<T>(sacc[e] / fmaxf(sl[e / HD], 1e-30f));
      __syncthreads();  // shared memory is reused by the next item
      continue;
    }
    // This split's partial: unnormalized acc and (m, l) per query head (an
    // empty split or a dead row: acc 0, m -1e30, l 0). The last split of
    // the (row, KV head) to finish merges the S partials into the row:
    // out = sum_s e^(m_s - M) acc_s / sum_s e^(m_s - M) l_s, rounded to T.
    float* pacc = a.part_acc + (int64_t)item * G * HD;
    float* pml = a.part_ml + (int64_t)item * G * 2;
    for (int e = tid; e < G * HD; e += kThreads) pacc[e] = sacc[e];
    for (int g = tid; g < G; g += kThreads) {
      pml[2 * g] = sm[g];
      pml[2 * g + 1] = sl[g];
    }
    __threadfence();
    __syncthreads();
    int* cnt = a.split_cnt + (int64_t)b * KVH + kvh;
    __shared__ int done_before;
    if (tid == 0) done_before = atomicAdd(cnt, 1);
    __syncthreads();
    if (done_before == S - 1) {
      __threadfence();
      const int64_t item0 = item - sp;
      for (int g = tid; g < G; g += kThreads) {  // merged (max, sum) of head g
        float m = kNegInf, l = 0.f;
        for (int s2 = 0; s2 < S; ++s2) m = fmaxf(m, __ldcg(a.part_ml + ((item0 + s2) * G + g) * 2));
        for (int s2 = 0; s2 < S; ++s2) {
          const float* ml = a.part_ml + ((item0 + s2) * G + g) * 2;
          l = fmaf(expf(__ldcg(ml) - m), __ldcg(ml + 1), l);
        }
        sm[g] = m;
        sl[g] = l;
      }
      __syncthreads();
      for (int e = tid; e < G * HD; e += kThreads) {
        const int g = e / HD;
        float acc = 0.f;
        for (int s2 = 0; s2 < S; ++s2) {
          const float w = expf(__ldcg(a.part_ml + ((item0 + s2) * G + g) * 2) - sm[g]);
          acc = fmaf(w, __ldcg(a.part_acc + (item0 + s2) * G * HD + e), acc);
        }
        out[e] = from_f<T>(acc / fmaxf(sl[g], 1e-30f));
      }
      if (tid == 0) *cnt = 0;  // ready for the next layer's splits
    }
    __syncthreads();  // shared memory is reused by the next item
  }
}

// ---------------------------------------------------------------------------
// The sampled epilogue: one row's draw by one block
// ---------------------------------------------------------------------------

constexpr int kBins = 256;                // radix digits per pass (8 bits)
constexpr int kScanItems = 8;             // consecutive logits per thread in the draw's scan (2 float4s)
constexpr int kRowLoads = 4;              // float4 loads in flight per thread in a pass over a row
constexpr float kMassScale = 1099511627776.0f;  // 2^40: fixed-point unit of the top-p bins

constexpr int kLaneStride = kBins + 1;  // a bin's 32 lane copies fall in 32 distinct banks

// Shared scratch of the pick (at the start of the kernel's shared memory).
// A radix pass counts into 32 copies of the bins, one per lane index: the
// values of a row share few top-byte bins, and one copy for the block made
// every lane of a warp wait on the same address. The copies are summed
// after the pass.
struct PickSmem {
  unsigned long long lane_mass[32 * kLaneStride];  // per-lane top-p bins: mass, fixed point
  unsigned lane_cnt[32 * kLaneStride];             // per-lane bins: element counts
  unsigned long long mass[kBins];                  // the copies summed
  unsigned cnt[kBins];
  float red[kWarps];  // block reductions
  int redi[kWarps];
  int bint[4];  // broadcasts
  unsigned long long bull;
};
static_assert(sizeof(PickSmem) <= kXFloats * sizeof(float), "the pick's scratch must fit the GEMV staging area");

// Zero the lane copies (counts, and masses when `mass`).
__device__ void clear_bins(PickSmem* ps, bool mass) {
  for (int j = threadIdx.x; j < 32 * kLaneStride; j += kThreads) {
    ps->lane_cnt[j] = 0u;
    if (mass) ps->lane_mass[j] = 0ull;
  }
}

// Sum the lane copies into cnt (and mass). Thread j reads bin j of each
// copy: one bank per thread at each step.
__device__ void merge_bins(PickSmem* ps, bool mass) {
  for (int j = threadIdx.x; j < kBins; j += kThreads) {
    unsigned c = 0u;
    unsigned long long m = 0ull;
    for (int l = 0; l < 32; ++l) {
      c += ps->lane_cnt[l * kLaneStride + j];
      if (mass) m += ps->lane_mass[l * kLaneStride + j];
    }
    ps->cnt[j] = c;
    if (mass) ps->mass[j] = m;
  }
}

// Order-preserving key of a float: a larger float has a larger key.
__device__ __forceinline__ unsigned order_key(float f) {
  const unsigned u = __float_as_uint(f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float key_value(unsigned k) {
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7fffffffu) : ~k);
}

// Block sum in a fixed order (the same value in every thread).
__device__ float block_sum(float v, PickSmem* ps) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  if (lane == 0) ps->red[warp] = v;
  __syncthreads();
  float s = 0.f;
  for (int w = 0; w < kWarps; ++w) s += ps->red[w];
  __syncthreads();
  return s;
}

// Block (max, lowest index among equal maxima), in every thread.
__device__ void block_argmax(float& v, int& ix, PickSmem* ps) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float ov = __shfl_xor_sync(0xffffffffu, v, o);
    const int oi = __shfl_xor_sync(0xffffffffu, ix, o);
    if (ov > v || (ov == v && oi < ix)) {
      v = ov;
      ix = oi;
    }
  }
  if (lane == 0) {
    ps->red[warp] = v;
    ps->redi[warp] = ix;
  }
  __syncthreads();
  v = ps->red[0];
  ix = ps->redi[0];
  for (int w = 1; w < kWarps; ++w) {
    if (ps->red[w] > v || (ps->red[w] == v && ps->redi[w] < ix)) {
      v = ps->red[w];
      ix = ps->redi[w];
    }
  }
  __syncthreads();
}

// f(i, s) for every i of [0, V) with s = row[i] (V % 4 == 0, row 16-byte
// aligned): each thread takes float4s tid, tid + kThreads, ..., with
// kRowLoads of them in flight, so a pass over a row is not a chain of L2
// latencies; a thread's indices ascend. The row was written inside the
// kernel: read through L2.
template <class F>
__device__ __forceinline__ void for_row(const float* row, int V, const F& f) {
  const float4* r4 = reinterpret_cast<const float4*>(row);
  const int n4 = V >> 2;
  for (int j0 = threadIdx.x; j0 < n4; j0 += kThreads * kRowLoads) {
    float4 v[kRowLoads];
#pragma unroll
    for (int q = 0; q < kRowLoads; ++q) {
      const int j = j0 + q * kThreads;
      if (j < n4) v[q] = __ldcg(r4 + j);
    }
#pragma unroll
    for (int q = 0; q < kRowLoads; ++q) {
      const int j = j0 + q * kThreads;
      if (j < n4) {
        f(4 * j, v[q].x);
        f(4 * j + 1, v[q].y);
        f(4 * j + 2, v[q].z);
        f(4 * j + 3, v[q].w);
      }
    }
  }
}

// Max of row[i] and its first index (INT_MAX when no value is > -inf).
__device__ void row_mode(const float* row, int V, float& m, int& mi, PickSmem* ps) {
  m = -INFINITY;
  mi = INT_MAX;
  for_row(row, V, [&](int i, float s) {  // ascending: strict > keeps the first
    if (s > m) {
      m = s;
      mi = i;
    }
  });
  block_argmax(m, mi, ps);
}

// The k-th largest of row[i] (1 <= k <= V), exactly: a radix select from the
// most significant byte of the order-preserving key down.
__device__ float kth_largest(const float* row, int V, int k, PickSmem* ps) {
  const int tid = threadIdx.x;
  unsigned prefix = 0u, mask = 0u;
  unsigned* cnt = ps->lane_cnt + (tid % 32) * kLaneStride;
  for (int shift = 24; shift >= 0; shift -= 8) {
    clear_bins(ps, false);
    __syncthreads();
    for_row(row, V, [&](int, float s) {
      const unsigned key = order_key(s);
      if ((key & mask) == prefix) atomicAdd(cnt + ((key >> shift) & 0xffu), 1u);
    });
    __syncthreads();
    merge_bins(ps, false);
    __syncthreads();
    if (tid == 0) {  // the digit holding the k-th largest: count down from the top bin
      int d = kBins - 1, above = 0;
      for (; d > 0; --d) {
        const int c = (int)ps->cnt[d];
        if (above + c >= k) break;
        above += c;
      }
      ps->bint[0] = d;
      ps->bint[1] = above;
    }
    __syncthreads();
    k -= ps->bint[1];
    prefix |= (unsigned)ps->bint[0] << shift;
    mask |= 0xffu << shift;
    __syncthreads();
  }
  return key_value(prefix);
}

// The smallest value v of row[i] with sum over values s > v of exp(s - lse)
// < top_p: the last value the top-p rule keeps. The mass above a bin's
// largest value is the mass of the bins above it, so the lowest non-empty
// bin whose mass-above is < top_p holds v; each pass narrows to it.
__device__ float nucleus_min(const float* row, int V, float lse, float top_p, PickSmem* ps) {
  const int tid = threadIdx.x;
  const double target = (double)top_p * (double)kMassScale;
  unsigned prefix = 0u, mask = 0u;
  unsigned long long above = 0ull;
  unsigned* cnt = ps->lane_cnt + (tid % 32) * kLaneStride;
  unsigned long long* mass = ps->lane_mass + (tid % 32) * kLaneStride;
  for (int shift = 24; shift >= 0; shift -= 8) {
    clear_bins(ps, true);
    __syncthreads();
    for_row(row, V, [&](int, float s) {
      const unsigned key = order_key(s);
      if ((key & mask) == prefix) {
        const unsigned bin = (key >> shift) & 0xffu;
        atomicAdd(cnt + bin, 1u);
        atomicAdd(mass + bin, (unsigned long long)__float2ull_rn(expf(s - lse) * kMassScale));
      }
    });
    __syncthreads();
    merge_bins(ps, true);
    __syncthreads();
    if (tid == 0) {
      unsigned long long acc = above, acc_found = above;
      int found = -1, top = -1;
      for (int d = kBins - 1; d >= 0; --d) {
        if (ps->cnt[d] == 0u) continue;
        if (top < 0) top = d;
        if ((double)acc >= target) break;  // the mass above only grows downwards
        found = d;
        acc_found = acc;
        acc += ps->mass[d];
      }
      if (found < 0) {  // top_p <= 0: keep the maximum alone
        found = top;
        acc_found = above;
      }
      ps->bint[0] = found;
      ps->bull = acc_found;
    }
    __syncthreads();
    prefix |= (unsigned)ps->bint[0] << shift;
    mask |= 0xffu << shift;
    above = ps->bull;
    __syncthreads();
  }
  return key_value(prefix);
}

// The filter JAX `filtered_probs_rows` applies to one sampled row of
// temperature-scaled f32 logits: keep scaled >= thresh, where thresh is the
// larger of the k-th largest (top_k > 0) and the top-p threshold (top_p <
// 1); p = exp(scaled - m) / zk over the kept. mode is the row's first
// maximum (INT_MAX when no logit is finite; the rest is then unset).
struct RowFilter {
  float m, thresh, zk;
  int mode;
};

// The filter of row[0, V) (logits / t, divided where they were stored), by
// the whole block; every thread returns it. Not inlined: one copy serves
// every template instance.
__device__ __noinline__ RowFilter row_filter(const float* row, int V, int top_k, float top_p, PickSmem* ps) {
  RowFilter f;
  f.thresh = -INFINITY;
  f.zk = 0.f;
  row_mode(row, V, f.m, f.mode, ps);
  if (f.mode == INT_MAX) return f;  // no finite logit
  const float m = f.m;
  float z = 0.f;
  for_row(row, V, [&](int, float s) { z += expf(s - m); });
  const float lse = m + logf(block_sum(z, ps));

  float thresh = -INFINITY;
  if (top_k > 0) {
    const int k = min(top_k, V);
    thresh = k == 1 ? m : kth_largest(row, V, k, ps);
  }
  if (top_p < 1.f) thresh = fmaxf(thresh, nucleus_min(row, V, lse, top_p, ps));

  float zk = 0.f;
  for_row(row, V, [&](int, float s) {
    if (s >= thresh) zk += expf(s - m);
  });
  f.zk = block_sum(zk, ps);
  f.thresh = thresh;
  return f;
}

// p of a scaled logit s under filter f.
__device__ __forceinline__ float filtered_p(float s, const RowFilter& f) {
  return s >= f.thresh ? expf(s - f.m) / f.zk : 0.f;
}

// Inverse CDF in index order over p(i), i in [0, V): the first index whose
// cumulative p exceeds u (among p > 0), or INT_MAX when u is past the
// total; every thread returns it. p4(i) gives p(i..i+3) (i % 4 == 0, V % 4
// == 0). Tiles of kThreads x kScanItems consecutive indices, a block scan of
// the threads' sums, the carry across tiles.
template <class P4>
__device__ int cdf_draw(int V, float u, PickSmem* ps, const P4& p4) {
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  if (tid == 0) ps->bint[2] = INT_MAX;
  __syncthreads();
  float carry = 0.f;
  for (int base = 0; base < V; base += kThreads * kScanItems) {
    const int i0 = base + tid * kScanItems;
    float pv[kScanItems];
#pragma unroll
    for (int q = 0; q < kScanItems / 4; ++q) {
      const float4 v = i0 + 4 * q < V ? p4(i0 + 4 * q) : make_float4(0.f, 0.f, 0.f, 0.f);
      pv[4 * q] = v.x, pv[4 * q + 1] = v.y, pv[4 * q + 2] = v.z, pv[4 * q + 3] = v.w;
    }
    float cum[kScanItems];
    bool kept[kScanItems];
    float local = 0.f;
#pragma unroll
    for (int j = 0; j < kScanItems; ++j) {
      kept[j] = pv[j] > 0.f;
      local += pv[j];
      cum[j] = local;
    }
    float x = local;  // inclusive warp scan of the threads' sums
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const float y = __shfl_up_sync(0xffffffffu, x, o);
      if (lane >= o) x += y;
    }
    float excl = __shfl_up_sync(0xffffffffu, x, 1);
    if (lane == 0) excl = 0.f;
    if (lane == 31) ps->red[warp] = x;
    __syncthreads();
    float before = carry, total = 0.f;
    for (int w = 0; w < kWarps; ++w) {
      if (w < warp) before += ps->red[w];
      total += ps->red[w];
    }
    before += excl;
    int hit = INT_MAX;
#pragma unroll
    for (int j = kScanItems - 1; j >= 0; --j)
      if (kept[j] && before + cum[j] > u) hit = i0 + j;
    if (hit != INT_MAX) atomicMin(&ps->bint[2], hit);
    __syncthreads();
    const int found = ps->bint[2];
    carry += total;
    __syncthreads();
    if (found != INT_MAX) return found;
  }
  return INT_MAX;
}

// JAX `pick_from_probs` over row[0, V) under filter f (f.mode != INT_MAX):
// the first index whose cumulative p exceeds u, or the mode when u is past
// the total. The row was written inside the kernel: read through L2.
__device__ int draw_filtered(const float* row, int V, const RowFilter& f, float u, PickSmem* ps) {
  const float4* r4 = reinterpret_cast<const float4*>(row);
  const int hit = cdf_draw(V, u, ps, [&](int i) {
    const float4 s = __ldcg(r4 + i / 4);
    return make_float4(filtered_p(s.x, f), filtered_p(s.y, f), filtered_p(s.z, f), filtered_p(s.w, f));
  });
  return hit != INT_MAX ? hit : f.mode;
}

// One sampled row's token from its temperature-scaled f32 logits row[0, V)
// (logits / t, divided where they were stored), by the whole block; every
// thread returns it. JAX `filtered_probs_rows` then `pick_from_probs(probs,
// u)`. Not inlined: one copy serves the window's 12 template instances and
// the epilogue kernel.
__device__ __noinline__ int sample_row(const float* row, int V, int top_k, float top_p, float u, PickSmem* ps) {
  const RowFilter f = row_filter(row, V, top_k, top_p, ps);
  return f.mode == INT_MAX ? 0 : draw_filtered(row, V, f, u, ps);
}

// ---------------------------------------------------------------------------
// bf16 products on the tensor cores
// ---------------------------------------------------------------------------
//
// y[b, c] = sum_k x(b, k) W[k, c] for the n rows of a phase, weights
// streamed once. The phase's output columns are cut into tiles of 64 and
// its depth K into boxes of 128 rows; a work item is one column tile over a
// run of kbs boxes (split-K: a phase with few tiles cuts K into nsplit
// runs, so that the items cover the grid; the host's plan,
// megakernel.product_plan, picks nsplit and kbs).
//
// The two warpgroups of a block are two independent streams ("lanes" of
// the grid: lane 2 blockIdx.x + wg of 2 gridDim.x, each walking its items
// lane-stride), each with its own half of the ring, staging buffers,
// output tile and producer, synchronising on a named barrier of its own:
// a step's chain (issue copies, stage inputs, products, epilogue) is
// latency-bound, and two chains an SM overlap. In each lane its first
// thread keeps up to kLaneSlots weight boxes in flight by TMA (16 KB each,
// 128 rows x 64 columns, 128-byte swizzle), each on its own mbarrier; when
// a phase's boxes run out it goes on with the next phase's (the caller
// names it), before the grid barrier between them: the weights are
// read-only for the whole launch. There is no producer warp: the lane's
// first thread tops its ring up while the lane's products run, the slots
// it refills freed by the lane barrier before, so no thread ever waits at
// a grid barrier on an mbarrier. A step is one box: the lane stages the
// rows' inputs x(b, k) (the RMS-normed residual, the attention rows or
// silu(gate)·up, already rounded to bf16 as the CUDA-core path rounds
// them) in the 128-byte swizzle of a wgmma operand, double-buffered (the
// next step's inputs are staged while this step's products run): the rows
// are the A operand of m64n64k16 wgmma, the box the B operand, N-major
// (the [in, out] layout, the descriptor's transpose bit) or K-major (the
// tied head's embedding rows); rows past n hold stale values whose
// accumulator rows are never read. Rows go in passes of 64, each with its
// own f32 sums, all of them over the same staged box: every weight byte
// leaves HBM once per forward, whatever n. A box's products run on fresh
// tensor-core accumulators (one pass: four chains of two k-steps), added
// to the sums on the CUDA cores once they land. An
// item's accumulator goes to the lane's f32 tile; with one split the
// phase's out(b, col, y) takes it there, else it goes to the split
// partials and the item's last split to arrive (a counter per tile, reset
// by it) sums the partials in split order and applies out, so repeats are
// bit-equal. after(tile, lane) (the head's argmax fold, per lane) follows
// out for each tile, in the lane that finished it. (Why not simpler: one
// block-wide chain of these steps left the memory idle between them;
// smaller copies, issued by one thread, cap the stream; A fragments held
// in registers spilled.)

constexpr int kTcN = 64;                     // output columns per tile: wgmma's N
constexpr int kBoxK = 128;                   // weight rows per ring slot
constexpr int kBoxBytes = kBoxK * kTcN * 2;  // 16 KB
constexpr int kLaneSlots = 3;                // slots in flight per lane (48 KB; 96 KB a block)
constexpr int kRingBoxes = 2 * kLaneSlots;
constexpr int kLaneThreads = 128;            // a warpgroup
constexpr int kPassRows = 64;                // rows per pass: one m64 tile
constexpr int kMaxPasses = 5;                // rows per phase <= 320
constexpr int kXsBytes = kPassRows * kBoxK * 2;  // a staging buffer: 64 rows x 128 bf16 (two a lane)
constexpr int kCtStride = 72;                // f32 output tile: rows of 64 + 8 (no bank conflicts)
constexpr int kCtBytes = kPassRows * kCtStride * 4;
enum { kPhQkv = 0, kPhWo, kPhGu, kPhDown, kPhHead, kPhases };

// One product phase: up to three column groups (the QKV phase's wq, wk,
// wv; gate | up), each a weight tensor of `width` columns in ceil(width /
// 64) tiles; the group's columns follow the previous groups' in out's
// column numbering.
struct Phase {
  const CUtensorMap* map[3];
  int tiles[3], width[3];
  int layer, K, n, nsplit, kbs;
  int kmajor;
};

__device__ __forceinline__ int ph_tiles(const Phase& p) { return p.tiles[0] + p.tiles[1] + p.tiles[2]; }
__device__ __forceinline__ int ph_boxes(const Phase& p) { return (p.K + kBoxK - 1) / kBoxK; }

// Item `item`'s column tile and box range [lo, hi).
__device__ __forceinline__ void ph_item(const Phase& p, int item, int& ct, int& lo, int& hi) {
  ct = item / p.nsplit;
  lo = (item - ct * p.nsplit) * p.kbs;
  hi = min(ph_boxes(p), lo + p.kbs);
}

// Tile ct's group, first column in the group's tensor and first column in
// out's numbering.
__device__ __forceinline__ void ph_tile(const Phase& p, int ct, int& g, int& c0, int& off) {
  // Selects, not a loop over the arrays: a Phase held in registers stays there.
  const int t01 = p.tiles[0] + p.tiles[1];
  g = ct < p.tiles[0] ? 0 : ct < t01 ? 1 : 2;
  off = g == 0 ? 0 : g == 1 ? p.width[0] : p.width[0] + p.width[1];
  c0 = (ct - (g == 0 ? 0 : g == 1 ? p.tiles[0] : t01)) * kTcN;
}

__device__ __forceinline__ int ph_width(const Phase& p, int g) { return g == 0 ? p.width[0] : g == 1 ? p.width[1] : p.width[2]; }
__device__ __forceinline__ const CUtensorMap* ph_map(const Phase& p, int g) {
  return g == 0 ? p.map[0] : g == 1 ? p.map[1] : p.map[2];
}

template <typename T>
__device__ Phase make_phase(const Args<T>& a, int kind, int l, int n) {
  Phase p = {};
  const int HQ = a.H * a.HD, HKV = a.KVH * a.HD;
  const CUtensorMap* m[3] = {nullptr, nullptr, nullptr};
  int w[3] = {0, 0, 0};
  p.layer = l, p.n = n, p.nsplit = a.plan[kind][0], p.kbs = a.plan[kind][1];
  switch (kind) {
    case kPhQkv: m[0] = &a.maps.wq, m[1] = &a.maps.wk, m[2] = &a.maps.wv, w[0] = HQ, w[1] = w[2] = HKV, p.K = a.D; break;
    case kPhWo: m[0] = &a.maps.wo, w[0] = a.D, p.K = HQ; break;
    case kPhGu: m[0] = &a.maps.wg, m[1] = &a.maps.wu, w[0] = w[1] = a.F, p.K = a.D; break;
    case kPhDown: m[0] = &a.maps.wd, w[0] = a.D, p.K = a.F; break;
    default: m[0] = &a.maps.head, w[0] = a.V, p.K = a.D, p.layer = 0, p.kmajor = a.head == nullptr; break;
  }
  for (int g = 0; g < 3; ++g) p.map[g] = m[g], p.width[g] = w[g], p.tiles[g] = (w[g] + kTcN - 1) / kTcN;
  return p;
}

// A lane's first thread's side of its ring, in shared memory: the phase
// whose boxes it issues (its product's number, -1 none) and where it is in
// it (the lane's item and box), the phase queued after it, and the boxes
// issued in the whole launch.
struct Producer {
  Phase cur, nxt;
  int cur_id, nxt_id, item, kb;
  uint32_t issued;
};

// Every thread's side, for its lane: the lane's ring (kLaneSlots boxes,
// 1024-byte aligned), barriers, producer, staging buffers and output
// tile; boxes consumed in the whole launch (the slot and parity follow
// from it) and products begun.
struct TcCtx {
  uint8_t* ring;
  uint64_t* full;
  Producer* pr;
  uint8_t* xs;  // two staging buffers
  float* ct;
  float* part;  // split partials (the grid's)
  int* cnt;     // per-tile arrival counters
  int lane, lanes, wg;
  uint32_t consumed;
  int calls;
};

// The lane's barrier (named barrier 1 + wg over its 128 threads).
__device__ __forceinline__ void lane_sync(int wg) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(1 + wg), "r"(kLaneThreads) : "memory");
}

__device__ void pr_start(Producer* pr, const Phase& p, int id, int lane) {
  for (int g = 0; g < 3; ++g)
    if (p.map[g] != nullptr) attn_tc::prefetch_tensormap(p.map[g]);
  pr->cur = p;
  pr->cur_id = id;
  pr->item = lane;
  int ct, lo, hi;
  ph_item(p, pr->item, ct, lo, hi);
  pr->kb = lo;
}

// Issue boxes (the lane's first thread) until `limit` are issued in all or
// both queued phases are out of boxes. The phase is read in place and the
// position kept in registers while it issues (a Phase copied out would
// live in local memory; the barrier and copy instructions clobber memory).
__device__ void pr_top_up(TcCtx& c, uint32_t limit) {
  Producer* pr = c.pr;
  uint32_t issued = pr->issued;
  if (issued >= limit) return;
  uint8_t* const ring = c.ring;
  uint64_t* const full = c.full;
  const int lanes = c.lanes;
  while (issued < limit) {
    const Phase& p = pr->cur;
    const int nitems = ph_tiles(p) * p.nsplit, kmajor = p.kmajor, layer = p.layer;
    int item = pr->item, kb = pr->kb;
    if (pr->cur_id < 0 || item >= nitems) {  // nothing (left) to issue: on to the queued phase
      if (pr->nxt_id < 0) break;
      pr_start(pr, pr->nxt, pr->nxt_id, c.lane);
      pr->nxt_id = -1;
      continue;
    }
    while (issued < limit && item < nitems) {
      int ct, lo, hi, g, c0, off;
      ph_item(p, item, ct, lo, hi);
      ph_tile(p, ct, g, c0, off);
      const CUtensorMap* map = ph_map(p, g);
      for (; kb < hi && issued < limit; ++kb, ++issued) {
        const int slot = (int)(issued % kLaneSlots);
        uint8_t* dst = ring + slot * kBoxBytes;
        attn_tc::mbar_arrive_expect_tx(&full[slot], kBoxBytes);
        if (kmajor) {  // two 64-wide planes of the embedding rows' depth
          attn_tc::tma_load_3d(dst, map, &full[slot], kb * kBoxK, c0, 0);
          attn_tc::tma_load_3d(dst + kBoxBytes / 2, map, &full[slot], kb * kBoxK + 64, c0, 0);
        } else {
          attn_tc::tma_load_3d(dst, map, &full[slot], c0, kb * kBoxK, layer);
        }
      }
      if (kb >= hi) {
        item += lanes;
        ph_item(p, item, ct, lo, hi);
        kb = lo;
      }
    }
    pr->item = item, pr->kb = kb;
  }
  pr->issued = issued;
}

// Queue `next` behind the phase being issued and top the ring up (each
// lane's first thread): the next product's first boxes fly during whatever
// runs before it.
__device__ void tc_prefetch(TcCtx& c, const Phase& next) {
  if (threadIdx.x % kLaneThreads == 0) {
    c.pr->nxt = next;
    c.pr->nxt_id = c.calls;
    pr_top_up(c, c.consumed + kLaneSlots);
  }
}

// The staged inputs: 8 consecutive elements of a row as bf16, packed.
enum { kXNorm = 0, kXRows, kXSiluUp };
struct XSrc {
  int kind;
  const __nv_bfloat16* p;  // h [n, D], attention rows [n, K] or gate | up [n, 2F]
  int ld;                  // its row stride
  const float* inv;        // kXNorm: the rows' inverse RMS (shared memory)
  const __nv_bfloat16* g;  // kXNorm: the norm's weight
  int F;                   // kXSiluUp
  __device__ uint4 vec8(int b, int k) const {
    if (kind == kXRows) return __ldcg(reinterpret_cast<const uint4*>(p + (int64_t)b * ld + k));
    float x[8], y[8];
    uint32_t o[4];
    if (kind == kXNorm) {
      ld_scratch_vec<__nv_bfloat16>(p + (int64_t)b * ld + k, x);
      load_w<__nv_bfloat16, 8>(g + k, y);
      const float r = inv[b];
#pragma unroll
      for (int v = 0; v < 4; ++v) o[v] = attn_tc::pack_bf16(x[2 * v] * r * y[2 * v], x[2 * v + 1] * r * y[2 * v + 1]);
    } else {
      ld_scratch_vec<__nv_bfloat16>(p + (int64_t)b * ld + k, x);
      ld_scratch_vec<__nv_bfloat16>(p + (int64_t)b * ld + F + k, y);
      float s[8];
#pragma unroll
      for (int v = 0; v < 8; ++v) s[v] = round_to<__nv_bfloat16>(round_to<__nv_bfloat16>(x[v] / (1.f + expf(-x[v]))) * y[v]);
#pragma unroll
      for (int v = 0; v < 4; ++v) o[v] = attn_tc::pack_bf16(s[2 * v], s[2 * v + 1]);
    }
    return make_uint4(o[0], o[1], o[2], o[3]);
  }
};

// The phase's out(b, col, y), and after(tile) for the head's fold.
enum { kOutRows = 0, kOutResidual, kOutLogits, kOutScaled };
struct OutDst {
  int kind;
  __nv_bfloat16* y;  // kOutRows: rows [n, ld]; kOutResidual: h [n, ld]
  int ld;
  float* lgs;             // kOutLogits: each lane's tile logits, lgs[(wg * 64 + c % 64) * B + b]
  const unsigned* mask;   // kOutLogits: the guided rows' allow bits [P, W32], or null
  const int* rows;        // kOutLogits: each row's mask-pool row (shared memory)
  int W32, B, V;
  float* logits;          // kOutLogits: [B, V] scaled store, or null; kOutScaled: [n, V]
  const float* temps;     // [B]
  float* best_v;          // kOutLogits: each lane's (max, first index) per row, [wg * B + b]
  int* best_i;
  __device__ void operator()(int b, int c, float v, int wg) const {
    switch (kind) {
      case kOutRows: y[(int64_t)b * ld + c] = __float2bfloat16(v); break;
      case kOutResidual: {
        __nv_bfloat16* p = y + (int64_t)b * ld + c;
        *p = __float2bfloat16(ld_scratch(p) + round_to<__nv_bfloat16>(v));
        break;
      }
      case kOutLogits:
        if (mask != nullptr && !((__ldg(mask + (int64_t)rows[b] * W32 + (c >> 5)) >> (c & 31)) & 1u)) v = -INFINITY;
        lgs[(wg * kTcN + c % kTcN) * B + b] = v;
        break;
      default: {
        const float t = temps[b % B];
        logits[(int64_t)b * V + c] = t > 0.f ? v / t : v;  // a division, as JAX scales
      }
    }
  }
  // ArgmaxTile's fold over a 64-column tile (columns past V skipped), by
  // the lane that finished it, into the lane's (max, first index).
  __device__ void after(int ct, int wg) const {
    if (kind != kOutLogits) return;
    const int c0 = ct * kTcN, nc = min(kTcN, V - c0), t = threadIdx.x % kLaneThreads;
    const float* tl = lgs + wg * kTcN * B;
    if (logits != nullptr) {
      for (int e = t; e < B * kTcN; e += kLaneThreads) {
        const int b = e / kTcN, c = e - b * kTcN;
        if (c >= nc) continue;
        const float x = tl[c * B + b], tb = temps[b];
        logits[(int64_t)b * V + c0 + c] = tb > 0.f ? x / tb : x;
      }
    }
    if (t >= B) return;
    float bv = best_v[wg * B + t];
    int bi = best_i[wg * B + t];
    for (int c = 0; c < nc; ++c) {  // ascending index: strict > keeps the first maximum
      const float v = tl[c * B + t];
      if (v > bv) bv = v, bi = c0 + c;
    }
    best_v[wg * B + t] = bv;
    best_i[wg * B + t] = bi;
  }
};

// A staging buffer: per 64 of a box's depth a plane of 64 rows x 128 bytes,
// in the 128-byte swizzle the wgmma descriptor reads (16-byte unit u of row
// r at u ^ (r % 8)), so the rows are the A operand straight from shared
// memory. Rows past the pass's are stale: their accumulator rows are never
// read.
__device__ __forceinline__ int xs_offset(int b, int kv) {  // bytes; kv: 8-element unit
  return (kv >> 3) * kPassRows * 128 + b * 128 + (((kv & 7) ^ (b & 7)) << 4);
}

// A lane's products of one box, issued (the caller waits): of its nks
// k-steps (16 of the depth each) of the staged rows (xs at shared address
// xs) times ring box `box`, those with s % C in [C0, C0 + (kTwo ? 2 : 1)),
// k-step s into a (s % C == C0) or b, both zeroed first: the caller adds
// these fresh per-box sums to its own f32 sums, so the tensor core's own
// accumulation, which truncates, spans two k-steps at most (C = 4).
template <int C, int C0, bool kTwo>
__device__ __forceinline__ void tc_mma(float (&a)[32], float (&b)[32], uint32_t xs, uint32_t box, int nks,
                                       int kmajor) {
  using namespace attn_tc;
#pragma unroll
  for (int i = 0; i < 32; ++i) a[i] = 0.f, b[i] = 0.f;
  fence_regs(a);
  fence_regs(b);
  wgmma_fence();
#pragma unroll
  for (int s = 0; s < kBoxK / 16; ++s) {
    if (s < nks && (s % C == C0 || (kTwo && s % C == C0 + 1))) {
      float(&d)[32] = s % C == C0 ? a : b;
      const uint64_t da = smem_desc(xs + (s / 4) * (kPassRows * 128) + (s % 4) * 32, 16, 1024, 1);
      if (kmajor)  // [64 vocab rows x 64 of D] planes
        wgmma_ss_n64(d, da, smem_desc(box + (s / 4) * (kBoxBytes / 2) + (s % 4) * 32, 16, 1024, 1), 1);
      else  // [128 weight rows x 64 columns]
        wgmma_ss_n64_bt(d, da, smem_desc(box + s * 16 * 128, kBoxBytes, 1024, 1), 1);
    }
  }
  wgmma_commit();
}

// The lane's accumulator rows (fragment rows) < rows into its output tile.
__device__ __forceinline__ void acc_to_tile(float* ct, const float (&acc)[32], int rows) {
  const int t = threadIdx.x % kLaneThreads, lane = t % 32, r = 16 * (t / 32) + lane / 4, cq = 2 * (lane % 4);
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      if (r + 8 * h < rows)
        *reinterpret_cast<float2*>(ct + (r + 8 * h) * kCtStride + 8 * j + cq) =
            make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
}

// One product phase (every thread of the block, each in its lane; see the
// section's note), MTW passes of 64 rows at most. `next`, when given, is
// the product the caller runs next: its first boxes are issued before this
// one returns.
template <int MTW>
__device__ __noinline__ void tc_product(TcCtx& c, const Phase& ph, const Phase* next, const XSrc& x, const OutDst& out) {
  __shared__ int last_split[2];
  const int t = threadIdx.x % kLaneThreads, wg = c.wg, lanes = c.lanes;
  const int n = ph.n, npass = (n + kPassRows - 1) / kPassRows;
  // The hot loop's context in registers (the barrier and wgmma
  // instructions clobber memory, so fields behind `c` would be reloaded).
  const uint32_t xs_addr = attn_tc::smem_u32(c.xs), ring = attn_tc::smem_u32(c.ring);
  uint8_t* const xs = c.xs;
  float* const ctile = c.ct;
  uint64_t* const full = c.full;
  uint32_t consumed = c.consumed;
  const int nitems = ph_tiles(ph) * ph.nsplit;
  const int id = c.calls++;
  const Phase P = ph;  // a copy in registers: `ph` lives in the caller's memory
  if (t == 0) {
    if (npass > MTW) asm volatile("trap;");  // the caller's MTW is too small for n
    Producer* pr = c.pr;
    if (pr->cur_id != id) {
      pr_start(pr, ph, id, c.lane);  // nothing of it issued yet
    } else if (pr->cur.map[0] != ph.map[0] || pr->cur.layer != ph.layer || pr->cur.n != ph.n ||
               pr->cur.nsplit != ph.nsplit) {
      asm volatile("trap;");  // the caller queued another product than the one it runs
    }
    pr->nxt_id = -1;
    if (next != nullptr) pr->nxt = *next, pr->nxt_id = id + 1;
  }
  // The lane's steps (item, box, pass of up to 64 rows) in order. Step
  // s's inputs are staged (buffer s % 2) while step s - 1's products run;
  // one lane barrier a step.
  struct Step {
    int item, kb, p;
  };
  auto item_lo = [&](int item) {
    int ct, lo, hi;
    ph_item(P, item, ct, lo, hi);
    return lo;
  };
  auto next_step = [&](Step st, int hi) {
    if (st.p + 1 < npass) return Step{st.item, st.kb, st.p + 1};
    if (st.kb + 1 < hi) return Step{st.item, st.kb + 1, 0};
    const int item = st.item + lanes;
    return Step{item, item < nitems ? item_lo(item) : 0, 0};
  };
  auto stage_in = [&](Step st, int buf) {
    const int k0 = st.kb * kBoxK, nv = min(kBoxK, P.K - k0) / 8;
    const int rows = min(kPassRows, n - st.p * kPassRows);
    uint8_t* dst = xs + buf * kXsBytes;
    for (int i = t; i < rows * nv; i += kLaneThreads) {
      const int b = i / nv, kv = i - b * nv;
      *reinterpret_cast<uint4*>(dst + xs_offset(b, kv)) = x.vec8(st.p * kPassRows + b, k0 + kv * 8);
    }
    attn_tc::fence_proxy_async();  // the staged rows are read by wgmma (the async proxy)
  };

  float acc[MTW][32];  // each pass's f32 sums over the item's boxes
#pragma unroll
  for (int p = 0; p < MTW; ++p)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[p][i] = 0.f;
  Step st{c.lane, c.lane < nitems ? item_lo(c.lane) : 0, 0};
  if (st.item < nitems) stage_in(st, 0);
  lane_sync(wg);
  if (t == 0) pr_top_up(c, consumed + kLaneSlots);
  int buf = 0;
  while (st.item < nitems) {
    int ct, lo, hi, g, c0, off;
    ph_item(P, st.item, ct, lo, hi);
    ph_tile(P, ct, g, c0, off);
    const int nks = min(kBoxK, P.K - st.kb * kBoxK) / 16;
    if (st.p == 0) attn_tc::mbar_wait(&full[consumed % kLaneSlots], (consumed / kLaneSlots) & 1);
    const uint32_t xa = xs_addr + buf * kXsBytes, box = ring + (consumed % kLaneSlots) * kBoxBytes;
    // The box's products on fresh accumulators, added to the pass's f32
    // sums on the CUDA cores once they land: one pass, four chains of two
    // k-steps, in two halves of two chains (registers), summed
    // (c0 + c1) + (c2 + c3); past one pass, one chain (the registers hold
    // MTW passes' sums).
    float t0[32], t1[32], half[32];
    if constexpr (MTW == 1)
      tc_mma<4, 0, true>(t0, t1, xa, box, nks, P.kmajor);
    else
      tc_mma<1, 0, false>(t0, t1, xa, box, nks, P.kmajor);
    // While the products run: the first thread refills the slots the steps
    // before freed (a copy's issue blocks its thread for a while), and
    // every thread stages the next step's inputs.
    if (t == 0) pr_top_up(c, consumed + kLaneSlots);
    const Step nx = next_step(st, hi);
    if (nx.item < nitems) stage_in(nx, buf ^ 1);
    attn_tc::wgmma_wait<0>();
    attn_tc::fence_regs(t0);
    if constexpr (MTW == 1) {
      attn_tc::fence_regs(t1);
#pragma unroll
      for (int i = 0; i < 32; ++i) half[i] = t0[i] + t1[i];
      tc_mma<4, 2, true>(t0, t1, xa, box, nks, P.kmajor);
      attn_tc::wgmma_wait<0>();
      attn_tc::fence_regs(t0);
      attn_tc::fence_regs(t1);
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[0][i] += half[i] + (t0[i] + t1[i]);
    } else {
#pragma unroll
      for (int q = 0; q < MTW; ++q)
        if (q == st.p)
#pragma unroll
          for (int i = 0; i < 32; ++i) acc[q][i] += t0[i];
    }
    const bool box_done = st.p + 1 == npass;
    if (box_done) ++consumed;
    if (box_done && st.kb + 1 >= hi) {
      // The item's rows: to out (one split) or to its partial.
      const int item = st.item;
#pragma unroll
      for (int p = 0; p < MTW; ++p) {
        if (p >= npass) break;
        const int prow = min(kPassRows, n - p * kPassRows);
        lane_sync(wg);  // the tile's earlier readers are done
        acc_to_tile(ctile, acc[p], prow);
        lane_sync(wg);
        if (P.nsplit == 1) {
          for (int e = t; e < prow * kTcN; e += kLaneThreads) {
            const int b = e / kTcN, cc = e - b * kTcN;
            if (c0 + cc < ph_width(P, g)) out(p * kPassRows + b, off + c0 + cc, ctile[b * kCtStride + cc], wg);
          }
        } else {
          float* dst = c.part + ((int64_t)item * n + p * kPassRows) * kTcN;
          for (int e = t; e < prow * (kTcN / 4); e += kLaneThreads) {
            const int b = e / (kTcN / 4), c4 = (e - b * (kTcN / 4)) * 4;
            *reinterpret_cast<float4*>(dst + b * kTcN + c4) = *reinterpret_cast<const float4*>(ctile + b * kCtStride + c4);
          }
        }
#pragma unroll
        for (int i = 0; i < 32; ++i) acc[p][i] = 0.f;
      }
      bool done = P.nsplit == 1;
      if (!done) {
        __threadfence();
        lane_sync(wg);
        if (t == 0) last_split[wg] = atomicAdd(c.cnt + ct, 1) == P.nsplit - 1;
        lane_sync(wg);
        if (last_split[wg]) {
          __threadfence();
          // Sum the partials in split order, 4 columns a thread, 4 splits' loads in flight.
          const float4* src = reinterpret_cast<const float4*>(c.part + (int64_t)ct * P.nsplit * n * kTcN);
          const int stride = n * (kTcN / 4), ns = P.nsplit;
          for (int e = t; e < stride; e += kLaneThreads) {
            float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
            for (int s0 = 0; s0 < ns; s0 += 4) {
              float4 q[4];
#pragma unroll
              for (int u = 0; u < 4; ++u)
                q[u] = s0 + u < ns ? __ldcg(src + (int64_t)(s0 + u) * stride + e) : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
              for (int u = 0; u < 4; ++u)
                if (s0 + u < ns) v = make_float4(v.x + q[u].x, v.y + q[u].y, v.z + q[u].z, v.w + q[u].w);
            }
            const int b = e / (kTcN / 4), cc = (e - b * (kTcN / 4)) * 4;
            const float vs[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
            for (int u = 0; u < 4; ++u)
              if (c0 + cc + u < ph_width(P, g)) out(b, off + c0 + cc + u, vs[u], wg);
          }
          if (t == 0) c.cnt[ct] = 0;  // ready for the next phase
          done = true;
        }
      }
      if (done && out.kind == kOutLogits) {
        lane_sync(wg);
        out.after(ct, wg);
      }
    }
    lane_sync(wg);  // this step's slot and staged inputs are free; the next step's are staged
    st = nx;
    buf ^= 1;
  }
  c.consumed = consumed;  // every box of this phase is consumed
  if (t == 0) pr_top_up(c, consumed + kLaneSlots);
}

// tc_product with as many passes as n rows need (the spec kernel's
// verify: n = B (gamma + 1) <= 288).
__device__ void tc_product_rows(TcCtx& c, const Phase& ph, const Phase* next, const XSrc& x, const OutDst& out) {
  switch ((ph.n + kPassRows - 1) / kPassRows) {
    case 1: tc_product<1>(c, ph, next, x, out); break;
    case 2: tc_product<2>(c, ph, next, x, out); break;
    case 3: tc_product<3>(c, ph, next, x, out); break;
    case 4: tc_product<4>(c, ph, next, x, out); break;
    default: tc_product<kMaxPasses>(c, ph, next, x, out); break;
  }
}

// Shared memory of a bf16 window (bytes from the dynamic base): the region
// the lanes' staging buffers (1024-byte aligned: 1024 bytes of slack) and
// output tiles, the attention and the pick share; the tail (inverse RMS of
// up to inv_rows rows, each lane's tile logits of B rows, each lane's best
// value / index, the guided rows); the producers; the ring (1024 bytes of
// slack to align it) and its barriers.
struct TcLayout {
  size_t tail, prod, ring, bars, bytes;
};

__host__ __device__ inline TcLayout tc_layout(size_t attn_floats_max, int inv_rows, int B) {
  const size_t tc = 1024 + 2 * (2 * (size_t)kXsBytes + kCtBytes);
  size_t u = sizeof(PickSmem);
  u = u > attn_floats_max * 4 ? u : attn_floats_max * 4;
  u = u > tc ? u : tc;
  TcLayout l;
  l.tail = (u + 15) / 16 * 16;
  l.prod = (l.tail + ((size_t)inv_rows + 2 * (size_t)kTcN * B + 5 * (size_t)B) * 4 + 15) / 16 * 16;
  l.ring = (l.prod + 2 * sizeof(Producer) + 15) / 16 * 16;
  l.bars = l.ring + 1024 + (size_t)kRingBoxes * kBoxBytes;
  l.bytes = l.bars + (size_t)kRingBoxes * sizeof(uint64_t);
  return l;
}

// Host: the tensor map of weight [L, K, N] (boxes of 128 rows x 64
// columns: a ring slot) or, K-major, of the embedding [V, D] read as the
// tied head (boxes of 64 vocab rows x 64 of D: half a slot).
inline cudaError_t encode_weight(CUtensorMap* map, const void* p, int L, int K, int N) {
  const cuuint64_t dims[3] = {(cuuint64_t)N, (cuuint64_t)K, (cuuint64_t)L};
  const cuuint64_t strides[2] = {(cuuint64_t)N * 2, (cuuint64_t)K * N * 2};
  const cuuint32_t box[3] = {kTcN, kBoxK, 1};
  return attn_tc::encode_tiled(map, 3, p, dims, strides, box, kTcN * 2);
}

inline cudaError_t encode_embed_rows(CUtensorMap* map, const void* p, int V, int D) {
  const cuuint64_t dims[3] = {(cuuint64_t)D, (cuuint64_t)V, 1};
  const cuuint64_t strides[2] = {(cuuint64_t)D * 2, (cuuint64_t)V * D * 2};
  const cuuint32_t box[3] = {64, kTcN, 1};  // half a slot: a 128-byte swizzled row is 64 of D
  return attn_tc::encode_tiled(map, 3, p, dims, strides, box, 128);
}

// Host: a bf16 model's tensor maps, and its plan checked against its
// widths: each phase's splits of kbs boxes cover its ceil(K / 64) boxes,
// none empty; split partials and counters given where a phase splits.
template <typename T>
cudaError_t tc_prepare(Args<T>& a, const int* plan) {
  const int HQ = a.H * a.HD, HKV = a.KVH * a.HD;
  const int K[kPhases] = {a.D, HQ, a.D, a.F, a.D};
  bool split = false;
  for (int k = 0; k < kPhases; ++k) {
    const int ns = plan[2 * k], kbs = plan[2 * k + 1], kb = (K[k] + kBoxK - 1) / kBoxK;
    if (ns < 1 || kbs < 1 || (ns - 1) * kbs >= kb || ns * kbs < kb) return cudaErrorInvalidValue;
    a.plan[k][0] = ns, a.plan[k][1] = kbs;
    split |= ns > 1;
  }
  if (split && (a.tc_part == nullptr || a.tc_cnt == nullptr)) return cudaErrorInvalidValue;
  cudaError_t e = encode_weight(&a.maps.wq, a.wq, a.L, a.D, HQ);
  if (e == cudaSuccess) e = encode_weight(&a.maps.wk, a.wk, a.L, a.D, HKV);
  if (e == cudaSuccess) e = encode_weight(&a.maps.wv, a.wv, a.L, a.D, HKV);
  if (e == cudaSuccess) e = encode_weight(&a.maps.wo, a.wo, a.L, HQ, a.D);
  if (e == cudaSuccess) e = encode_weight(&a.maps.wg, a.wg, a.L, a.D, a.F);
  if (e == cudaSuccess) e = encode_weight(&a.maps.wu, a.wu, a.L, a.D, a.F);
  if (e == cudaSuccess) e = encode_weight(&a.maps.wd, a.wd, a.L, a.F, a.D);
  if (e == cudaSuccess)
    e = a.head != nullptr ? encode_weight(&a.maps.head, a.head, 1, a.D, a.V) : encode_embed_rows(&a.maps.head, a.embed, a.V, a.D);
  return e;
}

// The context of a thread's lane from the block's shared memory (every
// thread); each lane's first thread initialises its barriers and producer.
// Ends at a block barrier.
__device__ TcCtx tc_init(unsigned char* smem, const TcLayout& l, float* part, int* cnt) {
  TcCtx c;
  c.wg = threadIdx.x / kLaneThreads;
  c.lane = 2 * blockIdx.x + c.wg;
  c.lanes = 2 * gridDim.x;
  uint8_t* ring = reinterpret_cast<uint8_t*>((reinterpret_cast<uintptr_t>(smem + l.ring) + 1023) & ~uintptr_t(1023));
  c.ring = ring + c.wg * kLaneSlots * kBoxBytes;
  c.full = reinterpret_cast<uint64_t*>(smem + l.bars) + c.wg * kLaneSlots;
  c.pr = reinterpret_cast<Producer*>(smem + l.prod) + c.wg;
  uint8_t* base = reinterpret_cast<uint8_t*>((reinterpret_cast<uintptr_t>(smem) + 1023) & ~uintptr_t(1023));
  c.xs = base + c.wg * 2 * kXsBytes;
  c.ct = reinterpret_cast<float*>(base + 4 * kXsBytes + c.wg * kCtBytes);
  c.part = part;
  c.cnt = cnt;
  c.consumed = 0;
  c.calls = 0;
  if (threadIdx.x % kLaneThreads == 0) {
    for (int i = 0; i < kLaneSlots; ++i) attn_tc::mbar_init(&c.full[i], 1);
    attn_tc::mbar_fence_init();
    c.pr->cur_id = c.pr->nxt_id = -1;
    c.pr->issued = 0;
  }
  __syncthreads();
  return c;
}

// ---------------------------------------------------------------------------
// The window
// ---------------------------------------------------------------------------

// Block 0 stamps the global timer (ns) into prof[slot] when profiling.
__device__ __forceinline__ void stamp(unsigned long long* prof, int64_t slot) {
  if (prof != nullptr && blockIdx.x == 0 && threadIdx.x == 0) {
    unsigned long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    prof[slot] = t;
  }
}

// Block b's greedy pick of row b: the grid's argmax partials [grid, B]
// reduced, ties to the lowest index (0 when every logit is NaN).
template <int B>
__device__ int row_argmax(const float* part_val, const int* part_idx, int b, PickSmem* ps) {
  float bv = -INFINITY;
  int bi = INT_MAX;
  for (int g = threadIdx.x; g < (int)gridDim.x; g += kThreads) {
    const float v = __ldcg(part_val + (int64_t)g * B + b);
    const int ix = __ldcg(part_idx + (int64_t)g * B + b);
    if (v > bv || (v == bv && ix < bi)) {
      bv = v;
      bi = ix;
    }
  }
  block_argmax(bv, bi, ps);
  return bi == INT_MAX ? 0 : bi;
}

// One layer of a one-token step of B rows at positions + i: RMS norm and
// QKV; rope, the K/V write and paged attention; wo and the residual; RMS
// norm and gate | up; down and the residual. Each phase ends at a grid
// barrier, after which block 0 stamps slot s0 + phase when profiling.
template <typename T>
constexpr bool kTensorCores = sizeof(T) == 2;  // bf16 products on wgmma; f32 on the CUDA-core GEMVs

// A bf16 layer of n rows on the tensor cores: decode_layer's phases, the
// chunk's K/V written in a phase of its own first (the spec verify) when
// `chunk_kv`. `after` is the product that follows the layer's down (null:
// none; the next layer's QKV when l + 1 < L).
template <typename T>
__device__ void tc_layer(const Args<T>& a, TcCtx& tc, float* smem, float* inv, int l, int i, int n, bool chunk_kv,
                         const Phase* after, cg::grid_group& grid, int64_t s0);

template <typename T, int B>
__device__ void decode_layer(const Args<T>& a, float* smem, float* inv, int l, int i, cg::grid_group& grid,
                             int64_t s0, TcCtx* tc = nullptr, const Phase* after = nullptr) {
  if constexpr (kTensorCores<T>) {
    tc_layer<T>(a, *tc, smem, inv, l, i, B, false, after, grid, s0);
    return;
  }
  const int D = a.D, F = a.F;
  const int HQ = a.H * a.HD, HKV = a.KVH * a.HD, NQKV = HQ + 2 * HKV;
  // 1. RMS norm and QKV (rope and the K/V write happen in phase 2).
  row_inv<T, B>(a.h, D, a.eps, inv);
  {
    const T* wq = a.wq + (int64_t)l * D * HQ;
    const T* wk = a.wk + (int64_t)l * D * HKV;
    const T* wv = a.wv + (int64_t)l * D * HKV;
    const int tq = HQ / kTile, tk = HKV / kTile;
    auto wsel = [&](int t, const T*& W, int& ldw, int& c0) {
      if (t < tq) {
        W = wq, ldw = HQ, c0 = t * kTile;
      } else if (t < tq + tk) {
        W = wk, ldw = HKV, c0 = (t - tq) * kTile;
      } else {
        W = wv, ldw = HKV, c0 = (t - tq - tk) * kTile;
      }
    };
    gemv_cols<T, B>(smem, D, NQKV / kTile, B, XNorm<T>{a.h, D, inv, a.anorm + (int64_t)l * D}, wsel,
                    OutRows<T>{a.qkv, NQKV}, NoAfter{});
  }
  grid.sync();
  stamp(a.prof, s0);
  // 2. Rope, write the step's K/V, paged attention.
  attention<T>(a, smem, l, i, B);
  grid.sync();
  stamp(a.prof, s0 + 1);
  // 3. wo and the residual.
  {
    const T* wo = a.wo + (int64_t)l * HQ * D;
    auto wsel = [&](int t, const T*& W, int& ldw, int& c0) { W = wo, ldw = D, c0 = t * kTile; };
    gemv_cols<T, B>(smem, HQ, D / kTile, B, XRows<T>{a.attn, HQ}, wsel, OutResidual<T>{a.h, D}, NoAfter{});
  }
  grid.sync();
  stamp(a.prof, s0 + 2);
  // 4. RMS norm, gate | up (silu * up is formed when phase 5 stages it).
  row_inv<T, B>(a.h, D, a.eps, inv);
  {
    const T* wg = a.wg + (int64_t)l * D * F;
    const T* wu = a.wu + (int64_t)l * D * F;
    const int tg = F / kTile;
    auto wsel = [&](int t, const T*& W, int& ldw, int& c0) {
      if (t < tg) {
        W = wg, ldw = F, c0 = t * kTile;
      } else {
        W = wu, ldw = F, c0 = (t - tg) * kTile;
      }
    };
    gemv_cols<T, B>(smem, D, 2 * F / kTile, B, XNorm<T>{a.h, D, inv, a.mnorm + (int64_t)l * D}, wsel,
                    OutRows<T>{a.gu, 2 * F}, NoAfter{});
  }
  grid.sync();
  stamp(a.prof, s0 + 3);
  // 5. down and the residual.
  {
    const T* wd = a.wd + (int64_t)l * F * D;
    auto wsel = [&](int t, const T*& W, int& ldw, int& c0) { W = wd, ldw = D, c0 = t * kTile; };
    gemv_cols<T, B>(smem, F, D / kTile, B, XSiluUp<T>{a.gu, F}, wsel, OutResidual<T>{a.h, D}, NoAfter{});
  }
  grid.sync();
  stamp(a.prof, s0 + 4);
}

// Final norm and head of B rows: each tile's f32 logits (masked where a
// guided row's FSM row disallows a token) folded into this block's (max,
// first index) per row, which go to part_val / part_idx [grid, B]; with
// `logits` [B, V] each row's logits are stored there too, divided by
// temps[b] where that is > 0. A block whose tiles a row's mask covers
// keeps (-inf, INT_MAX) for it, which row_argmax's reduction passes over.
// Ends at a grid barrier.
template <typename T, int B>
__device__ void decode_head(const Args<T>& a, float* smem, float* inv, float* lgs, float* best_v, int* best_i,
                            float* logits, const float* temps, cg::grid_group& grid, TcCtx* tc = nullptr,
                            const Phase* next = nullptr) {
  const int tid = threadIdx.x, D = a.D, V = a.V;
  constexpr int kBest = kTensorCores<T> ? 2 : 1;  // the tensor-core products keep one (max, index) per lane
  int* rows = best_i + kBest * B;  // [B], the last of the tail
  row_inv<T, B>(a.h, D, a.eps, inv);
  if (tid < kBest * B) {
    best_v[tid] = -INFINITY;
    best_i[tid] = INT_MAX;
  }
  // The carry was written by block `tid` before a grid barrier: read through L2.
  if (tid < B && a.mask != nullptr) rows[tid] = __ldcg(a.grow + tid);
  __syncthreads();
  if constexpr (kTensorCores<T>) {
    const XSrc x{kXNorm, a.h, D, inv, a.fnorm, 0};
    OutDst out = {};
    out.kind = kOutLogits, out.lgs = lgs, out.mask = a.mask, out.rows = rows, out.W32 = a.W32, out.B = B, out.V = V;
    out.logits = logits, out.temps = temps, out.best_v = best_v, out.best_i = best_i;
    tc_product<1>(*tc, make_phase(a, kPhHead, 0, B), next, x, out);
    __syncthreads();
    if (tid < B) {  // the two lanes' (max, first index): the larger, the lower index on a tie
      const float v1 = best_v[B + tid];
      const int i1 = best_i[B + tid];
      if (v1 > best_v[tid] || (v1 == best_v[tid] && i1 < best_i[tid])) best_v[tid] = v1, best_i[tid] = i1;
    }
  } else {
    const XNorm<T> xf{a.h, D, inv, a.fnorm};
    const ArgmaxTile<B> fold{lgs, best_v, best_i, logits, temps, V};
    const OutLogits<B> out{lgs, a.mask, rows, a.W32};
    if (a.head != nullptr) {
      const T* hw = a.head;
      auto wsel = [&](int t, const T*& W, int& ldw, int& c0) { W = hw, ldw = V, c0 = t * kTile; };
      gemv_cols<T, B>(smem, D, V / kTile, B, xf, wsel, out, fold);
    } else {
      gemv_rows<T, B>(smem, a.embed, D, V / kTile, B, xf, out, fold);
    }
  }
  if (tid < B) {
    a.part_val[(int64_t)blockIdx.x * B + tid] = best_v[tid];
    a.part_idx[(int64_t)blockIdx.x * B + tid] = best_i[tid];
  }
  grid.sync();
}

// The spec kernel's verify writes its chunk's K/V before any row attends.
// The verify's K/V: every row's key roped at its position and written with
// its value (a dead row's to block 0, offset 0), one (row, KV head) per item.
template <typename T>
__device__ void write_chunk_kv(const Args<T>& a, int n, int l) {
  const int KVH = a.KVH, HD = a.HD, BS = a.BS, W = a.W, half = HD / 2;
  const int HQ = a.H * HD, HKV = KVH * HD, NQKV = HQ + 2 * HKV;
  const int64_t tok_stride = (int64_t)KVH * HD, page_stride = (int64_t)BS * tok_stride;
  T* kc = a.kc + (int64_t)l * a.N * page_stride;
  T* vc = a.vc + (int64_t)l * a.N * page_stride;
  for (int item = blockIdx.x; item < n * KVH; item += gridDim.x) {
    const int rv = item / KVH, kvh = item % KVH;
    const bool live = a.active[rv] != 0;
    const int pos = __ldcg(a.positions + rv);
    const int slot = live ? pos : 0;
    const int64_t blk = (live && slot / BS < W) ? a.tables[(int64_t)rv * W + slot / BS] : 0;
    const int64_t dst = blk * page_stride + (int64_t)(slot % BS) * tok_stride + (int64_t)kvh * HD;
    const T* kr = a.qkv + (int64_t)rv * NQKV + HQ + (int64_t)kvh * HD;
    for (int j = threadIdx.x; j < half; j += kThreads) {
      const float freq = 1.f / powf(a.theta, (float)(2 * j) / (float)HD);
      float sn, cs;
      sincosf((float)pos * freq, &sn, &cs);
      const float x1 = ld_scratch(kr + j), x2 = ld_scratch(kr + j + half);
      kc[dst + j] = from_f<T>(x1 * cs - x2 * sn);
      kc[dst + j + half] = from_f<T>(x2 * cs + x1 * sn);
    }
    for (int e = threadIdx.x; e < HD; e += kThreads) vc[dst + e] = from_f<T>(ld_scratch(kr + HKV + e));
  }
}

template <typename T>
__device__ void tc_layer(const Args<T>& a, TcCtx& tc, float* smem, float* inv, int l, int i, int n, bool chunk_kv,
                         const Phase* after, cg::grid_group& grid, int64_t s0) {
  const int D = a.D, F = a.F;
  const int HQ = a.H * a.HD, HKV = a.KVH * a.HD, NQKV = HQ + 2 * HKV;
  const Phase qkv = make_phase(a, kPhQkv, l, n), wo = make_phase(a, kPhWo, l, n);
  const Phase gu = make_phase(a, kPhGu, l, n), down = make_phase(a, kPhDown, l, n);
  const Phase next_qkv = make_phase(a, kPhQkv, l + 1, n);
  OutDst rows = {}, resid = {};
  rows.kind = kOutRows;
  resid.kind = kOutResidual, resid.y = a.h, resid.ld = D;
  // 1. RMS norm and QKV.
  row_inv_rows<T>(a.h, n, D, a.eps, inv);
  rows.y = a.qkv, rows.ld = NQKV;
  tc_product_rows(tc, qkv, &wo, XSrc{kXNorm, a.h, D, inv, a.anorm + (int64_t)l * D, 0}, rows);
  grid.sync();
  stamp(a.prof, s0);
  // 2. Rope, the K/V write, paged attention.
  if (chunk_kv) {
    write_chunk_kv<T>(a, n, l);
    grid.sync();
    attention<T>(a, smem, l, 0, n, /*write_kv=*/false);
  } else {
    attention<T>(a, smem, l, i, n);
  }
  grid.sync();
  stamp(a.prof, s0 + 1);
  // 3. wo and the residual.
  tc_product_rows(tc, wo, &gu, XSrc{kXRows, a.attn, HQ, nullptr, nullptr, 0}, resid);
  grid.sync();
  stamp(a.prof, s0 + 2);
  // 4. RMS norm, gate | up.
  row_inv_rows<T>(a.h, n, D, a.eps, inv);
  rows.y = a.gu, rows.ld = 2 * F;
  tc_product_rows(tc, gu, &down, XSrc{kXNorm, a.h, D, inv, a.mnorm + (int64_t)l * D, 0}, rows);
  grid.sync();
  stamp(a.prof, s0 + 3);
  // 5. down (silu(gate) * up staged) and the residual.
  tc_product_rows(tc, down, l + 1 < a.L ? &next_qkv : after, XSrc{kXSiluUp, a.gu, 2 * F, nullptr, nullptr, F}, resid);
  grid.sync();
  stamp(a.prof, s0 + 4);
}

}  // namespace
