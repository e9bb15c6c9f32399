// Fused decode window for Hopper (sm_90a), CUDA C++ with a plain C entry
// point loaded through ctypes.
//
// Replaces the TPU Pallas kernel `_fused_window_kernel`
// (dynamo_tpu/engine/attention/megakernel.py, launched by
// `fused_decode_window`), greedy and sampled epilogues. One launch runs a
// whole window: num_steps decode steps of B rows through every layer of a
// dense llama, the K/V writes, the head and each row's pick, with each
// step's token fed back on the device. Per step i (positions + i):
//   embed -> per layer [RMS norm, QKV, rope, write K/V, paged attention over
//   kpos <= pos, wo + residual, RMS norm, gate/up, silu*up, down + residual]
//   -> final norm, head logits (f32), the pick: argmax (first index among
//   equal maxima), or, for a sampled row, the draw of JAX
//   `sample_from_uniforms` against the host's uniforms[i, b].
// Every product accumulates in f32 and is rounded to the weight dtype T, as
// in the TPU kernel; the residual h is carried in T; scores are rounded to T
// before scaling (the TPU kernel's einsum of T operands); p stays in f32
// (the TPU kernel rounds the normalized p to T), so in bf16 the two differ
// by p's rounding. Dead rows (active 0) write K/V to block 0, offset 0, and
// attend nothing; their tokens are unspecified.
//
// What bounds it on this card: decode at small batch reads every weight once
// per step and does two operations per weight per row, far below the ~295
// operations per byte where the tensor cores would limit, so the bound is the
// memory rate: 2.47 GB of bf16 weights per step for llama-3.2-1b plus the KV
// pages each row reads. This first version is the simple, right design:
// - ONE persistent cooperative launch (cudaLaunchCooperativeKernel), a grid
//   no larger than occupancy x SMs. The TPU grid's sequential (step, layer)
//   axes become loops inside the kernel; the phases that the TPU ran one
//   after another on one core are separated by grid-wide barriers
//   (cooperative_groups::this_grid().sync()): 5 per layer and 2 per step.
//   Every block reaches every barrier; blocks without work in a phase skip
//   its loop, never return.
// - Weights stay in the JAX layout [L, in, out] and stream from HBM once
//   per step. A GEMV phase splits its output columns into tiles of 16; a
//   block takes tiles grid-stride, its 256 threads split the reduction
//   dimension, each thread loads up to 16 bytes of a weight row at a time
//   and keeps B x VEC accumulators in registers (B is a template parameter,
//   VEC = min(16 bytes, 64 / B) elements). The input rows (RMS-normed, or
//   silu(gate)*up) are staged in shared memory in f32, in chunks of
//   32768 / B columns, 16 bytes per load; a whole hidden row fits for
//   B <= 16, so a block stages it once per phase for all its tiles.
// - The tied head (embed [V, D]) is read row by row: a tile is 16 vocab rows,
//   16 threads share each row's reduction.
// - Attention: one work item per (row, KV head, key split): a row's
//   pos + 1 keys are cut into S runs of whole 64-key tiles, S = the grid
//   over B x KVH (at most 16), so small batches still fill the card. The
//   item's G query heads share each staged tile; an online softmax in f32
//   gives the split's partial (acc, m, l), and the last split of a (row,
//   KV head) to finish (an atomic counter) merges the S partials into the
//   attention row. The split holding the row's last key
//   writes the step's K/V row first (threadfence + syncthreads), so
//   write-before-attend needs no grid barrier. Page offsets are 64-bit.
// - Scratch written inside the kernel (h, qkv, attention partials and
//   rows, gate|up, argmax partials, the KV cache) is read through L2 (__ldcg),
//   never through the read-only path, which could serve a value from
//   before the last barrier.
// - Argmax is two-level: each block keeps its (max, first index) per row
//   over its vocab tiles; after a barrier block b reduces row b's partials,
//   writes its token and embeds it for the next step (the step's closing
//   barrier orders that before anyone reads h).
// - The sampled epilogue (a runtime flag: null temps when off, so the
//   template instances stay 12): the head phase also stores each tile's f32
//   logits, divided by the row's temperature (a division, as JAX scales),
//   in a [B, V] scratch (16.4 MB at B = 32, served from L2), and after the
//   barrier block b draws row b when its temperature is > 0, as JAX
//   `filtered_probs_rows` + `pick_from_probs` (dynamo_tpu/engine/
//   sampling.py) compute it, without a sort: the scaled row's max and lse
//   by block reductions; the top-k threshold is the k-th largest scaled
//   value, found exactly by a radix select over the order-preserving
//   uint32 key of the float (4 passes of 256-bin shared histograms, 32
//   lane copies); the top-p threshold is the smallest value v with
//   sum_{s > v} exp(s - lse) < top_p (JAX's "keep while the exclusive mass
//   of the descending sort is < top_p"), found by the same descent with
//   bins summing mass (64-bit fixed point, 2^-40, so the sums do not
//   depend on the order of the atomics); scaled >= max of the two is kept,
//   and the token is the first kept index, in index order, whose
//   cumulative probability exp(s - max) / Z exceeds u (a block scan), or
//   the row's mode when u is past the total. Up to 12 passes over the row,
//   each thread with four 16-byte loads in flight. Its bound is those
//   bytes from L2; one block per row (B rows, the grid's other blocks
//   wait at the step's barrier) stays above it, its 8 warps' instruction
//   rate setting a pass's time. The same device function, alone on given
//   logits, is `dtt_sample_from_uniforms`.
// - With a profile buffer, block 0 stamps the global timer after every
//   grid barrier (and once at its end), so the host can split a window's
//   time by phase; without one the kernel stamps nothing.
// wgmma, TMA weight streaming, split-K for the narrow GEMVs and split-KV for
// long contexts are later work.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

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
  int steps, L, N, BS, H, KVH, HD, W, D, F, V, S;
  float eps, theta;
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
  // xs, warp partials, inv, tile logits, best value, best index
  return (size_t)kXFloats + (size_t)kWarps * B * kTile + B + (size_t)kTile * B + 2 * (size_t)B;
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

// y[b, c] = sum_k x(b, k) * W[k, c] over the column tiles t = blockIdx.x,
// + gridDim.x, ... of a phase. wsel(t, W, ldw, c0) gives the tile's weight
// ([K, ldw] row-major) and first column in it; out(b, col, y) takes each
// result (col over the phase's columns); after(t) runs once the tile is out.
template <typename T, int B, class X, class WSel, class Out, class After>
__device__ void gemv_cols(float* smem, int K, int ntiles, const X& x, const WSel& wsel, const Out& out,
                          const After& after) {
  using G = Gemv<T, B>;
  float* xs = smem;
  float* red = smem + kXFloats;  // [kWarps][B][kTile]
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int cx = tid % G::CT, ky = tid / G::CT;
  const bool one_chunk = K <= G::KC;
  bool staged = false;
  for (int t = blockIdx.x; t < ntiles; t += gridDim.x) {
    const T* W;
    int ldw, c0;
    wsel(t, W, ldw, c0);
    float acc[B][G::VEC];
#pragma unroll
    for (int b = 0; b < B; ++b)
#pragma unroll
      for (int v = 0; v < G::VEC; ++v) acc[b][v] = 0.f;
    for (int k0 = 0; k0 < K; k0 += G::KC) {
      const int kn = min(G::KC, K - k0);
      if (!(one_chunk && staged)) {
        __syncthreads();  // earlier readers of xs are done
        stage<T, B, G::KC>(xs, k0, kn, x);
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
      float s = 0.f;
      for (int w = 0; w < kWarps; ++w) s += red[(w * B + b) * kTile + c];
      out(b, t * kTile + c, s);
    }
    __syncthreads();
    after(t);
  }
}

// y[b, r] = sum_k x(b, k) * Wr[r, k] over row tiles of Wr [ntiles * 16, K]
// (the tied head: embed rows). out(b, row, y); after(t) once the tile is out.
template <typename T, int B, class X, class Out, class After>
__device__ void gemv_rows(float* smem, const T* Wr, int K, int ntiles, const X& x, const Out& out,
                          const After& after) {
  constexpr int VEC = 16 / (int)sizeof(T);
  constexpr int KC = kXFloats / B;
  float* xs = smem;
  const int tid = threadIdx.x, r = tid / 16, kl = tid % 16;
  const bool one_chunk = K <= KC;
  bool staged = false;
  for (int t = blockIdx.x; t < ntiles; t += gridDim.x) {
    float acc[B];
#pragma unroll
    for (int b = 0; b < B; ++b) acc[b] = 0.f;
    const T* wr = Wr + ((int64_t)t * kTile + r) * K;
    for (int k0 = 0; k0 < K; k0 += KC) {
      const int kn = min(KC, K - k0);
      if (!(one_chunk && staged)) {
        __syncthreads();
        stage<T, B, KC>(xs, k0, kn, x);
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
      for (int b = 0; b < B; ++b) out(b, t * kTile + r, acc[b]);
    }
    __syncthreads();
    after(t);
    __syncthreads();
  }
}

// inv[b] = rsqrt(mean(h[b]^2) + eps), one warp per row, 16 bytes per load.
template <typename T, int B>
__device__ void row_inv(const T* h, int D, float eps, float* inv) {
  constexpr int VEC = 16 / (int)sizeof(T);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  __syncthreads();  // the previous phase is done with inv
  for (int b = warp; b < B; b += kWarps) {
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

template <int B>
struct OutLogits {  // this tile's f32 logits: lgs[(c % 16) * B + b]
  float* lgs;
  __device__ void operator()(int b, int c, float v) const { lgs[(c % kTile) * B + b] = v; }
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

template <typename T>
__device__ void attention(const Args<T>& a, float* smem, int l, int i, int B) {
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
    const int pos = a.positions[b] + i;
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
    const bool writer = live ? (len - 1) / chunk == sp : sp == 0;

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

// One sampled row's token from its temperature-scaled f32 logits row[0, V)
// (logits / t, divided where they were stored), by the whole block; every
// thread returns it. JAX `filtered_probs_rows` then `pick_from_probs(probs,
// u)`: keep scaled >= max(k-th largest (top_k > 0), top-p threshold (top_p
// < 1)); p = exp(scaled - max) / Z over the kept; the first index whose
// cumulative p exceeds u, or the mode when u is past the total. Not
// inlined: one copy serves the window's 12 template instances and the
// epilogue kernel.
__device__ __noinline__ int sample_row(const float* row, int V, int top_k, float top_p, float u, PickSmem* ps) {
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  float m;
  int mode;
  row_mode(row, V, m, mode, ps);
  if (mode == INT_MAX) return 0;  // no finite logit
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
  zk = block_sum(zk, ps);

  // Inverse CDF in index order: tiles of kThreads x kScanItems consecutive
  // logits (float4 loads), a block scan of the threads' sums, the carry
  // across tiles.
  if (tid == 0) ps->bint[2] = INT_MAX;
  __syncthreads();
  float carry = 0.f;
  for (int base = 0; base < V; base += kThreads * kScanItems) {
    const int i0 = base + tid * kScanItems;
    float sv[kScanItems];
#pragma unroll
    for (int q = 0; q < kScanItems / 4; ++q) {
      const float4 v = i0 + 4 * q < V ? __ldcg(reinterpret_cast<const float4*>(row + i0) + q)
                                      : make_float4(-INFINITY, -INFINITY, -INFINITY, -INFINITY);
      sv[4 * q] = v.x, sv[4 * q + 1] = v.y, sv[4 * q + 2] = v.z, sv[4 * q + 3] = v.w;
    }
    float cum[kScanItems];
    bool kept[kScanItems];
    float local = 0.f;
#pragma unroll
    for (int j = 0; j < kScanItems; ++j) {
      float p = 0.f;
      kept[j] = false;
      if (sv[j] >= thresh) {
        p = expf(sv[j] - m) / zk;
        kept[j] = p > 0.f;
      }
      local += p;
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
  return mode;
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

template <typename T, int B>
__global__ void __launch_bounds__(kThreads, 1) fused_window_kernel(const Args<T> a) {
  extern __shared__ __align__(16) float smem[];
  cg::grid_group grid = cg::this_grid();
  const int tid = threadIdx.x;
  const int L = a.L, D = a.D, F = a.F, V = a.V;
  const int HQ = a.H * a.HD, HKV = a.KVH * a.HD, NQKV = HQ + 2 * HKV;
  float* inv = smem + kXFloats + kWarps * B * kTile;
  float* lgs = inv + B;
  float* best_v = lgs + kTile * B;
  int* best_i = reinterpret_cast<int*>(best_v + B);

  // Step 0's embedding, from the host's tokens.
  for (int64_t e = (int64_t)blockIdx.x * kThreads + tid; e < (int64_t)B * D; e += (int64_t)gridDim.x * kThreads) {
    const int b = (int)(e / D), d = (int)(e - (int64_t)b * D);
    const int t = min(max(a.tokens[b], 0), V - 1);
    a.h[e] = a.embed[(int64_t)t * D + d];
  }
  grid.sync();
  stamp(a.prof, 0);

  for (int i = 0; i < a.steps; ++i) {
    // Stamps of step i: after each of the 5 phases of each layer, after the
    // head, and after the argmax (1 + i * (5 L + 2) onwards).
    const int64_t s0 = 1 + (int64_t)i * (5 * L + 2);
    for (int l = 0; l < L; ++l) {
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
        gemv_cols<T, B>(smem, D, NQKV / kTile, XNorm<T>{a.h, D, inv, a.anorm + (int64_t)l * D}, wsel,
                        OutRows<T>{a.qkv, NQKV}, NoAfter{});
      }
      grid.sync();
      stamp(a.prof, s0 + 5 * l);
      // 2. Rope, write the step's K/V, paged attention.
      attention<T>(a, smem, l, i, B);
      grid.sync();
      stamp(a.prof, s0 + 5 * l + 1);
      // 3. wo and the residual.
      {
        const T* wo = a.wo + (int64_t)l * HQ * D;
        auto wsel = [&](int t, const T*& W, int& ldw, int& c0) { W = wo, ldw = D, c0 = t * kTile; };
        gemv_cols<T, B>(smem, HQ, D / kTile, XRows<T>{a.attn, HQ}, wsel, OutResidual<T>{a.h, D}, NoAfter{});
      }
      grid.sync();
      stamp(a.prof, s0 + 5 * l + 2);
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
        gemv_cols<T, B>(smem, D, 2 * F / kTile, XNorm<T>{a.h, D, inv, a.mnorm + (int64_t)l * D}, wsel,
                        OutRows<T>{a.gu, 2 * F}, NoAfter{});
      }
      grid.sync();
      stamp(a.prof, s0 + 5 * l + 3);
      // 5. down and the residual.
      {
        const T* wd = a.wd + (int64_t)l * F * D;
        auto wsel = [&](int t, const T*& W, int& ldw, int& c0) { W = wd, ldw = D, c0 = t * kTile; };
        gemv_cols<T, B>(smem, F, D / kTile, XSiluUp<T>{a.gu, F}, wsel, OutResidual<T>{a.h, D}, NoAfter{});
      }
      grid.sync();
      stamp(a.prof, s0 + 5 * l + 4);
    }

    // Final norm, head logits and this block's argmax partials.
    row_inv<T, B>(a.h, D, a.eps, inv);
    if (tid < B) {
      best_v[tid] = -INFINITY;
      best_i[tid] = INT_MAX;
    }
    __syncthreads();
    {
      const XNorm<T> xf{a.h, D, inv, a.fnorm};
      const ArgmaxTile<B> fold{lgs, best_v, best_i, a.temps != nullptr ? a.logits : nullptr, a.temps, V};
      if (a.head != nullptr) {
        const T* hw = a.head;
        auto wsel = [&](int t, const T*& W, int& ldw, int& c0) { W = hw, ldw = V, c0 = t * kTile; };
        gemv_cols<T, B>(smem, D, V / kTile, xf, wsel, OutLogits<B>{lgs}, fold);
      } else {
        gemv_rows<T, B>(smem, a.embed, D, V / kTile, xf, OutLogits<B>{lgs}, fold);
      }
    }
    if (tid < B) {
      a.part_val[(int64_t)blockIdx.x * B + tid] = best_v[tid];
      a.part_idx[(int64_t)blockIdx.x * B + tid] = best_i[tid];
    }
    grid.sync();
    stamp(a.prof, s0 + 5 * L);

    // Block b picks row b's token (its argmax partials reduced, ties to the
    // lowest index, or its draw), emits it and embeds it for the next step.
    // No block reads another row's token or h before the barrier below.
    if (blockIdx.x < B) {
      const int b = blockIdx.x;
      PickSmem* ps = reinterpret_cast<PickSmem*>(smem);
      int tok;
      if (a.temps != nullptr && a.temps[b] > 0.f) {
        tok = sample_row(a.logits + (int64_t)b * V, V, a.top_ks[b], a.top_ps[b],
                         a.unif[(int64_t)i * B + b], ps);
      } else {
        float bv = -INFINITY;
        int bi = INT_MAX;
        for (int g = tid; g < (int)gridDim.x; g += kThreads) {
          const float v = __ldcg(a.part_val + (int64_t)g * B + b);
          const int ix = __ldcg(a.part_idx + (int64_t)g * B + b);
          if (v > bv || (v == bv && ix < bi)) {
            bv = v;
            bi = ix;
          }
        }
        block_argmax(bv, bi, ps);
        tok = bi == INT_MAX ? 0 : bi;  // every logit NaN: no maximum
      }
      if (tid == 0) {
        a.tokens_out[(int64_t)i * B + b] = tok;
        a.tok[b] = tok;
      }
      if (i + 1 < a.steps) {
        for (int d = tid; d < D; d += kThreads) a.h[(int64_t)b * D + d] = a.embed[(int64_t)tok * D + d];
      }
    }
    // With a profile, the last step closes with a barrier too, so its last
    // stamp covers every row's pick.
    if (i + 1 < a.steps || a.prof != nullptr) grid.sync();
    stamp(a.prof, s0 + 5 * L + 1);
  }
}

template <typename T, int B>
cudaError_t blocks_b(int G, int HD, int* per_sm) {
  const size_t smem = smem_floats(B, G, HD) * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(fused_window_kernel<T, B>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem);
  if (e != cudaSuccess) return e;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, fused_window_kernel<T, B>, kThreads, smem);
}

template <typename T, int B>
cudaError_t launch_b(const Args<T>& a, int grid, cudaStream_t stream) {
  const size_t smem = smem_floats(B, a.H / a.KVH, a.HD) * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(fused_window_kernel<T, B>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem);
  if (e != cudaSuccess) return e;
  void* params[] = {const_cast<Args<T>*>(&a)};
  e = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(fused_window_kernel<T, B>), dim3(grid),
                                  dim3(kThreads), params, smem, stream);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

template <typename T>
cudaError_t blocks_t(int B, int G, int HD, int* per_sm) {
  switch (B) {
    case 1: return blocks_b<T, 1>(G, HD, per_sm);
    case 2: return blocks_b<T, 2>(G, HD, per_sm);
    case 4: return blocks_b<T, 4>(G, HD, per_sm);
    case 8: return blocks_b<T, 8>(G, HD, per_sm);
    case 16: return blocks_b<T, 16>(G, HD, per_sm);
    case 32: return blocks_b<T, 32>(G, HD, per_sm);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t launch_t(const Args<T>& a, int B, int grid, cudaStream_t s) {
  switch (B) {
    case 1: return launch_b<T, 1>(a, grid, s);
    case 2: return launch_b<T, 2>(a, grid, s);
    case 4: return launch_b<T, 4>(a, grid, s);
    case 8: return launch_b<T, 8>(a, grid, s);
    case 16: return launch_b<T, 16>(a, grid, s);
    case 32: return launch_b<T, 32>(a, grid, s);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
int launch_dtype(int B, int grid, const void* const* p, const int* n, float eps, float theta, cudaStream_t s) {
  Args<T> a;
  a.embed = static_cast<const T*>(p[0]);
  a.head = static_cast<const T*>(p[1]);
  a.fnorm = static_cast<const T*>(p[2]);
  a.anorm = static_cast<const T*>(p[3]);
  a.mnorm = static_cast<const T*>(p[4]);
  a.wq = static_cast<const T*>(p[5]);
  a.wk = static_cast<const T*>(p[6]);
  a.wv = static_cast<const T*>(p[7]);
  a.wo = static_cast<const T*>(p[8]);
  a.wg = static_cast<const T*>(p[9]);
  a.wu = static_cast<const T*>(p[10]);
  a.wd = static_cast<const T*>(p[11]);
  a.kc = static_cast<T*>(const_cast<void*>(p[12]));
  a.vc = static_cast<T*>(const_cast<void*>(p[13]));
  a.tokens = static_cast<const int*>(p[14]);
  a.positions = static_cast<const int*>(p[15]);
  a.tables = static_cast<const int*>(p[16]);
  a.active = static_cast<const int*>(p[17]);
  a.tokens_out = static_cast<int*>(const_cast<void*>(p[18]));
  a.h = static_cast<T*>(const_cast<void*>(p[19]));
  a.qkv = static_cast<T*>(const_cast<void*>(p[20]));
  a.part_acc = static_cast<float*>(const_cast<void*>(p[21]));
  a.gu = static_cast<T*>(const_cast<void*>(p[22]));
  a.tok = static_cast<int*>(const_cast<void*>(p[23]));
  a.part_val = static_cast<float*>(const_cast<void*>(p[24]));
  a.part_idx = static_cast<int*>(const_cast<void*>(p[25]));
  a.prof = static_cast<unsigned long long*>(const_cast<void*>(p[26]));
  a.part_ml = static_cast<float*>(const_cast<void*>(p[27]));
  a.attn = static_cast<T*>(const_cast<void*>(p[28]));
  a.split_cnt = static_cast<int*>(const_cast<void*>(p[29]));
  a.temps = static_cast<const float*>(p[30]);
  a.top_ks = static_cast<const int*>(p[31]);
  a.top_ps = static_cast<const float*>(p[32]);
  a.unif = static_cast<const float*>(p[33]);
  a.logits = static_cast<float*>(const_cast<void*>(p[34]));
  a.steps = n[0], a.L = n[1], a.N = n[2], a.BS = n[3], a.H = n[4], a.KVH = n[5], a.HD = n[6];
  a.W = n[7], a.D = n[8], a.F = n[9], a.V = n[10], a.S = n[11];
  a.eps = eps, a.theta = theta;
  if (a.KVH <= 0 || a.H % a.KVH || a.HD % 16 || a.HD > 128 || a.D % kTile || a.F % kTile || a.V % kTile ||
      a.W <= 0 || a.BS <= 0 || a.S <= 0 || grid < B)
    return (int)cudaErrorInvalidValue;
  if (a.temps != nullptr && (a.top_ks == nullptr || a.top_ps == nullptr || a.unif == nullptr || a.logits == nullptr))
    return (int)cudaErrorInvalidValue;
  return (int)launch_t<T>(a, B, grid, s);
}

// The sampled epilogue alone: block b picks row b of logits [B, V] (f32),
// the argmax for a greedy row (t <= 0), else sample_row over the row
// scaled into `scaled` [B, V] first, as the window's head stores it.
__global__ void __launch_bounds__(kThreads) sample_rows_kernel(const float* logits, float* scaled,
                                                               const float* temps, const int* top_ks,
                                                               const float* top_ps, const float* u, int* out,
                                                               int V) {
  extern __shared__ __align__(16) unsigned char pick_smem[];
  PickSmem* ps = reinterpret_cast<PickSmem*>(pick_smem);
  const int b = blockIdx.x;
  const float* row = logits + (int64_t)b * V;
  const float t = temps[b];
  int tok;
  if (t > 0.f) {
    float4* dst = reinterpret_cast<float4*>(scaled + (int64_t)b * V);
    const float4* src = reinterpret_cast<const float4*>(row);
    for (int j = threadIdx.x; j < V / 4; j += kThreads) {
      const float4 x = src[j];
      dst[j] = make_float4(x.x / t, x.y / t, x.z / t, x.w / t);
    }
    __syncthreads();  // the block's stores reach L2 before its __ldcg reads
    tok = sample_row(scaled + (int64_t)b * V, V, top_ks[b], top_ps[b], u[b], ps);
  } else {
    float m;
    row_mode(row, V, m, tok, ps);
    if (tok == INT_MAX) tok = 0;
  }
  if (threadIdx.x == 0) out[b] = tok;
}

}  // namespace

extern "C" {

// Co-resident blocks of the window kernel (occupancy x SMs) at this dtype
// (0 = float32, 1 = bfloat16), batch B, G query heads per KV head and head
// dim; *sm_count gets the SM count. A negative return is -cudaError.
int dtt_fused_decode_window_blocks(int dtype, int B, int G, int HD, int* sm_count) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess) {
    if (dtype == 0)
      e = blocks_t<float>(B, G, HD, &per_sm);
    else if (dtype == 1)
      e = blocks_t<__nv_bfloat16>(B, G, HD, &per_sm);
    else
      e = cudaErrorInvalidValue;
  }
  if (e != cudaSuccess) return -(int)e;
  *sm_count = sms;
  return per_sm * sms;
}

// One window: the pointers below (head and prof may be null; temps null
// for an all-greedy window, else top_ks, top_ps, unif [steps, B] and the
// logits scratch [B, V] f32 too), then steps, L, N, BS, H, KVH, HD, W, D, F,
// V and S, the attention's key splits (the partials hold B * KVH * S * G *
// HD and B * KVH * S * G * 2 floats; the split counters, B * KVH ints, start
// at zero and end at zero). `grid` must be at least B and must not exceed
// dtt_fused_decode_window_blocks. Returns 0 or the cudaError of the
// cooperative launch (e.g. cudaErrorCooperativeLaunchTooLarge); launches on
// `stream` and does not synchronise.
int dtt_fused_decode_window(int dtype, int B, int grid, const void* embed, const void* head,
                            const void* fnorm, const void* anorm, const void* mnorm, const void* wq,
                            const void* wk, const void* wv, const void* wo, const void* wg, const void* wu,
                            const void* wd, void* kc, void* vc, const void* tokens, const void* positions,
                            const void* tables, const void* active, void* tokens_out, void* h, void* qkv,
                            void* part_acc, void* gu, void* tok, void* part_val, void* part_idx, void* prof,
                            void* part_ml, void* attn, void* split_cnt, const void* temps,
                            const void* top_ks, const void* top_ps, const void* unif, void* logits, int steps,
                            int L, int N, int BS, int H, int KVH, int HD, int W, int D, int F, int V, int S,
                            float eps, float theta, void* stream) {
  if (steps <= 0) return 0;
  const void* p[35] = {embed, head, fnorm, anorm, mnorm, wq, wk, wv, wo, wg, wu, wd, kc, vc,
                       tokens, positions, tables, active, tokens_out, h, qkv, part_acc, gu, tok,
                       part_val, part_idx, prof, part_ml, attn, split_cnt, temps, top_ks, top_ps, unif,
                       logits};
  const int n[12] = {steps, L, N, BS, H, KVH, HD, W, D, F, V, S};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_dtype<float>(B, grid, p, n, eps, theta, s);
  if (dtype == 1) return launch_dtype<__nv_bfloat16>(B, grid, p, n, eps, theta, s);
  return (int)cudaErrorInvalidValue;
}

// The sampled epilogue alone on logits [B, V] f32 (V % 4 == 0, 16-byte
// aligned) with temps, top_ks, top_ps and u [B] (the window's pick at one
// step), a scratch `scaled` [B, V] f32: out [B] int tokens. Launches on
// `stream` and does not synchronise; returns 0 or the launch's cudaError.
int dtt_sample_from_uniforms(const void* logits, void* scaled, const void* temps, const void* top_ks,
                             const void* top_ps, const void* u, void* out, int B, int V, void* stream) {
  if (B <= 0) return 0;
  if (V <= 0 || V % 4) return (int)cudaErrorInvalidValue;
  const cudaError_t e = cudaFuncSetAttribute(sample_rows_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                             (int)sizeof(PickSmem));
  if (e != cudaSuccess) return (int)e;
  sample_rows_kernel<<<B, kThreads, sizeof(PickSmem), static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(logits), static_cast<float*>(scaled), static_cast<const float*>(temps),
      static_cast<const int*>(top_ks),
      static_cast<const float*>(top_ps), static_cast<const float*>(u), static_cast<int*>(out), V);
  return (int)cudaGetLastError();
}

}  // extern "C"
