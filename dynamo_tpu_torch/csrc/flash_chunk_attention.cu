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
// the tensor cores' rate (989 TFLOP/s in bf16). The first version ran the
// products on CUDA cores in f32, at 1.6 % of that bound.
//
// bf16 (the served dtype), every head dim (16, 32, 64, 128): wgmma fed by TMA.
// - grid (query tiles, KVH): a block owns 128 rows of (query, grouped head)
//   pairs of one KV head, BQ = 128/G queries, so each K/V tile in shared
//   memory serves the G heads. Rows past BQ·G (G not dividing 128) are zero
//   and never stored. The latest query tiles, which walk the most keys, are
//   scheduled first.
// - 288 threads: two consumer warpgroups (rows 0-63, 64-127: wgmma's M = 64)
//   and one producer warp. The producer loads the Q tile once (a 4-D TMA box
//   over q viewed as [T, KVH, G, HD]) and keeps a ring of 3 stages of 64
//   keys of K and V (2-D boxes over [T, KVH·HD] at column kvh·HD), one
//   full mbarrier per stage for K and one for V, one empty mbarrier that
//   all 256 consumer threads arrive on. Tiles wholly above the block's last
//   causal frontier or past valid_len are neither loaded nor computed; keys
//   past T come in as zeros (TMA's out-of-bounds fill).
// - swizzle: a row of HD bf16 is 32/64/128 bytes at HD = 16/32/64, and the
//   boxes take the matching swizzle; HD = 128 is two boxes of 64 columns.
//   So every served width and the test widths take the same kernel.
// - S = Q·Kᵀ: wgmma m64n64k16 over HD/16 k-steps, both operands K-major in
//   shared memory. The online softmax runs on the fragments (a row's 16
//   values per thread, reduced across its 4 lanes by shuffles); the score
//   scale rides in the exponent (one FMA and one ex2 a score); l sums p in
//   f32. The mask is applied only on the tiles that cross a row's causal
//   frontier or valid_len, in a copy of the softmax of their own: compares
//   on every tile were the largest single cost found in this kernel.
// - O += P·V: P is S's fragment rounded to bf16 in registers (wgmma's A);
//   V is the [keys, HD] tile, N-major, read with the descriptor's transpose
//   bit; wgmma m64n{HD}k16 over 4 k-steps of 16 keys.
// - software pipeline in each warpgroup: tile i's QK product is issued with
//   tile i-1's PV product behind it, and tile i's softmax (bound by the
//   special-function unit's ex2 rate) runs while PV(i-1) is on the tensor
//   cores; O's rescale waits for PV(i-1).
// - out is stored from the fragments in bf16, m and l to [T, KVH, G].
// - registers: 141 a thread at HD = 64, 166 at 128 (ptxas), under the 224
//   a thread may hold at 288 threads a block, so registers are not shifted
//   between warps (no setmaxnreg). One block an SM: at two (112 registers)
//   the pipelined HD = 64 kernel spills and serializes its wgmma.
//
// f32: the first version's CUDA-core kernel, kept as it was (TF32 would
// miss the 5e-5 bounds that the f32 checks hold it to):
// - grid (query tiles, KVH): a block owns 64 query rows, i.e. 64/G queries
//   times the G query heads of one KV head.
// - the block walks K/V tiles of 64 keys up to its queries' causal frontier
//   (and valid_len), never past it.
// - 256 threads as a 16x16 grid; each thread keeps a 4x4 tile of scores and
//   a 4x(HD/16) tile of the f32 accumulator in registers. Row strides are
//   padded by one float so a warp's reads fall in distinct banks.
// - a K/V tile is loaded as 16-byte vectors into registers, and the next
//   tile's loads are issued before the current tile's products.
// - the online-softmax update takes one warp per row (shuffle reductions).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "attention_tc.cuh"

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

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) {
  return x;
}

// x rounded to T and back: the cast of p to v's dtype.
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  const T y = from_f<T>(x);
  return load_f(&y);
}

// One 16-byte vector of floats.
__device__ __forceinline__ void widen(const uint4& raw, float* out, float) {
  out[0] = __uint_as_float(raw.x);
  out[1] = __uint_as_float(raw.y);
  out[2] = __uint_as_float(raw.z);
  out[3] = __uint_as_float(raw.w);
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

// ---- bf16: tensor cores ------------------------------------------------------

constexpr int kTcRows = 128;     // (query, head) rows per block: two warpgroups of 64
constexpr int kTcKeys = 64;      // keys per K/V stage
constexpr int kTcStages = 3;
constexpr int kTcConsumers = 256;
constexpr int kTcThreads = kTcConsumers + 32;  // + the producer warp

template <int HD>
struct TcShape {
  static constexpr int kChunk = HD < 64 ? HD : 64;  // columns per swizzled row
  static constexpr int kRowBytes = kChunk * 2;
  static constexpr int kChunks = HD / kChunk;
  static constexpr int kLayout = attn_tc::desc_layout(kRowBytes);
  static constexpr int kQChunkBytes = kTcRows * kRowBytes;
  static constexpr int kKvChunkBytes = kTcKeys * kRowBytes;
  static constexpr int kQBytes = kChunks * kQChunkBytes;
  static constexpr int kKvBytes = kChunks * kKvChunkBytes;  // one K or V stage
  // 1024 bytes of slack to align the base for the swizzle, then Q, the K
  // ring, the V ring and the barriers.
  static constexpr size_t kSmem = 1024 + kQBytes + 2 * kTcStages * kKvBytes + 8 * (1 + 3 * kTcStages);
};

template <int HD>
__global__ void __launch_bounds__(kTcThreads, 1) flash_chunk_tc_kernel(
    const __grid_constant__ CUtensorMap qmap,  // q as [T, KVH, G, HD]
    const __grid_constant__ CUtensorMap kmap,  // k as [T, KVH*HD]
    const __grid_constant__ CUtensorMap vmap,  // v as [T, KVH*HD]
    __nv_bfloat16* __restrict__ out,           // [T, H, HD]
    float* __restrict__ m_out,                 // [T, KVH, G]
    float* __restrict__ l_out,                 // [T, KVH, G]
    int T_, int H, int KVH, int valid_len, float scale) {
  using S = TcShape<HD>;
  using namespace attn_tc;
  const float scale_log2e = scale * 1.4426950408889634f;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sq = reinterpret_cast<uint8_t*>((reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* sk = sq + S::kQBytes;
  uint8_t* sv = sk + kTcStages * S::kKvBytes;
  uint64_t* q_full = reinterpret_cast<uint64_t*>(sv + kTcStages * S::kKvBytes);
  uint64_t* k_full = q_full + 1;
  uint64_t* v_full = k_full + kTcStages;
  uint64_t* empty = v_full + kTcStages;

  const int G = H / KVH;
  const int BQ = kTcRows / G;
  const int rows = BQ * G;
  const int kvh = blockIdx.y;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;  // latest tiles first
  const int n_keys = min(min(q0 + BQ, T_), valid_len);  // keys up to the last query's frontier
  const int nt = (n_keys + kTcKeys - 1) / kTcKeys;
  const int tid = threadIdx.x;

  if (tid == kTcConsumers) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kTcStages; ++s) {
      mbar_init(&k_full[s], 1);
      mbar_init(&v_full[s], 1);
      mbar_init(&empty[s], kTcConsumers);
    }
    mbar_fence_init();
  }
  // Rows past BQ*G take no TMA box: zero them, for the async proxy to read.
  constexpr int kVecPerRow = S::kRowBytes / 16;
  for (int i = tid; i < S::kChunks * (kTcRows - rows) * kVecPerRow; i += kTcThreads) {
    const int c = i / ((kTcRows - rows) * kVecPerRow), rem = i % ((kTcRows - rows) * kVecPerRow);
    *reinterpret_cast<uint4*>(sq + c * S::kQChunkBytes + (rows + rem / kVecPerRow) * S::kRowBytes +
                              (rem % kVecPerRow) * 16) = make_uint4(0u, 0u, 0u, 0u);
  }
  fence_proxy_async();
  __syncthreads();

  if (tid >= kTcConsumers) {
    // Producer: one thread issues every load.
    if (tid == kTcConsumers) {
      mbar_arrive_expect_tx(q_full, rows * HD * 2);
#pragma unroll
      for (int c = 0; c < S::kChunks; ++c) tma_load_4d(sq + c * S::kQChunkBytes, &qmap, q_full, c * S::kChunk, 0, kvh, q0);
      for (int i = 0; i < nt; ++i) {
        const int s = i % kTcStages;
        if (i >= kTcStages) mbar_wait(&empty[s], ((i / kTcStages) - 1) & 1);
        mbar_arrive_expect_tx(&k_full[s], S::kKvBytes);
#pragma unroll
        for (int c = 0; c < S::kChunks; ++c)
          tma_load_2d(sk + s * S::kKvBytes + c * S::kKvChunkBytes, &kmap, &k_full[s], kvh * HD + c * S::kChunk,
                      i * kTcKeys);
        mbar_arrive_expect_tx(&v_full[s], S::kKvBytes);
#pragma unroll
        for (int c = 0; c < S::kChunks; ++c)
          tma_load_2d(sv + s * S::kKvBytes + c * S::kKvChunkBytes, &vmap, &v_full[s], kvh * HD + c * S::kChunk,
                      i * kTcKeys);
      }
    }
    return;
  }

  // Consumers: warpgroup wg owns rows 64wg .. 64wg+63; this thread rows r0
  // and r0 + 8 (fragment halves h = 0, 1).
  const int wg = tid / 128, warp = (tid % 128) / 32, lane = tid % 32;
  const int r0 = wg * 64 + warp * 16 + lane / 4;
  const int row_t[2] = {q0 + r0 / G, q0 + (r0 + 8) / G};
  const int col0 = 2 * (lane % 4);
  // Row t sees keys < min(t + 1, valid_len); tiles below n_full are wholly
  // visible to every row of the block.
  const int limit[2] = {min(row_t[0] + 1, valid_len), min(row_t[1] + 1, valid_len)};
  const int n_full = min(q0 + 1, valid_len) / kTcKeys;
  float o[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) o[i] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f}, alpha[2];
  float sc[32];
  uint32_t pa[4][4];
  const uint32_t q_addr = smem_u32(sq) + wg * 64 * S::kRowBytes;
  constexpr uint32_t kSbo = 8 * S::kRowBytes;

  // S = Q·K(i) of 64 rows × 64 keys into sc.
  auto qk = [&](int i) {
    const uint32_t k_addr = smem_u32(sk + (i % kTcStages) * S::kKvBytes);
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      const int c = (kk * 16) / S::kChunk;
      const uint32_t off = ((kk * 16) % S::kChunk) * 2;
      wgmma_ss_n64(sc, smem_desc(q_addr + c * S::kQChunkBytes + off, 16, kSbo, S::kLayout),
                   smem_desc(k_addr + c * S::kKvChunkBytes + off, 16, kSbo, S::kLayout), kk > 0);
    }
  };
  // O += P·V(i), P in pa.
  auto pv = [&](int i) {
    const uint32_t v_addr = smem_u32(sv + (i % kTcStages) * S::kKvBytes);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_rs<HD>(o, pa[kk], smem_desc(v_addr + kk * 16 * S::kRowBytes, S::kKvChunkBytes, kSbo, S::kLayout));
  };
  auto softmax = [&](int i) {
    // Only the tiles past n_full cross a row's frontier and take the mask.
    if (i < n_full) online_softmax<false>(sc, m, l, alpha, i * kTcKeys, col0, limit, scale_log2e);
    else online_softmax<true>(sc, m, l, alpha, i * kTcKeys, col0, limit, scale_log2e);
  };
  auto pack = [&]() {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) pack_p(sc, kk, pa[kk]);
  };
  auto phase_of = [](int i) { return (uint32_t)((i / kTcStages) & 1); };

  // Software pipeline: while tile i's softmax runs on the CUDA cores, tile
  // i-1's P·V runs on the tensor cores. Tile 0's scores first.
  mbar_wait(q_full, 0);
  mbar_wait(&k_full[0], 0);
  __syncwarp();
  wgmma_fence();
  qk(0);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(sc);
  softmax(0);  // O is still zero: no rescale
  pack();
  for (int i = 1; i < nt; ++i) {
    mbar_wait(&k_full[i % kTcStages], phase_of(i));
    mbar_wait(&v_full[(i - 1) % kTcStages], phase_of(i - 1));
    __syncwarp();
    fence_regs(sc);
    fence_regs(o);
    fence_regs(pa);
    wgmma_fence();
    qk(i);
    wgmma_commit();
    pv(i - 1);
    wgmma_commit();
    wgmma_wait<1>();  // S(i) is done; P·V(i-1) may still run
    fence_regs(sc);
    softmax(i);
    wgmma_wait<0>();
    fence_regs(o);
    fence_regs(pa);
    mbar_arrive(&empty[(i - 1) % kTcStages]);
    rescale_rows(o, alpha);
    pack();
  }
  mbar_wait(&v_full[(nt - 1) % kTcStages], phase_of(nt - 1));
  __syncwarp();
  fence_regs(o);
  fence_regs(pa);
  wgmma_fence();
  pv(nt - 1);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(o);
  mbar_arrive(&empty[(nt - 1) % kTcStages]);

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = r0 + 8 * h, t = row_t[h];
    if (r >= rows || t >= T_) continue;
    const int g = r % G;
    const float lc = fmaxf(l[h], 1e-30f);
    __nv_bfloat16* orow = out + ((int64_t)t * H + (int64_t)kvh * G + g) * HD;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j + col0) =
          __floats2bfloat162_rn(o[4 * j + 2 * h] / lc, o[4 * j + 2 * h + 1] / lc);
    if (lane % 4 == 0) {
      const int64_t st = ((int64_t)t * KVH + kvh) * G + g;
      m_out[st] = m[h] * scale;
      l_out[st] = l[h];
    }
  }
}

template <int HD>
cudaError_t launch_tc(const void* q, const void* k, const void* v, void* out, float* m, float* l, int T_, int H,
                      int KVH, int valid_len, cudaStream_t stream) {
  using S = TcShape<HD>;
  const int G = H / KVH, BQ = kTcRows / G;
  CUtensorMap qmap, kmap, vmap;
  {
    const cuuint64_t dims[4] = {(cuuint64_t)HD, (cuuint64_t)G, (cuuint64_t)KVH, (cuuint64_t)T_};
    const cuuint64_t strides[3] = {(cuuint64_t)HD * 2, (cuuint64_t)G * HD * 2, (cuuint64_t)H * HD * 2};
    const cuuint32_t box[4] = {(cuuint32_t)S::kChunk, (cuuint32_t)G, 1, (cuuint32_t)BQ};
    cudaError_t e = attn_tc::encode_tiled(&qmap, 4, q, dims, strides, box, S::kRowBytes);
    if (e != cudaSuccess) return e;
  }
  {
    const cuuint64_t dims[2] = {(cuuint64_t)KVH * HD, (cuuint64_t)T_};
    const cuuint64_t strides[1] = {(cuuint64_t)KVH * HD * 2};
    const cuuint32_t box[2] = {(cuuint32_t)S::kChunk, (cuuint32_t)kTcKeys};
    cudaError_t e = attn_tc::encode_tiled(&kmap, 2, k, dims, strides, box, S::kRowBytes);
    if (e == cudaSuccess) e = attn_tc::encode_tiled(&vmap, 2, v, dims, strides, box, S::kRowBytes);
    if (e != cudaSuccess) return e;
  }
  static bool opted_in = false;  // the attribute is per function, set once
  if (!opted_in) {
    cudaError_t e = cudaFuncSetAttribute(flash_chunk_tc_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)S::kSmem);
    if (e != cudaSuccess) return e;
    opted_in = true;
  }
  const dim3 grid((T_ + BQ - 1) / BQ, KVH);
  flash_chunk_tc_kernel<HD><<<grid, kTcThreads, S::kSmem, stream>>>(
      qmap, kmap, vmap, static_cast<__nv_bfloat16*>(out), m, l, T_, H, KVH, valid_len, rsqrtf((float)HD));
  return cudaGetLastError();
}

// ---- f32: CUDA cores ------------------------------------------------------------

template <int HD>
cudaError_t launch_f32(const void* q, const void* k, const void* v, void* out, float* m, float* l, int T_, int H,
                       int KVH, int valid_len, cudaStream_t stream) {
  const size_t smem = smem_floats(HD) * sizeof(float);
  static bool opted_in = false;  // the attribute is per function, set once
  if (!opted_in) {
    cudaError_t e = cudaFuncSetAttribute(flash_chunk_kernel<float, HD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
    opted_in = true;
  }
  const int BQ = kRows / (H / KVH);
  const dim3 grid((T_ + BQ - 1) / BQ, KVH);
  flash_chunk_kernel<float, HD><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(out), m, l, T_, H, KVH, valid_len, rsqrtf((float)HD));
  return cudaGetLastError();
}

template <int HD>
cudaError_t launch_hd(int dtype, const void* q, const void* k, const void* v, void* out, float* m, float* l, int T_,
                      int H, int KVH, int valid_len, cudaStream_t s) {
  if (dtype == 0) return launch_f32<HD>(q, k, v, out, m, l, T_, H, KVH, valid_len, s);
  return launch_tc<HD>(q, k, v, out, m, l, T_, H, KVH, valid_len, s);
}

}  // namespace

extern "C" {

// Shared-memory bytes one block needs for this dtype (0 = float32,
// 1 = bfloat16) at head dim HD; 0 for a head dim the kernel does not take.
size_t dtt_flash_chunk_attention_smem(int dtype, int HD) {
  switch (HD) {
    case 16: return dtype == 0 ? smem_floats(16) * sizeof(float) : TcShape<16>::kSmem;
    case 32: return dtype == 0 ? smem_floats(32) * sizeof(float) : TcShape<32>::kSmem;
    case 64: return dtype == 0 ? smem_floats(64) * sizeof(float) : TcShape<64>::kSmem;
    case 128: return dtype == 0 ? smem_floats(128) * sizeof(float) : TcShape<128>::kSmem;
    default: return 0;
  }
}

// dtype: 0 = float32, 1 = bfloat16. Needs H % KVH == 0, G = H/KVH <= 64,
// HD in {16, 32, 64, 128}, 1 <= valid_len <= T, q, k and v on 16-byte
// boundaries. Returns cudaGetLastError() after the launch (0 = success);
// launches on `stream` and does not synchronise.
int dtt_flash_chunk_attention(int dtype, const void* q, const void* k, const void* v, void* out,
                              void* m, void* l, int T, int H, int KVH, int HD, int valid_len,
                              void* stream) {
  if (T == 0) return 0;
  if (KVH <= 0 || H % KVH != 0 || H / KVH > kRows || valid_len < 1 || valid_len > T || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  float* mf = static_cast<float*>(m);
  float* lf = static_cast<float*>(l);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (HD) {
    case 16: return launch_hd<16>(dtype, q, k, v, out, mf, lf, T, H, KVH, valid_len, s);
    case 32: return launch_hd<32>(dtype, q, k, v, out, mf, lf, T, H, KVH, valid_len, s);
    case 64: return launch_hd<64>(dtype, q, k, v, out, mf, lf, T, H, KVH, valid_len, s);
    case 128: return launch_hd<128>(dtype, q, k, v, out, mf, lf, T, H, KVH, valid_len, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
