// Ragged paged attention for Hopper (sm_90a), CUDA C++ with a plain C entry
// point loaded through ctypes.
//
// Replaces the TPU Pallas kernel `_mega_kernel`
// (dynamo_tpu/engine/attention/megakernel.py, launched by
// `ragged_paged_attention`). One launch serves a whole step's ragged batch:
// every query attends, under one online softmax, over
//   1. its row's paged prefix: pages tables[meta[0,nq], w], key positions
//      < meta[1,nq] (capped at W*BS), then
//   2. the fresh keys k_extra[meta[2,nq] : meta[3,nq]] (the causal frontier).
// Dead queries (meta[4,nq] == 0) read nothing and write zeros; a live query
// that sees no key writes zeros too. The result is acc / max(l, 1e-30) in
// q's dtype; scores are scaled by HD^-0.5 and masked with -1e30; p is rounded
// to v's dtype before the PV product and l sums it unrounded, as in the TPU
// kernel. The int8 branch (the TPU kernel's `quant=True`) reads int8 codes
// [NP, BS, KVH, HD] and f32 scales [NP, BS, KVH, 1] in place and dequantizes
// as the TPU kernel rounds: k = bf16(code * bf16(scale)) for bf16 queries,
// the exact f32 product for f32 ones. Page and scale offsets are 64-bit.
//
// What bounds it on this card. The steps the port sends are of two kinds,
// and one launch does both:
// - chunk queries (prefill, the chunk of a mixed step, the spec draft's
//   prefill chunks): many consecutive queries of one row share one prefix,
//   so a K/V tile read once serves a whole tile of queries. A 512-query
//   chunk over 1000 keys does ~250 multiply-adds per byte it reads: the
//   bound is the tensor cores' rate.
// - single-query rows (decode, `decode_multi`, the decode rows of a mixed
//   step): one query reads every key of its context once, two multiply-adds
//   per element, so the bound is the memory rate (3.35 TB/s).
// The first version ran one block per (query, KV head) on CUDA cores: a
// chunk re-read its prefix once per query, and a decode row walked its keys
// in one block.
//
// Which query takes which path is decided on the device from `meta` (the
// host never reads it): the queries are cut into tiles of BQ = 128/G
// consecutive queries. A tile's first live query names a row and a prefix
// length; the live queries of the tile with that row and that (capped)
// prefix are its chunk queries when there are at least two of them. Every
// other live query is a split query. (The port's chunk row starts at query
// 0, so a chunk's tail shares a tile with decode rows and stays a chunk; a
// tile of decode rows has one query a row and goes to the split path.)
//
// bf16 queries (the served dtype), over a bf16 pool or an int8 one, head
// dims 16, 32, 64, 128, G <= 64. One grid of 288-thread blocks (168
// registers a thread, one block an SM): ntiles*KVH chunk blocks, the latest
// tiles first, then NB persistent split blocks (one an SM at most).
// - Chunk block (tile, KV head): 128 rows of (query, grouped head) pairs,
//   the flash kernel's tile (csrc/attention_tc.cuh): two consumer
//   warpgroups run S = Q·Kᵀ and O += P·V on wgmma with the online softmax on
//   the fragments, pipelined (tile i's softmax while tile i-1's PV runs).
//   It walks the row's prefix in 64-key tiles (4 pages of 16), then the
//   fresh keys [min e_start, max e_end) of its chunk queries; keys past the
//   prefix and outside that hull are never fetched. The mask is applied
//   only on tiles that cross a frontier (the prefix's last tile; a fresh
//   tile not inside every chunk query's [e_start, e_end)), per row, and a
//   masked key's p is set to 0, so a row that sees no key yet keeps l = 0.
//   One producer warp gathers each tile through `tables` with 16-byte
//   cp.async copies written in the swizzle `smem_desc` expects (no tensor
//   maps: nothing is encoded on the host), into a ring of 3 stages whose
//   mbarriers (attn_tc's trapping wait) count the lanes' copies as they
//   land (cp.async.mbarrier.arrive); it reads the next tile's page ids
//   while the current tile's copies fly, and the consumers fence a landed
//   stage to the async proxy. int8 pages: the producer brings the raw codes
//   and the tokens' scales; the consumers dequantize a tile into one of two
//   swizzled bf16 buffers, fence it and meet on a named barrier before
//   wgmma reads it (a second barrier keeps a buffer from being rewritten
//   while the other warpgroup's P·V still reads it).
// - Split block (persistent): it reads `meta` a window of tiles at a time,
//   classifies the tiles as the chunk blocks do, ranks the split queries in
//   query order and numbers their work items (query, split, KV head), the
//   KV head fastest; block b takes items b, b + NB, ..., so the KV heads of
//   one (query, split) run at about the same time on neighbouring blocks
//   and their reads of a page's token rows meet in DRAM. No block starts empty,
//   and the grid does not grow with NQ*S. The split axis comes from W: KS
//   keys a split (256 at BS = 16, longer for tables past 64 splits:
//   decode.split_keys / num_splits). A query's fresh keys go to its last
//   live split. The first R split queries (every single-query row of the
//   port's steps) may split; any further ones run whole.
//   Each warpgroup of the block is a team that runs its items as a chunk
//   block runs a tile, on wgmma: the item's G heads are the rows of a
//   64-row tile (at G <= 8 one 8-row group that the descriptor repeats,
//   stride 0), its keys 64-key tiles streamed through the team's ring of 3
//   stages (2 at HD = 128) by 16-byte cp.async, the next item's page ids
//   read and its first tiles and q in flight while the current item ends.
//   int8 codes are dequantized into a swizzled bf16 tile before wgmma; the
//   fresh keys come as bf16. What bounds it here is the SM's issue: the
//   copies' issue and the per-tile softmax take most of a team's time, and
//   one block an SM leaves 8 warps to hide them. (Scores and P·V on CUDA
//   cores, and TMA boxes of one page each, were tried and dropped.)
//   The last split of a (query, KV head) to arrive merges the splits in
//   split order, behind a per-device counter that it resets (kept apart
//   from paged_decode_partials'), and writes the normalized result: repeats
//   are bit-equal.

// f32 queries (either pool): the first version's CUDA-core kernel, kept as
// it was (TF32 would miss the 5e-5 bounds that the f32 checks hold):
// - grid (NQ, KVH): one block per (query, KV head) owns the G = H/KVH query
//   heads of that KV head side by side, so each K/V element staged in shared
//   memory serves G heads.
// - a loop inside the block over the row's pages, bounded by the true prefix
//   length (table slots past it hold scratch page 0), then over the fresh
//   keys in tiles of BS; m, l and acc stay in f32 in shared memory.
// - the int8 branch stages a page's codes with 16-byte loads and multiplies
//   by the token's scale in registers; the fresh keys stay in q's dtype.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "attention_tc.cuh"

namespace {

constexpr float kNegInf = -1e30f;

// ---- f32: CUDA cores ----------------------------------------------------------

constexpr int kF32Threads = 128;

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

// Stage tokens [0, n_valid) of one int8 page for KV head kvh: each thread
// takes 16 codes of a token's row (one 16-byte load each of K and V) and
// writes code * scale into the f32 tiles.
__device__ __forceinline__ void stage_int8_page(const Smem& sm, const int8_t* __restrict__ k_codes,
                                                const int8_t* __restrict__ v_codes,
                                                const float* __restrict__ k_scales,
                                                const float* __restrict__ v_scales, int64_t page, int kvh,
                                                int KVH, int HD, int BS, int n_valid) {
  const int chunks = HD / 16;
  const int64_t tok_stride = (int64_t)KVH * HD;
  for (int i = threadIdx.x; i < n_valid * chunks; i += blockDim.x) {
    const int t = i / chunks, c = i - t * chunks;
    const int64_t tok = page * BS + t;  // row of the [NP*BS, KVH] scale pool
    const int64_t off = tok * tok_stride + (int64_t)kvh * HD + c * 16;
    const int4 kq = __ldg(reinterpret_cast<const int4*>(k_codes + off));
    const int4 vq = __ldg(reinterpret_cast<const int4*>(v_codes + off));
    const float ks = __ldg(k_scales + tok * KVH + kvh);
    const float vs = __ldg(v_scales + tok * KVH + kvh);
    const int8_t* kb = reinterpret_cast<const int8_t*>(&kq);
    const int8_t* vb = reinterpret_cast<const int8_t*>(&vq);
    float* kd = sm.k + t * (HD + 1) + c * 16;
    float* vd = sm.v + t * HD + c * 16;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      kd[j] = (float)kb[j] * ks;
      vd[j] = (float)vb[j] * vs;
    }
  }
}

// kQuant: the pages are int8 codes with f32 scales; otherwise f32 pages and
// the scale pointers are unused.
template <bool kQuant>
__global__ void __launch_bounds__(kF32Threads) ragged_f32_kernel(
    const float* __restrict__ q,          // [NQ, H, HD]
    const float* __restrict__ k_extra,    // [CK, KVH, HD]
    const float* __restrict__ v_extra,    // [CK, KVH, HD]
    const void* __restrict__ k_pages,     // [NP, BS, KVH, HD] f32, or int8 codes
    const void* __restrict__ v_pages,     // [NP, BS, KVH, HD]
    const float* __restrict__ k_scales,   // [NP, BS, KVH, 1] (kQuant)
    const float* __restrict__ v_scales,   // [NP, BS, KVH, 1] (kQuant)
    const int* __restrict__ tables,       // [R, W]
    const int* __restrict__ meta,         // [5, NQ]
    float* __restrict__ out,              // [NQ, H, HD]
    int NQ, int H, int KVH, int HD, int CK, int W, int BS, float scale) {
  extern __shared__ float smem[];
  const int nq = blockIdx.x, kvh = blockIdx.y, tid = threadIdx.x;
  const int G = H / KVH;
  // The G query heads of KV head kvh are contiguous: [nq, kvh*G .. kvh*G+G).
  const int64_t q_off = ((int64_t)nq * H + (int64_t)kvh * G) * HD;

  if (meta[4 * NQ + nq] == 0) {
    for (int i = tid; i < G * HD; i += blockDim.x) out[q_off + i] = 0.f;
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
    sm.q[i] = q[q_off + i];
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
    const int n_valid = min(BS, prefix_len - w * BS);
    if constexpr (kQuant) {
      stage_int8_page(sm, static_cast<const int8_t*>(k_pages), static_cast<const int8_t*>(v_pages), k_scales,
                      v_scales, page, kvh, KVH, HD, BS, n_valid);
    } else {
      const float* kp = static_cast<const float*>(k_pages);
      const float* vp = static_cast<const float*>(v_pages);
      const int64_t base = page * page_stride + head_off;
      for (int i = tid; i < n_valid * HD; i += blockDim.x) {
        const int t = i / HD, d = i - t * HD;
        const int64_t off = base + t * tok_stride + d;
        sm.k[t * (HD + 1) + d] = kp[off];
        sm.v[t * HD + d] = vp[off];
      }
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
      sm.k[t * (HD + 1) + d] = k_extra[off];
      sm.v[t * HD + d] = v_extra[off];
    }
    __syncthreads();
    fold_tile(sm, G, HD, BS, n_valid, scale);
  }

  for (int i = tid; i < G * HD; i += blockDim.x) {
    const int g = i / HD;
    out[q_off + i] = sm.acc[i] / fmaxf(sm.l[g], 1e-30f);
  }
}

template <bool kQuant>
cudaError_t launch_f32(const void* q, const void* k_extra, const void* v_extra, const void* k_pages,
                       const void* v_pages, const float* k_scales, const float* v_scales, const int* tables,
                       const int* meta, void* out, int NQ, int H, int KVH, int HD, int CK, int W, int BS,
                       cudaStream_t stream) {
  if (kQuant && HD % 16) return cudaErrorInvalidValue;  // 16-byte code loads
  const size_t smem = smem_floats(H / KVH, HD, BS) * sizeof(float);
  static size_t opted_in = 48 * 1024;  // the attribute is per function; raised when a shape needs more
  if (smem > opted_in) {
    cudaError_t e = cudaFuncSetAttribute(ragged_f32_kernel<kQuant>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
    if (e != cudaSuccess) return e;
    opted_in = smem;
  }
  const dim3 grid(NQ, KVH);
  ragged_f32_kernel<kQuant><<<grid, kF32Threads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k_extra), static_cast<const float*>(v_extra), k_pages,
      v_pages, k_scales, v_scales, tables, meta, static_cast<float*>(out), NQ, H, KVH, HD, CK, W, BS,
      rsqrtf((float)HD));
  return cudaGetLastError();
}

// ---- bf16: chunk tiles on wgmma, split queries on CUDA cores -------------------

constexpr int kRows = 128;  // (query, head) rows of a chunk tile: two warpgroups of 64
constexpr int kKeys = 64;   // keys per K/V tile, both paths
constexpr int kStages = 3;
constexpr int kConsumers = 256;
constexpr int kThreads = kConsumers + 32;  // + the producer warp
constexpr int kWarps = kThreads / 32;
constexpr int kMeta = 8;     // ints of a chunk tile's summary

// Shapes the kernel gets from the host (no device-to-host read).
struct Dims {
  int NQ, H, KVH, G, CK, W, BS, R;
  int BQ;      // queries per chunk tile: 128 / G
  int ntiles;  // ceil(NQ / BQ)
  int NB;      // persistent split blocks
  int S;       // splits per query (from W)
  int KS;      // keys per split
  int teams;   // the split path's teams a block (1 or 2)
  int bs_shift;  // log2(BS) when BS is a power of two, else -1
  float scale;
};

struct Args {
  const __nv_bfloat16* q;        // [NQ, H, HD]
  const __nv_bfloat16* k_extra;  // [CK, KVH, HD]
  const __nv_bfloat16* v_extra;
  const void* k_pages;           // [NP, BS, KVH, HD] bf16, or int8 codes
  const void* v_pages;
  const float* k_scales;         // [NP, BS, KVH, 1] (int8)
  const float* v_scales;
  const int* tables;             // [R, W]
  const int* meta;               // [5, NQ]
  __nv_bfloat16* out;            // [NQ, H, HD]
  float* scratch;                // split partials: m, l [R, KVH, S, G], acc [R, KVH, S, G, HD]
  int* counters;                 // [R * KVH], 0 between launches
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool copy) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(attn_tc::smem_u32(dst)), "l"(src),
               "r"(copy ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool copy) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(attn_tc::smem_u32(dst)), "l"(src),
               "r"(copy ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
// Arrive on `bar` once this thread's cp.async copies issued so far have
// landed (the barrier's count includes this arrival: .noinc).
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(attn_tc::smem_u32(bar)) : "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The 256 consumer threads of a chunk block meet here (barrier 0 is
// __syncthreads; the producer warp does not take part).
__device__ __forceinline__ void consumers_sync() { asm volatile("bar.sync 1, 256;\n" ::: "memory"); }

// Byte offset o inside a swizzled tile of RowBytes-long rows, as TMA writes
// it and `attn_tc::smem_desc` reads it: address bits [4, 4+b) XOR bits
// [7, 7+b), b = 3, 2, 1 for 128, 64, 32-byte rows.
template <int RowBytes>
__device__ __forceinline__ uint32_t swz(uint32_t o) {
  constexpr uint32_t kMask = RowBytes == 128 ? 7 : RowBytes == 64 ? 3 : 1;
  return o ^ (((o >> 7) & kMask) << 4);
}

__device__ __forceinline__ float bf16_round(float x) { return __bfloat162float(__float2bfloat16(x)); }

// The 8 int8 codes of `c`, dequantized and rounded as the TPU kernel does,
// bf16(code * s) with s = bf16(scale), packed in pairs. A code becomes an
// exact float without a conversion instruction: sign-extended (prmt), added
// to the mantissa of 1.5 * 2^23, less 1.5 * 2^23.
__device__ __forceinline__ uint4 dequant8(uint2 c, float s) {
  float f[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    uint32_t x;
    asm("prmt.b32 %0, %1, %2, %3;" : "=r"(x) : "r"(i < 4 ? c.x : c.y), "r"(0u), "r"(0x8880u | (i % 4) * 0x1111u));
    f[i] = (__int_as_float(0x4B400000 + (int)x) - 12582912.f) * s;
  }
  return make_uint4(attn_tc::pack_bf16(f[0], f[1]), attn_tc::pack_bf16(f[2], f[3]), attn_tc::pack_bf16(f[4], f[5]),
                    attn_tc::pack_bf16(f[6], f[7]));
}

// Marks the chunk queries of one tile (entries [0, n) of the tile's live,
// row and capped-prefix arrays): the live queries that share the row and
// prefix of the tile's first live query, when there are at least two. One
// warp; the chunk and split blocks call it on the same entries.
__device__ void classify_tile(const int8_t* live, const int* row, const int* plen, int n, int8_t* chunk) {
  const int lane = threadIdx.x % 32;
  int first = -1;
  for (int base = 0; base < n && first < 0; base += 32) {
    const int i = base + lane;
    const unsigned b = __ballot_sync(0xffffffffu, i < n && live[i]);
    if (b) first = base + __ffs(b) - 1;
  }
  int r0 = 0, p0 = 0, cnt = 0;
  if (first >= 0) {
    r0 = row[first];
    p0 = plen[first];
    for (int base = 0; base < n; base += 32) {
      const int i = base + lane;
      cnt += __popc(__ballot_sync(0xffffffffu, i < n && live[i] && row[i] == r0 && plen[i] == p0));
    }
  }
  for (int i = lane; i < n; i += 32) chunk[i] = cnt >= 2 && live[i] && row[i] == r0 && plen[i] == p0;
  __syncwarp();
}

// Exclusive prefix sum of one int per thread over the whole block; the
// block's total in *total. `tmp` holds kWarps + 1 ints.
__device__ int block_scan(int v, int* tmp, int* total) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  int x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) tmp[warp] = x;
  __syncthreads();
  if (threadIdx.x == 0) {
    int acc = 0;
    for (int w = 0; w < kWarps; ++w) {
      const int t = tmp[w];
      tmp[w] = acc;
      acc += t;
    }
    tmp[kWarps] = acc;
  }
  __syncthreads();
  const int out = tmp[warp] + x - v;
  *total = tmp[kWarps];
  __syncthreads();  // tmp may be reused
  return out;
}

template <int HD, bool kQuant>
struct Shape {
  // Chunk path: swizzled bf16 tiles, as the flash kernel's.
  static constexpr int kChunk = HD < 64 ? HD : 64;  // columns per swizzled row
  static constexpr int kRowBytes = kChunk * 2;
  static constexpr int kChunks = HD / kChunk;
  static constexpr int kLayout = attn_tc::desc_layout(kRowBytes);
  static constexpr int kQChunkBytes = kRows * kRowBytes;
  static constexpr int kQBytes = kChunks * kQChunkBytes;
  static constexpr int kKvChunkBytes = kKeys * kRowBytes;
  static constexpr int kKvBytes = kChunks * kKvChunkBytes;  // one K or V tile
  // A raw stage (int8 pool; and every split-path stage): K and V rows as
  // they come (codes, or a bf16 fresh tile: the larger), then K and V scales.
  static constexpr int kRawBytes = kKeys * HD * 2;
  static constexpr int kRawStage = 2 * kRawBytes + 2 * kKeys * 4;
  static constexpr int kStageBytes = kQuant ? kRawStage : 2 * kKvBytes;
  static constexpr int kConvBytes = kQuant ? 2 * 2 * kKvBytes : 0;  // two dequantized K+V buffers
  static constexpr int kBarOff = kQBytes + kConvBytes + kStages * kStageBytes;
  static constexpr int kMetaOff = kBarOff + 8 * (1 + 2 * kStages);
  // Q, the dequantized buffers and the ring from a 1024-aligned base (the
  // swizzle's period), then barriers and the tile's meta.
  static constexpr size_t kChunkSmem = 1024 + kMetaOff + kRows * (4 * 4 + 2) + kMeta * 4;
};

// One online-softmax step on a 64-key tile of S (raw scores, m64n64
// fragment) for this thread's two rows (fragment halves h = 0, 1), as
// attn_tc::online_softmax, with a key window [lo[h], hi[h]) per row: with
// kMask, keys k0 + column outside it score -1e30 and take p = 0 (not
// e^(-1e30 - m)), so a row that has seen no key keeps m = -1e30 and l = 0.
template <bool kMask>
__device__ __forceinline__ void softmax_tile(float (&sc)[32], float (&m)[2], float (&l)[2], float (&alpha)[2], int k0,
                                             int col0, const int (&lo)[2], const int (&hi)[2], float scale_log2e) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float mx = kNegInf;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int key = k0 + 8 * j + col0 + c;
        float& x = sc[4 * j + 2 * h + c];
        if (kMask && (key < lo[h] || key >= hi[h])) x = kNegInf;
        mx = fmaxf(mx, x);
      }
    mx = attn_tc::quad_max(mx);
    const float m_new = fmaxf(m[h], mx);
    alpha[h] = attn_tc::fast_exp2((m[h] - m_new) * scale_log2e);
    const float m_off = m_new * scale_log2e;
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int key = k0 + 8 * j + col0 + c;
        float& x = sc[4 * j + 2 * h + c];
        x = (kMask && (key < lo[h] || key >= hi[h])) ? 0.f : attn_tc::fast_exp2(fmaf(x, scale_log2e, -m_off));
        sum += x;
      }
    l[h] = l[h] * alpha[h] + attn_tc::quad_sum(sum);
    m[h] = m_new;
  }
}

// ---- chunk block ----

template <int HD, bool kQuant>
__device__ void chunk_block(const Args& a, const Dims& d, uint8_t* base) {
  using S = Shape<HD, kQuant>;
  using namespace attn_tc;
  const int tid = threadIdx.x;
  const int kvh = blockIdx.x % d.KVH;
  const int t = d.ntiles - 1 - blockIdx.x / d.KVH;  // latest tiles first
  const int G = d.G, BQ = d.BQ, rows = BQ * G;
  const int q0 = t * BQ, n = min(BQ, d.NQ - q0);
  const int NQ = d.NQ;

  uint8_t* sq = base;
  uint8_t* conv = sq + S::kQBytes;
  uint8_t* ring = conv + S::kConvBytes;
  uint64_t* q_full = reinterpret_cast<uint64_t*>(base + S::kBarOff);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + kStages;
  int* s_row = reinterpret_cast<int*>(base + S::kMetaOff);
  int* s_plen = s_row + kRows;
  int* s_es = s_plen + kRows;
  int* s_ee = s_es + kRows;
  int* s_info = s_ee + kRows;
  int8_t* s_live = reinterpret_cast<int8_t*>(s_info + kMeta);
  int8_t* s_chunk = s_live + kRows;

  const int p_cap = d.W * d.BS;
  if (tid < n) {
    const int nq = q0 + tid;
    s_live[tid] = a.meta[4 * NQ + nq] != 0;
    s_row[tid] = a.meta[nq];
    s_plen[tid] = min(max(a.meta[NQ + nq], 0), p_cap);
    s_es[tid] = max(a.meta[2 * NQ + nq], 0);
    s_ee[tid] = min(a.meta[3 * NQ + nq], d.CK);
  }
  __syncthreads();
  if (tid < 32) {
    classify_tile(s_live, s_row, s_plen, n, s_chunk);
    // The fresh keys' hull over the chunk queries, and the range every one
    // of them sees (a fresh tile inside it takes no mask).
    int lo = 0x7fffffff, hi = -0x7fffffff, es_max = -0x7fffffff, ee_min = 0x7fffffff, any = 0, r0 = 0, p0 = 0;
    for (int i = tid; i < n; i += 32)
      if (s_chunk[i]) {
        const int es = s_es[i], ee = s_ee[i];
        if (ee > es) {
          lo = min(lo, es);
          hi = max(hi, ee);
        }
        es_max = max(es_max, es);
        ee_min = min(ee_min, ee);
        any = 1;
        r0 = s_row[i];
        p0 = s_plen[i];
      }
    lo = __reduce_min_sync(0xffffffffu, lo);
    hi = __reduce_max_sync(0xffffffffu, hi);
    es_max = __reduce_max_sync(0xffffffffu, es_max);
    ee_min = __reduce_min_sync(0xffffffffu, ee_min);
    any = __reduce_or_sync(0xffffffffu, (unsigned)any);
    r0 = __reduce_max_sync(0xffffffffu, r0);
    p0 = __reduce_max_sync(0xffffffffu, p0);
    if (tid == 0) {
      s_info[0] = any;
      s_info[1] = r0;
      s_info[2] = p0;
      s_info[3] = lo;
      s_info[4] = hi;
      s_info[5] = es_max;
      s_info[6] = ee_min;
    }
  }
  __syncthreads();

  // Dead queries of this tile write zeros for this KV head's heads (the
  // split path never takes them). 16 bytes a store.
  const int vec_per_q = G * HD / 8;
  for (int i = tid; i < n * vec_per_q; i += kThreads) {
    const int qi = i / vec_per_q;
    if (!s_live[qi])
      *reinterpret_cast<uint4*>(a.out + ((int64_t)(q0 + qi) * d.H + (int64_t)kvh * G) * HD + (i % vec_per_q) * 8) =
          make_uint4(0u, 0u, 0u, 0u);
  }
  if (!s_info[0]) return;  // no chunk queries here: the split blocks take the live ones

  const int row_c = s_info[1], plen = s_info[2];
  const int c_lo = s_info[3], c_hi = s_info[4], es_max = s_info[5], ee_min = s_info[6];
  const int npt = (plen + kKeys - 1) / kKeys;
  const int nft = c_hi > c_lo ? (c_hi - c_lo + kKeys - 1) / kKeys : 0;
  const int nt = npt + nft;
  if (nt == 0) {  // no chunk query sees a key: zeros
    for (int i = tid; i < n * vec_per_q; i += kThreads) {
      const int qi = i / vec_per_q;
      if (s_chunk[qi])
        *reinterpret_cast<uint4*>(a.out + ((int64_t)(q0 + qi) * d.H + (int64_t)kvh * G) * HD +
                                  (i % vec_per_q) * 8) = make_uint4(0u, 0u, 0u, 0u);
    }
    return;
  }

  if (tid == kConsumers) {
    mbar_init(q_full, 32);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 32);
      mbar_init(&empty[s], kConsumers);
    }
    mbar_fence_init();
  }
  __syncthreads();

  const int64_t tok_stride = (int64_t)d.KVH * HD;
  if (tid >= kConsumers) {
    // Producer warp. Each lane copies its share of 16-byte units and
    // arrives on the stage's barrier when they land (32 arrivals fill it);
    // the consumers fence a landed stage to the async proxy.
    const int lane = tid - kConsumers;
    constexpr int kUnitsQ = HD / 8;  // 16-byte units of a bf16 row
    constexpr int kPerChunk = S::kChunk / 8;
    for (int r = lane; r < kRows; r += 32) {
      const int qi = q0 + r / G;
      const bool valid = r < rows && qi < NQ;
      const __nv_bfloat16* src = valid ? a.q + ((int64_t)qi * d.H + (int64_t)kvh * G + r % G) * HD : a.q;
#pragma unroll
      for (int u = 0; u < kUnitsQ; ++u)
        cp_async16(sq + (u / kPerChunk) * S::kQChunkBytes + swz<S::kRowBytes>(r * S::kRowBytes + (u % kPerChunk) * 16),
                   src + u * 8, valid);
    }
    cp_async_arrive(q_full);

    // Page ids of keys lane and lane + 32 of tile i (prefix tiles only).
    int pg[2] = {0, 0};
    auto lookup = [&](int i) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int p = i * kKeys + lane + 32 * h;
        pg[h] = (i < npt && p < plen) ? __ldg(a.tables + (int64_t)row_c * d.W + p / d.BS) : 0;
      }
    };
    lookup(0);
    auto issue = [&](int i) {
      uint8_t* st = ring + (i % kStages) * S::kStageBytes;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int j = lane + 32 * h;
        bool valid;
        int64_t off;  // element offset of the key's row for head kvh
        bool fresh = i >= npt;
        if (!fresh) {
          const int p = i * kKeys + j;
          valid = p < plen;
          off = ((int64_t)pg[h] * d.BS + p % d.BS) * tok_stride + (int64_t)kvh * HD;
        } else {
          const int c = c_lo + (i - npt) * kKeys + j;
          valid = c < c_hi;
          off = (int64_t)c * tok_stride + (int64_t)kvh * HD;
        }
        if (!valid) off = 0;
        if constexpr (!kQuant) {
          const __nv_bfloat16* ks = (fresh ? a.k_extra : static_cast<const __nv_bfloat16*>(a.k_pages)) + off;
          const __nv_bfloat16* vs = (fresh ? a.v_extra : static_cast<const __nv_bfloat16*>(a.v_pages)) + off;
#pragma unroll
          for (int u = 0; u < kUnitsQ; ++u) {
            const uint32_t o = (u / kPerChunk) * S::kKvChunkBytes + swz<S::kRowBytes>(j * S::kRowBytes + (u % kPerChunk) * 16);
            cp_async16(st + o, ks + u * 8, valid);
            cp_async16(st + S::kKvBytes + o, vs + u * 8, valid);
          }
        } else if (fresh) {  // bf16 rows, as they are
#pragma unroll
          for (int u = 0; u < kUnitsQ; ++u) {
            cp_async16(st + j * HD * 2 + u * 16, a.k_extra + off + u * 8, valid);
            cp_async16(st + S::kRawBytes + j * HD * 2 + u * 16, a.v_extra + off + u * 8, valid);
          }
        } else {  // int8 codes and the token's scales
          const int8_t* kc = static_cast<const int8_t*>(a.k_pages) + off;
          const int8_t* vc = static_cast<const int8_t*>(a.v_pages) + off;
#pragma unroll
          for (int u = 0; u < HD / 16; ++u) {
            cp_async16(st + j * HD + u * 16, kc + u * 16, valid);
            cp_async16(st + S::kRawBytes + j * HD + u * 16, vc + u * 16, valid);
          }
          const int64_t sidx = valid ? off / HD : 0;  // (page*BS + p%BS)*KVH + kvh
          cp_async4(st + 2 * S::kRawBytes + j * 4, a.k_scales + sidx, valid);
          cp_async4(st + 2 * S::kRawBytes + kKeys * 4 + j * 4, a.v_scales + sidx, valid);
        }
      }
    };
    // The next tile's page ids are read while this tile's copies fly.
    for (int i = 0; i < nt; ++i) {
      const int s = i % kStages;
      if (i >= kStages) mbar_wait(&empty[s], ((i / kStages) - 1) & 1);
      issue(i);
      cp_async_arrive(&full[s]);
      if (i + 1 < nt) lookup(i + 1);
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    return;
  }

  // Consumers: warpgroup wg owns rows 64wg .. 64wg+63; this thread rows r0
  // and r0 + 8 (fragment halves h = 0, 1).
  const int wg = tid / 128, warp = (tid % 128) / 32, lane = tid % 32;
  const int r0 = wg * 64 + warp * 16 + lane / 4;
  const int col0 = 2 * (lane % 4);
  int qi[2], lo[2], hi[2];
  bool mine[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = r0 + 8 * h;
    qi[h] = r / G;
    mine[h] = r < rows && qi[h] < n && s_chunk[qi[h]];
    lo[h] = mine[h] ? s_es[qi[h]] : 0;
    hi[h] = mine[h] ? s_ee[qi[h]] : 0;
  }
  const int plo[2] = {0, 0}, phi[2] = {plen, plen};
  const float scale_log2e = d.scale * 1.4426950408889634f;
  float o[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) o[i] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f}, alpha[2];
  float sc[32];
  uint32_t pa[4][4];
  const uint32_t q_addr = smem_u32(sq) + wg * 64 * S::kRowBytes;
  constexpr uint32_t kSbo = 8 * S::kRowBytes;

  // The K and V tiles of tile i: the ring stage (bf16 pool) or the
  // dequantized buffer (int8 pool).
  auto k_tile = [&](int i) -> uint32_t {
    return kQuant ? smem_u32(conv + (i % 2) * 2 * S::kKvBytes) : smem_u32(ring + (i % kStages) * S::kStageBytes);
  };
  auto qk = [&](int i) {
    const uint32_t k_addr = k_tile(i);
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      const int c = (kk * 16) / S::kChunk;
      const uint32_t off = ((kk * 16) % S::kChunk) * 2;
      wgmma_ss_n64(sc, smem_desc(q_addr + c * S::kQChunkBytes + off, 16, kSbo, S::kLayout),
                   smem_desc(k_addr + c * S::kKvChunkBytes + off, 16, kSbo, S::kLayout), kk > 0);
    }
  };
  auto pv = [&](int i) {
    const uint32_t v_addr = k_tile(i) + S::kKvBytes;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_rs<HD>(o, pa[kk], smem_desc(v_addr + kk * 16 * S::kRowBytes, S::kKvChunkBytes, kSbo, S::kLayout));
  };
  // Frontier tiles take the mask: the prefix's last tile, and a fresh tile
  // not inside every chunk query's range.
  auto softmax = [&](int i) {
    if (i < npt) {
      if ((i + 1) * kKeys <= plen) softmax_tile<false>(sc, m, l, alpha, i * kKeys, col0, plo, phi, scale_log2e);
      else softmax_tile<true>(sc, m, l, alpha, i * kKeys, col0, plo, phi, scale_log2e);
    } else {
      const int c0 = c_lo + (i - npt) * kKeys;
      if (c0 >= es_max && c0 + kKeys <= ee_min) softmax_tile<false>(sc, m, l, alpha, c0, col0, lo, hi, scale_log2e);
      else softmax_tile<true>(sc, m, l, alpha, c0, col0, lo, hi, scale_log2e);
    }
  };
  auto pack = [&]() {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) pack_p(sc, kk, pa[kk]);
  };
  auto phase_of = [](int i) { return (uint32_t)((i / kStages) & 1); };
  // Tile i ready for wgmma: its stage landed; int8: dequantized into
  // buffer i % 2 by all consumers, the raw stage released.
  auto ready = [&](int i) {
    mbar_wait(&full[i % kStages], phase_of(i));
    fence_proxy_async();
    if constexpr (kQuant) {
      consumers_sync();  // buffer i % 2 is free: every P·V of tile i-2 is done
      const uint8_t* st = ring + (i % kStages) * S::kStageBytes;
      uint8_t* dst = conv + (i % 2) * 2 * S::kKvBytes;
      constexpr int kU = HD / 8;  // 8-element units of a row
      const bool fresh = i >= npt;
      for (int e = tid; e < 2 * kKeys * kU; e += kConsumers) {
        const int kv = e / (kKeys * kU), rem = e % (kKeys * kU);
        const int j = rem / kU, u = rem % kU;
        uint4 w;
        if (fresh) {
          w = *reinterpret_cast<const uint4*>(st + kv * S::kRawBytes + j * HD * 2 + u * 16);
        } else {
          w = dequant8(*reinterpret_cast<const uint2*>(st + kv * S::kRawBytes + j * HD + u * 8),
                       bf16_round(*reinterpret_cast<const float*>(st + 2 * S::kRawBytes + kv * kKeys * 4 + j * 4)));
        }
        *reinterpret_cast<uint4*>(dst + kv * S::kKvBytes + (u / (S::kChunk / 8)) * S::kKvChunkBytes +
                                  swz<S::kRowBytes>(j * S::kRowBytes + (u % (S::kChunk / 8)) * 16)) = w;
      }
      fence_proxy_async();
      mbar_arrive(&empty[i % kStages]);
      consumers_sync();  // tile i's buffer is whole
    }
    __syncwarp();
  };
  // bf16 pool: the stage of tile i is released once its P·V is done.
  auto release = [&](int i) {
    if constexpr (!kQuant) mbar_arrive(&empty[i % kStages]);
  };

  mbar_wait(q_full, 0);
  ready(0);
  wgmma_fence();
  qk(0);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(sc);
  softmax(0);  // O is still zero: no rescale
  pack();
  for (int i = 1; i < nt; ++i) {
    ready(i);
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
    release(i - 1);
    rescale_rows(o, alpha);
    pack();
  }
  fence_regs(o);
  fence_regs(pa);
  wgmma_fence();
  pv(nt - 1);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(o);
  release(nt - 1);

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (!mine[h]) continue;
    const int g = (r0 + 8 * h) % G;
    const float lc = fmaxf(l[h], 1e-30f);
    __nv_bfloat16* orow = a.out + ((int64_t)(q0 + qi[h]) * d.H + (int64_t)kvh * G + g) * HD;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j + col0) =
          __floats2bfloat162_rn(o[4 * j + 2 * h] / lc, o[4 * j + 2 * h + 1] / lc);
  }
}

// ---- split block ----

// The split path runs its items in teams: two of 128 threads (warps 0-3,
// 4-7), each with its own ring and arrays, or one of 256 where two do not
// fit in shared memory; warp 8 takes part only in the block-wide steps. A
// team streams its items' tiles through one ring: the next item's page ids
// are read while the current item computes, and its first tiles (with its
// q) are in flight while the current item's last tiles compute and merge.
__device__ __forceinline__ void team_sync(int team, int size) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(2 + team), "r"(size) : "memory");
}

template <int HD, bool kQuant>
struct Split {
  using S = Shape<HD, kQuant>;
  static constexpr int kStages = HD == 128 ? 2 : 3;  // ring stages of a team
  static constexpr int kPages = 64;                   // page ids an item keeps in shared memory
  // A stage: the K and V tiles swizzled for wgmma (bf16 pool); int8 pool:
  // the raw codes and their scales, or a fresh bf16 tile swizzled.
  static constexpr int kStage = kQuant ? (2 * S::kRawBytes + 2 * kKeys * 4 + 1023) / 1024 * 1024 : 2 * S::kKvBytes;
  static constexpr int kConv = kQuant ? 2 * S::kKvBytes : 0;  // the dequantized K and V tiles
  // Q rows of an item's tile: its G heads; at G <= 8 one 8-row group that
  // the descriptor repeats over the warpgroup's 64 rows (stride 0).
  static __host__ __device__ int q_rows(int G) { return G <= 8 ? 8 : 64; }
  static __host__ __device__ size_t q_bytes(int G) { return ((size_t)q_rows(G) * HD * 2 + 1023) / 1024 * 1024; }
  // A team's arrays: the ring, the dequantized tiles, kStages Q buffers (an
  // item's q comes with its first tile), then the merge's weights [64, G],
  // m and l [G], the page ids and the merge flag.
  static __host__ __device__ size_t team_bytes(int G) {
    return (size_t)kStages * kStage + kConv + kStages * q_bytes(G) +
           (4 * ((size_t)G * kKeys + 2 * (size_t)G + kPages + 4) + 1023) / 1024 * 1024;
  }
  // Queries the block classifies at a time (whole tiles): fewer where two
  // teams take most of the card's shared memory.
  static constexpr int kWin = HD == 128 ? 512 : 1024;
  // The block: the teams, then the window's meta and ranks.
  static __host__ __device__ size_t bytes(int G, int teams) {
    return 1024 + teams * team_bytes(G) + (size_t)kWin * (6 * 4 + 2) + 4 * (2 * kWarps + 8);
  }
};

struct Team {
  int id, tid;  // team (warpgroup) index, thread in the team
  uint8_t* ring;
  uint8_t* conv;
  uint8_t* qbuf;
  float *ss, *sm, *sl;
  int* pg;    // page ids of the issuing item's prefix, from its first page
  int* flag;  // the merge's "last to arrive"
};

// A work item: query nq's G heads of KV head kvh over its prefix keys
// [pb, pe) and, when fb < fe, its fresh keys [fb, fe); split s of n (n > 1:
// partials in scratch slot `slot`, merged by the last split to arrive).
struct Item {
  int nq, kvh, row, pb, pe, fb, fe, s, n, slot, npt, nt;
};

// A team (one warpgroup) runs its K items, desc(k, item) for k < K, as the
// chunk blocks run a tile: S = Q·Kᵀ and O += P·V on wgmma, the G heads of
// the item's KV head as the rows of a 64-row tile, its keys in 64-key tiles
// streamed through the team's ring.
template <int HD, bool kQuant, class Desc>
__device__ void split_team(const Args& a, const Dims& d, const Team& tm, int K, const Desc& desc) {
  using S = Shape<HD, kQuant>;
  using SP = Split<HD, kQuant>;
  using namespace attn_tc;
  constexpr int kSt = SP::kStages;
  constexpr int kPerChunk = S::kChunk / 8;  // 16-byte units per swizzled row
  constexpr int kU = HD / 8;                // 16-byte units per bf16 row
  constexpr uint32_t kSbo = 8 * S::kRowBytes;
  const int tid = tm.tid, warp = tid / 32, lane = tid % 32;
  const int G = d.G;
  const int qrows = SP::q_rows(G);
  const size_t qb_bytes = SP::q_bytes(G);
  const int64_t tok_stride = (int64_t)d.KVH * HD;
  if (K <= 0) return;

  auto npages = [&](const Item& it) { return it.pe > it.pb ? (it.pe - 1) / d.BS - it.pb / d.BS + 1 : 0; };
  auto page_id = [&](const Item& it, int w) {
    return __ldg(a.tables + (int64_t)it.row * d.W + it.pb / d.BS + w);
  };
  auto next_nonempty = [&](int k, Item& it) {
    for (; k < K; ++k) {
      desc(k, it);
      if (it.nt > 0) return k;
    }
    return K;
  };
  // Byte offset of 16-byte unit u of row r in a swizzled tile of `rows` rows.
  auto tile_off = [](int r, int u, int rows) {
    return (u / kPerChunk) * rows * S::kRowBytes + swz<S::kRowBytes>(r * S::kRowBytes + (u % kPerChunk) * 16);
  };

  // The Q buffers' rows past G are never copied: zeros.
  for (int e = tid; e < kSt * qrows * kU; e += 128) {
    const int qb = e / (qrows * kU), r = (e / kU) % qrows, u = e % kU;
    if (r >= G) *reinterpret_cast<uint4*>(tm.qbuf + qb * qb_bytes + tile_off(r, u, qrows)) = make_uint4(0u, 0u, 0u, 0u);
  }

  // ---- issue side: item ik, its next tile ti; gi tiles issued; qi the
  // non-empty items entered (their Q buffer qi % kSt) ----
  Item Ii, In;
  int ik = next_nonempty(0, Ii), ti = 0, gi = 0, qi = 0;
  if (ik < K && tid < min(npages(Ii), SP::kPages)) tm.pg[tid] = page_id(Ii, tid);
  int kn = ik < K ? next_nonempty(ik + 1, In) : K;
  int next_pg = 0;  // this thread's page id of item kn, read ahead
  if (kn < K && tid < min(npages(In), SP::kPages)) next_pg = page_id(In, tid);
  team_sync(tm.id, 128);

  auto issue_one = [&]() {
    if (ik < K) {
      uint8_t* st = tm.ring + (gi % kSt) * SP::kStage;
      if (ti == 0) {  // the item's q, with its first tile
        const __nv_bfloat16* qb = a.q + ((int64_t)Ii.nq * d.H + (int64_t)Ii.kvh * G) * HD;
        uint8_t* qd = tm.qbuf + (qi % kSt) * qb_bytes;
        for (int e = tid; e < G * kU; e += 128) cp_async16(qd + tile_off(e / kU, e % kU, qrows), qb + e * 8, true);
      }
      const bool fresh = ti >= Ii.npt;
      const bool codes = kQuant && !fresh;
      const int k0 = fresh ? Ii.fb + (ti - Ii.npt) * kKeys : Ii.pb + ti * kKeys;
      const int kend = fresh ? Ii.fe : Ii.pe;
      const int pg0 = Ii.pb / d.BS;
      const int64_t head = (int64_t)Ii.kvh * HD;
      const int rv = codes ? HD / 16 : kU;  // 16-byte units a key row
      for (int e = tid; e < kKeys * rv; e += 128) {
        const int j = e / rv, u = e % rv;
        const int p = k0 + j;
        const bool valid = p < kend;
        int64_t tok = 0;  // the key's token row
        if (valid) {
          if (fresh) {
            tok = p;
          } else {
            const int w = (d.bs_shift >= 0 ? p >> d.bs_shift : p / d.BS) - pg0;
            const int r = d.bs_shift >= 0 ? p & (d.BS - 1) : p % d.BS;
            tok = (int64_t)(w < SP::kPages ? tm.pg[w] : page_id(Ii, w)) * d.BS + r;
          }
        }
        const int64_t off = valid ? tok * tok_stride + head : 0;
        if (codes) {  // raw rows of HD codes, then the token's scales
          cp_async16(st + j * HD + u * 16, static_cast<const int8_t*>(a.k_pages) + off + u * 16, valid);
          cp_async16(st + S::kRawBytes + j * HD + u * 16, static_cast<const int8_t*>(a.v_pages) + off + u * 16, valid);
          if (u == 0) {
            const int64_t sidx = valid ? tok * d.KVH + Ii.kvh : 0;
            cp_async4(st + 2 * S::kRawBytes + j * 4, a.k_scales + sidx, valid);
            cp_async4(st + 2 * S::kRawBytes + kKeys * 4 + j * 4, a.v_scales + sidx, valid);
          }
        } else {  // bf16 rows, swizzled for wgmma
          const __nv_bfloat16* kp = fresh ? a.k_extra : static_cast<const __nv_bfloat16*>(a.k_pages);
          const __nv_bfloat16* vp = fresh ? a.v_extra : static_cast<const __nv_bfloat16*>(a.v_pages);
          const int o = tile_off(j, u, kKeys);
          cp_async16(st + o, kp + off + u * 8, valid);
          cp_async16(st + S::kKvBytes + o, vp + off + u * 8, valid);
        }
      }
      ++gi;
      if (++ti == Ii.nt) {  // on to the next non-empty item: its page ids were read ahead
        ti = 0;
        ++qi;
        ik = kn;
        Ii = In;
        if (ik < K) {
          team_sync(tm.id, 128);  // every thread is done reading the page ids
          if (tid < min(npages(Ii), SP::kPages)) tm.pg[tid] = next_pg;
          team_sync(tm.id, 128);
          kn = next_nonempty(ik + 1, In);
          if (kn < K && tid < min(npages(In), SP::kPages)) next_pg = page_id(In, tid);
        }
      }
    }
    cp_async_commit();  // one group per call, empty past the stream's end
  };

  // ---- compute side: item kc, its tile tc; gt tiles computed; qc the
  // non-empty items entered. An item with no key writes zeros. ----
  Item Ic;
  auto enter = [&](int k) {
    for (; k < K; ++k) {
      desc(k, Ic);
      if (Ic.nt > 0) return k;
      __nv_bfloat16* ob = a.out + ((int64_t)Ic.nq * d.H + (int64_t)Ic.kvh * G) * HD;
      for (int i = tid; i < G * HD; i += 128) ob[i] = __float2bfloat16(0.f);
    }
    return K;
  };
  // This thread's rows r0 and r0 + 8 of the 64-row tile: heads, when < G.
  const int r0 = warp * 16 + lane / 4, col0 = 2 * (lane % 4);
  const float scale_log2e = d.scale * 1.4426950408889634f;
  const int lo[2] = {0, 0};
  float o[HD / 2];
  float m[2], l[2], alpha[2];
  float sc[32];
  uint32_t pa[4][4];
  int kc = enter(0), tc = 0, gt = 0, qc = 0;
#pragma unroll
  for (int t = 0; t < kSt - 1; ++t) issue_one();

  while (kc < K) {
    cp_async_wait<kSt - 2>();
    // Every thread's copies of tile gt are in, and every thread is past the
    // previous tile's products: its stage may take the next copy.
    team_sync(tm.id, 128);
    issue_one();
    const uint8_t* st = tm.ring + (gt % kSt) * SP::kStage;
    if (tc == 0) {
#pragma unroll
      for (int i = 0; i < HD / 2; ++i) o[i] = 0.f;
      m[0] = m[1] = kNegInf;
      l[0] = l[1] = 0.f;
    }
    const bool fresh = tc >= Ic.npt;
    const int nk = fresh ? min(kKeys, Ic.fe - Ic.fb - (tc - Ic.npt) * kKeys) : min(kKeys, Ic.pe - Ic.pb - tc * kKeys);
    uint32_t kv = smem_u32(st);
    if (kQuant && !fresh) {  // dequantize the codes into the swizzled tiles: bf16(code * bf16(scale))
      for (int e = tid; e < 2 * kKeys * kU; e += 128) {
        const int kvi = e / (kKeys * kU), j = (e / kU) % kKeys, u = e % kU;
        *reinterpret_cast<uint4*>(tm.conv + kvi * S::kKvBytes + tile_off(j, u, kKeys)) =
            dequant8(*reinterpret_cast<const uint2*>(st + kvi * S::kRawBytes + j * HD + u * 8),
                     bf16_round(*reinterpret_cast<const float*>(st + 2 * S::kRawBytes + kvi * kKeys * 4 + j * 4)));
      }
      kv = smem_u32(tm.conv);
    }
    fence_proxy_async();  // the copies (or the dequantized tiles) to the async proxy
    team_sync(tm.id, 128);

    // S = Q·K(tile): the item's Q (one 8-row group repeated at G <= 8).
    const uint32_t q_addr = smem_u32(tm.qbuf + (qc % kSt) * qb_bytes);
    const uint32_t q_sbo = qrows == 8 ? 0u : kSbo;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      const int c = (kk * 16) / S::kChunk;
      const uint32_t off = ((kk * 16) % S::kChunk) * 2;
      wgmma_ss_n64(sc, smem_desc(q_addr + c * qrows * S::kRowBytes + off, 16, q_sbo, S::kLayout),
                   smem_desc(kv + c * S::kKvChunkBytes + off, 16, kSbo, S::kLayout), kk > 0);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(sc);
    const int hi[2] = {nk, nk};
    if (nk < kKeys) softmax_tile<true>(sc, m, l, alpha, 0, col0, lo, hi, scale_log2e);
    else softmax_tile<false>(sc, m, l, alpha, 0, col0, lo, hi, scale_log2e);
    rescale_rows(o, alpha);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) pack_p(sc, kk, pa[kk]);
    fence_regs(o);
    fence_regs(pa);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_rs<HD>(o, pa[kk], smem_desc(kv + S::kKvBytes + kk * 16 * S::kRowBytes, S::kKvChunkBytes, kSbo, S::kLayout));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(o);
    ++gt;
    if (++tc < Ic.nt) continue;

    // The item's last tile: its result, or its partials and the merge.
    __nv_bfloat16* ob = a.out + ((int64_t)Ic.nq * d.H + (int64_t)Ic.kvh * G) * HD;
    if (Ic.n == 1) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int g = r0 + 8 * h;
        if (g >= G) continue;
        const float lc = fmaxf(l[h], 1e-30f);
#pragma unroll
        for (int j = 0; j < HD / 8; ++j)
          *reinterpret_cast<__nv_bfloat162*>(ob + g * HD + 8 * j + col0) =
              __floats2bfloat162_rn(o[4 * j + 2 * h] / lc, o[4 * j + 2 * h + 1] / lc);
      }
    } else {
      const int64_t cell = (int64_t)Ic.slot * d.KVH + Ic.kvh;  // (query slot, KV head)
      const int64_t plane = (int64_t)d.R * d.KVH * d.S * G;
      float* sc_m = a.scratch;
      float* sc_l = a.scratch + plane;
      float* sc_acc = a.scratch + 2 * plane;
      const int64_t first = cell * d.S * G;  // this cell's split 0, head 0
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int g = r0 + 8 * h;
        if (g >= G) continue;
        float* ar = sc_acc + (first + Ic.s * G + g) * HD;
#pragma unroll
        for (int j = 0; j < HD / 8; ++j)
          *reinterpret_cast<float2*>(ar + 8 * j + col0) = make_float2(o[4 * j + 2 * h], o[4 * j + 2 * h + 1]);
        if (lane % 4 == 0) {
          sc_m[first + Ic.s * G + g] = m[h];  // raw score units
          sc_l[first + Ic.s * G + g] = l[h];
        }
      }
      // One thread publishes the team's partials (the barrier orders them
      // before its fence) and counts the split; the last to arrive merges.
      team_sync(tm.id, 128);
      if (tid == 0) {
        __threadfence();
        const int last = atomicAdd(&a.counters[cell], 1) == Ic.n - 1;
        if (last) a.counters[cell] = 0;  // ready for the next launch
        __threadfence();
        *tm.flag = last;
      }
      team_sync(tm.id, 128);
      if (*tm.flag) {
        // m = max m_s; each split's weight 2^((m_s - m)·scale·log2e) once;
        // l and acc as weighted sums, in split order.
        for (int i = tid; i < Ic.n * G; i += 128) tm.ss[i] = __ldcg(sc_m + first + i);
        team_sync(tm.id, 128);
        for (int g = tid; g < G; g += 128) {
          float mm = kNegInf;
          for (int x = 0; x < Ic.n; ++x) mm = fmaxf(mm, tm.ss[x * G + g]);
          tm.sm[g] = mm;
        }
        team_sync(tm.id, 128);
        for (int i = tid; i < Ic.n * G; i += 128) tm.ss[i] = fast_exp2((tm.ss[i] - tm.sm[i % G]) * scale_log2e);
        team_sync(tm.id, 128);
        for (int g = tid; g < G; g += 128) {
          float ll = 0.f;
          for (int x = 0; x < Ic.n; ++x) ll += __ldcg(sc_l + first + x * G + g) * tm.ss[x * G + g];
          tm.sl[g] = ll;
        }
        team_sync(tm.id, 128);
        for (int i = tid; i < G * HD; i += 128) {
          const int g = i / HD;
          float acc = 0.f;
          for (int x0 = 0; x0 < Ic.n; x0 += 8) {  // 8 loads in flight, then their sum in split order
            float v[8];
#pragma unroll
            for (int u = 0; u < 8; ++u) v[u] = x0 + u < Ic.n ? __ldcg(sc_acc + (first + (x0 + u) * G) * HD + i) : 0.f;
#pragma unroll
            for (int u = 0; u < 8; ++u)
              if (x0 + u < Ic.n) acc += v[u] * tm.ss[(x0 + u) * G + g];
          }
          ob[i] = __float2bfloat16(acc / fmaxf(tm.sl[g], 1e-30f));
        }
      }
      team_sync(tm.id, 128);  // the merge's arrays are the next item's
    }
    tc = 0;
    ++qc;
    kc = enter(kc + 1);
  }
  cp_async_wait<0>();
}

template <int HD, bool kQuant>
__device__ void split_block(const Args& a, const Dims& d, uint8_t* base) {
  using SP = Split<HD, kQuant>;
  const int tid = threadIdx.x;
  const int b = blockIdx.x - d.ntiles * d.KVH;
  const int G = d.G, NQ = d.NQ, BQ = d.BQ;
  constexpr int kWin = SP::kWin;
  uint8_t* win_base = base + d.teams * SP::team_bytes(G);
  int* w_row = reinterpret_cast<int*>(win_base);
  int* w_plen = w_row + kWin;
  int* w_es = w_plen + kWin;
  int* w_ee = w_es + kWin;
  int* w_list = w_ee + kWin;        // window indices of the split queries, in order
  int* w_pre = w_list + kWin;       // [kWin + 1] first item of each split query
  int* tmp = w_pre + kWin + 1;      // [kWarps + 1] scan scratch
  int8_t* w_live = reinterpret_cast<int8_t*>(tmp + kWarps + 1);
  int8_t* w_chunk = w_live + kWin;

  // This thread's team: warpgroup 0 or 1 (warp 8, and warpgroup 1 when
  // one team fits, take part only in the block-wide steps).
  Team tm;
  tm.id = tid / 128;
  tm.tid = tid % 128;
  {
    uint8_t* tb = base + (tm.id < d.teams ? tm.id : 0) * SP::team_bytes(G);
    tm.ring = tb;
    tm.conv = tb + SP::kStages * SP::kStage;
    tm.qbuf = tm.conv + SP::kConv;
    tm.ss = reinterpret_cast<float*>(tm.qbuf + SP::kStages * SP::q_bytes(G));
    tm.sm = tm.ss + G * kKeys;
    tm.sl = tm.sm + G;
    tm.pg = reinterpret_cast<int*>(tm.sl + G);
    tm.flag = tm.pg + SP::kPages;
  }

  const int win = BQ * (kWin / BQ);
  const int p_cap = d.W * d.BS;
  int j_base = 0;  // split queries ranked before this window
  for (int w0 = 0; w0 < NQ; w0 += win) {
    const int wn = min(win, NQ - w0);
    for (int i = tid; i < wn; i += kThreads) {
      const int nq = w0 + i;
      w_live[i] = a.meta[4 * NQ + nq] != 0;
      w_row[i] = a.meta[nq];
      w_plen[i] = min(max(a.meta[NQ + nq], 0), p_cap);
      w_es[i] = max(a.meta[2 * NQ + nq], 0);
      w_ee[i] = min(a.meta[3 * NQ + nq], d.CK);
    }
    __syncthreads();
    for (int tt = tid / 32; tt * BQ < wn; tt += kWarps)
      classify_tile(w_live + tt * BQ, w_row + tt * BQ, w_plen + tt * BQ, min(BQ, wn - tt * BQ), w_chunk + tt * BQ);
    __syncthreads();
    // Rank the split queries: thread t takes window entries [4t, 4t + 4).
    int flags = 0, cnt = 0;
#pragma unroll
    for (int x = 0; x < 4; ++x) {
      const int i = 4 * tid + x;
      const bool f = i < wn && w_live[i] && !w_chunk[i];
      flags |= f << x;
      cnt += f;
    }
    int n_b;
    int rank = block_scan(cnt, tmp, &n_b);
#pragma unroll
    for (int x = 0; x < 4; ++x)
      if (flags >> x & 1) w_list[rank++] = 4 * tid + x;
    __syncthreads();
    // Their items, (split query k, split s, KV head) with the KV head
    // fastest: split query k (rank j) has n splits (n = 1 past the first R
    // split queries), KVH * n items from w_pre[k]. Thread t takes split
    // queries [4t, 4t + 4).
    int items[4], sum = 0;
#pragma unroll
    for (int x = 0; x < 4; ++x) {
      const int k = 4 * tid + x;
      items[x] = 0;
      if (k < n_b) {
        const int n = j_base + k < d.R ? max(1, (w_plen[w_list[k]] + d.KS - 1) / d.KS) : 1;
        items[x] = n * d.KVH;
      }
      sum += items[x];
    }
    int total;
    int first = block_scan(sum, tmp, &total);
#pragma unroll
    for (int x = 0; x < 4; ++x) {
      if (4 * tid + x < n_b) w_pre[4 * tid + x] = first;
      first += items[x];
    }
    if (tid == 0) w_pre[n_b] = total;
    __syncthreads();

    // Block b takes items b, b + NB, b + 2NB, ...: the KV heads of one
    // (query, split) sit on neighbouring blocks, which take them at about
    // the same time, so their reads of a page's token rows meet in DRAM.
    // The block's teams take turns.
    if (tm.id < d.teams) {
      auto desc = [&](int kk, Item& it) {
        const int idx = b + (tm.id + kk * d.teams) * d.NB;
        int lo = 0, hi = n_b;  // w_pre[lo] <= idx < w_pre[hi]
        while (hi - lo > 1) {
          const int mid = (lo + hi) / 2;
          if (w_pre[mid] <= idx) lo = mid;
          else hi = mid;
        }
        const int i = w_list[lo];
        const int n = (w_pre[lo + 1] - w_pre[lo]) / d.KVH;
        const int rem = idx - w_pre[lo];
        it.nq = w0 + i;
        it.kvh = rem % d.KVH;
        it.row = w_row[i];
        it.n = n;
        it.s = rem / d.KVH;
        it.slot = j_base + lo;
        it.pb = n > 1 ? it.s * d.KS : 0;
        it.pe = n > 1 ? min(it.pb + d.KS, w_plen[i]) : w_plen[i];
        it.fb = it.s == n - 1 ? w_es[i] : 0;
        it.fe = it.s == n - 1 ? max(w_ee[i], it.fb) : 0;
        it.npt = (it.pe - it.pb + kKeys - 1) / kKeys;
        it.nt = it.npt + (it.fe > it.fb ? (it.fe - it.fb + kKeys - 1) / kKeys : 0);
      };
      // The team's items: m = tm.id + kk*teams for b + m*NB < total.
      const int m_all = total > b ? (total - b + d.NB - 1) / d.NB : 0;
      split_team<HD, kQuant>(a, d, tm, m_all > tm.id ? (m_all - tm.id + d.teams - 1) / d.teams : 0, desc);
    }
    j_base += n_b;
    __syncthreads();  // the window's arrays are the next window's
  }
}

// Shared memory of a bf16 launch: the larger of the chunk block's and the
// split block's (two teams where they fit in the card's 227 KB, else one).
template <int HD, bool kQuant>
__host__ __device__ inline int split_teams(int G) {
  return Split<HD, kQuant>::bytes(G, 2) <= 232448 ? 2 : 1;
}

template <int HD, bool kQuant>
__host__ __device__ inline size_t bf16_smem(int G) {
  const size_t a = Shape<HD, kQuant>::kChunkSmem, b = Split<HD, kQuant>::bytes(G, split_teams<HD, kQuant>(G));
  return a > b ? a : b;
}

template <int HD, bool kQuant>
__global__ void __launch_bounds__(kThreads, 1) ragged_bf16_kernel(Args a, Dims d) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = reinterpret_cast<uint8_t*>((reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  if ((int)blockIdx.x < d.ntiles * d.KVH) chunk_block<HD, kQuant>(a, d, base);
  else split_block<HD, kQuant>(a, d, base);
}

template <int HD, bool kQuant>
cudaError_t launch_bf16_hd(const Args& a, Dims d, cudaStream_t stream) {
  d.teams = split_teams<HD, kQuant>(d.G);
  const size_t smem = bf16_smem<HD, kQuant>(d.G);
  static size_t opted_in = 48 * 1024;  // the attribute is per function; raised when a shape needs more
  if (smem > opted_in) {
    cudaError_t e = cudaFuncSetAttribute(ragged_bf16_kernel<HD, kQuant>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
    if (e != cudaSuccess) return e;
    opted_in = smem;
  }
  ragged_bf16_kernel<HD, kQuant><<<d.ntiles * d.KVH + d.NB, kThreads, smem, stream>>>(a, d);
  return cudaGetLastError();
}

template <bool kQuant>
cudaError_t launch_bf16(int HD, const Args& a, const Dims& d, cudaStream_t s) {
  switch (HD) {
    case 16: return launch_bf16_hd<16, kQuant>(a, d, s);
    case 32: return launch_bf16_hd<32, kQuant>(a, d, s);
    case 64: return launch_bf16_hd<64, kQuant>(a, d, s);
    case 128: return launch_bf16_hd<128, kQuant>(a, d, s);
    default: return cudaErrorInvalidValue;
  }
}

int launch(int dtype, bool quant, const void* q, const void* k_extra, const void* v_extra, const void* k_pages,
           const void* v_pages, const void* k_scales, const void* v_scales, const void* tables, const void* meta,
           void* out, void* scratch, void* counters, int NQ, int H, int KVH, int HD, int CK, int W, int BS, int R,
           int BQ, int ntiles, int NB, int NS, int KS, void* stream) {
  if (NQ == 0) return 0;
  if (KVH <= 0 || H % KVH != 0 || BS <= 0) return (int)cudaErrorInvalidValue;
  const int* t = static_cast<const int*>(tables);
  const int* m = static_cast<const int*>(meta);
  const float* ks = static_cast<const float*>(k_scales);
  const float* vs = static_cast<const float*>(v_scales);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    if (quant) return launch_f32<true>(q, k_extra, v_extra, k_pages, v_pages, ks, vs, t, m, out, NQ, H, KVH, HD, CK, W, BS, s);
    return launch_f32<false>(q, k_extra, v_extra, k_pages, v_pages, ks, vs, t, m, out, NQ, H, KVH, HD, CK, W, BS, s);
  }
  if (dtype != 1) return (int)cudaErrorInvalidValue;
  // The merge keeps one weight per split and head in the [G, 64] score tile.
  if (H / KVH > 64 || BQ < 1 || BQ * (H / KVH) > kRows || ntiles != (NQ + BQ - 1) / BQ || NB < 1 || NS < 1 ||
      NS > kKeys || KS <= 0)
    return (int)cudaErrorInvalidValue;
  const Args a{static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k_extra),
               static_cast<const __nv_bfloat16*>(v_extra), k_pages, v_pages, ks, vs, t, m,
               static_cast<__nv_bfloat16*>(out), static_cast<float*>(scratch), static_cast<int*>(counters)};
  int bs_shift = -1;
  for (int k = 0; k < 31; ++k)
    if (BS == 1 << k) bs_shift = k;
  Dims d{NQ, H, KVH, H / KVH, CK, W, BS, R, BQ, ntiles, NB, NS, KS, 1, bs_shift, rsqrtf((float)HD)};
  return quant ? (int)launch_bf16<true>(HD, a, d, s) : (int)launch_bf16<false>(HD, a, d, s);
}

template <bool kQuant>
size_t bf16_smem_for(int G, int HD) {
  switch (HD) {
    case 16: return bf16_smem<16, kQuant>(G);
    case 32: return bf16_smem<32, kQuant>(G);
    case 64: return bf16_smem<64, kQuant>(G);
    case 128: return bf16_smem<128, kQuant>(G);
    default: return 0;
  }
}

}  // namespace

extern "C" {

// Shared-memory bytes one block needs (dtype 0 = float32, 1 = bfloat16;
// quant 1 = int8 pages); the wrapper refuses shapes past the card's
// per-block limit before launching. 0 for a bf16 head dim the kernel does
// not take.
size_t dtt_ragged_paged_attention_smem(int dtype, int quant, int G, int HD, int BS) {
  if (dtype == 0) return smem_floats(G, HD, BS) * sizeof(float);
  return quant ? bf16_smem_for<true>(G, HD) : bf16_smem_for<false>(G, HD);
}

// dtype: 0 = float32, 1 = bfloat16. R = tables.shape[0]; bf16 takes HD in
// {16, 32, 64, 128} and G <= 64, BQ = 128 / G queries a chunk tile,
// ntiles = ceil(NQ / BQ), NB >= 1 split blocks, NS = ceil(W*BS / KS) splits
// (1 to 64) of KS keys, `scratch` R*KVH*NS*G*(HD + 2) floats (unread when
// NS = 1) and `counters` R*KVH ints that are 0 before the launch (and are
// again after it); f32 reads none of these. Every pointer on a 16-byte
// boundary. Returns cudaGetLastError() after the launch (0 = success);
// launches on `stream` and does not synchronise.
int dtt_ragged_paged_attention(int dtype, const void* q, const void* k_extra, const void* v_extra,
                               const void* k_pages, const void* v_pages, const void* tables, const void* meta,
                               void* out, void* scratch, void* counters, int NQ, int H, int KVH, int HD, int CK,
                               int W, int BS, int R, int BQ, int ntiles, int NB, int NS, int KS, void* stream) {
  return launch(dtype, false, q, k_extra, v_extra, k_pages, v_pages, nullptr, nullptr, tables, meta, out, scratch,
                counters, NQ, H, KVH, HD, CK, W, BS, R, BQ, ntiles, NB, NS, KS, stream);
}

// The int8 branch: k_codes / v_codes int8 [NP, BS, KVH, HD] (HD a multiple
// of 16), k_scales / v_scales f32 [NP, BS, KVH, 1]; q, the fresh keys and
// out in `dtype`; the rest as above.
int dtt_ragged_paged_attention_int8(int dtype, const void* q, const void* k_extra, const void* v_extra,
                                    const void* k_codes, const void* v_codes, const void* k_scales,
                                    const void* v_scales, const void* tables, const void* meta, void* out,
                                    void* scratch, void* counters, int NQ, int H, int KVH, int HD, int CK, int W,
                                    int BS, int R, int BQ, int ntiles, int NB, int NS, int KS, void* stream) {
  return launch(dtype, true, q, k_extra, v_extra, k_codes, v_codes, k_scales, v_scales, tables, meta, out, scratch,
                counters, NQ, H, KVH, HD, CK, W, BS, R, BQ, ntiles, NB, NS, KS, stream);
}

}  // extern "C"
