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
//   per step.
// - bf16 products run on the tensor cores (`tc_product` in
//   fused_window_device.cuh, whose note has the details): 64-column tiles;
//   each warpgroup of a block is an independent lane with its own 3-slot
//   ring of weight boxes (128 rows x 64, 16 KB: with one thread issuing,
//   smaller boxes cap the stream below the memory rate) that its first
//   thread streams by TMA, the next phase's first boxes issued before the
//   grid barrier between them; the B rows are the A operand of m64n64k16
//   wgmma from swizzled shared memory (rows past B are not read out: at
//   llama-3.2-1b's widths the padded 64-row products take ~0.16 ms of
//   tensor-core time a step, its 2.47 GB of weights ~0.74 ms at the memory
//   rate); the narrow phases (QKV, wo, down: 32-48 tiles against 264
//   lanes) split K into runs so their items cover the lanes, the last
//   split of a tile summing the f32 partials in split order. The shape
//   follows the bound: the rate comes from bytes in flight (96 KB a block,
//   one block an SM), from every lane having work in every phase, and from
//   two independent chains an SM (each step's copy issue, input staging,
//   products and epilogue are latency-bound).
// - f32 keeps CUDA-core GEMVs: a phase splits its output columns into
//   tiles of 16; a block takes tiles grid-stride, its 256 threads split
//   the reduction dimension, each thread loads up to 16 bytes of a weight
//   row at a time and keeps B x VEC accumulators in registers (B is a
//   template parameter, VEC = min(16 bytes, 64 / B) elements). The input
//   rows (RMS-normed, or silu(gate)*up) are staged in shared memory in
//   f32, in chunks of 32768 / B columns; a whole hidden row fits for B <=
//   16, so a block stages it once per phase for all its tiles. The tied
//   head (embed [V, D]) is read row by row: a tile is 16 vocab rows, 16
//   threads share each row's reduction.
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
// The attention phase (CUDA cores), the sampled draw (one block a row) and
// the grid barriers' count are later work.


#include "fused_window_device.cuh"

namespace {

// Dynamic shared memory of the window at batch B, G query heads per KV
// head and head dim HD: f32, the GEMV staging area and its tail or the
// attention's; bf16, tc_layout's.
template <typename T>
size_t window_smem(int B, int G, int HD) {
  if (kTensorCores<T>) return tc_layout(attn_floats(G, HD), B, B).bytes;
  return smem_floats(B, G, HD) * sizeof(float);
}

template <typename T, int B>
__global__ void __launch_bounds__(kThreads, 1) fused_window_kernel(const __grid_constant__ Args<T> a) {
  extern __shared__ __align__(16) float smem[];
  cg::grid_group grid = cg::this_grid();
  const int tid = threadIdx.x;
  const int L = a.L, D = a.D, V = a.V;
  float* inv = smem + kXFloats + kWarps * B * kTile;
  TcCtx tc;
  TcCtx* tcp = nullptr;
  if constexpr (kTensorCores<T>) {
    const TcLayout lay = tc_layout(attn_floats(a.H / a.KVH, a.HD), B, B);
    inv = reinterpret_cast<float*>(reinterpret_cast<unsigned char*>(smem) + lay.tail);
    tc = tc_init(reinterpret_cast<unsigned char*>(smem), lay, a.tc_part, a.tc_cnt);
    tcp = &tc;
    tc_prefetch(tc, make_phase(a, kPhQkv, 0, B));  // step 0's first boxes fly during the embedding
  }
  float* lgs = inv + B;
  float* best_v = lgs + (kTensorCores<T> ? 2 * kTcN : kTile) * B;  // bf16: per lane
  int* best_i = reinterpret_cast<int*>(best_v + (kTensorCores<T> ? 2 : 1) * B);

  // Step 0's embedding, from the host's tokens; the guided rows' carry
  // from the host's rows.
  for (int64_t e = (int64_t)blockIdx.x * kThreads + tid; e < (int64_t)B * D; e += (int64_t)gridDim.x * kThreads) {
    const int b = (int)(e / D), d = (int)(e - (int64_t)b * D);
    const int t = min(max(a.tokens[b], 0), V - 1);
    a.h[e] = a.embed[(int64_t)t * D + d];
  }
  if (a.mask != nullptr && blockIdx.x == 0 && tid < B) a.grow[tid] = a.rows0[tid];
  grid.sync();
  stamp(a.prof, 0);

  Phase head = {}, qkv0 = {};
  if constexpr (kTensorCores<T>) head = make_phase(a, kPhHead, 0, B), qkv0 = make_phase(a, kPhQkv, 0, B);
  for (int i = 0; i < a.steps; ++i) {
    // Stamps of step i: after each of the 5 phases of each layer, after the
    // head, and after the argmax (1 + i * (5 L + 2) onwards).
    const int64_t s0 = 1 + (int64_t)i * (5 * L + 2);
    for (int l = 0; l < L; ++l) decode_layer<T, B>(a, smem, inv, l, i, grid, s0 + 5 * l, tcp, &head);

    // Final norm, head logits and this block's argmax partials.
    decode_head<T, B>(a, smem, inv, lgs, best_v, best_i, a.temps != nullptr ? a.logits : nullptr, a.temps, grid, tcp,
                      i + 1 < a.steps ? &qkv0 : nullptr);
    stamp(a.prof, s0 + 5 * L);

    // Block b picks row b's token (its argmax partials reduced, ties to the
    // lowest index, or its draw), emits it, moves a guided row to its FSM's
    // next row and embeds the token for the next step. No block reads
    // another row's token, FSM row or h before the barrier below.
    if (blockIdx.x < B) {
      const int b = blockIdx.x;
      PickSmem* ps = reinterpret_cast<PickSmem*>(smem);
      const int tok = a.temps != nullptr && a.temps[b] > 0.f
                          ? sample_row(a.logits + (int64_t)b * V, V, a.top_ks[b], a.top_ps[b],
                                       a.unif[(int64_t)i * B + b], ps)
                          : row_argmax<B>(a.part_val, a.part_idx, b, ps);
      if (tid == 0) {
        a.tokens_out[(int64_t)i * B + b] = tok;
        a.tok[b] = tok;
        if (a.mask != nullptr) a.grow[b] = __ldg(a.next_pool + (int64_t)__ldcg(a.grow + b) * V + tok);
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
  const size_t smem = window_smem<T>(B, G, HD);
  cudaError_t e = cudaFuncSetAttribute(fused_window_kernel<T, B>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem);
  if (e != cudaSuccess) return e;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, fused_window_kernel<T, B>, kThreads, smem);
}

template <typename T, int B>
cudaError_t launch_b(const Args<T>& a, int grid, cudaStream_t stream) {
  const size_t smem = window_smem<T>(B, a.H / a.KVH, a.HD);
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
int launch_dtype(int B, int grid, const void* const* p, const int* n, const int* plan, float eps, float theta,
                 cudaStream_t s) {
  Args<T> a = {};
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
  a.rows0 = static_cast<const int*>(p[35]);
  a.grow = static_cast<int*>(const_cast<void*>(p[36]));
  a.mask = static_cast<const unsigned*>(p[37]);
  a.next_pool = static_cast<const int*>(p[38]);
  a.steps = n[0], a.L = n[1], a.N = n[2], a.BS = n[3], a.H = n[4], a.KVH = n[5], a.HD = n[6];
  a.W = n[7], a.D = n[8], a.F = n[9], a.V = n[10], a.S = n[11];
  a.W32 = (a.V + 31) / 32;
  a.tc_part = static_cast<float*>(const_cast<void*>(p[39]));
  a.tc_cnt = static_cast<int*>(const_cast<void*>(p[40]));
  const int P = n[12];
  a.eps = eps, a.theta = theta;
  if (a.KVH <= 0 || a.H % a.KVH || a.HD % 16 || a.HD > 128 || a.D % kTile || a.F % kTile || a.V % kTile ||
      a.W <= 0 || a.BS <= 0 || a.S <= 0 || grid < B)
    return (int)cudaErrorInvalidValue;
  if (a.temps != nullptr && (a.top_ks == nullptr || a.top_ps == nullptr || a.unif == nullptr || a.logits == nullptr))
    return (int)cudaErrorInvalidValue;
  const bool any_guided = a.rows0 != nullptr || a.grow != nullptr || a.mask != nullptr || a.next_pool != nullptr;
  if (any_guided && (a.rows0 == nullptr || a.grow == nullptr || a.mask == nullptr || a.next_pool == nullptr || P <= 0))
    return (int)cudaErrorInvalidValue;
  if constexpr (kTensorCores<T>) {
    const cudaError_t e = tc_prepare<T>(a, plan);
    if (e != cudaSuccess) return (int)e;
  }
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
// logits scratch [B, V] f32 too; rows0 null for a window without guided
// rows, else rows_out [B], the mask pool [P, ceil(V / 32)] u32 and the
// next-row pool [P, V] i32 too), the bf16 products' split partials and
// per-tile counters (zero; null where no phase splits) and plan (5 x
// (splits, boxes per split), host memory; read in bf16 only), then steps,
// L, N, BS, H, KVH, HD, W, D, F, V and S, the attention's key splits (the
// partials hold B * KVH * S * G * HD and B * KVH * S * G * 2 floats; the
// split counters, B * KVH ints, start at zero and end at zero), and P, the
// pools' rows (0 without guided rows).
// `grid` must be at least B and must not exceed
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
                            const void* top_ks, const void* top_ps, const void* unif, void* logits,
                            const void* rows0, void* rows_out, const void* mask_pool, const void* next_pool,
                            void* tc_part, void* tc_cnt, const int* plan, int steps, int L, int N, int BS, int H,
                            int KVH, int HD, int W, int D, int F, int V, int S, int P, float eps, float theta,
                            void* stream) {
  if (steps <= 0) return 0;
  const void* p[41] = {embed, head, fnorm, anorm, mnorm, wq, wk, wv, wo, wg, wu, wd, kc, vc,
                       tokens, positions, tables, active, tokens_out, h, qkv, part_acc, gu, tok,
                       part_val, part_idx, prof, part_ml, attn, split_cnt, temps, top_ks, top_ps, unif,
                       logits, rows0, rows_out, mask_pool, next_pool, tc_part, tc_cnt};
  const int n[13] = {steps, L, N, BS, H, KVH, HD, W, D, F, V, S, P};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_dtype<float>(B, grid, p, n, plan, eps, theta, s);
  if (dtype == 1) return launch_dtype<__nv_bfloat16>(B, grid, p, n, plan, eps, theta, s);
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
