// Fused speculative-decoding window for Hopper (sm_90a), CUDA C++ with a
// plain C entry point loaded through ctypes.
//
// Replaces the TPU Pallas kernel `_fused_spec_kernel`
// (dynamo_tpu/engine/attention/megakernel.py, launched by
// `fused_spec_window`). One launch runs R speculative rounds for B rows over
// two dense llamas, a draft and a target, each with its own paged KV cache.
// Per round, with the cursors (pos, tok, xprev) on the device:
//   1. the draft's catch-up: a one-token forward of xprev at pos - 1 (its
//      head skipped: the logits are unused);
//   2. gamma draft proposals: one-token forwards from tok at pos, pos + 1,
//      ...; after each head, block b picks row b's proposal x_g (the argmax,
//      or for a sampled row the draw of JAX `filtered_probs_rows` +
//      `pick_from_probs` on u[r, b, g]) and keeps the row's filter (max,
//      threshold, normalizer) beside its scaled logits;
//   3. the target's verify: the chunk [tok, x_1 .. x_gamma] at pos .. pos +
//      gamma as B (gamma + 1) rows through every target layer, each row's K/V
//      written before any row attends (a phase and a grid barrier of its
//      own: a chunk row attends keys that other rows write), then the head
//      over every row, its logits kept scaled;
//   4. rejection sampling: one block per target row computes its filter (or
//      its argmax for a greedy row); then block b accepts x_g while
//      u[r, b, gamma + g] < min(1, p_t(x_g) / max(p_d(x_g), 1e-20)); at the
//      first rejection k it draws the correction from max(p_t - p_d, 0)
//      renormalized (p_t where that sums to <= 1e-20), with all accepted the
//      bonus from the target's last row, both on u[r, b, 2 gamma] by inverse
//      CDF in index order; a greedy row accepts while its proposal is the
//      target's argmax and appends that argmax;
//   5. the cursors advance: pos += k + 1, tok = y, xprev = x_k (tok when
//      k = 0); tokens_out[r, b] = (x_1 .. x_gamma, y), accepted[r, b] = k.
// Rejected rows of either cache are never rewound: the next round writes
// each of their positions before anything attends to it.
//
// What bounds it: like the fused decode window, every weight of the draft
// is read once per forward (gamma + 1 per round, less the catch-up's head)
// and the target's once per round, at two operations per weight and row,
// far below the tensor cores' rate: the bound is the memory rate. The design
// is the decode window's (fused_window_device.cuh): one persistent
// cooperative launch, grid = occupancy x SMs, phases split by grid barriers,
// split paged attention, and in bf16 the tensor-core products (`tc_product`:
// TMA weight boxes into a ring, wgmma, split-K for the narrow phases); f32
// keeps CUDA-core GEMVs over 16-column tiles. What is new:
// - The verify's B (gamma + 1) rows (up to 288) go through the same
//   product in ONE pass over the weights: each staged box is applied to
//   every row, 64 rows a pass (each pass its own f32 accumulator kept
//   across the item's boxes; five passes at most), so the target's
//   weights leave HBM once per round whatever gamma, and the verify costs
//   one target step's products plus its attention over B (gamma + 1)
//   rows. In f32 the GEMVs apply each tile in passes of B rows (kPasses),
//   the later passes reading the tile from L1/L2.
// - Both models' logits stay in f32 scratch (draft [gamma, B, V], target
//   [B (gamma + 1), V]), scaled by the row's temperature, with each sampled
//   row's filter, so p_d and p_t of any token are one load each; the
//   residual draw makes one pass over V for its sum and a scan.
// - Timer stamps (with a profile buffer, block 0): one at the start, then per
//   round one after the catch-up, one after each proposal, one after the
//   verify and one after the rejection sampling.
// The product sequence is fixed (per round: the draft's layers for the
// catch-up and each proposal, a draft head after each proposal, the
// verify's layers, the target head), so each product names the next and
// the ring streams across phases, models and rounds.

#include "fused_window_device.cuh"

namespace {

constexpr int kMaxGamma = 8;
constexpr int kInvMax = 32 * (kMaxGamma + 1);  // the verify's rows, B (gamma + 1) <= 288

template <typename T>
struct SpecArgs {
  Args<T> d;  // the draft's one-token forwards over B rows (positions: the cursor pos)
  Args<T> t;  // the target's verify over B (gamma + 1) rows (positions: vpos)
  const int* tokens;     // [B] last confirmed token
  const int* xprev;      // [B] token at positions - 1
  const int* positions;  // [B] position of the last confirmed token
  const int* top_ks;     // [B]
  const float* temps;    // [B] (0 = greedy)
  const float* top_ps;   // [B]
  const float* unif;     // [R, B, 2 gamma + 1]
  int* tokens_out;       // [R, B, gamma + 1]
  int* accepted;         // [R, B]
  int* cur;              // [3, B]: pos, tok, xprev
  int* props;            // [gamma, B] this round's proposals
  int* vpos;             // [B (gamma + 1)] verify row s B + b: pos[b] + s
  float* dlog;           // [gamma, B, V] scaled draft logits
  float* tlog;           // [B (gamma + 1), V] scaled target logits
  float* dstat;          // [gamma, B, 3] draft filters (m, thresh, zk)
  float* tstat;          // [B (gamma + 1), 3] target filters
  int* tmode;            // [B (gamma + 1)] target argmax / mode
  unsigned long long* prof;  // [1 + R (gamma + 3)] timer stamps, or null
  int B, Bv, G, R, V;
};

__device__ __forceinline__ RowFilter load_filter(const float* st, const int* mode) {
  RowFilter f;
  f.m = __ldcg(st), f.thresh = __ldcg(st + 1), f.zk = __ldcg(st + 2);
  f.mode = mode != nullptr ? __ldcg(mode) : 0;
  return f;
}

struct OutScaled {  // row rv's logit into logits [n, V], divided by its batch row's temperature when > 0
  float* logits;
  const float* temps;
  int B, V;
  __device__ void operator()(int rv, int c, float v) const {
    const float t = temps[rv % B];
    logits[(int64_t)rv * V + c] = t > 0.f ? v / t : v;  // a division, as JAX scales
  }
};

// One target layer over the verify's n rows: decode_layer's phases with
// the chunk's K/V written in a phase of its own before the attention.
template <typename T, int B>
__device__ void verify_layer(const Args<T>& a, int n, float* smem, float* inv, int l, cg::grid_group& grid) {
  const int D = a.D, F = a.F;
  const int HQ = a.H * a.HD, HKV = a.KVH * a.HD, NQKV = HQ + 2 * HKV;
  row_inv_rows<T>(a.h, n, D, a.eps, inv);
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
    gemv_cols<T, B, true>(smem, D, NQKV / kTile, n, XNorm<T>{a.h, D, inv, a.anorm + (int64_t)l * D}, wsel,
                    OutRows<T>{a.qkv, NQKV}, NoAfter{});
  }
  grid.sync();
  write_chunk_kv<T>(a, n, l);
  grid.sync();
  attention<T>(a, smem, l, 0, n, /*write_kv=*/false);
  grid.sync();
  {
    const T* wo = a.wo + (int64_t)l * HQ * D;
    auto wsel = [&](int t, const T*& W, int& ldw, int& c0) { W = wo, ldw = D, c0 = t * kTile; };
    gemv_cols<T, B, true>(smem, HQ, D / kTile, n, XRows<T>{a.attn, HQ}, wsel, OutResidual<T>{a.h, D}, NoAfter{});
  }
  grid.sync();
  row_inv_rows<T>(a.h, n, D, a.eps, inv);
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
    gemv_cols<T, B, true>(smem, D, 2 * F / kTile, n, XNorm<T>{a.h, D, inv, a.mnorm + (int64_t)l * D}, wsel,
                    OutRows<T>{a.gu, 2 * F}, NoAfter{});
  }
  grid.sync();
  {
    const T* wd = a.wd + (int64_t)l * F * D;
    auto wsel = [&](int t, const T*& W, int& ldw, int& c0) { W = wd, ldw = D, c0 = t * kTile; };
    gemv_cols<T, B, true>(smem, F, D / kTile, n, XSiluUp<T>{a.gu, F}, wsel, OutResidual<T>{a.h, D}, NoAfter{});
  }
  grid.sync();
}

// h[row, :] = embed[token, :] for a row and token of this block (all threads).
template <typename T>
__device__ __forceinline__ void embed_row(const Args<T>& a, int row, int token, T* h) {
  const int D = a.D;
  token = min(max(token, 0), a.V - 1);
  for (int e = threadIdx.x; e < D; e += kThreads) h[(int64_t)row * D + e] = a.embed[(int64_t)token * D + e];
}

// The correction at a sampled row's first rejection: p(i) = max(p_t(i) -
// p_d(i), 0) / rs over the target's and the draft's filtered rows, drawn by
// inverse CDF in index order on u; its first maximum when u is past the
// total; p_t itself where rs <= 1e-20 (JAX spec_verify's rule). Every
// thread returns it.
__device__ int residual_draw(const float* trow, const RowFilter& tf, const float* drow, const RowFilter& df, int V,
                             float u, PickSmem* ps) {
  const float4* t4 = reinterpret_cast<const float4*>(trow);
  const float4* d4 = reinterpret_cast<const float4*>(drow);
  auto resid4 = [&](int i) {
    const float4 a = __ldcg(t4 + i / 4), c = __ldcg(d4 + i / 4);
    return make_float4(fmaxf(filtered_p(a.x, tf) - filtered_p(c.x, df), 0.f),
                       fmaxf(filtered_p(a.y, tf) - filtered_p(c.y, df), 0.f),
                       fmaxf(filtered_p(a.z, tf) - filtered_p(c.z, df), 0.f),
                       fmaxf(filtered_p(a.w, tf) - filtered_p(c.w, df), 0.f));
  };
  float rs = 0.f;
  for (int i = threadIdx.x * 4; i < V; i += kThreads * 4) {
    const float4 r = resid4(i);
    rs += (r.x + r.y) + (r.z + r.w);
  }
  rs = block_sum(rs, ps);
  if (!(rs > 1e-20f)) return draw_filtered(trow, V, tf, u, ps);
  const int hit = cdf_draw(V, u, ps, [&](int i) {
    const float4 r = resid4(i);
    return make_float4(r.x / rs, r.y / rs, r.z / rs, r.w / rs);
  });
  if (hit != INT_MAX) return hit;
  float m = -INFINITY;
  int mi = INT_MAX;
  for (int i = threadIdx.x * 4; i < V; i += kThreads * 4) {  // ascending: strict > keeps the first
    const float4 r = resid4(i);
    const float v[4] = {r.x, r.y, r.z, r.w};
    for (int j = 0; j < 4; ++j)
      if (v[j] > m) m = v[j], mi = i + j;
  }
  block_argmax(m, mi, ps);
  return mi == INT_MAX ? 0 : mi;
}

// Dynamic shared memory of the spec kernel at batch B and each model's
// query heads per KV head and head dim: f32, the GEMV staging area, its
// tail and kInvMax inverse norms, or the larger attention's; bf16,
// tc_layout's.
template <typename T>
size_t spec_smem_bytes(int B, int Gt, int HDt, int Gd, int HDd) {
  if (kTensorCores<T>) {
    const size_t at = attn_floats(Gt, HDt), ad = attn_floats(Gd, HDd);
    return tc_layout(at > ad ? at : ad, kInvMax, B).bytes;
  }
  size_t n = gemv_floats(B) + kInvMax;
  n = n > attn_floats(Gt, HDt) ? n : attn_floats(Gt, HDt);
  return (n > attn_floats(Gd, HDd) ? n : attn_floats(Gd, HDd)) * sizeof(float);
}

template <typename T, int B>
__global__ void __launch_bounds__(kThreads, 1) fused_spec_kernel(const __grid_constant__ SpecArgs<T> s) {
  extern __shared__ __align__(16) float smem[];
  cg::grid_group grid = cg::this_grid();
  const Args<T>& d = s.d;
  const Args<T>& t = s.t;
  const int tid = threadIdx.x, G = s.G, V = s.V, Bv = s.Bv, U = 2 * s.G + 1;
  float* inv = smem + kXFloats + kWarps * B * kTile;  // kInvMax floats
  TcCtx tc;
  TcCtx* tcp = nullptr;
  // The products in launch order: per round the draft's layers (QKV, wo,
  // gate/up, down each) for the catch-up and each proposal, a draft head
  // after each proposal, the verify's layers, the target's head.
  Phase d_qkv0 = {}, d_head = {}, t_qkv0 = {}, t_head = {};
  if constexpr (kTensorCores<T>) {
    const size_t at = attn_floats(t.H / t.KVH, t.HD), ad = attn_floats(d.H / d.KVH, d.HD);
    const TcLayout lay = tc_layout(at > ad ? at : ad, kInvMax, B);
    inv = reinterpret_cast<float*>(reinterpret_cast<unsigned char*>(smem) + lay.tail);
    tc = tc_init(reinterpret_cast<unsigned char*>(smem), lay, t.tc_part, t.tc_cnt);
    tcp = &tc;
    d_qkv0 = make_phase(d, kPhQkv, 0, B), d_head = make_phase(d, kPhHead, 0, B);
    t_qkv0 = make_phase(t, kPhQkv, 0, Bv), t_head = make_phase(t, kPhHead, 0, Bv);
    tc_prefetch(tc, d_qkv0);  // the first catch-up's first boxes fly during the set-up
  }
  float* lgs = inv + kInvMax;
  float* best_v = lgs + (kTensorCores<T> ? 2 * kTcN : kTile) * B;  // bf16: per lane
  int* best_i = reinterpret_cast<int*>(best_v + (kTensorCores<T> ? 2 : 1) * B);
  PickSmem* ps = reinterpret_cast<PickSmem*>(smem);
  int* cur_pos = s.cur;
  int* cur_tok = s.cur + B;
  int* cur_xprev = s.cur + 2 * B;
  __shared__ int shared_k, shared_x;

  // The cursors from the host's rows; the first catch-up's embedding.
  if (blockIdx.x < B) {
    const int b = blockIdx.x;
    if (tid == 0) {
      cur_pos[b] = s.positions[b];
      cur_tok[b] = s.tokens[b];
      cur_xprev[b] = s.xprev[b];
    }
    embed_row(d, b, s.xprev[b], d.h);
  }
  grid.sync();
  stamp(s.prof, 0);

  for (int r = 0; r < s.R; ++r) {
    const int64_t s0 = 1 + (int64_t)r * (G + 3);
    // 1. The draft's catch-up (g = -1: xprev at pos - 1, no head), then
    // 2. gamma proposals from tok at pos. One loop, so the draft's layer is
    // one copy in the kernel's code.
    for (int g = -1; g < G; ++g) {
      for (int l = 0; l < d.L; ++l) decode_layer<T, B>(d, smem, inv, l, g, grid, 0, tcp, g < 0 ? &d_qkv0 : &d_head);
      if (g < 0) {
        // The proposals start from tok; the verify's row s B + b is batch
        // row b's chunk position s, at pos + s.
        if (blockIdx.x < B) {
          const int b = blockIdx.x;
          const int tok = __ldcg(cur_tok + b), pos = __ldcg(cur_pos + b);
          embed_row(d, b, tok, d.h);
          embed_row(t, b, tok, t.h);
          for (int j = tid; j <= G; j += kThreads) s.vpos[j * B + b] = pos + j;
        }
        grid.sync();
        stamp(s.prof, s0);
        continue;
      }
      float* dl = s.dlog + (int64_t)g * B * V;
      decode_head<T, B>(d, smem, inv, lgs, best_v, best_i, dl, s.temps, grid, tcp, g + 1 < G ? &d_qkv0 : &t_qkv0);
      if (blockIdx.x < B) {
        const int b = blockIdx.x;
        int x;
        if (s.temps[b] > 0.f) {
          const float* row = dl + (int64_t)b * V;
          const RowFilter f = row_filter(row, V, s.top_ks[b], s.top_ps[b], ps);
          if (tid == 0) {
            float* st = s.dstat + ((int64_t)g * B + b) * 3;
            st[0] = f.m, st[1] = f.thresh, st[2] = f.zk;
          }
          x = f.mode == INT_MAX ? 0 : draw_filtered(row, V, f, s.unif[((int64_t)r * B + b) * U + g], ps);
        } else {
          x = row_argmax<B>(d.part_val, d.part_idx, b, ps);
        }
        if (tid == 0) s.props[g * B + b] = x;
        if (g + 1 < G) embed_row(d, b, x, d.h);
        embed_row(t, (g + 1) * B + b, x, t.h);
      }
      grid.sync();
      stamp(s.prof, s0 + 1 + g);
    }

    // 3. The target's verify over the chunk's Bv rows, then its head.
    if constexpr (kTensorCores<T>) {
      for (int l = 0; l < t.L; ++l) tc_layer<T>(t, tc, smem, inv, l, 0, Bv, true, &t_head, grid, 0);
      row_inv_rows<T>(t.h, Bv, t.D, t.eps, inv);
      OutDst out = {};
      out.kind = kOutScaled, out.logits = s.tlog, out.temps = s.temps, out.B = B, out.V = V;
      tc_product_rows(tc, t_head, r + 1 < s.R ? &d_qkv0 : nullptr, XSrc{kXNorm, t.h, t.D, inv, t.fnorm, 0}, out);
    } else {
      for (int l = 0; l < t.L; ++l) verify_layer<T, B>(t, Bv, smem, inv, l, grid);
      row_inv_rows<T>(t.h, Bv, t.D, t.eps, inv);
      const XNorm<T> xf{t.h, t.D, inv, t.fnorm};
      const OutScaled out{s.tlog, s.temps, B, V};
      if (t.head != nullptr) {
        const T* hw = t.head;
        auto wsel = [&](int i, const T*& W, int& ldw, int& c0) { W = hw, ldw = V, c0 = i * kTile; };
        gemv_cols<T, B, true>(smem, t.D, V / kTile, Bv, xf, wsel, out, NoAfter{});
      } else {
        gemv_rows<T, B, true>(smem, t.embed, t.D, V / kTile, Bv, xf, out, NoAfter{});
      }
    }
    grid.sync();
    stamp(s.prof, s0 + 1 + G);

    // 4. Each target row's filter (a sampled row) or argmax (a greedy one).
    for (int rv = blockIdx.x; rv < Bv; rv += gridDim.x) {
      const int b = rv % B;
      const float* row = s.tlog + (int64_t)rv * V;
      int mode;
      if (s.temps[b] > 0.f) {
        const RowFilter f = row_filter(row, V, s.top_ks[b], s.top_ps[b], ps);
        if (tid == 0) {
          float* st = s.tstat + (int64_t)rv * 3;
          st[0] = f.m, st[1] = f.thresh, st[2] = f.zk;
        }
        mode = f.mode;
      } else {
        float m;
        row_mode(row, V, m, mode, ps);
      }
      if (tid == 0) s.tmode[rv] = mode;
      __syncthreads();  // shared memory is reused by the next row
    }
    grid.sync();

    // 5. Block b's rejection sampling; its row's cursors advance.
    if (blockIdx.x < B) {
      const int b = blockIdx.x;
      const float* u = s.unif + ((int64_t)r * B + b) * U;
      const bool sampled = s.temps[b] > 0.f;
      if (tid == 0) {
        int k = 0;
        for (; k < G; ++k) {
          const int rt = k * B + b, x = __ldcg(s.props + rt);
          if (!sampled) {
            if (x != __ldcg(s.tmode + rt)) break;
            continue;
          }
          const float pt = filtered_p(__ldcg(s.tlog + (int64_t)rt * V + x), load_filter(s.tstat + (int64_t)rt * 3, nullptr));
          const float pd = filtered_p(__ldcg(s.dlog + (int64_t)rt * V + x), load_filter(s.dstat + (int64_t)rt * 3, nullptr));
          if (!(u[G + k] < fminf(pt / fmaxf(pd, 1e-20f), 1.f))) break;
        }
        shared_k = k;
      }
      __syncthreads();
      const int k = shared_k, rk = k * B + b;
      int y;
      if (!sampled) {
        y = __ldcg(s.tmode + rk);
      } else {
        const RowFilter tf = load_filter(s.tstat + (int64_t)rk * 3, s.tmode + rk);
        const float* trow = s.tlog + (int64_t)rk * V;
        if (tf.mode == INT_MAX) {
          y = 0;  // no finite logit
        } else if (k == G) {
          y = draw_filtered(trow, V, tf, u[2 * G], ps);  // the bonus
        } else {
          y = residual_draw(trow, tf, s.dlog + (int64_t)rk * V, load_filter(s.dstat + (int64_t)rk * 3, nullptr), V,
                            u[2 * G], ps);
        }
      }
      if (tid == 0) {
        int* out = s.tokens_out + ((int64_t)r * B + b) * (G + 1);
        for (int j = 0; j < G; ++j) out[j] = __ldcg(s.props + j * B + b);
        out[G] = y;
        s.accepted[(int64_t)r * B + b] = k;
        const int tok = __ldcg(cur_tok + b);
        shared_x = k >= 1 ? __ldcg(s.props + (k - 1) * B + b) : tok;
        cur_pos[b] = __ldcg(cur_pos + b) + k + 1;
        cur_tok[b] = y;
        cur_xprev[b] = shared_x;
      }
      __syncthreads();
      if (r + 1 < s.R) embed_row(d, b, shared_x, d.h);  // the next round's catch-up
    }
    grid.sync();
    stamp(s.prof, s0 + 2 + G);
  }
}

template <typename T, int B>
cudaError_t blocks_b(size_t smem, int* per_sm) {
  cudaError_t e =
      cudaFuncSetAttribute(fused_spec_kernel<T, B>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, fused_spec_kernel<T, B>, kThreads, smem);
}

template <typename T, int B>
cudaError_t launch_b(const SpecArgs<T>& s, int grid, size_t smem, cudaStream_t stream) {
  cudaError_t e =
      cudaFuncSetAttribute(fused_spec_kernel<T, B>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  void* params[] = {const_cast<SpecArgs<T>*>(&s)};
  e = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(fused_spec_kernel<T, B>), dim3(grid),
                                  dim3(kThreads), params, smem, stream);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

template <typename T>
cudaError_t blocks_t(int B, size_t smem, int* per_sm) {
  switch (B) {
    case 1: return blocks_b<T, 1>(smem, per_sm);
    case 2: return blocks_b<T, 2>(smem, per_sm);
    case 4: return blocks_b<T, 4>(smem, per_sm);
    case 8: return blocks_b<T, 8>(smem, per_sm);
    case 16: return blocks_b<T, 16>(smem, per_sm);
    case 32: return blocks_b<T, 32>(smem, per_sm);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t launch_t(const SpecArgs<T>& s, int grid, size_t smem, cudaStream_t st) {
  switch (s.B) {
    case 1: return launch_b<T, 1>(s, grid, smem, st);
    case 2: return launch_b<T, 2>(s, grid, smem, st);
    case 4: return launch_b<T, 4>(s, grid, smem, st);
    case 8: return launch_b<T, 8>(s, grid, smem, st);
    case 16: return launch_b<T, 16>(s, grid, smem, st);
    case 32: return launch_b<T, 32>(s, grid, smem, st);
    default: return cudaErrorInvalidValue;
  }
}

// One model's Args: weights w[12] (embed, head or null, fnorm, anorm,
// mnorm, wq, wk, wv, wo, wg, wu, wd), its caches, the rows' positions,
// tables and active flags, its scratch p[7] (h, qkv, part_acc, part_ml,
// attn, split_cnt, gu), and its dims n[9] (L, N, H, KVH, HD, W, D, F, S).
template <typename T>
Args<T> model_args(const void* const* w, const void* kc, const void* vc, const int* positions, const int* tables,
                   const int* active, void* const* p, const int* n, int BS, int V, float eps, float theta) {
  Args<T> a = {};
  const T* const* wt = reinterpret_cast<const T* const*>(w);
  a.embed = wt[0], a.head = wt[1], a.fnorm = wt[2], a.anorm = wt[3], a.mnorm = wt[4];
  a.wq = wt[5], a.wk = wt[6], a.wv = wt[7], a.wo = wt[8], a.wg = wt[9], a.wu = wt[10], a.wd = wt[11];
  a.kc = static_cast<T*>(const_cast<void*>(kc));
  a.vc = static_cast<T*>(const_cast<void*>(vc));
  a.positions = positions, a.tables = tables, a.active = active;
  a.h = static_cast<T*>(p[0]);
  a.qkv = static_cast<T*>(p[1]);
  a.part_acc = static_cast<float*>(p[2]);
  a.part_ml = static_cast<float*>(p[3]);
  a.attn = static_cast<T*>(p[4]);
  a.split_cnt = static_cast<int*>(p[5]);
  a.gu = static_cast<T*>(p[6]);
  a.L = n[0], a.N = n[1], a.H = n[2], a.KVH = n[3], a.HD = n[4], a.W = n[5], a.D = n[6], a.F = n[7], a.S = n[8];
  a.BS = BS, a.V = V, a.eps = eps, a.theta = theta;
  return a;
}

bool model_ok(const int* n, int V) {  // (L, N, H, KVH, HD, W, D, F, S)
  return n[0] > 0 && n[1] > 0 && n[3] > 0 && n[2] % n[3] == 0 && n[4] % 16 == 0 && n[4] <= 128 && n[5] > 0 &&
         n[6] % kTile == 0 && n[7] % kTile == 0 && n[8] > 0 && V % kTile == 0;
}

template <typename T>
int launch_dtype(const void* const* w, void* const* p, const int* n, const float* f, cudaStream_t stream) {
  const int B = n[0], grid = n[1], G = n[2], R = n[3], V = n[4], BS = n[5];
  const int* tn = n + 6;
  const int* dn = n + 15;
  const int Bv = B * (G + 1);
  if (G < 1 || G > kMaxGamma || Bv > kInvMax || grid < B || BS <= 0 || !model_ok(tn, V) || !model_ok(dn, V))
    return (int)cudaErrorInvalidValue;
  SpecArgs<T> s = {};
  // Buffers, in the wrapper's order.
  const int* positions = static_cast<const int*>(p[6]);
  int* cur = static_cast<int*>(p[16]);
  s.t = model_args<T>(w, p[0], p[1], static_cast<const int*>(p[36]), static_cast<const int*>(p[34]),
                      static_cast<const int*>(p[35]), p + 25, tn, BS, V, f[0], f[1]);
  s.d = model_args<T>(w + 12, p[2], p[3], cur, static_cast<const int*>(p[8]), static_cast<const int*>(p[9]),
                      p + 18, dn, BS, V, f[2], f[3]);
  s.d.part_val = static_cast<float*>(p[32]);
  s.d.part_idx = static_cast<int*>(p[33]);
  s.tokens = static_cast<const int*>(p[4]);
  s.xprev = static_cast<const int*>(p[5]);
  s.positions = positions;
  s.top_ks = static_cast<const int*>(p[10]);
  s.temps = static_cast<const float*>(p[11]);
  s.top_ps = static_cast<const float*>(p[12]);
  s.unif = static_cast<const float*>(p[13]);
  s.tokens_out = static_cast<int*>(p[14]);
  s.accepted = static_cast<int*>(p[15]);
  s.cur = cur;
  s.props = static_cast<int*>(p[17]);
  s.vpos = static_cast<int*>(p[36]);
  s.dlog = static_cast<float*>(p[37]);
  s.tlog = static_cast<float*>(p[38]);
  s.dstat = static_cast<float*>(p[39]);
  s.tstat = static_cast<float*>(p[40]);
  s.tmode = static_cast<int*>(p[41]);
  s.prof = static_cast<unsigned long long*>(p[42]);
  s.B = B, s.Bv = Bv, s.G = G, s.R = R, s.V = V;
  if constexpr (kTensorCores<T>) {
    // One set of split partials and counters serves both models: their
    // products never overlap.
    s.t.tc_part = s.d.tc_part = static_cast<float*>(p[43]);
    s.t.tc_cnt = s.d.tc_cnt = static_cast<int*>(p[44]);
    cudaError_t e = tc_prepare<T>(s.t, n + 24);
    if (e == cudaSuccess) e = tc_prepare<T>(s.d, n + 34);
    if (e != cudaSuccess) return (int)e;
  }
  const size_t smem = spec_smem_bytes<T>(B, tn[2] / tn[3], tn[4], dn[2] / dn[3], dn[4]);
  return (int)launch_t<T>(s, grid, smem, stream);
}

}  // namespace

extern "C" {

// Co-resident blocks of the spec kernel (occupancy x SMs) at this dtype (0 =
// float32, 1 = bfloat16), batch B, and each model's query heads per KV head
// and head dim (target, then draft); *sm_count gets the SM count. A
// negative return is -cudaError.
int dtt_fused_spec_window_blocks(int dtype, int B, int Gt, int HDt, int Gd, int HDd, int* sm_count) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess) {
    if (dtype == 0)
      e = blocks_t<float>(B, spec_smem_bytes<float>(B, Gt, HDt, Gd, HDd), &per_sm);
    else if (dtype == 1)
      e = blocks_t<__nv_bfloat16>(B, spec_smem_bytes<__nv_bfloat16>(B, Gt, HDt, Gd, HDd), &per_sm);
    else
      e = cudaErrorInvalidValue;
  }
  if (e != cudaSuccess) return -(int)e;
  *sm_count = sms;
  return per_sm * sms;
}

// One spec window. w: the target's 12 weight pointers, then the draft's
// (see model_args; a null head is a tied one). p: the 45 buffers in the
// order of `megakernel.fused_spec_window` (caches, the rows' inputs,
// outputs, cursors, proposals, each model's scratch, the draft's argmax
// partials, the verify's tables, active flags and positions, both models'
// scaled logits, filters and modes, the profile or null, the bf16
// products' split partials and per-tile counters, zero, or null where no
// phase splits). n: B, grid, gamma, R, V, BS, then the target's and the
// draft's (L, N, H, KVH, HD, W, D, F, S), then the target's plan at B
// (gamma + 1) rows and the draft's at B rows (5 x (splits, boxes per
// split) each, read in bf16 only). f: the target's rms eps and rope theta,
// then the draft's. The split counters start at zero and end at zero.
// Returns 0 or the cudaError of the cooperative launch; launches on
// `stream` and does not synchronise.
int dtt_fused_spec_window(int dtype, int nbufs, const void* const* w, void* const* p, const int* n, const float* f,
                          void* stream) {
  if (nbufs != 45) return (int)cudaErrorInvalidValue;
  if (n[3] <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_dtype<float>(w, p, n, f, s);
  if (dtype == 1) return launch_dtype<__nv_bfloat16>(w, p, n, f, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
