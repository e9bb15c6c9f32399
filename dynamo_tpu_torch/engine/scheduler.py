"""Continuous batching scheduler: the engine's step loop.

The core loop of the JAX package's ``Scheduler``:

- **Chunked prefill**: prompts longer than a chunk run as several chunks.
- **Wave admission**: when at least two short prompts wait, the head among
  them, up to a decode bucket of them are prefilled in ONE
  ``llama.chunk_decode`` pass (each row's last logits, one draw, one host
  read), unless a draft is attached; a wave is preferred to a mixed step
  while its prompts fit the mixed budget.
- **Prefix caching**: prompt block hashes are matched against the
  allocator's registry at first touch; matched blocks skip prefill, a full
  cover recomputes only the last token, and a shared last block is copied
  on write.
- **Mixed prefill+decode steps**: with sequences decoding AND prefill work
  waiting, each iteration runs ONE ragged batch — the decode batch plus up
  to ``mixed_prefill_budget`` chunk tokens (``llama.mixed_step``).
- **Attention path**: the model's ``attention_impl`` picks the megakernel
  or a per-piece path (``llama.resolve_attention_impl``); on the per-piece
  paths ``prefill_impl`` picks the flash chunk kernel ("auto": on a CUDA
  device) and every chunk says whether it has a cached prefix.
- **int8 storage** (``kv_cache_dtype`` / ``weight_dtype`` "int8"): as in
  the JAX package, the fused window and the fused spec window are off, so
  every forward goes through the per-step ragged kernel (its int8 branch
  over an int8 cache), windows through ``llama.decode_multi``; ``"paged"``
  over an int8 cache degrades to the gather.
- **Preemption**: a decode row that cannot grow its block table evicts the
  newest other running sequence, which later recomputes its KV.
- **Multi-step decode windows** (``num_scheduler_steps`` > 1, default 32):
  a decode iteration runs a window of N steps with the token fed back on
  the device and one host sync, N the smallest rung (8, 16,
  ``num_scheduler_steps``) covering the batch's remaining budget, capped
  while requests wait. On the megakernel path every batch runs the whole
  window as ONE launch of the fused decode-window kernel
  (``llama.decode_multi_fused``): greedy rows take the argmax, sampled rows
  draw in the kernel from uniforms the host derives once per window
  (``sampling.make_window_uniforms``). Off it, a batch runs
  ``llama.decode_multi``, one forward per step, unless a row is seeded
  and sampled, or guided: that batch decodes one step at a time, as in
  the JAX package. Tokens past a row's stop are trimmed.
- **Per-request extras** (logprobs, ``top_logprobs``, frequency/presence
  penalties, logits processors such as ``logit_bias``): such a row needs
  the host between tokens, so it rides no window, no overlapped step, no
  spec round, and (processors and logprobs) no wave. Its single steps
  apply the penalties (``sampling.apply_penalties``) and its processor
  chain on the device, then draw eagerly with the logprobs it asks for.
  **Row-wise fallback**, as in the JAX package: when the fused window is
  on, the batch's window-eligible rows still run one fused window and
  only the extras rows take a single step in the same iteration
  (``rowwise_windows_total``).
- **Guided decoding** (``attach_guided``): a request's grammar lifts to a
  token FSM against the served tokenizer (llm/guided). Per-step rows draw
  through the masked sampler; on the fused window guided rows ride the
  window, masked and advanced on the device through the mask and next-row
  pools, and never speculate.
- **Speculative decoding** (``attach_draft``): a draft model over its own
  paged cache, mirroring the target's block tables. Where the fused spec
  window's gate passes, every decode batch runs R = ``num_scheduler_steps
  // (γ+1)`` rounds of draft proposals, target verify and rejection
  sampling in ONE launch of the fused spec-window kernel
  (``llama.decode_spec_fused``), then replays the accepted bursts on the
  host. Elsewhere (one step an iteration, the per-piece paths, int8, a γ
  or batch the kernel refuses) a batch runs one round an iteration
  (``_decode_spec``): a draft ``chunk_decode`` pass and a γ-1-step
  ``decode_multi`` window propose, one target ``chunk_decode`` pass
  verifies, ``spec_verify`` accepts. A batch with a guided or seeded
  sampled row, or one whose blocks cannot be reserved, takes the non-spec
  path above; the draft catches up on the tokens it missed.
- **Overlapped decode** (``enable_overlap_decode``, on by default, as in
  the JAX package): a single-step batch with no guided or seeded sampled
  row, no draft and nobody waiting enters the zero-bubble pipeline: step
  N+1 (``llama.decode_sample``: forward, draw and next inputs on the
  device) is launched from step N's device outputs before the host reads
  step N's tokens, through a non-blocking copy into pinned memory. Tokens
  stream one step behind; a composition change flushes the pipeline, and
  a row that finished while its next step ran has that step's KV slot
  zeroed (``_kv_zero``).
- **CUDA graphs** (``engine/graphs.py``): on the megakernel path every
  prefill chunk, wave, mixed step, decode step, overlapped step, per-step
  draw, ``decode_multi`` step and per-round spec pass (``spec_verify``
  aside) replays a graph captured once per shape key
  (``warmup`` captures the key space up to a context length before
  traffic); on the CPU the same code runs eagerly. The per-piece paths,
  guided draws and the fused windows (one launch each already) stay
  eager.
- **Model families** (``models.get_module``): the dense llama family, llama
  with expert layers and MLA. Each path runs where the model has its
  function, as in the JAX package: MLA (``models/mla.py``: ``prefill``,
  ``decode``, ``decode_multi``) has no waves, mixed steps, overlapped
  decode, fused window or speculation, and attends through its own
  gather, never the ragged kernel; an MoE llama runs every llama path but
  the fused windows (whose kernels are dense), each forward's attention
  through the ragged kernel and its experts through ``llama._mlp``'s
  dispatch (``moe_dispatch``, "auto" resolved to "ragged"). Under
  "capacity" every forward also returns its drop counters, which the
  metrics drain in one read (``moe_dropped_total``,
  ``moe_assignments_total``). Neither family's steps are captured as CUDA
  graphs (``StepGraphs`` is off for them): the ragged dispatch reads its
  group sizes on the host each layer, which a capture cannot replay, and
  MLA runs on the gather path, which is never graphed.
- **Observability** (the JAX scheduler's hooks, at the same points of the
  step loop): ``telemetry`` (ttft, tpot, itl, queue_wait and per-phase
  step digests), ``slo`` (the SLO judge of ``slo_ttft_ms`` /
  ``slo_tpot_ms`` over finished requests), ``flight`` (per-phase step
  histograms, the roofline account over the card's peaks, the decode host
  gap, the fused windows and the graph-capture tracker) and, for a request
  whose ``trace`` is set, its lifecycle events on the process tracer
  (``queued``, ``admitted``, ``prefill_chunk``, ``mixed_ride``,
  ``first_token``, ``preempted``, ``resume``, ``deadline_evict``,
  ``disagg_inject``, ``guided_mask``, ``finish``). Step times are host wall
  time (``StepTimer``); no sync is added for them.
- **Keys**: the JAX package's threefry discipline (``engine/prng.py``):
  a step counter folded into ``PRNGKey(rng_seed)`` wherever the JAX
  scheduler folds it, and seeded requests keyed by their own seed and
  token position, so a seeded request draws from the same keys at any
  batch slot and in both packages.

Batch sizes and chunk lengths round up to the JAX package's buckets, which
bound how many tensor shapes the model sees. The engine runs each step on
a worker thread so device-blocked steps never stall the serving plane's
event loop.
"""

from __future__ import annotations

import asyncio
import enum
import logging
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from dynamo_tpu_torch.engine.attention import decode as paged_decode
from dynamo_tpu_torch.engine.attention import megakernel
from dynamo_tpu_torch.engine.config import ModelConfig, resolve_moe_dispatch
from dynamo_tpu_torch.engine.flight_recorder import FlightRecorder, StepCostModel, StepTimer, window_stats
from dynamo_tpu_torch.engine.graphs import HostReads, StepGraphs
from dynamo_tpu_torch.engine.kv_cache import BlockAllocator, KvCacheArrays, KvEvent, OutOfBlocksError, QuantKv
from dynamo_tpu_torch.engine.models import get_module, llama
from dynamo_tpu_torch.engine import prng
from dynamo_tpu_torch.engine.sampling import (
    SamplingParams, apply_penalties, apply_token_masks, compute_logprobs, compute_topk_logprobs,
    guided_sample_batch_logprobs, guided_sample_batch_top_logprobs, make_row_keys, make_window_uniforms,
    pack_param_rows, sample_batch_device, sample_batch_logprobs, sample_batch_top_logprobs,
)
from dynamo_tpu_torch.engine.spec_decode import SpecDecodeStats, spec_verify
from dynamo_tpu_torch.llm.guided.processor import GuidedDecoder, GuidedState
from dynamo_tpu_torch.llm.tokens import extend_block_hashes
from dynamo_tpu_torch.native import get_native
from dynamo_tpu_torch.logits_processing import apply_chain
from dynamo_tpu_torch.runtime.telemetry import SloConfig, SloJudge, Telemetry
from dynamo_tpu_torch.runtime.tracing import get_tracer

logger = logging.getLogger(__name__)


def _has_extras(s: SamplingParams) -> bool:
    """A row whose logits the host edits or reads between tokens: logits
    processors, logprobs, top_logprobs or penalties."""
    return bool(s.logits_processors or s.logprobs or s.top_logprobs or s.has_penalties)


def _tensors(tree):
    """The tensors of a parameter or cache tree (dicts, lists, tuples and
    named tuples such as ``QuantW`` / ``QuantKv``), depth first."""
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)


def next_bucket(n: int, buckets: List[int]) -> int:
    for b in buckets:
        if n <= b:
            return b
    return buckets[-1]


def width_rungs(max_w: int, start: int = 4) -> List[int]:
    """Block-table width rungs up to and including the bucket of ``max_w``:
    pow2 and 1.5·pow2 (4, 6, 8, 12, 16, 24, ...)."""
    rungs: List[int] = []
    w = start
    while True:
        rungs.append(w)
        if w >= max_w:
            return rungs
        nxt = w + w // 2 if w & (w - 1) == 0 else (w // 3) * 4
        w = nxt


def width_bucket(n: int, cap: int) -> int:
    """Smallest pow2-or-1.5·pow2 rung ≥ n, clamped to ``cap``."""
    return min(width_rungs(max(n, 1))[-1], cap)


@dataclass
class StopConditions:
    max_tokens: int = 256
    min_tokens: int = 0
    stop_token_ids: List[int] = field(default_factory=list)
    ignore_eos: bool = False
    # Remaining deadline budget in ms at arrival; past-deadline rows are
    # evicted with finish_reason "timeout" and their KV freed.
    deadline_ms: Optional[float] = None

    @classmethod
    def from_dict(cls, d: Optional[dict]) -> "StopConditions":
        d = d or {}
        dl = d.get("deadline_ms")
        return cls(
            max_tokens=d.get("max_tokens") or 256,
            min_tokens=d.get("min_tokens") or 0,
            stop_token_ids=list(d.get("stop_token_ids") or []),
            ignore_eos=bool(d.get("ignore_eos", False)),
            deadline_ms=float(dl) if dl else None,
        )


class SeqState(enum.Enum):
    WAITING = "waiting"
    PREFILL = "prefill"  # mid chunked-prefill
    RUNNING = "running"
    FINISHED = "finished"


@dataclass
class StepOutput:
    token_id: int
    finished: bool = False
    finish_reason: Optional[str] = None
    logprob: Optional[float] = None
    # First token only: seconds between arrival and engine admission.
    queue_s: Optional[float] = None
    # First token only: prompt tokens whose KV came from the prefix cache.
    cached_tokens: Optional[int] = None
    # OpenAI ``top_logprobs``: [(token_id, logprob), ...], the k most likely
    # tokens at this position (k = sampling.top_logprobs).
    top_logprobs: Optional[list] = None


@dataclass
class Sequence:
    request_id: str
    prompt: List[int]
    sampling: SamplingParams
    stop: StopConditions
    eos_token_ids: List[int] = field(default_factory=list)
    # runtime state
    state: SeqState = SeqState.WAITING
    output_ids: List[int] = field(default_factory=list)
    block_ids: List[int] = field(default_factory=list)
    num_computed: int = 0  # prompt tokens whose KV is in cache
    block_hashes: List[int] = field(default_factory=list)
    num_cached_blocks: int = 0  # prefix blocks reused from cache
    cached_tokens: int = 0  # prompt tokens skipped by the prefix cache
    out_queue: "asyncio.Queue[Optional[StepOutput]]" = field(default_factory=asyncio.Queue)
    arrival_ts: float = field(default_factory=time.monotonic)
    admitted_ts: Optional[float] = None
    first_token_ts: Optional[float] = None
    aborted: bool = False
    abort_reason: str = "cancelled"
    deadline_ts: Optional[float] = None
    # Preemption resume: tokens whose KV must be recomputed (prompt and
    # generated tokens but the last, which re-enters through decode).
    resume_tokens: Optional[List[int]] = None
    preemptions: int = 0
    # Tokens whose KV is in the draft cache (speculative decoding); it lags
    # the target's after non-spec steps and catches up before a spec window.
    d_n: int = 0
    # Guided decoding: the request's token-FSM cursor (llm/guided).
    guided: Optional[GuidedState] = None
    # Disaggregation: a prefill-role request holds its blocks at finish
    # until the decode worker pulls them (take_export); a decode-role one
    # starts from KV another worker prefilled (_inject_prefilled).
    keep_blocks_on_finish: bool = False
    prefilled: Optional[dict] = None
    # Image prompts: feature rows ``[F, D]`` injected at positions [0, F) on
    # every prefill chunk (the prompt's first F ids are placeholders). Such
    # a sequence neither matches nor registers prefix blocks (placeholder
    # ids do not identify the image), rides no wave, mixed step or
    # speculation, and prefills eagerly (the step graphs take no features).
    mm_features: Optional[np.ndarray] = None
    # (trace_id, parent span id) when the request's trace records, else None.
    trace: Optional[tuple] = None
    # A first token's logprob and alternatives, computed where it is drawn
    # (_sample_one) and handed out when it is appended.
    _pending_logprob: Optional[float] = None
    _pending_top_logprobs: Optional[list] = None

    @property
    def all_ids(self) -> List[int]:
        return self.prompt + self.output_ids

    @property
    def total_len(self) -> int:
        return len(self.prompt) + len(self.output_ids)


@dataclass
class SchedulerConfig:
    num_blocks: int = 512
    max_running: int = 32
    prefill_buckets: List[int] = field(default_factory=lambda: [32, 64, 128, 256, 512, 1024, 2048])
    decode_buckets: List[int] = field(default_factory=lambda: [1, 2, 4, 8, 16, 32])
    max_prefill_chunk: int = 2048
    enable_prefix_caching: bool = True
    # Mixed prefill+decode steps: each step with decodes running and prefill
    # waiting carries the decode batch plus up to this many chunk tokens.
    enable_mixed_batching: bool = True
    mixed_prefill_budget: int = 512
    # On OutOfBlocks mid-decode, preempt the newest running sequence instead
    # of finishing the starved one with "length".
    enable_preemption: bool = True
    # Multi-step decode: N decode steps per iteration with on-device token
    # feedback and one host sync (the JAX package's default, 32). 1 = one
    # decode step per iteration. Tokens stream in bursts of up to N.
    num_scheduler_steps: int = 32
    # While requests wait for admission, cap windows at the first rung at
    # or above this (None = full windows), so a new request never waits a
    # whole 32-step window.
    window_waiting_cap: Optional[int] = 8
    # Zero-bubble decode (the JAX package's default): a single-step batch
    # with no per-row host work launches step N+1 from step N's on-device
    # tokens before the host reads them; the host's bookkeeping runs one
    # step behind, beside the device. Composition changes flush back to
    # the sync path.
    enable_overlap_decode: bool = True
    # A prefill-role export nobody pulls within this many seconds is
    # reclaimed (expire_exports), so a dead decode worker pins no blocks.
    export_ttl_s: float = 120.0
    # SLO targets of the engine-side judge (None: the phase is not judged)
    # and the stall watchdog's threshold.
    slo_ttft_ms: Optional[float] = None
    slo_tpot_ms: Optional[float] = None
    stall_after_s: float = 120.0


@dataclass
class ForwardPassMetrics:
    """Worker load snapshot (the JAX package's wire keys this port fills)."""

    num_running: int = 0
    num_waiting: int = 0
    kv_usage: float = 0.0
    kv_total_blocks: int = 0
    kv_active_blocks: int = 0
    prefill_tokens_in_flight: int = 0
    request_total: int = 0
    mixed_steps_total: int = 0
    mixed_prefill_tokens_total: int = 0
    mixed_decode_tokens_total: int = 0
    cached_tokens_total: int = 0
    prefix_hit_blocks_total: int = 0
    prefix_miss_blocks_total: int = 0
    prefix_evicted_blocks_total: int = 0
    overlap_steps_total: int = 0
    overlap_flushes_total: int = 0
    # Prefix blocks onboarded from a KVBM tier (G2/G3/G4) back into G1.
    prefix_onboard_total: int = 0
    # SpecDecodeStats.to_dict() with a draft attached, else None.
    spec_decode: Optional[dict] = None
    # Capacity-dispatch MoE pressure: (token, expert) assignments dropped by
    # the experts' capacity, and all routed live assignments (capacity only).
    moe_dropped_total: int = 0
    moe_assignments_total: int = 0
    # Elastic capacity dial (set_capacity_dial): the live prefill:decode
    # split. fraction 0.5 = the configured budget/slots; the budget/slots
    # gauges carry the APPLIED values so the router's cost model sees the
    # dial, not just its setting.
    elastic_prefill_fraction: float = 0.5
    elastic_prefill_budget: int = 0
    elastic_decode_slots: int = 0
    elastic_dial_changes_total: int = 0

    def to_wire(self) -> dict:
        return self.__dict__.copy()


class Scheduler:
    """Owns the device cache, the parameters and the running/waiting sets.

    Synchronous core (stepped from a thread by TorchEngine); asyncio-facing
    methods only touch queues.
    """

    def __init__(
        self,
        model_config: ModelConfig,
        params,
        scheduler_config: Optional[SchedulerConfig] = None,
        *,
        dtype: torch.dtype = torch.bfloat16,
        device: str = "cuda",
        on_kv_event: Optional[Callable[[KvEvent], None]] = None,
        eos_token_ids: Optional[List[int]] = None,
        rng_seed: int = 0,
    ):
        # The port runs no expert parallelism (ROADMAP item 17): ep = 1.
        model_config = resolve_moe_dispatch(model_config, 1)
        self.mc = model_config
        # The served family's forwards (models/llama.py or models/mla.py).
        self.model = get_module(model_config)
        self.sc = scheduler_config or SchedulerConfig()
        self.device = torch.device(device)
        self.dtype = dtype
        # Block hashes come from the host library: built (or found) here, so
        # a first request never waits for the compiler and a failed build
        # stops the engine before it serves.
        get_native()
        self.allocator = BlockAllocator(self.sc.num_blocks, on_event=on_kv_event)
        # Reserve block 0 as the scratch sink for padded scatter positions.
        self.allocator._free.remove(0)
        self.cache = KvCacheArrays.create(model_config, self.sc.num_blocks, dtype=dtype, device=device)
        self.params = params
        self.max_blocks_per_seq = (model_config.max_seq_len + model_config.block_size - 1) // model_config.block_size
        self.waiting: List[Sequence] = []
        self.running: List[Sequence] = []
        self.by_id: Dict[str, Sequence] = {}
        self.request_total = 0
        self.preempt_total = 0
        self.timeouts_total = 0
        self._has_deadlines = False
        self._eos = eos_token_ids or []
        # Sampling keys: the step counter folded into this key (JAX's).
        self._rng = prng.PRNGKey(rng_seed)
        self._step_counter = 0
        # Model forward passes run (prefill chunks, decode and mixed steps),
        # all of them and by kind.
        self.forward_steps_total = 0
        self.prefill_steps_total = 0
        self.decode_steps_total = 0
        self.cached_tokens_total = 0
        self.cow_blocks_total = 0
        self.mixed_steps_total = 0
        self.mixed_prefill_tokens_total = 0
        self.mixed_decode_tokens_total = 0
        # What the family's module has, as the JAX scheduler checks it: wave
        # admission (several short waiting prompts prefilled in ONE
        # chunk_decode pass; a wave is also a forward and a prefill step),
        # mixed steps and the overlapped pipeline (every family has
        # decode_multi's windows).
        self._supports_chunk_admit = hasattr(self.model, "chunk_decode")
        self._supports_mixed = hasattr(self.model, "mixed_step")
        self._supports_overlap = hasattr(self.model, "decode_sample")
        # Capacity-dispatch MoE returns its drop counters from every forward;
        # they stay on the device until the metrics drain them in one read.
        self._moe_stats = (model_config.architecture == "llama" and model_config.num_experts > 0
                           and model_config.moe_dispatch == "capacity")
        self._stats_kw = {"moe_stats": True} if self._moe_stats else {}
        self._pending_aux: List[tuple] = []
        self._aux_lock = threading.Lock()
        self._moe_dropped_total = 0
        self._moe_assignments_total = 0
        # Elastic capacity dial (set_capacity_dial): the bases are the
        # CONFIGURED split — the dial scales mixed_prefill_budget and the
        # admission slot cap around them, fraction 0.5 = identity. Written
        # from the event loop (the set_dial control op) while the step
        # thread reads the live sc knobs, so the grouped update rides
        # _aux_lock.
        self._base_mixed_prefill_budget = self.sc.mixed_prefill_budget or self.sc.max_prefill_chunk
        self._base_max_running = self.sc.max_running
        self._elastic_fraction = 0.5  # guarded-by: _aux_lock
        self.elastic_dial_changes_total = 0  # guarded-by: _aux_lock
        # First-token latency decomposition: queue (arrival → admission)
        # and prefill (admission → first token) sums over first tokens.
        self.queue_wait_s_total = 0.0
        self.prefill_wait_s_total = 0.0
        self.first_tokens_total = 0
        self.wave_steps_total = 0
        # Decode windows: fused (one kernel launch each; those with a sampled
        # row and those with a guided row also counted apart), non-fused
        # (decode_multi), and the forward steps inside non-fused windows.
        # Windows are not in forward_steps_total. The fused kernel's launches
        # in the last fused window: the scrape's
        # ``fused_window_pallas_launches`` (None before the first).
        self.fused_windows_total = 0
        self.fused_sampled_windows_total = 0
        self.fused_window_pallas_launches: Optional[int] = None
        self.fused_guided_windows_total = 0
        self.multi_windows_total = 0
        self.window_steps_total = 0
        # Fused windows the row-wise fallback ran: a batch's window-eligible
        # rows, while its extras rows took a single step.
        self.rowwise_windows_total = 0
        # Speculative decoding (attach_draft): the draft and its cache, γ,
        # the acceptance stats, whether batches take the fused spec window
        # and its rounds, the spec windows run and the tokens they emitted,
        # the per-round spec rounds run, and the draft's prefill chunks (its
        # catch-up; not in forward_steps_total, nor are spec rounds).
        self.draft_params = None
        self.draft_cfg: Optional[ModelConfig] = None
        self.draft_cache: Optional[KvCacheArrays] = None
        self.spec_gamma = 0
        self.spec_stats = None
        self._use_fused_spec = False
        self._spec_rounds = 0
        self.spec_rounds_total = 0
        self.spec_fused_windows_total = 0
        self.spec_fused_accepted_tokens_total = 0
        self.draft_prefill_steps_total = 0
        # Guided decoding (attach_guided): the grammar compiler and the
        # device mask pools.
        self.guided: Optional[GuidedDecoder] = None
        # Trim buckets to the model's max length.
        self.sc.prefill_buckets = [b for b in self.sc.prefill_buckets if b <= model_config.max_seq_len] or [
            model_config.max_seq_len
        ]
        # MLA attends through its own gather (models/mla.py): no ragged
        # kernel, no flash prefill, as in the JAX package.
        self._attn_impl = "gather"
        if model_config.architecture == "llama":
            llama.warn_attention_impl_degrade(model_config, self.cache.k)
            self._attn_impl = llama.resolve_attention_impl(model_config, self.cache.k)
        # Prefill chunk attention on the per-piece paths: the flash kernel
        # ("auto" ⇒ on a CUDA device only) or one masked softmax.
        self._use_flash_prefill = model_config.architecture == "llama" and (
            model_config.prefill_impl == "flash"
            or (model_config.prefill_impl == "auto" and self.device.type == "cuda")
        )
        # Window rungs: a batch needing few more tokens runs a short window.
        steps = self.sc.num_scheduler_steps
        self._window_rungs = sorted({w for w in (8, 16, steps) if w <= steps})
        # The fused window: multi-step on, the megakernel path, a dense
        # llama (the kernel has no experts; MoE windows run decode_multi,
        # whose attention is still the ragged kernel), and the kernel's own
        # gate (bf16/f32, head dim, batch ≤ 32, a cooperative grid covering
        # the card).
        self._use_fused_window = (
            steps > 1
            and model_config.num_experts == 0
            and self._attn_impl == "megakernel"
            and megakernel.fused_window_fits(
                model_config, batch=self.sc.decode_buckets[-1], dtype=params["embed"].dtype,
                kv_dtype=self.cache.k.dtype, device=self.device,
            )
        )
        # The megakernel path's steps as CUDA graphs (eager on the CPU). The
        # split kernels' arrival counters are sized for the largest step
        # first: a graph keeps the address it captured. Refused for MoE: the
        # ragged dispatch reads its group sizes on the host every layer (a
        # sync no capture can hold), and no replay of the capacity or dense
        # dispatch is shown bit-equal to its eager step yet.
        self._graphs = (StepGraphs(self.device)
                        if self._attn_impl == "megakernel" and model_config.num_experts == 0 else None)
        if self.device.type == "cuda":
            rows = self.sc.decode_buckets[-1]
            megakernel.reserve_counters(self.device, (1 + rows) * model_config.num_kv_heads)
            paged_decode.reserve_counters(self.device, rows * model_config.num_kv_heads)
        self._warm_captures: Optional[int] = None
        self.warmup_stats: Optional[dict] = None
        # The overlapped pipeline: the in-flight step (_pipe), the counters
        # under the JAX package's keys, and the last decode tables upload.
        self._pipe: Optional[dict] = None
        self._reads = HostReads(self.device)
        self._tables_cache: Optional[tuple] = None
        self.overlap_steps_total = 0
        self.overlap_flushes_total = 0
        # KVBM (attach_kvbm) and disaggregation: prefill-role exports
        # awaiting their pull, with their deadlines; the exports parked,
        # taken by a pull and reclaimed past their TTL.
        self.kvbm = None
        self.prefix_onboard_total = 0
        self._pending_exports: Dict[str, Sequence] = {}
        self._export_deadline: Dict[str, float] = {}
        self.exports_total = 0
        self.exports_taken_total = 0
        self.exports_expired_total = 0
        # Observability: latency digests and the SLO judge, the flight
        # recorder (its compile tracker counts graph captures) with the
        # roofline model of the real parameter and cache byte widths, and
        # the process tracer. The ragged and paged kernels read each KV page
        # once; the gather reads, copies and re-reads the prefix.
        self.telemetry = Telemetry()
        self.slo = SloJudge(SloConfig(ttft_ms=self.sc.slo_ttft_ms, tpot_ms=self.sc.slo_tpot_ms))
        self.flight = FlightRecorder(telemetry=self.telemetry, compile_probe=lambda: self.graph_captures_total)
        self.tracer = get_tracer()
        p_leaves = list(_tensors(params))
        kv_bytes = sum(t.numel() * t.element_size() for t in _tensors((self.cache.k, self.cache.v)))
        self.flight.set_cost_model(StepCostModel(
            sum(t.numel() for t in p_leaves), sum(t.numel() * t.element_size() for t in p_leaves),
            kv_bytes / max(self.sc.num_blocks * model_config.block_size, 1),
            kv_read_factor=1.0 if self._attn_impl in ("paged", "megakernel") else 3.0, device=self.device))
        self._last_decode_dispatch_t: Optional[float] = None

    # --- public API (called from event loop) --------------------------------
    def add_request(
        self,
        request_id: str,
        token_ids: List[int],
        sampling: SamplingParams,
        stop: StopConditions,
        *,
        guided=None,
        keep_blocks_on_finish: bool = False,
        prefilled: Optional[dict] = None,
        mm_features: Optional[np.ndarray] = None,
        trace: Optional[tuple] = None,
    ) -> Sequence:
        """``guided``: a grammar spec (llm/guided), or the cursor
        ``self.guided.prepare`` made of one off the step thread.
        ``keep_blocks_on_finish``: a prefill-role request, whose blocks wait
        for ``take_export`` at finish. ``prefilled``: a decode-role request's
        pulled KV (``_inject_prefilled``). ``mm_features``: an image
        prompt's feature rows ``[F, hidden]`` (llm/multimodal.py), at most
        one per prompt token. ``trace``: ``(trace_id, parent span id)`` of a
        request whose trace records (``TorchEngine.generate`` sets it)."""
        if not token_ids:
            raise ValueError("empty prompt")
        if guided is not None and self.guided is None:
            raise ValueError(
                "guided decoding requested but no tokenizer is attached "
                "(Scheduler.attach_guided / TorchEngine.attach_guided_tokenizer)"
            )
        if len(token_ids) >= self.mc.max_seq_len:
            raise ValueError(f"prompt length {len(token_ids)} >= max_seq_len {self.mc.max_seq_len}")
        if mm_features is not None:
            if self.mc.architecture != "llama":
                raise ValueError("multimodal features require the llama prefill path")
            if mm_features.shape[0] > len(token_ids):
                raise ValueError("more multimodal feature rows than prompt tokens")
            mm_features = np.array(mm_features, dtype=np.float32)  # the sequence's own copy
        seq = Sequence(
            request_id=request_id,
            prompt=list(token_ids),
            sampling=sampling,
            stop=stop,
            eos_token_ids=self._eos,
            keep_blocks_on_finish=keep_blocks_on_finish,
            prefilled=prefilled,
            mm_features=mm_features,
            trace=trace,
        )
        if guided is not None:
            seq.guided = self.guided.open(guided)  # ValueError on a bad spec or a full device
        if stop.deadline_ms is not None:
            seq.deadline_ts = seq.arrival_ts + stop.deadline_ms / 1000.0
            self._has_deadlines = True
        self.waiting.append(seq)
        self.by_id[request_id] = seq
        self.request_total += 1
        self._trace_event(seq, "queued", prompt_tokens=len(token_ids))
        if seq.guided is not None:
            self._trace_event(seq, "guided_mask", states=seq.guided.fsm.num_states,
                              compile_s=round(seq.guided.fsm.compile_s, 6), cached=seq.guided.from_cache)
        return seq

    def abort(self, request_id: str) -> None:
        seq = self.by_id.get(request_id)
        if seq is not None and seq.state != SeqState.FINISHED:
            seq.aborted = True

    def has_work(self) -> bool:
        return bool(self.waiting or self.running)

    def metrics(self) -> ForwardPassMetrics:
        a = self.allocator
        return ForwardPassMetrics(
            num_running=len(self.running),
            num_waiting=len(self.waiting),
            kv_usage=a.usage(),
            kv_total_blocks=a.num_blocks,
            kv_active_blocks=a.num_active,
            prefill_tokens_in_flight=sum(len(s.prompt) - s.num_computed for s in self.waiting),
            request_total=self.request_total,
            mixed_steps_total=self.mixed_steps_total,
            mixed_prefill_tokens_total=self.mixed_prefill_tokens_total,
            mixed_decode_tokens_total=self.mixed_decode_tokens_total,
            cached_tokens_total=self.cached_tokens_total,
            prefix_hit_blocks_total=a.hit_blocks_total,
            prefix_miss_blocks_total=a.miss_blocks_total,
            prefix_evicted_blocks_total=a.evicted_blocks_total,
            overlap_steps_total=self.overlap_steps_total,
            overlap_flushes_total=self.overlap_flushes_total,
            prefix_onboard_total=self.prefix_onboard_total,
            spec_decode=self.spec_stats.to_dict() if self.spec_stats else None,
            moe_dropped_total=self.moe_dropped_total,
            moe_assignments_total=self.moe_assignments_total,
            elastic_prefill_fraction=self._elastic_fraction,
            elastic_prefill_budget=self.sc.mixed_prefill_budget or 0,
            elastic_decode_slots=self.sc.max_running,
            elastic_dial_changes_total=self.elastic_dial_changes_total,
        )

    @property
    def moe_dropped_total(self) -> int:
        """Capacity-MoE drop counter, drained on read (the forwards stage
        their device counters; reading each would sync every step)."""
        self._drain_aux()
        return self._moe_dropped_total

    @property
    def moe_assignments_total(self) -> int:
        self._drain_aux()
        return self._moe_assignments_total

    def _fwd(self, name: str, *args, **kw):
        """The served model's forward ``name``. Under capacity MoE it also
        asks for the forward's counters and stages them, and returns the
        rest of the result (the JAX scheduler's ``_consume_aux``)."""
        res = getattr(self.model, name)(*args, **kw, **self._stats_kw)
        if not self._moe_stats:
            return res
        *main, aux = res
        with self._aux_lock:
            self._pending_aux.append((aux["moe_dropped"], aux["moe_assignments"]))
            full = len(self._pending_aux) >= 256
        if full:
            self._drain_aux()
        return tuple(main)

    def _drain_aux(self) -> None:
        """Fold the staged MoE counters into the totals: one device read for
        all of them."""
        with self._aux_lock:
            pend, self._pending_aux = self._pending_aux, []
            if not pend:
                return
            d, a = torch.stack([torch.stack([d, a]) for d, a in pend]).sum(dim=0).tolist()
            self._moe_dropped_total += int(d)
            self._moe_assignments_total += int(a)

    def kv_gauges(self) -> dict:
        """Block-pool utilization for the stats scrape, the JAX scheduler's
        keys: free and cached depth, internal fragmentation (allocated but
        unwritten slots across live sequences) and the prefix-cache hit
        rate."""
        a = self.allocator
        bs = self.mc.block_size
        allocated = 0
        used = 0
        for s in list(self.running) + list(self.waiting):
            nb = len(s.block_ids)
            if not nb:
                continue
            allocated += nb * bs
            used += min(s.total_len, nb * bs)
        hits, misses = a.hit_blocks_total, a.miss_blocks_total
        return {
            "kv_free_blocks": len(a._free),
            "kv_cached_blocks": a.num_cached,
            "kv_fragmentation": round(1.0 - used / allocated, 6) if allocated else 0.0,
            "prefix_hit_rate": round(hits / (hits + misses), 6) if (hits + misses) else 0.0,
        }

    def debug_state(self) -> dict:
        """Live introspection (the JAX scheduler's keys): every sequence with
        its age and progress, the block pool, the latency digests, the SLO
        account and the flight recorder. Read from the event loop while the
        step thread mutates: last-write-wins races are fine for a debug
        dump."""
        now = time.monotonic()

        def seq_info(s: Sequence) -> dict:
            return {
                "request_id": s.request_id,
                "state": s.state.value,
                "age_s": round(now - s.arrival_ts, 3),
                "prompt_tokens": len(s.prompt),
                "output_tokens": len(s.output_ids),
                "computed": s.num_computed,
                "cached_tokens": s.cached_tokens,
                "blocks": len(s.block_ids),
                "preemptions": s.preemptions,
            }

        a = self.allocator
        return {
            "running": [seq_info(s) for s in list(self.running)],
            "waiting": [seq_info(s) for s in list(self.waiting)],
            "block_pool": {
                "total": a.num_blocks,
                "free": len(a._free),
                "cached": a.num_cached,
                "active": a.num_active,
                "usage": round(a.usage(), 6),
                "kv_fragmentation": self.kv_gauges()["kv_fragmentation"],
            },
            "digests": self.telemetry.summary(),
            "slo": self.slo.to_stats(),
            "flight": self.flight.debug_state(now),
        }

    def config_snapshot(self) -> dict:
        """The scheduler knobs and the model/attention identity that
        reproduce the serving behaviour (the JAX scheduler's keys, less the
        parallel layout the port does not have yet)."""
        return {
            "scheduler": {k: v for k, v in vars(self.sc).items() if not k.startswith("_")},
            "model": {
                "name": self.mc.name,
                "architecture": self.mc.architecture,
                "max_seq_len": self.mc.max_seq_len,
                "block_size": self.mc.block_size,
                "kv_cache_dtype": self.mc.kv_cache_dtype,
                "weight_dtype": self.mc.weight_dtype,
                "attention_impl": self._attn_impl,
            },
        }

    def attach_guided(self, tokenizer) -> None:
        """Enable grammar-constrained decoding: grammars lift to token FSMs
        against this tokenizer's vocabulary (llm/guided), their masks and
        next rows in pools on the scheduler's device."""
        self.guided = GuidedDecoder(
            tokenizer,
            eos_ids=self._eos,
            vocab_size=self.mc.vocab_size,
            device=self.device,
        )

    def _fused_guided_ok(self) -> bool:
        """Guided rows may ride the fused window. The JAX gate also charges
        both pools against the TPU kernel's VMEM budget; the Hopper kernel
        reads them from HBM, so the fused window and an attached tokenizer
        are all it needs."""
        return self._use_fused_window and self.guided is not None

    def attach_draft(self, draft_config: ModelConfig, draft_params, *, gamma: int = 4) -> None:
        """Enable speculative decoding: the draft proposes γ tokens a round
        and the target verifies them. The draft's paged cache mirrors the
        target's block tables, so allocation, preemption and the prefix
        cache are shared; it is made in the scheduler's compute dtype, int8
        where ``draft_config.kv_cache_dtype`` says so. Where the fused spec
        window's gate passes (the fused decode window, a bf16/f32 draft of
        the target's dtype that ``megakernel.fused_spec_fits`` takes), a
        batch runs R = ``num_scheduler_steps // (γ+1)`` rounds in one
        launch; elsewhere (one decode step an iteration, the per-piece
        paths, int8 KV or weights, a γ or batch the kernel refuses) it runs
        one round an iteration through ``chunk_decode`` (``_decode_spec``).
        Attach before ``warmup``."""
        if draft_config.block_size != self.mc.block_size:
            raise ValueError("draft and target must share block_size")
        if draft_config.vocab_size != self.mc.vocab_size:
            raise ValueError("draft and target must share the vocabulary")
        if draft_config.architecture != "llama" or self.mc.architecture != "llama":
            raise ValueError("spec decode needs llama-family draft AND target for now")
        if gamma < 1:
            raise ValueError(f"spec_gamma must be at least 1, got {gamma}")
        if self.device.type == "cuda":
            if self._graphs is not None and len(self._graphs):
                raise RuntimeError("attach_draft after graphs were captured: attach the draft before warmup")
            megakernel.reserve_counters(self.device, (1 + self.sc.decode_buckets[-1]) * draft_config.num_kv_heads)
        self.draft_cache = KvCacheArrays.create(draft_config, self.sc.num_blocks, dtype=self.dtype,
                                                device=self.device)
        self.draft_cfg = draft_config
        self.draft_params = draft_params
        self.spec_gamma = gamma
        self.spec_stats = SpecDecodeStats()
        dtype = self.params["embed"].dtype
        # The fused spec window takes no int8 model (an int8 target has no
        # fused window already), as in the JAX package.
        self._use_fused_spec = (
            self._use_fused_window
            and draft_config.num_experts == 0
            and "int8" not in (draft_config.kv_cache_dtype, draft_config.weight_dtype)
            and draft_params["embed"].dtype == dtype
            and megakernel.fused_spec_fits(
                self.mc, draft_config, batch=self.sc.decode_buckets[-1], gamma=gamma, dtype=dtype,
                kv_dtype=self.cache.k.dtype, device=self.device,
            )
        )
        # Each round nets 1..γ+1 tokens, so the fused window's worst-case
        # span stays that of a plain fused window.
        self._spec_rounds = max(1, self.sc.num_scheduler_steps // (gamma + 1)) if self._use_fused_spec else 0

    def window_stats(self) -> dict:
        """The fused windows' keys of the stats scrape, laid out as the JAX
        flight recorder lays them out."""
        return window_stats(self.fused_windows_total, self.fused_sampled_windows_total,
                            self.fused_window_pallas_launches, self.spec_fused_windows_total,
                            self.spec_fused_accepted_tokens_total)

    def _window_launches(self) -> int:
        """The fused decode window wrapper's count that proves a launch: on
        the card its kernel's launches alone (a window the plain version ran
        reads 0), on the CPU its plain calls, the CPU's route."""
        if self.device.type == "cuda":
            return megakernel.WINDOW_KERNEL_LAUNCHES
        return megakernel.WINDOW_REF_CALLS

    # --- CUDA graphs --------------------------------------------------------
    @property
    def graph_captures_total(self) -> int:
        return self._graphs.captures_total if self._graphs is not None else 0

    @property
    def graph_captures_after_warmup(self) -> Optional[int]:
        """Graphs captured since ``warmup`` returned (None before a warmup)."""
        return None if self._warm_captures is None else self.graph_captures_total - self._warm_captures

    def close(self) -> None:
        """Destroy the step graphs now, once no step runs (``TorchEngine.stop``).
        Left to the garbage collector, a stopped scheduler's hundreds of
        graph executables and their pool are freed whenever it reaches the
        scheduler's reference cycles: in another engine's steps, if the
        process builds one, stalling them while the device syncs. The
        counters stay readable."""
        if self._graphs is not None:
            self._graphs.close()

    # --- elastic capacity dial ----------------------------------------------
    def set_capacity_dial(self, prefill_fraction: float) -> dict:
        """Live prefill:decode capacity split, the JAX scheduler's rule.
        ``prefill_fraction`` ∈ [0, 1] (clamped):

        - 0.5 — the configured identity (mixed_prefill_budget / max_running
          exactly as constructed);
        - → 1.0 — prefill-heavy: the mixed-step chunk budget scales up to
          2× (clamped to max_prefill_chunk) while decode admission slots
          shrink toward 1;
        - → 0.0 — decode-heavy: admission slots stay at the configured cap
          while the chunk budget shrinks toward one block.

        Slots never exceed the configured max_running (the KV cache, the
        decode buckets and the split counters are sized for it), and rows
        admitted past a shrunken cap drain naturally. Thread-safe: the
        grouped update rides _aux_lock, so a stats scrape never reads a
        half-applied dial. Returns the applied values."""
        f = min(1.0, max(0.0, float(prefill_fraction)))
        raw = int(round(2.0 * f * self._base_mixed_prefill_budget))
        budget = max(self.mc.block_size, min(raw, self.sc.max_prefill_chunk))
        slots = int(round(2.0 * (1.0 - f) * self._base_max_running))
        slots = max(1, min(self._base_max_running, slots))
        with self._aux_lock:
            self._elastic_fraction = f
            self.sc.mixed_prefill_budget = budget
            self.sc.max_running = slots
            self.elastic_dial_changes_total += 1
        logger.info("capacity dial: prefill_fraction=%.3f → mixed_prefill_budget=%d decode_slots=%d",
                    f, budget, slots)
        return {"prefill_fraction": f, "mixed_prefill_budget": budget, "decode_slots": slots}

    def _mixed_warm_buckets(self) -> List[int]:
        """Prefill-chunk buckets a mixed step can ride across the capacity
        dial's whole range: budgets span [block_size, min(2 · base,
        max_prefill_chunk)] and chunks bucket up (next_bucket), so warmup
        covers every bucket between those bounds — a dial change never
        captures a graph mid-traffic."""
        eligible = [b for b in self.sc.prefill_buckets if b <= self.sc.max_prefill_chunk]
        if not eligible:
            eligible = [self.sc.prefill_buckets[0]]
        lo = next_bucket(max(self.mc.block_size, 1), eligible)
        hi = next_bucket(min(2 * self._base_mixed_prefill_budget, self.sc.max_prefill_chunk), eligible)
        return [b for b in eligible if lo <= b <= hi] or [eligible[0]]

    def warmup(self, ctx_tokens: int = 2048) -> int:
        """Capture the serving-hot graphs before traffic, so a request never
        waits for a capture: the key space the JAX package's warmup
        compiles. Decode and overlapped decode (every batch bucket × table
        width up to ``ctx_tokens``), ``decode_multi`` steps when the fused
        window is off (int8), the draw per bucket (the overlapped steps,
        the windows and the draws each greedy and sampled), prefill chunks per bucket
        at every table width they can pair with, waves (every batch bucket
        ≥ 2 × every chunk bucket × the widths a wave of that bucket can
        have, up to ``ctx_tokens``), mixed steps (``_mixed_warm_buckets`` ×
        batch buckets × widths) and, with a draft that speculates per
        round, the round's draft chunk, draft window and target verify at
        every batch bucket × width. Captures run
        with every row inactive and zero inputs, so writes land in the
        scratch block 0 and the cache is untouched. Returns the number of
        graphs captured; 0 on the per-piece paths, which run eagerly.
        ``warmup_stats`` keeps its wall seconds, the graphs and the bytes
        the card's allocator reserved meanwhile (the graphs' pool)."""
        g = self._graphs
        if g is None:
            self._warm_captures = 0
            return 0
        n0 = len(g)
        t0 = time.perf_counter()
        reserved0 = torch.cuda.memory_reserved(self.device) if g.on_card else 0
        bs, maxb, V = self.mc.block_size, self.max_blocks_per_seq, self.mc.vocab_size
        max_w = self._width_bucket((ctx_tokens + bs - 1) // bs)
        widths = sorted(set(min(r, maxb) for r in width_rungs(max_w)))
        model = (self.params, self.mc, self.cache)

        def z(*shape, dtype=np.int32):
            return np.zeros(shape, dtype=dtype)

        for B in sorted(set(self.sc.decode_buckets) | {1}):
            samp = (z(B, dtype=np.float32), z(B), np.ones((B,), np.float32))
            # Each draw in its greedy form (no key) and its sampled one.
            for key in (None, z(2, dtype=np.uint32)):
                if B in self.sc.decode_buckets:
                    for W in widths:
                        if key is None:
                            g.decode(*model, z(3, B), z(B, W), capture_only=True)
                        if self.sc.enable_overlap_decode:
                            g.decode_sample(*model, z(3, B), z(B, W), *samp, key, capture_only=True)
                        if self.sc.num_scheduler_steps > 1 and not self._use_fused_window:
                            for steps in self._window_rungs:
                                keys = None if key is None else z(steps, 2, dtype=np.uint32)
                                g.decode_multi(*model, z(3, B), z(B, W), *samp, keys, steps, capture_only=True)
                g.draw(g.rows_logits(B, V), *samp, key, capture_only=True)
            g.draw(g.rows_logits(B, V), *samp, None, z(B, 2, dtype=np.uint32), capture_only=True)
        prev = 0
        waves = self._supports_chunk_admit and self.draft_params is None
        wave_hi_w = width_bucket((self._wave_s_cap() + 1 + bs - 1) // bs, maxb)
        wave_keys = []
        for S in self.sc.prefill_buckets:
            if S > self.sc.max_prefill_chunk:
                continue
            # From the narrowest table a chunk of this bucket comes with (the
            # shortest prompt that maps here) to the widest within ctx_tokens.
            min_w = max(16, width_bucket((prev + 1 + bs - 1) // bs, maxb))
            # A wave's tables: from the shortest fresh prompt chunking here
            # (and its next token's slot; rung floor 4) to the longest
            # wave-eligible prompt's, within ctx_tokens.
            wave_lo = width_bucket((prev + 2 + bs - 1) // bs, maxb)
            prev = S
            for W in sorted(set(min(r, maxb) for r in width_rungs(max(max_w, min_w)) if r >= min_w)):
                g.prefill("target", *model, z(S), 0, 0, z(W), capture_only=True)
                if self.draft_params is not None:
                    g.prefill("draft", self.draft_params, self.draft_cfg, self.draft_cache, z(S), 0, 0, z(W),
                              capture_only=True)
            if waves:
                wave_hi = min(max(max_w, wave_lo), wave_hi_w)
                wave_keys += [(B, S, W) for B in self.sc.decode_buckets if B >= 2
                              for W in set(min(r, maxb) for r in width_rungs(wave_hi)) if wave_lo <= W <= wave_hi]
        # Smallest first: each larger wave's capture reuses the pool's
        # segments the smaller ones left (largest first, the one 32 × 2048
        # capture alone reserved 17.8 GB on an H100, against 11.0 GB for
        # all of them in this order).
        for B, S, W in sorted(wave_keys, key=lambda k: (k[0] * k[1], k[2])):
            g.wave(*model, z(B, S), z(B), z(B), z(B, W), capture_only=True)
        if self.sc.enable_mixed_batching and self.draft_params is None:
            m_widths = sorted(set(min(max(16, W), maxb) for W in widths))
            for S in self._mixed_warm_buckets():
                for B in self.sc.decode_buckets:
                    for W in m_widths:
                        g.mixed(*model, z(S), 0, 0, z(W), z(3, B), z(B, W), capture_only=True)
        if self.draft_params is not None and not self._use_fused_spec:
            # The per-round spec round's passes at every batch bucket and
            # width, each draw greedy and sampled.
            gamma, S = self.spec_gamma, self.spec_gamma + 1
            draft = (self.draft_params, self.draft_cfg, self.draft_cache)
            for B in self.sc.decode_buckets:
                samp = (z(B, dtype=np.float32), z(B), np.ones((B,), np.float32))
                for W in widths:
                    chunk = (z(B, S), z(B), z(B), z(B, W))
                    for key in (None, z(2, dtype=np.uint32)):
                        g.spec_draft(*draft, *chunk, *samp, key, gamma, capture_only=True)
                        if gamma > 1:
                            keys = None if key is None else z(gamma - 1, 2, dtype=np.uint32)
                            g.decode_multi(*draft, z(3, B), z(B, W), *samp, keys, gamma - 1, model="draft",
                                           return_logits=True, capture_only=True)
                    g.spec_target(*model, *chunk, gamma, capture_only=True)
        if g.on_card:
            torch.cuda.synchronize(self.device)
        self._warm_captures = g.captures_total
        self.warmup_stats = {
            "ctx_tokens": ctx_tokens, "graphs": len(g) - n0, "seconds": time.perf_counter() - t0,
            "reserved_bytes": torch.cuda.memory_reserved(self.device) - reserved0 if g.on_card else None,
        }
        return len(g) - n0

    # --- step loop core (runs in worker thread) -----------------------------
    def step(self) -> List[tuple]:
        """One scheduler iteration. Returns [(seq, StepOutput), ...].

        With sequences decoding AND prefill work at the head of the queue,
        the iteration is a MIXED step. Otherwise the phase-separated order
        runs: decode first (ITL), then admit one prefill chunk (TTFT).

        With an overlapped decode step in flight (``_pipe``), the iteration
        instead launches step N+1 from step N's on-device tokens and retires
        step N while the device runs, unless a composition change (waiting
        work, an abort, block growth, a finish) flushes it back to this
        sync path."""
        outputs: List[tuple] = []
        # The deadline sweep runs before the overlap path too: an expired row
        # marks itself aborted, which flushes the pipeline below.
        self._sweep_deadlines()
        if self._pipe is not None:
            if self._overlap_should_continue():
                self._overlap_step(outputs)
                return outputs
            self._overlap_flush(outputs)
        self._reap_aborted(outputs)
        cand = self._mixed_candidate()
        if cand is not None and not self._wave_preferred() and self._mixed_step(cand, outputs):
            return outputs
        if self.running:
            outputs.extend(self._decode_step())
        self._admit(outputs)
        return outputs

    def _mixed_candidate(self) -> Optional[Sequence]:
        """Head-of-queue sequence eligible to ride a mixed step, or None.
        Only the head is considered (FIFO); a full decode set keeps a
        not-yet-admitted head out, and a remotely prefilled or image head
        takes the phase-separated path."""
        if not (self.sc.enable_mixed_batching and self._supports_mixed and self.draft_params is None
                and self.running and self.waiting):
            return None
        head = self.waiting[0]
        if head.aborted or head.prefilled is not None or head.mm_features is not None:
            return None
        if head.state == SeqState.WAITING and len(self.running) >= self.sc.max_running:
            return None
        return head

    def _wave_preferred(self) -> bool:
        """A wave admission rather than a mixed step: at least two short
        wave-eligible prompts wait, the head among them, each within the
        mixed budget, so the wave's stall is no worse than the chunk a
        mixed step would carry. A long-prompt head takes the mixed path."""
        if not self._supports_chunk_admit or self.draft_params is not None:
            return False
        cap = min(self._wave_s_cap(), self.sc.mixed_prefill_budget or self._wave_s_cap())
        if self.sc.max_running - len(self.running) < 2:
            return False
        head = self.waiting[0]
        if not (self._wave_eligible(head) and len(head.prompt) <= cap):
            return False
        n = sum(1 for seq in self.waiting[: self.sc.decode_buckets[-1]]
                if self._wave_eligible(seq) and len(seq.prompt) <= cap)
        return n >= 2

    def _mixed_step(self, seq: Sequence, outputs: List[tuple]) -> bool:
        """One mixed iteration: the decode batch plus ``seq``'s next prefill
        chunk in ONE forward pass. Returns False (caller falls back to the
        phase-separated path) when the chunk's blocks can't be allocated."""
        resuming = seq.resume_tokens is not None
        pf_tokens = seq.resume_tokens if resuming else seq.prompt
        if seq.state == SeqState.WAITING:
            total_tokens = (seq.total_len if resuming else len(seq.prompt)) + 1
            try:
                self._first_touch(seq, pf_tokens, total_tokens)
            except OutOfBlocksError:
                return False
        if seq.num_computed >= len(pf_tokens):
            # Prefix-cache hit covered the whole chunkable range already.
            return False

        remaining = len(pf_tokens) - seq.num_computed
        budget = self.sc.max_prefill_chunk
        if self.sc.mixed_prefill_budget:
            budget = min(budget, self.sc.mixed_prefill_budget)
        chunk = min(remaining, budget)
        s_bucket = next_bucket(chunk, self.sc.prefill_buckets)
        chunk = min(chunk, s_bucket)
        chunk_tokens = pf_tokens[seq.num_computed : seq.num_computed + chunk]
        p_tok = np.zeros((s_bucket,), dtype=np.int32)
        p_tok[: len(chunk_tokens)] = chunk_tokens
        p_table = self._prefill_table(seq)

        # Decode batch formation — identical to _decode_step.
        n = min(len(self.running), self.sc.decode_buckets[-1])
        batch = self.running[:n]
        d_bucket = next_bucket(n, self.sc.decode_buckets)
        width = self._width_bucket(max(len(s.block_ids) for s in batch))
        self._break_decode_gap()
        with StepTimer() as timer:
            if self._graphs is not None:
                # One width for the chunk's table and the decode tables: the
                # graph keys on (S, B, W).
                width = max(width, len(p_table))
                tpa, tables = self._decode_host(batch, d_bucket, width)
                chunk_logits, d_logits = self._graphs.mixed(
                    self.params, self.mc, self.cache, p_tok, len(chunk_tokens), seq.num_computed,
                    np.pad(p_table, (0, width - len(p_table))), tpa, tables,
                )
                chunk_logits = chunk_logits[0]
            else:
                tpa, _ = self._decode_host(batch, d_bucket, width)
                tpa_d = self._dev(tpa)
                logits, _, _ = self._fwd(
                    "mixed_step", self.params, self.mc, self.cache.k, self.cache.v,
                    self._dev(p_tok), len(chunk_tokens), seq.num_computed, self._dev(p_table),
                    tpa_d[0], tpa_d[1], self._decode_tables(batch, d_bucket, width),
                    tpa_d[2].bool(), use_flash=self._use_flash_prefill, has_prefix=seq.num_computed > 0,
                )
                chunk_logits, d_logits = logits[0], logits[1:]
            self.forward_steps_total += 1
            self.mixed_steps_total += 1
            self.mixed_prefill_tokens_total += len(chunk_tokens)
            self.mixed_decode_tokens_total += n

            # Decode rows first (output-order parity with the phase-separated
            # decode-then-admit iteration), then the chunk's progress.
            self._finish_decode_rows(batch, d_bucket, d_logits, outputs)
        # The mixed step's roofline splits: the chunk's FLOPs/bytes go to the
        # prefill bucket and the decode rows' to decode.
        self.flight.record_mixed_step(timer.dur, len(chunk_tokens), n, kv_read_prefill=seq.num_computed,
                                      kv_read_decode=sum(s.total_len for s in batch))
        self.telemetry.observe("itl", timer.dur)
        self._trace_event(seq, "mixed_ride", chunk_tokens=len(chunk_tokens), decode_rows=n,
                          dur_s=round(timer.dur, 6))
        seq.num_computed += len(chunk_tokens)
        self._register_full_blocks(seq)  # chunk's completed blocks go live
        if seq.num_computed < len(pf_tokens):
            return True  # more chunks ride later steps
        self.waiting.remove(seq)
        seq.state = SeqState.RUNNING
        self.running.append(seq)
        self._register_full_blocks(seq)
        if resuming:
            # KV restored through the last generated token; the final token
            # re-enters via decode — nothing to sample or emit.
            seq.resume_tokens = None
        else:
            token = self._sample_one(seq, chunk_logits)
            self._append_token(seq, token, outputs)
        return True

    def _reap_aborted(self, outputs: List[tuple]) -> None:
        for seq in list(self.running):
            if seq.aborted:
                self._finish(seq, seq.abort_reason, outputs)
        for seq in list(self.waiting):
            if seq.aborted:
                self.waiting.remove(seq)
                seq.state = SeqState.FINISHED
                # Mid-prefill cancellations already hold blocks — release them.
                self.allocator.release(seq.block_ids)
                seq.block_ids = []
                self._close_guided(seq)
                self.by_id.pop(seq.request_id, None)
                outputs.append((seq, StepOutput(token_id=-1, finished=True, finish_reason=seq.abort_reason)))

    def _sweep_deadlines(self) -> None:
        """Mark past-deadline rows aborted with reason "timeout"; the regular
        reap then frees their KV and emits the final frame."""
        if not self._has_deadlines:
            return
        now = time.monotonic()
        for seq in self.running + self.waiting:
            if seq.deadline_ts is not None and not seq.aborted and now >= seq.deadline_ts:
                seq.aborted = True
                seq.abort_reason = "timeout"
                self.timeouts_total += 1
                self._trace_event(seq, "deadline_evict", overrun_ms=round((now - seq.deadline_ts) * 1000.0, 3),
                                  output_tokens=len(seq.output_ids))

    def _admit(self, outputs: List[tuple]) -> None:
        """Admit waiting sequences: a wave when several short prompts wait
        and the head is one of them (FIFO: an ineligible or long head never
        starves behind waves), else one chunked prefill of the head."""
        if not self.waiting or len(self.running) >= self.sc.max_running:
            return
        head = self.waiting[0]
        if self._wave_eligible(head) and len(head.prompt) <= self._wave_s_cap() and self._admit_wave(outputs):
            return
        seq = self.waiting[0]
        try:
            done = self._prefill_one(seq, outputs)
        except OutOfBlocksError:
            # Not enough KV blocks — leave in queue; decode progress will
            # free/evict blocks.
            return
        if done:
            self.waiting.pop(0)

    def _wave_s_cap(self) -> int:
        """Longest prompt a wave admission takes in its one chunk."""
        return min(self.sc.max_prefill_chunk, self.sc.prefill_buckets[-1])

    def _wave_eligible(self, seq: Sequence) -> bool:
        """Rows a wave can admit: new requests (no preemption resume) whose
        first token the wave's one draw can take (no grammar mask, no
        logprobs, no processors, no per-request key) and that carry no
        image features. Penalties do not matter: a first token has no
        history."""
        s = seq.sampling
        return (seq.state == SeqState.WAITING and seq.prefilled is None and seq.resume_tokens is None
                and seq.mm_features is None and seq.guided is None
                and not s.logprobs and not s.top_logprobs and not s.logits_processors
                and not (s.seed is not None and s.temperature > 0))

    def _admit_wave(self, outputs: List[tuple]) -> bool:
        """Prefill a wave of short waiting prompts in ONE ``chunk_decode``
        pass (each row's whole uncached prompt, its KV written, each row's
        last logits drawn from in one draw) and read back one ``[B]`` token
        array. Returns False (the caller prefills the head alone) when
        fewer than two rows are eligible or can allocate, or a draft is
        attached (its catch-up is per sequence)."""
        if not self._supports_chunk_admit or self.draft_params is not None:
            return False
        s_cap = self._wave_s_cap()
        cap = min(self.sc.max_running - len(self.running), self.sc.decode_buckets[-1])
        wave: List[Sequence] = []
        for seq in self.waiting:
            if len(wave) >= cap:
                break
            if self._wave_eligible(seq) and len(seq.prompt) <= s_cap:
                wave.append(seq)
        if len(wave) < 2:
            return False
        # First touch per row, all-or-nothing each; a row that cannot
        # allocate ends the wave.
        admitted: List[Sequence] = []
        for seq in wave:
            try:
                self._first_touch(seq, seq.prompt, len(seq.prompt) + 1)
            except OutOfBlocksError:
                break
            admitted.append(seq)
        if len(admitted) < 2:
            # Hand the blocks back: the single-sequence path touches again.
            for seq in admitted:
                self.allocator.release(seq.block_ids)
                self.cached_tokens_total -= seq.cached_tokens
                seq.block_ids = []
                seq.num_cached_blocks = seq.num_computed = seq.cached_tokens = 0
                seq.admitted_ts = None
                seq.state = SeqState.WAITING
            return False
        s_bucket = next_bucket(max(len(seq.prompt) - seq.num_computed for seq in admitted), self.sc.prefill_buckets)
        b_bucket = next_bucket(len(admitted), self.sc.decode_buckets)
        width = self._width_bucket(max(len(seq.block_ids) for seq in admitted))
        tokens = np.zeros((b_bucket, s_bucket), dtype=np.int32)
        pos0 = np.zeros((b_bucket,), dtype=np.int32)
        valid = np.zeros((b_bucket,), dtype=np.int32)
        tables = np.zeros((b_bucket, width), dtype=np.int32)
        for i, seq in enumerate(admitted):
            chunk = seq.prompt[seq.num_computed:]
            tokens[i, : len(chunk)] = chunk
            pos0[i] = seq.num_computed
            valid[i] = len(chunk)
            tables[i, : len(seq.block_ids)] = seq.block_ids
        self._break_decode_gap()
        with StepTimer() as timer:
            if self._graphs is not None:
                logits = self._graphs.wave(self.params, self.mc, self.cache, tokens, pos0, valid, tables)
            else:
                logits, _, _ = self._fwd("chunk_decode", self.params, self.mc, self.cache.k, self.cache.v,
                                         *map(self._dev, (tokens, pos0, valid, tables)), last_logits=True)
            sampled = self._draw(logits, admitted, b_bucket, self._next_key())[0]  # the wave's one host sync
            self.wave_steps_total += 1
            self.forward_steps_total += 1
            self.prefill_steps_total += 1
            for i, seq in enumerate(admitted):
                self.waiting.remove(seq)
                seq.num_computed = len(seq.prompt)
                seq.state = SeqState.RUNNING
                self.running.append(seq)
                self._register_full_blocks(seq)
                self._append_token(seq, int(sampled[i]), outputs)
        self.flight.record_step("wave", timer.dur, int(valid.sum()) + len(admitted), kv_read_tokens=int(pos0.sum()))
        return True

    def _first_touch(self, seq: Sequence, pf_tokens: List[int], total_tokens: int) -> None:
        """First admission: prefix-cache match + full block allocation,
        all-or-nothing — any acquired refs/blocks are returned before
        OutOfBlocksError propagates."""
        bs = self.mc.block_size
        try:
            if self.sc.enable_prefix_caching and seq.mm_features is None:
                seq.block_hashes = extend_block_hashes([], pf_tokens, bs)
                matched = self._match_prefix_tiers(seq)
                # At least one token must prefill so logits exist. A FULL
                # cover keeps every matched block and recomputes only the
                # last token, whose KV write lands in the final matched
                # block: copy it on write when another sequence holds it.
                if matched and len(matched) * bs >= len(pf_tokens):
                    last = matched[-1]
                    if self.allocator.ref_count(last) > 1:
                        try:
                            (cow,) = self.allocator.allocate(1)
                        except OutOfBlocksError:
                            # No room for the private copy: recompute the
                            # whole last block (still an n-1 block hit).
                            self.allocator.release([last])
                            matched = matched[:-1]
                        else:
                            self._copy_block(last, cow)
                            self.allocator.release([last])
                            matched[-1] = cow
                            self.cow_blocks_total += 1
                seq.block_ids = list(matched)
                seq.num_cached_blocks = len(matched)
                seq.num_computed = min(len(matched) * bs, len(pf_tokens) - 1)
                seq.cached_tokens = seq.num_computed
                self.cached_tokens_total += seq.cached_tokens
            needed = (total_tokens + bs - 1) // bs - len(seq.block_ids)
            if needed > 0:
                seq.block_ids.extend(self.allocator.allocate(needed))
        except OutOfBlocksError:
            self.allocator.release(seq.block_ids)
            self.cached_tokens_total -= seq.cached_tokens
            seq.block_ids = []
            seq.num_cached_blocks = 0
            seq.num_computed = 0
            seq.cached_tokens = 0
            raise
        seq.state = SeqState.PREFILL
        if seq.admitted_ts is None:
            seq.admitted_ts = time.monotonic()
            self._trace_event(seq, "admitted", queue_s=round(seq.admitted_ts - seq.arrival_ts, 6),
                              cached_blocks=seq.num_cached_blocks)

    def _prefill_one(self, seq: Sequence, outputs: List[tuple]) -> bool:
        """Run one prefill chunk for ``seq``. Returns True when the prompt is
        fully computed (sequence moved to running). Preempted sequences
        resume here: ``resume_tokens`` recompute their KV, then decode
        continues — no sampling at the end of a resume."""
        # Inject only at first admission: a preempted decode-role sequence
        # (resume_tokens set) recomputes; re-injecting would repeat its first
        # token and leave its generated tokens' KV out.
        if seq.state == SeqState.WAITING and seq.prefilled is not None and seq.resume_tokens is None:
            return self._inject_prefilled(seq, outputs)
        resuming = seq.resume_tokens is not None
        pf_tokens = seq.resume_tokens if resuming else seq.prompt
        if seq.state == SeqState.WAITING:
            total_tokens = (seq.total_len if resuming else len(seq.prompt)) + 1
            self._first_touch(seq, pf_tokens, total_tokens)

        remaining = len(pf_tokens) - seq.num_computed
        chunk = min(remaining, self.sc.max_prefill_chunk)
        bucket = next_bucket(chunk, self.sc.prefill_buckets)
        chunk = min(chunk, bucket)
        tokens = pf_tokens[seq.num_computed : seq.num_computed + chunk]
        padded = np.zeros((bucket,), dtype=np.int32)
        padded[: len(tokens)] = tokens
        self._break_decode_gap()
        with StepTimer() as timer:
            logits = self._prefill(seq, "target", padded, len(tokens), seq.num_computed)
        self.forward_steps_total += 1
        self.prefill_steps_total += 1
        self.flight.record_step("prefill", timer.dur, len(tokens), kv_read_tokens=seq.num_computed)
        self._trace_event(seq, "prefill_chunk", tokens=len(tokens), bucket=bucket,
                          computed=seq.num_computed + len(tokens), dur_s=round(timer.dur, 6), resume=resuming)
        seq.num_computed += len(tokens)
        self._register_full_blocks(seq)  # chunk's completed blocks go live
        self._draft_catchup(seq, pf_tokens, seq.num_computed)

        if seq.num_computed < len(pf_tokens):
            return False  # more chunks to go
        seq.state = SeqState.RUNNING
        self.running.append(seq)
        self._register_full_blocks(seq)
        if resuming:
            seq.resume_tokens = None
            self._trace_event(seq, "resume", total_len=seq.total_len)
            return True
        token = self._sample_one(seq, logits)
        self._append_token(seq, token, outputs)
        return True

    def _draft_catchup(self, seq: Sequence, tokens: List[int], upto: int) -> None:
        """Draft KV for positions ``seq.d_n .. upto-1`` of ``tokens``, in
        prefill chunks: it mirrors each prompt chunk (the draft computes the
        whole prompt, whatever the target's prefix-cache hit) and absorbs the
        lag left by non-spec decode steps. An image sequence never
        speculates (the draft has no vision path), so it has no draft KV."""
        if self.draft_params is None or seq.mm_features is not None:
            return
        while seq.d_n < upto:
            start = seq.d_n
            chunk = min(upto - start, self.sc.max_prefill_chunk)
            bucket = next_bucket(chunk, self.sc.prefill_buckets)
            chunk = min(chunk, bucket)
            padded = np.zeros((bucket,), dtype=np.int32)
            padded[:chunk] = tokens[start:start + chunk]
            self._prefill(seq, "draft", padded, chunk, start)
            seq.d_n += chunk
            self.draft_prefill_steps_total += 1

    def _width_bucket(self, max_used: int) -> int:
        """Block-table width buckets at pow2 AND 1.5·pow2 rungs."""
        return width_bucket(max_used, self.max_blocks_per_seq)

    def _dev(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a).to(self.device)

    def _prefill(self, seq: Sequence, model: str, padded: np.ndarray, valid: int, start: int) -> torch.Tensor:
        """One prefill chunk of ``seq`` through the target (or the draft)
        model → its last row's logits ``[V]``: a graph replay on the
        megakernel path, else the family's ``prefill`` (the draft is a
        llama); an image sequence's chunk carries its features, eagerly."""
        params, cfg, cache = ((self.params, self.mc, self.cache) if model == "target"
                              else (self.draft_params, self.draft_cfg, self.draft_cache))
        table = self._prefill_table(seq)
        if seq.mm_features is not None:
            # Image rows at positions [0, F), on every chunk: eagerly, as the
            # graphs take no per-request features.
            feats = torch.from_numpy(seq.mm_features).to(self.device)
            return self._fwd("prefill", params, cfg, cache.k, cache.v, self._dev(padded), valid, start,
                             self._dev(table), use_flash=self._use_flash_prefill, has_prefix=start > 0,
                             mm_feats=feats, mm_len=feats.shape[0])[0]
        if self._graphs is not None:
            return self._graphs.prefill(model, params, cfg, cache, padded, valid, start, table)[0]
        args = (params, cfg, cache.k, cache.v, self._dev(padded), valid, start, self._dev(table))
        if model == "draft":
            return llama.prefill(*args, has_prefix=start > 0)[0]
        if self.mc.architecture == "llama":
            return self._fwd("prefill", *args, use_flash=self._use_flash_prefill, has_prefix=start > 0)[0]
        return self._fwd("prefill", *args)[0]

    def _decode_host(self, batch: List[Sequence], bucket: int, width: int) -> tuple:
        """``(tpa [3, bucket], tables [bucket, width])`` int32 numpy of a
        decode batch: each row's last token and its write slot, the active
        lanes, and the block tables."""
        tpa = np.zeros((3, bucket), dtype=np.int32)
        tables = np.zeros((bucket, width), dtype=np.int32)
        for i, seq in enumerate(batch):
            tpa[:, i] = (seq.all_ids[-1], seq.total_len - 1, 1)
            tables[i, : len(seq.block_ids)] = seq.block_ids
        return tpa, tables

    def _decode_tables(self, batch: List[Sequence], bucket: int, width: int) -> torch.Tensor:
        """Decode block tables as a device tensor, uploaded again only when
        a table changed (the JAX package's cache: tables are append-only
        between composition changes)."""
        key = (bucket, width, tuple(s.request_id for s in batch))
        blocks = tuple(tuple(s.block_ids) for s in batch)
        if self._tables_cache is not None:
            ckey, cblocks, dev = self._tables_cache
            if ckey == key and cblocks == blocks:
                return dev
        dev = self._dev(self._decode_host(batch, bucket, width)[1])
        self._tables_cache = (key, blocks, dev)
        return dev

    def _prefill_table(self, seq: Sequence) -> np.ndarray:
        """Prefill block table bucketed to a rung width covering the
        sequence's blocks — not padded to max_blocks_per_seq."""
        w = max(16, width_bucket(len(seq.block_ids), self.max_blocks_per_seq))
        table = np.zeros((w,), dtype=np.int32)
        table[: len(seq.block_ids)] = seq.block_ids
        return table

    def _decode_step(self) -> List[tuple]:
        outputs: List[tuple] = []
        # Batch size caps at the largest decode bucket; over-cap rows wait.
        n = min(len(self.running), self.sc.decode_buckets[-1])
        batch = self.running[:n]
        bucket = next_bucket(n, self.sc.decode_buckets)
        # With a draft attached the batch speculates, unless a row carries
        # extras (processors, logprobs, penalties), is guided (the draft's
        # proposals ignore the FSM mask), carries image features (no vision
        # path in the draft) or is seeded and sampled (a spec round keys its
        # draws per batch, not per request): the fused spec window
        # first, then one per-round spec round; where the blocks cannot be
        # reserved, the non-spec path below.
        if self.draft_params is not None and not any(
            _has_extras(s.sampling) or s.guided is not None or s.mm_features is not None
            or (s.sampling.seed is not None and s.sampling.temperature > 0) for s in batch
        ):
            if self._use_fused_spec and self._decode_spec_fused(batch, bucket, outputs):
                return outputs
            if self._decode_spec(batch, bucket, outputs):
                return outputs
        if self.sc.num_scheduler_steps > 1:
            # A row rides a window unless it needs the host between tokens:
            # extras rows never; a guided row only the fused window, which
            # masks and advances it on the device, and a seeded sampled row
            # only the fused window too, whose uniforms honour its seed
            # (decode_multi threads one key for the batch and no FSM).
            fused_w = self._use_fused_window
            guided_ok = self._fused_guided_ok()

            def window_ok(s: Sequence) -> bool:
                if _has_extras(s.sampling):
                    return False
                if s.guided is not None:
                    return guided_ok
                if s.sampling.seed is not None and s.sampling.temperature > 0:
                    return fused_w
                return True

            win = [s for s in batch if window_ok(s)]
            if len(win) == len(batch):
                if self._decode_multi(batch, bucket, outputs):
                    return outputs
            elif win and fused_w:
                # Row-wise fallback: the eligible rows run one fused window
                # and only the others single-step below, in this order (the
                # window's uniforms, then the step's key, off one counter).
                # Where the window cannot reserve its blocks, the whole
                # batch single-steps.
                if self._decode_multi(win, next_bucket(len(win), self.sc.decode_buckets), outputs):
                    self.rowwise_windows_total += 1
                    batch = [s for s in batch if not window_ok(s)]
                    bucket = next_bucket(len(batch), self.sc.decode_buckets)
        width = self._width_bucket(max(len(seq.block_ids) for seq in batch))
        # The zero-bubble pipeline: a batch with no per-row host work and
        # nothing waiting hands off to the overlapped loop (tokens stream one
        # step behind; this iteration emits nothing).
        if self._overlap_start_ok(batch) and self._overlap_start(batch, bucket, width):
            return outputs
        tpa, tables = self._decode_host(batch, bucket, width)
        with StepTimer() as timer:
            self._record_host_gap()
            if self._graphs is not None:
                logits = self._graphs.decode(self.params, self.mc, self.cache, tpa, tables)
            else:
                tpa_d = self._dev(tpa)
                logits, _, _ = self._fwd("decode", self.params, self.mc, self.cache.k, self.cache.v, tpa_d[0],
                                         tpa_d[1], self._decode_tables(batch, bucket, width), tpa_d[2].bool())
            self._note_decode_dispatch()
            self.forward_steps_total += 1
            self.decode_steps_total += 1
            self._finish_decode_rows(batch, bucket, logits, outputs)
        self.flight.record_step("decode", timer.dur, len(outputs), kv_read_tokens=sum(s.total_len for s in batch))
        self.telemetry.observe("itl", timer.dur)
        return outputs

    def _decode_inputs(self, batch: List[Sequence], bucket: int) -> tuple:
        """Device ``(tokens, positions, tables, active)`` of a decode batch
        padded to ``bucket``: each row's last token at its write slot, the
        tables at the width bucket of the longest row."""
        width = self._width_bucket(max(len(seq.block_ids) for seq in batch))
        tpa_d = self._dev(self._decode_host(batch, bucket, width)[0])
        return tpa_d[0], tpa_d[1], self._decode_tables(batch, bucket, width), tpa_d[2].bool()

    # --- zero-bubble overlapped decode --------------------------------------
    def _overlap_row_ok(self, seq: Sequence) -> bool:
        """Rows that need the host between steps cannot ride the pipeline:
        guided (the FSM advances before the next mask), logprobs and
        processors and penalties (the logits change or are read between
        steps), seeded sampled rows (per-row keys) and prefill-role rows
        (their blocks wait for an export at finish), as in the JAX
        package."""
        s = seq.sampling
        return not (seq.aborted or seq.guided is not None or _has_extras(s)
                    or (s.seed is not None and s.temperature > 0) or seq.keep_blocks_on_finish)

    def _overlap_start_ok(self, batch: List[Sequence]) -> bool:
        return (
            self.sc.enable_overlap_decode
            and self._supports_overlap
            and self.draft_params is None
            and not self.waiting
            and all(self._overlap_row_ok(s) for s in batch)
        )

    def _overlap_can_dispatch(self, batch: List[Sequence], positions: List[int]) -> bool:
        """The next step writes KV at each row's input position: every slot
        must already exist (block-table growth flushes to the sync path,
        which allocates or preempts there) and stay inside max_seq_len."""
        bs = self.mc.block_size
        for seq, p in zip(batch, positions):
            if p + 1 > len(seq.block_ids) * bs or p >= self.mc.max_seq_len:
                return False
        return True

    def _overlap_should_continue(self) -> bool:
        pipe = self._pipe
        return (
            not self.waiting
            and not any(s.aborted for s in pipe["batch"])
            and self._overlap_can_dispatch(pipe["batch"], pipe["positions"])
        )

    def _dispatch_overlap(self, pipe: dict, tpa) -> None:
        """Launch one decode + draw step (``llama.decode_sample``) without
        waiting for it: ``tpa`` is the host's ``[3, B]`` inputs, or the
        previous step's ``next_tpa`` on the device. Its tokens start on
        their way to pinned host memory at once; the step's ``next_tpa``
        feeds the next launch."""
        key = self._next_key()
        if pipe["greedy"]:
            key = None  # an all-greedy batch draws nothing
        self._record_host_gap()
        if self._graphs is not None:
            sampled, next_tpa = self._graphs.decode_sample(
                self.params, self.mc, self.cache, tpa, pipe["tables"], pipe["temps"], pipe["tks"], pipe["tps"], key)
        else:
            if not isinstance(tpa, torch.Tensor):
                tpa = self._dev(tpa)
            if "samp_d" not in pipe:
                pipe["samp_d"] = tuple(self._dev(x) for x in (pipe["temps"], pipe["tks"], pipe["tps"]))
            sampled, next_tpa, _, _ = self._fwd(
                "decode_sample", self.params, self.mc, self.cache.k, self.cache.v, tpa,
                self._decode_tables(pipe["batch"], pipe["bucket"], pipe["width"]), *pipe["samp_d"], key)
        self._note_decode_dispatch()
        pipe["sampled"] = self._reads.read_async(sampled)
        pipe["next_tpa"] = next_tpa
        self.overlap_steps_total += 1
        self.forward_steps_total += 1
        self.decode_steps_total += 1

    def _overlap_start(self, batch: List[Sequence], bucket: int, width: int) -> bool:
        """Launch pipeline step 0. No token is retired this iteration:
        streams run one step behind on the overlap path."""
        positions = [s.total_len - 1 for s in batch]
        if not self._overlap_can_dispatch(batch, positions):
            return False
        temps, top_ks, top_ps = pack_param_rows([s.sampling for s in batch], bucket)
        tpa, tables = self._decode_host(batch, bucket, width)
        pipe = {"batch": batch, "bucket": bucket, "width": width, "tables": tables,
                "temps": temps, "tks": top_ks, "tps": top_ps, "greedy": not (temps > 0).any()}
        self._dispatch_overlap(pipe, tpa)
        pipe["positions"] = [p + 1 for p in positions]
        self._pipe = pipe
        return True

    def _overlap_step(self, outputs: List[tuple]) -> None:
        """Steady state: launch step N+1 from step N's on-device tokens,
        THEN read and retire step N while N+1 runs: one wait per step. A row
        that turns out finished at step N makes step N+1's token for it
        garbage; the flush discards it and rolls back its KV slot."""
        pipe = self._pipe
        prev = pipe["sampled"]
        # The N+1 launch writes each row's last appended token's KV at the
        # row's total_len before this retire: take the targets first.
        rollback = self._rollback_targets(pipe["batch"])
        with StepTimer() as timer:
            self._dispatch_overlap(pipe, pipe["next_tpa"])
            pipe["positions"] = [p + 1 for p in pipe["positions"]]
            sampled_h = prev.wait()  # the step's one wait
            finished = False
            for i, seq in enumerate(pipe["batch"]):
                self._append_token(seq, int(sampled_h[i]), outputs)
                if seq.state != SeqState.RUNNING:
                    finished = True
        self.flight.record_step("decode", timer.dur, len(pipe["batch"]),
                                kv_read_tokens=sum(s.total_len for s in pipe["batch"]))
        self.telemetry.observe("itl", timer.dur)
        if finished:
            self._overlap_flush(outputs, rollback=rollback)

    def _rollback_targets(self, batch: List[Sequence]) -> List[Optional[tuple]]:
        """(block, offset) each row's in-flight step writes to: the slot to
        zero if the row turns out finished while that step runs."""
        bs = self.mc.block_size
        out: List[Optional[tuple]] = []
        for seq in batch:
            p = seq.total_len
            out.append((seq.block_ids[p // bs], p % bs) if p < len(seq.block_ids) * bs else None)
        return out

    def _overlap_flush(self, outputs: List[tuple], rollback: Optional[List] = None) -> None:
        """Absorb the in-flight step and return to the sync path. Rows still
        running keep its token (it computed what the sync path would have);
        rows that finished at the previous retire discard theirs and get
        the KV slot it wrote zeroed, so the device state never runs ahead
        of the host's account. ``rollback`` comes only from
        _overlap_step's finish path: on a composition flush every row still
        runs and nothing rolls back."""
        pipe, self._pipe = self._pipe, None
        self.overlap_flushes_total += 1
        sampled_h = pipe["sampled"].wait()
        for i, seq in enumerate(pipe["batch"]):
            if seq.state != SeqState.RUNNING:
                # Only rows that finished at the previous retire roll back (a
                # row preempted by a batchmate's growth below is WAITING, its
                # blocks released and maybe owned again: nothing to zero).
                if (rollback is not None and rollback[i] is not None
                        and seq.state == SeqState.FINISHED and not seq.aborted):
                    self._kv_zero(*rollback[i])
                continue
            if seq.aborted:
                continue  # _reap_aborted finishes it without the extra token
            self._ensure_block_capacity(seq)
            if seq.state != SeqState.RUNNING:
                continue
            self._append_token(seq, int(sampled_h[i]), outputs)

    def _kv_zero(self, block: int, offset: int) -> None:
        """Zero one KV slot in every layer: a rolled-back write (an int8
        cache's codes and scales)."""
        for c in self._kv_pools():
            for t in ((c.q, c.scale) if isinstance(c, QuantKv) else (c,)):
                t[:, block, offset] = 0

    def _decode_multi(self, batch: List[Sequence], bucket: int, outputs: List[tuple]) -> bool:
        """One multi-step decode window: N steps, one host sync. Returns
        False (the caller runs a single step) when the window would pass
        ``max_seq_len`` or its KV blocks can't be reserved."""
        rungs = self._window_rungs
        remaining = [max(1, seq.stop.max_tokens - len(seq.output_ids)) for seq in batch]
        steps = next((w for w in rungs if w >= max(remaining)), rungs[-1])
        if self.sc.window_waiting_cap:
            cap_rung = next((w for w in rungs if w >= self.sc.window_waiting_cap), rungs[-1])
            # A waiting request, or a batchmate within a rung of its budget,
            # caps the window: at most cap_rung-1 trimmed steps.
            if self.waiting or min(remaining) <= cap_rung:
                steps = min(steps, cap_rung)
        bs = self.mc.block_size
        # Reserve the whole window's blocks up front (+1 for the next
        # iteration's write slot, as _ensure_block_capacity keeps).
        for seq in batch:
            if seq.total_len + steps > self.mc.max_seq_len:
                return False
            need = (seq.total_len + steps + bs - 1) // bs - len(seq.block_ids)
            if need > 0:
                try:
                    seq.block_ids.extend(self.allocator.allocate(need))
                except OutOfBlocksError:
                    return False
        temps, top_ks, top_ps = pack_param_rows([s.sampling for s in batch], bucket)
        # The fused window takes any batch with no per-row host extras: guided
        # rows only where the guided epilogue is on.
        any_guided = any(s.guided is not None for s in batch)
        fused_ok = (self._use_fused_window and not any(_has_extras(s.sampling) for s in batch)
                    and (not any_guided or self._fused_guided_ok()))
        n0 = len(outputs)
        with StepTimer() as timer:
            self._record_host_gap()
            if fused_ok:
                args = (self.params, self.mc, self.cache.k, self.cache.v, *self._decode_inputs(batch, bucket))
                samp = {}
                # A guided window takes the sampled epilogue, as in the JAX
                # package, so it draws its uniforms off the step counter even
                # when every row is greedy and the keys stay the JAX package's.
                if any_guided or any(s.sampling.temperature > 0 for s in batch):
                    # One [steps, bucket] uniforms upload per window.
                    uniforms = make_window_uniforms(self._next_key(), *self._seed_rows(batch, bucket), steps,
                                                    device=self.device)
                    samp = dict(temps=temps, top_ks=top_ks, top_ps=top_ps, uniforms=uniforms, sampled=True)
                if any_guided:
                    # The rows' FSM rows at the window's start; the kernel advances them.
                    pool = self.guided.pool
                    samp.update(guided_rows=self._guided_rows(batch, bucket), mask_pool=pool.device(),
                                next_pool=pool.next_device(), guided=True)
                    self.fused_guided_windows_total += 1
                launches0 = self._window_launches()
                toks, _, _ = llama.decode_multi_fused(*args, num_steps=steps, **samp)
                self._note_decode_dispatch()
                self.fused_window_pallas_launches = self._window_launches() - launches0
            else:
                key = self._next_key()
                if not (temps > 0).any():
                    key = None  # an all-greedy window draws nothing
                if self._graphs is not None:
                    width = self._width_bucket(max(len(seq.block_ids) for seq in batch))
                    tpa, tables = self._decode_host(batch, bucket, width)
                    toks = self._graphs.decode_multi(self.params, self.mc, self.cache, tpa, tables, temps, top_ks,
                                                     top_ps, None if key is None else prng.split_many(key, steps), steps)
                else:
                    args = (self.params, self.mc, self.cache.k, self.cache.v, *self._decode_inputs(batch, bucket))
                    toks, _, _ = self._fwd("decode_multi", *args, temps, top_ks, top_ps, key, steps)
                self._note_decode_dispatch()
                self.multi_windows_total += 1
                self.window_steps_total += steps
            sampled = toks.cpu().numpy()  # the one host sync per window
            for i, seq in enumerate(batch):
                for s in range(steps):
                    if seq.state != SeqState.RUNNING:
                        break  # stopped inside the window: later tokens are trimmed
                    self._append_token(seq, int(sampled[s, i]), outputs)
        if fused_ok:
            self.fused_windows_total += 1
            if samp:
                self.fused_sampled_windows_total += 1
        # Every step of a window reads the weights and each row's prefix from
        # HBM: decode_multi's forwards, and the fused kernel too, whose
        # products stream the weight boxes step after step (the JAX package
        # charges its fused window one pass, held in VMEM).
        self.flight.record_step("decode", timer.dur, len(outputs) - n0,
                                kv_read_tokens=steps * sum(s.total_len for s in batch), param_passes=float(steps))
        self.telemetry.observe("itl", timer.dur / max(steps, 1))
        return True

    def _decode_spec_fused(self, batch: List[Sequence], bucket: int, outputs: List[tuple]) -> bool:
        """R speculative rounds in ONE launch (``llama.decode_spec_fused``):
        per round the draft proposes γ tokens, the target verifies the γ+1
        chunk and rejection sampling keeps a prefix plus a correction or
        bonus token, the cursors advancing on the device. The host syncs
        once and replays each round's burst, trimming at stops. Returns False
        (the caller decodes without the draft) when the window would pass
        ``max_seq_len`` or its blocks can't be reserved."""
        gamma, R = self.spec_gamma, self._spec_rounds
        span = R * (gamma + 1)  # worst-case tokens appended per window
        bs = self.mc.block_size
        for seq in batch:
            if seq.total_len + span + 1 > self.mc.max_seq_len:
                return False
            need = (seq.total_len + span + 1 + bs - 1) // bs - len(seq.block_ids)
            if need > 0:
                try:
                    seq.block_ids.extend(self.allocator.allocate(need))
                except OutOfBlocksError:
                    return False
            if seq.total_len - seq.d_n > 2:
                # The kernel's catch-up re-feeds only the token at pos-1, so
                # the draft cache must cover pos-2 already.
                self._draft_catchup(seq, seq.all_ids, seq.total_len - 1)
        width = self._width_bucket(max(len(seq.block_ids) for seq in batch))
        self._break_decode_gap()
        n0 = len(outputs)
        t_round = time.perf_counter()
        tables = np.zeros((bucket, width), dtype=np.int32)
        tpa = np.zeros((4, bucket), dtype=np.int32)  # tokens, xprev, positions, active
        for i, seq in enumerate(batch):
            tables[i, : len(seq.block_ids)] = seq.block_ids
            tpa[:, i] = (seq.all_ids[-1], seq.all_ids[-2], seq.total_len - 1, 1)
        temps, top_ks, top_ps = pack_param_rows([s.sampling for s in batch], bucket)
        # Every draw of the window (γ proposals, γ accept tests and the
        # correction or bonus per round and row) in one upload.
        uniforms = prng.uniform(self._next_key(), (R, bucket, 2 * gamma + 1), device=self.device)
        tpa_d, tables_d = self._dev(tpa), self._dev(tables)
        toks, acc, _, _, _, _ = llama.decode_spec_fused(
            self.params, self.mc, self.draft_params, self.draft_cfg, self.cache.k, self.cache.v,
            self.draft_cache.k, self.draft_cache.v, tpa_d[0], tpa_d[1], tpa_d[2], tables_d, tables_d,
            tpa_d[3].bool(), temps, top_ks, top_ps, uniforms, rounds=R, gamma=gamma,
        )
        toks_h, acc_h = toks.cpu().numpy(), acc.cpu().numpy()  # the one host sync
        st = self.spec_stats
        for r in range(R):
            st.num_rounds += 1
            for i, seq in enumerate(batch):
                if seq.state != SeqState.RUNNING:
                    continue  # stopped in an earlier round
                k = int(acc_h[r, i])
                st.record_round(k, gamma)
                old_total = seq.total_len
                for t in list(toks_h[r, i, :k]) + [toks_h[r, i, gamma]]:
                    if seq.state != SeqState.RUNNING:
                        break  # a stop inside the burst: the rest is trimmed
                    self._append_token(seq, int(t), outputs)
                # The draft holds the catch-up row and the first min(k, γ-1)
                # proposal feeds of this round.
                seq.d_n = old_total + min(k, gamma - 1)
        dur_round = time.perf_counter() - t_round
        self.spec_fused_windows_total += 1
        self.spec_fused_accepted_tokens_total += len(outputs) - n0
        # Both models' weights stream once for the whole window.
        self.flight.record_step("spec", dur_round, len(outputs) - n0,
                                kv_read_tokens=2 * R * sum(s.total_len for s in batch), param_passes=1.0)
        self.telemetry.observe("itl", dur_round / max(len(outputs) - n0, 1))
        return True

    def _decode_spec(self, batch: List[Sequence], bucket: int, outputs: List[tuple]) -> bool:
        """One speculative round for the batch: the draft catches up on its
        unconsumed confirmed tokens and draws the first proposal (one
        ``chunk_decode`` pass), then γ-1 more in a ``decode_multi`` window
        with each step's logits; the target scores ``[last ; proposals]``
        in one ``chunk_decode(all_logits=True)`` pass, and rejection
        sampling (``spec_verify``) keeps a prefix and a correction or bonus
        token a row, so the output follows the target's distribution
        (greedy rows: argmax agreement). Returns False (the caller decodes
        without the draft) when the round would pass ``max_seq_len`` or its
        blocks cannot be reserved."""
        gamma = self.spec_gamma
        S = gamma + 1
        bs = self.mc.block_size
        for seq in batch:
            if seq.total_len + S + 1 > self.mc.max_seq_len:
                return False
            need = (seq.total_len + S + 1 + bs - 1) // bs - len(seq.block_ids)
            if need > 0:
                try:
                    seq.block_ids.extend(self.allocator.allocate(need))
                except OutOfBlocksError:
                    return False
            if seq.total_len - seq.d_n > S:
                # A lag longer than the round's chunk (non-spec stretches):
                # absorb it in prefill chunks so the row rejoins the round.
                self._draft_catchup(seq, seq.all_ids, seq.total_len - 1)
        B = bucket
        width = self._width_bucket(max(len(seq.block_ids) for seq in batch))
        self._break_decode_gap()
        n0 = len(outputs)
        t_round = time.perf_counter()
        tables = np.zeros((B, width), dtype=np.int32)
        d_toks = np.zeros((B, S), dtype=np.int32)
        d_pos0 = np.zeros((B,), dtype=np.int32)
        d_valid = np.zeros((B,), dtype=np.int32)
        # The draft window's [3, B] inputs (its first tokens come from the
        # device) and the target's chunk: [last confirmed ; proposals].
        tpa = np.zeros((3, B), dtype=np.int32)
        t_pos0 = np.zeros((B,), dtype=np.int32)
        t_valid = np.zeros((B,), dtype=np.int32)
        for i, seq in enumerate(batch):
            lag = seq.total_len - seq.d_n  # ≥ 1: the last token is never in the draft cache
            d_toks[i, :lag] = seq.all_ids[seq.d_n:]
            d_pos0[i], d_valid[i] = seq.d_n, lag
            tables[i, : len(seq.block_ids)] = seq.block_ids
            tpa[1:, i] = (seq.total_len, 1)
            t_pos0[i], t_valid[i] = seq.total_len - 1, S
        temps, top_ks, top_ps = pack_param_rows([s.sampling for s in batch], B)
        greedy = not (temps > 0).any()
        dp, dc, dcache = self.draft_params, self.draft_cfg, self.draft_cache
        g = self._graphs
        samp_d = tuple(self._dev(x) for x in (temps, top_ks, top_ps))
        tables_d = self._dev(tables) if g is None else None
        key = self._next_key()
        if g is not None:
            tok1, lg1 = g.spec_draft(dp, dc, dcache, d_toks, d_pos0, d_valid, tables, temps, top_ks, top_ps,
                                     None if greedy else key, gamma)
        else:
            lg1, _, _ = llama.chunk_decode(dp, dc, dcache.k, dcache.v, *map(self._dev, (d_toks, d_pos0, d_valid)),
                                           tables_d, last_logits=True)
            tok1 = sample_batch_device(lg1, *samp_d, None if greedy else key)
        proposals = tok1[:, None]
        draft_logits = lg1[:, None]
        if gamma > 1:
            key2 = self._next_key()
            keys = None if greedy else prng.split_many(key2, gamma - 1)
            if g is not None:
                toks_out, lg_steps = g.decode_multi(dp, dc, dcache, tpa, tables, temps, top_ks, top_ps, keys,
                                                    gamma - 1, model="draft", return_logits=True, first_tokens=tok1)
            else:
                tpa_d = self._dev(tpa)
                toks_out, lg_steps, _, _ = llama.decode_multi(
                    dp, dc, dcache.k, dcache.v, tok1, tpa_d[1], tables_d, tpa_d[2].bool(), *samp_d,
                    None if greedy else key2, gamma - 1, return_logits=True)
            proposals = torch.cat([proposals, toks_out.t()], 1)  # [B, γ]
            draft_logits = torch.cat([draft_logits, lg_steps.transpose(0, 1)], 1)  # [B, γ, V]
        proposals_h = proposals.cpu().numpy()  # the round's first host sync
        t_toks = np.zeros((B, S), dtype=np.int32)
        for i, seq in enumerate(batch):
            t_toks[i, 0] = seq.all_ids[-1]
            t_toks[i, 1:] = proposals_h[i]
        if g is not None:
            t_logits = g.spec_target(self.params, self.mc, self.cache, t_toks, t_pos0, t_valid, tables, gamma)
        else:
            t_logits, _, _ = self._fwd("chunk_decode", self.params, self.mc, self.cache.k, self.cache.v,
                                       *map(self._dev, (t_toks, t_pos0, t_valid)), tables_d, all_logits=True)
        accepted, next_tok = spec_verify(draft_logits, t_logits, proposals, *samp_d, self._next_key())
        accepted_h, next_h = accepted.cpu().numpy(), next_tok.cpu().numpy()  # the second
        st = self.spec_stats
        st.num_rounds += 1
        self.spec_rounds_total += 1
        for i, seq in enumerate(batch):
            if seq.state != SeqState.RUNNING:
                continue
            k = int(accepted_h[i])
            st.record_round(k, gamma)
            old_total = seq.total_len
            for t in list(proposals_h[i, :k]) + [int(next_h[i])]:
                if seq.state != SeqState.RUNNING:
                    break  # a stop inside the burst: stale KV rows stay masked by position
                self._append_token(seq, int(t), outputs)
            # The draft holds the catch-up through old_total-1 and the
            # proposal feeds at old_total.., the first min(k, γ-1) confirmed.
            seq.d_n = old_total + min(k, gamma - 1)
        self.flight.record_step("spec", time.perf_counter() - t_round, len(outputs) - n0,
                                kv_read_tokens=2 * sum(s.total_len for s in batch))
        return True

    def _finish_decode_rows(
        self, batch: List[Sequence], bucket: int, logits: torch.Tensor, outputs: List[tuple]
    ) -> None:
        """Post-forward half of a decode step: penalties, logits processors,
        sampling (with the logprobs a row asks for), then token append/stop
        handling, growing each row's block table. Shared by _decode_step and
        _mixed_step."""
        edited = False
        if any(seq.sampling.has_penalties for seq in batch):
            logits = self._apply_penalties(batch, bucket, logits)
            edited = True
        if any(seq.sampling.logits_processors for seq in batch):
            # The rows that carry processors, on the device (JAX crosses to
            # the host for them and computes the same function).
            logits = logits.clone()
            for i, seq in enumerate(batch):
                if seq.sampling.logits_processors:
                    logits[i] = apply_chain(seq.sampling.logits_processors, seq.output_ids, logits[i])
            edited = True
        key = self._next_key()
        row_keys = None
        if any(seq.sampling.seed is not None for seq in batch):
            row_keys = make_row_keys(key, *self._seed_rows(batch, bucket))
        top = any(seq.sampling.top_logprobs for seq in batch)
        want = "top" if top else "chosen" if any(seq.sampling.logprobs for seq in batch) else None
        sampled, lps, top_ids, top_lps = self._draw(logits, batch, bucket, key, row_keys, edited=edited,
                                                    logprobs=want)
        for i, seq in enumerate(batch):
            if seq.state != SeqState.RUNNING:
                continue  # preempted while growing an earlier row this step
            self._ensure_block_capacity(seq)
            if seq.state != SeqState.RUNNING:
                continue
            s = seq.sampling
            lp = float(lps[i]) if lps is not None and (s.logprobs or s.top_logprobs) else None
            tlp = None
            if top_ids is not None and s.top_logprobs:
                tlp = [(int(t), float(lp)) for t, lp in zip(top_ids[i, :s.top_logprobs], top_lps[i, :s.top_logprobs])]
            self._append_token(seq, int(sampled[i]), outputs, logprob=lp, top_logprobs=tlp)

    def _apply_penalties(self, batch: List[Sequence], bucket: int, logits: torch.Tensor) -> torch.Tensor:
        """Frequency/presence penalties for the rows that ask for them
        (``sampling.apply_penalties``), the history padded to a power of two
        from 16 as in the JAX package."""
        H = 16
        longest = max((len(s.output_ids) for s in batch if s.sampling.has_penalties), default=0)
        while H < longest:
            H *= 2
        hist = np.zeros((bucket, H), dtype=np.int32)
        hist_len = np.zeros((bucket,), dtype=np.int32)
        freq = np.zeros((bucket,), dtype=np.float32)
        pres = np.zeros((bucket,), dtype=np.float32)
        for i, seq in enumerate(batch):
            if not seq.sampling.has_penalties or not seq.output_ids:
                continue
            n = len(seq.output_ids)
            hist[i, :n] = seq.output_ids
            hist_len[i] = n
            freq[i] = seq.sampling.frequency_penalty
            pres[i] = seq.sampling.presence_penalty
        return apply_penalties(logits, *map(self._dev, (hist, hist_len, freq, pres)))

    # --- KVBM and disaggregation --------------------------------------------
    def attach_kvbm(self, kvbm) -> None:
        """Enable tiered offload and onboarding (``llm/block_manager``)."""
        self.kvbm = kvbm

    def _match_prefix_tiers(self, seq: Sequence) -> List[int]:
        """The G1 prefix match, extended by onboarding from G2/G3/G4 when a
        KVBM is attached. Onboarded blocks count as hits (reuse, not
        recompute): the allocator's G1 walk counted them as misses, so the
        counters move here; ``prefix_onboard_total`` counts the blocks that
        came back into G1 from a deeper tier."""
        if self.kvbm is None:
            return self.allocator.match_prefix(seq.block_hashes)
        match = self.kvbm.match_prefix(seq.block_hashes)
        blocks = self.kvbm.onboard(match, seq.block_hashes)
        onboarded = len(blocks) - len(match.g1_blocks)
        if onboarded > 0:
            self.prefix_onboard_total += onboarded
            self.allocator.hit_blocks_total += onboarded
            self.allocator.miss_blocks_total -= onboarded
        return blocks

    def _inject_prefilled(self, seq: Sequence, outputs: List[tuple]) -> bool:
        """Decode-role admission: the prompt's KV came from a prefill worker.
        Scatter it into fresh blocks (``prefilled["blocks"]``: host block
        pairs off the wire; ``prefilled["device_blocks"]``: stacked device
        tensors, handed over in process or pulled through CUDA IPC) and
        enter decode with the prefill leg's first token, with no prefill
        compute. With ``prefill_len`` short of the prompt (a token-boundary
        split) the KV covers that many tokens and the request resumes
        chunked prefill there: it samples its own first token at the
        prompt's end and the leg's is dropped."""
        from dynamo_tpu_torch.llm.block_manager.transfer import scatter_blocks_device

        bs = self.mc.block_size
        data = seq.prefilled
        n_pref = min(int(data.get("prefill_len") or len(seq.prompt)), len(seq.prompt))
        full = n_pref >= len(seq.prompt)
        n_blocks = (len(seq.prompt) + 1 + bs - 1) // bs
        seq.block_ids = self.allocator.allocate(n_blocks)  # OutOfBlocksError: retried next step
        if "device_blocks" in data:
            k_stack, v_stack = data["device_blocks"]
        else:
            # One stacked upload for all the host blocks.
            blocks = data["blocks"]
            k_stack = torch.stack([k for k, _ in blocks], dim=1)
            v_stack = torch.stack([v for _, v in blocks], dim=1) if blocks[0][1].numel() else None
        scatter_blocks_device(self.cache, seq.block_ids[: k_stack.shape[1]], k_stack, v_stack)
        seq.num_computed = n_pref
        if seq.admitted_ts is None:
            seq.admitted_ts = time.monotonic()
        # A draft has no KV of a remotely prefilled prompt: compute its own
        # before the row speculates.
        self._draft_catchup(seq, seq.prompt, seq.num_computed)
        if self.sc.enable_prefix_caching:
            seq.block_hashes = extend_block_hashes([], seq.prompt, bs)
            self._register_full_blocks(seq)
        seq.prefilled = None  # consumed: a later preemption resumes by recompute
        if not full:
            seq.state = SeqState.PREFILL
            self._trace_event(seq, "disagg_inject", blocks=len(seq.block_ids), device_native="device_blocks" in data,
                              partial=True, prefill_len=n_pref)
            return False
        seq.state = SeqState.RUNNING
        self.running.append(seq)
        self._trace_event(seq, "disagg_inject", blocks=len(seq.block_ids), device_native="device_blocks" in data)
        self._append_token(seq, int(data["first_token"]), outputs)
        return True

    def take_export(self, request_id: str):
        """A finished prefill-role request's blocks, as host pairs (one
        device → host copy), its blocks released. → ``(blocks, hashes,
        prompt_len)`` or None."""
        from dynamo_tpu_torch.llm.block_manager.transfer import gather_blocks_host

        seq = self._pending_exports.pop(request_id, None)
        self._export_deadline.pop(request_id, None)
        if seq is None:
            return None
        data = gather_blocks_host(self.cache, seq.block_ids)
        self.allocator.release(seq.block_ids)
        seq.block_ids = []
        self.exports_taken_total += 1
        return data, seq.block_hashes, len(seq.prompt)

    def take_export_device(self, request_id: str):
        """A finished prefill-role request's blocks stacked into fresh device
        tensors (one gather, no host round trip), its blocks released. The
        stack does not alias the cache, so it can await a pull while the
        blocks are reused. → ``((k_stack [L, n, BS, KVH, HD], v_stack or
        None), hashes, prompt_len)`` or None."""
        from dynamo_tpu_torch.llm.block_manager.transfer import gather_blocks_device

        seq = self._pending_exports.pop(request_id, None)
        self._export_deadline.pop(request_id, None)
        if seq is None:
            return None
        k_stack, v_stack = gather_blocks_device(self.cache, seq.block_ids)
        self.allocator.release(seq.block_ids)
        seq.block_ids = []
        self.exports_taken_total += 1
        return (k_stack, v_stack), seq.block_hashes, len(seq.prompt)

    def expire_exports(self, now: Optional[float] = None) -> int:
        """Reclaim the exports nobody pulled within ``export_ttl_s``.
        Returns how many."""
        now = time.monotonic() if now is None else now
        expired = [rid for rid, dl in self._export_deadline.items() if dl < now]
        for rid in expired:
            seq = self._pending_exports.pop(rid, None)
            self._export_deadline.pop(rid, None)
            if seq is not None:
                self.allocator.release(seq.block_ids)
                seq.block_ids = []
        self.exports_expired_total += len(expired)
        return len(expired)

    def _copy_block(self, src: int, dst: int) -> None:
        """Block duplication across all layers (the copy-on-write copy); an
        int8 cache copies its codes and its scales."""
        for c in self._kv_pools():
            for t in ((c.q, c.scale) if isinstance(c, QuantKv) else (c,)):
                t[:, dst] = t[:, src]

    def _kv_pools(self) -> tuple:
        """The cache tensors that hold blocks: k and v, or MLA's latent k
        alone (its v is a ``[L, 1, 1, 1, 1]`` placeholder, which no block
        index reaches)."""
        return (self.cache.k,) if self.mc.architecture == "mla" else (self.cache.k, self.cache.v)

    def _ensure_block_capacity(self, seq: Sequence) -> None:
        """Grow the block table if the *next* token would overflow it. On
        OutOfBlocks, preempt the newest other running sequence and retry;
        only when no victim exists does the sequence finish with "length"."""
        bs = self.mc.block_size
        while seq.total_len + 1 > len(seq.block_ids) * bs:
            try:
                seq.block_ids.extend(self.allocator.allocate(1))
                return
            except OutOfBlocksError:
                if self.sc.enable_preemption and self._preempt_for(seq):
                    continue  # victim freed blocks — retry
                seq.aborted = True
                seq.abort_reason = "length"
                logger.warning("seq %s out of KV blocks at len %d", seq.request_id, seq.total_len)
                return

    def _preempt_for(self, needy: Sequence) -> bool:
        """Evict the newest other running sequence: release its blocks and
        send it back to the waiting queue for recompute. Returns True if a
        victim was preempted."""
        candidates = [s for s in self.running if s is not needy and s.state == SeqState.RUNNING]
        if not candidates:
            return False
        victim = max(candidates, key=lambda s: s.arrival_ts)
        self.running.remove(victim)
        self.allocator.release(victim.block_ids)
        victim.block_ids = []
        victim.block_hashes = []
        victim.num_cached_blocks = 0
        victim.num_computed = 0
        victim.d_n = 0  # the draft's rows went with the blocks
        # Recompute everything up to (not including) the last token; the
        # last token re-enters through the decode step on resume.
        victim.resume_tokens = list(victim.all_ids[:-1])
        victim.state = SeqState.WAITING
        victim.preemptions += 1
        self.preempt_total += 1
        self.waiting.insert(0, victim)
        self._trace_event(victim, "preempted", total_len=victim.total_len, for_request=needy.request_id)
        logger.info("preempted %s (len %d) to free blocks", victim.request_id, victim.total_len)
        return True

    def _record_host_gap(self) -> None:
        """Called right before a decode-family dispatch: the time since the
        previous one returned is the gap the card waited on the host."""
        if self._last_decode_dispatch_t is not None:
            self.flight.record_host_gap(time.perf_counter() - self._last_decode_dispatch_t)

    def _note_decode_dispatch(self) -> None:
        """Called right after a decode-family dispatch returns (launched, the
        host free again)."""
        self._last_decode_dispatch_t = time.perf_counter()

    def _break_decode_gap(self) -> None:
        """A non-decode dispatch: the next decode's gap is not a host gap."""
        self._last_decode_dispatch_t = None

    def _trace_event(self, seq: Sequence, name: str, **attrs) -> None:
        """A lifecycle event on the request's trace; ``seq.trace`` is set
        only for a trace that records, so an untraced request pays one
        check."""
        if seq.trace is None:
            return
        self.tracer.event(name, seq.trace[0], parent_id=seq.trace[1], service="scheduler",
                          request_id=seq.request_id, **attrs)

    def _next_key(self) -> np.ndarray:
        """The next sampling call's key: the step counter, advanced, folded
        into the scheduler's key."""
        self._step_counter += 1
        return prng.fold_in(self._rng, self._step_counter)

    def _seed_rows(self, batch: List[Sequence], bucket: int) -> tuple:
        """(seeds, token positions, has_seed) rows of a batch padded to
        ``bucket``, for ``make_row_keys`` and ``make_window_uniforms``."""
        seeds = np.zeros((bucket,), dtype=np.int32)
        positions = np.zeros((bucket,), dtype=np.int32)
        has_seed = np.zeros((bucket,), dtype=bool)
        for i, seq in enumerate(batch):
            if seq.sampling.seed is not None:
                seeds[i] = seq.sampling.seed
                positions[i] = len(seq.output_ids)
                has_seed[i] = True
        return seeds, positions, has_seed

    def _draw(self, logits: torch.Tensor, batch: List[Sequence], bucket: int, key: np.ndarray,
              row_keys: Optional[np.ndarray] = None, *, edited: bool = False,
              logprobs: Optional[str] = None) -> tuple:
        """One token per row of ``logits`` (the batch padded to ``bucket``)
        as the rows' sampling options ask, guided rows over their FSM row's
        allowed tokens → ``(tokens, logprobs, top_ids, top_lps)`` numpy:
        ``[bucket]`` int32 tokens, then with ``logprobs="chosen"`` the
        chosen tokens' logprobs and with ``"top"`` also the
        ``TOP_LOGPROBS_CAP`` alternatives (None where not asked), all of
        the distribution drawn from (a guided row's masked one). The draw
        graph replays only a plain draw; guided draws (the mask pool may
        grow and move), draws over ``edited`` logits (penalties or
        processors applied outside the graph's buffer) and draws with
        logprobs run eagerly, on the logits' device."""
        temps, top_ks, top_ps = pack_param_rows([s.sampling for s in batch], bucket)
        if not (temps > 0).any():
            key = row_keys = None  # an all-greedy batch draws nothing
        if any(s.guided is not None for s in batch):
            pool, rows = self.guided.pool.device(), self._guided_rows(batch, bucket)
            k_rows = np.stack([top_ks, rows])
            if logprobs == "top":
                out = guided_sample_batch_top_logprobs(logits, pool, k_rows, temps, top_ps, key, row_keys)
            elif logprobs == "chosen":
                out = (*guided_sample_batch_logprobs(logits, pool, k_rows, temps, top_ps, key, row_keys), None, None)
            else:
                masked = apply_token_masks(logits, pool, torch.from_numpy(rows))
                out = (sample_batch_device(masked, temps, top_ks, top_ps, key, row_keys), None, None, None)
        elif self._graphs is not None and not edited and logprobs is None:
            return self._graphs.draw(logits, temps, top_ks, top_ps, key, row_keys).cpu().numpy(), None, None, None
        elif logprobs == "top":
            out = sample_batch_top_logprobs(logits, temps, top_ks, top_ps, key, row_keys)
        elif logprobs == "chosen":
            out = (*sample_batch_logprobs(logits, temps, top_ks, top_ps, key, row_keys), None, None)
        else:
            out = (sample_batch_device(logits, temps, top_ks, top_ps, key, row_keys), None, None, None)
        return tuple(None if x is None else x.cpu().numpy() for x in out)

    def _guided_rows(self, batch: List[Sequence], bucket: int) -> np.ndarray:
        """Each row's mask-pool row, padded to ``bucket``: a guided row's
        current FSM row, 0 (allow-all) for the others."""
        rows = np.zeros((bucket,), dtype=np.int32)
        for i, seq in enumerate(batch):
            if seq.guided is not None:
                rows[i] = seq.guided.row_id
        return rows

    def _sample_one(self, seq: Sequence, logits: torch.Tensor) -> int:
        """A first token: the row's processors applied first; a seeded
        request draws from its seed folded with its token position, others
        from the step's key. A row that asks for logprobs gets them of the
        logits before any grammar mask (as in the JAX package, whose first
        draw is the masked sampler's and whose logprobs are not), kept for
        ``_append_token``."""
        key = self._next_key()
        s = seq.sampling
        edited = bool(s.logits_processors)
        if edited:
            logits = apply_chain(s.logits_processors, seq.output_ids, logits)
        if s.seed is not None:
            key = prng.fold_in(prng.PRNGKey(s.seed), len(seq.output_ids))
        token = int(self._draw(logits[None, :], [seq], 1, key, edited=edited)[0][0])
        tok = torch.tensor([token], device=logits.device)
        if s.top_logprobs:
            chosen, ids, lps = (x.cpu().numpy() for x in compute_topk_logprobs(logits[None, :], tok))
            seq._pending_logprob = float(chosen[0])
            seq._pending_top_logprobs = [(int(t), float(lp)) for t, lp in zip(ids[0, :s.top_logprobs],
                                                                              lps[0, :s.top_logprobs])]
        elif s.logprobs:
            seq._pending_logprob = float(compute_logprobs(logits[None, :], tok).cpu()[0])
        return token

    def _append_token(self, seq: Sequence, token: int, outputs: List[tuple], logprob: Optional[float] = None,
                      top_logprobs: Optional[list] = None) -> None:
        if logprob is None:
            logprob, seq._pending_logprob = seq._pending_logprob, None
        if top_logprobs is None:
            top_logprobs, seq._pending_top_logprobs = seq._pending_top_logprobs, None
        seq.output_ids.append(token)
        if seq.guided is not None:
            seq.guided.advance(token)  # the host's FSM replay of the token
        # First token carries the request's queue time and its prefix-cache
        # reuse (skipped prompt tokens).
        queue_s = None
        cached = None
        if len(seq.output_ids) == 1:
            if seq.first_token_ts is None:
                seq.first_token_ts = time.monotonic()
            if seq.admitted_ts is not None:
                queue_s = max(0.0, seq.admitted_ts - seq.arrival_ts)
                self.queue_wait_s_total += queue_s
                self.telemetry.observe("queue_wait", queue_s)
                self.prefill_wait_s_total += max(0.0, seq.first_token_ts - seq.admitted_ts)
            self.first_tokens_total += 1
            cached = seq.cached_tokens
            self.telemetry.observe("ttft", max(0.0, seq.first_token_ts - seq.arrival_ts))
            self._trace_event(seq, "first_token", ttft_s=round(time.monotonic() - seq.arrival_ts, 6),
                              cached_tokens=seq.cached_tokens)
        reason = self._check_stop(seq, token)
        if reason is not None:
            # Token that triggered 'stop' is still emitted (backend strips).
            outputs.append(
                (seq, StepOutput(token_id=token, finished=True, finish_reason=reason, logprob=logprob,
                                 queue_s=queue_s, cached_tokens=cached, top_logprobs=top_logprobs))
            )
            self._finish(seq, reason, outputs, emit=False)
        else:
            outputs.append((seq, StepOutput(token_id=token, logprob=logprob, queue_s=queue_s, cached_tokens=cached,
                                            top_logprobs=top_logprobs)))

    def _check_stop(self, seq: Sequence, token: int) -> Optional[str]:
        if seq.guided is not None and seq.guided.exhausted:
            # The FSM accepts and only EOS remains (or the cursor is done):
            # finish instead of spending a step on the EOS.
            return "stop"
        n_out = len(seq.output_ids)
        if n_out >= seq.stop.min_tokens:
            if not seq.stop.ignore_eos and token in seq.eos_token_ids:
                return "stop"
            if token in seq.stop.stop_token_ids:
                return "stop"
        if n_out >= seq.stop.max_tokens:
            return "length"
        if seq.total_len >= self.mc.max_seq_len:
            return "length"
        return None

    def _register_full_blocks(self, seq: Sequence) -> None:
        """Publish completed prompt blocks for prefix reuse, after every
        prefill chunk: same-prefix bursts then share KV mid-prefill."""
        if not self.sc.enable_prefix_caching or not seq.block_hashes:
            return
        bs = self.mc.block_size
        n_full = min(seq.num_computed, len(seq.prompt)) // bs
        n_full = min(n_full, len(seq.block_hashes), len(seq.block_ids))
        if n_full > seq.num_cached_blocks:
            self.allocator.register_hashes(seq.block_ids[:n_full], seq.block_hashes[:n_full])

    def _finish(self, seq: Sequence, reason: str, outputs: List[tuple], emit: bool = True) -> None:
        if seq in self.running:
            self.running.remove(seq)
        seq.state = SeqState.FINISHED
        # Request-level telemetry and the SLO verdict. Cancelled and failed
        # requests are not judged: the client left, and counting them as
        # violations would let an abort storm fake an SLO breach.
        if seq.first_token_ts is not None and reason in ("stop", "length"):
            ttft_s = max(0.0, seq.first_token_ts - seq.arrival_ts)
            n_out = len(seq.output_ids)
            tpot_s = None
            if n_out > 1:
                tpot_s = max(0.0, time.monotonic() - seq.first_token_ts) / (n_out - 1)
                self.telemetry.observe("tpot", tpot_s)
            self.slo.judge(ttft_s, tpot_s, n_out)
        self._trace_event(seq, "finish", reason=reason, output_tokens=len(seq.output_ids),
                          preemptions=seq.preemptions)
        # Extend hashes over generated tokens so completed output blocks are
        # reusable too (multi-turn: the next prompt includes them). Image
        # sequences never register: placeholder ids do not hash the image.
        if self.sc.enable_prefix_caching and reason != "cancelled" and seq.mm_features is None:
            bs = self.mc.block_size
            seq.block_hashes = extend_block_hashes(seq.block_hashes, seq.all_ids, bs)
            n_full = len(seq.all_ids) // bs
            self.allocator.register_hashes(seq.block_ids[:n_full], seq.block_hashes[:n_full])
        if seq.keep_blocks_on_finish and reason not in ("cancelled", "timeout"):
            # Prefill role: the blocks stay held until the decode worker
            # pulls them (take_export), so no eviction touches them.
            self._pending_exports[seq.request_id] = seq
            self._export_deadline[seq.request_id] = time.monotonic() + self.sc.export_ttl_s
            self.exports_total += 1
        else:
            self.allocator.release(seq.block_ids)
            seq.block_ids = []
        self._close_guided(seq)
        if emit:
            outputs.append((seq, StepOutput(token_id=-1, finished=True, finish_reason=reason)))
        self.by_id.pop(seq.request_id, None)

    def _close_guided(self, seq: Sequence) -> None:
        """A finished request's grammar rows lose their user (the pool may
        reuse them)."""
        if seq.guided is not None:
            self.guided.close(seq.guided)
