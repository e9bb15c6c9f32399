"""Continuous batching scheduler: the engine's step loop.

The core loop of the JAX package's ``Scheduler`` in its single-step
configuration (one decode step per iteration, no overlapped decode):

- **Chunked prefill**: prompts longer than a chunk run as several chunks.
- **Prefix caching**: prompt block hashes are matched against the
  allocator's registry at first touch; matched blocks skip prefill, a full
  cover recomputes only the last token, and a shared last block is copied
  on write.
- **Mixed prefill+decode steps**: with sequences decoding AND prefill work
  waiting, each iteration runs ONE ragged batch — the decode batch plus up
  to ``mixed_prefill_budget`` chunk tokens (``llama.mixed_step``).
- **Preemption**: a decode row that cannot grow its block table evicts the
  newest other running sequence, which later recomputes its KV.

Batch sizes and chunk lengths round up to the JAX package's buckets, which
bound how many tensor shapes the model sees. The step loop runs in a
worker thread (``asyncio.to_thread``) so device-blocked steps never stall
the serving plane's event loop.
"""

from __future__ import annotations

import asyncio
import enum
import logging
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from dynamo_tpu_torch.engine.config import ModelConfig
from dynamo_tpu_torch.engine.kv_cache import BlockAllocator, KvCacheArrays, KvEvent, OutOfBlocksError
from dynamo_tpu_torch.engine.models import llama
from dynamo_tpu_torch.engine.sampling import SamplingParams, pack_param_rows, sample_batch
from dynamo_tpu_torch.llm.tokens import extend_block_hashes

logger = logging.getLogger(__name__)


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
    # First token only: seconds between arrival and engine admission.
    queue_s: Optional[float] = None
    # First token only: prompt tokens whose KV came from the prefix cache.
    cached_tokens: Optional[int] = None


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
    aborted: bool = False
    abort_reason: str = "cancelled"
    deadline_ts: Optional[float] = None
    # Preemption resume: tokens whose KV must be recomputed (prompt and
    # generated tokens but the last, which re-enters through decode).
    resume_tokens: Optional[List[int]] = None
    preemptions: int = 0

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
        self.mc = model_config
        self.sc = scheduler_config or SchedulerConfig()
        self.device = torch.device(device)
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
        self._gen = torch.Generator(device=self.device).manual_seed(rng_seed)
        # Model forward passes run (prefill chunks, decode and mixed steps):
        # each launches the attention kernel once per layer.
        self.forward_steps_total = 0
        self.cached_tokens_total = 0
        self.cow_blocks_total = 0
        self.mixed_steps_total = 0
        self.mixed_prefill_tokens_total = 0
        self.mixed_decode_tokens_total = 0
        # Trim buckets to the model's max length.
        self.sc.prefill_buckets = [b for b in self.sc.prefill_buckets if b <= model_config.max_seq_len] or [
            model_config.max_seq_len
        ]

    # --- public API (called from event loop) --------------------------------
    def add_request(
        self,
        request_id: str,
        token_ids: List[int],
        sampling: SamplingParams,
        stop: StopConditions,
    ) -> Sequence:
        if not token_ids:
            raise ValueError("empty prompt")
        if len(token_ids) >= self.mc.max_seq_len:
            raise ValueError(f"prompt length {len(token_ids)} >= max_seq_len {self.mc.max_seq_len}")
        seq = Sequence(
            request_id=request_id,
            prompt=list(token_ids),
            sampling=sampling,
            stop=stop,
            eos_token_ids=self._eos,
        )
        if stop.deadline_ms is not None:
            seq.deadline_ts = seq.arrival_ts + stop.deadline_ms / 1000.0
            self._has_deadlines = True
        self.waiting.append(seq)
        self.by_id[request_id] = seq
        self.request_total += 1
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
        )

    # --- step loop core (runs in worker thread) -----------------------------
    def step(self) -> List[tuple]:
        """One scheduler iteration. Returns [(seq, StepOutput), ...].

        With sequences decoding AND prefill work at the head of the queue,
        the iteration is a MIXED step. Otherwise the phase-separated order
        runs: decode first (ITL), then admit one prefill chunk (TTFT)."""
        outputs: List[tuple] = []
        self._sweep_deadlines()
        self._reap_aborted(outputs)
        cand = self._mixed_candidate()
        if cand is not None and self._mixed_step(cand, outputs):
            return outputs
        if self.running:
            outputs.extend(self._decode_step())
        self._admit(outputs)
        return outputs

    def _mixed_candidate(self) -> Optional[Sequence]:
        """Head-of-queue sequence eligible to ride a mixed step, or None.
        Only the head is considered (FIFO); a full decode set keeps a
        not-yet-admitted head out."""
        if not (self.sc.enable_mixed_batching and self.running and self.waiting):
            return None
        head = self.waiting[0]
        if head.aborted:
            return None
        if head.state == SeqState.WAITING and len(self.running) >= self.sc.max_running:
            return None
        return head

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
        tokens = np.zeros((d_bucket,), dtype=np.int32)
        positions = np.zeros((d_bucket,), dtype=np.int32)
        active = np.zeros((d_bucket,), dtype=bool)
        for i, s in enumerate(batch):
            tokens[i] = s.all_ids[-1]
            positions[i] = s.total_len - 1
            active[i] = True
        logits, _, _ = llama.mixed_step(
            self.params, self.mc, self.cache.k, self.cache.v,
            self._dev(p_tok), len(chunk_tokens), seq.num_computed, p_table,
            self._dev(tokens), self._dev(positions), self._decode_tables(batch, d_bucket, width),
            self._dev(active),
        )
        self.forward_steps_total += 1
        self.mixed_steps_total += 1
        self.mixed_prefill_tokens_total += len(chunk_tokens)
        self.mixed_decode_tokens_total += n

        # Decode rows first (output-order parity with the phase-separated
        # decode-then-admit iteration), then the chunk's progress.
        self._finish_decode_rows(batch, d_bucket, logits[1:], outputs)
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
            token = self._sample_one(seq, logits[0])
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

    def _admit(self, outputs: List[tuple]) -> None:
        """Admit the head of the queue: one chunked prefill."""
        if not self.waiting or len(self.running) >= self.sc.max_running:
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

    def _first_touch(self, seq: Sequence, pf_tokens: List[int], total_tokens: int) -> None:
        """First admission: prefix-cache match + full block allocation,
        all-or-nothing — any acquired refs/blocks are returned before
        OutOfBlocksError propagates."""
        bs = self.mc.block_size
        try:
            if self.sc.enable_prefix_caching:
                seq.block_hashes = extend_block_hashes([], pf_tokens, bs)
                matched = self.allocator.match_prefix(seq.block_hashes)
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

    def _prefill_one(self, seq: Sequence, outputs: List[tuple]) -> bool:
        """Run one prefill chunk for ``seq``. Returns True when the prompt is
        fully computed (sequence moved to running). Preempted sequences
        resume here: ``resume_tokens`` recompute their KV, then decode
        continues — no sampling at the end of a resume."""
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
        logits, _, _ = llama.prefill(
            self.params, self.mc, self.cache.k, self.cache.v,
            self._dev(padded), len(tokens), seq.num_computed, self._prefill_table(seq),
        )
        self.forward_steps_total += 1
        seq.num_computed += len(tokens)
        self._register_full_blocks(seq)  # chunk's completed blocks go live

        if seq.num_computed < len(pf_tokens):
            return False  # more chunks to go
        seq.state = SeqState.RUNNING
        self.running.append(seq)
        self._register_full_blocks(seq)
        if resuming:
            seq.resume_tokens = None
            return True
        token = self._sample_one(seq, logits)
        self._append_token(seq, token, outputs)
        return True

    def _width_bucket(self, max_used: int) -> int:
        """Block-table width buckets at pow2 AND 1.5·pow2 rungs."""
        return width_bucket(max_used, self.max_blocks_per_seq)

    def _dev(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a).to(self.device)

    def _decode_tables(self, batch: List[Sequence], bucket: int, width: int) -> torch.Tensor:
        tables = np.zeros((bucket, width), dtype=np.int32)
        for i, s in enumerate(batch):
            tables[i, : len(s.block_ids)] = s.block_ids
        return self._dev(tables)

    def _prefill_table(self, seq: Sequence) -> torch.Tensor:
        """Prefill block table bucketed to a rung width covering the
        sequence's blocks — not padded to max_blocks_per_seq."""
        w = max(16, width_bucket(len(seq.block_ids), self.max_blocks_per_seq))
        table = np.zeros((w,), dtype=np.int32)
        table[: len(seq.block_ids)] = seq.block_ids
        return self._dev(table)

    def _decode_step(self) -> List[tuple]:
        outputs: List[tuple] = []
        # Batch size caps at the largest decode bucket; over-cap rows wait.
        n = min(len(self.running), self.sc.decode_buckets[-1])
        batch = self.running[:n]
        bucket = next_bucket(n, self.sc.decode_buckets)
        width = self._width_bucket(max(len(seq.block_ids) for seq in batch))
        tpa = np.zeros((3, bucket), dtype=np.int32)
        for i, seq in enumerate(batch):
            tpa[0, i] = seq.all_ids[-1]
            tpa[1, i] = seq.total_len - 1  # write slot of the current token
            tpa[2, i] = 1
        tpa_d = self._dev(tpa)
        logits, _, _ = llama.decode(
            self.params, self.mc, self.cache.k, self.cache.v,
            tpa_d[0], tpa_d[1], self._decode_tables(batch, bucket, width), tpa_d[2].bool(),
        )
        self.forward_steps_total += 1
        self._finish_decode_rows(batch, bucket, logits, outputs)
        return outputs

    def _finish_decode_rows(
        self, batch: List[Sequence], bucket: int, logits: torch.Tensor, outputs: List[tuple]
    ) -> None:
        """Post-forward half of a decode step: sampling, then token
        append/stop handling, growing each row's block table. Shared by
        _decode_step and _mixed_step."""
        temps, top_ks, top_ps = pack_param_rows([s.sampling for s in batch], bucket)
        sampled = sample_batch(logits, temps, top_ks, top_ps, self._gen)
        for i, seq in enumerate(batch):
            if seq.state != SeqState.RUNNING:
                continue  # preempted while growing an earlier row this step
            self._ensure_block_capacity(seq)
            if seq.state != SeqState.RUNNING:
                continue
            self._append_token(seq, int(sampled[i]), outputs)

    def _copy_block(self, src: int, dst: int) -> None:
        """Block duplication across all layers (the copy-on-write copy)."""
        self.cache.k[:, dst] = self.cache.k[:, src]
        self.cache.v[:, dst] = self.cache.v[:, src]

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
        # Recompute everything up to (not including) the last token; the
        # last token re-enters through the decode step on resume.
        victim.resume_tokens = list(victim.all_ids[:-1])
        victim.state = SeqState.WAITING
        victim.preemptions += 1
        self.preempt_total += 1
        self.waiting.insert(0, victim)
        logger.info("preempted %s (len %d) to free blocks", victim.request_id, victim.total_len)
        return True

    def _sample_one(self, seq: Sequence, logits: torch.Tensor) -> int:
        temps, top_ks, top_ps = pack_param_rows([seq.sampling], 1)
        return int(sample_batch(logits[None, :], temps, top_ks, top_ps, self._gen)[0])

    def _append_token(self, seq: Sequence, token: int, outputs: List[tuple]) -> None:
        seq.output_ids.append(token)
        # First token carries the request's queue time and its prefix-cache
        # reuse (skipped prompt tokens).
        queue_s = None
        cached = None
        if len(seq.output_ids) == 1:
            if seq.admitted_ts is not None:
                queue_s = max(0.0, seq.admitted_ts - seq.arrival_ts)
            cached = seq.cached_tokens
        reason = self._check_stop(seq, token)
        if reason is not None:
            # Token that triggered 'stop' is still emitted (backend strips).
            outputs.append(
                (seq, StepOutput(token_id=token, finished=True, finish_reason=reason,
                                 queue_s=queue_s, cached_tokens=cached))
            )
            self._finish(seq, reason, outputs, emit=False)
        else:
            outputs.append((seq, StepOutput(token_id=token, queue_s=queue_s, cached_tokens=cached)))

    def _check_stop(self, seq: Sequence, token: int) -> Optional[str]:
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
        # Extend hashes over generated tokens so completed output blocks are
        # reusable too (multi-turn: the next prompt includes them).
        if self.sc.enable_prefix_caching and reason != "cancelled":
            bs = self.mc.block_size
            seq.block_hashes = extend_block_hashes(seq.block_hashes, seq.all_ids, bs)
            n_full = len(seq.all_ids) // bs
            self.allocator.register_hashes(seq.block_ids[:n_full], seq.block_hashes[:n_full])
        self.allocator.release(seq.block_ids)
        seq.block_ids = []
        if emit:
            outputs.append((seq, StepOutput(token_id=-1, finished=True, finish_reason=reason)))
        self.by_id.pop(seq.request_id, None)
