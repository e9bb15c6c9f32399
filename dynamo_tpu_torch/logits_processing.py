"""Logits processing: per-request processors applied before sampling.

The JAX package's ``logits_processing`` on torch tensors. A processor is
either a :class:`BaseLogitsProcessor` (any callable of the running token
history and one row's logits ``[V]``, returning new logits) or a
:class:`DeviceLogitsProcessor`, a pure tensor function of (logits,
history, history length). The scheduler applies a row's chain on the
logits' device, between the forward and the draw; the JAX scheduler
crosses to the host for the same rows and computes the same function.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Protocol, Sequence, runtime_checkable

import torch


@runtime_checkable
class BaseLogitsProcessor(Protocol):
    """Called with the running token history and one row's logits ``[V]``;
    returns the adjusted logits (a new tensor on the same device)."""

    def __call__(self, token_ids: Sequence[int], logits: torch.Tensor) -> torch.Tensor:
        ...


class DeviceLogitsProcessor:
    """A processor written as tensor operations over fixed shapes.

    ``apply(logits, history, history_len)``: logits ``[V]`` f32, history
    ``[H]`` int (generated ids, -1 padded), history_len a scalar."""

    def apply(self, logits: torch.Tensor, history, history_len) -> torch.Tensor:
        raise NotImplementedError


# --- stock processors -------------------------------------------------------


@dataclass
class TemperatureProcessor(DeviceLogitsProcessor):
    temperature: float = 1.0

    def apply(self, logits, history, history_len):
        return logits / max(self.temperature, 1e-6)

    def __call__(self, token_ids, logits):
        return self.apply(logits, None, None)


@dataclass
class RepetitionPenaltyProcessor(DeviceLogitsProcessor):
    """HF-style repetition penalty over the generated tokens: a seen token's
    logit is divided (if > 0) or multiplied (if < 0) by ``penalty``."""

    penalty: float = 1.1

    def apply(self, logits, history, history_len):
        V = logits.shape[-1]
        hist = torch.where(history >= 0, history, V).long()  # pad → the out-of-range slot
        seen = torch.zeros((V + 1,), dtype=torch.bool, device=logits.device).index_fill(0, hist, True)[:V]
        penalized = torch.where(logits > 0, logits / self.penalty, logits * self.penalty)
        return torch.where(seen, penalized, logits)

    def __call__(self, token_ids, logits):
        hist = torch.tensor(list(token_ids) or [-1], dtype=torch.int32, device=logits.device)
        return self.apply(logits, hist, len(token_ids))


@dataclass
class MinPProcessor(DeviceLogitsProcessor):
    """min-p: drop tokens whose probability is below ``min_p`` × the
    largest."""

    min_p: float = 0.05

    def apply(self, logits, history, history_len):
        probs = torch.softmax(logits, dim=-1)
        cutoff = self.min_p * probs.amax(dim=-1, keepdim=True)
        return torch.where(probs >= cutoff, logits, -float("inf"))

    def __call__(self, token_ids, logits):
        return self.apply(logits, None, None)


class LogitBiasProcessor(DeviceLogitsProcessor):
    """OpenAI ``logit_bias``: a per-token additive bias before sampling
    (-100 in effect bans a token, +100 in effect forces it among the
    biased ones). Ids outside the vocabulary are clipped into it and their
    bias zeroed, as in JAX. The id and bias tensors are made once per
    request and kept on the device the logits come from."""

    def __init__(self, bias: dict):
        # {token_id: bias}; string keys (raw OpenAI JSON) are accepted.
        ids = [int(k) for k in bias.keys()]
        vals = [float(v) for v in bias.values()]
        self.ids = torch.tensor(ids or [0], dtype=torch.int32)
        self.vals = torch.tensor(vals or [0.0], dtype=torch.float32)
        self.empty = not ids

    def apply(self, logits, history, history_len):
        if self.empty:
            return logits
        if self.ids.device != logits.device:
            self.ids, self.vals = self.ids.to(logits.device), self.vals.to(logits.device)
        V = logits.shape[-1]
        ids = self.ids.clamp(0, V - 1).long()
        keep = (self.ids >= 0) & (self.ids < V)
        return logits.index_add(0, ids, torch.where(keep, self.vals, 0.0).to(logits.dtype))

    def __call__(self, token_ids, logits):
        return self.apply(logits, None, None)


@dataclass
class AllowedTokensProcessor(DeviceLogitsProcessor):
    """Constrain sampling to an allow-list."""

    allowed: Sequence[int] = ()

    def apply(self, logits, history, history_len):
        V = logits.shape[-1]
        idx = torch.tensor(list(self.allowed), dtype=torch.long, device=logits.device)
        mask = torch.zeros((V,), dtype=torch.bool, device=logits.device).index_fill(0, idx, True)
        return torch.where(mask, logits, -float("inf"))

    def __call__(self, token_ids, logits):
        return self.apply(logits, None, None)


def apply_chain(
    processors: List[BaseLogitsProcessor],
    token_ids: Sequence[int],
    logits: torch.Tensor,
) -> torch.Tensor:
    for proc in processors:
        logits = proc(token_ids, logits)
    return logits
