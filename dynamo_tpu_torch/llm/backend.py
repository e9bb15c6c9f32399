"""Backend operator: incremental detokenization + stop-string jailing.

Sits between the engine stream (token ids) and the frontend (text deltas).

Stop-string jail: generated text that could be the beginning of a stop
string is withheld until it either completes the stop string (sequence
ends, jailed text dropped) or diverges (jailed text released). Tool-call
and reasoning parsers are not ported yet (ROADMAP Queue 1 item 10).
"""

from __future__ import annotations

from typing import AsyncIterator, List, Optional, Sequence

from dynamo_tpu_torch.llm.protocols.common import LLMEngineOutput
from dynamo_tpu_torch.llm.tokenizer import DecodeStream, Tokenizer
from dynamo_tpu_torch.runtime.engine import Annotated, Context
from dynamo_tpu_torch.runtime.pipeline import Operator


class StopStringJail:
    def __init__(self, stop_strings: Sequence[str]):
        self.stops = [s for s in stop_strings if s]
        self._held = ""

    def feed(self, delta: str) -> tuple[Optional[str], bool]:
        """Returns (text_to_emit_or_None, hit). On hit, held text before the
        stop string is emitted and the stop string itself is dropped."""
        if not self.stops:
            return delta, False
        buf = self._held + delta
        for s in self.stops:
            idx = buf.find(s)
            if idx != -1:
                self._held = ""
                return (buf[:idx] or None), True
        # Hold the longest tail that is a proper prefix of any stop string.
        hold = 0
        for s in self.stops:
            for k in range(min(len(s) - 1, len(buf)), 0, -1):
                if buf.endswith(s[:k]):
                    hold = max(hold, k)
                    break
        if hold:
            self._held = buf[-hold:]
            emit = buf[:-hold]
        else:
            self._held = ""
            emit = buf
        return (emit or None), False

    def flush(self) -> str:
        held, self._held = self._held, ""
        return held


class Backend(Operator):
    """Attaches ``text`` to engine output frames by detokenizing incrementally."""

    def __init__(self, tokenizer: Tokenizer):
        self.tokenizer = tokenizer

    def transform_response(self, stream: AsyncIterator, request: dict, context: Context) -> AsyncIterator:
        stop_conditions = request.get("stop_conditions") or {}
        stop_strings: List[str] = list(stop_conditions.get("stop") or [])
        # EOS/stop tokens are stripped from text output.
        skip_ids = set(self.tokenizer.eos_token_ids) | set(stop_conditions.get("stop_token_ids") or [])
        decoder = DecodeStream(self.tokenizer, skip_token_ids=skip_ids)
        jail = StopStringJail(stop_strings)

        def finalize(
            out: LLMEngineOutput, emit_text: Optional[str], finish: str, *, include_tail: bool = True
        ) -> LLMEngineOutput:
            """The final frame. On a stop-string hit the detokenizer/jail
            tails are at/after the stop string and are dropped."""
            tail = (decoder.flush() + jail.flush()) if include_tail else ""
            text = (emit_text or "") + tail
            return LLMEngineOutput(token_ids=out.token_ids, text=text or None, finish_reason=finish, index=out.index)

        async def gen():
            async for item in stream:
                if isinstance(item, Annotated) and item.is_annotation():
                    yield item
                    continue
                wire = item.data if isinstance(item, Annotated) else item
                out = LLMEngineOutput.from_wire(wire)
                if isinstance(wire, dict) and wire.get("queue_s") is not None:
                    # Engine admission queue time (first frame).
                    yield Annotated(event="_queue", comment=str(wire["queue_s"]))
                if isinstance(wire, dict) and wire.get("cached_tokens") is not None:
                    # Prefix-cache reuse (first frame): reported by the
                    # frontend as usage.prompt_tokens_details.cached_tokens.
                    yield Annotated(event="_cached", comment=str(wire["cached_tokens"]))
                delta = decoder.step(out.token_ids) if out.token_ids else ""
                emit_text, hit = jail.feed(delta) if delta else (None, False)
                if hit:
                    yield Annotated(data=finalize(out, emit_text, "stop", include_tail=False).to_wire())
                    context.stop_generating()  # propagate abort to the engine
                    return
                if out.finish_reason:
                    yield Annotated(data=finalize(out, emit_text, out.finish_reason).to_wire())
                    return
                if emit_text or out.token_ids:
                    yield Annotated(
                        data=LLMEngineOutput(token_ids=out.token_ids, text=emit_text, index=out.index).to_wire()
                    )

        return gen()
