"""Backend operator: incremental detokenization + stop-string jailing.

Sits between the engine stream (token ids) and the frontend (text deltas).

Stop-string jail: generated text that could be the beginning of a stop
string is withheld until it either completes the stop string (sequence
ends, jailed text dropped) or diverges (jailed text released). With
``parser_options`` on the request (the preprocessor sets them), a
tool-call jail (llm/parsers) withholds text that may open a tool call and
turns it into OpenAI ``tool_calls`` on the final frame (finish reason
``tool_calls``), and a reasoning parser splits ``reasoning`` deltas off
the text. Logprobs pass through on each frame. A request that still
carries image parts (``_mm_image_urls``: no encode stage ran) is refused
with a ``RequestError``.
"""

from __future__ import annotations

from typing import AsyncIterator, List, Optional, Sequence

from dynamo_tpu_torch.llm.parsers import StreamingToolCallJail, get_reasoning_parser, get_tool_parser
from dynamo_tpu_torch.llm.parsers.tool_calling import ToolCallConfig
from dynamo_tpu_torch.llm.protocols.common import LLMEngineOutput
from dynamo_tpu_torch.llm.protocols.openai import RequestError
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

    async def transform_request(self, request, context: Context):
        # An EncodeOperator upstream consumes the images: a pipeline without
        # one refuses an image request rather than answer its text alone.
        if isinstance(request, dict) and request.get("_mm_image_urls"):
            raise RequestError("request carries image content but no encode path is "
                               "configured (frontend --encode-component / pipeline encoder)")
        return request

    def transform_response(self, stream: AsyncIterator, request: dict, context: Context) -> AsyncIterator:
        stop_conditions = request.get("stop_conditions") or {}
        stop_strings: List[str] = list(stop_conditions.get("stop") or [])
        # EOS/stop tokens are stripped from text output.
        skip_ids = set(self.tokenizer.eos_token_ids) | set(stop_conditions.get("stop_token_ids") or [])
        decoder = DecodeStream(self.tokenizer, skip_token_ids=skip_ids)
        jail = StopStringJail(stop_strings)
        parser_jail = _build_parser_jail(request.get("parser_options"))

        def finalize(
            out: LLMEngineOutput, emit_text: Optional[str], finish: str, *, include_tail: bool = True
        ) -> LLMEngineOutput:
            """The final frame, with the parsers' results folded in. On a
            stop-string hit the detokenizer/jail tails are at/after the stop
            string and are dropped."""
            tail = (decoder.flush() + jail.flush()) if include_tail else ""
            text = (emit_text or "") + tail
            tool_calls = None
            reasoning = None
            if parser_jail is not None:
                r0, c0 = parser_jail.feed(text) if text else ("", text)
                r1, c1, calls = parser_jail.finish()
                reasoning = (r0 + r1) or None
                text = c0 + c1
                if calls:
                    tool_calls = [c.to_openai() for c in calls]
                    finish = "tool_calls"
            return LLMEngineOutput(token_ids=out.token_ids, text=text or None, finish_reason=finish,
                                   logprobs=out.logprobs, top_logprobs=out.top_logprobs, index=out.index,
                                   tool_calls=tool_calls, reasoning=reasoning)

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
                reasoning_delta = None
                if parser_jail is not None and emit_text:
                    r, c = parser_jail.feed(emit_text)
                    reasoning_delta, emit_text = (r or None), (c or None)
                if emit_text or reasoning_delta or out.token_ids:
                    yield Annotated(
                        data=LLMEngineOutput(token_ids=out.token_ids, text=emit_text, logprobs=out.logprobs,
                                             top_logprobs=out.top_logprobs, index=out.index,
                                             reasoning=reasoning_delta).to_wire()
                    )

        return gen()


def _build_parser_jail(parser_options: Optional[dict]) -> Optional[StreamingToolCallJail]:
    """The request's tool-call jail and reasoning parser (None without
    ``parser_options``). With no named tool parser, bare JSON calls are
    not taken for tool calls."""
    if not parser_options:
        return None
    tool_name = parser_options.get("tool_call_parser")
    reasoning_name = parser_options.get("reasoning_parser")
    config = get_tool_parser(tool_name) if tool_name else ToolCallConfig(format="json", allow_bare_json=False)
    reasoning = get_reasoning_parser(reasoning_name) if reasoning_name else None
    return StreamingToolCallJail(config=config, reasoning=reasoning)
