"""OpenAI→internal preprocessing: chat template render + tokenization +
sampling/stop extraction.

Runs as a pipeline Operator in front of the engine so the engine only ever
sees token ids (PreprocessedRequest). The JAX package renders chat
templates with jinja2, which is not assumed to be installed here: the
default template is rendered in plain Python, byte-identical to the JAX
``PromptFormatter`` for messages whose content is a string. Model-specific
templates (from a tokenizer's config) wait for tokenizer loading
(ROADMAP Queue 1 item 12).
"""

from __future__ import annotations

from typing import AsyncIterator, List, Optional, Tuple

from dynamo_tpu_torch.llm.protocols.common import PreprocessedRequest
from dynamo_tpu_torch.llm.protocols.openai import sampling_from_request, stop_conditions_from_request
from dynamo_tpu_torch.llm.tokenizer import Tokenizer
from dynamo_tpu_torch.runtime.engine import Annotated, Context
from dynamo_tpu_torch.runtime.pipeline import Operator

# The JAX package's generic fallback template, kept as its source text for
# reference; ``render_default_chat_template`` is its plain-Python rendering.
DEFAULT_CHAT_TEMPLATE = (
    "{% for message in messages %}"
    "<|{{ message.role }}|>\n{{ message.content }}\n"
    "{% endfor %}"
    "{% if add_generation_prompt %}<|assistant|>\n{% endif %}"
)

ANNOTATION_FORMATTED_PROMPT = "formatted_prompt"
ANNOTATION_TOKEN_IDS = "token_ids"


def render_default_chat_template(messages: List[dict], add_generation_prompt: bool = True) -> str:
    """``DEFAULT_CHAT_TEMPLATE`` rendered without jinja2: one
    ``<|role|>\\ncontent\\n`` block per message, then the assistant header.
    A message without content renders it empty, as jinja2's undefined does."""
    parts = [f"<|{m['role']}|>\n{m.get('content', '')}\n" for m in messages]
    if add_generation_prompt:
        parts.append("<|assistant|>\n")
    return "".join(parts)


class OpenAIPreprocessor(Operator):
    """Chat/completion request → PreprocessedRequest (wire dict)."""

    def __init__(self, tokenizer: Tokenizer, *, default_max_tokens: int = 512):
        self.tokenizer = tokenizer
        self.default_max_tokens = default_max_tokens

    # --- Operator interface -------------------------------------------------
    async def transform_request(self, request: dict, context: Context) -> dict:
        req, prompt = self.preprocess(request)
        wire = req.to_wire()
        # Side-band for the response annotation path; engines ignore it.
        wire["_formatted_prompt"] = prompt
        return wire

    def transform_response(self, stream: AsyncIterator, request: dict, context: Context) -> AsyncIterator:
        annotations = request.get("annotations") or []

        async def gen():
            # Internal metrics annotation (the HTTP service's usage block
            # reads the prompt length from it; "_"-prefixed events are
            # never sent to clients).
            yield Annotated(event="_metrics", comment=str(len(request.get("token_ids") or [])))
            if ANNOTATION_FORMATTED_PROMPT in annotations and request.get("_formatted_prompt") is not None:
                yield Annotated(event=ANNOTATION_FORMATTED_PROMPT, comment=request["_formatted_prompt"])
            if ANNOTATION_TOKEN_IDS in annotations:
                yield Annotated(event=ANNOTATION_TOKEN_IDS, comment=str(request.get("token_ids")))
            async for item in stream:
                yield item

        return gen()

    # --- core ---------------------------------------------------------------
    def preprocess(self, body: dict) -> Tuple[PreprocessedRequest, Optional[str]]:
        if "messages" in body:
            prompt = render_default_chat_template(body["messages"], add_generation_prompt=True)
            token_ids = self.tokenizer.encode(prompt)
        else:
            raw = body.get("prompt", "")
            if isinstance(raw, list) and raw and isinstance(raw[0], int):
                prompt, token_ids = None, list(raw)
            else:
                prompt = raw if isinstance(raw, str) else "\n".join(raw)
                token_ids = self.tokenizer.encode(prompt)

        nvext = body.get("nvext") or {}
        stop_conditions = stop_conditions_from_request(body)
        if stop_conditions.get("max_tokens") is None:
            stop_conditions["max_tokens"] = self.default_max_tokens
        # Request deadline: client ``timeout`` (seconds) becomes a deadline
        # budget the scheduler enforces by evicting past-deadline rows.
        timeout_s = body.get("timeout")
        if timeout_s:
            stop_conditions["deadline_ms"] = float(timeout_s) * 1000.0
        return PreprocessedRequest(
            token_ids=token_ids,
            sampling_options=sampling_from_request(body),
            stop_conditions=stop_conditions,
            annotations=list(nvext.get("annotations") or []),
            model=body.get("model", ""),
            tenant=body.get("_tenant") or body.get("user") or "anon",
        ), prompt
