"""OpenAI API protocol: request validation + response/chunk builders.

The chat-completions and completions part of the JAX package's
``llm/protocols/openai.py``: the same validation rules and the same
response and chunk shapes. Request fields of features this port does not
implement yet are refused with a 400 naming the field, never silently
ignored (ROADMAP Queue 1 item 10).
"""

from __future__ import annotations

import re
import time
import uuid
from typing import Any, Dict, Optional


class RequestError(ValueError):
    """400-class protocol violation."""


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise RequestError(msg)


TENANT_MAX_LEN = 64
_TENANT_RE = re.compile(r"^[A-Za-z0-9._:-]+$")

# Fields whose features are not ported yet: a request that sets one gets a
# 400 instead of an answer that quietly ignores it.
_UNSUPPORTED = (
    "logprobs", "top_logprobs", "tools", "tool_choice", "logit_bias",
    "frequency_penalty", "presence_penalty", "seed", "response_format",
)


def validate_tenant(value: Any, source: str = "user") -> str:
    """Validate a client-supplied tenant id (OpenAI ``user`` field)."""
    _require(isinstance(value, str) and bool(value), f"{source} must be a non-empty string")
    _require(len(value) <= TENANT_MAX_LEN, f"{source} must be at most {TENANT_MAX_LEN} characters")
    _require(_TENANT_RE.match(value) is not None, f"{source} may only contain [A-Za-z0-9._:-]")
    return value


def _validate_common(body: dict) -> None:
    for key in _UNSUPPORTED:
        v = body.get(key)
        _require(
            v is None or v is False or v == 0,
            f"{key} is not supported by the PyTorch/CUDA port yet",
        )
    nv = body.get("nvext") or {}
    _require(
        not any(nv.get(k) is not None for k in ("guided_regex", "guided_choice", "guided_json")),
        "guided decoding is not supported by the PyTorch/CUDA port yet",
    )
    n = body.get("n")
    _require(n is None or n == 1, "n > 1 is not supported by the PyTorch/CUDA port yet")
    for key in ("temperature", "top_p"):
        v = body.get(key)
        _require(v is None or isinstance(v, (int, float)), f"{key} must be a number")
    t = body.get("temperature")
    _require(t is None or 0.0 <= t <= 2.0, "temperature must be in [0, 2]")
    tp = body.get("top_p")
    _require(tp is None or 0.0 < tp <= 1.0, "top_p must be in (0, 1]")
    tk = body.get("top_k")
    _require(tk is None or (isinstance(tk, int) and tk >= 0), "top_k must be a non-negative integer")
    mt = body.get("max_tokens") or body.get("max_completion_tokens")
    _require(mt is None or (isinstance(mt, int) and mt > 0), "max_tokens must be a positive integer")
    to = body.get("timeout")
    _require(
        to is None or (isinstance(to, (int, float)) and not isinstance(to, bool) and 0 < to <= 3600),
        "timeout must be a number of seconds in (0, 3600]",
    )
    stop = body.get("stop")
    _require(
        stop is None or isinstance(stop, str) or (isinstance(stop, list) and all(isinstance(s, str) for s in stop)),
        "stop must be a string or array of strings",
    )
    user = body.get("user")
    if user is not None:
        validate_tenant(user, "user")


def validate_chat_request(body: dict) -> dict:
    _require(isinstance(body, dict), "body must be a JSON object")
    _require(bool(body.get("model")), "missing required field: model")
    messages = body.get("messages")
    _require(isinstance(messages, list) and len(messages) > 0, "messages must be a non-empty array")
    for m in messages:
        _require(isinstance(m, dict) and "role" in m, "each message needs a role")
        _require(m["role"] in ("system", "user", "assistant", "tool", "developer"), f"invalid role {m['role']!r}")
        _require(
            isinstance(m.get("content", ""), str),
            "message content must be a string (content parts are not supported by the port yet)",
        )
    _validate_common(body)
    return body


def validate_completion_request(body: dict) -> dict:
    _require(isinstance(body, dict), "body must be a JSON object")
    _require(bool(body.get("model")), "missing required field: model")
    prompt = body.get("prompt")
    _require(
        isinstance(prompt, str)
        or (isinstance(prompt, list) and all(isinstance(p, (str, int)) for p in prompt)),
        "prompt must be a string, array of strings, or array of token ids",
    )
    _validate_common(body)
    return body


def sampling_from_request(body: dict) -> Dict[str, Any]:
    return {k: body.get(k) for k in ("temperature", "top_p", "top_k") if body.get(k) is not None}


def stop_conditions_from_request(body: dict) -> Dict[str, Any]:
    stop = body.get("stop")
    if isinstance(stop, str):
        stop = [stop]
    return {
        "max_tokens": body.get("max_tokens") or body.get("max_completion_tokens"),
        "min_tokens": body.get("min_tokens"),
        "stop": stop or [],
        "stop_token_ids": body.get("stop_token_ids") or [],
        "ignore_eos": bool((body.get("nvext") or {}).get("ignore_eos", False)),
    }


# --- response builders ------------------------------------------------------


def make_id(prefix: str = "chatcmpl") -> str:
    return f"{prefix}-{uuid.uuid4().hex[:24]}"


def chat_chunk(
    rid: str,
    model: str,
    delta: dict,
    finish_reason: Optional[str] = None,
    usage: Optional[dict] = None,
    index: int = 0,
) -> dict:
    out = {
        "id": rid,
        "object": "chat.completion.chunk",
        "created": int(time.time()),
        "model": model,
        "choices": [{"index": index, "delta": delta, "finish_reason": finish_reason}],
    }
    if usage is not None:
        out["usage"] = usage
    return out


def chat_choice(index: int, text: str, finish_reason: str) -> dict:
    return {
        "index": index,
        "message": {"role": "assistant", "content": text},
        "finish_reason": finish_reason,
    }


def chat_response(rid: str, model: str, text: str, finish_reason: str, usage: dict) -> dict:
    return {
        "id": rid,
        "object": "chat.completion",
        "created": int(time.time()),
        "model": model,
        "choices": [chat_choice(0, text, finish_reason)],
        "usage": usage,
    }


def completion_chunk(
    rid: str, model: str, text: str, finish_reason: Optional[str] = None, index: int = 0
) -> dict:
    return {
        "id": rid,
        "object": "text_completion",
        "created": int(time.time()),
        "model": model,
        "choices": [{"index": index, "text": text, "finish_reason": finish_reason}],
    }


def completion_choice(index: int, text: str, finish_reason: str) -> dict:
    return {"index": index, "text": text, "finish_reason": finish_reason}


def completion_response(rid: str, model: str, text: str, finish_reason: str, usage: dict) -> dict:
    return {
        "id": rid,
        "object": "text_completion",
        "created": int(time.time()),
        "model": model,
        "choices": [completion_choice(0, text, finish_reason)],
        "usage": usage,
    }


def usage_dict(
    prompt_tokens: int,
    completion_tokens: int,
    cached_tokens: Optional[int] = None,
    tenant: Optional[str] = None,
) -> dict:
    """OpenAI usage block. ``cached_tokens`` (engine-reported prefix-cache
    reuse) renders as ``prompt_tokens_details.cached_tokens`` when known."""
    out = {
        "prompt_tokens": prompt_tokens,
        "completion_tokens": completion_tokens,
        "total_tokens": prompt_tokens + completion_tokens,
    }
    if cached_tokens is not None:
        out["prompt_tokens_details"] = {"cached_tokens": int(cached_tokens)}
    if tenant is not None:
        out["tenant"] = tenant
    return out


def error_body(message: str, err_type: str = "invalid_request_error", code: int = 400) -> dict:
    return {"error": {"message": message, "type": err_type, "code": code}}
