"""OpenAI API protocol: request validation + response/chunk builders.

The chat-completions and completions part of the JAX package's
``llm/protocols/openai.py``: the same validation rules and messages and
the same response and chunk shapes, the per-request extras among them
(``logprobs`` / ``top_logprobs``, penalties, ``logit_bias``, ``n`` up to
``MAX_N``, ``tools`` / ``tool_choice``, structured outputs through
``response_format`` and ``nvext.guided_*``). Beyond the JAX checks the
port validates ``top_k``, bounds ``seed`` to the scheduler's 32-bit key
rows and takes message content as a string (content parts wait for the
multimodal path).
"""

from __future__ import annotations

import re
import time
import uuid
from typing import Any, Dict, List, Optional


class RequestError(ValueError):
    """400-class protocol violation."""


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise RequestError(msg)


TENANT_MAX_LEN = 64
_TENANT_RE = re.compile(r"^[A-Za-z0-9._:-]+$")

MAX_N = 8  # per-request choice fan-out cap (each choice is a full generation)
# Seeds go into a 32-bit signed row of the scheduler's key table.
SEED_MIN, SEED_MAX = -(2**31), 2**31 - 1


def validate_tenant(value: Any, source: str = "user") -> str:
    """Validate a client-supplied tenant id (OpenAI ``user`` field)."""
    _require(isinstance(value, str) and bool(value), f"{source} must be a non-empty string")
    _require(len(value) <= TENANT_MAX_LEN, f"{source} must be at most {TENANT_MAX_LEN} characters")
    _require(_TENANT_RE.match(value) is not None, f"{source} may only contain [A-Za-z0-9._:-]")
    return value


def _validate_common(body: dict) -> None:
    _validate_guided_ext(body)
    _validate_response_format(body)
    n = body.get("n")
    _require(
        n is None or (isinstance(n, int) and 1 <= n <= MAX_N),
        f"n must be an integer in [1, {MAX_N}]",
    )
    for key in ("temperature", "top_p", "frequency_penalty", "presence_penalty"):
        v = body.get(key)
        _require(v is None or isinstance(v, (int, float)), f"{key} must be a number")
    t = body.get("temperature")
    _require(t is None or 0.0 <= t <= 2.0, "temperature must be in [0, 2]")
    tp = body.get("top_p")
    _require(tp is None or 0.0 < tp <= 1.0, "top_p must be in (0, 1]")
    tk = body.get("top_k")
    _require(tk is None or (isinstance(tk, int) and tk >= 0), "top_k must be a non-negative integer")
    seed = body.get("seed")
    _require(seed is None or (isinstance(seed, int) and not isinstance(seed, bool)), "seed must be an integer")
    _require(seed is None or SEED_MIN <= seed <= SEED_MAX, f"seed must be an integer in [{SEED_MIN}, {SEED_MAX}]")
    # Choice i of an n > 1 request draws with seed + i (llm/http/service.py).
    _require(seed is None or seed + (n or 1) - 1 <= SEED_MAX, f"seed + n - 1 must be at most {SEED_MAX}")
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
    lb = body.get("logit_bias")
    if lb is not None:
        _require(isinstance(lb, dict), "logit_bias must be an object mapping token ids to bias")
        for k, v in lb.items():
            _require(
                isinstance(k, (str, int)) and str(k).lstrip("-").isdigit(),
                "logit_bias keys must be token ids",
            )
            _require(
                isinstance(v, (int, float)) and not isinstance(v, bool) and -100.0 <= v <= 100.0,
                "logit_bias values must be numbers in [-100, 100]",
            )


RESPONSE_FORMAT_TYPES = ("text", "json_object", "json_schema")


def _validate_response_format(body: dict) -> None:
    """Structural response_format checks. Schema *compilability* is checked
    by the preprocessor's grammar build; both raise RequestError, so a
    malformed constraint is always a structured 400, never a 500."""
    rf = body.get("response_format")
    if rf is None:
        return
    _require(
        isinstance(rf, dict) and isinstance(rf.get("type"), str),
        "response_format must be an object with a string 'type'",
    )
    _require(
        rf["type"] in RESPONSE_FORMAT_TYPES,
        f"response_format.type must be one of {list(RESPONSE_FORMAT_TYPES)}",
    )
    if rf["type"] == "json_schema":
        js = rf.get("json_schema")
        _require(isinstance(js, dict), "response_format.json_schema must be an object")
        _require(
            isinstance(js.get("schema"), dict),
            "response_format.json_schema.schema is required and must be an object",
        )
        name = js.get("name")
        _require(name is None or isinstance(name, str), "json_schema.name must be a string")


def _validate_tools(body: dict) -> None:
    tools = body.get("tools")
    if tools is None:
        return
    _require(isinstance(tools, list), "tools must be an array")
    for t in tools:
        _require(
            isinstance(t, dict) and t.get("type") == "function" and isinstance(t.get("function"), dict),
            "each tool must be {type: 'function', function: {...}}",
        )
        fn = t["function"]
        _require(isinstance(fn.get("name"), str) and bool(fn["name"]), "tool function.name is required")
        params = fn.get("parameters")
        _require(params is None or isinstance(params, dict), "tool function.parameters must be an object")


def _tool_names(body: dict) -> List[str]:
    return [(t.get("function") or {}).get("name") for t in (body.get("tools") or []) if isinstance(t, dict)]


def _validate_tool_choice(body: dict) -> None:
    tc = body.get("tool_choice")
    if tc is None:
        return
    if isinstance(tc, str):
        _require(
            tc in ("none", "auto", "required"),
            "tool_choice must be 'none', 'auto', 'required', or {type:'function',function:{name}}",
        )
        _require(
            tc != "required" or bool(body.get("tools")),
            "tool_choice 'required' needs a non-empty tools array",
        )
        return
    _require(
        isinstance(tc, dict)
        and tc.get("type") == "function"
        and isinstance(tc.get("function"), dict)
        and isinstance(tc["function"].get("name"), str),
        "named tool_choice must be {type: 'function', function: {name: ...}}",
    )
    name = tc["function"]["name"]
    _require(name in _tool_names(body), f"tool_choice names unknown tool {name!r}")


def _validate_guided_ext(body: dict) -> None:
    """nvext guided-decoding extensions (guided_regex / guided_choice /
    guided_json) — structural checks; at most one constraint per request."""
    nv = body.get("nvext") or {}
    gr = nv.get("guided_regex")
    _require(gr is None or (isinstance(gr, str) and bool(gr)), "nvext.guided_regex must be a non-empty string")
    gc = nv.get("guided_choice")
    _require(
        gc is None
        or (isinstance(gc, list) and len(gc) > 0 and all(isinstance(c, str) and c for c in gc)),
        "nvext.guided_choice must be a non-empty array of strings",
    )
    gj = nv.get("guided_json")
    _require(gj is None or isinstance(gj, dict), "nvext.guided_json must be a schema object")
    _require(
        sum(x is not None for x in (gr, gc, gj)) <= 1,
        "at most one nvext guided_* constraint per request",
    )


def validate_chat_request(body: dict) -> dict:
    _require(isinstance(body, dict), "body must be a JSON object")
    _require(bool(body.get("model")), "missing required field: model")
    messages = body.get("messages")
    _require(isinstance(messages, list) and len(messages) > 0, "messages must be a non-empty array")
    for m in messages:
        _require(isinstance(m, dict) and "role" in m, "each message needs a role")
        _require(m["role"] in ("system", "user", "assistant", "tool", "developer"), f"invalid role {m['role']!r}")
        # None: an assistant message that only calls tools.
        _require(
            m.get("content") is None or isinstance(m["content"], str),
            "message content must be a string (content parts are not supported by the port yet)",
        )
    _validate_common(body)
    lp = body.get("logprobs")
    _require(lp is None or isinstance(lp, bool), "logprobs must be a boolean")
    tlp = body.get("top_logprobs")
    _require(
        tlp is None or (isinstance(tlp, int) and 0 <= tlp <= 20),
        "top_logprobs must be an integer in [0, 20]",
    )
    _require(tlp is None or bool(lp), "top_logprobs requires logprobs: true")
    _validate_tools(body)
    _validate_tool_choice(body)
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
    lp = body.get("logprobs")
    _require(
        lp is None or (isinstance(lp, int) and 0 <= lp <= 5),
        "logprobs must be an integer in [0, 5]",
    )
    return body


def sampling_from_request(body: dict) -> Dict[str, Any]:
    out = {
        k: body.get(k)
        for k in ("temperature", "top_p", "top_k", "seed", "frequency_penalty", "presence_penalty")
        if body.get(k) is not None
    }
    # Chat sends a boolean, completions a count; either turns on the chosen
    # tokens' logprobs (completions ``logprobs: 0`` too: only absent or
    # false is off).
    lp = body.get("logprobs")
    if lp is not None and lp is not False:
        out["logprobs"] = True
    tlp = body.get("top_logprobs")
    if tlp:
        out["top_logprobs"] = int(tlp)
    elif isinstance(lp, int) and not isinstance(lp, bool) and lp > 0:
        # Completions: the logprobs count is also the alternatives' count.
        out["top_logprobs"] = int(lp)
    lb = body.get("logit_bias")
    if lb:
        # Keys as ints on the wire (OpenAI clients send strings).
        out["logit_bias"] = {int(k): float(v) for k, v in lb.items()}
    return out


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


def _top_entries(alts: Optional[list]) -> List[dict]:
    """Alternative-token entries of one position from the wire shape
    [[alt_token_id, logprob], ...]. Alternatives are named by id
    (``token_id:<n>``): a token never generated into the stream has no
    meaningful detokenization of its own, and the id is lossless."""
    if not alts:
        return []
    return [{"token": f"token_id:{int(tid)}", "logprob": float(lp), "bytes": None} for tid, lp in alts]


def chat_logprobs_content(
    text: Optional[str], logprobs: List[float], top_logprobs: Optional[List[list]] = None
) -> dict:
    """Chat logprobs block of one delta or message: one entry per generated
    token, with its alternatives where the engine computed them
    (``top_logprobs``: [[alt_token_id, logprob], ...] per token, aligned
    with ``logprobs``)."""
    toks = [text] if (text and len(logprobs) == 1) else [""] * len(logprobs)
    tops = top_logprobs or []
    return {
        "content": [
            {
                "token": t,
                "logprob": lp,
                "bytes": list(t.encode()) if t else None,
                "top_logprobs": _top_entries(tops[i] if i < len(tops) else None),
            }
            for i, (t, lp) in enumerate(zip(toks, logprobs))
        ]
    }


def completion_logprobs_block(
    texts: List[str], logprobs: List[float], top_logprobs: Optional[List[list]] = None
) -> dict:
    """Completions-style logprobs arrays (tokens / token_logprobs), without
    ``text_offset`` (character offsets are not tracked through streaming
    detokenization). ``top_logprobs`` is the legacy per-position dict of
    alternatives where the engine computed them, else None."""
    tops = None
    if top_logprobs:
        tops = [{e["token"]: e["logprob"] for e in _top_entries(alts)} for alts in top_logprobs]
        # Padded into line with tokens if the engine gave fewer positions.
        while len(tops) < len(logprobs):
            tops.append({})
    return {"tokens": texts, "token_logprobs": logprobs, "top_logprobs": tops}


def chat_chunk(
    rid: str,
    model: str,
    delta: dict,
    finish_reason: Optional[str] = None,
    usage: Optional[dict] = None,
    index: int = 0,
    logprobs: Optional[dict] = None,
) -> dict:
    choice = {"index": index, "delta": delta, "finish_reason": finish_reason}
    if logprobs is not None:
        choice["logprobs"] = logprobs
    out = {
        "id": rid,
        "object": "chat.completion.chunk",
        "created": int(time.time()),
        "model": model,
        "choices": [choice],
    }
    if usage is not None:
        out["usage"] = usage
    return out


def chat_choice(
    index: int,
    text: str,
    finish_reason: str,
    tool_calls: Optional[list] = None,
    reasoning: Optional[str] = None,
    logprobs: Optional[dict] = None,
) -> dict:
    message: dict = {"role": "assistant", "content": text}
    if tool_calls:
        message["tool_calls"] = tool_calls
        message["content"] = text or None
    if reasoning:
        message["reasoning_content"] = reasoning
    choice = {"index": index, "message": message, "finish_reason": finish_reason}
    if logprobs is not None:
        choice["logprobs"] = logprobs
    return choice


def chat_response_multi(rid: str, model: str, choices: List[dict], usage: dict) -> dict:
    return {
        "id": rid,
        "object": "chat.completion",
        "created": int(time.time()),
        "model": model,
        "choices": choices,
        "usage": usage,
    }


def chat_response(
    rid: str,
    model: str,
    text: str,
    finish_reason: str,
    usage: dict,
    tool_calls: Optional[list] = None,
    reasoning: Optional[str] = None,
    logprobs: Optional[dict] = None,
) -> dict:
    return chat_response_multi(rid, model, [chat_choice(0, text, finish_reason, tool_calls, reasoning, logprobs)],
                               usage)


def completion_chunk(
    rid: str,
    model: str,
    text: str,
    finish_reason: Optional[str] = None,
    index: int = 0,
    logprobs: Optional[dict] = None,
) -> dict:
    choice = {"index": index, "text": text, "finish_reason": finish_reason}
    if logprobs is not None:
        choice["logprobs"] = logprobs
    return {
        "id": rid,
        "object": "text_completion",
        "created": int(time.time()),
        "model": model,
        "choices": [choice],
    }


def completion_choice(index: int, text: str, finish_reason: str, logprobs: Optional[dict] = None) -> dict:
    choice = {"index": index, "text": text, "finish_reason": finish_reason}
    if logprobs is not None:
        choice["logprobs"] = logprobs
    return choice


def completion_response_multi(rid: str, model: str, choices: List[dict], usage: dict) -> dict:
    return {
        "id": rid,
        "object": "text_completion",
        "created": int(time.time()),
        "model": model,
        "choices": choices,
        "usage": usage,
    }


def completion_response(
    rid: str, model: str, text: str, finish_reason: str, usage: dict, logprobs: Optional[dict] = None
) -> dict:
    return completion_response_multi(rid, model, [completion_choice(0, text, finish_reason, logprobs)], usage)


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
