"""The port's guided-decoding modules (``dynamo_tpu_torch.llm.guided``)
against the JAX package's.

1. Grammar: the regex, choice and JSON-schema cases of the JAX guided
   tests compile to the same patterns and the same character DFAs
   (transitions, accepting states, start), and the same constraints are
   rejected with the same messages.
2. FSM: the token FSMs over ``ByteTokenizer``'s strings at V = 256 and at
   llama-3.2-1b's V = 128256 (ids above 255 decode to their low byte) have
   the same ``next_state``, ``allow_words``, ``accepting`` and
   ``accept_only``, bit for bit.
3. Pool: after several registrations and a doubling of the capacity the
   port's device tables equal the JAX ``device()`` and ``next_device()``
   element for element (the port writes only each new grammar's rows).
4. Cursor: ``GuidedState`` walks (valid tokens, EOS, a dead token) give the
   same ``row_id``, ``exhausted`` and ``finished`` at every token, and
   ``GuidedDecoder`` caches and counts as JAX's does.
"""

import sys
import threading

import numpy as np
import pytest
import torch

from dynamo_tpu.llm.guided import fsm as jfsm
from dynamo_tpu.llm.guided import grammar as jgrammar
from dynamo_tpu.llm.guided import processor as jproc
from dynamo_tpu.llm.protocols import openai as joai
from dynamo_tpu_torch.llm.guided import fsm as tfsm
from dynamo_tpu_torch.llm.guided import grammar as tgrammar
from dynamo_tpu_torch.llm.guided import processor as tproc
from dynamo_tpu_torch.llm.protocols import openai as toai
from dynamo_tpu_torch.llm.tokenizer import ByteTokenizer

EOS = 0
V_FULL = 128256  # llama-3.2-1b's vocabulary
SCHEMA = {"type": "object", "properties": {"city": {"enum": ["SF", "NY"]}, "ok": {"type": "boolean"}}}
SCHEMAS = [
    SCHEMA,
    {"type": "object", "properties": {"tags": {"type": "array", "items": {"enum": ["a", "b"]}, "maxItems": 3},
                                      "level": {"enum": [1, 2, 3]}}},
    {"type": "object", "properties": {"name": {"type": "string", "maxLength": 4},
                                      "score": {"anyOf": [{"type": "integer"}, {"type": "null"}]}}},
    {"type": "array", "items": {"type": "number"}, "minItems": 2},
    {"type": ["string", "null"], "minLength": 1},
    {"const": {"k": [1, "x"]}},
    {"type": "string", "pattern": "[a-f]{2,3}"},
]
# The JAX guided tests' oracle and choice patterns, and a few beside them.
PATTERNS = [
    "(ab|cd){1,3}", "a?b{1,2}c{2}", "[xy]{2,4}", "(foo|bar|foobar)", '"(SF|NY)"', "x(12|345)?y",
    "(?:ab|ba|aab)", "(?:bba|a|b|abb)", r"\d{3}-[a-z]+", r"[^a-z\s]{1,3}\.", r"(?:yes|no)\n?", "a*?b+?",
    r"\w+@\w+\.(com|org)", r"\{\}|x{2,}",
]
CHOICES = [["red", "green", "blue"], ["a+b", "(c)", "d|e"], ["x"]]


def _choice(c):
    return tgrammar.spec_to_pattern({"kind": "choice", "choices": c})


CASES = (
    [("regex", p) for p in PATTERNS]
    + [("schema", s) for s in SCHEMAS]
    + [("choice", c) for c in CHOICES]
    + [("json_object", None)]
)


def _patterns(kind, arg):
    """(port pattern, JAX pattern) of one case."""
    if kind == "regex":
        return arg, arg
    if kind == "schema":
        return tgrammar.schema_to_regex(arg), jgrammar.schema_to_regex(arg)
    if kind == "choice":
        return _choice(arg), jgrammar.spec_to_pattern({"kind": "choice", "choices": arg})
    return tgrammar.json_object_regex(), jgrammar.json_object_regex()


def _token_strs(V):
    tok = ByteTokenizer()
    return [tok.decode([i]) for i in range(V)]


_STRS = {256: _token_strs(256)}


def _strs(V):
    if V not in _STRS:
        _STRS[V] = _token_strs(V)
    return _STRS[V]


@pytest.mark.parametrize("kind,arg", CASES, ids=[f"{k}-{i}" for i, (k, _) in enumerate(CASES)])
def test_patterns_and_dfas_match_jax(kind, arg):
    tp, jp = _patterns(kind, arg)
    assert tp == jp
    td, jd = tgrammar.compile_regex(tp), jgrammar.compile_regex(jp)
    assert (td.transitions, td.accepting, td.start, td.pattern) == (
        jd.transitions, jd.accepting, jd.start, jd.pattern)


def _fsm_equal(t, j):
    assert (t.num_states, t.vocab_size, t.eos_ids, t.pattern) == (j.num_states, j.vocab_size, j.eos_ids, j.pattern)
    for name in ("next_state", "allow_words", "accepting", "accept_only"):
        a, b = getattr(t, name), getattr(j, name)
        assert a.dtype == b.dtype and a.shape == b.shape, name
        np.testing.assert_array_equal(a, b, err_msg=name)


# At the full vocabulary every state's table row is 128,256 ids wide: the
# cases there are the grammars with tens of states, not json_object's 1,734.
FULL_CASES = [("regex", PATTERNS[0]), ("regex", PATTERNS[8]), ("schema", SCHEMA), ("schema", SCHEMAS[2]),
              ("choice", CHOICES[0]), ("choice", CHOICES[1])]


@pytest.mark.parametrize("V,kind,arg", [(256, k, a) for k, a in CASES] + [(V_FULL, k, a) for k, a in FULL_CASES],
                         ids=[f"V256-{k}-{i}" for i, (k, _) in enumerate(CASES)]
                         + [f"V{V_FULL}-{k}-{i}" for i, (k, _) in enumerate(FULL_CASES)])
def test_token_fsm_tables_match_jax(V, kind, arg):
    tp, jp = _patterns(kind, arg)
    strs = _strs(V)
    t = tfsm.compile_token_fsm(tgrammar.compile_regex(tp), strs, eos_ids=[EOS])
    j = jfsm.compile_token_fsm(jgrammar.compile_regex(jp), strs, eos_ids=[EOS])
    _fsm_equal(t, j)
    assert t.allow_words.dtype == np.uint32 and t.next_state.dtype == np.int32
    assert t.allow_words.shape == (t.num_states, (V + 31) // 32)


BAD_PATTERNS = ["(?=a)b", "a**b[", "[z-a]", "(a", "a\\1", "^a$", "[]", "\\q", "a{3,2}", "*a"]
BAD_SCHEMAS = [{"$ref": "#/defs/x"}, {"allOf": [{}]}, {"type": "object", "properties": {"a": {"$ref": "#"}}},
               {"enum": []}, {"type": "array", "minItems": 3, "maxItems": 1}, {"type": "weird"}, "nope"]


def _raised(fn, exc):
    with pytest.raises(exc) as info:
        fn()
    return str(info.value)


@pytest.mark.parametrize("pattern", BAD_PATTERNS)
def test_rejected_patterns_match_jax(pattern):
    assert _raised(lambda: tgrammar.compile_regex(pattern), tgrammar.GrammarError) == _raised(
        lambda: jgrammar.compile_regex(pattern), jgrammar.GrammarError)


@pytest.mark.parametrize("schema", BAD_SCHEMAS, ids=range(len(BAD_SCHEMAS)))
def test_rejected_schemas_match_jax(schema):
    assert _raised(lambda: tgrammar.schema_to_regex(schema), tgrammar.GrammarError) == _raised(
        lambda: jgrammar.schema_to_regex(schema), jgrammar.GrammarError)


def _body(**extra):
    return {"model": "m", "messages": [{"role": "user", "content": "x"}], **extra}


SPEC_BODIES = [
    _body(response_format={"type": "json_schema", "json_schema": {"name": "x", "schema": SCHEMA}}),
    _body(response_format={"type": "json_object"}),
    _body(response_format={"type": "text"}),
    _body(nvext={"guided_regex": r"\d+"}),
    _body(nvext={"guided_choice": ["yes", "no"]}),
    _body(nvext={"guided_json": SCHEMAS[1]}),
    _body(response_format={"type": "json_object"}, nvext={"guided_regex": "a"}),  # response_format first
    _body(),
]
BAD_SPEC_BODIES = [
    _body(response_format={"type": "json_schema", "json_schema": {"schema": {"$ref": "#/x"}}}),
    _body(nvext={"guided_regex": "(?=a)b"}),
    _body(nvext={"guided_json": {"allOf": [{}]}}),
    _body(nvext={"guided_regex": "[a"}),
]


@pytest.mark.parametrize("body", SPEC_BODIES, ids=range(len(SPEC_BODIES)))
def test_build_guided_spec_matches_jax(body):
    assert tgrammar.build_guided_spec(body) == jgrammar.build_guided_spec(body)


@pytest.mark.parametrize("body", BAD_SPEC_BODIES, ids=range(len(BAD_SPEC_BODIES)))
def test_build_guided_spec_400s_match_jax(body):
    assert _raised(lambda: tgrammar.build_guided_spec(body), toai.RequestError) == _raised(
        lambda: jgrammar.build_guided_spec(body), joai.RequestError)


def _jax_pools(pool):
    return np.asarray(pool.device()), np.asarray(pool.next_device())


@pytest.mark.parametrize("V,min_rows", [(256, 16), (V_FULL, 8)])
def test_mask_pool_matches_jax_across_registrations_and_growth(V, min_rows):
    """Registrations that cross the first capacity (so it doubles), one
    registered twice: the port's tables equal JAX's element for element,
    the bases and capacity too."""
    strs = _strs(V)
    pats = [_choice(CHOICES[0]), PATTERNS[0], tgrammar.schema_to_regex(SCHEMA), PATTERNS[8]]
    tpool, jpool = tproc.GuidedMaskPool(V, min_rows=min_rows), jproc.GuidedMaskPool(V, min_rows=min_rows)
    t_fsms = [tfsm.compile_token_fsm(tgrammar.compile_regex(p), strs, [EOS]) for p in pats]
    j_fsms = [jfsm.compile_token_fsm(jgrammar.compile_regex(p), strs, [EOS]) for p in pats]
    caps = []
    for tf, jf in list(zip(t_fsms, j_fsms)) + [(t_fsms[1], j_fsms[1])]:
        assert tpool.register(tf) == jpool.register(jf)
        caps.append(tpool.capacity)
        assert tpool.capacity == jpool.capacity
    assert caps[-1] > min_rows  # the capacity doubled at least once
    mask, nxt = tpool.device(), tpool.next_device()
    assert mask.dtype == nxt.dtype == torch.int32 and mask.device.type == "cpu"
    jm, jn = _jax_pools(jpool)
    np.testing.assert_array_equal(mask.numpy().view(np.uint32), jm)
    np.testing.assert_array_equal(nxt.numpy(), jn)


def test_mask_pool_before_registration_matches_jax():
    for V in (256, 250):  # 250: the allow-all row's last word keeps its pad bits 0
        t, j = tproc.GuidedMaskPool(V, min_rows=4), jproc.GuidedMaskPool(V, min_rows=4)
        jm, jn = _jax_pools(j)
        np.testing.assert_array_equal(t.device().numpy().view(np.uint32), jm)
        np.testing.assert_array_equal(t.next_device().numpy(), jn)
        assert t.next_pool_bytes() == j.next_pool_bytes()


def _expected_rows(fsm, base, V):
    """What a grammar's rows at ``base`` must hold: its allow bits, and its
    next rows (base + state, row 0 where dead)."""
    nxt = np.where(fsm.next_state >= 0, base + fsm.next_state, 0)
    return fsm.allow_words, np.pad(nxt, ((0, 0), (0, V - nxt.shape[1])))


def test_mask_pool_reuses_the_rows_of_released_grammars():
    """Schemas that change from request to request: a grammar that does not
    fit takes the rows of grammars no cursor holds before the capacity
    doubles, first fit; live grammars keep their rows and their tables;
    a released grammar registered again is written again."""
    V = 256
    strs = _strs(V)
    pats = [_choice([f"q{j:02d}{c}" for c in "abc"]) for j in range(12)]  # one size, different rows
    fsms = [tfsm.compile_token_fsm(tgrammar.compile_regex(p), strs, [EOS]) for p in pats]
    assert len({f.num_states for f in fsms}) == 1
    rows = sum(f.num_states for f in fsms[:3])
    pool = tproc.GuidedMaskPool(V, min_rows=rows + 1)
    live = {}
    for i, f in enumerate(fsms):
        live[i] = pool.register(f)
        if i >= 2:  # two live grammars at a time
            pool.release(fsms[i - 2])
            del live[i - 2]
    assert pool.capacity == rows + 1  # never grew: churn reuses freed rows
    assert pool.rows_in_use() <= 1 + sum(fsms[i].num_states for i in range(len(fsms) - 3, len(fsms)))
    spans = sorted((b, b + fsms[i].num_states) for i, b in live.items())
    assert all(e <= b for (_, e), (b, _) in zip(spans, spans[1:])) and spans[0][0] >= 1  # no overlap, row 0 kept
    mask, nxt = pool.device().numpy().view(np.uint32), pool.next_device().numpy()
    for i, base in live.items():
        want_m, want_n = _expected_rows(fsms[i], base, V)
        S = fsms[i].num_states
        np.testing.assert_array_equal(mask[base : base + S], want_m)
        np.testing.assert_array_equal(nxt[base : base + S], want_n)
    np.testing.assert_array_equal(mask[0], np.full(V // 32, 0xFFFFFFFF, np.uint32))
    # A cursor still holding its grammar keeps its rows through the churn.
    pinned = pool.register(fsms[0])
    for f in fsms[1:6]:
        pool.register(f)
        pool.release(f)
    assert pool.register(fsms[0]) == pinned


def test_mask_pool_refuses_a_grammar_the_device_cannot_hold(monkeypatch):
    """A capacity the device cannot allocate is a ValueError (the scheduler
    refuses that request) and leaves the pool as it was."""
    V = 256
    strs = _strs(V)
    small, big = (tfsm.compile_token_fsm(tgrammar.compile_regex(p), strs, [EOS])
                  for p in (PATTERNS[1], tgrammar.schema_to_regex(SCHEMA)))
    pool = tproc.GuidedMaskPool(V, min_rows=small.num_states + 2)
    base = pool.register(small)
    before = pool.device().clone(), pool.next_device().clone(), pool.capacity
    zeros = torch.zeros

    def no_room(shape, **kw):
        if shape[0] > before[2]:
            raise torch.cuda.OutOfMemoryError("no room")
        return zeros(shape, **kw)

    monkeypatch.setattr(tproc.torch, "zeros", no_room)
    with pytest.raises(ValueError, match="no device memory"):
        pool.register(big)
    assert pool.capacity == before[2] and pool.register(small) == base
    assert torch.equal(pool.device(), before[0]) and torch.equal(pool.next_device(), before[1])


def test_guided_decoder_prepare_is_safe_across_threads():
    """``prepare`` from more threads than cores, with a short switch
    interval: each distinct grammar compiles once and every cursor of it
    shares the one cached FSM (a lost cache update would compile twice)."""
    dec = tproc.GuidedDecoder(ByteTokenizer(), eos_ids=[EOS], vocab_size=256)
    specs = [{"kind": "regex", "pattern": p} for p in PATTERNS[:4]]
    got = [[] for _ in range(12)]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=lambda out=out, k=k: out.extend(
            dec.prepare(specs[(k + i) % 4]) for i in range(8))) for k, out in enumerate(got)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
    assert dec.compiles_total == 4 and all(len(out) == 8 for out in got)
    by_pattern = {}
    for st in (st for out in got for st in out):
        assert by_pattern.setdefault(st.fsm.pattern, st.fsm) is st.fsm


def _walk(state_cls, fsm, base, tokens):
    st = state_cls(fsm, base)
    out = [(st.row_id, st.exhausted, st.finished, st.state)]
    for tok in tokens:
        st.advance(tok)
        out.append((st.row_id, st.exhausted, st.finished, st.state))
    return out


WALKS = [
    ("choice", [ord(c) for c in "green"]),
    ("choice", [ord(c) for c in "re"] + [EOS]),
    ("choice", [ord(c) for c in "bx"]),  # a dead token
    ("choice", [ord("r"), 300, ord("d")]),  # an id past the byte range: the tokenizer's copy of "," (dead)
    ("schema", [ord(c) for c in '{"city":"SF","ok":true}'] + [EOS]),
    ("schema", [ord(c) for c in '{"city":"NY"'] + [V_FULL + 5]),  # out of the vocabulary
    ("regex", [ord(c) for c in "abcdab"] + [ord("a")]),
]


@pytest.mark.parametrize("kind,tokens", WALKS, ids=range(len(WALKS)))
def test_guided_state_walks_match_jax(kind, tokens):
    pattern = {"choice": _choice(CHOICES[0]), "schema": tgrammar.schema_to_regex(SCHEMA), "regex": PATTERNS[0]}[kind]
    strs = _strs(V_FULL) if kind != "regex" else _strs(256)
    tf = tfsm.compile_token_fsm(tgrammar.compile_regex(pattern), strs, [EOS])
    jf = jfsm.compile_token_fsm(jgrammar.compile_regex(pattern), strs, [EOS])
    assert _walk(tproc.GuidedState, tf, 7, tokens) == _walk(jproc.GuidedState, jf, 7, tokens)


def test_guided_decoder_caches_counts_and_rejects_as_jax():
    tok = ByteTokenizer()
    t = tproc.GuidedDecoder(tok, eos_ids=[EOS], vocab_size=256, pool_rows=32)
    j = jproc.GuidedDecoder(tok, eos_ids=[EOS], vocab_size=256, pool_rows=32)
    specs = [{"kind": "regex", "pattern": PATTERNS[1]}, {"kind": "choice", "choices": CHOICES[0]},
             {"kind": "regex", "pattern": PATTERNS[1]}]
    for spec in specs:
        ts, js = t.open(spec), j.open(spec)
        assert (ts.pool_base, ts.from_cache, ts.row_id) == (js.pool_base, js.from_cache, js.row_id)
    ts_, js_ = t.stats(), j.stats()
    assert set(ts_) == set(js_)
    assert (ts_["guided_requests_total"], ts_["guided_grammar_compiles_total"]) == (3, 2) == (
        js_["guided_requests_total"], js_["guided_grammar_compiles_total"])
    bad = {"kind": "nope"}
    assert _raised(lambda: t.open(bad), ValueError) == _raised(lambda: j.open(bad), ValueError)
    np.testing.assert_array_equal(t.pool.device().numpy().view(np.uint32), np.asarray(j.pool.device()))
    np.testing.assert_array_equal(t.pool.next_device().numpy(), np.asarray(j.pool.next_device()))
