"""Checkpoints on disk: the port's loaders against the JAX package's.

1. safetensors: ``engine/weights.load_checkpoint`` (the port's own reader,
   ``engine/safetensors_reader.py``) and the JAX ``load_checkpoint`` (the
   ``safetensors`` wheel) read the same directories — one file or two
   shards; f32, f16 and bf16 tensors; tied and untied heads; files written
   by ``safetensors.torch`` and by ``chip_smoke.write_hf_checkpoint`` — to
   bit-equal tensors, and under ``weight_dtype="int8"`` to equal int8
   codes and f32 scales. ``config_from_hf`` equals JAX's. The reader
   refuses a truncated or overrunning header, bad or overlapping offsets
   and an unknown dtype, naming the file and the tensor.
2. GGUF: the port's ``llm/gguf.py`` and ``config_from_gguf`` /
   ``load_gguf_checkpoint`` against the JAX package's on the cases of
   ``tests/test_gguf.py`` (metadata, bad magic, truncation, versions,
   q8_0 / q4_k / q5_k / q6_k dequantization, a round trip, the HF cache
   layout, RoPE scaling refused) and on ``chip_smoke.write_gguf_q8_0``'s
   file, whose dequantized values both read back exactly.
3. The engine: ``TorchEngine.build(EngineArgs(checkpoint_path=...))`` and
   a draft checkpoint load the files' weights.

Exact equality throughout (tolerance 0): both packages cast with
round-to-nearest-even and quantize with the same f32 arithmetic.
"""

import dataclasses
import json
import os
import struct

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from safetensors.torch import save_file

import chip_smoke
from dynamo_tpu.engine import weights as jweights
from dynamo_tpu.engine.config import get_config as jax_config
from dynamo_tpu.engine.models import llama as jllama
from dynamo_tpu.llm import gguf as jgguf
from dynamo_tpu_torch.engine.config import get_config
from dynamo_tpu_torch.engine.engine import EngineArgs, TorchEngine
from dynamo_tpu_torch.engine.quant import QuantW, quantize_weight
from dynamo_tpu_torch.engine.safetensors_reader import SafetensorsFile
from dynamo_tpu_torch.engine.weights import (
    GGUF_NAMES,
    HF_NAMES,
    config_from_gguf,
    config_from_hf,
    init_params,
    load_checkpoint,
    load_gguf_checkpoint,
    resolve_model,
)
from dynamo_tpu_torch.llm import gguf as pgguf

TCFG = get_config("tiny")
JCFG = jax_config("tiny")
TORCH_DTYPES = {"f32": torch.float32, "f16": torch.float16, "bf16": torch.bfloat16}
JAX_DTYPES = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}


def hf_tensors(cfg, dtype, seed=0, head=True):
    """Seeded HF-named tensors ([out, in] matrices) of ``cfg``'s widths."""
    rng = np.random.default_rng(seed)
    D, I, V = cfg.hidden_size, cfg.intermediate_size, cfg.vocab_size
    shapes = {"attn_norm": (D,), "mlp_norm": (D,), "wq": (cfg.q_size, D), "wk": (cfg.kv_size, D),
              "wv": (cfg.kv_size, D), "wo": (D, cfg.q_size), "w_gate": (I, D), "w_up": (I, D), "w_down": (D, I)}
    out = {HF_NAMES["embed"]: rng.standard_normal((V, D)), HF_NAMES["final_norm"]: rng.standard_normal(D)}
    if head:
        out[HF_NAMES["lm_head"]] = rng.standard_normal((V, D))
    for l in range(cfg.num_layers):
        for k, s in shapes.items():
            out[HF_NAMES[k].format(l)] = rng.standard_normal(s)
    # One all-zero output column: the int8 scale's 1.0 branch.
    out[HF_NAMES["wq"].format(0)][3, :] = 0.0
    return {k: torch.from_numpy(np.asarray(v, np.float32)).to(dtype) for k, v in out.items()}


def write_dir(path, tensors, shards=1):
    os.makedirs(path, exist_ok=True)
    names = list(tensors)
    for k in range(shards):
        part = {n: tensors[n].contiguous() for n in names[k::shards]}
        save_file(part, os.path.join(path, f"model-{k + 1:05d}-of-{shards:05d}.safetensors"))
    return str(path)


def assert_same(jp, tp):
    """A JAX param tree (the JAX loader's) equals the port's, bit for bit."""
    assert set(jp) == set(tp), (set(jp), set(tp))
    for k in jp:
        if k == "layers":
            assert set(jp[k]) == set(tp[k])
            for name, a in jp[k].items():
                b = tp[k][name]
                if isinstance(b, QuantW):
                    np.testing.assert_array_equal(np.asarray(a.q), b.q.numpy(), err_msg=name)
                    np.testing.assert_array_equal(np.asarray(a.scale), b.scale.numpy(), err_msg=name)
                else:
                    assert b.dtype == {jnp.dtype(jnp.float32): torch.float32,
                                       jnp.dtype(jnp.bfloat16): torch.bfloat16}[a.dtype]
                    np.testing.assert_array_equal(np.asarray(a.astype(jnp.float32)), b.float().numpy(),
                                                  err_msg=name)
        else:
            np.testing.assert_array_equal(np.asarray(jp[k].astype(jnp.float32)), tp[k].float().numpy(), err_msg=k)


# ---------------------------------------------------------------------------
# 1. safetensors
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("stored", ["f32", "f16", "bf16"])
@pytest.mark.parametrize("shards", [1, 2])
@pytest.mark.parametrize("tied", [False, True])
@pytest.mark.parametrize("compute", [torch.float32, torch.bfloat16])
def test_load_checkpoint_matches_jax(tmp_path, stored, shards, tied, compute):
    d = write_dir(tmp_path / "ckpt", hf_tensors(TCFG, TORCH_DTYPES[stored], head=True), shards)
    tcfg, jcfg = TCFG.replace(tie_word_embeddings=tied), JCFG.replace(tie_word_embeddings=tied)
    jp = jweights.load_checkpoint(d, jcfg, dtype=JAX_DTYPES[compute])
    tp = load_checkpoint(d, tcfg, dtype=compute, device="cpu")
    assert ("lm_head" in tp) == (not tied)
    assert_same(jp, tp)


@pytest.mark.parametrize("stored", ["f32", "f16", "bf16"])
def test_int8_codes_and_scales_match_jax(tmp_path, stored):
    """Quantized from the file's own precision, before the device: the
    JAX loader's ``quantize_weight_np`` codes and scales exactly."""
    d = write_dir(tmp_path / "ckpt", hf_tensors(TCFG, TORCH_DTYPES[stored], seed=3), 2)
    jp = jweights.load_checkpoint(d, JCFG.replace(weight_dtype="int8"), dtype=jnp.bfloat16)
    tp = load_checkpoint(d, TCFG.replace(weight_dtype="int8"), dtype=torch.bfloat16, device="cpu")
    assert all(isinstance(tp["layers"][k], QuantW) for k in ("wq", "w_down"))
    assert_same(jp, tp)


def test_chip_smoke_writer_round_trip(tmp_path):
    """``chip_smoke.write_hf_checkpoint`` (the writer the card's smoke test
    uses, no wheel) reads back bit-equal through both loaders, and its
    ``config.json`` gives the preset's widths in both."""
    params = init_params(TCFG, torch.Generator().manual_seed(5), device="cpu", dtype=torch.bfloat16)
    paths = chip_smoke.write_hf_checkpoint(str(tmp_path / "hf"), params, TCFG, shards=2)
    assert [os.path.basename(p) for p in paths] == ["model-00001-of-00002.safetensors",
                                                     "model-00002-of-00002.safetensors"]
    tp = load_checkpoint(str(tmp_path / "hf"), TCFG, dtype=torch.bfloat16, device="cpu")
    assert chip_smoke.tensors_equal(tp, params) == []
    assert_same(jweights.load_checkpoint(str(tmp_path / "hf"), JCFG, dtype=jnp.bfloat16), tp)
    got, want = config_from_hf(str(tmp_path / "hf")), jweights.config_from_hf(str(tmp_path / "hf"))
    assert dataclasses.asdict(got) == {k: v for k, v in dataclasses.asdict(want).items()
                                       if k in dataclasses.asdict(got)}
    assert (got.hidden_size, got.num_layers, got.vocab_size) == (TCFG.hidden_size, TCFG.num_layers, TCFG.vocab_size)


@pytest.mark.parametrize("hf", [
    {"vocab_size": 100, "hidden_size": 64, "num_hidden_layers": 2, "num_attention_heads": 4,
     "intermediate_size": 96},
    {"vocab_size": 100, "hidden_size": 64, "num_hidden_layers": 2, "num_attention_heads": 4, "head_dim": 32,
     "num_key_value_heads": 2, "intermediate_size": 96, "rope_theta": 10000.0, "rms_norm_eps": 1e-6,
     "max_position_embeddings": 512, "tie_word_embeddings": True},
])
def test_config_from_hf_matches_jax(tmp_path, hf):
    d = tmp_path / "model-x"
    d.mkdir()
    (d / "config.json").write_text(json.dumps(hf))
    got, want = dataclasses.asdict(config_from_hf(str(d))), dataclasses.asdict(jweights.config_from_hf(str(d)))
    assert got == {k: v for k, v in want.items() if k in got}


def _raw_file(path, header: dict, data: bytes, length=None):
    raw = json.dumps(header).encode()
    path.write_bytes(struct.pack("<Q", len(raw) if length is None else length) + raw + data)
    return str(path)


@pytest.mark.parametrize("case", ["short", "overrun", "not_json", "unknown_dtype", "out_of_range", "overlap",
                                  "size_mismatch"])
def test_reader_refusals(tmp_path, case):
    p = tmp_path / "bad.safetensors"
    ok = {"dtype": "F32", "shape": [2], "data_offsets": [0, 8]}
    if case == "short":
        p.write_bytes(b"\x01\x02")
        match = "shorter than the 8-byte header length"
    elif case == "overrun":
        _raw_file(p, {"a": ok}, b"\0" * 8, length=10_000)
        match = "overruns the file"
    elif case == "not_json":
        p.write_bytes(struct.pack("<Q", 4) + b"{{{{")
        match = "not JSON"
    elif case == "unknown_dtype":
        _raw_file(p, {"w": {"dtype": "F8_E4M3", "shape": [2], "data_offsets": [0, 2]}}, b"\0" * 2)
        match = "tensor 'w': unknown dtype 'F8_E4M3'"
    elif case == "out_of_range":
        _raw_file(p, {"w": {"dtype": "F32", "shape": [2], "data_offsets": [4, 12]}}, b"\0" * 8)
        match = "tensor 'w': data_offsets"
    elif case == "overlap":
        _raw_file(p, {"a": ok, "b": {"dtype": "F32", "shape": [2], "data_offsets": [4, 12]}}, b"\0" * 12)
        match = "tensors 'a' and 'b' overlap"
    else:
        _raw_file(p, {"w": {"dtype": "BF16", "shape": [3], "data_offsets": [0, 8]}}, b"\0" * 8)
        match = "tensor 'w': data_offsets .* needs 6"
    with pytest.raises(ValueError, match=match) as err:
        SafetensorsFile(str(p))
    assert str(p) in str(err.value)


def test_reader_reads_every_dtype(tmp_path):
    """Each dtype the reader maps reads back the bytes ``safetensors.torch``
    wrote, shape and dtype kept (bf16 with no numpy dtype between)."""
    rng = np.random.default_rng(1)
    tensors = {
        "bf16": torch.from_numpy(rng.standard_normal((3, 5)).astype(np.float32)).to(torch.bfloat16),
        "f16": torch.from_numpy(rng.standard_normal(7).astype(np.float16)),
        "f32": torch.from_numpy(rng.standard_normal((2, 2, 2)).astype(np.float32)),
        "i8": torch.from_numpy(rng.integers(-128, 127, size=9).astype(np.int8)),
        "i64": torch.arange(4, dtype=torch.int64),
        "empty": torch.zeros((0, 3), dtype=torch.float32),
    }
    save_file(tensors, str(tmp_path / "t.safetensors"), metadata={"k": "v"})
    with SafetensorsFile(str(tmp_path / "t.safetensors")) as f:
        assert sorted(f.keys()) == sorted(tensors) and f.metadata == {"k": "v"}
        for name, t in tensors.items():
            got = f.get(name)
            assert got.dtype == t.dtype and got.shape == t.shape
            assert torch.equal(got, t), name


def test_missing_files_and_tensors(tmp_path):
    with pytest.raises(FileNotFoundError):
        load_checkpoint(str(tmp_path), TCFG, device="cpu")
    tensors = hf_tensors(TCFG, torch.float32)
    del tensors[HF_NAMES["w_up"].format(1)]
    d = write_dir(tmp_path / "partial", tensors)
    with pytest.raises(ValueError, match="no tensor 'model.layers.1.mlp.up_proj.weight'"):
        load_checkpoint(d, TCFG, device="cpu")
    with pytest.raises(ValueError, match="has shape"):
        load_checkpoint(write_dir(tmp_path / "full", hf_tensors(TCFG, torch.float32)),
                        TCFG.replace(intermediate_size=64), device="cpu")


# ---------------------------------------------------------------------------
# 2. GGUF (tests/test_gguf.py's cases, both packages)
# ---------------------------------------------------------------------------


def _s(text: str) -> bytes:
    b = text.encode()
    return struct.pack("<Q", len(b)) + b


def write_gguf(path, *, version=3, metadata=(), tensors=(), data=b""):
    out = b"GGUF" + struct.pack("<IQQ", version, len(tensors), len(metadata))
    for key, vtype, raw in metadata:
        out += _s(key) + struct.pack("<I", vtype) + raw
    for name, dims, gtype, offset in tensors:
        out += _s(name) + struct.pack("<I", len(dims)) + b"".join(struct.pack("<Q", d) for d in dims)
        out += struct.pack("<IQ", gtype, offset)
    if data:
        out += b"\0" * (-len(out) % 32) + data
    path.write_bytes(out)
    return str(path)


def _meta_fields(m):
    return (m.version, m.metadata, [(t.name, t.shape, t.ggml_type, t.offset, t.dtype_name) for t in m.tensors],
            m.data_start, m.architecture, m.model_name, m.context_length, m.num_layers, m.tokenizer_model, m.tokens,
            m.chat_template)


def test_gguf_parse_matches_jax(tmp_path):
    tokens_array = struct.pack("<IQ", 8, 2) + _s("<s>") + _s("</s>")
    path = write_gguf(tmp_path / "m.gguf", metadata=[
        ("general.architecture", 8, _s("llama")), ("general.name", 8, _s("tiny-test")),
        ("llama.context_length", 4, struct.pack("<I", 4096)), ("llama.block_count", 4, struct.pack("<I", 2)),
        ("llama.rope.freq_base", 6, struct.pack("<f", 10000.0)), ("tokenizer.ggml.model", 8, _s("gpt2")),
        ("tokenizer.ggml.tokens", 9, tokens_array), ("general.quantized", 7, b"\x01"),
        ("tokenizer.chat_template", 8, _s("{{ x }}")), ("x.i64", 11, struct.pack("<q", -5)),
        ("x.f64", 12, struct.pack("<d", 0.25)), ("x.u16", 2, struct.pack("<H", 7))],
        tensors=[("token_embd.weight", [256, 64], 0, 0), ("blk.0.attn_q.weight", [64, 64], 30, 65536)])
    got, want = pgguf.parse_gguf(path), jgguf.parse_gguf(path)
    assert _meta_fields(got) == _meta_fields(want)
    assert got.tensors[1].dtype_name == "bf16" and got.tokens == ["<s>", "</s>"] and got.chat_template == "{{ x }}"


@pytest.mark.parametrize("case", ["bad_magic", "truncated", "version", "array", "value_type", "rank"])
def test_gguf_refusals_match_jax(tmp_path, case):
    p = tmp_path / "bad.gguf"
    if case == "bad_magic":
        p.write_bytes(b"NOPE" + b"\x00" * 100)
    elif case == "truncated":
        write_gguf(p, metadata=[("general.architecture", 8, _s("llama"))])
        p.write_bytes(p.read_bytes()[:-4])
    elif case == "version":
        write_gguf(p, version=9)
    elif case == "array":
        write_gguf(p, metadata=[("a", 9, struct.pack("<IQ", 4, 1 << 30))])
    elif case == "value_type":
        write_gguf(p, metadata=[("a", 99, b"")])
    else:
        write_gguf(p, tensors=[("t", [1] * 9, 0, 0)])
    for mod in (pgguf, jgguf):
        with pytest.raises(mod.GgufError):
            mod.parse_gguf(str(p), max_array=1 << 24)


def _q_bytes(rng, kind: str, blocks: int) -> bytes:
    """Random blocks of a quantized type with finite f16 scales."""
    size = {"q8_0": 34, "q4_k": 144, "q5_k": 176, "q6_k": 210}[kind]
    raw = rng.integers(0, 256, size=(blocks, size), dtype=np.uint8)
    scales = rng.uniform(-0.5, 0.5, size=(blocks, 2)).astype(np.float16).view(np.uint8)
    if kind == "q8_0":
        raw[:, 0:2] = scales[:, 0:2]
    elif kind == "q6_k":
        raw[:, 208:210] = scales[:, 0:2]
    else:
        raw[:, 0:4] = scales
    return raw.tobytes()


@pytest.mark.parametrize("kind,gtype", [("q8_0", 8), ("q4_k", 12), ("q5_k", 13), ("q6_k", 14)])
def test_quantized_dequant_matches_jax(tmp_path, kind, gtype):
    """Each quantized type's dequantization, through ``load_tensors``,
    equals the JAX package's exactly on random blocks (and on the hand-made
    q5_k block of test_gguf.py: every 5-bit code in its lane)."""
    rng = np.random.default_rng(gtype)
    per = 32 if kind == "q8_0" else 256
    raw = _q_bytes(rng, kind, 6)
    path = write_gguf(tmp_path / f"{kind}.gguf", tensors=[("t", [per, 6], gtype, 0)], data=raw)
    got, want = pgguf.load_tensors(path)["t"], jgguf.load_tensors(path)["t"]
    assert got.shape == (6, per)
    np.testing.assert_array_equal(got, want)
    if kind == "q5_k":
        block = np.zeros(176, np.uint8)
        block[0:2] = np.frombuffer(np.float16(1.0).tobytes(), np.uint8)
        block[4:8] = 1  # scale 1, min 0 for sub-blocks 0-3 (and 4-7 through the high bits' zero)
        block[12:16] = 1
        codes = (np.arange(256) % 32).astype(np.uint8)
        qs, qh = np.zeros(128, np.uint8), np.zeros(32, np.uint8)
        for j in range(4):
            c1, c2 = codes[64 * j:64 * j + 32], codes[64 * j + 32:64 * j + 64]
            qs[32 * j:32 * (j + 1)] = (c1 & 0xF) | ((c2 & 0xF) << 4)
            qh |= ((c1 >> 4) << (2 * j)) | ((c2 >> 4) << (2 * j + 1))
        block[16:48], block[48:176] = qh, qs
        np.testing.assert_array_equal(pgguf._dequant_q5_k(block.tobytes()), jgguf._dequant_q5_k(block.tobytes()))


def test_gguf_unsupported_type_refused(tmp_path):
    path = write_gguf(tmp_path / "iq.gguf", tensors=[("t", [256], 16, 0)], data=b"\0" * 256)
    with pytest.raises(pgguf.GgufError, match="unsupported tensor dtype iq2_xxs"):
        pgguf.load_tensors(path)


def _tiny_gguf_meta(cfg, **extra):
    meta = [("general.architecture", 8, _s("llama")), ("general.name", 8, _s("tiny-gguf")),
            ("llama.context_length", 4, struct.pack("<I", cfg.max_seq_len)),
            ("llama.block_count", 4, struct.pack("<I", cfg.num_layers)),
            ("llama.embedding_length", 4, struct.pack("<I", cfg.hidden_size)),
            ("llama.feed_forward_length", 4, struct.pack("<I", cfg.intermediate_size)),
            ("llama.attention.head_count", 4, struct.pack("<I", cfg.num_heads)),
            ("llama.attention.head_count_kv", 4, struct.pack("<I", cfg.num_kv_heads)),
            ("llama.rope.freq_base", 6, struct.pack("<f", cfg.rope_theta)),
            ("llama.attention.layer_norm_rms_epsilon", 6, struct.pack("<f", cfg.rms_norm_eps))]
    return meta + [(k, t, v) for k, (t, v) in extra.items()]


def _gguf_f32(path, cfg, head=True, **extra):
    """tiny's seeded JAX params as an f32 GGUF (HF [out, in] matrices)."""
    params = jllama.init_params(JCFG, jax.random.PRNGKey(0), dtype=jnp.float32)
    lp = params["layers"]
    arrays = [("token_embd.weight", np.asarray(params["embed"])), ("output_norm.weight", np.asarray(params["final_norm"]))]
    if head:
        arrays.append(("output.weight", np.asarray(params["lm_head"]).T))
    for l in range(cfg.num_layers):
        for k, fmt in GGUF_NAMES.items():
            if "{}" in fmt:
                a = np.asarray(lp[k][l])
                arrays.append((fmt.format(l), a if a.ndim == 1 else a.T))
    tensors, blobs, offset = [], b"", 0
    for name, a in arrays:
        raw = np.ascontiguousarray(a, dtype=np.float32).tobytes()
        tensors.append((name, list(reversed(a.shape)), 0, offset))
        blobs += raw + b"\0" * (-len(raw) % 32)
        offset += len(raw) + (-len(raw) % 32)
    return write_gguf(path, metadata=_tiny_gguf_meta(cfg, **extra), tensors=tensors, data=blobs)


@pytest.mark.parametrize("head", [True, False])
def test_gguf_round_trip_matches_jax(tmp_path, head):
    path = _gguf_f32(tmp_path / "tiny.gguf", TCFG, head=head)
    got, want = config_from_gguf(path), jweights.config_from_gguf(path)
    assert dataclasses.asdict(got) == {k: v for k, v in dataclasses.asdict(want).items() if k in dataclasses.asdict(got)}
    assert got.tie_word_embeddings == (not head) and got.vocab_size == TCFG.vocab_size
    cfg = TCFG.replace(tie_word_embeddings=not head)
    jp = jweights.load_gguf_checkpoint(path, JCFG.replace(tie_word_embeddings=not head), dtype=jnp.float32)
    assert_same(jp, load_gguf_checkpoint(path, cfg, dtype=torch.float32, device="cpu"))
    # A directory with no safetensors loads its first .gguf, as JAX's does.
    assert_same(jp, load_checkpoint(str(tmp_path), cfg, dtype=torch.float32, device="cpu"))


def test_config_from_gguf_refuses_rope_scaling(tmp_path):
    path = _gguf_f32(tmp_path / "scaled.gguf", TCFG, **{"llama.rope.scaling.type": (8, _s("linear")),
                                                         "llama.rope.scaling.factor": (6, struct.pack("<f", 4.0))})
    for fn in (config_from_gguf, jweights.config_from_gguf):
        with pytest.raises(ValueError, match="rope.scaling.type='linear'"):
            fn(path)


def test_chip_smoke_q8_0_gguf(tmp_path):
    """``chip_smoke.write_gguf_q8_0``'s file: both loaders read the writer's
    dequantized values back exactly (cast to bf16), and ``params_from_hf``
    of them is the port's params."""
    params = init_params(TCFG, torch.Generator().manual_seed(9), device="cpu", dtype=torch.bfloat16)
    path = str(tmp_path / "m.gguf")
    values = chip_smoke.write_gguf_q8_0(path, params, TCFG)
    assert {t.name: t.ggml_type for t in pgguf.parse_gguf(path).tensors}["blk.0.attn_q.weight"] == 8
    tp = load_checkpoint(path, TCFG, dtype=torch.bfloat16, device="cpu")
    want = chip_smoke.params_from_hf(values, TCFG, "cpu", torch.bfloat16, GGUF_NAMES)
    assert chip_smoke.tensors_equal(tp, want) == []
    assert_same(jweights.load_checkpoint(path, JCFG, dtype=jnp.bfloat16), tp)
    # q8_0 keeps each value within half a code step of its block, plus the
    # f16 rounding of the scale over 127 steps.
    w = params["layers"]["wq"][0].T.float().numpy()
    step = np.abs(w.reshape(-1, 32)).max(axis=1, keepdims=True) / 127
    err = np.abs(values["blk.0.attn_q.weight"].numpy().reshape(-1, 32) - w.reshape(-1, 32))
    assert np.all(err <= step * (0.5 + 127 * 2.0 ** -11))


def test_resolve_model_matches_jax(tmp_path, monkeypatch):
    repo = tmp_path / "hub" / "models--org--model"
    snap = repo / "snapshots" / "abc123"
    snap.mkdir(parents=True)
    (snap / "model.safetensors").write_bytes(b"x")
    (repo / "refs").mkdir()
    (repo / "refs" / "main").write_text("abc123\n")
    other = tmp_path / "hub" / "models--org--norefs" / "snapshots"
    (other / "r1").mkdir(parents=True)
    (other / "r2").mkdir()
    (other / "r2" / "m.gguf").write_bytes(b"GGUF")
    monkeypatch.setenv("HF_HOME", str(tmp_path))
    g = tmp_path / "m.gguf"
    g.write_bytes(b"GGUF")
    for name in ("org/model", "org/missing", "org/norefs", str(g), str(snap), str(tmp_path / "nothing")):
        assert resolve_model(name) == jweights.resolve_model(name), name
    assert resolve_model("org/model") == str(snap) and resolve_model("org/norefs") == str(other / "r2")


# ---------------------------------------------------------------------------
# 3. The engine
# ---------------------------------------------------------------------------


def test_engine_builds_from_checkpoints(tmp_path):
    """``EngineArgs.checkpoint_path`` and ``draft_checkpoint_path`` load the
    files' weights (the draft from a GGUF); int8 quantizes at load."""
    params = init_params(TCFG, torch.Generator().manual_seed(2), device="cpu", dtype=torch.float32)
    chip_smoke.write_hf_checkpoint(str(tmp_path / "hf"), params, TCFG)
    values = chip_smoke.write_gguf_q8_0(str(tmp_path / "d.gguf"), params, TCFG)
    engine = TorchEngine.build(EngineArgs(model="tiny", dtype="float32", device="cpu",
                                          checkpoint_path=str(tmp_path / "hf"), draft_model="tiny",
                                          draft_checkpoint_path=str(tmp_path / "d.gguf")))
    sched = engine.scheduler
    assert chip_smoke.tensors_equal(sched.params, params) == []
    assert chip_smoke.tensors_equal(sched.draft_params,
                                    chip_smoke.params_from_hf(values, TCFG, "cpu", torch.float32, GGUF_NAMES)) == []
    q = TorchEngine.build(EngineArgs(model="tiny", dtype="float32", device="cpu", weight_dtype="int8",
                                     checkpoint_path=str(tmp_path / "hf"))).scheduler.params["layers"]["wk"]
    assert torch.equal(q.q[1], quantize_weight(params["layers"]["wk"][1]).q)
