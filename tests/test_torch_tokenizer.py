"""The port's ``tokenizer.json`` reader against the ``tokenizers`` wheel.

The port's ``HFTokenizer`` (``llm/tokenizer_json.py``, no wheel) and the
JAX package's ``HFTokenizer`` (the ``tokenizers`` wheel) load the same
files, in the layouts of the repo's Llama-family presets' published
tokenizers, each built here with a seeded BPE vocabulary
(``chip_smoke.bpe_vocab``):

- Llama-3: ``chip_smoke.llama3_tokenizer_spec`` at 2,000 tokens (the file
  the card's smoke test writes at 128,000), ``ignore_merges``, its Split
  pattern, ByteLevel, 256 special tokens; and with ``ignore_merges`` off;
- Qwen2.5: NFC, its own Split pattern (one digit a piece), ByteLevel;
- Mistral: ``byte_fallback`` BPE with ``<0xAB>`` tokens and an unknown
  token, ``Prepend("▁")`` + ``Replace(" ", "▁")`` or the ``Metaspace``
  pre-tokenizer, decoded by ``Replace``, ``ByteFallback``, ``Fuse`` and
  ``Strip``.

On hypothesis text (letters, Mn/Mc marks, Nl/No numerals, digit runs, CJK,
emoji, punctuation, ``\\r\\n`` and space runs, U+001C and U+0085, any
character, the special tokens inside the text) ``encode`` gives the same
ids and ``decode`` the same text; random id lists (partial UTF-8, special
and out-of-range ids) decode the same; ``DecodeStream`` gives the same
deltas. The added tokens' ``lstrip``, ``rstrip``, ``single_word``,
``normalized`` and ``special`` are honoured as the wheel does; the config's
EOS id, template and tokens and the vocabulary size match; guided
decoding's per-id strings over chip_smoke's 128,256-id vocabulary equal the
JAX package's; every unsupported component raises, naming itself.
Exact equality throughout.
"""

import json
import os

import pytest
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

import chip_smoke
from dynamo_tpu.llm.guided.processor import GuidedDecoder as JaxGuidedDecoder
from dynamo_tpu.llm.tokenizer import DecodeStream as JaxDecodeStream
from dynamo_tpu.llm.tokenizer import HFTokenizer as JaxHFTokenizer
from dynamo_tpu_torch.llm.guided.processor import GuidedDecoder
from dynamo_tpu_torch.llm.tokenizer import ByteTokenizer, DecodeStream, HFTokenizer, load_tokenizer
from dynamo_tpu_torch.llm.tokenizer_json import BYTE_TO_CHAR, TokenizerJson, bytelevel, translate_pattern

QWEN_PATTERN = (r"(?i:'s|'t|'re|'ve|'m|'ll|'d)|[^\r\n\p{L}\p{N}]?\p{L}+|\p{N}| ?[^\s\p{L}\p{N}]+[\r\n]*"
                r"|\s*[\r\n]+|\s+(?!\S)|\s+")
QWEN_SPECIAL = ["<|endoftext|>", "<|im_start|>", "<|im_end|>", "<|object_ref_start|>", "<|object_ref_end|>",
                "<|box_start|>", "<|box_end|>", "<|quad_start|>", "<|quad_end|>", "<|vision_start|>",
                "<|vision_end|>", "<|vision_pad|>", "<|image_pad|>", "<|video_pad|>", "<tool_call>", "</tool_call>"]
MISTRAL_SPECIAL = ["<unk>", "<s>", "</s>", "[INST]", "[/INST]", "[TOOL_CALLS]", "[AVAILABLE_TOOLS]"]
SETTINGS = settings(max_examples=120, deadline=None, suppress_health_check=[HealthCheck.too_slow])


def _added(i, content, **kw):
    return {"id": i, "content": content, "single_word": False, "lstrip": False, "rstrip": False,
            "normalized": False, "special": True, **kw}


def llama3(ignore_merges=True):
    spec = chip_smoke.llama3_tokenizer_spec(size=2000, n_special=256)
    spec["model"]["ignore_merges"] = ignore_merges
    return spec, "<|begin_of_text|>", "<|eot_id|>", chip_smoke.llama3_special_tokens(12)


def qwen():
    alphabet = [BYTE_TO_CHAR[b] for b in range(256)]
    vocab, merges = chip_smoke.bpe_vocab(alphabet, [bytelevel(w) for w in chip_smoke.corpus_words()], 2000, seed=7)
    spec = chip_smoke.llama3_tokenizer_spec(size=2000, n_special=0)
    spec["model"].update(vocab=vocab, merges=merges, ignore_merges=False)
    spec["added_tokens"] = [_added(2000 + i, t) for i, t in enumerate(QWEN_SPECIAL)]
    spec["normalizer"] = {"type": "NFC"}
    spec["pre_tokenizer"]["pretokenizers"][0]["pattern"] = {"Regex": QWEN_PATTERN}
    spec["post_processor"] = {"type": "ByteLevel", "add_prefix_space": False, "trim_offsets": False,
                              "use_regex": False}
    return spec, None, "<|im_end|>", QWEN_SPECIAL


def mistral(metaspace=False):
    """A Mistral-v0.3-like file (V = 32768 published; 3,000 here)."""
    alphabet = MISTRAL_SPECIAL[:3] + [f"<0x{b:02X}>" for b in range(256)]
    alphabet += sorted(set("▁abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789.,;:!?'\"-_()[]{}éü中"))
    words = ["▁" + w.strip() for w in chip_smoke.corpus_words() if w.strip().isalpha() and w.strip().isascii()]
    vocab, merges = chip_smoke.bpe_vocab(alphabet, words, 3000, seed=1)
    for t in MISTRAL_SPECIAL[3:]:
        vocab[t] = len(vocab)
    spec = {
        "version": "1.0", "truncation": None, "padding": None,
        "added_tokens": [_added(vocab[t], t) for t in MISTRAL_SPECIAL],
        "normalizer": {"type": "Sequence", "normalizers": [{"type": "Prepend", "prepend": "▁"},
                                                           {"type": "Replace", "pattern": {"String": " "},
                                                            "content": "▁"}]},
        "pre_tokenizer": None,
        "post_processor": {"type": "TemplateProcessing",
                           "single": [{"SpecialToken": {"id": "<s>", "type_id": 0}}, {"Sequence": {"id": "A", "type_id": 0}}],
                           "pair": [{"Sequence": {"id": "A", "type_id": 0}}, {"Sequence": {"id": "B", "type_id": 1}}],
                           "special_tokens": {"<s>": {"id": "<s>", "ids": [1], "tokens": ["<s>"]}}},
        "decoder": {"type": "Sequence", "decoders": [
            {"type": "Replace", "pattern": {"String": "▁"}, "content": " "}, {"type": "ByteFallback"},
            {"type": "Fuse"}, {"type": "Strip", "content": " ", "start": 1, "stop": 0}]},
        "model": {"type": "BPE", "dropout": None, "unk_token": "<unk>", "continuing_subword_prefix": None,
                  "end_of_word_suffix": None, "fuse_unk": True, "byte_fallback": True, "ignore_merges": False,
                  "vocab": vocab, "merges": merges},
    }
    if metaspace:
        spec["normalizer"] = None
        spec["pre_tokenizer"] = {"type": "Metaspace", "replacement": "▁", "prepend_scheme": "first", "split": False}
    return spec, "<s>", "</s>", MISTRAL_SPECIAL


LAYOUTS = {"llama3": llama3, "llama3-merges": lambda: llama3(False), "qwen2.5": qwen, "mistral": mistral,
           "mistral-metaspace": lambda: mistral(True)}


@pytest.fixture(scope="module")
def pairs(tmp_path_factory):
    """layout → (port HFTokenizer, JAX HFTokenizer, special tokens)."""
    out = {}
    for name, build in LAYOUTS.items():
        spec, bos, eos, specials = build()
        d = str(tmp_path_factory.mktemp(name))
        chip_smoke.write_tokenizer(d, spec, chat_template="{{ messages }}", bos_token=bos, eos_token=eos)
        out[name] = (HFTokenizer(d), JaxHFTokenizer(d), specials)
    return out


def text_of(specials):
    chunk = st.one_of(
        st.text(st.characters(categories=["Lu", "Ll", "Lt", "Lm", "Lo"]), max_size=6),
        st.text(st.characters(categories=["Mn", "Mc"]), max_size=3),
        st.text(st.characters(categories=["Nd", "Nl", "No"]), max_size=5),
        st.text(st.sampled_from("0123456789"), min_size=1, max_size=7),
        st.text(st.characters(min_codepoint=0x4E00, max_codepoint=0x9FFF), max_size=4),
        st.text(st.characters(min_codepoint=0x1F300, max_codepoint=0x1FAFF), max_size=3),
        st.lists(st.sampled_from([" ", "  ", "\n", "\r\n", "\t", "\r", " ", "　", "\x1c", "\x85"]),
                max_size=5).map("".join),
        st.text(st.characters(categories=["P", "S"]), max_size=4),
        st.sampled_from(["'s", "'S", "'ll", "'RE", " the", "The", " dynamo", " serving", "ſ", "K"]),
        st.text(max_size=5),
        st.sampled_from(specials),
    )
    return st.lists(chunk, max_size=12).map("".join)


def _check_text(mine, jax_tok, text):
    ids = jax_tok.encode(text)
    assert mine.encode(text) == ids, ascii(text)
    assert mine.decode(ids) == jax_tok.decode(ids)


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_encode_decode_match_the_wheel(pairs, layout):
    mine, jax_tok, specials = pairs[layout]

    @SETTINGS
    @given(text_of(specials))
    def check(text):
        _check_text(mine, jax_tok, text)

    check()
    # Fixed cases: contractions, digit runs, newline runs before text,
    # whitespace before non-space, an added token at the very start.
    for text in ["I'll've 12345678 'S\r\n\r\n  x\n\n\ty", "  hello  world  ", specials[1] + " a" + specials[0],
                 "naïve café — ½ Ⅻ ३४ कि", "中文😀👍🏽 é", ""]:
        _check_text(mine, jax_tok, text)


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_decode_random_ids_match_the_wheel(pairs, layout):
    """Arbitrary id lists, partial UTF-8 sequences, special and unknown
    ids among them, decode as the wheel's (lossy UTF-8 alike)."""
    mine, jax_tok, _ = pairs[layout]
    V = jax_tok.vocab_size

    @SETTINGS
    @given(st.lists(st.integers(0, V + 4), max_size=16))
    def check(ids):
        assert mine.decode(ids) == jax_tok.decode(ids), ids

    check()


@pytest.mark.parametrize("layout", ["llama3", "mistral"])
def test_decode_stream_matches_jax(pairs, layout):
    """The port's DecodeStream over its tokenizer gives the JAX
    DecodeStream's deltas (partial UTF-8 held back, EOS skipped)."""
    mine, jax_tok, specials = pairs[layout]

    @SETTINGS
    @given(text_of(specials), st.lists(st.integers(1, 4), min_size=1, max_size=6))
    def check(text, steps):
        ids = jax_tok.encode(text)
        skip = jax_tok.eos_token_ids
        a, b = DecodeStream(mine, skip_token_ids=skip), JaxDecodeStream(jax_tok, skip_token_ids=skip)
        i = 0
        while i < len(ids):
            n = steps[i % len(steps)]
            assert a.step(ids[i:i + n]) == b.step(ids[i:i + n])
            i += n
        assert a.flush() == b.flush()

    check()


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_config_and_vocab_match_jax(pairs, layout):
    mine, jax_tok, specials = pairs[layout]
    assert mine.eos_token_ids == jax_tok.eos_token_ids and mine.eos_token_ids
    assert (mine.chat_template, mine.bos_token, mine.eos_token) == (jax_tok.chat_template, jax_tok.bos_token,
                                                                    jax_tok.eos_token)
    assert mine.vocab_size == jax_tok.vocab_size
    assert all(mine.token_to_id(t) == jax_tok._tok.token_to_id(t) for t in specials)


@pytest.mark.parametrize("option", [{"lstrip": True}, {"rstrip": True}, {"single_word": True},
                                    {"normalized": True, "special": False}, {"special": False},
                                    {"lstrip": True, "rstrip": True, "single_word": True}])
def test_added_token_options_match_the_wheel(tmp_path, option):
    """``lstrip``, ``rstrip``, ``single_word`` (the wheel's word characters:
    letters, marks, Nd/Nl, connectors, the circled letters), ``normalized``
    and ``special`` on added tokens, one of them a plain word."""
    spec = chip_smoke.llama3_tokenizer_spec(size=600, n_special=8)
    for e in spec["added_tokens"][:5]:
        e.update(option)
    spec["added_tokens"].append(_added(608, "ab", **{"special": False, "normalized": True, **option}))
    spec["normalizer"] = {"type": "NFC"}
    chip_smoke.write_tokenizer(str(tmp_path), spec)
    mine, jax_tok = HFTokenizer(str(tmp_path)), JaxHFTokenizer(str(tmp_path))
    specials = chip_smoke.llama3_special_tokens(8) + ["ab", " ab ", "xab_", "ⓐab", "ab́", "½ab"]

    @SETTINGS
    @given(text_of(specials))
    def check(text):
        _check_text(mine, jax_tok, text)

    check()


def test_translate_pattern_classes():
    """The rewritten classes on the characters where Python's ``re`` and
    the wheel's Oniguruma disagree: U+001C–U+001F are not ``\\s`` there; ½
    and Ⅻ are ``\\p{N}``, not ``\\p{L}``; a Unicode 16.0 letter is ``\\p{L}``."""
    import re

    letters = re.compile(translate_pattern(r"\p{L}+"))
    numbers = re.compile(translate_pattern(r"\p{N}"))
    space = re.compile(translate_pattern(r"\s"))
    assert letters.fullmatch("aé中ǅ\U000105c0") and not letters.match("½") and not letters.match("Ⅻ")
    assert numbers.match("½") and numbers.match("Ⅻ") and numbers.match("٣") and not numbers.match("a")
    assert all(space.match(c) for c in "\t\n\x0b\x0c\r \x85\xa0 　")
    assert not any(space.match(c) for c in "\x1c\x1d\x1e\x1f")
    assert re.compile(translate_pattern(r"[^\s\p{L}]")).match("\x1c")


UNSUPPORTED = [
    ("normalizer", {"type": "Lowercase"}, "normalizer 'Lowercase'"),
    ("normalizer", {"type": "NFKC"}, "normalizer 'NFKC'"),
    ("normalizer", {"type": "Replace", "pattern": {"Regex": " +"}, "content": " "}, "Replace with a Regex"),
    ("pre_tokenizer", {"type": "Whitespace"}, "pre-tokenizer 'Whitespace'"),
    ("pre_tokenizer", {"type": "ByteLevel", "add_prefix_space": False, "use_regex": True}, "ByteLevel with use_regex"),
    ("pre_tokenizer", {"type": "ByteLevel", "add_prefix_space": True, "use_regex": False},
     "ByteLevel with add_prefix_space"),
    ("pre_tokenizer", {"type": "Metaspace", "replacement": "▁"}, "prepend_scheme None"),
    ("pre_tokenizer", {"type": "Split", "pattern": {"String": " "}, "behavior": "Removed", "invert": False},
     "Split behavior 'Removed'"),
    ("pre_tokenizer", {"type": "Split", "pattern": {"Regex": r"\w+"}, "behavior": "Isolated", "invert": False},
     r"regex escape '\\w'"),
    ("pre_tokenizer", {"type": "Split", "pattern": {"Regex": r"\p{Lu}"}, "behavior": "Isolated", "invert": False},
     "regex escape"),
    ("decoder", {"type": "WordPiece", "prefix": "##"}, "decoder 'WordPiece'"),
    ("post_processor", {"type": "BertProcessing", "sep": ["[SEP]", 1], "cls": ["[CLS]", 0]},
     "post-processor 'BertProcessing'"),
    ("model", {"type": "WordPiece", "vocab": {}}, "model 'WordPiece'"),
    ("model.dropout", 0.1, "dropout"),
    ("model.continuing_subword_prefix", "##", "continuing_subword_prefix"),
    ("truncation", {"max_length": 8}, "truncation"),
]


@pytest.mark.parametrize("where,value,match", UNSUPPORTED, ids=[u[2] for u in UNSUPPORTED])
def test_unsupported_components_are_refused(where, value, match):
    spec = chip_smoke.llama3_tokenizer_spec(size=300, n_special=4)
    if where.startswith("model."):
        spec["model"][where[6:]] = value
    else:
        spec[where] = value
    with pytest.raises(ValueError, match=match):
        TokenizerJson(json.loads(json.dumps(spec)))


def test_load_tokenizer_paths(tmp_path):
    """A directory or the ``.json`` itself loads; no path is the byte
    tokenizer; a named path without a ``tokenizer.json`` raises (the JAX
    package serves bytes there)."""
    spec, bos, eos, _ = llama3()
    chip_smoke.write_tokenizer(str(tmp_path), spec)
    for path in (str(tmp_path), os.path.join(str(tmp_path), "tokenizer.json")):
        tok = load_tokenizer(path)
        assert isinstance(tok, HFTokenizer) and tok.eos_token_ids == [2009]
        assert tok.chat_template == chip_smoke.LLAMA3_CHAT_TEMPLATE
    assert isinstance(load_tokenizer(None), ByteTokenizer) and isinstance(load_tokenizer(""), ByteTokenizer)
    with pytest.raises(FileNotFoundError, match="no .*tokenizer.json"):
        load_tokenizer(str(tmp_path / "missing"))


def test_guided_token_strings_over_the_full_vocabulary(tmp_path):
    """Guided decoding's per-id strings over chip_smoke's 128,256-id
    Llama-3-layout file equal the JAX package's (the wheel's decode of each
    id alone), and a rendered Llama-3 header is one id each."""
    chip_smoke.write_tokenizer(str(tmp_path), chip_smoke.llama3_tokenizer_spec())
    mine, jax_tok = HFTokenizer(str(tmp_path)), JaxHFTokenizer(str(tmp_path))
    assert mine.vocab_size == jax_tok.vocab_size == 128256
    want = JaxGuidedDecoder(jax_tok, pool_rows=1)._token_strings()
    assert GuidedDecoder(mine, pool_rows=1)._token_strings() == want
    text = "<|start_header_id|>user<|end_header_id|>\n\nHello, how are the servers today?<|eot_id|>"
    assert mine.encode(text) == jax_tok.encode(text)
    assert mine.encode(text)[0] == 128006 and 128009 in mine.encode(text)
