"""The port's image reader (``dynamo_tpu_torch/llm/image_decode.py``)
against PIL, which the JAX package decodes image prompts with.

PNGs come from PIL's writer and from a writer here (grey and palette at
1/2/4 bits, every filter type, Adam7 interlace, which PIL does not write);
JPEGs from PIL's libjpeg-turbo writer at 4:4:4, 4:2:2 and 4:2:0, grey, odd
and non-square sizes and restart markers. A PNG's data URL must decode
bit-equal to the JAX package's ``decode_image_data_url``; a JPEG's aims at
bit equality and may differ by at most 1/255 (the largest difference seen
is written in ROADMAP Queue 3). Average and Paeth rows of wide, tall and
narrow PNGs are bit-equal to PIL's, and a tall one's decode allocates
linearly in its height. Refused formats raise a ``ValueError`` naming
them.
"""

from __future__ import annotations

import base64
import io
import struct
import zlib

import numpy as np
import pytest
from PIL import Image

from dynamo_tpu.llm.multimodal import decode_image_data_url as jax_decode
from dynamo_tpu_torch.llm import image_decode as dec

SIZES = [(32, 32), (224, 224), (33, 17), (17, 33), (101, 57), (3, 2)]


def _image(w: int, h: int, seed: int = 0) -> np.ndarray:
    """Smooth colour gradients plus noise: both the DCT's low and high
    frequencies carry energy."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    base = np.stack([128 + 100 * np.sin(x / 7.0 + c) * np.cos(y / 9.0 - c) for c in range(3)], -1)
    return np.clip(base + rng.normal(0, 20, base.shape), 0, 255).astype(np.uint8)


def _url(raw: bytes, kind: str = "png") -> str:
    return f"data:image/{kind};base64," + base64.b64encode(raw).decode()


def _pil_rgb(raw: bytes) -> np.ndarray:
    return np.asarray(Image.open(io.BytesIO(raw)).convert("RGB"))


def _save(im: Image.Image, fmt: str, **kw) -> bytes:
    buf = io.BytesIO()
    im.save(buf, fmt, **kw)
    return buf.getvalue()


@pytest.mark.parametrize("w,h", SIZES)
@pytest.mark.parametrize("mode", ["RGB", "RGBA", "L", "LA", "P", "1"])
def test_pil_png_bit_equal(mode, w, h):
    img = _image(w, h)
    rgba = np.concatenate([img, img[..., :1]], -1)
    im = Image.fromarray(rgba) if mode == "RGBA" else Image.fromarray(img).convert(mode)
    raw = _save(im, "PNG")
    np.testing.assert_array_equal(dec.decode_image(raw), _pil_rgb(raw))
    for size in (32, 224):
        np.testing.assert_array_equal(dec.decode_image_data_url(_url(raw), size), jax_decode(_url(raw), size))


def _chunk(kind: bytes, body: bytes) -> bytes:
    return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF)


def _filter_row(row: np.ndarray, prev: np.ndarray, kind: int, bpp: int) -> np.ndarray:
    """PNG's forward filter of one row of bytes (int arithmetic mod 256)."""
    r, p = row.astype(np.int32), prev.astype(np.int32)
    a = np.concatenate([np.zeros(bpp, np.int32), r[:-bpp]])
    c = np.concatenate([np.zeros(bpp, np.int32), p[:-bpp]])
    if kind == 0:
        pred = np.zeros_like(r)
    elif kind == 1:
        pred = a
    elif kind == 2:
        pred = p
    elif kind == 3:
        pred = (a + p) >> 1
    else:
        est = a + p - c
        pa, pb, pc = np.abs(est - a), np.abs(est - p), np.abs(est - c)
        pred = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, p, c))
    return ((r - pred) & 255).astype(np.uint8)


def _pack(samples: np.ndarray, depth: int) -> np.ndarray:
    """[h, w*ch] samples → [h, rowbytes] bytes at ``depth`` bits."""
    if depth == 8:
        return samples.astype(np.uint8)
    h, n = samples.shape
    per = 8 // depth
    pad = (-n) % per
    s = np.concatenate([samples, np.zeros((h, pad), samples.dtype)], 1).reshape(h, -1, per).astype(np.uint8)
    shifts = np.arange(8 - depth, -1, -depth, dtype=np.uint8)
    return (s << shifts).sum(axis=2).astype(np.uint8)


def _write_png(samples: np.ndarray, depth: int, ctype: int, *, interlace: bool, seed: int,
               palette: np.ndarray = None, kind: int = None) -> bytes:
    """A PNG of ``samples`` [h, w, ch] with a random filter type per row, or
    filter ``kind`` on every row."""
    rng = np.random.default_rng(seed)
    h, w, ch = samples.shape
    bpp = max(1, depth * ch // 8)
    passes = ([(x0, y0, dx, dy) for x0, y0, dx, dy in dec._ADAM7] if interlace else [(0, 0, 1, 1)])
    data = bytearray()
    for x0, y0, dx, dy in passes:
        sub = samples[y0::dy, x0::dx]
        if sub.size == 0:
            continue
        rows = _pack(sub.reshape(sub.shape[0], -1), depth)
        prev = np.zeros(rows.shape[1], np.uint8)
        for row in rows:
            k = int(rng.integers(0, 5)) if kind is None else kind
            data.append(k)
            data += _filter_row(row, prev, k, bpp).tobytes()
            prev = row
    out = b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, ctype, 0, 0, int(interlace)))
    if palette is not None:
        out += _chunk(b"PLTE", palette.tobytes())
    return out + _chunk(b"IDAT", zlib.compress(bytes(data))) + _chunk(b"IEND", b"")


CASES = [(0, 1), (0, 2), (0, 4), (0, 8), (3, 1), (3, 2), (3, 4), (3, 8), (2, 8), (4, 8), (6, 8)]


@pytest.mark.parametrize("interlace", [False, True])
@pytest.mark.parametrize("ctype,depth", CASES)
def test_written_png_bit_equal(ctype, depth, interlace):
    rng = np.random.default_rng(ctype * 10 + depth)
    w, h = (37, 23) if interlace else (29, 41)
    ch = dec._PNG_CHANNELS[ctype]
    top = (1 << depth) - 1
    palette = None
    if ctype == 3:
        palette = rng.integers(0, 256, (top + 1, 3), dtype=np.uint8)
    samples = rng.integers(0, top + 1, (h, w, ch)).astype(np.uint8)
    raw = _write_png(samples, depth, ctype, interlace=interlace, seed=depth, palette=palette)
    np.testing.assert_array_equal(dec.decode_image(raw), _pil_rgb(raw))
    np.testing.assert_array_equal(dec.decode_image_data_url(_url(raw), 32), jax_decode(_url(raw), 32))


# Average and Paeth rows are undone along anti-diagonals, in bands of rows:
# wide, tall and narrow images against PIL, bit for bit.
@pytest.mark.parametrize("kind", [3, 4, None], ids=["average", "paeth", "random"])
@pytest.mark.parametrize("w,h", [(8000, 1), (1, 8000), (4000, 3), (300, 200)])
def test_average_and_paeth_rows_bit_equal_at_any_shape(w, h, kind):
    samples = np.random.default_rng(w * 7 + h).integers(0, 256, (h, w, 3)).astype(np.uint8)
    raw = _write_png(samples, 8, 2, interlace=False, seed=w + h, kind=kind)
    np.testing.assert_array_equal(dec.decode_image(raw), _pil_rgb(raw))


def test_unfilter_memory_is_linear_in_height():
    """A 1-wide, 8000-tall Paeth PNG (28 KB): the decode's peak allocation
    stays under 50× its pixel bytes (one wavefront over every row held
    [h + w − 1, h, bpp] int16 arrays, 0.38 GB each here)."""
    import tracemalloc

    samples = np.random.default_rng(3).integers(0, 256, (8000, 1, 3)).astype(np.uint8)
    raw = _write_png(samples, 8, 2, interlace=False, seed=0, kind=4)
    tracemalloc.start()
    try:
        got = dec.decode_image(raw)
        peak = tracemalloc.get_traced_memory()[1]
    finally:
        tracemalloc.stop()
    np.testing.assert_array_equal(got, samples)
    assert peak < 50 * samples.nbytes, peak


JPEG_MAX_DIFF = 1  # in 8-bit steps, i.e. 1/255 after the division


@pytest.mark.parametrize("w,h", SIZES)
@pytest.mark.parametrize("sub,mode", [(0, "RGB"), (1, "RGB"), (2, "RGB"), (0, "L")])
def test_pil_jpeg_matches(w, h, sub, mode):
    img = _image(w, h, seed=w + h)
    for quality in (75, 95):
        kw = {"subsampling": sub} if mode == "RGB" else {}
        raw = _save(Image.fromarray(img).convert(mode), "JPEG", quality=quality, **kw)
        diff = np.abs(dec.decode_image(raw).astype(int) - _pil_rgb(raw)).max()
        assert diff <= JPEG_MAX_DIFF, (quality, diff)
        for size in (32, 224):
            got = dec.decode_image_data_url(_url(raw, "jpeg"), size)
            assert np.abs(got - jax_decode(_url(raw, "jpeg"), size)).max() <= JPEG_MAX_DIFF / 255 + 1e-7


@pytest.mark.parametrize("sub", [0, 2])
def test_jpeg_restart_markers(sub):
    img = _image(61, 45, seed=3)
    raw = _save(Image.fromarray(img), "JPEG", quality=90, subsampling=sub, restart_marker_blocks=3)
    assert b"\xff\xdd" in raw and b"\xff\xd0" in raw
    assert np.abs(dec.decode_image(raw).astype(int) - _pil_rgb(raw)).max() <= JPEG_MAX_DIFF


def _refused():
    img = Image.fromarray(_image(24, 16))
    baseline = _save(img, "JPEG")
    sof = baseline.index(b"\xff\xc0")
    return [
        ("progressive JPEG", _save(img, "JPEG", progressive=True)),
        ("arithmetic-coded JPEG", baseline[:sof + 1] + b"\xc9" + baseline[sof + 2:]),
        ("CMYK JPEG", _save(img.convert("CMYK"), "JPEG")),
        ("16-bit PNG", _save(Image.fromarray(np.zeros((8, 8), np.uint16)), "PNG")),
        ("GIF", _save(img, "GIF")),
        ("WebP", _save(img, "WEBP")),
        ("unknown", b"not an image at all"),
    ]


@pytest.mark.parametrize("name,raw", _refused(), ids=lambda x: x if isinstance(x, str) else "")
def test_refused_formats_name_themselves(name, raw):
    with pytest.raises(ValueError, match=name):
        dec.decode_image_data_url(_url(raw), 32)


def test_data_url_errors_match_jax():
    for url in ("https://example.com/cat.png", "data:image/png;base64"):
        with pytest.raises(ValueError) as jax_err:
            jax_decode(url, 32)
        with pytest.raises(ValueError) as port_err:
            dec.decode_image_data_url(url, 32)
        assert str(port_err.value) == str(jax_err.value)


@pytest.mark.parametrize("w,h", [(640, 480), (31, 57), (1000, 20), (17, 500), (224, 100)])
def test_resize_bit_equal(w, h):
    img = np.random.default_rng(w * h).integers(0, 256, (h, w, 3), dtype=np.uint8)
    for size in (7, 32, 224):
        want = np.asarray(Image.fromarray(img).resize((size, size)))
        np.testing.assert_array_equal(dec.resize_bicubic(img, size), want)
