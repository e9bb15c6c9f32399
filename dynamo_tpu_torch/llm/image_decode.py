"""Image reader for image prompts: PNG and baseline JPEG, resized as PIL does.

The JAX package decodes an image prompt with PIL,
``Image.open(...).convert("RGB").resize((size, size))`` divided by 255
(``llm/multimodal.py``); the card's machine has no PIL, so the port reads
the two formats itself, on numpy and the standard library's ``zlib``:

- **PNG**: bit depths 1/2/4/8, colour types 0 (grey), 2 (RGB), 3
  (palette), 4 (grey + alpha) and 6 (RGBA), filters 0-4, Adam7
  interlace. Grey below 8 bits scales as PIL's unpackers do (×255, ×85,
  ×17); alpha is dropped as ``convert("RGB")`` drops it.
- **Baseline JPEG** (SOF0/SOF1, 8-bit, sequential Huffman): grey or
  YCbCr (RGB with an Adobe transform of 0), luma sampling 1×1, 2×1 or
  2×2 over 1×1 chroma, restart markers. PIL decodes with libjpeg-turbo's
  defaults, so this follows its integer IDCT (``jidctint.c``), its fancy
  (triangle) upsampling (``jdsample.c``, edge rows and columns
  replicated) and its YCbCr→RGB tables (``jdcolor.c``).
- **Resize**: PIL's default for RGB, BICUBIC with a = -0.5 and the
  support widened by the scale factor, 22-bit fixed-point coefficients,
  one clipped 8-bit pass per axis, horizontal first (Pillow's
  ``Resample.c``). A same-size image is returned as it is.

Anything else (progressive or arithmetic-coded JPEG, CMYK, 16-bit PNG,
GIF, WebP, ...) raises a ``ValueError`` that names the format; the HTTP
service answers it with a 400.
"""

from __future__ import annotations

import base64
import struct
import zlib
from typing import List, Tuple

import numpy as np


def decode_image_data_url(url: str, size: int) -> np.ndarray:
    """``data:image/...;base64,...`` → ``[size, size, 3]`` f32 in [0, 1],
    as the JAX package's PIL path gives it."""
    if not url.startswith("data:"):
        raise ValueError("only data: image URLs are supported (zero-egress environment)")
    try:
        raw = base64.b64decode(url.split(",", 1)[1])
    except (IndexError, ValueError) as e:
        raise ValueError(f"malformed image data URL: {e}") from None
    return resize_bicubic(decode_image(raw), size).astype(np.float32) / 255.0


def decode_image(raw: bytes) -> np.ndarray:
    """PNG or baseline JPEG bytes → ``[H, W, 3]`` uint8 RGB."""
    if raw.startswith(b"\x89PNG\r\n\x1a\n"):
        return decode_png(raw)
    if raw.startswith(b"\xff\xd8"):
        return decode_jpeg(raw)
    raise ValueError(f"unsupported image format: {_sniff(raw)} (the reader takes PNG and baseline JPEG)")


def _sniff(raw: bytes) -> str:
    if raw[:6] in (b"GIF87a", b"GIF89a"):
        return "GIF"
    if raw[:4] == b"RIFF" and raw[8:12] == b"WEBP":
        return "WebP"
    if raw[:2] == b"BM":
        return "BMP"
    if raw[:4] in (b"II*\x00", b"MM\x00*"):
        return "TIFF"
    return "unknown"


# ---------------------------------------------------------------------------
# PNG
# ---------------------------------------------------------------------------

_PNG_DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8), 4: (8, 16), 6: (8, 16)}
_PNG_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))


def decode_png(raw: bytes) -> np.ndarray:
    pos, ihdr, plte, idat = 8, None, None, []
    while pos + 8 <= len(raw):
        length, kind = struct.unpack(">I4s", raw[pos:pos + 8])
        body = raw[pos + 8:pos + 8 + length]
        pos += 12 + length
        if kind == b"IHDR":
            ihdr = struct.unpack(">IIBBBBB", body[:13])
        elif kind == b"PLTE":
            plte = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if ihdr is None or not idat:
        raise ValueError("malformed PNG: no IHDR or IDAT")
    w, h, depth, ctype, _, _, interlace = ihdr
    if ctype not in _PNG_DEPTHS or depth not in _PNG_DEPTHS[ctype]:
        raise ValueError(f"malformed PNG: colour type {ctype} at bit depth {depth}")
    if depth == 16:
        raise ValueError("16-bit PNG is not supported")
    if ctype == 3 and plte is None:
        raise ValueError("malformed PNG: palette image without PLTE")
    if not w or not h:
        raise ValueError("malformed PNG: empty image")
    data = zlib.decompress(b"".join(idat))
    nch = _PNG_CHANNELS[ctype]
    if interlace:
        samples = np.zeros((h, w, nch), np.uint8)
        off = 0
        for x0, y0, dx, dy in _ADAM7:
            pw, ph = -(-(w - x0) // dx), -(-(h - y0) // dy)
            if pw <= 0 or ph <= 0:
                continue
            sub, off = _png_pass(data, off, pw, ph, depth, nch)
            samples[y0::dy, x0::dx] = sub
    else:
        samples, _ = _png_pass(data, 0, w, h, depth, nch)
    if ctype == 3:
        pal = np.zeros((256, 3), np.uint8)
        pal[: len(plte)] = plte[:256]
        return pal[samples[..., 0]]
    if ctype in (0, 4):
        grey = samples[..., 0]
        if depth < 8:
            grey = (grey.astype(np.uint16) * (255 // ((1 << depth) - 1))).astype(np.uint8)
        return np.repeat(grey[..., None], 3, axis=2)
    return np.ascontiguousarray(samples[..., :3])


def _png_pass(data: bytes, off: int, w: int, h: int, depth: int, nch: int) -> Tuple[np.ndarray, int]:
    """One (sub)image's filtered scanlines from ``data[off:]`` → ``([h, w,
    nch] samples, the offset past them)``."""
    bits = depth * nch
    rowbytes = (w * bits + 7) // 8
    bpp = max(1, bits // 8)
    n = h * (rowbytes + 1)
    if len(data) < off + n:
        raise ValueError("malformed PNG: truncated image data")
    rows = np.frombuffer(data, np.uint8, n, off).reshape(h, rowbytes + 1)
    kinds = rows[:, 0]
    if kinds.max(initial=0) > 4:
        raise ValueError(f"malformed PNG: filter type {int(kinds.max())}")
    recon = _unfilter(rows[:, 1:], kinds, bpp)
    if depth == 8:
        return recon.reshape(h, w, nch), off + n
    per = 8 // depth
    shifts = np.arange(8 - depth, -1, -depth, dtype=np.uint8)
    vals = (recon[:, :, None] >> shifts) & ((1 << depth) - 1)
    return vals.reshape(h, rowbytes * per)[:, :w, None], off + n


def _unfilter(x: np.ndarray, kinds: np.ndarray, bpp: int) -> np.ndarray:
    """Undo PNG's per-row filters. Rows of None/Sub/Up are undone a row at
    a time in numpy; Average and Paeth depend on the byte to the left, so
    an image that uses them is undone along anti-diagonals of pixels (a
    pixel needs only its left, upper and upper-left neighbours), in bands
    of rows (``_band_rows``), so time and memory grow linearly with the
    height."""
    h, rb = x.shape
    if not np.isin(kinds, (3, 4)).any():
        out = np.empty_like(x)
        prev = np.zeros(rb, np.uint8)
        for r in range(h):
            row, k = x[r], kinds[r]
            if k == 1:
                row = (np.cumsum(row.reshape(-1, bpp), axis=0, dtype=np.int64) & 255).astype(np.uint8).reshape(-1)
            elif k == 2:
                row = row + prev
            out[r] = row
            prev = out[r]
        return out
    w = rb // bpp
    x = x.reshape(h, w, bpp)
    out = np.empty((h, w, bpp), np.uint8)
    above = np.zeros((w, bpp), np.int16)  # the zero row above the image
    step = _band_rows(h, w)
    for r0 in range(0, h, step):
        band = _unfilter_band(x[r0:r0 + step], kinds[r0:r0 + step], above)
        out[r0:r0 + step] = band
        above = band[-1]
    return out.reshape(h, rb)


def _band_rows(h: int, w: int) -> int:
    """Rows per band: a band of k rows loops over its k + w - 1 diagonals
    and holds ``[k + w + 1, k + 1, bpp]`` skewed arrays, so k doubles from
    16 while those stay within about 4× the image's own size (a wide image
    is one band; a tall narrow one, bands of a few dozen rows)."""
    k = 16
    while k < h and (2 * k) * (2 * k + w) <= 4 * h * w:
        k *= 2
    return min(k, h)


def _unfilter_band(x: np.ndarray, kinds: np.ndarray, above: np.ndarray) -> np.ndarray:
    """One band of ``x`` (``[k, w, bpp]`` filtered bytes, the band's filter
    types), below the reconstructed row ``above`` (``[w, bpp]``) →
    ``[k, w, bpp]`` int16 reconstructed bytes."""
    k, w, bpp = x.shape
    # Skewed layout: diagonal d = r + j is row d + 2 of ``st`` (diagonals -2
    # and -1 come first), band row r its column r + 1, and column 0 the row
    # above the band (its pixel j on diagonal j - 1). Pixel (r, j)'s left
    # neighbour is then st[d+1, r+1], its upper one st[d+1, r] and its
    # upper-left st[d, r]: whole diagonals are contiguous slices.
    n_diag = k + w - 1
    rr, jj = np.meshgrid(np.arange(k), np.arange(w), indexing="ij")
    xt = np.zeros((n_diag, k, bpp), np.int16)
    xt[rr + jj, rr] = x
    live = np.zeros((n_diag, k, 1), bool)
    live[rr + jj, rr] = True
    st = np.zeros((n_diag + 2, k + 1, bpp), np.int16)
    st[1:w + 1, 0] = above
    t = kinds.astype(np.int16)[:, None]
    sub, up, avg, paeth = t == 1, t == 2, t == 3, t == 4
    any_paeth = bool(paeth.any())
    for d in range(n_diag):
        a, b, c = st[d + 1, 1:], st[d + 1, :-1], st[d, :-1]
        pred = np.where(sub, a, np.where(up, b, np.where(avg, (a + b) >> 1, 0)))
        if any_paeth:
            p = a + b - c
            pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
            pred = np.where(paeth, np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c)), pred)
        st[d + 2, 1:] = np.where(live[d], (xt[d] + pred) & 255, 0)
    return st[rr + jj + 2, rr + 1]


# ---------------------------------------------------------------------------
# Baseline JPEG (libjpeg-turbo's integer IDCT, fancy upsampling, YCbCr tables)
# ---------------------------------------------------------------------------

_ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5, 12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21,
    28, 35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51, 58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61,
    54, 47, 55, 62, 63])
_SOF_REFUSED = {0xC2: "progressive JPEG", 0xC3: "lossless JPEG", 0xC5: "hierarchical JPEG",
                0xC6: "hierarchical progressive JPEG", 0xC7: "hierarchical lossless JPEG",
                0xC9: "arithmetic-coded JPEG", 0xCA: "arithmetic-coded progressive JPEG",
                0xCB: "arithmetic-coded lossless JPEG", 0xCD: "arithmetic-coded hierarchical JPEG",
                0xCE: "arithmetic-coded hierarchical progressive JPEG",
                0xCF: "arithmetic-coded hierarchical lossless JPEG"}


class _Huffman:
    """A canonical Huffman table as a 16-bit lookahead: ``look[peek16]`` =
    ``(code length << 8) | symbol``."""

    def __init__(self, counts: bytes, symbols: bytes):
        look = [0] * 65536
        code, k = 0, 0
        for length in range(1, 17):
            for _ in range(counts[length - 1]):
                span = 1 << (16 - length)
                look[code * span:(code + 1) * span] = [(length << 8) | symbols[k]] * span
                code += 1
                k += 1
            code <<= 1
        self.look = look


def decode_jpeg(raw: bytes) -> np.ndarray:
    qt: dict = {}
    dc: dict = {}
    ac: dict = {}
    frame = None
    restart = 0
    jfif = adobe = False
    adobe_transform = None
    coefs: List[np.ndarray] = []
    pos = 2
    while pos < len(raw):
        if raw[pos] != 0xFF:
            raise ValueError("malformed JPEG: marker expected")
        marker = raw[pos + 1]
        pos += 2
        if marker == 0xD9:  # EOI
            break
        if marker in (0xD8, 0x01) or 0xD0 <= marker <= 0xD7 or marker == 0xFF:
            pos -= 1 if marker == 0xFF else 0
            continue
        length = struct.unpack(">H", raw[pos:pos + 2])[0]
        seg = raw[pos + 2:pos + length]
        pos += length
        if marker == 0xDB:
            _read_dqt(seg, qt)
        elif marker == 0xC4:
            _read_dht(seg, dc, ac)
        elif marker == 0xDD:
            restart = struct.unpack(">H", seg[:2])[0]
        elif marker == 0xE0 and seg.startswith(b"JFIF\x00"):
            jfif = True
        elif marker == 0xEE and seg.startswith(b"Adobe") and len(seg) >= 12:
            adobe, adobe_transform = True, seg[11]
        elif marker in _SOF_REFUSED:
            raise ValueError(f"{_SOF_REFUSED[marker]} is not supported (baseline JPEG only)")
        elif marker in (0xC0, 0xC1):
            frame = _read_sof(seg)
            coefs = [np.zeros((c["bh"], c["bw"], 64), np.int64) for c in frame["comps"]]
        elif marker == 0xDA:
            if frame is None:
                raise ValueError("malformed JPEG: scan before frame header")
            pos = _read_scan(raw, pos, seg, frame, coefs, dc, ac, restart)
    if frame is None:
        raise ValueError("malformed JPEG: no frame header")
    planes = []
    for comp, coef in zip(frame["comps"], coefs):
        if comp["tq"] not in qt:
            raise ValueError("malformed JPEG: missing quantization table")
        deq = coef * qt[comp["tq"]][None, None, :]
        blocks = _idct_islow(deq.reshape(-1, 8, 8))
        bh, bw = coef.shape[:2]
        plane = blocks.reshape(bh, bw, 8, 8).transpose(0, 2, 1, 3).reshape(bh * 8, bw * 8)
        planes.append(plane[: comp["dh"], : comp["dw"]])
    W, H = frame["w"], frame["h"]
    if len(planes) == 1:
        return np.repeat(planes[0][:H, :W, None], 3, axis=2)
    hmax, vmax = frame["hmax"], frame["vmax"]
    full = [planes[0][:H, :W]]
    for comp, plane in zip(frame["comps"][1:], planes[1:]):
        full.append(_upsample(plane, hmax // comp["h"], vmax // comp["v"])[:H, :W])
    rgb_ids = [c["id"] for c in frame["comps"]] == [82, 71, 66]
    if (adobe and adobe_transform == 0 and not jfif) or (not jfif and not adobe and rgb_ids):
        return np.stack(full, axis=2).astype(np.uint8)
    return _ycc_to_rgb(*full)


def _read_dqt(seg: bytes, qt: dict) -> None:
    i = 0
    while i < len(seg):
        pq, tq = seg[i] >> 4, seg[i] & 15
        n = 128 if pq else 64
        vals = np.frombuffer(seg, ">u2" if pq else np.uint8, 64, i + 1).astype(np.int64)
        table = np.zeros(64, np.int64)
        table[_ZIGZAG] = vals
        qt[tq] = table
        i += 1 + n


def _read_dht(seg: bytes, dc: dict, ac: dict) -> None:
    i = 0
    while i < len(seg):
        tc, th = seg[i] >> 4, seg[i] & 15
        counts = seg[i + 1:i + 17]
        n = sum(counts)
        (ac if tc else dc)[th] = _Huffman(counts, seg[i + 17:i + 17 + n])
        i += 17 + n


def _read_sof(seg: bytes) -> dict:
    precision, h, w, nf = struct.unpack(">BHHB", seg[:6])
    if precision != 8:
        raise ValueError(f"{precision}-bit JPEG is not supported (8-bit baseline only)")
    if nf == 4:
        raise ValueError("CMYK JPEG is not supported")
    if nf not in (1, 3):
        raise ValueError(f"JPEG with {nf} components is not supported")
    if not h or not w:
        raise ValueError("malformed JPEG: empty image")
    comps = []
    for k in range(nf):
        cid, hv, tq = seg[6 + 3 * k:9 + 3 * k]
        comps.append({"id": cid, "h": hv >> 4, "v": hv & 15, "tq": tq})
    if nf == 1:
        comps[0]["h"] = comps[0]["v"] = 1  # a lone component is never subsampled
    elif (comps[0]["h"], comps[0]["v"]) not in ((1, 1), (2, 1), (2, 2)) or any(
            (c["h"], c["v"]) != (1, 1) for c in comps[1:]):
        raise ValueError("JPEG sampling factors " + ",".join(f"{c['h']}x{c['v']}" for c in comps)
                         + " are not supported (luma 1x1, 2x1 or 2x2 over 1x1 chroma)")
    hmax, vmax = max(c["h"] for c in comps), max(c["v"] for c in comps)
    mcux, mcuy = -(-w // (8 * hmax)), -(-h // (8 * vmax))
    for c in comps:
        c["dw"], c["dh"] = -(-w * c["h"] // hmax), -(-h * c["v"] // vmax)  # downsampled size
        c["bw"], c["bh"] = mcux * c["h"], mcuy * c["v"]  # blocks, padded to whole MCUs
    return {"w": w, "h": h, "comps": comps, "hmax": hmax, "vmax": vmax, "mcux": mcux, "mcuy": mcuy}


def _entropy_segments(raw: bytes, pos: int) -> Tuple[List[bytes], int]:
    """The scan's entropy-coded data from ``pos``, split at its restart
    markers and unstuffed → (segments, offset of the marker that ends it)."""
    segs, start, i = [], pos, pos
    n = len(raw)
    while True:
        i = raw.find(b"\xff", i)
        if i < 0 or i + 1 >= n:
            segs.append(raw[start:].replace(b"\xff\x00", b"\xff"))
            return segs, n
        m = raw[i + 1]
        if m == 0x00 or m == 0xFF:
            i += 1
        elif 0xD0 <= m <= 0xD7:
            segs.append(raw[start:i].replace(b"\xff\x00", b"\xff"))
            start = i = i + 2
        else:
            segs.append(raw[start:i].replace(b"\xff\x00", b"\xff"))
            return segs, i


def _read_scan(raw: bytes, pos: int, seg: bytes, frame: dict, coefs: list, dc: dict, ac: dict,
               restart: int) -> int:
    ns = seg[0]
    by_id = {c["id"]: k for k, c in enumerate(frame["comps"])}
    members = []
    for k in range(ns):
        cid, tables = seg[1 + 2 * k], seg[2 + 2 * k]
        ci = by_id[cid]
        if (tables >> 4) not in dc or (tables & 15) not in ac:
            raise ValueError("malformed JPEG: missing Huffman table")
        members.append((ci, dc[tables >> 4].look, ac[tables & 15].look))
    segs, end = _entropy_segments(raw, pos)
    comps = frame["comps"]
    if ns == 1:
        # Non-interleaved: one block per MCU over the component's own grid.
        ci = members[0][0]
        c = comps[ci]
        units = [[(members[0], by, bx)] for by in range(-(-c["dh"] // 8)) for bx in range(-(-c["dw"] // 8))]
    else:
        units = []
        for my in range(frame["mcuy"]):
            for mx in range(frame["mcux"]):
                units.append([(m, my * comps[m[0]]["v"] + y, mx * comps[m[0]]["h"] + x)
                              for m in members for y in range(comps[m[0]]["v"]) for x in range(comps[m[0]]["h"])])
    per_seg = restart if restart else len(units)
    zz = _ZIGZAG.tolist()
    for s, seg_data in enumerate(segs):
        chunk = units[s * per_seg:(s + 1) * per_seg]
        if not chunk:
            break
        _decode_units(seg_data, chunk, coefs, zz)
    return end


def _decode_units(data: bytes, units: list, coefs: list, zz: list) -> None:
    """Huffman-decode the blocks of ``units`` from one restart interval
    (DC predictions start at 0) into ``coefs`` (natural order)."""
    data = data + b"\x00\x00\x00\x00"
    nbits = (len(data) - 4) * 8
    bitpos = 0
    pred: dict = {}
    frombytes = int.from_bytes

    for unit in units:
        for (ci, dlook, alook), by, bx in unit:
            blk = [0] * 64
            # DC
            p = bitpos >> 3
            e = dlook[(frombytes(data[p:p + 3], "big") >> (8 - (bitpos & 7))) & 0xFFFF]
            if not e:
                raise ValueError("malformed JPEG: bad Huffman code")
            bitpos += e >> 8
            t = e & 255
            diff = 0
            if t:
                p = bitpos >> 3
                v = (frombytes(data[p:p + 4], "big") >> (32 - (bitpos & 7) - t)) & ((1 << t) - 1)
                bitpos += t
                diff = v if v >= 1 << (t - 1) else v - (1 << t) + 1
            d = pred.get(ci, 0) + diff
            pred[ci] = d
            blk[0] = d
            k = 1
            while k < 64:
                p = bitpos >> 3
                e = alook[(frombytes(data[p:p + 3], "big") >> (8 - (bitpos & 7))) & 0xFFFF]
                if not e:
                    raise ValueError("malformed JPEG: bad Huffman code")
                bitpos += e >> 8
                rs = e & 255
                r, t = rs >> 4, rs & 15
                if t:
                    k += r
                    p = bitpos >> 3
                    v = (frombytes(data[p:p + 4], "big") >> (32 - (bitpos & 7) - t)) & ((1 << t) - 1)
                    bitpos += t
                    if k < 64:
                        blk[zz[k]] = v if v >= 1 << (t - 1) else v - (1 << t) + 1
                    k += 1
                elif r == 15:
                    k += 16
                else:
                    break
            coefs[ci][by, bx] = blk
    if bitpos > nbits + 64:
        raise ValueError("malformed JPEG: truncated scan")


# jidctint.c's constants (CONST_BITS 13, PASS1_BITS 2).
_F = {"0_298631336": 2446, "0_390180644": 3196, "0_541196100": 4433, "0_765366865": 6270, "0_899976223": 7373,
      "1_175875602": 9633, "1_501321110": 12299, "1_847759065": 15137, "1_961570560": 16069, "2_053119869": 16819,
      "2_562915447": 20995, "3_072711026": 25172}


def _idct_1d(x0, x1, x2, x3, x4, x5, x6, x7, shift: int) -> list:
    """One 1-D pass of ``jpeg_idct_islow`` over int64 arrays (inputs are
    frequencies 0..7; the even part is scaled by 2**13), each output
    descaled by ``shift`` bits with rounding."""
    z1 = (x2 + x6) * _F["0_541196100"]
    tmp2 = z1 - x6 * _F["1_847759065"]
    tmp3 = z1 + x2 * _F["0_765366865"]
    tmp0 = (x0 + x4) << 13
    tmp1 = (x0 - x4) << 13
    tmp10, tmp13 = tmp0 + tmp3, tmp0 - tmp3
    tmp11, tmp12 = tmp1 + tmp2, tmp1 - tmp2
    t0, t1, t2, t3 = x7, x5, x3, x1
    z1, z2, z3, z4 = t0 + t3, t1 + t2, t0 + t2, t1 + t3
    z5 = (z3 + z4) * _F["1_175875602"]
    t0 = t0 * _F["0_298631336"]
    t1 = t1 * _F["2_053119869"]
    t2 = t2 * _F["3_072711026"]
    t3 = t3 * _F["1_501321110"]
    z1 = z1 * -_F["0_899976223"]
    z2 = z2 * -_F["2_562915447"]
    z3 = z3 * -_F["1_961570560"] + z5
    z4 = z4 * -_F["0_390180644"] + z5
    t0 = t0 + z1 + z3
    t1 = t1 + z2 + z4
    t2 = t2 + z2 + z3
    t3 = t3 + z1 + z4
    half = 1 << (shift - 1)
    return [(v + half) >> shift for v in (tmp10 + t3, tmp11 + t2, tmp12 + t1, tmp13 + t0,
                                          tmp13 - t0, tmp12 - t1, tmp11 - t2, tmp10 - t3)]


# The post-IDCT range limit (jdmaster.c): index (x & 1023) → clamp(x + 128).
_RANGE = np.concatenate([np.arange(128, 256), np.full(384, 255), np.zeros(384), np.arange(0, 128)]).astype(np.uint8)


def _idct_islow(blocks: np.ndarray) -> np.ndarray:
    """Dequantized coefficient blocks ``[N, 8, 8]`` (row = vertical
    frequency) → samples ``[N, 8, 8]`` uint8: columns first into the
    workspace (descaled by 11 bits), then rows (by 18)."""
    ws = _idct_1d(*[blocks[:, k, :] for k in range(8)], shift=13 - 2)  # 8 × [N, 8 cols]
    ws = np.stack(ws, axis=1)  # [N, row, col]
    out = _idct_1d(*[ws[:, :, k] for k in range(8)], shift=13 + 2 + 3)  # 8 × [N, 8 rows]
    return _RANGE[np.stack(out, axis=2) & 1023]


def _upsample(plane: np.ndarray, fh: int, fv: int) -> np.ndarray:
    """libjpeg-turbo's chroma upsampling by (fh, fv) ∈ {(1,1), (2,1),
    (2,2)}: the triangle filter ("fancy") where the plane is wider than 2
    samples, else replication."""
    if fh == 1 and fv == 1:
        return plane
    p = plane.astype(np.int32)
    if p.shape[1] <= 2:
        return np.repeat(np.repeat(plane, fh, axis=1), fv, axis=0)
    if fv == 1:
        left = np.concatenate([p[:, :1], p[:, :-1]], axis=1)
        right = np.concatenate([p[:, 1:], p[:, -1:]], axis=1)
        out = np.empty((p.shape[0], 2 * p.shape[1]), np.int32)
        out[:, 0::2] = (3 * p + left + 1) >> 2
        out[:, 1::2] = (3 * p + right + 2) >> 2
        return out.astype(np.uint8)
    above = np.concatenate([p[:1], p[:-1]], axis=0)
    below = np.concatenate([p[1:], p[-1:]], axis=0)
    rows = []
    for near in (above, below):
        cs = 3 * p + near  # column sums toward the nearer row
        left = np.concatenate([cs[:, :1], cs[:, :-1]], axis=1)
        right = np.concatenate([cs[:, 1:], cs[:, -1:]], axis=1)
        out = np.empty((p.shape[0], 2 * p.shape[1]), np.int32)
        out[:, 0::2] = (3 * cs + left + 8) >> 4
        out[:, 1::2] = (3 * cs + right + 7) >> 4
        rows.append(out)
    full = np.empty((2 * p.shape[0], 2 * p.shape[1]), np.int32)
    full[0::2], full[1::2] = rows
    return full.astype(np.uint8)


def _ycc_tables():
    x = np.arange(256, dtype=np.int64) - 128
    fix = lambda v: int(v * 65536 + 0.5)  # noqa: E731
    half = 1 << 15
    return ((fix(1.40200) * x + half) >> 16, (fix(1.77200) * x + half) >> 16, -fix(0.71414) * x,
            -fix(0.34414) * x + half)


_CR_R, _CB_B, _CR_G, _CB_G = _ycc_tables()


def _ycc_to_rgb(y: np.ndarray, cb: np.ndarray, cr: np.ndarray) -> np.ndarray:
    y = y.astype(np.int64)
    r = y + _CR_R[cr]
    g = y + ((_CB_G[cb] + _CR_G[cr]) >> 16)
    b = y + _CB_B[cb]
    return np.clip(np.stack([r, g, b], axis=2), 0, 255).astype(np.uint8)


# ---------------------------------------------------------------------------
# Resize (Pillow's Resample.c, BICUBIC)
# ---------------------------------------------------------------------------

_PRECISION_BITS = 32 - 8 - 2


def _bicubic(x: np.ndarray) -> np.ndarray:
    a = -0.5
    x = np.abs(x)
    near = ((a + 2.0) * x - (a + 3.0)) * x * x + 1
    far = (((x - 5) * x + 8) * x - 4) * a
    return np.where(x < 1.0, near, np.where(x < 2.0, far, 0.0))


def _resize_weights(in_size: int, out_size: int) -> Tuple[np.ndarray, np.ndarray]:
    """Pillow's ``precompute_coeffs`` + ``normalize_coeffs_8bpc``, all
    outputs at once → ``(idx, k)``, each ``[out, ksize]``: the input index
    and the 22-bit fixed-point weight of each tap (0 past the window)."""
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = 2.0 * filterscale
    ksize = int(np.ceil(support)) * 2 + 1
    center = (np.arange(out_size) + 0.5) * scale
    xmin = np.maximum((center - support + 0.5).astype(np.int64), 0)  # C's (int) truncates
    xmax = np.minimum((center + support + 0.5).astype(np.int64), in_size) - xmin
    taps = np.arange(ksize)
    live = taps[None, :] < xmax[:, None]
    w = np.where(live, _bicubic((taps[None, :] + xmin[:, None] - center[:, None] + 0.5) * (1.0 / filterscale)), 0.0)
    total = np.zeros(out_size)
    for t in range(ksize):  # the C loop's summation order
        total = total + w[:, t]
    w = np.where(total[:, None] != 0.0, w / np.where(total == 0.0, 1.0, total)[:, None], w)
    scaled = w * (1 << _PRECISION_BITS)
    k = np.trunc(np.where(w < 0, scaled - 0.5, scaled + 0.5)).astype(np.int64)
    return np.minimum(xmin[:, None] + taps[None, :], in_size - 1), np.where(live, k, 0)


def _resize_axis(x: np.ndarray, axis: int, size: int) -> np.ndarray:
    """One pass of ``ImagingResample{Horizontal,Vertical}_8bpc`` along
    ``axis`` of a uint8 image: integer sums from ``1 << 21``, clipped."""
    idx, k = _resize_weights(x.shape[axis], size)
    taps = np.take(x, idx, axis=axis).astype(np.int64)  # axis → [size, ksize]
    shape = [1] * taps.ndim
    shape[axis], shape[axis + 1] = k.shape
    acc = (taps * k.reshape(shape)).sum(axis=axis + 1) + (1 << (_PRECISION_BITS - 1))
    return np.clip(acc >> _PRECISION_BITS, 0, 255).astype(np.uint8)


def resize_bicubic(img: np.ndarray, size: int) -> np.ndarray:
    """``[H, W, 3]`` uint8 → ``[size, size, 3]`` uint8, bit-equal to PIL's
    ``Image.resize((size, size))`` of an RGB image (horizontal pass first,
    each pass rounded and clipped to 8 bits)."""
    h, w = img.shape[:2]
    if (h, w) == (size, size):
        return img
    x = img
    if w != size:
        x = _resize_axis(x, 1, size)
    if h != size:
        x = _resize_axis(x, 0, size)
    return x
