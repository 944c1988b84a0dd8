"""A minimal PNG codec on ``zlib`` and numpy (the port's stand-in for PIL).

The port reads and writes its datasets with this module on every machine,
so it needs no imaging library. It covers what an RGB-D dataset holds:

- 8- or 16-bit gray (depth maps are 16-bit), gray + alpha, RGB and RGBA;
- non-interlaced images, with any of the five filter types per row,
  undone by the host core (``native.py``, ``csrc/qedcore.cpp``); the row
  loops :func:`_paeth_row` and :func:`_average_row` are its plain version.

Palette images, bit depths below 8 and interlaced files raise
:class:`PngError` instead of being misread. :mod:`.image` reads PNG and JPEG
files alike.

On top of the codec, two of PIL's conversions that the data layer needs:
:func:`to_rgb` (``Image.convert("RGB")``) and :func:`to_luma`
(``Image.convert("L")``, with PIL's integer luma weights), and
:func:`resize_bilinear`, PIL's ``BILINEAR`` resample (a triangle filter
whose support grows with the reduction factor, in PIL's fixed point).
"""

from __future__ import annotations

import math
import struct
import zlib
from pathlib import Path

import numpy as np

from qed_splatter_tpu_torch.data.image import ImageError

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# colour type -> channels (3, palette, is refused)
_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}
_COLOR_TYPE = {v: k for k, v in _CHANNELS.items()}


class PngError(ImageError):
    """A file this codec does not read (or not a PNG at all)."""


def _chunks(raw: bytes, path):
    if raw[:8] != _SIGNATURE:
        raise PngError(f"not a PNG file: {path}")
    pos = 8
    while pos + 8 <= len(raw):
        length, kind = struct.unpack(">I4s", raw[pos:pos + 8])
        data = raw[pos + 8:pos + 8 + length]
        pos += 12 + length
        yield kind, data
        if kind == b"IEND":
            return
    raise PngError(f"truncated PNG (no IEND chunk): {path}")


def _paeth_row(row: bytearray, prior: bytes, bpp: int) -> None:
    """Undo the Paeth filter of one row in place (sequential in x)."""
    for i in range(len(row)):
        a = row[i - bpp] if i >= bpp else 0
        b = prior[i]
        c = prior[i - bpp] if i >= bpp else 0
        p = a + b - c
        pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
        if pa <= pb and pa <= pc:
            pred = a
        elif pb <= pc:
            pred = b
        else:
            pred = c
        row[i] = (row[i] + pred) & 0xFF


def _average_row(row: bytearray, prior: bytes, bpp: int) -> None:
    """Undo the Average filter of one row in place (sequential in x)."""
    for i in range(len(row)):
        a = row[i - bpp] if i >= bpp else 0
        row[i] = (row[i] + ((a + prior[i]) >> 1)) & 0xFF


def _unfilter(data: np.ndarray, height: int, stride: int,
              bpp: int, path) -> np.ndarray:
    """[height, stride] uint8 of raw samples from the filtered scanlines
    (the host core's ``qed_png_unfilter``)."""
    from qed_splatter_tpu_torch import native

    if data.size != height * (stride + 1):
        raise PngError(f"PNG data has {data.size} bytes, expected "
                       f"{height * (stride + 1)}: {path}")
    out, bad = native.png_unfilter(data, height, stride, bpp)
    if bad >= 0:
        kind = int(data[bad * (stride + 1)])
        raise PngError(f"unknown PNG filter type {kind} in row {bad}: "
                       f"{path}")
    return out


def unfilter_plain(data: np.ndarray, height: int, stride: int,
                   bpp: int) -> np.ndarray:
    """The plain version of :func:`_unfilter`: numpy for None, Sub and Up,
    the row loops for Average and Paeth."""
    rows = data.reshape(height, stride + 1)
    out = np.empty((height, stride), np.uint8)
    prior = np.zeros(stride, np.uint8)
    for y in range(height):
        cur = rows[y, 1:]
        kind = int(rows[y, 0])
        if kind == 0:
            rec = cur.copy()
        elif kind == 1:      # Sub: a running sum along each byte lane
            lanes = cur.reshape(-1, bpp)
            rec = np.cumsum(lanes, axis=0, dtype=np.uint8).reshape(-1)
        elif kind == 2:      # Up
            rec = cur + prior
        elif kind in (3, 4):
            buf = bytearray(cur.tobytes())
            (_average_row if kind == 3 else _paeth_row)(
                buf, prior.tobytes(), bpp)
            rec = np.frombuffer(bytes(buf), np.uint8)
        else:
            raise PngError(f"unknown PNG filter type {kind} in row {y}")
        out[y] = rec
        prior = out[y]
    return out


def decode_png(data: bytes, path="<bytes>") -> np.ndarray:
    """Samples of a PNG as numpy: [H, W] for gray, [H, W, C] otherwise
    (C = 2 gray + alpha, 3 RGB, 4 RGBA); uint8 at bit depth 8, uint16 at
    16 (as PIL's ``np.asarray(Image.open(...))`` lays them out)."""
    header = None
    idat = []
    for kind, chunk in _chunks(data, path):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", chunk[:13])
        elif kind == b"IDAT":
            idat.append(chunk)
        elif kind == b"PLTE":
            raise PngError(f"palette PNGs are not supported: {path}")
    if header is None:
        raise PngError(f"PNG has no IHDR chunk: {path}")
    width, height, depth, ctype, comp, filt, interlace = header
    if ctype not in _CHANNELS:
        raise PngError(f"PNG colour type {ctype} (palette) is not supported: "
                       f"{path}")
    if depth not in (8, 16):
        raise PngError(f"PNG bit depth {depth} is not supported (8 or 16 "
                       f"only): {path}")
    if interlace != 0:
        raise PngError(f"interlaced PNGs are not supported: {path}")
    if comp != 0 or filt != 0:
        raise PngError(f"unknown PNG compression or filter method: {path}")
    ch = _CHANNELS[ctype]
    bpp = ch * depth // 8
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    samples = _unfilter(raw, height, width * bpp, bpp, path)
    if depth == 16:
        samples = samples.reshape(-1).view(">u2").astype(np.uint16)
    shape = (height, width) if ch == 1 else (height, width, ch)
    return samples.reshape(shape)


def read_png(path) -> np.ndarray:
    """:func:`decode_png` of a file."""
    return decode_png(Path(path).read_bytes(), path)


def _filter_rows(samples: np.ndarray, bpp: int,
                 filter_type) -> np.ndarray:
    """[H, 1 + stride] filtered scanlines. ``filter_type`` 0-4 applies one
    filter to every row; None picks per row the one with the least sum of
    |signed bytes| (libpng's heuristic) among None, Sub and Up, the filters
    that :func:`decode_png` undoes without a loop over the row."""
    x = samples.astype(np.int16)
    a = np.zeros_like(x)
    a[:, bpp:] = x[:, :-bpp]
    b = np.zeros_like(x)
    b[1:] = x[:-1]
    c = np.zeros_like(x)
    c[1:, bpp:] = x[:-1, :-bpp]
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
    preds = (np.zeros_like(x), a, b, (a + b) >> 1, paeth)
    cands = np.stack([(x - pr) & 0xFF for pr in preds]).astype(np.uint8)
    if filter_type is None:
        cost = np.abs(cands[:3].view(np.int8).astype(np.int32)).sum(-1)
        kinds = np.argmin(cost, axis=0)
    else:
        kinds = np.full(x.shape[0], int(filter_type))
    rows = cands[kinds, np.arange(x.shape[0])]
    return np.concatenate([kinds.astype(np.uint8)[:, None], rows], axis=1)


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def encode_png(img: np.ndarray, filter_type=None, level: int = 6) -> bytes:
    """PNG bytes of ``img``: [H, W] or [H, W, C] (C in 1-4), uint8 or
    uint16. ``filter_type`` as in :func:`_filter_rows`."""
    img = np.asarray(img)
    if img.dtype not in (np.uint8, np.uint16):
        raise PngError(f"PNG samples must be uint8 or uint16, not {img.dtype}")
    if img.ndim == 2:
        img = img[..., None]
    h, w, ch = img.shape
    if ch not in _COLOR_TYPE:
        raise PngError(f"cannot write {ch} channels to a PNG")
    depth = 8 * img.dtype.itemsize
    samples = img.astype(">u2" if depth == 16 else np.uint8).reshape(h, -1)
    samples = samples.view(np.uint8).reshape(h, -1)
    bpp = ch * depth // 8
    rows = _filter_rows(samples, bpp, filter_type)
    ihdr = struct.pack(">IIBBBBB", w, h, depth, _COLOR_TYPE[ch], 0, 0, 0)
    return (_SIGNATURE + _chunk(b"IHDR", ihdr)
            + _chunk(b"IDAT", zlib.compress(rows.tobytes(), level))
            + _chunk(b"IEND", b""))


def write_png(path, img: np.ndarray, filter_type=None) -> None:
    Path(path).write_bytes(encode_png(img, filter_type))


# ------------------------------------------------------ PIL's conversions

def to_rgb(img: np.ndarray) -> np.ndarray:
    """``Image.convert("RGB")`` of 8-bit samples: gray is repeated, alpha
    dropped (not composited)."""
    if img.dtype != np.uint8:
        raise PngError("only 8-bit images convert to RGB")
    if img.ndim == 2:
        return np.repeat(img[..., None], 3, axis=-1)
    if img.shape[-1] == 2:
        return np.repeat(img[..., :1], 3, axis=-1)
    return np.ascontiguousarray(img[..., :3])


def to_luma(img: np.ndarray) -> np.ndarray:
    """``Image.convert("L")``: RGB(A) through PIL's integer luma,
    (299 R + 587 G + 114 B) / 1000 as (19595 R + 38470 G + 7471 B +
    0x8000) >> 16; gray + alpha keeps the gray; 16-bit gray clips at 255."""
    if img.ndim == 2:
        return np.minimum(img, 255).astype(np.uint8)
    if img.shape[-1] == 2:
        return img[..., 0].astype(np.uint8)
    rgb = img[..., :3].astype(np.uint32)
    luma = (rgb[..., 0] * 19595 + rgb[..., 1] * 38470 + rgb[..., 2] * 7471
            + 0x8000) >> 16
    return luma.astype(np.uint8)


_PRECISION_BITS = 32 - 8 - 2


def _bilinear_taps(in_size: int, out_size: int):
    """PIL's ``precompute_coeffs`` for the bilinear filter, then its 8-bit
    fixed point: (first input index, [out, ksize] int64 weights)."""
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = 1.0 * filterscale
    ksize = int(math.ceil(support)) * 2 + 1
    ss = 1.0 / filterscale
    first = np.zeros(out_size, np.int64)
    weights = np.zeros((out_size, ksize), np.int64)
    for xx in range(out_size):
        center = (xx + 0.5) * scale
        xmin = max(int(center - support + 0.5), 0)
        xmax = min(int(center + support + 0.5), in_size) - xmin
        ws = [max(0.0, 1.0 - abs((x + xmin - center + 0.5) * ss))
              for x in range(xmax)]
        total = sum(ws)
        first[xx] = xmin
        for x, w in enumerate(ws):
            if total != 0.0:
                w = w / total
            weights[xx, x] = int(0.5 + w * (1 << _PRECISION_BITS))
    return first, weights


def _resample_axis0(img: np.ndarray, out_size: int) -> np.ndarray:
    first, weights = _bilinear_taps(img.shape[0], out_size)
    acc = np.full((out_size,) + img.shape[1:], 1 << (_PRECISION_BITS - 1),
                  np.int64)
    src = img.astype(np.int64)
    last = img.shape[0] - 1
    for j in range(weights.shape[1]):
        w = weights[:, j].reshape((-1,) + (1,) * (img.ndim - 1))
        acc += src[np.minimum(first + j, last)] * w
    return np.clip(acc >> _PRECISION_BITS, 0, 255).astype(np.uint8)


def resize_bilinear(img: np.ndarray, width: int, height: int) -> np.ndarray:
    """``Image.resize((width, height), Image.BILINEAR)`` of an 8-bit [H, W]
    or [H, W, C] image: the horizontal pass, rounded to 8 bits, then the
    vertical one, as PIL resamples."""
    if img.dtype != np.uint8:
        raise PngError("resize_bilinear takes 8-bit images")
    out = img
    if width != img.shape[1]:
        out = np.swapaxes(_resample_axis0(np.swapaxes(out, 0, 1), width),
                          0, 1)
    if height != img.shape[0]:
        out = _resample_axis0(out, height)
    return np.ascontiguousarray(out)
