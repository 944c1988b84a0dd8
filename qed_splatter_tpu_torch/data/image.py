"""One reader for the images of a dataset (the port's ``Image.open``).

:func:`read_image` sniffs a file's magic bytes and decodes PNG through
:mod:`.png` and baseline JPEG through the host core (``native.py``,
``csrc/qedcore.cpp``), returning what PIL's ``np.asarray(Image.open(path))``
returns: [H, W] for gray, [H, W, C] otherwise; uint8, or uint16 for 16-bit
PNG. Like PIL, it applies no EXIF orientation.

What neither decoder reads raises :class:`ImageError` naming the file:
palette, interlaced and sub-8-bit PNGs (:class:`~.png.PngError`),
progressive, arithmetic-coded, 12-bit, lossless and CMYK/YCCK JPEGs and
sampling factors above 2 (:class:`JpegError`), and any other format.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

_PNG = b"\x89PNG\r\n\x1a\n"
_JPEG = b"\xff\xd8\xff"


class ImageError(ValueError):
    """An image file the port does not decode."""


class JpegError(ImageError):
    """A JPEG file the port does not decode."""


def decode_jpeg(data: bytes, path="<bytes>") -> np.ndarray:
    """A baseline JPEG's pixels as PIL decodes them (libjpeg's defaults:
    the islow IDCT, fancy upsampling, fixed-point YCbCr -> RGB)."""
    from qed_splatter_tpu_torch import native

    try:
        return native.jpeg_decode(data)
    except native.JpegDecodeError as e:
        raise JpegError(f"{e}: {path}") from None


def decode_image(data: bytes, path="<bytes>") -> np.ndarray:
    """A PNG or JPEG's samples, by its magic bytes."""
    from qed_splatter_tpu_torch.data import png

    if data[:8] == _PNG:
        return png.decode_png(data, path)
    if data[:3] == _JPEG:
        return decode_jpeg(data, path)
    raise ImageError(f"not a PNG or JPEG file: {path}")


def read_image(path) -> np.ndarray:
    """:func:`decode_image` of a file."""
    return decode_image(Path(path).read_bytes(), path)
