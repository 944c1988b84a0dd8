"""The port's image decoding in its host core against PIL (the reference
opens every image through PIL) and against the plain versions: the PNG row
filters undone by ``qed_png_unfilter`` byte-equal to the Python row loops
and to PIL for every filter type, 8 and 16 bits and 1-4 channels; baseline
JPEG byte-equal to PIL (gray, 4:4:4, 4:2:2, 4:2:0, restart intervals,
16-bit quantization tables, odd sizes); the refusals, each naming the file;
and a JPEG dataset loaded by the port equal to the JAX package's."""

import io
import json

import numpy as np
import pytest
from PIL import Image

from qed_splatter_tpu import testing as jtesting
from qed_splatter_tpu.configs import DataConfig as JData
from qed_splatter_tpu.data.dataset import FullImageDatamanager as JDM
from qed_splatter_tpu.data.dataset import load_image_uint8 as jload
from qed_splatter_tpu_torch import native
from qed_splatter_tpu_torch.configs import DataConfig
from qed_splatter_tpu_torch.data import png
from qed_splatter_tpu_torch.data.dataset import FullImageDatamanager
from qed_splatter_tpu_torch.data.dataset import load_image_uint8
from qed_splatter_tpu_torch.data.image import ImageError, JpegError, \
    decode_image, read_image


def _textured(h, w, ch, seed=0, dtype=np.uint8, noise=0.1):
    """Waves plus noise: every PNG filter wins rows, JPEG blocks carry AC
    energy."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    top = np.iinfo(dtype).max
    img = np.stack([np.sin(xx / 7.0 + c) * np.cos(yy / 5.0 - c)
                    for c in range(ch)], -1) * 0.35 + 0.5
    img = img * top + rng.normal(0, noise * top, img.shape)
    img = np.clip(img, 0, top).astype(dtype)
    return img[..., 0] if ch == 1 else img


@pytest.mark.parametrize("filter_type", [0, 1, 2, 3, 4])
@pytest.mark.parametrize("dtype", [np.uint8, np.uint16], ids=["8", "16"])
def test_unfilter_core_equals_plain_and_pil(filter_type, dtype):
    """Every row in one filter type, 1-4 channels: the core's unfilter
    byte-equal to the plain version and to the samples, and PIL reads the
    file to the same samples (exact; PIL reads 16-bit files with more than
    one channel down to 8 bits, so those are held to the samples alone)."""
    for ch in (1, 2, 3, 4):
        img = _textured(23, 37, ch, seed=ch, dtype=dtype)
        arr = img if img.ndim == 3 else img[..., None]
        h = arr.shape[0]
        samples = arr.astype(">u2" if dtype == np.uint16 else np.uint8)
        samples = samples.reshape(h, -1).view(np.uint8).reshape(h, -1)
        bpp = ch * np.dtype(dtype).itemsize
        rows = png._filter_rows(samples, bpp, filter_type)
        assert (rows[:, 0] == filter_type).all()
        flat = rows.reshape(-1)
        core, bad = native.png_unfilter(flat, h, samples.shape[1], bpp)
        assert bad == -1
        np.testing.assert_array_equal(core, samples)
        np.testing.assert_array_equal(
            png.unfilter_plain(flat, h, samples.shape[1], bpp), samples)
        data = png.encode_png(img, filter_type=filter_type)
        np.testing.assert_array_equal(png.decode_png(data), img)
        if dtype == np.uint8 or ch == 1:
            np.testing.assert_array_equal(
                np.asarray(Image.open(io.BytesIO(data))), img)


def test_unfilter_pil_adaptive_png(tmp_path):
    """A frame PIL writes with its own per-row choice (mostly Paeth on a
    smooth texture, Sub and Up beside it) reads to PIL's samples."""
    img = _textured(120, 160, 3, noise=0.03)
    Image.fromarray(img).save(tmp_path / "a.png")
    raw = (tmp_path / "a.png").read_bytes()
    assert png.read_png(tmp_path / "a.png").tobytes() == \
        np.asarray(Image.open(tmp_path / "a.png")).tobytes()
    # the file does hold Average or Paeth rows
    import zlib
    idat = b"".join(d for k, d in png._chunks(raw, "a") if k == b"IDAT")
    kinds = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(
        120, -1)[:, 0]
    assert ({3, 4} & set(kinds.tolist())) and len(set(kinds.tolist())) > 1
    np.testing.assert_array_equal(read_image(tmp_path / "a.png"), img)


def test_unknown_filter_byte_names_the_row_and_file(tmp_path):
    img = _textured(9, 11, 3)
    rows = png._filter_rows(img.reshape(9, -1), 3, 1)
    rows[5, 0] = 9
    import struct
    import zlib
    ihdr = struct.pack(">IIBBBBB", 11, 9, 8, 2, 0, 0, 0)
    data = (png._SIGNATURE + png._chunk(b"IHDR", ihdr)
            + png._chunk(b"IDAT", zlib.compress(rows.tobytes()))
            + png._chunk(b"IEND", b""))
    (tmp_path / "bad.png").write_bytes(data)
    with pytest.raises(png.PngError, match=r"type 9 in row 5: .*bad.png"):
        read_image(tmp_path / "bad.png")
    assert issubclass(png.PngError, ImageError)


def _jpeg(img, **kw):
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, "JPEG", **kw)
    return buf.getvalue()


def _pil(data):
    return np.asarray(Image.open(io.BytesIO(data)))


@pytest.mark.parametrize("quality", [50, 95])
@pytest.mark.parametrize("mode", ["gray", "444", "422", "420"])
def test_jpeg_equals_pil(mode, quality):
    """Baseline JPEG at an odd size (97x61, partial MCUs on both edges):
    byte-equal to PIL's decode, with and without a restart interval."""
    sub = {"444": 0, "422": 1, "420": 2}.get(mode)
    img = _textured(61, 97, 1 if mode == "gray" else 3, seed=quality)
    kw = dict(quality=quality)
    if sub is not None:
        kw["subsampling"] = sub
    for extra in ({}, {"restart_marker_blocks": 3}):
        data = _jpeg(img, **kw, **extra)
        if extra:
            assert b"\xff\xdd" in data          # a DRI segment
        got = decode_image(data)
        want = _pil(data)
        assert got.shape == want.shape and got.dtype == np.uint8
        np.testing.assert_array_equal(got, want)


def test_jpeg_edge_sizes_and_16bit_tables():
    """1x1 to 17x2 images (chroma 1-2 samples wide: libjpeg's box
    upsampling) and a file whose quantization tables are rewritten as
    16-bit entries (same values): equal to PIL."""
    for h, w in ((1, 1), (2, 3), (7, 3), (17, 2), (9, 33)):
        for sub in (0, 1, 2):
            data = _jpeg(_textured(h, w, 3, seed=h * w), quality=80,
                         subsampling=sub)
            np.testing.assert_array_equal(decode_image(data), _pil(data))
    data = bytearray(_jpeg(_textured(40, 56, 3), quality=70, subsampling=2))
    out, pos = bytearray(data[:2]), 2
    while pos < len(data):
        assert data[pos] == 0xFF
        marker = data[pos + 1]
        n = (data[pos + 2] << 8) | data[pos + 3]
        seg = data[pos + 4:pos + 2 + n]
        if marker == 0xDB:
            wide, i = bytearray(), 0
            while i < len(seg):
                tq = seg[i] & 15
                wide.append(0x10 | tq)
                for v in seg[i + 1:i + 65]:
                    wide += bytes((0, v))
                i += 65
            out += bytes((0xFF, 0xDB)) + (len(wide) + 2).to_bytes(2, "big")
            out += wide
        else:
            out += data[pos:pos + 2 + n]
        pos += 2 + n
        if marker == 0xDA:
            out += data[pos:]
            break
    assert bytes(out) != bytes(data)
    np.testing.assert_array_equal(decode_image(bytes(out)),
                                  _pil(bytes(data)))


def _patch_sof(data: bytes, offset: int, value: int) -> bytes:
    i = data.index(b"\xff\xc0")
    b = bytearray(data)
    b[i + offset] = value
    return bytes(b)


def _cmyk_jpeg(img):
    buf = io.BytesIO()
    Image.fromarray(img).convert("CMYK").save(buf, "JPEG")
    return buf.getvalue()


def test_jpeg_refusals_name_the_file(tmp_path):
    """Progressive, CMYK, arithmetic coding, 12-bit samples and sampling
    factors above 2 are refused with the feature and the file named."""
    img = _textured(24, 32, 3)
    base = _jpeg(img, quality=80, subsampling=0)
    cases = {
        "progressive": (_jpeg(img, progressive=True), "progressive"),
        "cmyk": (_cmyk_jpeg(img), "CMYK"),
        "arith": (base.replace(b"\xff\xc0", b"\xff\xc9", 1), "arithmetic"),
        "twelve": (_patch_sof(base, 4, 12), "12-bit"),
        "sampling": (_patch_sof(base, 11, 0x31), "sampling factors"),
    }
    for name, (data, what) in cases.items():
        p = tmp_path / f"{name}.jpg"
        p.write_bytes(data)
        with pytest.raises(JpegError, match=f"{what}.*{name}.jpg"):
            read_image(p)
    (tmp_path / "x.gif").write_bytes(b"GIF89a" + bytes(20))
    with pytest.raises(ImageError, match="not a PNG or JPEG file.*x.gif"):
        read_image(tmp_path / "x.gif")


@pytest.mark.parametrize("count", [2, 3, 255])
def test_jpeg_overfull_huffman_table_is_refused(tmp_path, count):
    """A DHT that declares more codes of one length than the length holds
    (two 1-bit codes use the all-ones code, which T.81 reserves), put in
    force for the scan, is refused as libjpeg refuses it
    (JERR_BAD_HUFF_TABLE), before any code table is written: a JpegError
    naming the file, and PIL fails too."""
    base = _jpeg(_textured(24, 32, 3), quality=80, subsampling=0)
    counts = bytes([count] + [0] * 15)
    body = b"\x00" + counts + bytes(i % 12 for i in range(count))  # DC 0
    dht = b"\xff\xc4" + (len(body) + 2).to_bytes(2, "big") + body
    pos = 2                     # walk the markers to the scan header
    while base[pos + 1] != 0xDA:
        pos += 2 + int.from_bytes(base[pos + 2:pos + 4], "big")
    data = base[:pos] + dht + base[pos:]
    p = tmp_path / f"dht{count}.jpg"
    p.write_bytes(data)
    with pytest.raises(JpegError, match=f"bad Huffman table.*dht{count}.jpg"):
        read_image(p)
    with pytest.raises(ImageError):
        decode_image(data)
    with pytest.raises(OSError):
        Image.open(io.BytesIO(data)).load()


def test_jpeg_dataset_equals_jax(tmp_path):
    """A dataset whose frames are JPEGs (4:2:0, quality 90, as cameras
    write them): the port's ``load_image_uint8`` (with and without the
    bilinear downscale) and datamanager equal the JAX package's, which
    opens them with PIL."""
    root = tmp_path / "scene"
    jtesting.write_synthetic_dataset(root, num_frames=4, width=64,
                                     height=48)
    meta = json.loads((root / "transforms.json").read_text())
    for fr in meta["frames"]:
        src = root / fr["file_path"]
        img = np.asarray(Image.open(src).convert("RGB")).copy()
        img[::3, ::5] = 255 - img[::3, ::5]     # AC energy in every block
        dst = src.with_suffix(".jpg")
        Image.fromarray(img).save(dst, "JPEG", quality=90)
        src.unlink()
        fr["file_path"] = str(dst.relative_to(root))
    (root / "transforms.json").write_text(json.dumps(meta))
    for fr in meta["frames"]:
        p = root / fr["file_path"]
        for d in (1, 2):
            np.testing.assert_array_equal(load_image_uint8(p, d),
                                          jload(p, d))
    dm = FullImageDatamanager(DataConfig(data=str(root)))
    jdm = JDM(JData(data=str(root)))
    assert dm.num_train == jdm.num_train > 0
    for i in range(len(meta["frames"])):
        a, b = dm.get_item(i), jdm.get_item(i)
        np.testing.assert_array_equal(a["image"], b["image"])
        np.testing.assert_array_equal(a["depth_image"], b["depth_image"])


def test_committed_jpeg_fixture_equals_pil():
    """The frame ``chip_smoke.py`` times the JPEG decode on (written by
    ``tools/torch_jpeg_fixture.py``) decodes to PIL's pixels."""
    from pathlib import Path

    path = Path(__file__).parent / "data" / "room_1296x840_q90.jpg"
    got = read_image(path)
    assert got.shape == (840, 1296, 3)
    np.testing.assert_array_equal(got, np.asarray(Image.open(path)))
