"""The port's data layer against PIL and the JAX package on the CPU: the PNG
codec and PIL's conversions, the PLY IO, the dataparser, undistortion, the
datamanager (pixels, depth, masks, camera order) and the room dataset
writer."""

import io
import json
import zlib

import numpy as np
import pytest
from PIL import Image

from qed_splatter_tpu import testing as jtesting
from qed_splatter_tpu.configs import DataConfig as JData
from qed_splatter_tpu.data import ply as jply
from qed_splatter_tpu.data.dataset import FullImageDatamanager as JDm
from qed_splatter_tpu.data.transforms_json import parse_transforms as jparse
from qed_splatter_tpu.data.undistort import undistort_image as jundistort
from qed_splatter_tpu_torch import testing as ttesting
from qed_splatter_tpu_torch.configs import DataConfig as TData
from qed_splatter_tpu_torch.data import png, ply
from qed_splatter_tpu_torch.data.dataset import FullImageDatamanager as TDm
from qed_splatter_tpu_torch.data.transforms_json import parse_transforms
from qed_splatter_tpu_torch.data.undistort import undistort_image


def _image(shape, dtype, seed=0):
    """A smooth ramp plus noise: every filter type wins some rows."""
    rng = np.random.default_rng(seed)
    h, w = shape[:2]
    yy, xx = np.meshgrid(np.linspace(0, 1, h), np.linspace(0, 1, w),
                         indexing="ij")
    base = 0.7 * xx + 0.3 * yy
    if len(shape) == 3:
        base = np.repeat(base[..., None], shape[2], -1)
    top = np.iinfo(dtype).max
    return (base * (top - 40) + rng.integers(0, 40, shape)).astype(dtype)


MODES = [((29, 41), np.uint8), ((29, 41, 2), np.uint8),
         ((29, 41, 3), np.uint8), ((29, 41, 4), np.uint8),
         ((29, 41), np.uint16)]


@pytest.mark.parametrize("filter_type", [0, 1, 2, 3, 4, None])
@pytest.mark.parametrize("shape,dtype", MODES,
                         ids=["L8", "LA8", "RGB8", "RGBA8", "L16"])
def test_png_encode_decode_against_pil(shape, dtype, filter_type):
    """Each filter type (and the adaptive choice) on 8-bit gray, gray +
    alpha, RGB, RGBA and 16-bit gray: PIL reads what the port writes, and
    the port reads it back, exactly."""
    img = _image(shape, dtype)
    data = png.encode_png(img, filter_type)
    kinds = set(np.frombuffer(zlib.decompress(data[data.index(b"IDAT") + 4:
                                                   -16]), np.uint8)
                [:: img.nbytes // shape[0] + 1].tolist())
    if filter_type is not None:
        assert kinds == {filter_type}
    pil = np.asarray(Image.open(io.BytesIO(data)))
    np.testing.assert_array_equal(pil.astype(np.int64), img.astype(np.int64))
    back = png.decode_png(data)
    assert back.dtype == img.dtype
    np.testing.assert_array_equal(back, img)


@pytest.mark.parametrize("shape,dtype", MODES,
                         ids=["L8", "LA8", "RGB8", "RGBA8", "L16"])
def test_png_decodes_pil_files(shape, dtype, tmp_path):
    """Files PIL writes (its adaptive filters, Average and Paeth among
    them) decode to PIL's own samples."""
    img = _image(shape, dtype, seed=1)
    Image.fromarray(img).save(tmp_path / "x.png")
    want = np.asarray(Image.open(tmp_path / "x.png"))
    got = png.read_png(tmp_path / "x.png")
    np.testing.assert_array_equal(got.astype(np.int64), want.astype(np.int64))


def test_png_refuses_what_it_cannot_read(tmp_path):
    img = _image((16, 16, 3), np.uint8)
    Image.fromarray(img).convert("P").save(tmp_path / "pal.png")
    with pytest.raises(png.PngError, match="palette"):
        png.read_png(tmp_path / "pal.png")
    Image.fromarray(img).save(tmp_path / "inter.png", interlace=1)
    raw = (tmp_path / "inter.png").read_bytes()
    if raw[28] == 1:   # PIL wrote an interlaced file
        with pytest.raises(png.PngError, match="interlaced"):
            png.decode_png(raw)
    # a hand-made interlaced header is refused either way
    data = bytearray(png.encode_png(img))
    data[28] = 1
    with pytest.raises(png.PngError, match="interlaced"):
        png.decode_png(bytes(data))
    with pytest.raises(png.PngError, match="not a PNG"):
        png.decode_png(b"GIF89a" + bytes(20))


@pytest.mark.parametrize("d", [2, 3, 4])
def test_resize_bilinear_matches_pil(d):
    """PIL's BILINEAR resize when shrinking (a triangle filter whose
    support grows with the factor), within one level of 255 (it is
    exact here)."""
    img = np.random.default_rng(d).integers(0, 256, (61, 83, 3)).astype(
        np.uint8)
    want = np.asarray(Image.fromarray(img).resize((83 // d, 61 // d),
                                                  Image.BILINEAR))
    got = png.resize_bilinear(img, 83 // d, 61 // d)
    assert got.shape == want.shape
    assert np.abs(got.astype(int) - want).max() <= 1


@pytest.mark.parametrize("channels", [1, 2, 3, 4])
def test_luma_and_rgb_conversions_match_pil(channels):
    img = _image((23, 31, channels) if channels > 1 else (23, 31), np.uint8)
    pil = Image.fromarray(img)
    np.testing.assert_array_equal(png.to_luma(img),
                                  np.asarray(pil.convert("L")))
    np.testing.assert_array_equal(png.to_rgb(img),
                                  np.asarray(pil.convert("RGB")))


@pytest.mark.parametrize("colors", ["uint8", "float", None])
def test_ply_roundtrip_and_jax_parity(colors, tmp_path):
    rng = np.random.default_rng(0)
    pts = rng.normal(size=(57, 3)).astype(np.float32)
    normals = rng.normal(size=(57, 3)).astype(np.float32)
    cols = {"uint8": rng.integers(0, 256, (57, 3)).astype(np.uint8),
            "float": rng.uniform(0, 1, (57, 3)), None: None}[colors]
    ply.write_ply(tmp_path / "t.ply", pts, cols, normals)
    jply.write_ply(tmp_path / "j.ply", pts, cols, normals)
    assert (tmp_path / "t.ply").read_bytes() == (tmp_path / "j.ply"
                                                  ).read_bytes()
    got, want = ply.read_ply(tmp_path / "t.ply"), jply.read_ply(
        tmp_path / "t.ply")
    np.testing.assert_array_equal(got.positions, pts)
    np.testing.assert_array_equal(got.normals, normals)
    np.testing.assert_array_equal(got.colors_uint8(), want.colors_uint8())


def test_ply_ascii_read(tmp_path):
    text = ("ply\nformat ascii 1.0\nelement vertex 2\nproperty float x\n"
            "property float y\nproperty float z\nproperty uchar red\n"
            "property uchar green\nproperty uchar blue\nend_header\n"
            "0 1 2 10 20 30\n3 4 5 40 50 60\n")
    (tmp_path / "a.ply").write_text(text)
    got, want = ply.read_ply(tmp_path / "a.ply"), jply.read_ply(
        tmp_path / "a.ply")
    np.testing.assert_array_equal(got.positions, want.positions)
    np.testing.assert_array_equal(got.colors, want.colors)


@pytest.mark.parametrize("model", ["OPENCV", "OPENCV_FISHEYE"])
@pytest.mark.parametrize("nearest", [False, True])
def test_undistort_matches_jax(model, nearest):
    img = _image((40, 56, 3), np.uint8)
    K = np.array([[50.0, 0, 28.3], [0, 49.0, 19.7], [0, 0, 1]], np.float32)
    dist = np.array([0.08, -0.03, 0.005, 0.001, 0.002, -0.001], np.float32)
    for x in (img, img[..., 0].astype(np.float32) / 7.0):
        got = undistort_image(x, K, dist, nearest=nearest,
                              camera_model=model)
        want = jundistort(x, K, dist, nearest=nearest, camera_model=model)
        assert got.dtype == want.dtype
        np.testing.assert_allclose(got.astype(np.float64),
                                   want.astype(np.float64), atol=1e-5)


@pytest.fixture(scope="module")
def datasets(tmp_path_factory):
    root = tmp_path_factory.mktemp("data")
    jtesting.write_room_dataset(root / "room", num_frames=9, width=48,
                                height=32, sparse_ply=300, eval_every=4)
    jtesting.write_synthetic_dataset(root / "syn", num_frames=7, width=40,
                                     height=30, depth_format="png",
                                     with_ply=True)
    jtesting.write_synthetic_dataset(root / "npy", num_frames=5, width=40,
                                     height=30, depth_format="npy")
    return root


PARSE_CASES = [
    ("room", {}),
    ("syn", {}),
    ("npy", {}),
    ("syn", dict(orientation_method="pca", center_method="focus")),
    ("room", dict(orientation_method="vertical", auto_scale_poses=False,
                  scale_factor=0.5)),
    ("syn", dict(orientation_method="none", center_method="none",
                 eval_mode="interval", eval_interval=3)),
    ("npy", dict(eval_mode="all", max_images=4)),
    ("syn", dict(train_split_fraction=0.5, load_3D_points=False)),
]


@pytest.mark.parametrize("name,kw", PARSE_CASES)
def test_parse_transforms_matches_jax(datasets, name, kw):
    got = parse_transforms(TData(data=str(datasets / name), **kw))
    want = jparse(JData(data=str(datasets / name), **kw))
    assert len(got.frames) == len(want.frames)
    for a, b in zip(got.frames, want.frames):
        np.testing.assert_allclose(a.camera.c2w, b.camera.c2w, atol=1e-6)
        np.testing.assert_allclose(a.camera.intrinsics_matrix(),
                                   b.camera.intrinsics_matrix(), atol=1e-6)
        assert (a.camera.width, a.camera.height, a.camera.cam_idx) == (
            b.camera.width, b.camera.height, b.camera.cam_idx)
        assert (a.image_path, a.depth_path, a.mask_path) == (
            b.image_path, b.depth_path, b.mask_path)
    np.testing.assert_array_equal(got.train_indices, want.train_indices)
    np.testing.assert_array_equal(got.eval_indices, want.eval_indices)
    np.testing.assert_array_equal(got.transform_matrix, want.transform_matrix)
    assert got.scale_factor == want.scale_factor
    assert got.depth_unit_scale_factor == want.depth_unit_scale_factor
    if want.points is None:
        assert got.points is None
    else:
        np.testing.assert_array_equal(got.points, want.points)
        np.testing.assert_array_equal(got.points_rgb, want.points_rgb)


def _with_masks_and_distortion(root):
    """Masks (RGB PNGs written by PIL) and distortion added to a dataset."""
    meta = json.loads((root / "transforms.json").read_text())
    rng = np.random.default_rng(5)
    (root / "masks").mkdir(exist_ok=True)
    for i, fr in enumerate(meta["frames"]):
        m = rng.integers(0, 256, (meta["h"], meta["w"], 3)).astype(np.uint8)
        Image.fromarray(m).save(root / "masks" / f"m{i}.png")
        fr["mask_path"] = f"masks/m{i}.png"
    meta.update(k1=0.05, k2=-0.01, p1=0.001)
    (root / "transforms.json").write_text(json.dumps(meta))


@pytest.mark.parametrize("name,downscale", [("room", None), ("syn", None),
                                            ("syn", 2), ("masked", None)])
def test_datamanager_matches_jax(datasets, name, downscale, tmp_path):
    """Images, depth and masks equal; the first 3 epochs' camera order
    equal. ``downscale`` is the dataset-level PIL BILINEAR resize."""
    root = datasets / (name if name != "masked" else "npy")
    if name == "masked":
        import shutil

        shutil.copytree(root, tmp_path / "masked")
        root = tmp_path / "masked"
        _with_masks_and_distortion(root)
    got = TDm(TData(data=str(root), downscale_factor=downscale), seed=3)
    want = JDm(JData(data=str(root), downscale_factor=downscale), seed=3)
    order_t = [got.next_train(i)["cam_idx"] for i in range(3 * got.num_train)]
    order_j = [want.next_train(i)["cam_idx"]
               for i in range(3 * want.num_train)]
    assert order_t == order_j
    for idx in range(len(want.scene.frames)):
        a, b = got.get_item(idx), want.get_item(idx)
        assert set(a) == set(b)
        if downscale:
            assert np.abs(a["image"].astype(int) - b["image"]).max() <= 1
        else:
            np.testing.assert_array_equal(a["image"], b["image"])
        if "depth_image" in b:
            np.testing.assert_array_equal(a["depth_image"], b["depth_image"])
        if "mask" in b:
            np.testing.assert_array_equal(a["mask"], b["mask"])
        assert a["camera"].width == b["camera"].width
        np.testing.assert_allclose(a["camera"].intrinsics_matrix(),
                                   b["camera"].intrinsics_matrix(),
                                   atol=1e-6)
        assert (a["camera"].distortion is None) == (
            b["camera"].distortion is None)


def test_room_writer_matches_jax(tmp_path):
    """The port's room dataset at 96x64 equals JAX's in decoded pixels,
    depths, seed points and transforms.json."""
    kw = dict(num_frames=4, width=96, height=64, sparse_ply=200,
              eval_every=3)
    jtesting.write_room_dataset(tmp_path / "j", **kw)
    ttesting.write_room_dataset(tmp_path / "t", workers=2, **kw)
    for sub in ("j", "t"):
        assert (tmp_path / sub / "transforms.json").exists()
    assert json.loads((tmp_path / "t" / "transforms.json").read_text()) == \
        json.loads((tmp_path / "j" / "transforms.json").read_text())
    for i in range(4):
        name = f"frame_{i:04d}"
        np.testing.assert_array_equal(
            png.read_png(tmp_path / "t" / "images" / f"{name}.png"),
            np.asarray(Image.open(tmp_path / "j" / "images" / f"{name}.png")))
        np.testing.assert_array_equal(
            np.load(tmp_path / "t" / "depth" / f"{name}.npy"),
            np.load(tmp_path / "j" / "depth" / f"{name}.npy"))
    assert (tmp_path / "t" / "sparse_pc.ply").read_bytes() == (
        tmp_path / "j" / "sparse_pc.ply").read_bytes()


def test_synthetic_writer_matches_jax(tmp_path):
    kw = dict(num_frames=3, width=40, height=30, depth_format="png",
              with_ply=True)
    jtesting.write_synthetic_dataset(tmp_path / "j", **kw)
    ttesting.write_synthetic_dataset(tmp_path / "t", **kw)
    for sub, ext in (("images", "png"), ("depth", "png")):
        for i in range(3):
            name = f"{sub}/frame_{i:04d}.{ext}"
            np.testing.assert_array_equal(
                png.read_png(tmp_path / "t" / name).astype(np.int64),
                np.asarray(Image.open(tmp_path / "j" / name)).astype(
                    np.int64))
    assert (tmp_path / "t" / "sparse_pc.ply").read_bytes() == (
        tmp_path / "j" / "sparse_pc.ply").read_bytes()
