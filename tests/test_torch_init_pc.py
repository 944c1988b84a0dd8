"""The port's init-pointcloud path against the JAX package on the CPU: the
host core (the port's own build of ``csrc/qedcore.cpp``) against the JAX
package's binding of the checked-in library, the plain voxel downsample,
backprojection and colorize, and a whole ``init-pc`` run with its resume."""

import json
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial import cKDTree

from qed_splatter_tpu import native as jnative
from qed_splatter_tpu import testing as jtesting
from qed_splatter_tpu.data import init_pc as jinit_pc
from qed_splatter_tpu.ops import backproject as jbp
from qed_splatter_tpu.ops.voxel import voxel_downsample as jvoxel
from qed_splatter_tpu_torch import native
from qed_splatter_tpu_torch.data import init_pc
from qed_splatter_tpu_torch.data.ply import read_ply
from qed_splatter_tpu_torch.ops import backproject as bp
from qed_splatter_tpu_torch.ops.knn import nn_distances
from qed_splatter_tpu_torch.ops.voxel import cell_means, voxel_downsample

# the two builds of one source differ in -march only
CORE_TOL = 1e-6


def _sorted(p, *more):
    order = np.lexsort(p.T)
    return (p[order], *(m[order] for m in more))


def _match(got, want, atol):
    """Indices into ``want`` of each point of ``got``, asserting the two
    clouds are one set within ``atol`` (a one-to-one nearest match; sorting
    would part near-equal keys)."""
    assert got.shape == want.shape
    d, idx = cKDTree(want).query(got)
    assert d.max() <= atol, d.max()
    assert len(np.unique(idx)) == len(idx)
    return idx


def test_core_voxel_matches_the_jax_binding():
    rng = np.random.default_rng(0)
    pts = rng.normal(size=(5000, 3)).astype(np.float32)
    cols = rng.uniform(0, 1, (5000, 3)).astype(np.float32)
    got_p, got_c = _sorted(*native.voxel_downsample_native(pts, 0.2, cols))
    want_p, want_c = _sorted(*jnative.voxel_downsample_native(pts, 0.2,
                                                              cols))
    assert got_p.shape == want_p.shape
    np.testing.assert_allclose(got_p, want_p, atol=CORE_TOL)
    np.testing.assert_allclose(got_c, want_c, atol=CORE_TOL)
    # against JAX's numpy version, as JAX's own test holds its core
    np_p, np_c = _sorted(*jvoxel(pts, 0.2, cols))
    np.testing.assert_allclose(got_p, np_p, atol=1e-5)
    np.testing.assert_allclose(got_c, np_c, atol=1e-5)


def _clouds(case):
    rng = np.random.default_rng({"random": 1, "clustered": 2,
                                 "disjoint": 4}[case])
    if case == "random":
        q = rng.normal(size=(2000, 3))
        r = rng.normal(size=(3000, 3))
    elif case == "clustered":
        r = np.concatenate([rng.normal(scale=0.01, size=(1000, 3)),
                            rng.normal(loc=5.0, scale=2.0, size=(50, 3))])
        q = rng.uniform(-3, 8, (500, 3))
    else:
        r = rng.normal(size=(2000, 3))
        q = rng.normal(size=(500, 3)) + 500.0
    return q.astype(np.float32), r.astype(np.float32)


@pytest.mark.parametrize("case", ["random", "clustered", "disjoint"])
def test_core_nn_distances_match_jax_and_scipy(case):
    q, r = _clouds(case)
    got = native.nn_distances_native(q, r)
    np.testing.assert_allclose(got, jnative.nn_distances_native(q, r),
                               rtol=CORE_TOL, atol=CORE_TOL)
    want, _ = cKDTree(r).query(q)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    # the plain version, from coordinate differences
    plain = nn_distances(torch.as_tensor(q), torch.as_tensor(r)).numpy()
    np.testing.assert_allclose(plain, want, rtol=1e-5, atol=1e-6)


def test_core_backproject_matches_jax():
    rng = np.random.default_rng(3)
    h, w = 33, 47
    depth = rng.uniform(0.5, 5.0, (h, w)).astype(np.float32)
    depth[::5, ::3] = 0.0
    K = np.array([[40.0, 0, w / 2], [0, 42.0, h / 2], [0, 0, 1]], np.float32)
    c2w = np.eye(4, dtype=np.float32)
    c2w[:3, 3] = [0.3, -0.2, 1.0]
    got = native.backproject_native(depth, K, c2w, 4.0, stride=2)
    want = jnative.backproject_native(depth, K, c2w, 4.0, stride=2)
    assert np.array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_allclose(got, want, atol=CORE_TOL, equal_nan=True)


@pytest.mark.parametrize("with_colors", [False, True])
def test_plain_voxel_equals_jax_numpy_exactly(with_colors):
    rng = np.random.default_rng(5)
    pts = rng.normal(size=(4000, 3)).astype(np.float32) * 2.0
    # a grid of points on cell boundaries, where floor(p / v) and
    # floor(p * (1 / v)) can part
    grid = (np.stack(np.meshgrid(*[np.arange(-20, 20)] * 3), -1)
            .reshape(-1, 3) * 0.05).astype(np.float32)
    pts = np.concatenate([pts, grid])
    cols = (rng.uniform(0, 255, pts.shape).astype(np.uint8)
            if with_colors else None)
    got_p, got_c = voxel_downsample(
        torch.as_tensor(pts), 0.05,
        torch.as_tensor(cols) if with_colors else None)
    want_p, want_c = jvoxel(pts, 0.05, cols)
    # both emit cells in sorted key order
    assert np.array_equal(got_p.numpy(), want_p)
    if with_colors:
        assert got_c.dtype == torch.uint8
        assert np.array_equal(got_c.numpy(), want_c)
    else:
        assert got_c is None and want_c is None


def test_core_voxel_against_the_plain_version():
    """The core keys by floor(p * (1 / v)) in float32, the plain version
    (and the JAX package's numpy) by floor(p / v). On a wall at z = 5.2,
    the room's back wall, the two part for every point (5.2 / 0.05 rounds
    to 103.99999, 5.2 * 20 to 104): the core equals ``cell_means`` under
    its own key exactly, the plain grid equals the core's on every cell no
    point with two keys touches, and each plain centroid lies within one
    voxel of a core centroid."""
    rng = np.random.default_rng(6)
    v = 0.05
    pts = rng.uniform(-2.2, 2.2, (20_000, 3)).astype(np.float32)
    pts[:, 2] += 3.0
    pts[:5000, 0] = 2.2
    pts[5000:10_000, 1] = -1.6
    pts[10_000:15_000, 2] = 5.2
    core, _ = native.voxel_downsample_native(pts, v)
    p = torch.as_tensor(pts)
    k_core = torch.floor(p * float(np.float32(1) / np.float32(v)))
    k_plain = torch.floor(p / v)
    differ = (k_core != k_plain).any(1)
    assert int(differ.sum()) == 5000 and bool(differ[10_000:15_000].all())
    same, _ = cell_means(p, k_core)
    _match(same.numpy(), core, 1e-6)
    plain, _ = voxel_downsample(p, v)
    assert len(plain) != len(core)
    touched = torch.cat([k_core[differ], k_plain[differ]])
    cells = torch.unique(k_plain, dim=0)
    untouched = ~(cells[:, None, :] == torch.unique(touched, dim=0)[None]
                  ).all(-1).any(1)
    assert 0 < int(untouched.sum()) < len(plain)
    near = nn_distances(plain, torch.as_tensor(core))
    assert float(near[untouched].max()) <= 1e-6
    assert float(near.max()) <= v


def test_backproject_depth_matches_jax():
    rng = np.random.default_rng(7)
    h, w = 37, 53
    depth = rng.uniform(0.3, 6.0, (h, w)).astype(np.float32)
    depth[::4, ::5] = 0.0
    depth[3, 7] = np.nan
    depth[5, :6] = 7.0                       # past depth_max
    K = np.array([[45.0, 0, 26.0], [0, 43.0, 19.0], [0, 0, 1]], np.float32)
    c2w = jtesting.orbit_c2w_opengl(2.0, 0.4, 0.2)
    c2w_cv = np.linalg.inv(
        jinit_pc.opengl_c2w_to_opencv_w2c(c2w).astype(np.float64)
    ).astype(np.float32)
    for stride in (1, 3):
        got, gv = bp.backproject_depth(torch.as_tensor(depth), K, c2w_cv,
                                       5.0, stride=stride)
        want, wv = jbp.backproject_depth(jnp.asarray(depth), K, c2w_cv, 5.0,
                                         stride=stride)
        assert np.array_equal(gv.numpy(), np.asarray(wv))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def _frames(rng, b, h, w):
    imgs = rng.uniform(0, 1, (b, h, w, 3)).astype(np.float32)
    depths = rng.uniform(1.5, 4.5, (b, h, w)).astype(np.float32)
    depths[:, ::7, ::3] = 0.0
    w2c = np.stack([
        np.linalg.inv(jtesting.orbit_c2w_opengl(3.0, 0.3 * i, 0.1).astype(
            np.float64) @ np.diag([1.0, -1.0, -1.0, 1.0])).astype(np.float32)
        for i in range(b)])
    Ks = np.tile(np.array([[30.0, 0, w / 2], [0, 31.0, h / 2], [0, 0, 1]],
                          np.float32), (b, 1, 1))
    return imgs, depths, w2c, Ks


def test_colorize_and_project_match_jax():
    rng = np.random.default_rng(8)
    b, h, w = 3, 24, 32
    imgs, depths, w2c, Ks = _frames(rng, b, h, w)
    pts = rng.uniform(-1.5, 1.5, (3000, 3)).astype(np.float32)
    pts[:, 2] += 3.0
    # a share of the points on the frames' own depth surfaces, so the gate
    # passes for many (and fails for the rest)
    u = rng.uniform(0, w, 1000).astype(np.float32)
    v = rng.uniform(0, h, 1000).astype(np.float32)
    z = depths[0, v.astype(int), u.astype(int)]
    cam = np.stack([(u - Ks[0, 0, 2]) / Ks[0, 0, 0] * z,
                    (v - Ks[0, 1, 2]) / Ks[0, 1, 1] * z, z], -1)
    c2w = np.linalg.inv(w2c[0].astype(np.float64))
    pts[:1000] = (cam @ c2w[:3, :3].T + c2w[:3, 3]).astype(np.float32)
    got_s, got_c = bp.colorize_points(
        torch.as_tensor(pts), torch.as_tensor(imgs), torch.as_tensor(depths),
        torch.as_tensor(w2c), torch.as_tensor(Ks), 10.0, 0.05, 0.02)
    want_s, want_c = jbp.colorize_points(
        jnp.asarray(pts), jnp.asarray(imgs), jnp.asarray(depths),
        jnp.asarray(w2c), jnp.asarray(Ks), jnp.float32(10.0),
        jnp.float32(0.05), jnp.float32(0.02))
    assert np.array_equal(got_c.numpy(), np.asarray(want_c))
    assert 300 < float(got_c.sum()) < 3 * 3000
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s), atol=1e-5)
    gu, gv, gz = bp.project_points(torch.as_tensor(pts),
                                   torch.as_tensor(w2c[1]),
                                   torch.as_tensor(Ks[1]))
    wu, wv, wz = jbp.project_points(jnp.asarray(pts), jnp.asarray(w2c[1]),
                                    jnp.asarray(Ks[1]))
    for g, want in ((gu, wu), (gv, wv), (gz, wz)):
        np.testing.assert_allclose(g.numpy(), np.asarray(want), atol=1e-5,
                                   rtol=1e-6, equal_nan=True)


def test_colorize_oracle():
    """The JAX package's oracle case: consistent points take the pixel's
    colour, occluded, out-of-frame and behind-camera points none."""
    h, w = 24, 32
    K = np.array([[20.0, 0, 16.0], [0, 20.0, 12.0], [0, 0, 1.0]], np.float32)
    depth = np.full((1, h, w), 2.0, np.float32)
    img = np.zeros((1, h, w, 3), np.float32)
    img[0, :, :16] = (1.0, 0.0, 0.0)
    img[0, :, 16:] = (0.0, 1.0, 0.0)
    pts = np.array([[-0.5, 0, 2], [0.5, 0, 2], [0, 0, 3], [5, 0, 2],
                    [0, 0, -1]], np.float32)
    s, c = bp.colorize_points(torch.as_tensor(pts), torch.as_tensor(img),
                              torch.as_tensor(depth),
                              torch.eye(4)[None], torch.as_tensor(K)[None],
                              10.0, 0.05, 0.02)
    assert c.tolist() == [1, 1, 0, 0, 0]
    assert s[0].tolist() == [1, 0, 0] and s[1].tolist() == [0, 1, 0]


@pytest.fixture(scope="module")
def two_datasets(tmp_path_factory):
    root = tmp_path_factory.mktemp("initpc")
    jtesting.write_synthetic_dataset(root / "src", num_frames=6, width=64,
                                     height=48, with_ply=False)
    shutil.copytree(root / "src", root / "jax")
    shutil.copytree(root / "src", root / "port")
    return root


def test_init_pc_run_matches_jax(two_datasets, monkeypatch):
    root = two_datasets
    quiet = lambda *a: None  # noqa: E731
    jout = jinit_pc.main(jinit_pc.InitPcArgs(data=str(root / "jax"),
                                             stride=2), log=quiet)
    args = init_pc.InitPcArgs(data=str(root / "port"), stride=2)
    out = init_pc.main(args, log=quiet, device="cpu")
    got, want = read_ply(out), read_ply(jout)
    assert len(got) == len(want) > 100
    _match(got.positions, want.positions, 1e-5)
    meta = json.loads((root / "port" / "transforms.json").read_text())
    assert meta["ply_file_path"] == "sparse_pc.ply"

    # a rerun resumes from the per-frame cache: nothing is backprojected
    cached = sorted((root / "port" / "init_pc_cache" / "frames").iterdir())
    assert len(cached) == 6

    def no_backprojection(*a, **k):
        raise AssertionError("a cached frame was backprojected again")
    monkeypatch.setattr(init_pc, "backproject_frame_np", no_backprojection)
    again = read_ply(init_pc.main(args, log=quiet, device="cpu"))
    assert np.array_equal(again.positions, got.positions)

    # colorize, into its own file, both packages from the port's cloud
    shutil.copy(out, root / "jax" / "sparse_pc.ply")
    jc = read_ply(jinit_pc.main(jinit_pc.InitPcArgs(
        data=str(root / "jax"), colorize=True, output_name="c.ply",
        update_transforms=False), log=quiet))
    pc = read_ply(init_pc.main(init_pc.InitPcArgs(
        data=str(root / "port"), colorize=True, output_name="c.ply",
        update_transforms=False), log=quiet, device="cpu"))
    idx = _match(pc.positions, jc.positions, 1e-5)
    assert np.abs(pc.colors.astype(int)
                  - jc.colors[idx].astype(int)).max() <= 1
    assert (pc.colors.sum(-1) > 0).mean() > 0.5
    meta = json.loads((root / "port" / "transforms.json").read_text())
    assert meta["ply_file_path"] == "sparse_pc.ply"


def test_streaming_merge_respects_budget(tmp_path):
    from qed_splatter_tpu_torch.data.ply import write_ply

    rng = np.random.default_rng(0)
    paths = []
    for i in range(4):
        p = tmp_path / f"c{i}.ply"
        write_ply(p, rng.uniform(0, 1.0, (500, 3)).astype(np.float32))
        paths.append(p)
    msgs = []
    merged = init_pc.streaming_merge(paths, voxel_size=0.05, max_points=600,
                                     log=msgs.append)
    want = jinit_pc.streaming_merge(paths, voxel_size=0.05, max_points=600,
                                    log=lambda *a: None)
    assert len(msgs) >= 2 and all("re-voxelized" in m for m in msgs)
    _match(merged, want, 1e-6)
