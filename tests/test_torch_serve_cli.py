"""The port's serving tools on the CPU: camera paths and the exports against
the JAX package, and the ``eval``, ``render`` and ``export`` subcommands on
a tiny checkpoint trained by the port's own ``train``; the writer's
optional backends (with fakes in ``sys.modules``) and the one subcommand
still refused."""

import json
import sys
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qed_splatter_tpu.data import camera_path as jcamera_path
from qed_splatter_tpu.engine import checkpoint as jckpt
from qed_splatter_tpu.models.gaussians import GaussianParams as JParams
from qed_splatter_tpu_torch import cli
from qed_splatter_tpu_torch import testing as ttesting
from qed_splatter_tpu_torch.data import camera_path, png
from qed_splatter_tpu_torch.data.ply import read_ply
from qed_splatter_tpu_torch.engine import checkpoint as ckpt
from qed_splatter_tpu_torch.engine.writer import MetricsWriter
from qed_splatter_tpu_torch.models.gaussians import FIELDS, from_jax_arrays
from qed_splatter_tpu_torch.models.splatfacto import render


def _c2w_forms(m44):
    """One pose as the four camera_to_world forms nerfstudio files hold."""
    return {"flat16": m44.reshape(-1).tolist(), "nested4x4": m44.tolist(),
            "flat12": m44[:3].reshape(-1).tolist(),
            "nested3x4": m44[:3].tolist()}


def test_camera_path_matches_jax(tmp_path):
    poses = [ttesting.orbit_c2w_opengl(2.5, a, 0.3, (0.1, -0.2, 3.0))
             for a in (0.0, 0.7, 1.9)]
    for form in ("flat16", "nested4x4", "flat12", "nested3x4"):
        frames = [{"camera_to_world": _c2w_forms(p)[form]} for p in poses]
        frames[1]["fov"] = 70.0                 # the rest take the default
        path = tmp_path / f"{form}.json"
        path.write_text(json.dumps({"render_width": 80, "render_height": 60,
                                    "fov": 45.0, "camera_path": frames}))
        got = camera_path.load_camera_path(str(path))
        want = jcamera_path.load_camera_path(str(path))
        assert len(got) == len(want) == 3
        for (gc, gk, gw, gh), (wc, wk, ww, wh), p in zip(got, want, poses):
            assert (gw, gh) == (ww, wh) == (80, 60)
            assert np.array_equal(gc, wc) and np.array_equal(gk, wk)
            assert np.array_equal(gc, p[:3])
    (tmp_path / "bad.json").write_text(json.dumps({"frames": []}))
    with pytest.raises(ValueError, match="camera_path"):
        camera_path.load_camera_path(str(tmp_path / "bad.json"))


def _jax_params(seed=0, capacity=300, sh_degree=2):
    rng = np.random.default_rng(seed)
    k = (sh_degree + 1) ** 2 - 1
    return {
        "means": rng.normal(0, 1.5, (capacity, 3)).astype(np.float32),
        "quats": rng.normal(size=(capacity, 4)).astype(np.float32),
        "scales": rng.normal(-3, 0.7, (capacity, 3)).astype(np.float32),
        "opacities": rng.normal(0, 2, (capacity,)).astype(np.float32),
        "features_dc": rng.normal(0, 1.2, (capacity, 3)).astype(np.float32),
        "features_rest": rng.normal(0, 0.1, (capacity, k, 3)).astype(
            np.float32),
        "alive": rng.uniform(size=capacity) < 0.7,
    }


META = {"dataparser_transform": [[0.0, -1.0, 0.0, 0.3], [1.0, 0.0, 0.0, -0.1],
                                 [0.0, 0.0, 1.0, 0.2]],
        "dataparser_scale": 0.4}


@pytest.mark.parametrize("meta", [None, META], ids=["no_meta", "transform"])
def test_exports_match_jax(tmp_path, meta):
    arrays = _jax_params()
    jp = JParams(**{f: jnp.asarray(arrays[f]) for f in FIELDS})
    tp = from_jax_arrays(arrays, device="cpu")
    buf = ckpt.pack_splat_buffer(tp, meta)
    assert len(buf) == 32 * int(arrays["alive"].sum())
    assert buf == jckpt.pack_splat_buffer(jp, meta)
    for name, fn, jfn in (
            ("splat.ply", ckpt.export_ply, jckpt.export_ply),
            ("pc.ply", ckpt.export_pointcloud_ply,
             jckpt.export_pointcloud_ply),
            ("s.splat", ckpt.export_splat, jckpt.export_splat)):
        n = fn(tmp_path / f"port_{name}", tp, meta)
        assert n == jfn(tmp_path / f"jax_{name}", jp, meta)
        assert ((tmp_path / f"port_{name}").read_bytes()
                == (tmp_path / f"jax_{name}").read_bytes()), name


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """A 10-step checkpoint of the port's ``train`` on a tiny dataset, with
    an ``eval_all`` row at its last step."""
    root = tmp_path_factory.mktemp("scene")
    out = tmp_path_factory.mktemp("out")
    ttesting.write_synthetic_dataset(root, num_frames=5, width=64, height=48,
                                     with_ply=True)
    assert cli.main([
        "train", "--data", str(root), "--device", "cpu", "--output-dir",
        str(out), "--max-num-iterations", "10", "--steps-per-eval-image",
        "0", "--steps-per-eval-all-images", "10", "--steps-per-save", "10",
        "--model.num-downscales", "0", "--model.max-per-tile", "64",
        "--model.sh-degree", "1"]) == 0
    return root, out / "qed-splatter"


def _printed(text):
    rows = {}
    for line in text.splitlines():
        k, sep, v = line.partition(": ")
        if sep and k.replace("_", "").isalnum():
            rows[k] = float(v)
    return rows


def test_eval_cli_prints_the_trainers_eval_all(trained, tmp_path, capsys):
    root, run = trained
    rows = [json.loads(line) for line in
            (run / "metrics.jsonl").read_text().splitlines()]
    want = [r for r in rows if r["split"] == "eval_all"][-1]
    assert want["step"] == 10
    capsys.readouterr()
    assert cli.main(["eval", "--data", str(root), "--load-dir",
                     str(run / "ckpts"), "--device", "cpu", "--output-dir",
                     str(tmp_path)]) == 0
    got = _printed(capsys.readouterr().out)
    for k in ("rgb_psnr", "rgb_ssim", "rgb_mse", "depth_abs_rel",
              "depth_a1", "gaussian_count"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6, err_msg=k)
    assert np.isnan(got["rgb_lpips"])
    assert cli.main(["eval", "--data", str(root), "--device", "cpu"]) == 2


def _write_path(tmp_path, target):
    frames = [{"camera_to_world": ttesting.orbit_c2w_opengl(
        3.0, a, 0.2, target).reshape(-1).tolist(), "fov": 60.0}
        for a in (0.0, 1.0)]
    p = tmp_path / "cam.json"
    p.write_text(json.dumps({"render_width": 40, "render_height": 30,
                             "camera_path": frames}))
    return p


@pytest.mark.parametrize("mode", ["orbit", "eval", "path"])
def test_render_cli_frames_equal_render(trained, tmp_path, mode):
    root, run = trained
    state = ckpt.load_state(run / "ckpts", device="cpu")
    cfg = ckpt.model_config_from_meta(ckpt.checkpoint_meta(run / "ckpts"))
    out = tmp_path / "frames"
    argv = ["--load-dir", str(run / "ckpts"), "--device", "cpu",
            "--output-dir", str(out)]
    argv += {"orbit": ["--num-frames", "3", "--width", "48", "--height",
                       "32", "--depth"],
             "eval": ["--mode", "eval", "--data", str(root)],
             "path": ["--camera-path", str(_write_path(tmp_path, (0, 0, 3)))],
             }[mode]
    assert cli.main(["render", *argv]) == 0
    ns = cli.render_parser().parse_args(argv)
    ns.mode = ns.mode or ("path" if ns.camera_path else "orbit")
    cams = cli.render_cameras(ns, state.params)
    assert len(cams) == {"orbit": 3, "eval": 1, "path": 2}[mode]
    names = sorted(p.name for p in out.iterdir())
    assert names[-len(cams):] == [f"frame_{i:05d}.png"
                                  for i in range(len(cams))]
    assert (mode == "orbit") == ("depth_00000.png" in names)
    for i, (c2w, K, w, h) in enumerate(cams):
        want = render(state.params, c2w, K, w, h, cfg, step=state.step,
                      train=False, device="cpu")
        got = png.read_png(out / f"frame_{i:05d}.png")
        assert got.shape == (h, w, 3)
        assert np.array_equal(got, cli.to_uint8(want.rgb))


def test_render_cli_crop_and_errors(trained, tmp_path):
    root, run = trained
    base = ["render", "--load-dir", str(run / "ckpts"), "--device", "cpu",
            "--num-frames", "1", "--width", "32", "--height", "24"]
    assert cli.main([*base, "--output-dir", str(tmp_path / "full")]) == 0
    # a box far away leaves nothing: the background image
    assert cli.main([*base, "--output-dir", str(tmp_path / "crop"),
                     "--crop-center", "100", "100", "100", "--crop-size",
                     "0.1", "0.1", "0.1"]) == 0
    full = png.read_png(tmp_path / "full" / "frame_00000.png")
    crop = png.read_png(tmp_path / "crop" / "frame_00000.png")
    assert not np.array_equal(full, crop)
    assert (crop.reshape(-1, 3) == crop.reshape(-1, 3)[0]).all()
    assert cli.main([*base, "--mode", "eval"]) == 2
    assert cli.main([*base, "--mode", "path"]) == 2
    assert cli.main(["render", "--load-dir", str(tmp_path), "--device",
                     "cpu"]) == 2


def test_export_cli_counts_and_crop(trained, tmp_path):
    _, run = trained
    ck = str(run / "ckpts")
    state = ckpt.load_state(ck, device="cpu")
    alive = state.params.alive
    means = state.params.means[alive]
    n_alive = int(alive.sum())
    base = ["export", "--load-dir", ck, "--device", "cpu", "--output"]
    assert cli.main([*base, str(tmp_path / "a.ply")]) == 0
    assert len(read_ply(tmp_path / "a.ply")) == n_alive
    assert cli.main([*base, str(tmp_path / "a.splat")]) == 0
    assert (tmp_path / "a.splat").stat().st_size == 32 * n_alive
    assert cli.main([*base, str(tmp_path / "pc.ply"), "--pointcloud"]) == 0
    assert len(read_ply(tmp_path / "pc.ply")) == n_alive
    c = means.mean(0)
    half = (means.max(0).values - means.min(0).values) / 4
    inside = int(((means - c).abs() <= half).all(-1).sum())
    assert 0 < inside < n_alive
    assert cli.main([*base, str(tmp_path / "crop.ply"), "--crop-center",
                     *map(str, c.tolist()), "--crop-size",
                     *map(str, (2 * half).tolist())]) == 0
    assert len(read_ply(tmp_path / "crop.ply")) == inside
    assert cli.main([*base, str(tmp_path / "x.ply"), "--load-dir",
                     str(tmp_path)]) == 2


class _Recorder:
    """Records every method call on it as (library, method, args, kwargs)."""

    def __init__(self, calls, lib):
        self._calls, self._lib = calls, lib

    def __getattr__(self, method):
        return lambda *a, **k: self._calls.append((self._lib, method, a, k))


def test_writer_backends_call_their_libraries(tmp_path, monkeypatch,
                                              capsys):
    log = []
    wandb = types.ModuleType("wandb")
    wandb.init = lambda **kw: (log.append(("wandb", "init", (), kw))
                               or _Recorder(log, "wandb"))
    comet = types.ModuleType("comet_ml")
    comet.Experiment = lambda **kw: (log.append(("comet", "init", (), kw))
                                     or _Recorder(log, "comet"))
    tb = types.ModuleType("torch.utils.tensorboard")
    tb.SummaryWriter = lambda **kw: (log.append(("tb", "init", (), kw))
                                     or _Recorder(log, "tb"))
    for name, mod in (("wandb", wandb), ("comet_ml", comet),
                      ("torch.utils.tensorboard", tb)):
        monkeypatch.setitem(sys.modules, name, mod)
    w = MetricsWriter(tmp_path, console_every=0, use_tensorboard=True,
                      use_wandb=True, use_comet=True)
    w.write(7, {"loss": torch.tensor(0.25)}, prefix="train")
    w.close()
    # the row holds the loss and the writer's iters_per_s
    calls = [(lib, m) for lib, m, _, _ in log]
    assert calls == [("tb", "init"), ("wandb", "init"), ("comet", "init"),
                     ("tb", "add_scalar"), ("tb", "add_scalar"),
                     ("wandb", "log"), ("comet", "log_metrics"),
                     ("tb", "close"), ("wandb", "finish"), ("comet", "end")]
    assert log[0][3]["log_dir"] == str(tmp_path / "tb")
    assert log[3][2] == ("train/loss", 0.25, 7)
    assert log[4][2][0] == "train/iters_per_s"
    for row in log[5:7]:
        assert row[2][0]["train/loss"] == 0.25 and row[3] == {"step": 7}
    # a backend that cannot be imported is reported and left out
    monkeypatch.setitem(sys.modules, "wandb", None)
    capsys.readouterr()
    w = MetricsWriter(tmp_path / "b", console_every=0, use_wandb=True)
    w.write(1, {"loss": 1.0})
    w.close()
    assert "wandb unavailable" in capsys.readouterr().out
    assert json.loads((tmp_path / "b" / "metrics.jsonl").read_text())[
        "loss"] == 1.0


def test_view_is_still_refused(tmp_path, capsys):
    """``view`` was refused until ROADMAP item 10 was ported: now a missing
    checkpoint is an error (rc 2, named) and every subcommand exists
    (tests/test_torch_viewer.py serves frames)."""
    assert cli.main(["view", "--load-dir", str(tmp_path / "x"),
                     "--device", "cpu"]) == 2
    assert "no checkpoint" in capsys.readouterr().err
    assert set(cli.COMMANDS) == {"train", "train-multi", "eval", "init-pc",
                                 "export", "render", "eval-pc", "view"}
