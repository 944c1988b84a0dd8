"""The port's live viewer on the CPU, as ``tests/test_viewer_cli.py`` holds
the JAX viewer: every endpoint, pause and resume, the ``/render`` PNG, the
camera path and both HTML pages against the JAX package's, ``cli view``
serving a frame, and a trainer with ``vis="viewer"`` paused and resumed by
a client between its dispatches."""

import json
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from qed_splatter_tpu import viewer as jviewer
from qed_splatter_tpu.viewer_webgl import WEBGL_PAGE as JWEBGL_PAGE
from qed_splatter_tpu_torch import cli, testing
from qed_splatter_tpu_torch.configs import DataConfig, ModelConfig, \
    TrainerConfig
from qed_splatter_tpu_torch.data import png
from qed_splatter_tpu_torch.data.camera_path import load_camera_path
from qed_splatter_tpu_torch.engine import checkpoint as ckpt
from qed_splatter_tpu_torch.engine.trainer import Trainer
from qed_splatter_tpu_torch.viewer import _PAGE, Viewer
from qed_splatter_tpu_torch.viewer_webgl import WEBGL_PAGE


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """A tiny trained checkpoint and its dataset, through the port's CLI."""
    root = tmp_path_factory.mktemp("scene")
    out = tmp_path_factory.mktemp("out")
    testing.write_gaussian_dataset(root, num_frames=4, width=64, height=48,
                                   num_teacher=60, seed=0, eval_every=4,
                                   device="cpu")
    assert cli.main(["init-pc", "--data", str(root), "--stride", "2",
                     "--device", "cpu"]) == 0
    assert cli.main([
        "train", "--data", str(root), "--output-dir", str(out),
        "--device", "cpu", "--max-num-iterations", "20",
        "--steps-per-eval-image", "100", "--steps-per-eval-all-images",
        "100", "--steps-per-save", "20", "--model.num-downscales", "0",
        "--model.max-per-tile", "64", "--no-model.adaptive-max-per-tile",
        "--model.sh-degree", "1",
    ]) == 0
    return root, out / "qed-splatter" / "ckpts"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny CPU tensors: one intra-op thread (no oversubscription beside
    the other test workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _get(base, path):
    return urllib.request.urlopen(base + path, timeout=60).read()


def _json(base, path):
    return json.loads(_get(base, path))


def test_pages_equal_jax():
    assert _PAGE == jviewer._PAGE
    assert WEBGL_PAGE == JWEBGL_PAGE


def test_viewer_endpoints(trained):
    root, ckpts = trained
    state = ckpt.load_state(ckpts, device="cpu")
    cfg = ckpt.model_config_from_meta(ckpt.checkpoint_meta(ckpts))
    viewer = Viewer(cfg, port=0, device="cpu")
    viewer.update(state.params, int(state.step),
                  metrics={"loss": 0.5, "psnr": 20.0})
    viewer.start()
    base = f"http://127.0.0.1:{viewer.port}"
    try:
        assert "crop box" in _get(base, "/").decode()
        st = _json(base, "/status")
        assert st["ready"] and st["training"] and not st["paused"]
        assert st["metrics"]["psnr"] == 20.0
        assert st["gaussian_count"] == int(state.params.num_alive()) > 0
        data = _get(base, "/render?az=0&el=0.2&r=3&w=64&h=40")
        img = png.decode_png(data)
        assert img.shape == (40, 64, 3) and img.dtype == np.uint8
        crop = _get(base, "/render?az=0&el=0.2&r=3&w=64&h=40&crop=1"
                          "&ccx=100&ccy=100&ccz=100&csx=0.1&csy=0.1&csz=0.1")
        crop = png.decode_png(crop)
        assert not np.array_equal(crop, img)
        # an empty crop renders the background alone
        assert np.all(crop.reshape(-1, 3) == crop.reshape(-1, 3)[0])
        depth = png.decode_png(_get(base, "/render?az=0&el=0.2&r=3&w=64"
                                          "&h=40&depth=1"))
        assert depth.shape == (40, 64, 3)
        assert len(viewer.state.timings) == 3
        assert all(r >= 0 and e > 0 for r, e in viewer.state.timings)

        # training controls
        st = _json(base, "/control?cmd=pause")
        assert st["paused"] and viewer.state.paused
        assert _json(base, "/status")["paused"]
        st = _json(base, "/control?cmd=resume")
        assert not st["paused"] and not viewer.state.paused

        # camera-path authoring: keyframes -> nerfstudio JSON, as JAX's
        with pytest.raises(urllib.error.HTTPError):
            _get(base, "/campath?seconds=2&fps=4")
        kfs = ((0.0, 0.2, 3.0), (1.0, 0.3, 2.5), (2.0, 0.2, 3.0))
        for az, el, r in kfs:
            st = _json(base, f"/keyframe?az={az}&el={el}&r={r}")
        assert st["count"] == 3
        doc = _json(base, "/campath?seconds=2&fps=6&w=320&h=240&fov=55")
        jstate = jviewer.ViewerState(cfg)
        jstate.keyframes = list(kfs)
        want = jstate.camera_path_json(2.0, 6.0, 320, 240, 55.0)
        assert doc == json.loads(json.dumps(want))
        assert len(doc["camera_path"]) == 12
        p = root / "path.json"
        p.write_text(json.dumps(doc))
        cams = load_camera_path(str(p))
        assert len(cams) == 12
        c2w, K, w, h = cams[0]
        assert c2w.shape == (3, 4) and (w, h) == (320, 240)
        assert _json(base, "/keyframe?clear=1")["count"] == 0

        # the WebGL page, the splat buffer and the orbit target
        assert "webgl2" in _get(base, "/webgl").decode()
        resp = urllib.request.urlopen(base + "/splats", timeout=60)
        body = resp.read()
        assert len(body) == 32 * int(state.params.num_alive())
        assert body == ckpt.pack_splat_buffer(state.params)
        assert resp.headers["X-Step"] == str(int(state.step))
        assert _json(base, "/meta")["target"] == [0.0, 0.0, 0.0]
        with pytest.raises(urllib.error.HTTPError):
            _get(base, "/nothing")
    finally:
        viewer.stop()


def test_viewer_snapshot_is_a_copy(trained):
    """The trainer updates its params in place: the viewer renders the
    snapshot it was handed, not the live tensors."""
    _, ckpts = trained
    state = ckpt.load_state(ckpts, device="cpu")
    viewer = Viewer(ckpt.model_config_from_meta(ckpt.checkpoint_meta(ckpts)),
                    port=0, device="cpu")
    try:
        viewer.update(state.params, 5)
        before = viewer.state.render_frame(0.0, 0.2, 3.0, 32, 24)
        state.params.means.add_(10.0)
        after = viewer.state.render_frame(0.0, 0.2, 3.0, 32, 24)
        np.testing.assert_array_equal(before, after)
    finally:
        viewer.stop()


def test_cli_view_serves_a_frame(trained):
    _, ckpts = trained
    stop, started = threading.Event(), []
    rc = []
    th = threading.Thread(target=lambda: rc.append(cli.cmd_view(
        ["--load-dir", str(ckpts), "--port", "0", "--device", "cpu"],
        stop=stop, on_start=started.append)))
    th.start()
    try:
        for _ in range(6000):
            if started:
                break
            time.sleep(0.05)
        base = f"http://127.0.0.1:{started[0].port}"
        img = png.decode_png(_get(base, "/render?az=0.5&el=0.2&r=3&w=48"
                                        "&h=32"))
        assert img.shape == (32, 48, 3)
        # the orbit is centred on the alive gaussians
        state = ckpt.load_state(ckpts, device="cpu")
        p = state.params
        np.testing.assert_allclose(_json(base, "/meta")["target"],
                                   p.means[p.alive].mean(0).numpy(),
                                   rtol=1e-5, atol=1e-6)
    finally:
        stop.set()
        th.join(30)
    assert rc == [0]
    assert cli.main(["view", "--load-dir", str(ckpts / "missing"),
                     "--device", "cpu"]) == 2


def test_trainer_with_viewer_pauses_between_dispatches(trained, tmp_path):
    """``vis="viewer"`` on the multi-step path: the viewer gets snapshots
    and metrics, renders while training runs, and a pause holds the step
    between chunks until the resume."""
    root, _ = trained
    cfg = TrainerConfig(
        output_dir=str(tmp_path), data=DataConfig(data=str(root)),
        model=ModelConfig(num_downscales=0, max_per_tile=64,
                          adaptive_max_per_tile=False, sh_degree=1,
                          camera_opt_mode="off"),
        max_num_iterations=30, steps_per_eval_image=0,
        steps_per_eval_all_images=0, steps_per_save=0, log_every=10,
        steps_per_dispatch=10, vis="viewer", viewer_port=0)
    t = Trainer(cfg, device="cpu")
    base = f"http://127.0.0.1:{t.viewer.port}"
    seen = {}
    held = threading.Event()       # the loop reached the gate while paused
    gate = t._viewer_gate

    def watched_gate():
        if t.viewer.state.paused:
            held.set()
        gate()
    t._viewer_gate = watched_gate

    def client():
        for _ in range(30_000):     # the first chunk, however slow the host
            if t.viewer.state.step >= 10:
                break
            time.sleep(0.02)
        _json(base, "/control?cmd=pause")
        held.wait(600)         # the chunk in flight ends, then the gate holds
        s0 = t.state.step
        time.sleep(0.5)
        seen["held"] = (s0, t.state.step)
        seen["render"] = png.decode_png(_get(
            base, "/render?az=0&el=0.2&r=3&w=32&h=24")).shape
        seen["status"] = _json(base, "/status")
        _json(base, "/control?cmd=resume")

    th = threading.Thread(target=client)
    th.start()
    try:
        t.train(finalize=False)
    finally:
        th.join(60)
        t.viewer.stop()
    assert t.state.step == 30
    s0, s1 = seen["held"]
    assert s0 == s1 and s0 < 30
    assert seen["render"] == (24, 32, 3)
    st = seen["status"]
    assert st["training"] and st["paused"] and st["step"] == s0
    assert "loss" in st["metrics"]
    assert t.viewer.state.step == 30
