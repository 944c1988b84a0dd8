"""The bilateral grid's benchmark cell on the CPU: the port's grid against
the benchmark's plain reference (``splatbench/reference/appearance.py``)
on random, non-identity grids, the step's ``bilagrid_clamped`` counter,
the grid's roofline counts and its two metric readers, and the two cells
this grid's configuration came with, loaded by name, the grid cell's made
gaussians those of ``room.train_late`` bit for bit."""

import copy
import hashlib
import importlib.util
import math
from pathlib import Path

import numpy as np
import pytest
import torch

from qed_splatter_tpu_torch.configs import AdamConfig, ModelConfig, \
    default_optimizers
from qed_splatter_tpu_torch.engine.optim import GroupOptimizers
from qed_splatter_tpu_torch.engine.train_step import init_train_state, \
    make_train_step
from qed_splatter_tpu_torch.models import bilateral_grid as tbg
from qed_splatter_tpu_torch.models.gaussians import init_from_points
from qed_splatter_tpu_torch.testing import orbit_c2w_opengl
from splatbench import spec
from splatbench.reference import appearance
from splatbench.reference import step as rstep

ROOT = Path(__file__).resolve().parents[1]
SEED = 2 ** 31 + 11
GRID_CELL = "room_bilagrid.train_late"
# sha256 of room.train_late's tiny made state at SEED (the digest the
# benchmark's own grid-off test pins)
ROOM_LATE_DIGEST = \
    "d9ac84ec3c3cf5083480cd267a4a6f4e38ba50cd6d8220df4a3018ef370a67fc"


def _metric(name):
    path = ROOT / "splatbench" / "metrics" / f"{name}.py"
    s = importlib.util.spec_from_file_location(
        "metric_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(s)
    s.loader.exec_module(mod)
    return mod


def _grids(gen, n=3, shape=(16, 16, 8), std=0.1):
    ident = tbg.init_bilateral_grids(n, shape)
    return ident + std * torch.randn(ident.shape, generator=gen)


def test_grid_step_matches_the_plain_reference():
    """At 24x20 (the grid's 16x16 fits: ``grid_sample``'s path), the
    corrected and clamped image, ten times the total variation, the
    gradients of the grids and of the render, and one Adam update of the
    grid group at the grid cell's resume step (past the warm-up)."""
    gen = torch.Generator().manual_seed(SEED)
    grids = _grids(gen)
    rgb = torch.rand((20, 24, 3), generator=gen)
    weight = torch.randn((20, 24, 3), generator=gen)
    cam = 1

    def run(slice_apply, tv):
        g = grids.clone().requires_grad_(True)
        x = rgb.clone().requires_grad_(True)
        out = slice_apply(g[cam], x)
        loss = (weight * out).sum() + tv(g)
        gg, gx = torch.autograd.grad(loss, (g, x))
        return out.detach(), tv(grids), gg, gx

    port = run(lambda g, x: torch.clamp(tbg.apply_bilateral_grid(g, x),
                                        0.0, 1.0),
               lambda g: 10.0 * tbg.total_variation_loss(g))
    ref = run(appearance.apply_grid, appearance.tv_loss)
    # some values clamped, some not: both sides of the clamp are held
    assert 0.05 < float(((port[0] == 0) | (port[0] == 1)).float().mean()) \
        < 0.95
    # float32 values of order 1 from 8 corners' weighted sums and a 4-term
    # affine, summed in another order (grid_sample against an explicit
    # gather): a few ulps of 1 (at most 5.7e-7 over five seeds; bf16
    # operands would be off by about 4e-3)
    torch.testing.assert_close(port[0], ref[0], rtol=0, atol=1e-5)
    # means of squared differences of float32, in another order (equal
    # over five seeds)
    torch.testing.assert_close(port[1], ref[1], rtol=1e-5, atol=0)
    # gradients: the same sums in reverse, scattered in another order (at
    # most 1.4e-6 of the largest over five seeds)
    for a, b in ((port[2], ref[2]), (port[3], ref[3])):
        scale = float(b.abs().max())
        assert scale > 0
        assert float((a - b).abs().max()) <= 1e-5 * scale
    # one Adam update of the grid group, the port's optimizer against the
    # reference's, from the same moments
    cell = spec.load_cell(GRID_CELL, with_state=False)
    opt = cell.config["optimizers"]["bilateral_grid"]
    count = cell.traffic["resume_step"]
    g = port[2]
    mu = 1e-3 * torch.randn(grids.shape, generator=gen)
    nu = 1e-6 * torch.rand(grids.shape, generator=gen) + 1e-8
    p_port, p_ref = grids.clone(), grids.clone()
    st_port = {"count": torch.full((), count, dtype=torch.int32),
               "mu": mu.clone(), "nu": nu.clone()}
    st_ref = {"count": count, "mu": mu.clone(), "nu": nu.clone()}
    GroupOptimizers({"bilateral_grid": AdamConfig(**opt)}).update_group(
        "bilateral_grid", p_port, g, st_port)
    rstep.adam_(p_ref, g, st_ref, opt)
    assert int(st_port["count"]) == st_ref["count"] == count + 1
    torch.testing.assert_close(st_port["mu"], st_ref["mu"], rtol=0, atol=0)
    torch.testing.assert_close(st_port["nu"], st_ref["nu"], rtol=0, atol=0)
    upd_port, upd_ref = p_port - grids, p_ref - grids
    assert float(upd_ref.abs().max()) > 0
    # the same float32 formula: the learning rate's exp and log and the
    # root may round by an ulp, and grids of order 1 hold the update to
    # about 1e-7 of it
    torch.testing.assert_close(upd_port, upd_ref, rtol=1e-4, atol=1e-10)
    assert opt == dict(default_optimizers()["bilateral_grid"].__dict__)


def test_bilagrid_clamped_counts_the_values_the_clamp_cuts():
    """A 16x16 frame reads the 16x16 grid at its cell centres: with a grid
    that is its offset column alone, column j's three channels are that
    column's offsets whatever the render, so the share the clamp cuts is a
    plain count of the offsets outside [0, 1]."""
    n = 16
    cfg = ModelConfig(use_bilateral_grid=True)
    optims = GroupOptimizers(default_optimizers())
    step = make_train_step(cfg, optims, n, n, has_depth=True, device="cpu")
    pts = np.zeros((4, 3), np.float32)
    pts[:, 0] = np.arange(4) * 0.1
    pts[:, 2] = 3.0
    state = init_train_state(init_from_points(pts, None, device="cpu"),
                             optims, 2, use_bilateral_grid=True)
    # three of seven outside; 0 and 1 themselves are not cut
    offsets = torch.tensor([-0.6, 0.5, 1.6, 0.2, 1.05, 1.0, 0.0])
    per_col = offsets[torch.arange(n * 3) % len(offsets)].reshape(n, 3)
    grid = torch.zeros((n, n, 8, 12))
    grid[..., 3::4] = per_col[None, :, None, :]
    state.bilateral_grids[1] = grid
    f = 0.8 * n
    batch = dict(c2w=orbit_c2w_opengl(3.0, 0.0, 0.0, (0, 0, 3.0)),
                 K=np.array([[f, 0, n / 2], [0, f, n / 2], [0, 0, 1]],
                            np.float32),
                 cam_idx=1, rgb=np.full((n, n, 3), 0.5, np.float32),
                 depth=np.full((n, n, 1), 3.0, np.float32))
    _, metrics = step(state, batch, torch.Generator().manual_seed(0))
    want = float(((per_col < 0) | (per_col > 1)).float().mean())
    assert want == pytest.approx(21 / 48)
    assert float(metrics["bilagrid_clamped"]) == pytest.approx(want,
                                                               abs=1e-7)
    assert metrics["bilagrid_clamped"].dim() == 0
    # without the grid the step has no such metric
    off = make_train_step(ModelConfig(), optims, n, n, has_depth=True,
                          device="cpu")
    state0 = init_train_state(init_from_points(pts, None, device="cpu"),
                              optims, 2)
    _, m0 = off(state0, batch, torch.Generator().manual_seed(0))
    assert "bilagrid_clamped" not in m0


class _Run:
    def __init__(self, trace):
        self.trace = trace


def test_bilagrid_roofline_counts_and_readers():
    """The bytes and operations at the grid cell's 1296x840 frame and
    16x16x8 grid by hand, and the two readers on a run's stages."""
    roof = _metric("bilagrid_roofline_pct.train")
    ms = _metric("bilagrid_ms.train")
    assert roof.frame_and_grid() == (1296, 840, (16, 16, 8))
    px = 1296 * 840
    assert px == 1_088_640
    # forward 12 + 12, backward 12 + 12 + 12 bytes a pixel; the grid and
    # its gradient, 16 * 16 * 8 cells of 12 floats each
    want_bytes = px * (24 + 36) + 2 * 16 * 16 * 8 * 12 * 4
    # forward: guidance 8, weights 21, read 192, affine 18, clamp 6;
    # backward: mask 3, coefficients 9, affine 15, the forward's first
    # three again 221, grid 192, guidance 163
    want_ops = px * (245 + 603)
    c = roof.counts(1296, 840, (16, 16, 8))
    assert c == {"bytes": want_bytes, "ops": want_ops}
    assert want_bytes == 65_515_008 and want_ops == 923_166_720
    bound = max(want_ops / 67e12, want_bytes / 3.35e12)
    assert bound == pytest.approx(19.5567e-6, rel=1e-4)
    # 0.06 s of the grid's stages over 10 steps: 6 ms a step
    run = _Run({"traced_steps": 10, "stages": {
        "render.bilagrid": 0.015, "bwd.render.bilagrid": 0.045,
        "loss.ssim": 1.0}})
    assert ms.read(run) == pytest.approx(6.0)
    assert roof.read(run) == pytest.approx(100 * bound / 6e-3)
    # a program that marks no grid stage (the grid off, or no marks), and
    # an untraced run: nothing to read
    for r in (_Run({"traced_steps": 10, "stages": {"loss.ssim": 1.0}}),
              _Run(None), _Run({"traced_steps": 0, "stages": {}})):
        assert ms.read(r) is None and roof.read(r) is None


def _tiny(cell):
    """``cell`` at a 64x48 room or forest of 6 frames and 1,500 gaussians:
    the same code paths at a size the CPU makes in a second."""
    cell.config = copy.deepcopy(cell.config)
    cell.config["dataset"]["args"].update(num_frames=6, width=64, height=48)
    cell.config["state"]["alive"] = 1500
    cell.state = copy.deepcopy(cell.state)
    cell.traffic = dict(cell.traffic, capacity=4096, trace_chunks=1)
    return cell


def _digest(S) -> str:
    h = hashlib.sha256()

    def feed(key, x):
        h.update(key.encode())
        if isinstance(x, torch.Tensor):
            h.update(str(x.dtype).encode() + str(tuple(x.shape)).encode())
            h.update(x.detach().cpu().contiguous().numpy().tobytes())
        elif isinstance(x, dict):
            for k in sorted(x):
                feed(key + "." + k, x[k])
        else:
            h.update(repr(x).encode())

    for k in sorted(S):
        feed(k, S[k])
    return h.hexdigest()


def test_new_cells_load_and_the_grid_cell_makes_room_late_gaussians(
        tmp_path, monkeypatch):
    from splatbench import scene
    from splatbench.reference import data as rdata

    monkeypatch.setattr(scene, "CACHE", tmp_path)
    dens = spec.load_cell("forest.train_densify")
    assert dens.config["name"] == "forest_depth" and dens.traffic["absgrad"]
    assert {"stats_gap", "new_rows_gap", "refine_mismatch"} <= set(
        dens.limits)
    grid = spec.load_cell(GRID_CELL)
    late = spec.load_cell("room.train_late")
    assert grid.config["model"]["use_bilateral_grid"]
    assert grid.config["model"]["bilateral_grid_shape"] == [16, 16, 8]
    assert [m["name"] for m in grid.per_layer] == [
        "bilagrid_ms.train", "bilagrid_roofline_pct.train"]
    # the room's configuration but for the grid; the late room's rows and
    # tables
    strip = ("name", "source", "about", "assumed")
    assert ({k: v for k, v in grid.config.items() if k not in strip}
            == {k: v for k, v in dict(late.config, model=dict(
                late.config["model"], use_bilateral_grid=True)).items()
                if k not in strip})
    assert ({k: v for k, v in grid.state.items() if k != "bilateral_grid"}
            == late.state)
    grid, late = _tiny(grid), _tiny(late)
    scn = rdata.load_scene(scene.dataset_dir(late.config),
                           late.config["data"])
    S_late = scene.synthesize(scn, late.config, late.traffic, late.state,
                              SEED, "cpu")
    S_grid = scene.synthesize(scn, grid.config, grid.traffic, grid.state,
                              SEED, "cpu")
    assert S_grid["bilateral_grids"].shape == (6, 16, 16, 8, 12)
    assert _digest(S_late) == ROOM_LATE_DIGEST
    assert _digest({k: v for k, v in S_grid.items()
                    if not k.startswith("bilateral")}) == ROOM_LATE_DIGEST
    assert math.isfinite(float(S_grid["bilateral_grids"].sum()))
