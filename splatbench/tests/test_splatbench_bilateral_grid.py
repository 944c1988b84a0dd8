"""The bilateral grid through the harness on the CPU: the made grids, the
plain reference against the port with the grid on, the faults of the
grid the check has to catch, and the made state of a cell without the
grid, bit for bit what it was before the grid could be made."""

import copy
import dataclasses
import hashlib

import pytest
import torch

from conftest import tiny_cell

SEED = 2 ** 31 + 11

# the grid rules splatbench/calibrate.py wrote from the grids the program
# trained to step 19,990 on an H100 (room_rgbd and forest_depth with the
# grid on, seed 1), to four digits
ROOM_RULE = {
    "offset_mean": [-0.0313, -0.0004619, 0.003272, 0.01395, 0.01079, -0.02645,
        0.01044, 0.01961, 0.01053, 0.0093, -0.01215, 0.01821],
    "offset_std": [0.01218, 0.004249, 0.005247, 0.003695, 0.006327, 0.004861,
        0.003766, 0.00276, 0.005893, 0.004954, 0.006923, 0.001957],
    "residual_rms": [0.003381, 0.002471, 0.002915, 0.005225, 0.002482,
        0.002493, 0.002864, 0.005645, 0.002199, 0.002107, 0.003014, 0.003388],
    "residual_corr": [0.9606, 0.9453, 0.8706],
    "tv": [8.161e-07, 1.134e-06, 2.68e-06],
    "adam": {"rms": 7.353e-08, "log_sigma": 4.307},
}
FOREST_RULE = {
    "offset_mean": [-0.2161, -0.01357, -0.04445, 0.04679, -0.04032, -0.1647,
        -0.006087, 0.05722, -0.03414, 0.01097, -0.2183, 0.0408],
    "offset_std": [0.02758, 0.02051, 0.03208, 0.01849, 0.03594, 0.03662,
        0.02603, 0.02254, 0.0371, 0.02099, 0.05552, 0.02036],
    "residual_rms": [0.02006, 0.01872, 0.01175, 0.03329, 0.01926, 0.02581,
        0.0157, 0.04558, 0.02056, 0.02832, 0.02878, 0.04585],
    "residual_corr": [0.946, 0.9468, 0.8995],
    "tv": [7.493e-05, 7.384e-05, 0.0001394],
    "adam": {"rms": 1.692e-07, "log_sigma": 3.674},
}

# sha256 of scene.synthesize's state at SEED for each tiny cell, as the
# harness made it before it could make grids (``_digest``)
GRID_OFF_DIGESTS = {
    "forest.train_late":
        "522ed876992abdb0fdcd21fd8d8d4d2583f11d80a1aca9e89c359979ffa635ac",
    "room.train_late":
        "d9ac84ec3c3cf5083480cd267a4a6f4e38ba50cd6d8220df4a3018ef370a67fc",
    "room.train_densify":
        "56057b993202da480bfe08dc8b841780c368ecde5136afa1c5940d409d138122",
}


def grid_cell(name="room.train_late"):
    """The tiny cell ``name`` with the model's bilateral grid on, its grids
    drawn by its configuration's calibrated rule."""
    cell = tiny_cell(name)
    cell.config["model"]["use_bilateral_grid"] = True
    cell.state["bilateral_grid"] = copy.deepcopy(
        FOREST_RULE if name.startswith("forest") else ROOM_RULE)
    return cell


def _scene(cell):
    from splatbench import scene
    from splatbench.reference import data as rdata

    return rdata.load_scene(scene.dataset_dir(cell.config),
                            cell.config["data"])


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


def _run(cell):
    from splatbench import harness

    return harness.run_cell(cell, SEED, 0.05, False, device="cpu")


@pytest.mark.parametrize("name", sorted(GRID_OFF_DIGESTS))
def test_a_cell_without_the_grid_makes_the_state_it_made_before(
        name, tiny_cache):
    from splatbench import scene

    cell = tiny_cell(name)
    assert not cell.config["model"]["use_bilateral_grid"]
    S = scene.synthesize(_scene(cell), cell.config, cell.traffic, cell.state,
                         SEED, "cpu")
    assert "bilateral_grids" not in S
    assert _digest(S) == GRID_OFF_DIGESTS[name]


def test_made_grids_follow_the_rule(tiny_cache):
    from splatbench import calibrate, scene

    cell = grid_cell()
    scn = _scene(cell)
    S = scene.synthesize(scn, cell.config, cell.traffic, cell.state, SEED,
                         "cpu")
    grids, st = S["bilateral_grids"], S["bilateral_grid_state"]
    assert grids.shape == (len(scn.frames), 16, 16, 8, 12)
    assert st["count"] == cell.traffic["resume_step"]
    assert not st["mu"].any()
    train = list(scn.train_indices)
    other = [i for i in range(len(scn.frames)) if i not in train]
    ident = torch.tensor(scene.IDENTITY)
    assert (grids[other] == ident).all() and not st["nu"][other].any()
    assert (st["nu"][train] > 0).all()
    got = calibrate.grid_statistics(grids, train)
    assert got["offset_std"] == pytest.approx(ROOM_RULE["offset_std"],
                                              rel=1.0)
    assert got["residual_rms"] == pytest.approx(ROOM_RULE["residual_rms"],
                                                rel=1e-5)
    assert got["residual_corr"] == pytest.approx(
        ROOM_RULE["residual_corr"], abs=0.02)
    # the loss's total variation, as the trained grids gave it (the tiny
    # room has 5 train frames of 6, the room 44 of 48)
    assert got["tv"] == pytest.approx(ROOM_RULE["tv"], rel=0.25)
    # and the rest of the state is the grid-off state's, draw for draw
    cell_off = tiny_cell()
    S_off = scene.synthesize(scn, cell_off.config, cell_off.traffic,
                             cell_off.state, SEED, "cpu")
    assert _digest(S_off) == GRID_OFF_DIGESTS["room.train_late"]
    assert _digest({k: v for k, v in S.items()
                    if not k.startswith("bilateral")}) == _digest(S_off)


def test_a_grid_cell_without_a_grid_rule_raises(tiny_cache):
    from splatbench import scene

    cell = grid_cell()
    del cell.state["bilateral_grid"]
    with pytest.raises(KeyError, match="bilateral_grid"):
        scene.synthesize(_scene(cell), cell.config, cell.traffic,
                         cell.state, SEED, "cpu")


def test_the_reference_slice_is_trilinear_with_clamped_edges():
    from splatbench.reference import appearance

    # a grid linear in (row, column, level): the slice gives the line
    # itself inside the grid, and the edge's value beyond the half-pixel
    # centres
    gh, gw, gd = 4, 5, 3
    r, c, l = torch.meshgrid(torch.arange(float(gh)),
                             torch.arange(float(gw)),
                             torch.arange(float(gd)), indexing="ij")
    grid = torch.stack([r, c, l] + [torch.zeros_like(r)] * 9, -1)
    h, w = 8, 10
    lum = torch.linspace(0.0, 1.0, h * w).reshape(h, w)
    rgb = lum[..., None].expand(h, w, 3).contiguous()
    out = appearance.slice_grid(grid, rgb)
    rows = ((torch.arange(h) + 0.5) * gh / h - 0.5).clamp(0, gh - 1)
    cols = ((torch.arange(w) + 0.5) * gw / w - 0.5).clamp(0, gw - 1)
    assert torch.allclose(out[..., 0], rows[:, None].expand(h, w))
    assert torch.allclose(out[..., 1], cols[None, :].expand(h, w))
    assert torch.allclose(out[..., 2], lum * (gd - 1), atol=1e-6)
    with pytest.raises(ValueError, match="smaller than the grid"):
        appearance.slice_grid(grid, rgb[:3])


@pytest.mark.parametrize("name", ["room.train_late", "forest.train_late"])
def test_reference_follows_the_port_with_the_grid(name, tiny_cache):
    from splatbench import spec

    out = _run(grid_cell(name))
    checks = out["checks"]
    # at the limits of the cell the grid configuration would join
    assert checks["checks"].keys() == spec.load_cell(name).limits.keys()
    assert checks["correct"], checks
    assert out["attempted"] >= 10 and out["failed"] == 0


def _next_camera(monkeypatch):
    from qed_splatter_tpu_torch.engine import train_step

    real = train_step.TrainStep._grads

    def next_grid(self, state, inp):
        # camera c reads the grid of camera c + 1; the gradient goes back
        # to the grid it read
        rolled = dataclasses.replace(state, bilateral_grids=torch.roll(
            state.bilateral_grids, -1, 0))
        sg = real(self, rolled, inp)
        return dataclasses.replace(sg, bilateral_grids=torch.roll(
            sg.bilateral_grids, 1, 0))

    monkeypatch.setattr(train_step.TrainStep, "_grads", next_grid)


def _no_tv(monkeypatch):
    from qed_splatter_tpu_torch.engine import train_step

    monkeypatch.setattr(train_step, "total_variation_loss",
                        lambda grids: 0.0 * grids.sum())


def _no_adam(monkeypatch):
    from qed_splatter_tpu_torch.engine import optim

    real = optim.GroupOptimizers.update_group

    def skip(self, name, *args):
        if name != "bilateral_grid":
            real(self, name, *args)

    monkeypatch.setattr(optim.GroupOptimizers, "update_group", skip)


@pytest.mark.parametrize("fault", [_next_camera, _no_tv, _no_adam],
                         ids=["next_camera_grid", "tv_dropped",
                              "grid_adam_skipped"])
def test_a_fault_of_the_grid_is_not_correct(fault, tiny_cache, monkeypatch):
    fault(monkeypatch)
    checks = _run(grid_cell())["checks"]
    assert not checks["correct"], checks


def test_calibrate_writes_the_grid_rule_and_the_made_grids_keep_it(
        tiny_cache, monkeypatch, tmp_path):
    import json

    from splatbench import calibrate, run, scene, spec

    cell = tiny_cell()
    cell.config["dataset"]["args"].update(num_frames=16)
    # trained from 2,000 random points, not the dataset's 50,000
    cell.config["model"].update(use_bilateral_grid=True, random_init=True,
                                num_random=2000)
    monkeypatch.setattr(spec, "load_cell",
                        lambda name, with_state=True: copy.deepcopy(cell))
    monkeypatch.setattr(run, "_environment", lambda: None)
    out = tmp_path / "rule.json"
    assert calibrate.main(["--config", "room_rgbd", "--cells",
                           "room.train_late", "--device", "cpu",
                           "--budget-s", "20", "--out", str(out)]) == 0
    rule = json.loads(out.read_text())["cells"]["room.train_late"]
    got = rule["bilateral_grid"]
    assert {"offset_mean", "offset_std", "residual_rms", "residual_corr",
            "tv", "adam"} <= got.keys()
    assert got["adam"]["rms"] > 0 and max(got["residual_rms"]) > 0
    cell.state = rule
    scn = _scene(cell)
    S = scene.synthesize(scn, cell.config, cell.traffic, rule, SEED, "cpu")
    made = calibrate.grid_statistics(S["bilateral_grids"],
                                     list(scn.train_indices))

    def rms(v):
        return float(torch.tensor(v).pow(2).mean().sqrt())

    for key in ("offset_std", "residual_rms", "tv"):
        assert 0.5 < rms(made[key]) / rms(got[key]) < 2.0, (key, made, got)
    for a, b in zip(made["tv"], got["tv"]):
        assert 0.5 < a / b < 2.0, (made["tv"], got["tv"])
