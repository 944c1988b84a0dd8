"""The cell's inputs: the dataset on disk and the state the run resumes.

The dataset is written once per checkout by the program's own synthetic
writer (``qed_splatter_tpu_torch.testing``), with the configuration's
arguments, into ``.splatbench_cache/datasets/<config>-<hash>/``: a fixed
directory keyed by the writer and its arguments. Later runs only read it,
as users read a captured scene.

The state is made here from ``--seed``, on the device, in a few large
calls: the positions on the scene's surfaces (the train frames' depth
backprojected, as ``init-pc`` does, and sampled), colours from their
pixels, and opacities, sizes against the points' spacing, SH bands, Adam's
second moments and, for a densifying window, the statistics a refine
period has gathered, all drawn from a state the program trained on the
card (``splatbench/states/<cell>.json``, made by
:mod:`splatbench.calibrate`). With the model's bilateral grid on, each
train camera's colour grid is drawn too (:func:`bilateral_grids`), after
every other draw, so that a state without grids is the same with or
without that code. Every draw
is a ``torch.Generator`` on the device seeded from ``--seed``, so the same
seed gives the same state, bit for bit, and the reference can make it
again. It reads the dataset through :mod:`splatbench.reference.data`, not
the program's dataparser.
"""

from __future__ import annotations

import hashlib
import json
import math
import os
import shutil
from pathlib import Path

import numpy as np
import torch

from splatbench.reference import data as rdata

ROOT = Path(__file__).resolve().parents[1]
CACHE = ROOT / ".splatbench_cache"
GROUPS = ("means", "quats", "scales", "opacities", "features_dc",
          "features_rest")
SH_C0 = 0.28209479177387814


def dataset_dir(config: dict) -> Path:
    """The dataset of ``config``, written on first use (atomically: a run
    cut while writing leaves no directory that a later run would read)."""
    ds = config["dataset"]
    key = hashlib.sha256(json.dumps(ds, sort_keys=True).encode()).hexdigest()
    out = CACHE / "datasets" / f"{config['name']}-{key[:16]}"
    if (out / "transforms.json").exists():
        return out
    from qed_splatter_tpu_torch import testing

    tmp = out.with_name(out.name + f".partial{os.getpid()}")
    shutil.rmtree(tmp, ignore_errors=True)
    getattr(testing, ds["writer"])(
        tmp, workers=min(8, os.cpu_count() or 1), **ds["args"])
    os.replace(tmp, out)
    return out


def _normal(gen, shape, device, mean=0.0, std=1.0):
    return torch.randn(shape, generator=gen, device=device) * std + mean


def surface_points(scene: rdata.Scene, n: int, gen: torch.Generator,
                   device) -> tuple:
    """``n`` points on the train frames' surfaces (each frame's depth
    backprojected at random valid pixels, an equal share a frame), the
    colour of each point's pixel, and the surfaces' area: the count of
    voxels the points fill, on a grid coarse enough that every voxel the
    surface crosses holds a point, times a voxel's face."""
    train = [scene.frames[i] for i in scene.train_indices]
    per = [n // len(train) + (1 if i < n % len(train) else 0)
           for i in range(len(train))]
    pts, cols, foot = [], [], []
    for fr, m in zip(train, per):
        depth = torch.as_tensor(
            rdata.read_depth(fr, scene.depth_scale)[..., 0], device=device)
        rgb = torch.as_tensor(rdata.read_png_rgb(fr.image_path), device=device)
        valid = torch.nonzero(depth.reshape(-1) > 0)[:, 0]
        pick = valid[torch.randperm(valid.numel(), generator=gen,
                                    device=device)[:m]]
        v, u = pick // fr.width, pick % fr.width
        z = depth.reshape(-1)[pick]
        K = torch.as_tensor(fr.K, device=device)
        x = (u.float() + 0.5 - K[0, 2]) / K[0, 0]
        y = -(v.float() + 0.5 - K[1, 2]) / K[1, 1]
        p_cam = torch.stack([x * z, y * z, -z], dim=-1)
        c2w = torch.as_tensor(fr.c2w, device=device)
        pts.append(p_cam @ c2w[:3, :3].T + c2w[:3, 3])
        cols.append(rgb.reshape(-1, 3)[pick].float() / 255.0)
        foot.append(z / K[0, 0])
    pts, cols, foot = torch.cat(pts), torch.cat(cols), torch.cat(foot)
    per_pixel = float(np.mean([fr.width * fr.height for fr in train]))
    guess = foot * math.sqrt(per_pixel / max(n / len(train), 1.0))
    vox = 3.0 * float(torch.quantile(guess[:100_000], 0.95))
    occupied = torch.unique(torch.floor(pts / vox).to(torch.int64), dim=0)
    return pts, cols, occupied.shape[0] * vox * vox


def sh_band(k_rest: int) -> list:
    """The SH degree (1, 2, 3, ...) of each higher coefficient."""
    return [int(math.isqrt(i + 1)) for i in range(k_rest)]


def synthesize(scene: rdata.Scene, config: dict, traffic: dict, state: dict,
               seed: int, device) -> dict:
    """The state at ``traffic["resume_step"]`` (the reference's plain
    dicts; see :mod:`splatbench.reference.step`), drawn by the cell's
    state rule ``state`` (``splatbench/states/<cell>.json``): rows of a
    state the program trained on the card, each gaussian taking one row's
    opacity, size and shape, and, in a densifying window, statistics."""
    n = int(config["state"]["alive"])
    cap = int(traffic["capacity"])
    if cap < n:
        raise ValueError(f"capacity {cap} < alive {n}")
    gen = torch.Generator(device=device).manual_seed(int(seed))
    pts, cols, area = surface_points(scene, n, gen, device)
    table = torch.tensor(state["rows"], dtype=torch.float32, device=device)
    pick = table[torch.randint(table.shape[0], (n,), generator=gen,
                               device=device)]
    col = {name: pick[:, i] for i, name in enumerate(state["columns"])}

    f32 = torch.float32
    means = torch.zeros((cap, 3), dtype=f32, device=device)
    means[:n] = pts
    # sizes against the spacing n points would have on the surfaces
    mean_log = 0.5 * math.log(area / n) + col["log_size_offset"]
    d_max, d_min = col["log_axis_max"], col["log_axis_min"]
    scales = torch.zeros((cap, 3), dtype=f32, device=device)
    scales[:n] = torch.stack([mean_log + d_max, mean_log - d_max - d_min,
                              mean_log + d_min], dim=-1)
    quats = torch.zeros((cap, 4), dtype=f32, device=device)
    quats[:, 0] = 1.0
    q = _normal(gen, (n, 4), device)
    quats[:n] = q / q.norm(dim=-1, keepdim=True)
    opac = torch.zeros((cap,), dtype=f32, device=device)
    opac[:n] = col["opacity_logit"]
    dc = torch.zeros((cap, 3), dtype=f32, device=device)
    dc[:n] = (cols - 0.5) / SH_C0
    k_rest = (config["model"]["sh_degree"] + 1) ** 2 - 1
    band_rms = torch.tensor([state["sh_rest_rms"][b - 1]
                             for b in sh_band(k_rest)], dtype=f32,
                            device=device)
    rest = torch.zeros((cap, k_rest, 3), dtype=f32, device=device)
    rest[:n] = _normal(gen, (n, k_rest, 3), device) * band_rms[:, None]
    alive = torch.zeros((cap,), dtype=torch.bool, device=device)
    alive[:n] = True
    params = dict(means=means, quats=quats, scales=scales, opacities=opac,
                  features_dc=dc, features_rest=rest, alive=alive)

    step = int(traffic["resume_step"])
    adam = state["adam"]

    def moments(x, group):
        nu = torch.zeros_like(x)
        nu[:n] = (adam[group]["rms"] * torch.exp(_normal(
            gen, x[:n].shape, device, std=adam[group]["log_sigma"]))) ** 2
        return {"count": step, "mu": torch.zeros_like(x), "nu": nu}

    opt = {g: moments(params[g], g) for g in GROUPS}
    n_cam = len(scene.frames)
    camera_opt = _normal(gen, (n_cam, 6), device,
                         std=state["camera_delta_rms"])
    cam = adam["camera_opt"]
    cam_nu = (cam["rms"] * torch.exp(_normal(
        gen, (n_cam, 6), device, std=cam["log_sigma"]))) ** 2
    camera_opt_state = {"count": step, "mu": torch.zeros_like(camera_opt),
                        "nu": cam_nu}
    stats = {k: torch.zeros((cap,), dtype=f32, device=device)
             for k in ("grad_norm_sum", "vis_count", "max_radii_frac")}
    if traffic["absgrad"]:
        # what the refine period before the resume step gathered
        steps = step % int(config["model"]["refine_every"])
        vis = torch.round(col["vis_share"] * steps)
        mean_grad = config["model"]["densify_grad_thresh"] * torch.exp(
            col["log_grad_ratio"])
        train = scene.frames[int(scene.train_indices[0])]
        stats["vis_count"][:n] = vis
        stats["grad_norm_sum"][:n] = vis * mean_grad / (
            0.5 * max(train.width, train.height))
    out = {"params": params, "opt": opt, "camera_opt": camera_opt,
           "camera_opt_state": camera_opt_state, "stats": stats,
           "step": step}
    if config["model"]["use_bilateral_grid"]:
        if "bilateral_grid" not in state:
            raise KeyError("the model turns the bilateral grid on, and the "
                           "cell's states file has no 'bilateral_grid' rule "
                           "(splatbench/calibrate.py writes it)")
        out["bilateral_grids"], out["bilateral_grid_state"] = (
            bilateral_grids(scene, config["model"]["bilateral_grid_shape"],
                            state["bilateral_grid"], step, gen, device))
    return out


IDENTITY = (1.0, 0.0, 0.0, 0.0, 0.0, 1.0, 0.0, 0.0, 0.0, 0.0, 1.0, 0.0)


def _smooth_corr(r: float, n: int) -> torch.Tensor:
    """[n, n] float64 correlation of a smooth stationary field along an
    axis of ``n`` cells whose neighbours correlate by ``r``: ``r`` to the
    squared distance (a Gaussian in the distance)."""
    k = torch.arange(n, dtype=torch.float64)
    return r ** ((k[:, None] - k[None, :]) ** 2)


def _neighbour_corr(sample_corr, sizes) -> list:
    """Each axis's neighbour correlation ``r`` of a separable smooth field
    (:func:`_smooth_corr`) whose expected sample correlation over a grid of
    ``sizes`` is ``sample_corr``: one minus the mean squared neighbour
    difference, 2 (1 - r), over twice the variance about the grid's mean,
    1 minus the mean of the field's correlations over the grid. A fixed
    point, in plain floats (no draw)."""
    r = [float(c) for c in sample_corr]
    for _ in range(200):
        mean_corr = 1.0
        for ri, n in zip(r, sizes):
            mean_corr *= float(_smooth_corr(ri, n).sum()) / n ** 2
        var = 1.0 - mean_corr
        r = [min(max(1.0 - (1.0 - c) * var, 0.0), 0.999999)
             for c in sample_corr]
    return r


def _correlate(x: torch.Tensor, dim: int, r: float) -> torch.Tensor:
    """``x`` (independent unit normals along ``dim``) given the correlation
    :func:`_smooth_corr` along ``dim``: each line times a square root of
    the matrix, as products and sums (no matrix product, so no TF32)."""
    n = x.shape[dim]
    lam, vec = torch.linalg.eigh(_smooth_corr(r, n))
    root = (vec * lam.clamp(min=0.0).sqrt()).to(x.device, x.dtype)
    root = root.reshape((1,) * dim + (n, n) + (1,) * (x.dim() - dim - 1))
    return (root * x.unsqueeze(dim)).sum(dim + 1)


def bilateral_grids(scene: rdata.Scene, shape, rule: dict, step: int,
                    gen: torch.Generator, device) -> tuple:
    """The colour grids ([num_cameras, gh, gw, gd, 12], one per frame, as
    the program's trainer makes them) and their Adam state, by the rule
    ``rule`` (the ``bilateral_grid`` key of the states file, written by
    :func:`splatbench.calibrate.grid_statistics` from trained grids).

    The frames the trainer never trains on keep the identity grid and a
    zero second moment, as in a trained state. Each train camera's grid is
    the identity plus, for each of the 12 coefficients, a per-camera
    offset (normal at ``offset_mean``, ``offset_std``) and a residual about
    it: a smooth field (a Gaussian correlation along each grid axis, with
    the camera's mean taken out) at ``residual_rms`` over the cameras,
    whose sample neighbour correlation along each axis is
    ``residual_corr``, so that its total variation is the trained grids'.
    Second moments are lognormal at ``adam``'s median root and log sigma;
    first moments zero; the count the resume step."""
    gh, gw, gd = (int(v) for v in shape)
    f32 = torch.float32
    n_cam = len(scene.frames)
    train = torch.as_tensor(np.asarray(scene.train_indices, np.int64),
                            device=device)
    n = train.numel()
    ident = torch.tensor(IDENTITY, dtype=f32, device=device)
    offset = (torch.tensor(rule["offset_mean"], dtype=f32, device=device)
              + torch.tensor(rule["offset_std"], dtype=f32, device=device)
              * _normal(gen, (n, 12), device))
    field = _normal(gen, (n, gh, gw, gd, 12), device)
    for dim, r in enumerate(_neighbour_corr(rule["residual_corr"],
                                            (gh, gw, gd)), start=1):
        field = _correlate(field, dim, r)
    field = field - field.mean((1, 2, 3), keepdim=True)
    field = field * (torch.tensor(rule["residual_rms"], dtype=f32,
                                  device=device)
                     / field.pow(2).mean((0, 1, 2, 3)).sqrt())
    grids = ident.expand(n_cam, gh, gw, gd, 12).clone()
    grids[train] = ident + offset[:, None, None, None, :] + field
    adam = rule["adam"]
    nu = torch.zeros_like(grids)
    nu[train] = (adam["rms"] * torch.exp(_normal(
        gen, (n, gh, gw, gd, 12), device, std=adam["log_sigma"]))) ** 2
    return grids, {"count": step, "mu": torch.zeros_like(grids), "nu": nu}


def camera_sequence(seed: int, resume_step: int, num_train: int, start: int,
                    n: int) -> list:
    """Train positions of steps ``start`` .. ``start + n - 1`` of a run
    resumed at ``resume_step``: the trainer's epochs of permutations
    without replacement, drawn from ``default_rng((seed, resume_step))``."""
    rng = np.random.default_rng((int(seed), int(resume_step)))
    seq: list = []
    while len(seq) < start - resume_step + n:
        seq.extend(rng.permutation(num_train).tolist())
    return seq[start - resume_step:start - resume_step + n]
