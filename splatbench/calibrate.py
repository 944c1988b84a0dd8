"""The state rule of each cell, read from a state the program trained.

    python3 -m splatbench.calibrate --config <config> --cells <cell>,...
        [--seed N] [--budget-s S] [--out FILE] [--sample-dir DIR]

on the card. It trains the program from the dataset's own points, as
``cli train`` does, with the configuration as the cells run it (the
capacity capped at the cells' own), and stops at each cell's resume step
(rounded down to a chunk). There it reads the trained state: the joint
rows of opacity logit, mean log size against the spacing its alive count
has on the scene's surfaces, and the largest and smallest axis against
the mean (with the densify statistics in a densifying cell), the SH bands'
RMS, Adam's second moments, the camera deltas, the K and pair budget the
trainer holds, and the pairs a step needs per pixel; with the bilateral
grid on, the train cameras' colour grids (:func:`grid_statistics`) and
their Adam second moments. Then it makes the
cell's state from those rows (:func:`splatbench.scene.synthesize`), lets
the program's own trainer settle K and the pair budget on it, and reads
the same numbers there. Each cell's rule is written whole under
``states`` in ``--out``: copy it to ``splatbench/states/<cell>.json``.
The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import json
import math
import sys
import tempfile
import time
from pathlib import Path

ROWS = 4096
QUANTILES = [0.0, 0.01, 0.05, 0.1, 0.25, 0.5, 0.75, 0.9, 0.95, 0.99, 1.0]


def _q(x):
    import torch

    x = x.double().flatten()
    if x.numel() > 1_000_000:
        x = x[torch.randperm(x.numel(), device=x.device)[:1_000_000]]
    return [float(v) for v in torch.quantile(
        x, torch.tensor(QUANTILES, dtype=torch.float64, device=x.device))]


def _rms(nu) -> dict:
    """Adam's second moment as a lognormal of the root: the median root and
    the sigma of its log, over the elements it has reached."""
    r = nu.double().flatten()
    r = r[r > 0].sqrt().log()
    return {"rms": float(r.median().exp()) if r.numel() else 0.0,
            "log_sigma": float(r.std()) if r.numel() > 1 else 0.0}


def grid_statistics(grids, train) -> dict:
    """The rule :func:`splatbench.scene.bilateral_grids` draws from, read
    from grids ([num_cameras, gh, gw, gd, 12]) at the train cameras
    ``train``: each coefficient's per-camera mean offset from the identity
    (the mean and spread over the cameras), the RMS of each coefficient's
    residual about its camera's mean, the lag-1 correlation of the
    residual along each grid axis (one minus the mean squared difference
    of neighbours over twice the mean square: what sets the total
    variation), and ``tv``, the loss's three terms over every camera."""
    import torch

    from splatbench import scene

    g = grids.double()
    ident = torch.tensor(scene.IDENTITY, dtype=g.dtype, device=g.device)
    dev = g[torch.as_tensor(train, device=g.device)] - ident
    off = dev.mean((1, 2, 3))
    res = dev - off[:, None, None, None, :]
    var = res.pow(2).mean()
    corr = []
    for dim in (1, 2, 3):
        d = torch.diff(res, dim=dim).pow(2).mean()
        corr.append(float(1.0 - d / (2.0 * var)) if var > 0 else 0.0)
    return {
        "offset_mean": [float(v) for v in off.mean(0)],
        "offset_std": [float(v) for v in (off.std(0) if off.shape[0] > 1
                                          else torch.zeros_like(off[0]))],
        "residual_rms": [float(v) for v in res.pow(2).mean((0, 1, 2, 3))
                         .sqrt()],
        "residual_corr": corr,
        "tv": [float(torch.diff(g, dim=dim).pow(2).mean())
               for dim in (1, 2, 3)],
    }


def _needed(params, scn, model, k, tpg, positions):
    from splatbench import yardstick

    per_px = []
    for pos in positions:
        fr = scn.frames[int(scn.train_indices[pos])]
        need = yardstick.needed_pairs(
            params, {"c2w": fr.c2w, "K": fr.K, "width": fr.width,
                     "height": fr.height}, model, k, tpg)
        per_px.append(need["pairs"] / need["pixels"])
    return per_px


def read_state(trainer, scn, cell, area, gen_seed, steps_since_refine):
    """The rule's rows and numbers from the trainer's state."""
    import torch

    from splatbench import scene

    st = trainer.state
    p = st.params
    a = p.alive
    n = int(a.sum())
    logs = p.scales[a].double()
    mean = logs.mean(1)
    cols = {"opacity_logit": p.opacities[a].double(),
            "log_size_offset": mean - 0.5 * math.log(area / n),
            "log_axis_max": logs.max(1).values - mean,
            "log_axis_min": logs.min(1).values - mean}
    model = cell.config["model"]
    if cell.traffic["absgrad"]:
        vis = st.stats.vis_count[a].double()
        g = st.stats.grad_norm_sum[a].double()
        max_hw = max(scn.frames[0].width, scn.frames[0].height)
        ratio = torch.where(
            vis > 0, g / vis.clamp(min=1) * 0.5 * max_hw
            / model["densify_grad_thresh"], torch.ones_like(g))
        cols["vis_share"] = vis / max(steps_since_refine, 1)
        cols["log_grad_ratio"] = torch.log(ratio.clamp(min=1e-12))
    gen = torch.Generator(device=p.means.device).manual_seed(gen_seed)
    take = torch.randperm(n, generator=gen, device=p.means.device)[:ROWS]
    names = list(cols)
    rows = torch.stack([cols[c][take] for c in names], 1).cpu().tolist()
    rest = p.features_rest[a].double()
    band = torch.tensor(scene.sh_band(rest.shape[1]), device=rest.device)
    sh_rms = [float(rest[:, band == b].pow(2).mean().sqrt())
              for b in range(1, int(band.max()) + 1)]
    adam = {g: _rms(st.opt_state[g]["nu"][a]) for g in scene.GROUPS}
    adam["camera_opt"] = _rms(st.camera_opt_state["nu"])
    rule = {
        "columns": names,
        "rows": [[float(f"{v:.5g}") for v in row] for row in rows],
        "sh_rest_rms": sh_rms,
        "adam": adam,
        "camera_delta_rms": float(st.camera_opt.double().pow(2).mean()
                                  .sqrt()),
    }
    if st.bilateral_grids is not None:
        train = list(scn.train_indices)
        rule["bilateral_grid"] = dict(
            grid_statistics(st.bilateral_grids, train),
            adam=_rms(st.bilateral_grid_state["nu"][
                torch.as_tensor(train, device=p.means.device)]))
    summary = {
        "step": int(st.step), "alive": n,
        "capacity": int(p.capacity),
        "k_by_d": dict(trainer._k_by_d), "tpg_by_d": dict(trainer._tpg_by_d),
        "opacity_q": _q(torch.sigmoid(p.opacities[a])),
        "log_size_offset_q": _q(cols["log_size_offset"]),
        "log_axis_max_q": _q(cols["log_axis_max"]),
        "log_axis_min_q": _q(cols["log_axis_min"]),
        "quantile_levels": QUANTILES,
    }
    if cell.traffic["absgrad"]:
        summary["vis_share_q"] = _q(cols["vis_share"])
        summary["log_grad_ratio_q"] = _q(cols["log_grad_ratio"][
            cols["vis_share"] > 0])
    return rule, summary


def _params(state):
    p = state.params
    return {g: getattr(p, g) for g in ("means", "quats", "scales",
                                       "opacities", "alive")}


def _eval_psnr(trainer):
    rows = [json.loads(x) for x in (trainer.run_dir / "metrics.jsonl")
            .read_text().splitlines()]
    ev = [r for r in rows if r.get("split") == "eval" and "rgb_psnr" in r]
    return [r["rgb_psnr"] for r in ev[-5:]]


def settle_made(cell, scn, rule, seed, dev, k0, tpg0, data_dir, log):
    """The made state under the program's trainer: chunks from the resume
    step until K and the pair budget hold for two chunks."""
    import torch

    from splatbench import harness, scene
    from qed_splatter_tpu_torch.data.dataset import FullImageDatamanager

    cell = copy.copy(cell)
    cell.state = rule
    S = scene.synthesize(scn, cell.config, cell.traffic, rule, seed, dev)
    work = Path(tempfile.mkdtemp(prefix="splatbench-cal-"))
    tcfg = harness.trainer_config(cell, data_dir, work, seed)
    dm = FullImageDatamanager(tcfg.data, seed=tcfg.seed)
    trainer = harness.BenchTrainer(tcfg, harness.program_state(S), k0, tpg0,
                                   datamanager=dm, device=dev)
    del S
    seen = [(k0, tpg0)]
    start = trainer.state.step
    trainer.train(max_steps=-(-start // 10) * 10, finalize=False)
    for _ in range(12):
        trainer.train(max_steps=trainer.state.step + 10, finalize=False)
        seen.append((trainer._k_for(1), trainer._tpg_for(1)))
        if len(seen) >= 3 and seen[-1] == seen[-2] == seen[-3]:
            break
    k, tpg = seen[-1]
    log(f"made state: K/pair budget by chunk {seen}")
    positions = list(range(4))
    per_px = _needed(_params(trainer.state), scn, cell.config["model"], k,
                     tpg, positions)
    made = {"step": int(trainer.state.step),
            "alive": int(trainer.state.params.num_alive()),
            "k_tpg_by_chunk": seen, "pairs_per_pixel": per_px,
            "eval_psnr": trainer.eval_image(trainer.state.step)["rgb_psnr"]}
    del trainer
    torch.cuda.empty_cache()
    return k, tpg, made


def main(argv=None) -> int:
    from splatbench.run import _environment

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--config", required=True)
    ap.add_argument("--cells", required=True)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--budget-s", type=float, default=900.0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None)
    ap.add_argument("--sample-dir", default=None)
    args = ap.parse_args(argv)
    _environment()
    import numpy as np
    import torch

    from qed_splatter_tpu_torch import cuda as qcuda
    from qed_splatter_tpu_torch.engine.trainer import Trainer
    from splatbench import harness, scene, spec
    from splatbench.reference import data as rdata

    def log(msg):
        print(f"[calibrate {args.config}] {msg}", file=sys.stderr,
              flush=True)

    dev = torch.device(args.device)
    cells = sorted((spec.load_cell(c, with_state=False)
                    for c in args.cells.split(",")),
                   key=lambda c: c.traffic["resume_step"])
    for c in cells:
        assert c.config["name"] == args.config, c.name
    base = cells[0]
    cfg = copy.deepcopy(base.config)
    cap = max(int(c.traffic["capacity"]) for c in cells)
    cfg["model"]["max_capacity"] = cap
    data_dir = scene.dataset_dir(cfg)
    if dev.type == "cuda":
        qcuda.build(qcuda.sources())
    scn = rdata.load_scene(data_dir, cfg["data"])
    work = Path(tempfile.mkdtemp(prefix="splatbench-cal-"))
    train_cell = copy.copy(base)
    train_cell.config = cfg
    tcfg = harness.trainer_config(train_cell, data_dir, work, args.seed)
    with contextlib.redirect_stdout(sys.stderr):
        trainer = Trainer(tcfg, device=dev)
    t0 = time.perf_counter()
    out = {"config": args.config, "seed": args.seed, "max_capacity": cap,
           "cells": {}}
    for cell in cells:
        stop = int(cell.traffic["resume_step"]) // 10 * 10
        with contextlib.redirect_stdout(sys.stderr):
            while (trainer.state.step < stop
                   and time.perf_counter() - t0 < args.budget_s):
                trainer.train(max_steps=min(stop, trainer.state.step + 100),
                              finalize=False)
        log(f"{cell.name}: step {trainer.state.step} of {stop} after "
            f"{time.perf_counter() - t0:.1f} s, alive "
            f"{int(trainer.state.params.num_alive())}")
        g = torch.Generator(device=dev).manual_seed(args.seed)
        _, _, area = scene.surface_points(
            scn, int(cfg["state"]["alive"]), g, dev)
        refine_every = int(cfg["model"]["refine_every"])
        rule, trained = read_state(
            trainer, scn, cell, area, args.seed,
            trainer.state.step % refine_every or refine_every)
        k_t, tpg_t = trainer._k_for(1), trainer._tpg_for(1)
        trained["pairs_per_pixel"] = _needed(
            _params(trainer.state), scn, cfg["model"], k_t, tpg_t,
            list(range(4)))
        trained["eval_psnr"] = _eval_psnr(trainer)
        trained["area"] = area
        trained["seconds"] = time.perf_counter() - t0
        if args.sample_dir:
            a = trainer.state.params.alive
            keep = torch.randperm(int(a.sum()), device=dev)[:40_000]
            np.savez_compressed(
                Path(args.sample_dir) / f"cal_{cell.name}.npz",
                **{g: getattr(trainer.state.params, g)[a][keep].cpu().numpy()
                   for g in scene.GROUPS})
        with contextlib.redirect_stdout(sys.stderr):
            k, tpg, made = settle_made(cell, scn, rule, args.seed + 1, dev,
                                       k_t, tpg_t, data_dir, log)
        rule["max_per_tile"], rule["small_tiles_per_gaussian"] = k, tpg
        rule["calibration"] = {"trained": trained, "made": made}
        out["cells"][cell.name] = rule
        log(f"{cell.name}: trained {json.dumps(trained)}")
        log(f"{cell.name}: made {json.dumps(made)}")
        if args.out:
            Path(args.out).write_text(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
