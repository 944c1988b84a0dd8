"""The check that decides ``correct``: the reference follows the program's
first three steps (a chunk of one step, then a chunk of two) and the
refine that ends them, from the same state.

The reference (:mod:`splatbench.reference`) makes the state again from the
seed, reads the dataset's files itself, draws the backgrounds and the
refine's split offsets from the same seeds as the trainer, takes the train
cameras in the trainer's order, and runs the three steps and the refine in
plain PyTorch. The numbers compared, each against its limit in
``splatbench/limits/<cell>.json``:

- ``loss_rel``: the largest relative gap of the three steps' losses (the
  second and third from one chunk's per-step metrics, so a chunk that
  trains each step on its first camera or background fails it);
- ``grad_gap``: the first step's gradient, as Adam got it (the program's
  from its first moment, which starts at zero), by the worst leaf: the gap
  of the two norms over the reference's norm of that leaf or of the median
  leaf, whichever is larger;
- ``change_gap``: the parameters' change over the three steps, the same
  way, over the rows that the refine keeps on both sides (leaves whose
  reference gradient is under a thousandth of the median leaf's move by
  round-off alone and are left out);
- with the model's bilateral grid on, the per-camera colour grids are one
  more leaf of ``grad_gap`` and ``change_gap``;
- ``refine_mismatch``: the share of rows whose alive flag after the refine
  differs (a cull skipped or at another threshold fails it);
- with absgrad on (a densifying cell): ``stats_gap``, the worst relative
  gap of the statistics' change over the three steps as the refine reads
  them (the absgrad sum and the visibility count), and ``new_rows_gap``,
  the worst leaf's gap of the norms of the rows the refine seeded.

The control (:func:`control_readings`) puts the reference itself in the
program's place, with TF32 turned on: the nearest precision below the
configuration's float32 with TF32 off. The faults (:data:`FAULTS`) put it
there with the refine's cull broken.
"""

from __future__ import annotations

import math
import statistics
from typing import Dict, Optional

import torch

from splatbench import scene
from splatbench.reference import data as rdata
from splatbench.reference import step as rstep

GROUPS = scene.GROUPS
LEAVES = GROUPS + ("camera_opt",)


@torch.no_grad()
def row_sq(x: torch.Tensor) -> torch.Tensor:
    """[C] float64 squared norm of each row, on the CPU."""
    return (x.double() ** 2).reshape(x.shape[0], -1).sum(1).cpu()


# the refine's cull, broken: skipped, or at twice its alpha threshold
FAULTS = ("cull_skipped", "cull_alpha_x2")


def _fault_model(model: dict, fault: str) -> dict:
    if fault == "cull_skipped":
        return dict(model, cull_alpha_thresh=0.0, cull_scale_thresh=math.inf)
    if fault == "cull_alpha_x2":
        return dict(model, cull_alpha_thresh=2 * model["cull_alpha_thresh"])
    raise ValueError(f"no fault {fault!r}")


def reference_readings(cell, scn: rdata.Scene, seed: int, ks, tpgs,
                       device, tf32: bool = False,
                       fault: Optional[str] = None) -> dict:
    """The reference's readings of the first three steps and the refine,
    each step at the K and pair budget the program's ran at (``ks``,
    ``tpgs``), in the form of the program's
    (:func:`splatbench.harness.first_steps`) plus the rows the refine
    seeded (``take``)."""
    cfg, traffic, model = cell.config, cell.traffic, cell.config["model"]
    refine_model = _fault_model(model, fault) if fault else model
    S = scene.synthesize(scn, cfg, traffic, cell.state, seed, device)
    p0 = {g: S["params"][g].clone() for g in GROUPS}
    cam0 = S["camera_opt"].clone()
    grids0 = (S["bilateral_grids"].clone() if "bilateral_grids" in S
              else None)
    stats0 = {key: v.clone() for key, v in S["stats"].items()}
    resume = S["step"]
    positions = scene.camera_sequence(seed, resume, len(scn.train_indices),
                                      resume, 3)
    first = scn.frames[int(scn.train_indices[positions[0]])]
    bands = (rstep.band(first.width, device), rstep.band(first.height,
                                                         device))
    out = {"loss": [], "grad_norm": {}}
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        for i, pos in enumerate(positions):
            idx = int(scn.train_indices[pos])
            fr = scn.frames[idx]
            frame = {
                "rgb": torch.as_tensor(rdata.read_rgb(fr), device=device),
                "depth": torch.as_tensor(
                    rdata.read_depth(fr, scn.depth_scale), device=device),
                "c2w": torch.as_tensor(fr.c2w, device=device),
                "K": torch.as_tensor(fr.K, device=device),
                "cam_idx": idx, "width": fr.width, "height": fr.height}
            gen = torch.Generator(device=device).manual_seed(
                (int(seed) * 1_000_003 + S["step"]) * 2)
            bg = torch.rand(3, generator=gen, device=device)
            loss, grads = rstep.train_step(
                S, frame, bg, model, cfg["optimizers"], ks[i], tpgs[i],
                traffic["absgrad"], bands)
            out["loss"].append(float(loss))
            if i == 0:
                out["grad_norm"] = {g: float(x.double().norm())
                                    for g, x in grads.items()}
            if i == 2 and traffic["absgrad"]:
                out["stats_grad"] = float(
                    (S["stats"]["grad_norm_sum"].double()
                     - stats0["grad_norm_sum"].double()).norm())
                out["stats_vis"] = float(
                    (S["stats"]["vis_count"] - stats0["vis_count"]).sum())
            del grads, frame
        gen = torch.Generator(device=device).manual_seed(
            (int(seed) * 1_000_003 + S["step"]) * 2 + 1)
        _, take, _, _ = rstep.refine_(
            S, refine_model, len(scn.train_indices),
            max(first.width, first.height), gen)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev[0]
        torch.backends.cudnn.allow_tf32 = prev[1]
    p = S["params"]
    out["alive"] = p["alive"].cpu()
    out["take"] = take.cpu()
    out["change_sq"] = {g: row_sq(p[g] - p0[g]) for g in GROUPS}
    out["row_sq"] = {g: row_sq(p[g]) for g in GROUPS}
    out["camera_opt"] = S["camera_opt"].double().cpu()
    out["camera_opt0"] = cam0.double().cpu()
    if grids0 is not None:
        out["bilateral_grids"] = S["bilateral_grids"].double().cpu()
        out["bilateral_grids0"] = grids0.double().cpu()
    return out


def _gap(a: float, b: float, scale: float) -> float:
    return abs(a - b) / scale if scale > 0 else (0.0 if a == b else math.inf)


def compare(ref: dict, prog: dict, alive0: torch.Tensor,
            absgrad: bool) -> Dict[str, float]:
    """The numbers compared (see the module docstring), ``prog`` against
    ``ref``."""
    out = {"loss_rel": max(_gap(lp, lr, abs(lr)) for lp, lr in
                           zip(prog["loss"], ref["loss"]))}
    gr = ref["grad_norm"]
    leaves = LEAVES + (("bilateral_grid",) if "bilateral_grids0" in ref
                       else ())
    med = statistics.median(gr.values())
    # a leaf the program does not report (its grids missing) fails
    out["grad_gap"] = max(_gap(prog["grad_norm"].get(g, math.inf), gr[g],
                               max(gr[g], med)) for g in leaves)
    kept = alive0 & ref["alive"] & prog["alive"] & ~ref["take"]
    moved = [g for g in leaves if gr[g] >= 1e-3 * med]
    dr, dp = {}, {}
    for g in GROUPS:
        dr[g] = math.sqrt(float(ref["change_sq"][g][kept].sum()))
        dp[g] = math.sqrt(float(prog["change_sq"][g][kept].sum()))
    dr["camera_opt"] = float((ref["camera_opt"]
                              - ref["camera_opt0"]).norm())
    dp["camera_opt"] = float((prog["camera_opt"]
                              - ref["camera_opt0"]).norm())
    if "bilateral_grid" in leaves:
        dr["bilateral_grid"] = float((ref["bilateral_grids"]
                                      - ref["bilateral_grids0"]).norm())
        dp["bilateral_grid"] = (
            float((prog["bilateral_grids"] - ref["bilateral_grids0"]).norm())
            if "bilateral_grids" in prog else math.inf)
    med_d = statistics.median(dr[g] for g in moved)
    out["change_gap"] = max(_gap(dp[g], dr[g], max(dr[g], med_d))
                            for g in moved)
    out["refine_mismatch"] = float(
        (ref["alive"] ^ prog["alive"]).sum()) / max(
            float(ref["alive"].sum()), 1.0)
    if absgrad:
        out["stats_gap"] = max(
            _gap(prog["stats_grad"], ref["stats_grad"], ref["stats_grad"]),
            _gap(prog["stats_vis"], ref["stats_vis"], ref["stats_vis"]))
        take = ref["take"]
        nr = {g: math.sqrt(float(ref["row_sq"][g][take].sum()))
              for g in GROUPS}
        npg = {g: math.sqrt(float(prog["row_sq"][g][take].sum()))
               for g in GROUPS}
        med_n = statistics.median(nr.values())
        out["new_rows_gap"] = max(_gap(npg[g], nr[g], max(nr[g], med_n))
                                  for g in GROUPS)
    return out


def judge(numbers: Dict[str, float], limits: Dict[str, float]) -> tuple:
    """(correct, {name: {"value", "limit"}}): every number that has a
    limit within it; a number that is not finite, or missing, fails."""
    checks = {n: {"value": numbers.get(n, math.nan), "limit": lim}
              for n, lim in limits.items()}
    ok = all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
             for c in checks.values())
    return ok, checks


def check_cell(cell, scn, seed, prog: dict, device) -> dict:
    """The reference's readings beside the program's, compared."""
    ref = reference_readings(cell, scn, seed, prog["k"], prog["tpg"], device)
    alive0 = _alive0(cell)
    numbers = compare(ref, prog, alive0, cell.traffic["absgrad"])
    correct, checks = judge(numbers, cell.limits)
    return {"correct": correct, "checks": checks, "numbers": numbers}


def _alive0(cell) -> torch.Tensor:
    cap = int(cell.traffic["capacity"])
    alive = torch.zeros((cap,), dtype=torch.bool)
    alive[:int(cell.config["state"]["alive"])] = True
    return alive


def control_readings(cell, scn, seed, ks, tpgs, device) -> Dict[str, dict]:
    """The numbers of the control (the reference computed with TF32) and of
    each fault of :data:`FAULTS`, each in the program's place, against the
    float32 reference."""
    ref = reference_readings(cell, scn, seed, ks, tpgs, device)
    alive0, absgrad = _alive0(cell), cell.traffic["absgrad"]
    out = {"tf32": compare(ref, reference_readings(
        cell, scn, seed, ks, tpgs, device, tf32=True), alive0, absgrad)}
    for fault in FAULTS:
        out[fault] = compare(ref, reference_readings(
            cell, scn, seed, ks, tpgs, device, fault=fault), alive0, absgrad)
    return out
