#!/usr/bin/env python3
"""Locate what separates a training step's gradients on the kernel path from
the plain path (``use_pallas=False``) after a few optimizer steps.

    python3 tools/torch_step_grad_diff.py [--seed 0] [--runs 6]
                                          [--out FILE.json]

On a scene made from the seed alone the two paths agree to rounding (1e-7 of
each gradient's max). After optimizer steps the state differs from run to
run (``index_add_`` sums with atomics), and some runs read 1e-4 to 1e-3.
This script repeats ``chip_smoke.py``'s training phase on scene A (23 steps)
and on each run's final state

- compares the step's gradients and its rendered frame on the two paths;
- counts the (tile, pixel, slot) pairs on which the two paths take another
  branch of alpha's discontinuities (``chip_smoke.flipped_pairs``) on the
  slabs the step gave its compositor, and holds the forward kernel against
  its plain version on those slabs; where there are such pairs, their
  gaussians are made transparent in a copy of the state and the paths
  compared again;
- counts the pixels where the loss takes another branch of one of its kinks
  on the two frames, by kind (``chip_smoke.loss_branch_kinds``), masks
  those pixels out of the loss on both paths and compares again.

``chip_smoke.py``'s trainer phase runs the same two counts on its trained
state.

One JSON line per run. Needs CUDA and nvcc; imports no JAX.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke  # noqa: E402
from qed_splatter_tpu_torch import cuda as qcuda  # noqa: E402


def without_gaussians(state, ids):
    """``state`` with the gaussians ``ids`` made transparent (opacity logit
    -30: op e^-sigma stays below 1/255 everywhere, on both paths)."""
    opac = state.params.opacities.clone()
    opac[ids] = -30.0
    return dataclasses.replace(state,
                               params=state.params.replace(opacities=opac))


def compare(step, plain, state, batch, seed_bg):
    """Both paths on one state: relative gradient errors, frame error, the
    two paths' outputs, and what the kernel path gave its compositor and its
    gather."""
    from qed_splatter_tpu_torch.ops import rasterize_pallas as rp

    def gen():
        return torch.Generator(device="cuda").manual_seed(seed_bg)

    with chip_smoke.Capture(rp, "composite_tiles_chunked") as cap_c, \
            chip_smoke.Capture(rp, "tile_gather_ranked") as cap_g:
        a = step.grads(state, batch, gen())
    b = plain.grads(state, batch, gen())
    torch.cuda.synchronize()
    pairs = [*((g, a.params[g], b.params[g]) for g in a.params),
             ("camera_opt", a.camera_opt, b.camera_opt),
             ("absgrad", a.absgrad, b.absgrad)]
    rel = {name: float((x - y).abs().max()) / max(float(y.abs().max()), 1e-30)
           for name, x, y in pairs}
    diff = (a.out.rgb - b.out.rgb).detach().abs().amax(-1)
    frame = {"rgb_max_abs": float(diff.max()),
             "pixels_over_1e-5": int((diff > 1e-5).sum()),
             "alpha_max_abs": chip_smoke.max_abs(a.out.accumulation.detach(),
                                                 b.out.accumulation.detach())}
    return rel, frame, a.out, b.out, cap_c, cap_g


def one_run(n_alive, capacity, k_cap, n_steps, seed, run):
    from qed_splatter_tpu_torch.configs import ModelConfig, \
        default_optimizers
    from qed_splatter_tpu_torch.engine.optim import GroupOptimizers
    from qed_splatter_tpu_torch.engine.train_step import init_train_state, \
        make_train_step
    from qed_splatter_tpu_torch.ops import rasterize_pallas as rp

    w, h = chip_smoke.W, chip_smoke.H
    params = chip_smoke.make_scene(n_alive, capacity, seed)
    batch = chip_smoke.train_batch(np.random.default_rng(seed))
    cfg = ModelConfig(camera_opt_mode="SO3xR3", max_per_tile=k_cap,
                      background_color="random")
    cfg_plain = dataclasses.replace(cfg, use_pallas=False)
    optims = GroupOptimizers(default_optimizers())
    state = init_train_state(params, optims, num_cameras=4)
    step = make_train_step(cfg, optims, w, h, has_depth=True)
    plain = make_train_step(cfg_plain, optims, w, h, has_depth=True)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    for _ in range(n_steps):
        state, _ = step(state, batch, gen)

    rel, frame, out_a, out_b, cap_c, cap_g = compare(step, plain, state,
                                                     batch, seed + 17)
    row = {"scene": "A", "run": run, "steps": n_steps,
           "worst_rel": max(rel.values()), "rel": rel, "frame": frame}

    # alpha's discontinuities in the compositor
    means, conics, colors, opac, ntx = cap_c.args[:5]
    counts = cap_c.kwargs["tile_counts"]
    with torch.no_grad():
        where, a_loc, a_glob = chip_smoke.flipped_pairs(means, conics, opac,
                                                        counts, ntx)
        k_chunk = rp.K_CHUNK if k_cap > rp.K_CHUNK else 0
        out, acc, _, _ = rp.composite_tiles_fwd(means, conics, colors, opac,
                                                ntx, 16, counts, k_chunk)
        ro, ra = rp.composite_tiles_ref(means, conics, colors, opac, ntx, 16,
                                        counts, k_chunk)
        row["kernel_vs_tile_local_plain_rgb_alpha"] = max(
            chip_smoke.max_abs(out[:, :3], ro[:, :3]),
            chip_smoke.max_abs(acc, ra))
    order, ranks = cap_g.args[1], cap_g.args[2]
    ids = order[ranks[where[:, 0], where[:, 2]]]
    row["flipped_pairs"] = int(where.shape[0])
    row["flipped"] = [
        {"tile": int(p[0]), "pixel": int(p[1]), "slot": int(p[2]),
         "gaussian": int(i), "a255_tile_local": float(x) * 255.0,
         "a255_global": float(y) * 255.0}
        for p, i, x, y in list(zip(where.tolist(), ids.tolist(),
                                   a_loc.tolist(), a_glob.tolist()))[:16]]
    if where.shape[0]:
        rel2 = compare(step, plain, without_gaussians(state, ids), batch,
                       seed + 17)[0]
        row.update(worst_rel_without_gaussians=max(rel2.values()),
                   rel_without_gaussians=rel2)

    # the loss's kinks
    differ = chip_smoke.loss_branch_pixels(out_a, out_b, batch)
    row["loss_branch_pixels"] = int(differ.sum())
    row["loss_branch_by_kind"] = {
        kind: int(m.sum()) for kind, m in
        chip_smoke.loss_branch_kinds(out_a, out_b, batch).items()}
    d_rgb = [(o.rgb.detach() - batch["rgb"]) for o in (out_a, out_b)]
    d_dep = [(o.depth.detach() - batch["depth"])[..., 0]
             for o in (out_a, out_b)]
    row["loss_branch_at"] = [
        {"y": y, "x": x,
         "rgb_minus_gt_kernel": d_rgb[0][y, x].tolist(),
         "rgb_minus_gt_plain": d_rgb[1][y, x].tolist(),
         "depth_minus_gt_kernel": float(d_dep[0][y, x]),
         "depth_minus_gt_plain": float(d_dep[1][y, x])}
        for y, x in differ.nonzero().tolist()[:8]]
    masked = dict(batch, mask=(~differ)[..., None].to(torch.float32))
    step_m = make_train_step(cfg, optims, w, h, has_depth=True, has_mask=True)
    plain_m = make_train_step(cfg_plain, optims, w, h, has_depth=True,
                              has_mask=True)
    rel3, _, out_a3, out_b3, _, _ = compare(step_m, plain_m, state, masked,
                                            seed + 17)
    left = chip_smoke.loss_branch_pixels(out_a3, out_b3, batch) & ~differ
    row.update(worst_rel_masked=max(rel3.values()), rel_masked=rel3,
               loss_branch_pixels_left=int(left.sum()))
    print(json.dumps(row), flush=True)
    del state, params
    torch.cuda.empty_cache()
    return row


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--runs", type=int, default=6)
    ap.add_argument("--out", default="")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("error: CUDA is not available", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    qcuda.build(qcuda.sources())
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()
    print(f"card: {smi}", flush=True)
    rows = [one_run(80_000, 131_072, 256, chip_smoke.TRAIN_STEPS_WARM
                    + chip_smoke.TRAIN_STEPS_TIMED, args.seed, run)
            for run in range(args.runs)]
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps({"card": smi, "rows": rows},
                                             indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
