"""Command line of the port (port of ``cli.py``).

    python -m qed_splatter_tpu_torch.cli train --data DIR [--device cpu]
        [--max-num-iterations N] [--model.max-per-tile 256 ...]
        [--supervise [--max-restarts 5]]
    python -m qed_splatter_tpu_torch.cli train-multi --data A --data B ...
    python -m qed_splatter_tpu_torch.cli init-pc --data DIR [--stride 4]
        [--colorize] [--output-name NAME] [--no-update-transforms] ...
    python -m qed_splatter_tpu_torch.cli eval --data DIR --load-dir CKPTS
    python -m qed_splatter_tpu_torch.cli render --load-dir CKPTS
        [--mode orbit|eval|path] [--data DIR] [--camera-path PATH.json]
        [--depth] [--crop-center X Y Z --crop-size SX SY SZ]
    python -m qed_splatter_tpu_torch.cli export --load-dir CKPTS
        [--output splat.ply|splat.splat] [--pointcloud] [--crop-* ...]
    python -m qed_splatter_tpu_torch.cli eval-pc --pred recon.ply --gt scan.ply
    python -m qed_splatter_tpu_torch.cli view --load-dir CKPTS [--port 7007]
        [--crop-* ...]

Every field of the config dataclasses is a flag, as in the JAX package's
``qed``: nested fields take dotted prefixes (``--model.sh-degree``),
booleans ``--x`` / ``--no-x``, Literal types become choices.
``--device`` (default ``cuda``) picks where a command runs; on the GPU
``train`` holds the device lock (``utils/chiplock.py``) for its life.
``train --num-data-shards D --num-model-shards M`` (D x M > 1) starts D x M
ranks on the host (``parallel/launch.py``; under ``torchrun`` it joins
torchrun's job instead); the launching process takes the lock once for
all of them. With one card the ranks share it over gloo.
``--supervise`` runs the training in a child process and restarts it from
the run's latest checkpoint when it dies (only the child takes the lock;
under a mesh the child is the launcher, and any rank that dies ends it).
``eval-pc`` runs on the host core (``native.py``). ``view`` serves the live
viewer (``viewer.py``) over a checkpoint until Ctrl-C.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import subprocess
import sys
import threading
import time
import typing
from pathlib import Path
from typing import Optional

from qed_splatter_tpu_torch.configs import TrainerConfig


def _unwrap_optional(tp):
    origin = typing.get_origin(tp)
    if origin is typing.Union:
        args = [a for a in typing.get_args(tp) if a is not type(None)]
        if len(args) == 1:
            return args[0], True
    return tp, False


def add_dataclass_args(parser: argparse.ArgumentParser, cls, prefix: str = ""):
    hints = typing.get_type_hints(cls)
    for f in dataclasses.fields(cls):
        tp = hints.get(f.name, f.type)
        name = f.name.replace("_", "-")
        flag = f"--{prefix}{name}"
        dest = f"{prefix}{name}".replace(".", "__").replace("-", "_")
        tp, _ = _unwrap_optional(tp)
        if dataclasses.is_dataclass(tp):
            add_dataclass_args(parser, tp, prefix=f"{prefix}{name}.")
            continue
        origin = typing.get_origin(tp)
        if tp is bool:
            group = parser.add_mutually_exclusive_group()
            group.add_argument(flag, dest=dest, action="store_true",
                               default=None)
            group.add_argument(f"--no-{prefix}{name}", dest=dest,
                               action="store_false", default=None)
        elif origin is typing.Literal:
            parser.add_argument(flag, dest=dest, type=str, default=None,
                                choices=list(typing.get_args(tp)))
        elif origin in (tuple, list):
            inner = typing.get_args(tp)[0] if typing.get_args(tp) else str
            parser.add_argument(flag, dest=dest, type=inner, nargs="+",
                                default=None)
        elif tp in (int, float, str):
            parser.add_argument(flag, dest=dest, type=tp, default=None)
        elif tp is dict:
            continue  # optimizer table: not exposed as flat flags
        else:
            parser.add_argument(flag, dest=dest, type=str, default=None)


def apply_overrides(cls_instance, args_ns, prefix: str = ""):
    """Rebuild a (frozen) dataclass with CLI overrides applied."""
    updates = {}
    hints = typing.get_type_hints(type(cls_instance))
    for f in dataclasses.fields(cls_instance):
        tp = hints.get(f.name, f.type)
        tp, _ = _unwrap_optional(tp)
        name = f.name.replace("_", "-")
        dest = f"{prefix}{name}".replace(".", "__").replace("-", "_")
        cur = getattr(cls_instance, f.name)
        if dataclasses.is_dataclass(tp) and not isinstance(cur, dict):
            updates[f.name] = apply_overrides(cur, args_ns, f"{prefix}{name}.")
            continue
        if hasattr(args_ns, dest):
            val = getattr(args_ns, dest)
            if val is not None:
                if typing.get_origin(tp) is tuple:
                    val = tuple(val)
                updates[f.name] = val
    return dataclasses.replace(cls_instance, **updates)


def build_trainer_config(argv):
    """(TrainerConfig, device) from ``train``'s flags."""
    parser = argparse.ArgumentParser(
        prog="python -m qed_splatter_tpu_torch.cli train",
        description="Train qed-splatter with the PyTorch port")
    add_dataclass_args(parser, TrainerConfig)
    # alias matching `ns-train qed-splatter --data PATH`
    parser.add_argument("--data", dest="data__data_alias", type=str,
                        default=None)
    parser.add_argument("--device", default="cuda",
                        help="torch device to train on (cuda or cpu)")
    ns = parser.parse_args(argv)
    cfg = apply_overrides(TrainerConfig(), ns)
    if ns.data__data_alias:
        cfg = dataclasses.replace(
            cfg, data=dataclasses.replace(cfg.data, data=ns.data__data_alias))
    return cfg, ns.device


def cmd_train(argv) -> int:
    from qed_splatter_tpu_torch.engine.trainer import Trainer
    from qed_splatter_tpu_torch.utils.chiplock import acquire_chip_lock

    cfg, device = build_trainer_config(argv)
    if not cfg.data.data:
        print("error: --data PATH is required", file=sys.stderr)
        return 2
    if cfg.supervise:
        return _supervise_train(argv, cfg)
    ranks = cfg.num_data_shards * cfg.num_model_shards
    if ranks > 1 and "WORLD_SIZE" not in os.environ:
        # the launcher holds the lock for all its ranks (one flock: a
        # rank's own would find the launcher's and fail)
        acquire_chip_lock("qed train", device=device)
        return _launch_ranks(argv, ranks, device)
    # one client on the GPU at a time (a CPU run takes no lock; in a
    # torchrun job, local rank 0 takes it for the host)
    if os.environ.get("LOCAL_RANK", "0") == "0":
        acquire_chip_lock("qed train", device=device)
    Trainer(cfg, device=device).train()
    return 0


def _launch_ranks(argv, ranks: int, device: str) -> int:
    """``ranks`` spawned processes on this host, each one rank of the
    mesh running :func:`train_rank`; the kernels are built once, here,
    before they start. A rank that fails ends the job with its traceback
    (``parallel/launch.py``)."""
    from qed_splatter_tpu_torch.parallel.launch import free_port, run_rank, \
        spawn

    if device.startswith("cuda"):
        from qed_splatter_tpu_torch import cuda as qcuda

        qcuda.build(qcuda.sources())
    spawn(run_rank, ranks, (train_rank, ranks, free_port(), (argv,)))
    return 0


def train_rank(argv) -> None:
    """One rank of a ``train`` job the launcher started: the trainer on
    its rank's share of the host's CPU threads; takes no lock."""
    import torch
    import torch.distributed as dist

    from qed_splatter_tpu_torch.engine.trainer import Trainer

    cfg, device = build_trainer_config(argv)
    world = int(os.environ["WORLD_SIZE"])
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    try:
        Trainer(cfg, device=device).train()
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def _supervise_train(argv, cfg) -> int:
    """Crash-supervised training: ``train`` in a child process, restarted
    from the run's latest checkpoint when it dies (a lost CUDA context
    kills the process). The child's attempt journal names the
    configuration in flight, so the restart refuses exactly that one.
    Restarts are bounded by ``max_restarts``; two crashes with no
    checkpoint progress between them stop the loop."""
    from qed_splatter_tpu_torch.engine import checkpoint as ckpt

    ckpts = (Path(cfg.output_dir) / (cfg.experiment_name or "qed-splatter")
             / "ckpts")
    # the child imports this package wherever it is started
    env = dict(os.environ)
    root = str(Path(__file__).resolve().parents[1])
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (root, env.get("PYTHONPATH")) if p)
    base = [a for a in argv if a not in ("--supervise", "--no-supervise")]
    restarts, last_ckpt = 0, None
    while True:
        child = [sys.executable, "-m", "qed_splatter_tpu_torch.cli", "train",
                 *base, "--no-supervise"]
        if ckpts.exists() and ckpt.latest_checkpoint(ckpts) is not None:
            # last: argparse keeps the final occurrence
            child += ["--load-dir", str(ckpts)]
        rc = subprocess.call(child, env=env)
        if rc == 0:
            if restarts:
                print(f"SUPERVISOR: run completed after {restarts} "
                      f"restart(s)")
            return 0
        cur = ckpt.latest_checkpoint(ckpts) if ckpts.exists() else None
        progress, last_ckpt = cur != last_ckpt, cur
        restarts += 1
        if restarts > cfg.max_restarts:
            print(f"SUPERVISOR: giving up after {cfg.max_restarts} restarts "
                  f"(last rc={rc})", file=sys.stderr)
            return rc
        if not progress and restarts > 1:
            print("SUPERVISOR: two crashes with no checkpoint progress, not "
                  f"a transient failure; stopping (rc={rc})",
                  file=sys.stderr)
            return rc
        print(f"SUPERVISOR: training process exited rc={rc}; restart "
              f"{restarts}/{cfg.max_restarts}"
              + (f" resuming from {cur}" if cur else ""), flush=True)


def cmd_train_multi(argv) -> int:
    """N scenes in one process, round robin (``engine/multi_scene.py``):

        train-multi --data sceneA --data sceneB [train's flags]
    """
    from qed_splatter_tpu_torch.engine.multi_scene import MultiSceneTrainer
    from qed_splatter_tpu_torch.utils.chiplock import acquire_chip_lock

    scenes, rest = [], []
    it = iter(argv)
    for a in it:
        if a == "--data":
            scenes.append(next(it, None))
        elif a.startswith("--data="):
            scenes.append(a.split("=", 1)[1])
        else:
            rest.append(a)
    if not scenes or any(s is None for s in scenes):
        print("error: at least one --data PATH is required", file=sys.stderr)
        return 2
    cfg, device = build_trainer_config(rest)
    acquire_chip_lock("qed train-multi", device=device)
    MultiSceneTrainer(cfg, scenes, device=device).train()
    return 0


def cmd_eval(argv) -> int:
    """``Trainer.eval_all`` of a checkpoint, printed. The model config is
    the checkpoint's unless ``--model.*`` flags are given."""
    from qed_splatter_tpu_torch.engine import checkpoint as ckpt
    from qed_splatter_tpu_torch.engine.trainer import Trainer

    cfg, device = build_trainer_config(argv)
    if not cfg.data.data or not cfg.load_dir:
        print("error: --data and --load-dir are required", file=sys.stderr)
        return 2
    if not any(a.startswith("--model.") for a in argv):
        meta = ckpt.checkpoint_meta(cfg.load_dir)
        if meta:
            cfg = dataclasses.replace(
                cfg, model=ckpt.model_config_from_meta(meta))
    trainer = Trainer(cfg, device=device)
    for k, v in trainer.eval_all(int(trainer.state.step)).items():
        print(f"{k}: {v}")
    return 0


def cmd_init_pc(argv) -> int:
    from qed_splatter_tpu_torch.data.init_pc import InitPcArgs
    from qed_splatter_tpu_torch.data.init_pc import main as init_main

    parser = argparse.ArgumentParser(
        prog="python -m qed_splatter_tpu_torch.cli init-pc",
        description="Create / colorize an init point cloud from RGB-D")
    add_dataclass_args(parser, InitPcArgs)
    parser.add_argument("--device", default="cuda",
                        help="torch device for backprojection and colorize")
    ns = parser.parse_args(argv)
    args = apply_overrides(InitPcArgs(), ns)
    if not args.data:
        print("error: --data PATH is required", file=sys.stderr)
        return 2
    init_main(args, device=ns.device)
    return 0


def add_crop_args(parser) -> None:
    """Crop-box flags: an oriented box in scene space (the model's
    coordinate frame); gaussians outside it are left out."""
    parser.add_argument("--crop-center", type=float, nargs=3, default=None,
                        metavar=("X", "Y", "Z"))
    parser.add_argument("--crop-size", type=float, nargs=3, default=None,
                        metavar=("SX", "SY", "SZ"))
    parser.add_argument("--crop-rotation", type=float, nargs=9, default=None,
                        help="row-major 3x3 box rotation (default identity)")


def crop_from_args(ns):
    """The CropBox of the --crop-* flags; None when no crop is asked for."""
    if ns.crop_center is None and ns.crop_size is None:
        return None
    from qed_splatter_tpu_torch.models.crop import CropBox

    return CropBox(
        center=tuple(ns.crop_center or (0.0, 0.0, 0.0)),
        size=tuple(ns.crop_size or (2.0, 2.0, 2.0)),
        rotation=tuple(ns.crop_rotation) if ns.crop_rotation else None)


def _load_state(ns):
    """The checkpoint state of ``--load-dir`` on ``--device``, or None after
    printing the error."""
    from qed_splatter_tpu_torch.engine import checkpoint as ckpt

    try:
        return ckpt.load_state(ns.load_dir, device=ns.device)
    except FileNotFoundError as e:
        print(f"error: {e}", file=sys.stderr)
        return None


def cmd_export(argv) -> int:
    from qed_splatter_tpu_torch.engine import checkpoint as ckpt

    parser = argparse.ArgumentParser(
        prog="python -m qed_splatter_tpu_torch.cli export")
    parser.add_argument("--load-dir", required=True)
    parser.add_argument("--output", default="splat.ply")
    parser.add_argument("--pointcloud", action="store_true",
                        help="write plain xyz/rgb instead of the 3DGS layout")
    parser.add_argument("--format", choices=["ply", "splat"], default=None,
                        help="output format (default: from --output's "
                             "suffix; .splat = the packed 32-byte web-viewer "
                             "layout)")
    parser.add_argument("--device", default="cuda",
                        help="torch device to load the checkpoint on")
    add_crop_args(parser)
    ns = parser.parse_args(argv)
    state = _load_state(ns)
    if state is None:
        return 2
    meta = ckpt.checkpoint_meta(ns.load_dir)
    params = state.params
    crop = crop_from_args(ns)
    if crop is not None:
        params = params.replace(alive=params.alive & crop.within(params.means))
    fmt = ns.format or ("splat" if ns.output.endswith(".splat") else "ply")
    if ns.pointcloud:
        n = ckpt.export_pointcloud_ply(ns.output, params, meta)
    elif fmt == "splat":
        n = ckpt.export_splat(ns.output, params, meta)
    else:
        n = ckpt.export_ply(ns.output, params, meta)
    print(f"Wrote {n} gaussians to {ns.output}")
    return 0


def render_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="python -m qed_splatter_tpu_torch.cli render")
    parser.add_argument("--load-dir", required=True)
    parser.add_argument("--output-dir", default="renders")
    parser.add_argument("--mode", choices=["orbit", "eval", "path"],
                        default=None,
                        help="default: 'path' when --camera-path is given, "
                             "else 'orbit'")
    parser.add_argument("--data", default=None,
                        help="dataset (required for --mode eval)")
    parser.add_argument("--camera-path", default=None,
                        help="nerfstudio camera-path JSON "
                             "(required for --mode path)")
    parser.add_argument("--num-frames", type=int, default=60)
    parser.add_argument("--width", type=int, default=960)
    parser.add_argument("--height", type=int, default=540)
    parser.add_argument("--radius", type=float, default=3.0)
    parser.add_argument("--elevation", type=float, default=0.2)
    parser.add_argument("--depth", action="store_true",
                        help="also write normalized depth images")
    parser.add_argument("--device", default="cuda",
                        help="torch device to render on")
    add_crop_args(parser)
    return parser


def render_cameras(ns, params) -> list:
    """The (c2w, K, width, height) of each frame ``render`` writes, for
    parsed render flags (``ns.mode`` set) and the checkpoint's params."""
    import numpy as np

    from qed_splatter_tpu_torch.testing import orbit_c2w_opengl

    if ns.mode == "eval":
        from qed_splatter_tpu_torch.configs import DataConfig
        from qed_splatter_tpu_torch.data.transforms_json import \
            parse_transforms

        scene = parse_transforms(DataConfig(data=ns.data))
        return [(c.c2w, c.intrinsics_matrix(), c.width, c.height)
                for c in (scene.frames[int(i)].camera
                          for i in scene.eval_indices)]
    if ns.mode == "path":
        from qed_splatter_tpu_torch.data.camera_path import load_camera_path

        return load_camera_path(ns.camera_path, default_width=ns.width,
                                default_height=ns.height)
    # an orbit around the centre of the alive gaussians
    means = params.means.cpu().numpy()[params.alive.cpu().numpy()]
    target = tuple(means.mean(0)) if len(means) else (0.0, 0.0, 0.0)
    f = 0.8 * max(ns.width, ns.height)
    K = np.array([[f, 0, ns.width / 2], [0, f, ns.height / 2], [0, 0, 1]],
                 np.float32)
    return [(orbit_c2w_opengl(ns.radius, 2 * np.pi * i / ns.num_frames,
                              ns.elevation, target), K, ns.width, ns.height)
            for i in range(ns.num_frames)]


def to_uint8(rgb):
    """A rendered [H, W, 3] image in [0, 1] as the uint8 the PNG holds."""
    import numpy as np

    return np.clip(rgb.cpu().numpy() * 255, 0, 255).astype(np.uint8)


def cmd_render(argv) -> int:
    """Render a camera trajectory of a checkpoint to PNG frames: an orbit,
    the dataset's eval cameras, or a nerfstudio camera path."""
    import numpy as np

    from qed_splatter_tpu_torch.data.png import write_png
    from qed_splatter_tpu_torch.engine import checkpoint as ckpt
    from qed_splatter_tpu_torch.models.splatfacto import render

    ns = render_parser().parse_args(argv)
    if ns.mode is None:
        # --camera-path implies path mode: an orbit in place of the user's
        # authored path would be a trap
        ns.mode = "path" if ns.camera_path else "orbit"
    if ns.mode == "eval" and not ns.data:
        print("error: --data required for --mode eval", file=sys.stderr)
        return 2
    if ns.mode == "path" and not ns.camera_path:
        print("error: --camera-path required for --mode path",
              file=sys.stderr)
        return 2
    state = _load_state(ns)
    if state is None:
        return 2
    cfg = ckpt.model_config_from_meta(ckpt.checkpoint_meta(ns.load_dir))
    out_dir = Path(ns.output_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    cams = render_cameras(ns, state.params)
    crop = crop_from_args(ns)
    for i, (c2w, K, w, h) in enumerate(cams):
        out = render(state.params, c2w, K, w, h, cfg, step=state.step,
                     train=False, crop_box=crop, device=ns.device)
        write_png(out_dir / f"frame_{i:05d}.png", to_uint8(out.rgb))
        if ns.depth:
            d = out.depth[..., 0].cpu().numpy()
            dn = (d - d.min()) / max(d.max() - d.min(), 1e-9)
            write_png(out_dir / f"depth_{i:05d}.png",
                      (dn * 255).astype(np.uint8))
        print(f"  frame {i + 1}/{len(cams)}", end="\r", flush=True)
    print(f"\nWrote {len(cams)} frames to {out_dir}")
    return 0


def cmd_eval_pc(argv) -> int:
    """Point-cloud accuracy and completeness against a reference scan, on
    the host geometry core."""
    from qed_splatter_tpu_torch.data.ply import read_ply
    from qed_splatter_tpu_torch.metrics import (
        calculate_accuracy,
        calculate_completeness,
    )

    parser = argparse.ArgumentParser(
        prog="python -m qed_splatter_tpu_torch.cli eval-pc")
    parser.add_argument("--pred", required=True, help="reconstructed PLY")
    parser.add_argument("--gt", required=True, help="reference-scan PLY")
    parser.add_argument("--completeness-threshold", type=float, default=0.05)
    parser.add_argument("--accuracy-percentile", type=float, default=90.0)
    ns = parser.parse_args(argv)
    pred = read_ply(ns.pred).positions
    gt = read_ply(ns.gt).positions
    acc = calculate_accuracy(pred, gt, percentile=ns.accuracy_percentile)
    cmp_ = calculate_completeness(pred, gt,
                                  threshold=ns.completeness_threshold)
    print(f"accuracy_p{ns.accuracy_percentile:.0f}: {acc:.6f}")
    print(f"completeness_{ns.completeness_threshold}: {cmp_:.2f}%")
    return 0


def cmd_view(argv, stop: Optional[threading.Event] = None,
             on_start=None) -> int:
    """Standalone viewer over a checkpoint, until Ctrl-C (or ``stop`` is
    set, for callers that embed it; ``on_start(viewer)`` is called once it
    serves)."""
    from qed_splatter_tpu_torch.engine import checkpoint as ckpt
    from qed_splatter_tpu_torch.viewer import Viewer

    parser = argparse.ArgumentParser(
        prog="python -m qed_splatter_tpu_torch.cli view")
    parser.add_argument("--load-dir", required=True)
    parser.add_argument("--port", type=int, default=7007)
    parser.add_argument("--device", default="cuda",
                        help="torch device to load and render on")
    add_crop_args(parser)
    ns = parser.parse_args(argv)
    state = _load_state(ns)
    if state is None:
        return 2
    cfg = ckpt.model_config_from_meta(ckpt.checkpoint_meta(ns.load_dir))
    # centre the orbit on the alive gaussians
    p = state.params
    means = p.means[p.alive].cpu().numpy()
    target = tuple(means.mean(0)) if len(means) else (0.0, 0.0, 0.0)
    viewer = Viewer(cfg, port=ns.port, target=target,
                    crop=crop_from_args(ns), device=ns.device)
    viewer.update(state.params, int(state.step))
    viewer.start()
    if on_start is not None:
        on_start(viewer)
    print("Press Ctrl-C to stop.")
    try:
        while stop is None or not stop.is_set():
            time.sleep(0.2)
    except KeyboardInterrupt:
        pass
    viewer.stop()
    return 0


COMMANDS = {"train": cmd_train, "train-multi": cmd_train_multi,
            "eval": cmd_eval, "init-pc": cmd_init_pc, "export": cmd_export,
            "render": cmd_render, "eval-pc": cmd_eval_pc, "view": cmd_view}


def main(argv: Optional[list] = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] in ("-h", "--help"):
        print("usage: python -m qed_splatter_tpu_torch.cli "
              f"{{{','.join(COMMANDS)}}} [flags]")
        return 0 if argv else 2
    cmd = argv[0]
    if cmd not in COMMANDS:
        print(f"unknown command: {cmd}; choose from {list(COMMANDS)}",
              file=sys.stderr)
        return 2
    return COMMANDS[cmd](argv[1:])


if __name__ == "__main__":
    raise SystemExit(main())
