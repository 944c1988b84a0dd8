"""Command line of the port: ``train`` and ``train-multi`` (port of
``cli.py``).

    python -m qed_splatter_tpu_torch.cli train --data DIR [--device cpu]
        [--max-num-iterations N] [--model.max-per-tile 256 ...]
        [--supervise [--max-restarts 5]]
    python -m qed_splatter_tpu_torch.cli train-multi --data A --data B ...

Every field of the config dataclasses is a flag, as in the JAX package's
``qed train``: nested fields take dotted prefixes (``--model.sh-degree``),
booleans ``--x`` / ``--no-x``, Literal types become choices.
``--device`` (default ``cuda``) picks where the trainer runs; on the GPU
the command holds the device lock (``utils/chiplock.py``) for its life.
``--supervise`` runs the training in a child process and restarts it from
the run's latest checkpoint when it dies (only the child takes the lock).
The other subcommands of ``qed`` are not ported and raise, naming their
ROADMAP item.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import subprocess
import sys
import typing
from pathlib import Path
from typing import Optional

from qed_splatter_tpu_torch import not_ported
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
    # one client on the GPU at a time (a CPU run takes no lock)
    acquire_chip_lock("qed train", device=device)
    Trainer(cfg, device=device).train()
    return 0


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


# the JAX package's other subcommands, by the ROADMAP item that ports them
NOT_PORTED = {
    "eval": 9, "export": 9, "render": 9, "init-pc": 3, "eval-pc": 5,
    "view": 10,
}
_TITLES = {
    3: "init_pc, backproject, voxel and the native binding",
    5: "the point-cloud metrics and LPIPS",
    9: "the remaining CLI subcommands and writer backends",
    10: "the viewer",
}
COMMANDS = {"train": cmd_train, "train-multi": cmd_train_multi}


def main(argv: Optional[list] = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] in ("-h", "--help"):
        print("usage: python -m qed_splatter_tpu_torch.cli "
              "{train,train-multi} [flags]")
        return 0 if argv else 2
    cmd = argv[0]
    if cmd in NOT_PORTED:
        item = NOT_PORTED[cmd]
        raise not_ported(f"the '{cmd}' subcommand", item, _TITLES[item])
    if cmd not in COMMANDS:
        print(f"unknown command: {cmd}; choose from "
              f"{[*COMMANDS, *NOT_PORTED]}", file=sys.stderr)
        return 2
    return COMMANDS[cmd](argv[1:])


if __name__ == "__main__":
    raise SystemExit(main())
