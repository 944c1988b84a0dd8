"""Command line of the port: the ``train`` subcommand (port of ``cli.py``).

    python -m qed_splatter_tpu_torch.cli train --data DIR [--device cpu]
        [--max-num-iterations N] [--model.max-per-tile 256 ...]

Every field of the config dataclasses is a flag, as in the JAX package's
``qed train``: nested fields take dotted prefixes (``--model.sh-degree``),
booleans ``--x`` / ``--no-x``, Literal types become choices.
``--device`` (default ``cuda``) picks where the trainer runs; on the GPU
the command holds the device lock (``utils/chiplock.py``) for its life. The
other subcommands of ``qed`` are not ported and raise, naming their ROADMAP
item.
"""

from __future__ import annotations

import argparse
import dataclasses
import sys
import typing
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
    # one client on the GPU at a time (a CPU run takes no lock)
    acquire_chip_lock("qed train", device=device)
    Trainer(cfg, device=device).train()
    return 0


# the JAX package's other subcommands, by the ROADMAP item that ports them
NOT_PORTED = {
    "eval": 9, "export": 9, "render": 9,
    "init-pc": 3, "eval-pc": 5, "train-multi": 8, "view": 10,
}
_TITLES = {
    3: "init_pc, backproject, voxel and the native binding",
    5: "the point-cloud metrics and LPIPS",
    8: "parallel/* and multi_scene",
    9: "the remaining CLI subcommands and writer backends",
    10: "the viewer",
}


def main(argv: Optional[list] = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] in ("-h", "--help"):
        print("usage: python -m qed_splatter_tpu_torch.cli train [flags]")
        return 0 if argv else 2
    cmd = argv[0]
    if cmd in NOT_PORTED:
        item = NOT_PORTED[cmd]
        raise not_ported(f"the '{cmd}' subcommand", item, _TITLES[item])
    if cmd != "train":
        print(f"unknown command: {cmd}; choose from "
              f"{['train', *NOT_PORTED]}", file=sys.stderr)
        return 2
    return cmd_train(argv[1:])


if __name__ == "__main__":
    raise SystemExit(main())
