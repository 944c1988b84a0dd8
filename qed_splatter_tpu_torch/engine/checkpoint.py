"""Checkpoints and the 3DGS PLY export (port of ``engine/checkpoint.py``).

A checkpoint is a directory ``<ckpt_dir>/step-XXXXXXXXX/`` holding
``state.pt``, a ``torch.save`` of the whole :class:`TrainState` as CPU
tensors (params, Adam moments, camera deltas and their moments, densify
stats, step, and the bilateral grids with their moments when the run has
them), and ``meta.json``. ``<ckpt_dir>/latest.json`` repeats the
newest checkpoint's ``meta.json``. The metadata carries the JAX package's
keys: ``step``, ``path``, ``capacity``, ``num_cameras``, ``sh_degree``,
the bilateral-grid keys, the dataparser transform and scale, the model
config, and the adaptive tables ``k_by_d`` and ``tpg_by_d``.

:func:`load_state` restores a run's latest checkpoint for the serving
tools. :func:`export_ply` writes the alive gaussians as the same 3DGS
interchange PLY as the JAX package, byte for byte; :func:`export_splat` as
the 32-byte-per-gaussian ``.splat`` layout of web viewers
(:func:`pack_splat_buffer`), and :func:`export_pointcloud_ply` as centres and
dc colours.
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Dict, Optional

import numpy as np
import torch

from qed_splatter_tpu_torch import resolve_device
from qed_splatter_tpu_torch.configs import ModelConfig
from qed_splatter_tpu_torch.engine.densify import DensifyStats
from qed_splatter_tpu_torch.data.ply import write_ply
from qed_splatter_tpu_torch.engine.train_step import TrainState
from qed_splatter_tpu_torch.models.gaussians import (
    FIELDS,
    SH_C0,
    GaussianParams,
)

STATE_FILE = "state.pt"


def _adam_to(s: Dict, device) -> Dict:
    return {k: v.detach().to(device, copy=True) for k, v in s.items()}


def copy_state(state: TrainState, device) -> TrainState:
    """A copy of ``state`` on ``device`` that shares no tensor with it (the
    step updates parameters and moments in place)."""
    return TrainState(
        params=GaussianParams(**{
            f: getattr(state.params, f).detach().to(device, copy=True)
            for f in FIELDS}),
        opt_state={g: _adam_to(s, device) for g, s in state.opt_state.items()},
        camera_opt=state.camera_opt.detach().to(device, copy=True),
        camera_opt_state=_adam_to(state.camera_opt_state, device),
        stats=DensifyStats(*(
            getattr(state.stats, f.name).detach().to(device, copy=True)
            for f in dataclasses.fields(DensifyStats))),
        step=int(state.step),
        bilateral_grids=(
            state.bilateral_grids.detach().to(device, copy=True)
            if state.bilateral_grids is not None else None),
        bilateral_grid_state=(
            _adam_to(state.bilateral_grid_state, device)
            if state.bilateral_grid_state is not None else None),
    )


def state_to_dict(state: TrainState) -> Dict:
    """What ``state.pt`` holds: the state as nested dicts of CPU tensor
    copies, and the step."""
    cpu = copy_state(state, "cpu")
    return {
        "params": {f: getattr(cpu.params, f) for f in FIELDS},
        "opt_state": cpu.opt_state,
        "camera_opt": cpu.camera_opt,
        "camera_opt_state": cpu.camera_opt_state,
        "stats": {f.name: getattr(cpu.stats, f.name)
                  for f in dataclasses.fields(DensifyStats)},
        "step": cpu.step,
        "bilateral_grids": cpu.bilateral_grids,
        "bilateral_grid_state": cpu.bilateral_grid_state,
    }


def _jsonable_config(cfg) -> dict:
    out = {}
    for f in dataclasses.fields(cfg):
        v = getattr(cfg, f.name)
        out[f.name] = list(v) if isinstance(v, tuple) else v
    return out


def save_checkpoint(ckpt_dir, state: TrainState, step: int,
                    dataparser_transform=None,
                    dataparser_scale: float = 1.0,
                    model_config=None,
                    k_by_d=None,
                    tpg_by_d=None) -> Path:
    """Write ``step-XXXXXXXXX/`` under ``ckpt_dir`` and point
    ``latest.json`` at it."""
    ckpt_dir = Path(ckpt_dir).absolute()
    path = ckpt_dir / f"step-{step:09d}"
    path.mkdir(parents=True, exist_ok=True)
    torch.save(state_to_dict(state), path / STATE_FILE)
    meta = {
        "step": step,
        "path": path.name,
        "capacity": int(state.params.capacity),
        "num_cameras": int(state.camera_opt.shape[0]),
        "sh_degree": int(state.params.sh_degree),
        "use_bilateral_grid": state.bilateral_grids is not None,
        "bilateral_grid_shape": (
            list(state.bilateral_grids.shape[1:4])
            if state.bilateral_grids is not None else None),
        # the dataparser normalization, for the inverse transform on
        # export: world = R^T ((p / scale) - t)
        "dataparser_transform": (
            np.asarray(dataparser_transform).tolist()
            if dataparser_transform is not None else None),
        "dataparser_scale": float(dataparser_scale),
        "model_config": (_jsonable_config(model_config)
                         if model_config is not None else None),
        # adaptive per-resolution-bucket tables: a resume must not re-enter
        # its bucket at the config defaults
        "k_by_d": ({str(d): int(k) for d, k in k_by_d.items()}
                   if k_by_d else None),
        "tpg_by_d": ({str(d): int(k) for d, k in tpg_by_d.items()}
                     if tpg_by_d else None),
    }
    text = json.dumps(meta)
    (path / "meta.json").write_text(text)
    (ckpt_dir / "latest.json").write_text(text)
    return path


def restore_checkpoint(path, device="cuda") -> TrainState:
    """The :class:`TrainState` saved in checkpoint directory ``path``, on
    ``device``."""
    dev = resolve_device(device)
    d = torch.load(Path(path) / STATE_FILE, map_location=dev,
                   weights_only=True)
    return TrainState(
        params=GaussianParams(**d["params"]),
        opt_state=d["opt_state"],
        camera_opt=d["camera_opt"],
        camera_opt_state=d["camera_opt_state"],
        stats=DensifyStats(**d["stats"]),
        step=int(d["step"]),
        bilateral_grids=d.get("bilateral_grids"),
        bilateral_grid_state=d.get("bilateral_grid_state"),
    )


def load_state(ckpt_dir, device="cuda") -> TrainState:
    """The latest checkpoint under ``ckpt_dir`` (a run's ``ckpts/`` or one
    checkpoint directory), on ``device``."""
    latest = latest_checkpoint(ckpt_dir)
    if latest is None:
        raise FileNotFoundError(f"no checkpoint under {ckpt_dir}")
    return restore_checkpoint(latest, device)


def latest_checkpoint(ckpt_dir) -> Optional[Path]:
    """The checkpoint ``latest.json`` names, else the last ``step-*``;
    ``ckpt_dir`` may also be one checkpoint directory itself."""
    ckpt_dir = Path(ckpt_dir)
    if (ckpt_dir / STATE_FILE).exists():
        return ckpt_dir
    meta = ckpt_dir / "latest.json"
    if meta.exists():
        p = ckpt_dir / json.loads(meta.read_text())["path"]
        if p.exists():
            return p
    candidates = sorted(ckpt_dir.glob("step-*"))
    return candidates[-1] if candidates else None


def checkpoint_meta(ckpt_dir) -> Optional[dict]:
    """``latest.json`` of a checkpoint root, or ``meta.json`` of one
    checkpoint directory."""
    for name in ("latest.json", "meta.json"):
        meta = Path(ckpt_dir) / name
        if meta.exists():
            return json.loads(meta.read_text())
    return None


def model_config_from_meta(meta: Optional[dict]) -> ModelConfig:
    """The trained ModelConfig from checkpoint metadata; defaults (plus a
    top-level ``sh_degree``) for metadata without one."""
    cfg = ModelConfig()
    if not meta:
        return cfg
    stored = meta.get("model_config")
    if stored:
        names = {f.name for f in dataclasses.fields(ModelConfig)}
        kw = {}
        for k, v in stored.items():
            if k not in names:
                continue
            if isinstance(getattr(cfg, k), tuple) and isinstance(v, list):
                v = tuple(v)
            kw[k] = v
        return dataclasses.replace(cfg, **kw)
    if "sh_degree" in meta:
        return dataclasses.replace(cfg, sh_degree=int(meta["sh_degree"]))
    return cfg


def _inverse_transform(means: np.ndarray, scales_log: np.ndarray, meta):
    """Undo the dataparser's orient / center / scale normalization, so
    exports land in input-world coordinates."""
    if not meta or meta.get("dataparser_transform") is None:
        return means, scales_log
    t34 = np.asarray(meta["dataparser_transform"], np.float64)
    scale = float(meta.get("dataparser_scale", 1.0))
    R, t = t34[:3, :3], t34[:3, 3]
    out = (means.astype(np.float64) / scale - t) @ R  # R^-1 = R^T, rows
    return out.astype(np.float32), (
        scales_log - np.log(max(scale, 1e-12))).astype(np.float32)


def _alive_rows(params: GaussianParams):
    """(number alive, a function giving a field's alive rows as numpy)."""
    idx = torch.nonzero(params.alive.cpu()).reshape(-1).numpy()

    def rows(t):
        return t.detach().cpu().numpy()[idx]
    return len(idx), rows


def _dc_rgb(dc: np.ndarray) -> np.ndarray:
    """SH dc band -> RGB clipped to [0, 1] (float32)."""
    return np.clip(dc * np.float32(SH_C0) + np.float32(0.5), 0.0, 1.0)


def export_ply(path, params: GaussianParams, meta=None) -> int:
    """Write the alive gaussians as a 3DGS interchange PLY (positions,
    normals 0, SH features channel-major, opacity logit, log-scales,
    quaternions), readable by standard splat viewers. ``meta``
    (:func:`checkpoint_meta`) enables the inverse dataparser transform.
    Returns the number of gaussians written."""
    n, rows = _alive_rows(params)

    means, scales = _inverse_transform(rows(params.means),
                                       rows(params.scales), meta)
    dc, rest = rows(params.features_dc), rows(params.features_rest)
    props = [(a, "<f4") for a in ("x", "y", "z", "nx", "ny", "nz")]
    props += [(f"f_dc_{i}", "<f4") for i in range(3)]
    n_rest = rest.shape[1] * 3
    props += [(f"f_rest_{i}", "<f4") for i in range(n_rest)]
    props += [("opacity", "<f4")]
    props += [(f"scale_{i}", "<f4") for i in range(3)]
    props += [(f"rot_{i}", "<f4") for i in range(4)]
    rec = np.zeros(n, dtype=np.dtype(props))
    rec["x"], rec["y"], rec["z"] = means.T
    for i in range(3):
        rec[f"f_dc_{i}"] = dc[:, i]
    # 3DGS layout: channel-major (all coeffs of R, then G, then B)
    rest_cm = rest.transpose(0, 2, 1).reshape(n, -1)
    for i in range(n_rest):
        rec[f"f_rest_{i}"] = rest_cm[:, i]
    rec["opacity"] = rows(params.opacities)
    for i in range(3):
        rec[f"scale_{i}"] = scales[:, i]
    quats = rows(params.quats)
    for i in range(4):
        rec[f"rot_{i}"] = quats[:, i]
    header = "\n".join(
        ["ply", "format binary_little_endian 1.0", f"element vertex {n}"]
        + [f"property float {name}" for name, _ in props]
        + ["end_header", ""])
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    with open(path, "wb") as f:
        f.write(header.encode("ascii"))
        f.write(rec.tobytes())
    return n


def export_pointcloud_ply(path, params: GaussianParams, meta=None) -> int:
    """Write the alive gaussians' centres and dc colours as a plain xyz/rgb
    PLY (for the point-cloud metrics); returns the number written."""
    n, rows = _alive_rows(params)
    means, _ = _inverse_transform(rows(params.means),
                                  np.zeros((n, 3), np.float32), meta)
    write_ply(path, means, _dc_rgb(rows(params.features_dc)))
    return n


def pack_splat_buffer(params: GaussianParams, meta=None) -> bytes:
    """The alive gaussians as the 32-byte-per-splat buffer of web splat
    viewers: position f32x3, world scale f32x3 (exp of the log-scale),
    colour rgba u8x4 (SH dc -> rgb, sigmoid opacity), rotation u8x4 (the
    normalized wxyz quaternion as c * 128 + 128). Splats are ordered by
    descending volume x opacity, so a truncated prefix still previews the
    large structure first."""
    n, rows = _alive_rows(params)
    means, scales_log = _inverse_transform(
        rows(params.means).astype(np.float32),
        rows(params.scales).astype(np.float32), meta)
    scales = np.exp(scales_log)
    rgb = _dc_rgb(rows(params.features_dc))
    opac = 1.0 / (1.0 + np.exp(-rows(params.opacities).astype(np.float32)))
    quats = rows(params.quats).astype(np.float32)
    quats = quats / np.maximum(
        np.linalg.norm(quats, axis=-1, keepdims=True), 1e-12)
    order = np.argsort(
        -(scales[:, 0] * scales[:, 1] * scales[:, 2] * opac), kind="stable")
    rec = np.zeros(n, dtype=np.dtype([("pos", "<f4", 3), ("scale", "<f4", 3),
                                      ("rgba", "u1", 4), ("rot", "u1", 4)]))
    rec["pos"] = means[order]
    rec["scale"] = scales[order]
    rec["rgba"][:, :3] = np.clip(rgb[order] * 255.0 + 0.5, 0, 255)
    rec["rgba"][:, 3] = np.clip(opac[order] * 255.0 + 0.5, 0, 255)
    rec["rot"] = np.clip(quats[order] * 128.0 + 128.0, 0, 255)
    return rec.tobytes()


def export_splat(path, params: GaussianParams, meta=None) -> int:
    """Write the alive gaussians as a ``.splat`` file (the layout of
    :func:`pack_splat_buffer`); returns the number written."""
    buf = pack_splat_buffer(params, meta)
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_bytes(buf)
    return len(buf) // 32
