"""Synthetic scenes, cameras and datasets for drives and tests (port of
``testing.py``): numpy on the host, images written with
:mod:`qed_splatter_tpu_torch.data.png`; only the gaussian teacher's
dataset renders, with the port's own ``render``."""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from typing import Tuple

import numpy as np


def random_scene(
    n: int = 256,
    seed: int = 0,
    spread: float = 1.0,
    scale_range: Tuple[float, float] = (0.02, 0.12),
) -> dict:
    """Random 3D gaussians in front of the origin, numpy host-side."""
    rng = np.random.default_rng(seed)
    means = rng.uniform(-spread, spread, size=(n, 3)).astype(np.float32)
    means[:, 2] += 3.0  # push in front of a camera looking down +z (OpenCV)
    quats = rng.normal(size=(n, 4)).astype(np.float32)
    quats /= np.linalg.norm(quats, axis=-1, keepdims=True)
    scales = rng.uniform(*scale_range, size=(n, 3)).astype(np.float32)
    opacities = rng.uniform(0.3, 0.95, size=(n,)).astype(np.float32)
    colors = rng.uniform(0.0, 1.0, size=(n, 3)).astype(np.float32)
    return dict(
        means=means, quats=quats, scales=scales,
        opacities=opacities, colors=colors,
    )


def simple_camera(width: int = 64, height: int = 48, f: float = 60.0):
    """Identity-pose OpenCV camera (world == camera, +z forward).

    Returns (viewmat [1,4,4], K [1,3,3]) as numpy float32.
    """
    viewmat = np.eye(4, dtype=np.float32)[None]
    K = np.array(
        [[f, 0.0, width / 2.0], [0.0, f, height / 2.0], [0.0, 0.0, 1.0]],
        dtype=np.float32,
    )[None]
    return viewmat, K


def orbit_c2w_opengl(
    radius: float, azimuth: float, elevation: float, target=(0.0, 0.0, 3.0)
) -> np.ndarray:
    """OpenGL camera-to-world orbiting ``target``, looking at it. [4, 4]."""
    target = np.asarray(target, dtype=np.float64)
    eye = target + radius * np.array(
        [
            np.cos(elevation) * np.sin(azimuth),
            np.sin(elevation),
            -np.cos(elevation) * np.cos(azimuth),
        ]
    )
    forward = target - eye
    forward /= np.linalg.norm(forward)
    up = np.array([0.0, 1.0, 0.0])
    right = np.cross(forward, up)
    right /= np.linalg.norm(right)
    up = np.cross(right, forward)
    # OpenGL convention: camera looks down -z, y up.
    c2w = np.eye(4)
    c2w[:3, 0] = right
    c2w[:3, 1] = up
    c2w[:3, 2] = -forward
    c2w[:3, 3] = eye
    return c2w.astype(np.float32)


def orbit_intrinsics(width: int, height: int, focal_scale: float = 0.8):
    """Pinhole K [3, 3] float32 with f = focal_scale * max(W, H), centred
    principal point (the orbit render's intrinsics)."""
    f = focal_scale * max(width, height)
    return np.array(
        [[f, 0, width / 2], [0, f, height / 2], [0, 0, 1]], np.float32
    )


def write_synthetic_dataset(
    root,
    num_frames: int = 6,
    width: int = 64,
    height: int = 48,
    depth_format: str = "npy",
    with_ply: bool = False,
    depth_unit: float = 1000.0,
    seed: int = 0,
) -> None:
    """Write a nerfstudio-style RGB-D dataset (transforms.json + images +
    depths) rendered from a simple analytic scene: a textured plane at
    z = 4 in front of orbiting cameras. The same files as the JAX
    package's ``testing.write_synthetic_dataset`` (PNGs written with
    :mod:`qed_splatter_tpu_torch.data.png`, so their bytes may differ; their
    pixels do not)."""
    import json
    from pathlib import Path

    from qed_splatter_tpu_torch.data.png import write_png

    root = Path(root)
    (root / "images").mkdir(parents=True, exist_ok=True)
    (root / "depth").mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed)
    f = 60.0
    frames = []
    for i in range(num_frames):
        az = 0.25 * (i / max(num_frames - 1, 1) - 0.5)
        c2w = orbit_c2w_opengl(2.0, az, 0.05, target=(0.0, 0.0, 3.0))
        # simple image: smooth gradient + noise blocks
        yy, xx = np.meshgrid(
            np.linspace(0, 1, height), np.linspace(0, 1, width), indexing="ij"
        )
        img = np.stack(
            [xx, yy, np.full_like(xx, 0.3 + 0.1 * i / num_frames)], axis=-1
        )
        img = (img * 255).astype(np.uint8)
        write_png(root / "images" / f"frame_{i:04d}.png", img)
        depth_m = 2.0 + 0.5 * xx + 0.25 * yy  # metric depth in meters
        depth_raw = (depth_m * depth_unit).astype(np.float32)
        if depth_format == "npy":
            np.save(root / "depth" / f"frame_{i:04d}.npy", depth_raw)
            depth_name = f"depth/frame_{i:04d}.npy"
        else:
            write_png(root / "depth" / f"frame_{i:04d}.png",
                      depth_raw.astype(np.uint16))
            depth_name = f"depth/frame_{i:04d}.png"
        frames.append(
            {
                "file_path": f"images/frame_{i:04d}.png",
                "depth_file_path": depth_name,
                "transform_matrix": c2w.tolist(),
            }
        )
    meta = {
        "fl_x": f, "fl_y": f,
        "cx": width / 2.0, "cy": height / 2.0,
        "w": width, "h": height,
        "frames": frames,
    }
    if with_ply:
        from qed_splatter_tpu_torch.data.ply import write_ply

        pts = rng.uniform(-1, 1, size=(256, 3)).astype(np.float32)
        pts[:, 2] += 3.0
        cols = rng.uniform(0, 1, size=(256, 3)).astype(np.float32)
        write_ply(root / "sparse_pc.ply", pts, cols)
        meta["ply_file_path"] = "sparse_pc.ply"
    with open(root / "transforms.json", "w") as fh:
        json.dump(meta, fh, indent=2)


def write_room_dataset(
    root,
    num_frames: int = 48,
    width: int = 1296,
    height: int = 840,
    seed: int = 0,
    depth_unit: float = 1000.0,
    eval_every: int = 0,
    rgb_only: bool = False,
    sparse_ply: int = 0,
    workers: int = 1,
) -> None:
    """Analytic ray-cast indoor RGB-D dataset: a closed textured room with
    boxes — opaque surfaces with exact, multi-view-consistent sensor depth
    (BASELINE config #3 class: ScanNet-style mm RGB-D).

    Unlike the gaussian-teacher scene (volumetric translucent blobs whose
    depth is inherently ambiguous for a refitted representation), every ray
    here terminates on one opaque surface, so depth supervision and the
    photometric objective agree exactly — the workload real RGB-D sensors
    produce. Textures are procedural functions of the world-space hit point
    (view-independent, mid-frequency), so the scene is gaussian-fittable
    but not trivial.

    ``rgb_only=True`` drops the depth maps from disk and transforms.json —
    the splatfacto-base workload (BASELINE config #2: "RGB-only
    splatfacto-init, 7k iters at 1080p"). ``sparse_ply=N`` additionally
    writes an SfM-style sparse surface point cloud (~N points sampled from
    the ray-cast hits with albedo colors, like the COLMAP cloud nerfstudio
    scenes ship) as ``sparse_pc.ply`` and sets ``ply_file_path`` so
    splatfacto seeds from it (ref dataparser.py:25-56 / config.py:36).
    ``workers`` threads cast the frames' rays (the output is the same).

    A numpy port of the JAX package's ``testing.write_room_dataset``: the
    same decoded pixels, depths and points, its PNGs written with
    :mod:`qed_splatter_tpu_torch.data.png` (no imaging library needed).
    """
    import json
    from pathlib import Path

    from qed_splatter_tpu_torch.data.png import write_png

    root = Path(root)
    (root / "images").mkdir(parents=True, exist_ok=True)
    (root / "depth").mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed)

    cz = 3.0  # room center z
    # room interior AABB and boxes [(lo, hi, palette_idx)]
    room_lo = np.array([-2.2, -1.6, cz - 2.2])
    room_hi = np.array([2.2, 1.6, cz + 2.2])
    boxes = []
    for bi in range(4):
        size = rng.uniform(0.35, 0.9, 3)
        pos = np.array([
            rng.uniform(-1.4, 1.4),
            -1.6 + size[1] / 2,          # resting on the floor
            cz + rng.uniform(-1.4, 1.4),
        ])
        boxes.append((pos - size / 2, pos + size / 2))
    palette = rng.uniform(0.25, 0.95, (12, 3))

    def shade(p, sid, axis):
        """Procedural albedo at world points p [M, 3] on surface sid."""
        base = palette[sid % len(palette)]
        u = p[:, (axis + 1) % 3]
        v = p[:, (axis + 2) % 3]
        checker = (np.floor(u * 3.0) + np.floor(v * 3.0)) % 2
        wave = 0.5 + 0.5 * np.sin(7.0 * u + 3.0 * v + sid)
        c = base[None, :] * (0.55 + 0.3 * checker[:, None])
        c = c + 0.18 * wave[:, None] * palette[(sid + 5) % len(palette)]
        return np.clip(c, 0.0, 1.0)

    f = 0.75 * max(width, height)
    K = np.array(
        [[f, 0, width / 2.0], [0, f, height / 2.0], [0, 0, 1]], np.float32
    )

    def raycast(c2w):
        eye = c2w[:3, 3]
        R = c2w[:3, :3]
        u, v = np.meshgrid(np.arange(width) + 0.5, np.arange(height) + 0.5)
        # OpenGL camera: x right, y up, looking along -z
        d_cam = np.stack([
            (u - K[0, 2]) / f, -(v - K[1, 2]) / f, -np.ones_like(u)
        ], axis=-1).reshape(-1, 3)
        d = d_cam @ R.T                          # [M, 3] world directions
        M = d.shape[0]
        best_t = np.full(M, np.inf)
        best_sid = np.zeros(M, np.int32)
        best_axis = np.zeros(M, np.int32)

        def plane_hits(axis, value, inward, sid, lo=None, hi=None):
            nonlocal best_t, best_sid, best_axis
            da = d[:, axis]
            with np.errstate(divide="ignore", invalid="ignore"):
                t = (value - eye[axis]) / da
            p = eye[None, :] + t[:, None] * d
            ok = (t > 1e-4) & np.isfinite(t)
            if inward is not None:  # one-sided: ray must approach the wall
                ok &= (da * inward) > 0
            b_lo = room_lo if lo is None else lo
            b_hi = room_hi if hi is None else hi
            for ax2 in range(3):
                if ax2 == axis:
                    continue
                ok &= (p[:, ax2] >= b_lo[ax2] - 1e-6)
                ok &= (p[:, ax2] <= b_hi[ax2] + 1e-6)
            upd = ok & (t < best_t)
            best_t = np.where(upd, t, best_t)
            best_sid = np.where(upd, sid, best_sid)
            best_axis = np.where(upd, axis, best_axis)

        sid = 0
        for axis in range(3):  # 6 room walls (seen from inside)
            plane_hits(axis, room_lo[axis], inward=-1.0, sid=sid); sid += 1
            plane_hits(axis, room_hi[axis], inward=+1.0, sid=sid); sid += 1
        for lo, hi in boxes:  # 6 faces per box (seen from outside)
            for axis in range(3):
                plane_hits(axis, lo[axis], inward=+1.0, sid=sid,
                           lo=lo, hi=hi); sid += 1
                plane_hits(axis, hi[axis], inward=-1.0, sid=sid,
                           lo=lo, hi=hi); sid += 1

        p = eye[None, :] + best_t[:, None] * d
        rgb = shade(p, 0, 0) * 0.0
        for s in range(sid):
            m = best_sid == s
            if m.any():
                rgb[m] = shade(p[m], s, int(best_axis[m][0]))
        # sensor z-depth: |d_cam z| = 1 so depth-along-axis == t
        depth = best_t.reshape(height, width).astype(np.float32)
        return rgb.reshape(height, width, 3), depth

    frames = []
    sp_pts, sp_cols = [], []
    sp_rng = np.random.default_rng(seed + 1)

    def _room_frame(i, c2w, rgb, depth):
        write_png(root / "images" / f"frame_{i:04d}.png",
                  np.clip(rgb * 255, 0, 255).astype(np.uint8))
        frame = {
            "file_path": f"images/frame_{i:04d}.png",
            "transform_matrix": np.asarray(c2w).tolist(),
        }
        if not rgb_only:
            np.save(root / "depth" / f"frame_{i:04d}.npy",
                    (depth * depth_unit).astype(np.float32))
            frame["depth_file_path"] = f"depth/frame_{i:04d}.npy"
        frames.append(frame)
        if sparse_ply > 0:
            # SfM-like sparse samples: random finite-depth pixels,
            # backprojected through the same OpenGL camera as raycast()
            m = sparse_ply // num_frames + 1
            ys = sp_rng.integers(0, height, m)
            xs = sp_rng.integers(0, width, m)
            t = depth[ys, xs]
            ok = np.isfinite(t)
            d_cam = np.stack([
                (xs + 0.5 - K[0, 2]) / f, -(ys + 0.5 - K[1, 2]) / f,
                -np.ones(m),
            ], axis=-1)
            pts = (np.asarray(c2w)[:3, 3][None]
                   + t[:, None] * (d_cam @ np.asarray(c2w)[:3, :3].T))
            sp_pts.append(pts[ok])
            sp_cols.append(rgb[ys, xs][ok])

    poses = []
    for i in range(num_frames):
        az = 2.0 * np.pi * i / num_frames
        el = 0.12 * np.sin(3.0 * az)
        poses.append(orbit_c2w_opengl(1.5, az, el, target=(0.0, 0.0, cz)))
    # the ray casts are independent (numpy releases the interpreter lock
    # in its array ops); everything that draws from an rng stays in order
    with ThreadPoolExecutor(max(workers, 1)) as pool:
        casts = pool.map(lambda c: raycast(np.asarray(c)), poses)
        for i, (c2w, (rgb, depth)) in enumerate(zip(poses, casts)):
            _room_frame(i, c2w, rgb, depth)
    meta = {
        "fl_x": float(f), "fl_y": float(f),
        "cx": width / 2.0, "cy": height / 2.0,
        "w": width, "h": height,
        "frames": frames,
    }
    if sparse_ply > 0:
        from qed_splatter_tpu_torch.data.ply import write_ply

        pts = np.concatenate(sp_pts)[:sparse_ply]
        cols = np.concatenate(sp_cols)[:sparse_ply]
        # SfM noise: sub-cm jitter so the cloud is realistic, not exact
        pts = pts + sp_rng.normal(0, 0.004, pts.shape)
        write_ply(root / "sparse_pc.ply", pts.astype(np.float32),
                  colors=np.clip(cols * 255, 0, 255).astype(np.uint8))
        meta["ply_file_path"] = "sparse_pc.ply"
    _split_meta(meta, frames, eval_every)
    with open(root / "transforms.json", "w") as fh:
        json.dump(meta, fh, indent=2)


def _split_meta(meta: dict, frames: list, eval_every: int) -> None:
    """Every ``eval_every``-th frame held out (``val_filenames``)."""
    if eval_every > 0:
        meta["val_filenames"] = [
            fr["file_path"] for i, fr in enumerate(frames)
            if i % eval_every == 0
        ]
        meta["train_filenames"] = [
            fr["file_path"] for i, fr in enumerate(frames)
            if i % eval_every != 0
        ]


def _round_up(n, m=256):
    return ((n + m - 1) // m) * m


def write_gaussian_dataset(
    root,
    num_frames: int = 30,
    width: int = 640,
    height: int = 480,
    num_teacher: int = 4000,
    seed: int = 0,
    depth_unit: float = 1000.0,
    eval_every: int = 0,
    device="cuda",
) -> None:
    """Render a procedural gaussian 'teacher' scene into an on-disk RGB-D
    nerfstudio dataset (BASELINE config #1 shape: tiny indoor 480p RGB-D).

    The teacher is a random clustered gaussian cloud rendered with the
    port's own renderer (``render(train=False)`` on ``device``), so the
    targets are exactly reconstructable. Every gaussian is drawn: the
    teachers are sorted by view depth and rendered in disjoint chunks of
    ``max_per_tile`` (no per-tile truncation can happen inside a chunk),
    over-composited front to back. The same scene, cameras and files as
    the JAX package's ``testing.write_gaussian_dataset``.
    """
    import json
    from pathlib import Path

    import torch

    from qed_splatter_tpu_torch import resolve_device
    from qed_splatter_tpu_torch.configs import ModelConfig
    from qed_splatter_tpu_torch.data.png import write_png
    from qed_splatter_tpu_torch.models.gaussians import init_from_points
    from qed_splatter_tpu_torch.models.splatfacto import render
    from qed_splatter_tpu_torch.ops.camera import get_viewmat

    dev = resolve_device(device)
    root = Path(root)
    (root / "images").mkdir(parents=True, exist_ok=True)
    (root / "depth").mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed)

    # clustered teacher cloud: a few blobs + a ground slab, colorful
    centers = rng.uniform(-0.9, 0.9, (8, 3)).astype(np.float32)
    centers[:, 2] = centers[:, 2] * 0.4 + 3.0
    pts = []
    cols = []
    for c in centers:
        k = num_teacher // 10
        pts.append(c + rng.normal(scale=0.18, size=(k, 3)).astype(np.float32))
        base = rng.uniform(0.15, 1.0, 3)
        cols.append(
            np.clip(base + rng.normal(scale=0.1, size=(k, 3)), 0, 1)
        )
    k = num_teacher - sum(len(p) for p in pts)
    slab = rng.uniform(-1.4, 1.4, (k, 3)).astype(np.float32)
    slab[:, 1] = -0.9 + 0.03 * rng.normal(size=k)
    slab[:, 2] = slab[:, 2] * 0.6 + 3.0
    pts.append(slab)
    cols.append(
        np.stack([0.4 + 0.2 * np.cos(slab[:, 0] * 7),
                  0.45 + 0.2 * np.sin(slab[:, 2] * 5),
                  np.full(k, 0.35)], axis=1)
    )
    pts = np.concatenate(pts).astype(np.float32)
    cols = (np.clip(np.concatenate(cols), 0, 1) * 255).astype(np.uint8)

    teacher = init_from_points(pts, cols, capacity=_round_up(len(pts)),
                               device=dev)
    # near-opaque teacher (sigmoid(3.0) = 0.95), as RGB-D sensors image
    # opaque surfaces: a translucent teacher's RGB and surface depth
    # disagree, and no student fits both
    teacher = teacher.replace(
        scales=torch.minimum(teacher.scales + 0.7,
                             torch.full_like(teacher.scales, np.log(0.3))),
        opacities=torch.full_like(teacher.opacities, 3.0),
    )
    cfg = ModelConfig(background_color="black", camera_opt_mode="off",
                      max_per_tile=512)
    f = 0.75 * max(width, height)
    K = np.array(
        [[f, 0, width / 2.0], [0, f, height / 2.0], [0, 0, 1]], np.float32
    )

    def render_exact(c2w):
        viewmat = get_viewmat(torch.as_tensor(c2w)[None])[0].numpy()
        z = (pts @ viewmat[:3, :3].T + viewmat[:3, 3])[:, 2]
        order = np.argsort(z)
        total_rgb = torch.zeros((height, width, 3), device=dev)
        total_depth = torch.zeros((height, width), device=dev)
        transmit = torch.ones((height, width), device=dev)
        for s0 in range(0, len(order), cfg.max_per_tile):
            alive = torch.zeros(teacher.capacity, dtype=torch.bool,
                                device=dev)
            alive[torch.as_tensor(order[s0:s0 + cfg.max_per_tile],
                                  device=dev)] = True
            out = render(teacher.replace(alive=alive), c2w, K, width, height,
                         cfg, step=10_000, train=False, device=dev)
            acc_c = out.accumulation[..., 0]
            # black background: out.rgb is the chunk's premultiplied colour;
            # the depth's far fallback fires only where acc == 0
            dep_c = torch.where(acc_c > 0, out.depth[..., 0], 0.0)
            total_rgb += transmit[..., None] * out.rgb
            total_depth += transmit * dep_c
            transmit *= 1.0 - acc_c
        return (total_rgb.cpu().numpy(), total_depth.cpu().numpy(),
                1.0 - transmit.cpu().numpy())

    frames = []
    for i in range(num_frames):
        az = 1.2 * (i / max(num_frames - 1, 1) - 0.5)
        el = 0.15 + 0.1 * np.sin(2.1 * i)
        c2w = orbit_c2w_opengl(2.6, az, el, target=(0.0, 0.0, 3.0))
        rgb_f, depth_f, acc = render_exact(c2w)
        rgb = np.clip(rgb_f * 255, 0, 255).astype(np.uint8)
        # sensor depth: the accumulated depth normalized by alpha, valid
        # only where the ray is effectively solid (depth sensors drop out
        # at soft silhouette edges too)
        depth_m = depth_f / np.maximum(acc, 1e-6)
        depth_m = np.where(acc > 0.98, depth_m, 0.0)
        write_png(root / "images" / f"frame_{i:04d}.png", rgb)
        np.save(root / "depth" / f"frame_{i:04d}.npy",
                (depth_m * depth_unit).astype(np.float32))
        frames.append({
            "file_path": f"images/frame_{i:04d}.png",
            "depth_file_path": f"depth/frame_{i:04d}.npy",
            "transform_matrix": c2w.tolist(),
        })
    meta = {
        "fl_x": float(f), "fl_y": float(f),
        "cx": width / 2.0, "cy": height / 2.0,
        "w": width, "h": height,
        "frames": frames,
    }
    _split_meta(meta, frames, eval_every)
    with open(root / "transforms.json", "w") as fh:
        json.dump(meta, fh, indent=2)


def write_forest_dataset(
    root,
    num_frames: int = 40,
    width: int = 960,
    height: int = 540,
    seed: int = 0,
    depth_unit: float = 1000.0,
    eval_every: int = 8,
    world_offset=(18.0, 0.0, -11.0),
    workers: int = 1,
) -> None:
    """Analytic ray-cast outdoor forest scene: BASELINE config #4 (the
    reference README's thesis workload: an outdoor scene with UNSCALED
    poses, trained with ``auto_scale_poses=False``,
    ``center_method/orientation_method none`` and a ``random_scale=100``
    cube init, with dense depth supervision).

    A textured ground plane at y = 0 and 14 trees (cylinder trunks under
    spherical canopies) over a ~36 m clearing, seen from a fly-around at
    ~12-18 m radius, in metres; the poses are translated by
    ``world_offset`` (odometry does not start at the scene centroid), so a
    pipeline that silently re-centres or re-scales poses goes visibly
    wrong, while the ``random_scale=100`` cube (+-50 m) still covers the
    geometry. Dense z-depth (mm by default) for every pixel; sky pixels get
    depth 0 (invalid: the depth loss masks gt <= 0). ``workers`` threads
    cast the frames' rays (the output is the same).

    A numpy port of the JAX package's ``testing.write_forest_dataset``: the
    same decoded pixels, depths and ``transforms.json``, its PNGs written
    with :mod:`qed_splatter_tpu_torch.data.png`.
    """
    import json
    from pathlib import Path

    from qed_splatter_tpu_torch.data.png import write_png

    root = Path(root)
    (root / "images").mkdir(parents=True, exist_ok=True)
    (root / "depth").mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed)
    off = np.asarray(world_offset, np.float64)

    n_trees = 14
    # trees in an annulus so the camera orbit stays in the clearing
    ang = rng.uniform(0, 2 * np.pi, n_trees)
    rad = rng.uniform(8.0, 17.0, n_trees)
    tx = rad * np.cos(ang)
    tz = rad * np.sin(ang)
    trunk_r = rng.uniform(0.25, 0.55, n_trees)
    trunk_h = rng.uniform(4.0, 8.0, n_trees)
    canopy_r = rng.uniform(1.6, 3.2, n_trees)
    palette = rng.uniform(0.2, 0.9, (8, 3))

    f = 0.8 * max(width, height)
    K = np.array(
        [[f, 0, width / 2.0], [0, f, height / 2.0], [0, 0, 1]], np.float32
    )

    def shade_ground(p):
        u, v = p[:, 0], p[:, 2]
        checker = (np.floor(u * 0.8) + np.floor(v * 0.8)) % 2
        wave = 0.5 + 0.5 * np.sin(1.7 * u) * np.cos(2.3 * v)
        c = (np.array([0.25, 0.38, 0.16])[None]
             * (0.6 + 0.35 * checker[:, None])
             + 0.25 * wave[:, None] * np.array([0.35, 0.3, 0.12])[None])
        return np.clip(c, 0, 1)

    def shade_trunk(p, i):
        h = p[:, 1] / trunk_h[i]
        ring = 0.5 + 0.5 * np.sin(12.0 * np.arctan2(p[:, 2] - tz[i],
                                                    p[:, 0] - tx[i]))
        c = (np.array([0.36, 0.24, 0.12])[None] * (0.7 + 0.3 * ring[:, None])
             * (0.8 + 0.4 * h[:, None]))
        return np.clip(c, 0, 1)

    def shade_canopy(p, i):
        base = palette[i % len(palette)] * np.array([0.4, 0.8, 0.35])
        tex = 0.5 + 0.5 * np.sin(5.0 * p[:, 0]) * np.sin(4.0 * p[:, 1]) \
            * np.sin(6.0 * p[:, 2])
        return np.clip(base[None] * (0.55 + 0.45 * tex[:, None]), 0, 1)

    def raycast(c2w_local):
        eye = c2w_local[:3, 3]
        R = c2w_local[:3, :3]
        u, v = np.meshgrid(np.arange(width) + 0.5, np.arange(height) + 0.5)
        d_cam = np.stack([
            (u - K[0, 2]) / f, -(v - K[1, 2]) / f, -np.ones_like(u)
        ], axis=-1).reshape(-1, 3)
        d = d_cam @ R.T
        M = d.shape[0]
        best_t = np.full(M, np.inf)
        kind = np.full(M, -1, np.int32)    # 0 ground, 1+i trunk, 100+i canopy

        # ground plane y = 0 (one-sided from above)
        with np.errstate(divide="ignore", invalid="ignore"):
            tg = -eye[1] / d[:, 1]
        ok = (tg > 1e-4) & np.isfinite(tg) & (d[:, 1] < 0)
        pg = eye[0] + tg * d[:, 0]
        zg = eye[2] + tg * d[:, 2]
        ok &= (np.abs(pg) < 60.0) & (np.abs(zg) < 60.0)  # finite meadow
        upd = ok & (tg < best_t)
        best_t = np.where(upd, tg, best_t)
        kind = np.where(upd, 0, kind)

        for i in range(n_trees):
            # vertical cylinder |(x,z) - (tx,tz)| = r, 0 <= y <= h
            ox, oz = eye[0] - tx[i], eye[2] - tz[i]
            a = d[:, 0] ** 2 + d[:, 2] ** 2
            b = 2 * (ox * d[:, 0] + oz * d[:, 2])
            cc = ox * ox + oz * oz - trunk_r[i] ** 2
            disc = b * b - 4 * a * cc
            with np.errstate(divide="ignore", invalid="ignore"):
                t1 = (-b - np.sqrt(np.maximum(disc, 0))) / (2 * a)
            y1 = eye[1] + t1 * d[:, 1]
            ok = (disc > 0) & (t1 > 1e-4) & (y1 >= 0) & (y1 <= trunk_h[i])
            upd = ok & (t1 < best_t)
            best_t = np.where(upd, t1, best_t)
            kind = np.where(upd, 1 + i, kind)
            # canopy sphere at (tx, trunk_h + 0.6*canopy_r, tz)
            cy = trunk_h[i] + 0.6 * canopy_r[i]
            oc = eye - np.array([tx[i], cy, tz[i]])
            b2 = 2 * (d @ oc)
            c2 = oc @ oc - canopy_r[i] ** 2
            disc2 = b2 * b2 - 4 * c2
            with np.errstate(invalid="ignore"):
                t2 = (-b2 - np.sqrt(np.maximum(disc2, 0))) / 2.0
            ok2 = (disc2 > 0) & (t2 > 1e-4)
            upd2 = ok2 & (t2 < best_t)
            best_t = np.where(upd2, t2, best_t)
            kind = np.where(upd2, 100 + i, kind)

        hit = np.isfinite(best_t)
        p = eye[None, :] + np.where(hit, best_t, 0.0)[:, None] * d
        rgb = np.full((M, 3), [0.55, 0.7, 0.95])  # sky
        g = kind == 0
        if g.any():
            rgb[g] = shade_ground(p[g])
        for i in range(n_trees):
            m = kind == 1 + i
            if m.any():
                rgb[m] = shade_trunk(p[m], i)
            m = kind == 100 + i
            if m.any():
                rgb[m] = shade_canopy(p[m], i)
        depth = np.where(hit, best_t, 0.0).reshape(height, width)
        return rgb.reshape(height, width, 3), depth.astype(np.float32)

    poses = []
    for i in range(num_frames):
        az = 2.0 * np.pi * i / num_frames
        r_cam = 13.0 + 4.0 * np.sin(2 * az)
        eye_h = 2.2 + 1.2 * np.sin(3 * az + 1.0)
        c2w = orbit_c2w_opengl(
            r_cam, az, 0.08 + 0.05 * np.sin(az), target=(0.0, 1.5, 0.0)
        ).astype(np.float64)
        # orbit_c2w_opengl targets (0,1.5,0) at radius r; lift to eye_h
        c2w[1, 3] = eye_h
        poses.append(c2w)
    frames = []
    # the ray casts are independent (numpy releases the interpreter lock
    # in its array ops)
    with ThreadPoolExecutor(max(workers, 1)) as pool:
        casts = pool.map(lambda c: raycast(c.astype(np.float64)), poses)
        for i, (c2w, (rgb, depth)) in enumerate(zip(poses, casts)):
            write_png(root / "images" / f"frame_{i:04d}.png",
                      np.clip(rgb * 255, 0, 255).astype(np.uint8))
            np.save(root / "depth" / f"frame_{i:04d}.npy",
                    (depth * depth_unit).astype(np.float32))
            c2w_world = c2w.copy()
            c2w_world[:3, 3] += off    # survey-frame offset: UNSCALED poses
            frames.append({
                "file_path": f"images/frame_{i:04d}.png",
                "depth_file_path": f"depth/frame_{i:04d}.npy",
                "transform_matrix": c2w_world.tolist(),
            })
    meta = {
        "fl_x": float(f), "fl_y": float(f),
        "cx": width / 2.0, "cy": height / 2.0,
        "w": width, "h": height,
        "frames": frames,
    }
    _split_meta(meta, frames, eval_every)
    with open(root / "transforms.json", "w") as fh:
        json.dump(meta, fh, indent=2)
