"""Synthetic cameras and datasets for drives and tests (numpy, host-side)."""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor

import numpy as np


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
    if eval_every > 0:
        meta["val_filenames"] = [
            fr["file_path"] for i, fr in enumerate(frames)
            if i % eval_every == 0
        ]
        meta["train_filenames"] = [
            fr["file_path"] for i, fr in enumerate(frames)
            if i % eval_every != 0
        ]
    with open(root / "transforms.json", "w") as fh:
        json.dump(meta, fh, indent=2)
