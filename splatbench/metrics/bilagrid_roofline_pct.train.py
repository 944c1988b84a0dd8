"""The bilateral grid's share of its roofline: the least time the card
could take to slice a camera's grid and apply it to the frame, forward and
backward, over the device's busy time of the grid's two stages
(``bilagrid_ms.train``), percent.

The least time is the larger of bytes / 3.35 TB/s and f32 operations /
67 TFLOP/s (``splatbench.yardstick.bound_s``). Both are counted from the
frame and the grid alone, whatever implements them: for an H x W frame and
a [gh, gw, gd, 12] grid of float32,

bytes, each input read once and each output written once:
  forward: the render's RGB read (12 a pixel), the corrected RGB written
    (12), the grid read (gh gw gd 12 x 4);
  backward: the corrected RGB's gradient read (12), the render's RGB read
    (12), the render's RGB gradient written (12), the grid's gradient
    written (gh gw gd 12 x 4);
  so 60 bytes a pixel and twice the grid (2 x 98,304 bytes at 16x16x8);

operations a pixel, a multiply and an add counted as two:
  forward, 245: the guidance, luminance (3 products, 2 sums), its clamp
    (2) and scale to the levels (1): 8; the corner weights, a fraction, a
    floor's difference and a complement on each of the three axes (9) and
    the eight corners' products of three weights (4 + 8): 21; the
    trilinear read, 8 corners x 12 coefficients x 2: 192; the 3x4 affine,
    3 rows x (3 products + 3 sums): 18; the clamp, 3 x 2: 6;
  backward, 603: the clamp's mask (3); the 12 coefficients' gradients (9
    products; the offsets' 3 are the incoming gradient); the render's
    gradient through the affine, 3 x (3 products + 2 sums): 15; the
    guidance, weights and read again, which the backward needs and does
    not read back (8 + 21 + 192): 221; the grid's gradient, 8 corners x
    12 x 2: 192; the guidance's gradient: along the levels each of the 12
    coefficients' 4 corner differences, weighted and summed (4 + 4 + 3) x
    12 = 132, against the coefficients' gradients (12 + 11) = 23, the
    clamp's mask and the scale (2), to the three channels through the
    luminance (3 + 3): 163;
  848 in all.

At 1296x840 and 16x16x8: 65,515,008 bytes (19.56 us) and 923,166,720
operations (13.78 us): the bytes bound it.

The frame size and the grid shape are read from the configuration of the
one cell this metric lists, ``room_bilagrid.train_late`` (its training
frames at full resolution, the dataset's width and height). A second grid
cell would need the harness to hand the reader its cell's frame and grid,
a change to the benchmark's own files."""

import math

from splatbench import spec, yardstick

CELL = "room_bilagrid.train_late"
BYTES_PER_PIXEL = 60
OPS_FWD_PER_PIXEL = 8 + 21 + 192 + 18 + 6
OPS_BWD_PER_PIXEL = 3 + 9 + 15 + (8 + 21 + 192) + 192 + (132 + 23 + 2 + 6)


def counts(width: int, height: int, grid_shape) -> dict:
    """Bytes and f32 operations of one step's slice and apply, forward and
    backward, at a ``width`` x ``height`` frame and a ``grid_shape``
    ([gh, gw, gd]) grid of 12 coefficients."""
    px = width * height
    grid_bytes = math.prod(grid_shape) * 12 * 4
    return {"bytes": px * BYTES_PER_PIXEL + 2 * grid_bytes,
            "ops": px * (OPS_FWD_PER_PIXEL + OPS_BWD_PER_PIXEL)}


def frame_and_grid(cell: str = CELL) -> tuple:
    """(width, height, grid shape) of ``cell``'s configuration."""
    cfg = spec.load_cell(cell, with_state=False).config
    args = cfg["dataset"]["args"]
    return (int(args["width"]), int(args["height"]),
            tuple(cfg["model"]["bilateral_grid_shape"]))


def read(run):
    ms = spec.reader("bilagrid_ms.train")(run)
    if ms is None or ms <= 0:
        return None
    c = counts(*frame_and_grid())
    return 100.0 * yardstick.bound_s(c["ops"], c["bytes"]) / (ms * 1e-3)
