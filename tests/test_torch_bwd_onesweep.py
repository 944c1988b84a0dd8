"""The compositing backward kernel's algorithm in plain PyTorch
(``composite_tiles_bwd_sweeps_ref``, what the port's autograd runs on CPU
tensors) on the CPU.

It is the direct chain rule with dalpha_k = T_k (dw_k - Q_k): T from the
forward's front-to-back pass (handed over as the last T and its slot, and
divided back out), Q_k (what lies behind slot k, composited on its own)
from a back-to-front sweep, and only the slots below each tile's count
replayed. Held against JAX autodiff of the XLA ``rasterize_tiles`` on the
same slabs and against a float64 autograd of the plain composite, at
``atol=5e-5, rtol=1e-3`` elementwise (the bar of ``test_torch_backward.py``):
on random slabs, under opaque stacks, with tile counts below K, and chunked
with both skip reasons.

The one-sweep form, R_k = S - prefix_k with S = gout . out + gacc acc from
the forward's outputs, needs no back-to-front sweep. It is measured here
too (``test_one_sweep_form_misses_bar_under_opaque_stack``): its error is
eps |S| whatever R_k is, times 1 / (1 - alpha_k) <= 1000, and it misses the
bar on the slots of an opaque stack, which is why the kernel sweeps both
ways."""

import numpy as np
import pytest
import torch

from qed_splatter_tpu_torch.ops import rasterize_pallas as trp
from test_torch_backward import (ATOL, NAMES, RTOL, _assert_close,
                                 _cotangents, _f64_grads, _jax_autodiff,
                                 _saturate)
from test_torch_rasterize import _slabs, _t


def _forward(slabs, ntx, counts=None, k_chunk=0):
    t = slabs[0].shape[0]
    runs = torch.empty(t, dtype=torch.int32)
    out, acc = trp.composite_tiles_ref(
        *map(_t, slabs), ntx, tile_counts=None if counts is None
        else _t(counts), k_chunk=k_chunk, chunks_run=runs)
    return out, acc, runs


def _sweeps(slabs, gout, gacc, ntx, counts=None, k_chunk=0, runs=None):
    return trp.composite_tiles_bwd_sweeps_ref(
        *map(_t, slabs), _t(gout), _t(gacc), ntx, k_chunk=k_chunk,
        chunks_run=runs, tile_counts=None if counts is None else _t(counts))


def _one_sweep(slabs, out, acc, gout, gacc, ntx):
    """The form the kernel does not use: one front-to-back sweep with
    R_k = S - prefix_k and S from the forward's outputs."""
    gout, gacc = _t(gout), _t(gacc)
    total = (gout * out).sum(1) + gacc[:, 0] * acc[:, 0]
    return trp.composite_tiles_bwd_sweeps_ref(*map(_t, slabs), gout, gacc,
                                              ntx, total=total)


def _worst(got, want):
    return max(float((g - w).abs().max()) / max(float(w.abs().max()), 1e-12)
               for g, w in zip(got, want))


@pytest.mark.parametrize("d,k,t,needles", [(3, 64, 4, False),
                                           (4, 64, 12, True),
                                           (4, 96, 6, False),
                                           (1, 96, 4, False)])
def test_sweeps_match_jax_autodiff_and_float64(d, k, t, needles):
    ntx = 2
    slabs = _slabs(17 * d + k, t, d, k, ntx, needles)
    gout, gacc = _cotangents(d + k, t, d)
    got = _sweeps(slabs, gout, gacc, ntx)
    xla = _jax_autodiff(slabs, gout, gacc, ntx)
    f64 = _f64_grads(slabs, gout, gacc, ntx)
    for name, g, j, x in zip(NAMES, got, xla, f64):
        assert g.shape == x.shape
        _assert_close(g, j, f"{name} vs JAX XLA autodiff")
        _assert_close(g, x.float(), f"{name} vs float64 autograd")


@pytest.mark.parametrize("d,k,depth", [(3, 64, 8), (4, 96, 8), (4, 64, 2),
                                       (4, 96, 24)])
def test_sweeps_under_opaque_stacks(d, k, depth):
    """Every other tile starts with ``depth`` slots of alpha 0.999 over the
    whole tile; at depth 24 T falls to 1e-72, below ``TRANS_MIN`` and below
    float32. Prints the worst error over max |grad| beside the autograd
    oracle's."""
    ntx, t = 2, 6
    slabs = _slabs(5 * d + depth, t, d, k, ntx)
    _saturate(slabs[0], slabs[1], slabs[3], [0, 2, 4], ntx, n=depth)
    gout, gacc = _cotangents(depth, t, d)
    got = _sweeps(slabs, gout, gacc, ntx)
    xla = _jax_autodiff(slabs, gout, gacc, ntx)
    f64 = [x.float() for x in _f64_grads(slabs, gout, gacc, ntx)]
    oracle = trp.composite_tiles_bwd_ref(*map(_t, slabs), _t(gout),
                                         _t(gacc), ntx)
    print(f"two sweeps {_worst(got, f64):.2e}, autograd oracle "
          f"{_worst(oracle, f64):.2e} of max |grad| vs float64")
    for name, g, j, x in zip(NAMES, got, xla, f64):
        assert torch.isfinite(g).all(), name
        _assert_close(g, j, f"{name} vs JAX XLA autodiff")
        _assert_close(g, x, f"{name} vs float64 autograd")


@pytest.mark.parametrize("d,k,depth,k_chunk", [(3, 64, 8, 0), (4, 96, 24, 0),
                                               (4, 96, 12, 0),
                                               (4, 256, 8, 64)])
def test_sweeps_fed_by_the_forward(d, k, depth, k_chunk):
    """The handoff: the plain forward's ``t_last`` and ``cut`` (the last
    transmittance >= ``TRANS_MIN`` and its slot, per pixel) feed the sweeps
    in place of their own front-to-back pass. Same gradients, exactly, and
    inside the bar against JAX autodiff under opaque stacks, where ``cut``
    lies below the tile's count once the stack takes T under 1e-30
    (0.001^10: from 11 slots on)."""
    ntx, t = 2, 6
    slabs = _slabs(7 * d + depth, t, d, k, ntx)
    if k_chunk:
        slabs[3] *= 0.25
    stacked = [0, 2, 4]
    _saturate(slabs[0], slabs[1], slabs[3], stacked, ntx, n=depth)
    counts = np.array([k, k - 9, k, 20, k + 5, 0], np.int32)
    for i, c in enumerate(counts):
        slabs[3][i, 0, c:] = 0.0
    gout, gacc = _cotangents(depth, t, d)
    runs = torch.empty(t, dtype=torch.int32)
    _, _, t_last, cut = trp.composite_tiles_ref(
        *map(_t, slabs), ntx, tile_counts=_t(counts), k_chunk=k_chunk,
        chunks_run=runs, tail=True)
    assert t_last.shape == (t, 1, 256) and cut.shape == (t, 1, 256)
    assert t_last.dtype == torch.float32 and cut.dtype == torch.int32
    n_run = trp.slots_run(t, k, k_chunk, runs, _t(counts), "cpu")
    assert (t_last >= trp.TRANS_MIN).all() and (t_last <= 1).all()
    assert (cut[:, 0] <= n_run[:, None]).all() and (cut >= 0).all()
    below = cut[stacked, 0] < n_run[stacked, None]
    if depth > 10:
        assert below.all() and (cut[stacked] <= depth).all()
    else:
        # 1e-24 behind the stack: only more splats can take T under 1e-30
        assert (cut[stacked] >= depth).all()
    assert (cut[[1, 3, 5], 0] == n_run[[1, 3, 5], None]).all()
    own = _sweeps(slabs, gout, gacc, ntx, counts, k_chunk, runs)
    fed = trp.composite_tiles_bwd_sweeps_ref(
        *map(_t, slabs), _t(gout), _t(gacc), ntx, k_chunk=k_chunk,
        chunks_run=runs, tile_counts=_t(counts), t_last=t_last, cut=cut)
    xla = _jax_autodiff(slabs, gout, gacc, ntx)
    for name, f, o, j in zip(NAMES, fed, own, xla):
        assert torch.equal(f, o), f"{name}: fed by the forward != own sweep"
        assert torch.isfinite(f).all(), name
        _assert_close(f, j, f"{name} vs JAX XLA autodiff")
    with pytest.raises(ValueError, match="together"):
        trp.composite_tiles_bwd_sweeps_ref(
            *map(_t, slabs), _t(gout), _t(gacc), ntx, t_last=t_last)


@pytest.mark.parametrize("counted", [False, True])
def test_backward_wrapper_takes_the_forwards_handoff(counted):
    """``composite_tiles_bwd`` has one path: it is fed ``t_last`` and ``cut``
    by ``composite_tiles_fwd`` and recomputes neither. Without them it
    raises; with them it gives the plain sweeps' gradients."""
    d, k, ntx, t = 4, 64, 2, 4
    slabs = _slabs(31, t, d, k, ntx)
    counts = np.array([k, 17, 0, k + 3], np.int32) if counted else None
    if counted:
        for i, c in enumerate(counts):
            slabs[3][i, 0, c:] = 0.0
    gout, gacc = _cotangents(3, t, d)
    runs = torch.empty(t, dtype=torch.int32)
    tc = None if counts is None else _t(counts)
    args = (*map(_t, slabs), _t(gout), _t(gacc), ntx, 16, 0)
    _, _, t_last, cut = trp.composite_tiles_fwd(*map(_t, slabs), ntx, 16, tc,
                                                0, runs, tail=True)
    with pytest.raises(ValueError, match="t_last and cut"):
        trp.composite_tiles_bwd(*args, runs, tc, None, None)
    with pytest.raises(ValueError, match="t_last and cut"):
        trp.composite_tiles_bwd(*args, runs, tc, t_last, None)
    got = trp.composite_tiles_bwd(*args, runs, tc, t_last, cut)
    want = _sweeps(slabs, gout, gacc, ntx, counts, 0, runs)
    for name, g, w in zip(NAMES, got, want):
        assert torch.equal(g, w), name


@pytest.mark.parametrize("d,k", [(3, 64), (4, 96)])
def test_one_sweep_form_misses_bar_under_opaque_stack(d, k):
    """Why the kernel sweeps both ways: on the slabs of the test above
    (8-deep stacks) the one-sweep form misses the elementwise bar against
    JAX's XLA autodiff where the two-sweep form meets it. Prints both
    forms' worst |err| over max |grad| and worst absolute error."""
    ntx, t = 2, 6
    slabs = _slabs(5 * d + 8, t, d, k, ntx)
    _saturate(slabs[0], slabs[1], slabs[3], [0, 2, 4], ntx, n=8)
    gout, gacc = _cotangents(8, t, d)
    out, acc, _ = _forward(slabs, ntx)
    one = _one_sweep(slabs, out, acc, gout, gacc, ntx)
    two = _sweeps(slabs, gout, gacc, ntx)
    xla = [torch.tensor(g) for g in _jax_autodiff(slabs, gout, gacc, ntx)]
    misses = []
    for name, o, w, j in zip(NAMES, one, two, xla):
        scale = float(j.abs().max())
        print(f"{name}: one sweep {float((o - j).abs().max()) / scale:.2e} "
              f"of max |grad| ({float((o - j).abs().max()):.2e} abs), two "
              f"sweeps {float((w - j).abs().max()) / scale:.2e} "
              f"({float((w - j).abs().max()):.2e} abs)")
        _assert_close(w, j, f"two sweeps {name} vs JAX XLA autodiff")
        if not np.allclose(o.numpy(), j.numpy(), atol=ATOL, rtol=RTOL):
            misses.append(name)
    assert "conics" in misses and "opac" in misses, misses
    # away from the stacks the one-sweep form is fine
    clear = [1, 3, 5]
    for name, o, j in zip(NAMES, one, xla):
        _assert_close(o[clear], j[clear], f"one sweep {name}, no stack")


@pytest.mark.parametrize("k,counts", [
    (64, [0, 1, 17, 64, 40, 200]),
    (96, [96, 5, 0, 33, 95, 1000]),
])
def test_sweeps_stop_at_tile_counts(k, counts):
    """Counts below K (0 and counts above K included): exact zeros at and
    past the count, and elsewhere exactly the unbounded result."""
    ntx, t, d = 3, 6, 4
    counts = np.asarray(counts, np.int32)
    slabs = _slabs(k, t, d, k, ntx)
    for i, c in enumerate(counts):
        slabs[3][i, 0, c:] = 0.0               # padding, as the binning leaves
    _saturate(slabs[0], slabs[1], slabs[3], [3], ntx, n=4)
    gout, gacc = _cotangents(k, t, d)
    bounded = _sweeps(slabs, gout, gacc, ntx, counts=counts)
    free = _sweeps(slabs, gout, gacc, ntx)
    xla = _jax_autodiff(slabs, gout, gacc, ntx)
    for name, b, f, j in zip(NAMES, bounded, free, xla):
        for i, c in enumerate(counts):
            assert not b[i, :, c:].any(), f"{name}: tile {i} past its count"
            assert torch.equal(b[i, :, :c], f[i, :, :c]), name
        _assert_close(b, j, f"{name} vs JAX XLA autodiff")
    # the compositor's autograd takes the counts to its backward
    leaves = [_t(x).requires_grad_(True) for x in slabs]
    out, acc = trp.composite_tiles_chunked(*leaves, ntx,
                                           tile_counts=_t(counts))
    auto = torch.autograd.grad((out, acc), leaves, (_t(gout), _t(gacc)))
    for name, a, b in zip(NAMES, auto, bounded):
        assert torch.equal(a, b), f"{name}: autograd path != the sweeps"


@pytest.mark.parametrize("counted", [False, True])
def test_sweeps_chunked_both_skip_reasons(counted):
    """K = 2048 in the real chunks of 1024: tile 0 saturates in chunk 1,
    tile 2's count ends in chunk 1, the rest composite both chunks. With
    ``counted`` the backward also stops at each tile's count."""
    ntx, t, d, k = 2, 4, 4, 2048
    assert trp.K_CHUNK == 1024
    slabs = _slabs(31, t, d, k, ntx)
    slabs[3] *= 0.03
    _saturate(slabs[0], slabs[1], slabs[3], [0], ntx)
    counts = np.array([k, 1500, 700, k], np.int32)
    for i, c in enumerate(counts):
        slabs[3][i, 0, c:] = 0.0
    gout, gacc = _cotangents(3, t, d)
    _, _, runs = _forward(slabs, ntx, counts, trp.K_CHUNK)
    assert runs.tolist() == [1, 2, 1, 2]
    got = _sweeps(slabs, gout, gacc, ntx, counts if counted else None,
                  trp.K_CHUNK, runs)
    xla = _jax_autodiff(slabs, gout, gacc, ntx)
    f64 = _f64_grads(slabs, gout, gacc, ntx, k_chunk=trp.K_CHUNK, runs=runs)
    stop = np.minimum(runs.numpy() * trp.K_CHUNK, counts if counted else k)
    for name, g, j, x in zip(NAMES, got, xla, f64):
        _assert_close(g, j, f"{name} vs JAX XLA autodiff")
        _assert_close(g, x.float(), f"{name} vs float64 autograd")
        for i, n in enumerate(stop):
            assert not g[i, :, n:].any(), f"{name}: tile {i} past slot {n}"
    with pytest.raises(ValueError, match="chunks_run"):
        _sweeps(slabs, gout, gacc, ntx, k_chunk=trp.K_CHUNK)
