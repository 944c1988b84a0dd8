"""The compositing backward and the rank gather's VJP, port vs the JAX
package on the CPU.

- ``composite_tiles_bwd_ref`` (the autograd VJP of the plain composite,
  the CUDA kernel's oracle) and what the port's autograd runs on CPU
  tensors (``composite_tiles_bwd_sweeps_ref``, the kernel's algorithm in
  plain PyTorch) against JAX autodiff of the XLA
  ``rasterize_tiles`` on the same slabs (every slot a gaussian of its own),
  against the VJP of JAX's ``composite_tiles_pallas`` /
  ``composite_tiles_chunked`` (Pallas in interpret mode), and against a
  float64 autograd of the same composite.
- The whole rasterizer's gradients against JAX autodiff of the XLA
  ``rasterize_tiles``.
- A finite-difference check, the absgrad seed against ``tile_eps``, and the
  gather's index_add VJP against JAX's scatter VJP.

Tolerances: ``atol=5e-5, rtol=1e-3`` elementwise, the bar of
``tests/test_rasterize_pallas.py::test_backward_parity``, against autodiff
(JAX's XLA path, or float64), on every tile, opaque stacks included.
Against the Pallas VJP the bar is 1e-4 of each tensor's max |grad|, the
form of ``test_needle_splat_gradient_parity``, on the tiles without an
opaque stack. The Pallas kernel sums the conic and opacity gradients
through pixel moments (``mean^2 S0 - 2 mean Sx + Sxx``), which cancels on
splats centred far from the tile, and takes T from a log-space bf16 hi/lo
matmul, whose error 1 / (1 - alpha) amplifies up to 1000x under an opaque
stack: there it fails the elementwise bar against JAX's own XLA autodiff
(``test_pallas_vjp_off_under_opaque_stack`` measures it)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qed_splatter_tpu.ops import rasterize_pallas as jrp
from qed_splatter_tpu.ops.rasterize import absgrad_scatter as jabsgrad
from qed_splatter_tpu.ops.rasterize import rasterize_tiles as jraster
from qed_splatter_tpu.ops.segment import tile_gather_cm as jgather_cm
from qed_splatter_tpu_torch.ops import rasterize_pallas as trp
from qed_splatter_tpu_torch.ops.rasterize import absgrad_scatter
from qed_splatter_tpu_torch.ops.rasterize import rasterize_tiles as traster
from qed_splatter_tpu_torch.ops.segment import tile_gather_ranked
from test_torch_rasterize import H, W, _binned, _slabs, _t

ATOL, RTOL = 5e-5, 1e-3
MAXREL = 1e-4


def _cotangents(seed, t, d):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(t, d, 256)).astype(np.float32),
            rng.normal(size=(t, 1, 256)).astype(np.float32))


def _saturate(means, conics, opac, tiles, ntx, n=8):
    for i in tiles:                       # an opaque stack in front
        means[i, 0, :n] = (i % ntx) * 16 + 8.0
        means[i, 1, :n] = (i // ntx) * 16 + 8.0
        conics[i, :, :n] = np.array([1e-6, 0.0, 1e-6])[:, None]
        opac[i, 0, :n] = 0.999


def _jax_autodiff(slabs, gout, gacc, ntx):
    """JAX autodiff of the XLA ``rasterize_tiles`` on the same slabs: each
    slot is a gaussian of its own, listed on its tile only, and the
    cotangents are laid out as the [H, W, C] images they belong to."""
    t, d, k = slabs[2].shape
    nty = t // ntx
    h, w = nty * 16, ntx * 16
    ids = jnp.arange(t * k, dtype=jnp.int32).reshape(t, k)
    flat = [jnp.asarray(x.transpose(0, 2, 1).reshape(t * k, -1))
            for x in slabs]

    def image(x):                         # [T, C, P] -> [H, W, C]
        c = x.shape[1]
        return jnp.asarray(x.reshape(nty, ntx, c, 16, 16)
                           .transpose(0, 3, 1, 4, 2).reshape(h, w, c))

    def composite(m, c, col, o):
        r = jraster(ids, m, c, col, o[:, 0], w, h, ntx)
        return r.render, r.alpha

    _, vjp = jax.vjp(composite, *flat)
    grads = vjp((image(gout), image(gacc)))
    return [np.asarray(g).reshape(t, k, -1).transpose(0, 2, 1)
            for g in grads]


def _f64_grads(slabs, gout, gacc, ntx, k_chunk=0, runs=None):
    return trp.composite_tiles_bwd_ref(
        *(torch.tensor(s, dtype=torch.float64) for s in slabs),
        torch.tensor(gout, dtype=torch.float64),
        torch.tensor(gacc, dtype=torch.float64), ntx, k_chunk=k_chunk,
        chunks_run=runs)


def _port_autograd(slabs, gout, gacc, ntx, chunked=False, counts=None):
    leaves = [torch.tensor(s, requires_grad=True) for s in slabs]
    runs = torch.empty(leaves[0].shape[0], dtype=torch.int32)
    if chunked:
        out, acc = trp.composite_tiles_chunked(
            *leaves, ntx, tile_counts=None if counts is None else _t(counts),
            chunks_run=runs)
    else:
        out, acc = trp.composite_tiles(*leaves, ntx)
    grads = torch.autograd.grad((out, acc), leaves,
                                (torch.tensor(gout), torch.tensor(gacc)))
    return grads, runs


def _assert_maxrel(got, want, name, tiles=slice(None)):
    got, want = np.asarray(got)[tiles], np.asarray(want)[tiles]
    scale = max(float(np.abs(want).max()), 1e-12)
    err = float(np.abs(got - want).max()) / scale
    assert err < MAXREL, f"{name}: max err {err:.2e} of max |grad|"


def _assert_close(got, want, name):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=ATOL,
                               rtol=RTOL, err_msg=name)


NAMES = ("means", "conics", "colors", "opac")


@pytest.mark.parametrize("d,needles", [(3, False), (4, True)])
def test_composite_bwd_matches_pallas_vjp(d, needles):
    ntx, t, k = 2, 4, 64
    slabs = _slabs(11 * d, t, d, k, ntx, needles)
    _saturate(slabs[0], slabs[1], slabs[3], [1], ntx)
    gout, gacc = _cotangents(d, t, d)
    _, vjp = jax.vjp(
        lambda *a: jrp.composite_tiles_pallas(*a, ntx, 16, True, False),
        *map(jnp.asarray, slabs))
    want = vjp((jnp.asarray(gout), jnp.asarray(gacc)))
    ref = trp.composite_tiles_bwd_ref(*map(_t, slabs), _t(gout), _t(gacc),
                                      ntx)
    xla = _jax_autodiff(slabs, gout, gacc, ntx)
    f64 = _f64_grads(slabs, gout, gacc, ntx)
    auto, _ = _port_autograd(slabs, gout, gacc, ntx)
    # on CPU tensors the autograd path runs the kernel's algorithm in plain
    # PyTorch, held to the same bars as the autograd oracle
    sweeps = trp.composite_tiles_bwd_sweeps_ref(*map(_t, slabs), _t(gout),
                                                _t(gacc), ntx)
    clear = [0, 2, 3]                     # tile 1 holds the opaque stack
    for name, r, w, j, x, a, s in zip(NAMES, ref, want, xla, f64, auto,
                                      sweeps):
        _assert_maxrel(r, w, f"{name} vs Pallas VJP", clear)
        _assert_close(r, j, f"{name} vs JAX XLA autodiff")
        _assert_close(r, x.float(), f"{name} vs float64 autograd")
        assert torch.equal(a, s), f"{name}: autograd path != its plain bwd"
        _assert_maxrel(a, w, f"autograd {name} vs Pallas VJP", clear)
        _assert_close(a, j, f"autograd {name} vs JAX XLA autodiff")
        _assert_close(a, x.float(), f"autograd {name} vs float64 autograd")


@pytest.mark.parametrize("d,needles", [(3, False), (4, True)])
def test_pallas_vjp_off_under_opaque_stack(d, needles):
    """A reference fault, measured on the slabs of the test above: on a
    tile with an opaque stack the JAX Pallas VJP misses the elementwise bar
    against JAX's own XLA autodiff, where the port meets it. Prints max
    |err| / max |grad| per slab."""
    ntx, t, k = 2, 4, 64
    slabs = _slabs(11 * d, t, d, k, ntx, needles)
    _saturate(slabs[0], slabs[1], slabs[3], [1], ntx)
    gout, gacc = _cotangents(d, t, d)
    _, vjp = jax.vjp(
        lambda *a: jrp.composite_tiles_pallas(*a, ntx, 16, True, False),
        *map(jnp.asarray, slabs))
    pallas = [np.asarray(g) for g in vjp((jnp.asarray(gout),
                                          jnp.asarray(gacc)))]
    xla = _jax_autodiff(slabs, gout, gacc, ntx)
    port = [g.numpy() for g in trp.composite_tiles_bwd_ref(
        *map(_t, slabs), _t(gout), _t(gacc), ntx)]
    misses = []
    for name, p, r, j in zip(NAMES, pallas, port, xla):
        scale = np.abs(j).max()
        print(f"{name}: Pallas VJP {np.abs(p - j).max() / scale:.2e}, port "
              f"{np.abs(r - j).max() / scale:.2e} of max |grad|")
        _assert_close(r, j, f"port {name} vs JAX XLA autodiff")
        if not np.allclose(p, j, atol=ATOL, rtol=RTOL):
            misses.append(name)
    assert "opac" in misses, misses


def test_chunked_composite_bwd_matches_jax(monkeypatch):
    """K = 256 in chunks of 64: a tile saturated in chunk 1, tiles whose
    count ends in chunk 1 or 3, and live tiles that run every chunk. Skipped
    chunks get exact zero gradients."""
    monkeypatch.setattr(jrp, "K_CHUNK", 64)
    monkeypatch.setattr(trp, "K_CHUNK", 64)
    ntx, t, d, k = 3, 6, 4, 256
    means, conics, colors, opac = _slabs(5, t, d, k, ntx)
    opac *= 0.25
    _saturate(means, conics, opac, [0], ntx)
    counts = np.full(t, k, np.int32)
    counts[[2, 4]] = [40, 150]
    for i in (2, 4):
        opac[i, 0, counts[i]:] = 0.0
    slabs = [means, conics, colors, opac]
    gout, gacc = _cotangents(9, t, d)
    _, vjp = jax.vjp(
        lambda *a: jrp.composite_tiles_chunked(
            *a, ntx, 16, True, False, tile_counts=jnp.asarray(counts)),
        *map(jnp.asarray, slabs))
    want = vjp((jnp.asarray(gout), jnp.asarray(gacc)))
    got, runs = _port_autograd(slabs, gout, gacc, ntx, chunked=True,
                               counts=counts)
    assert runs.tolist() == [1, 4, 1, 4, 3, 4]
    # the XLA rasterizer composites every slot; past a skipped chunk the
    # slots add nothing (opacity 0, or T ~ 1e-24 under the opaque stack)
    xla = _jax_autodiff(slabs, gout, gacc, ntx)
    f64 = _f64_grads(slabs, gout, gacc, ntx, k_chunk=64, runs=runs)
    for name, g, w, j, x in zip(NAMES, got, want, xla, f64):
        _assert_maxrel(g, w, f"{name} vs chunked Pallas VJP", slice(1, t))
        _assert_close(g, j, f"{name} vs JAX XLA autodiff")
        _assert_close(g, x.float(), f"{name} vs float64 autograd")
        for i, r in enumerate(runs.tolist()):
            assert not g[i, :, r * 64:].any(), f"{name}: skipped chunk"
    with pytest.raises(ValueError, match="chunks_run"):
        trp.composite_tiles_bwd_ref(*map(_t, slabs), _t(gout), _t(gacc),
                                    ntx, k_chunk=64)


def _raster_loss_grads_jax(b, m2d, con, colors, opac):
    target = jnp.zeros((H, W, colors.shape[-1]))

    def loss(m2d, con, colors, opac):
        out = jraster(b.tile_lists, m2d, con, colors, opac, W, H,
                      b.num_tiles_x)
        return (jnp.mean((out.render - target) ** 2)
                + 0.3 * jnp.mean(out.alpha ** 2))

    return jax.grad(loss, argnums=(0, 1, 2, 3))(m2d, con, colors, opac)


@pytest.mark.parametrize("with_depth", [False, True])
def test_rasterize_grads_match_jax_autodiff(with_depth):
    """Both port paths (rank gather + compositing Function; plain id-list
    compositor) against JAX autodiff of the XLA rasterizer, D = 3 and 4."""
    r, colors, opac, b = _binned(96, 3, 128, with_depth)
    m2d, con = r.means2d[0], r.conics[0]
    want = _raster_loss_grads_jax(b, m2d, con, colors, opac)
    for path in ("ranked", "plain"):
        leaves = [_t(x).requires_grad_(True) for x in (m2d, con, colors,
                                                       opac)]
        if path == "ranked":
            out = trp.rasterize_tiles_pallas(
                _t(b.tile_ranks), _t(b.order), *leaves, W, H,
                b.num_tiles_x, tile_counts=_t(b.tile_counts))
        else:
            out = traster(_t(b.tile_lists), *leaves, W, H, b.num_tiles_x)
        loss = (torch.mean(out.render ** 2)
                + 0.3 * torch.mean(out.alpha ** 2))
        got = torch.autograd.grad(loss, leaves)
        for name, g, w in zip(NAMES, got, want):
            _assert_close(g, w, f"{path} {name}")


def test_composite_grad_finite_difference():
    """The autograd Function's gradient against central differences, on
    broad splats that keep every pixel above the 1/255 alpha threshold (a
    pixel crossing it is a jump no difference quotient follows)."""
    rng = np.random.default_rng(0)
    t, k, d = 2, 8, 3
    means = torch.tensor(rng.uniform(0, 32, (t, 2, k)).astype(np.float32))
    means[:, 1] = torch.tensor(rng.uniform(0, 16, (t, k)).astype(np.float32))
    conics = torch.tensor([0.002, 0.0005, 0.003])[None, :, None].repeat(
        t, 1, k)
    colors = torch.tensor(rng.uniform(0, 1, (t, d, k)).astype(np.float32))
    opac = torch.tensor(rng.uniform(0.3, 0.7, (t, 1, k)).astype(np.float32))

    def f(m, c, o):
        out, acc = trp.composite_tiles(m, c, colors, o, 2)
        return (out.double() ** 2).sum() + acc.double().sum()

    leaves = [x.clone().requires_grad_() for x in (means, conics, opac)]
    grads = torch.autograd.grad(f(*leaves), leaves)
    for which, idx, eps in ((2, (0, 0, 0), 1e-2), (2, (1, 0, 3), 1e-2),
                            (0, (0, 0, 2), 5e-2), (0, (1, 1, 5), 5e-2),
                            (1, (0, 0, 1), 1e-4), (1, (1, 2, 6), 1e-4)):
        plus = [means, conics, opac]
        minus = [means, conics, opac]
        e = torch.zeros_like(plus[which])
        e[idx] = eps
        plus[which] = plus[which] + e
        minus[which] = minus[which] - e
        fd = (float(f(*plus)) - float(f(*minus))) / (2 * eps)
        np.testing.assert_allclose(float(grads[which][idx]), fd, rtol=2e-2,
                                   atol=2e-3)


def test_absgrad_seed_matches_tile_eps():
    """Per-gaussian |slot mean gradient| sums: the gather seed (kernel path)
    against the tile_eps side channel + absgrad_scatter (plain path) and
    against the JAX tile_eps path. Tolerance 1e-4: index_add_ sums in
    another order than JAX's scatter."""
    r, colors, opac, b = _binned(160, 13, 128, True)
    m2d, con = r.means2d[0], r.conics[0]
    n = m2d.shape[0]
    t, k = b.tile_lists.shape
    target = np.random.default_rng(2).uniform(0, 1, (H, W, 4))

    def jloss(eps):
        out = jraster(b.tile_lists, m2d, con, colors, opac, W, H,
                      b.num_tiles_x, tile_eps=eps)
        return jnp.mean((out.render - jnp.asarray(target)) ** 2)

    want = jabsgrad(jax.grad(jloss)(jnp.zeros((t, k, 2))), b.tile_lists, n)

    seed = torch.zeros((n, 2), requires_grad=True)
    eps = torch.zeros((t, k, 2), requires_grad=True)
    leaves = [_t(x).requires_grad_(True) for x in (m2d, con, colors, opac)]
    out = trp.rasterize_tiles_pallas(
        _t(b.tile_ranks), _t(b.order), *leaves, W, H, b.num_tiles_x,
        tile_counts=_t(b.tile_counts), absgrad_seed=seed)
    g = torch.autograd.grad(torch.mean((out.render - _t(target)) ** 2),
                            [seed, *leaves])
    plain = traster(_t(b.tile_lists), *leaves, W, H, b.num_tiles_x,
                    tile_eps=eps)
    g2 = torch.autograd.grad(torch.mean((plain.render - _t(target)) ** 2),
                             [eps, *leaves])
    by_eps = absgrad_scatter(g2[0], _t(b.tile_lists), n)
    assert (g[0] >= 0).all() and g[0].abs().sum() > 0
    np.testing.assert_allclose(g[0].numpy(), by_eps.numpy(), atol=1e-4,
                               rtol=1e-4)
    np.testing.assert_allclose(g[0].numpy(), np.asarray(want), atol=1e-4,
                               rtol=1e-4)
    for name, a, c in zip(NAMES, g[1:], g2[1:]):
        _assert_close(a, c, f"seeded vs tile_eps {name}")


def test_ranked_gather_vjp_matches_scatter():
    """The index_add_ VJP of the rank gather against JAX's id-space gather
    with a scatter-add VJP, on the JAX test's loss sum(sin(g) g)."""
    r, colors, opac, b = _binned(192, 11, 128, False)
    packed = jnp.concatenate([r.means2d[0], r.conics[0], colors,
                              opac[:, None]], axis=-1)

    def jloss(p):
        g = jgather_cm(p, b.tile_lists)
        return jnp.sum(jnp.sin(g) * g)

    jv, jg = jax.value_and_grad(jloss)(packed)
    p = _t(packed).requires_grad_(True)
    g = tile_gather_ranked(p, _t(b.order), _t(b.tile_ranks))
    loss = torch.sum(torch.sin(g) * g)
    (tg,) = torch.autograd.grad(loss, [p])
    np.testing.assert_allclose(float(loss.detach()), float(jv), rtol=1e-6)
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), atol=1e-4,
                               rtol=1e-4)
