"""PyTorch port vs the JAX package: the compositor (plain version on the
CPU) against the Pallas kernels in interpret mode and the XLA rasterizer,
K-chunking with saturated tiles, needle splats, and the naive oracle.

Tolerance 1e-4 abs: the reference's own on-chip forward parity bar."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qed_splatter_tpu.ops import rasterize_pallas as jrp
from qed_splatter_tpu.ops.naive import rasterize_naive as jnaive
from qed_splatter_tpu.ops.projection import project_gaussians as jproj
from qed_splatter_tpu.ops.rasterize import rasterize_tiles as jraster
from qed_splatter_tpu.ops.tiles import bin_gaussians as jbin
from qed_splatter_tpu.testing import random_scene, simple_camera
from qed_splatter_tpu_torch.ops import rasterize_pallas as trp
from qed_splatter_tpu_torch.ops.naive import rasterize_naive as tnaive
from qed_splatter_tpu_torch.ops.rasterize import rasterize_tiles as traster

W, H = 64, 48
TOL = 1e-4


def _t(x):
    return torch.tensor(np.asarray(x))


def _slabs(seed, t, d, k, num_tiles_x, needles=False):
    """Random channel-major slabs of splats around their tiles."""
    rng = np.random.default_rng(seed)
    tid = np.arange(t)
    ox = (tid % num_tiles_x) * 16.0
    oy = (tid // num_tiles_x) * 16.0
    means = np.stack([ox[:, None] + rng.uniform(-10, 26, (t, k)),
                      oy[:, None] + rng.uniform(-10, 26, (t, k))], 1)
    sx = rng.uniform(0.8, 6, (t, k))
    sy = rng.uniform(0.8, 6, (t, k))
    rho = rng.uniform(-0.8, 0.8, (t, k))
    if needles:  # long thin splats centred far outside the tile
        means[:, 0, ::3] += rng.choice([-1, 1], (t, (k + 2) // 3)) * 400
        sx[:, ::3] = 300.0
        sy[:, ::3] = 1.0
        rho[:, ::3] = rng.uniform(-0.02, 0.02, (t, (k + 2) // 3))
    det = (sx * sy) ** 2 * (1 - rho ** 2)
    conics = np.stack([sy * sy / det, -rho * sx * sy / det, sx * sx / det], 1)
    opac = rng.uniform(0.05, 0.99, (t, 1, k))
    opac[:, :, -k // 5:] = 0.0                      # padded tail
    colors = rng.uniform(0, 1, (t, d, k))
    if d == 4:
        colors[:, 3] = rng.uniform(1, 5, (t, k))     # depth channel
    return [a.astype(np.float32) for a in (means, conics, colors, opac)]


@pytest.mark.parametrize("d,k,needles", [(3, 128, False), (4, 256, False),
                                         (4, 128, True)])
def test_composite_matches_pallas_interpret(d, k, needles):
    ntx, t = 4, 12
    slabs = _slabs(d * k, t, d, k, ntx, needles)
    jo, ja = jrp.composite_tiles_pallas(*map(jnp.asarray, slabs), ntx, 16,
                                        True, False)
    to, ta = trp.composite_tiles(*map(_t, slabs), ntx)
    assert to.shape == (t, d, 256) and ta.shape == (t, 1, 256)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), atol=TOL)
    np.testing.assert_allclose(ta.numpy(), np.asarray(ja), atol=TOL)


def _counted(d, k, counts, ntx=3):
    """Slabs whose slots at and past each tile's count are padding as the
    binning leaves it (opacity 0)."""
    counts = np.asarray(counts, np.int32)
    slabs = _slabs(13 * d + k, len(counts), d, k, ntx)
    for i, c in enumerate(counts):
        slabs[3][i, 0, c:] = 0.0
    return slabs, counts


COUNTED = [(3, 128, [0, 1, 17, 128, 40, 300]),
           (4, 256, [256, 5, 0, 33, 255, 1000]),
           (1, 128, [128, 0, 50, 7, 127, 129])]


@pytest.mark.parametrize("d,k,counts", COUNTED)
def test_composite_stops_at_tile_counts(d, k, counts):
    """With ``tile_counts`` below K (0 and counts past K included) the plain
    compositor runs only the slots below each count. On slabs whose padding
    has opacity 0 that is what the JAX package computes, with and without
    the counts."""
    ntx = 3
    slabs, counts = _counted(d, k, counts)
    t = len(counts)
    jo, ja = jrp.composite_tiles_pallas(*map(jnp.asarray, slabs), ntx, 16,
                                        True, False)
    co, ca = jrp.composite_tiles_chunked(
        *map(jnp.asarray, slabs), ntx, 16, True, False,
        tile_counts=jnp.asarray(counts))
    runs = torch.empty(t, dtype=torch.int32)
    to, ta = trp.composite_tiles_ref(*map(_t, slabs), ntx,
                                     tile_counts=_t(counts), chunks_run=runs)
    fo, fa = trp.composite_tiles_chunked(*map(_t, slabs), ntx,
                                         tile_counts=_t(counts))
    assert torch.equal(to, fo) and torch.equal(ta, fa)
    assert runs.tolist() == [1] * t
    for want_o, want_a in ((jo, ja), (co, ca)):
        np.testing.assert_allclose(to.numpy(), np.asarray(want_o), atol=TOL)
        np.testing.assert_allclose(ta.numpy(), np.asarray(want_a), atol=TOL)
    empty = [i for i, c in enumerate(counts) if c == 0]
    assert not to[empty].any() and not ta[empty].any()
    # the counts alone decide: opacity left in the padding changes nothing
    loud = [s.copy() for s in slabs]
    for i, c in enumerate(counts):
        loud[3][i, 0, c:] = 0.7
    lo, la = trp.composite_tiles_ref(*map(_t, loud), ntx,
                                     tile_counts=_t(counts))
    assert torch.equal(lo, to) and torch.equal(la, ta)


@pytest.mark.parametrize("k_chunk", [0, 64])
def test_composite_never_reads_past_tile_counts(k_chunk):
    """NaN in the means, conics and colours at and past each tile's count
    (opacity 0, as the binning leaves it) never reaches the output, the
    chunks run or what the forward hands the backward."""
    ntx, d, k = 3, 4, 256
    slabs, counts = _counted(d, k, [256, 5, 0, 33, 100, 1000])
    t = len(counts)
    bad = [s.copy() for s in slabs]
    for i, c in enumerate(counts):
        for x in bad[:3]:
            x[i, :, c:] = np.nan
    res = []
    for these in (slabs, bad):
        runs = torch.empty(t, dtype=torch.int32)
        res.append((*trp.composite_tiles_ref(
            *map(_t, these), ntx, tile_counts=_t(counts), k_chunk=k_chunk,
            chunks_run=runs, tail=True), runs))
    for clean, poisoned in zip(*res):
        assert torch.isfinite(poisoned.float()).all()
        assert torch.equal(clean, poisoned)
    # without the counts the poison is composited
    out, _ = trp.composite_tiles_ref(*map(_t, bad), ntx, k_chunk=k_chunk)
    assert torch.isnan(out[1]).any()


def test_chunked_composite_matches_jax(monkeypatch):
    """K = 512 in chunks of 128 on both sides: tiles saturated in chunk 1,
    tiles whose count ends the list early, and live tiles."""
    monkeypatch.setattr(jrp, "K_CHUNK", 128)
    monkeypatch.setattr(trp, "K_CHUNK", 128)
    ntx, t, d, k = 3, 9, 4, 512
    means, conics, colors, opac = _slabs(7, t, d, k, ntx)
    opac *= 0.3
    sat = [0, 4]
    for i in sat:                                    # opaque stack up front
        means[i, 0, :8] = (i % ntx) * 16 + 8.0
        means[i, 1, :8] = (i // ntx) * 16 + 8.0
        conics[i, :, :8] = np.array([1e-6, 0.0, 1e-6])[:, None]
        opac[i, 0, :8] = 0.999
    counts = np.full(t, k, np.int32)
    counts[[1, 5]] = [100, 250]                      # ends in chunk 1 / 2
    for i, c in ((1, 100), (5, 250)):
        opac[i, 0, c:] = 0.0
    slabs = [means, conics, colors, opac]
    jo, ja = jrp.composite_tiles_chunked(
        *map(jnp.asarray, slabs), ntx, 16, True, False,
        tile_counts=jnp.asarray(counts))
    runs = torch.empty(t, dtype=torch.int32)
    to, ta = trp.composite_tiles_chunked(*map(_t, slabs), ntx,
                                         tile_counts=_t(counts),
                                         chunks_run=runs)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), atol=TOL)
    np.testing.assert_allclose(ta.numpy(), np.asarray(ja), atol=TOL)
    assert runs[sat].tolist() == [1, 1]
    assert runs[[1, 5]].tolist() == [1, 2]
    assert (runs[[2, 3, 6, 7, 8]] == 4).all()


def test_chunked_skip_never_reads_skipped_chunk():
    """The JAX test's poisoned second chunk: NaN colours after a saturated
    chunk (or past the tile count) never reach the output."""
    t, d, k = 2, 3, 2 * trp.K_CHUNK
    g_means = np.zeros((t, 2, k), np.float32)
    g_conics = np.zeros((t, 3, k), np.float32)
    g_colors = np.zeros((t, d, k), np.float32)
    g_opac = np.zeros((t, 1, k), np.float32)
    for i in range(8):
        g_means[0, :, i] = (8.0, 8.0)
        g_conics[0, :, i] = (1e-6, 0.0, 1e-6)
        g_colors[0, :, i] = (0.5, 0.2, 0.1)
        g_opac[0, 0, i] = 0.999
    g_means[:, :, trp.K_CHUNK] = (8.0, 8.0)
    g_conics[:, :, trp.K_CHUNK] = (1e-6, 0.0, 1e-6)
    g_colors[:, :, trp.K_CHUNK] = np.nan
    g_opac[:, 0, trp.K_CHUNK] = 0.5
    slabs = list(map(_t, (g_means, g_conics, g_colors, g_opac)))
    out, acc = trp.composite_tiles_chunked(*slabs, 2)
    assert torch.isfinite(out[0]).all()
    assert torch.allclose(acc[0], torch.ones(1), atol=1e-2)
    assert torch.isnan(out[1]).any()
    out2, _ = trp.composite_tiles_chunked(
        *slabs, 2, tile_counts=torch.tensor([k, trp.K_CHUNK - 1],
                                            dtype=torch.int32))
    assert torch.isfinite(out2).all()


def test_composite_checks_inputs():
    slabs = list(map(_t, _slabs(0, 2, 3, 128, 2)))
    with pytest.raises(TypeError):
        trp.composite_tiles(slabs[0].double(), *slabs[1:], 2)
    with pytest.raises(ValueError):
        trp.composite_tiles(slabs[0][:, :, :64], *slabs[1:], 2)
    with pytest.raises(ValueError):
        trp.composite_tiles_chunked(*slabs, 2,
                                    tile_counts=torch.zeros(2))


def _binned(n, seed, k, with_depth):
    s = random_scene(n=n, seed=seed)
    vm, K = simple_camera(W, H, 60.0)
    r = jproj(*(jnp.asarray(s[f]) for f in ("means", "quats", "scales")),
              jnp.asarray(vm), jnp.asarray(K), W, H)
    colors = jnp.asarray(s["colors"])
    if with_depth:
        colors = jnp.concatenate([colors, r.depths[0][:, None]], -1)
    b = jbin(r.means2d[0], r.radii[0], r.depths[0], W, H, max_per_tile=k,
             with_slab_plan=False)
    return r, colors, jnp.asarray(s["opacities"]), b


@pytest.mark.parametrize("with_depth", [False, True])
def test_rasterize_paths_match_jax(with_depth):
    r, colors, opac, b = _binned(192, 0, 128, with_depth)
    args = (b.tile_lists, r.means2d[0], r.conics[0], colors, opac, W, H,
            b.num_tiles_x)
    want = jraster(*args)
    want_pal = jrp.rasterize_tiles_pallas(*args, interpret=True)
    t_args = [_t(a) for a in args[:5]] + list(args[5:])
    plain = traster(*t_args)
    by_rank = trp.rasterize_tiles_pallas(
        _t(b.tile_ranks), _t(b.order), *t_args[1:],
        tile_counts=_t(b.tile_counts))
    for got in (plain, by_rank):
        for ref in (want, want_pal):
            np.testing.assert_allclose(got.render.numpy(),
                                       np.asarray(ref.render), atol=TOL)
            np.testing.assert_allclose(got.alpha.numpy(),
                                       np.asarray(ref.alpha), atol=TOL)


def test_naive_matches_jax_and_tiles():
    r, colors, opac, b = _binned(96, 5, 128, False)
    args = (r.means2d[0], r.conics[0], colors, opac, r.depths[0], r.radii[0])
    want = jnaive(*args, W, H)
    got = tnaive(*map(_t, args), W, H)
    np.testing.assert_allclose(got.render.numpy(), np.asarray(want.render),
                               atol=TOL)
    np.testing.assert_allclose(got.alpha.numpy(), np.asarray(want.alpha),
                               atol=TOL)
