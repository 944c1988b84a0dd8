"""The ports of the JAX round's gather microbenchmarks
(``qed_splatter_tpu_torch/tools/bench_gather.py`` and ``bench_gather3.py``)
and of their two Pallas kernels, on the CPU: the plain versions of kernel
#6 (the slab window gather on 4-byte keys, ``ops/tiles.py``) and #7 (the
identity copy, ``ops/copy_rows.py``) against ``jax.lax.gather`` and the
identity, and every formulation the JAX tools time present under its name.
The kernels themselves run on the card (``tests/test_torch_cuda.py``)."""

import ast
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qed_splatter_tpu_torch.ops import tiles
from qed_splatter_tpu_torch.ops.copy_rows import copy_rows, copy_rows_ref
from qed_splatter_tpu_torch.tools import bench_gather, bench_gather3

ROOT = Path(__file__).resolve().parents[1]


def _timed_names(path):
    """The names the JAX tool passes to its timer ``t(name, ...)``."""
    names = []
    for node in ast.walk(ast.parse(path.read_text())):
        if (isinstance(node, ast.Call) and isinstance(node.func, ast.Name)
                and node.func.id == "t" and node.args
                and isinstance(node.args[0], ast.Constant)):
            names.append(node.args[0].value)
    return names


@pytest.mark.parametrize("k", [256, 100])
def test_slab_gather_4_byte_plain_matches_lax_gather(k):
    """#6's plain version (what the wrapper runs on CPU tensors) against the
    JAX tool's ``slab_xla``: ``lax.gather`` of K-wide windows, CLIP mode,
    on sorted uint32 keys whose values are below 2^31."""
    rng = np.random.default_rng(k)
    m, t = 5000, 37
    pairs = np.sort(rng.integers(0, 2 ** 31, m).astype(np.uint32))
    starts = np.sort(rng.integers(0, m - k, t))
    starts[:2] = [0, m - k]
    want = jax.lax.gather(
        jnp.asarray(pairs), jnp.asarray(starts.astype(np.int32))[:, None],
        jax.lax.GatherDimensionNumbers(offset_dims=(1,),
                                       collapsed_slice_dims=(),
                                       start_index_map=(0,)),
        slice_sizes=(k,), mode=jax.lax.GatherScatterMode.CLIP)
    keys = torch.as_tensor(pairs.astype(np.int32))
    st = torch.as_tensor(starts.astype(np.int64))
    before = tiles.SLAB_GATHER32.launches
    got = tiles.slab_gather(keys, st, k, 0)
    assert got.dtype == torch.int32 and tuple(got.shape) == (t, k)
    np.testing.assert_array_equal(got.numpy().astype(np.uint32),
                                  np.asarray(want))
    assert torch.equal(got, tiles.slab_gather_ref(keys, st, k, 0))
    assert torch.equal(got, bench_gather.slab_library(keys, st, k))
    assert tiles.SLAB_GATHER32.launches == before   # the CPU launches none


def test_slab_gather_4_byte_refuses_rank_mode():
    keys = torch.arange(10, dtype=torch.int32)
    with pytest.raises(TypeError, match="int32 keys in its gather mode"):
        tiles.slab_ranks(keys, torch.zeros(2, dtype=torch.int64),
                         torch.ones(2, dtype=torch.int32), 4, 3)


@pytest.mark.parametrize("shape", [(327, 10), (4096, 10), (13,)])
def test_copy_rows_is_the_identity(shape):
    """#7's plain version against the JAX tool's Pallas copy: the identity
    (``pallas_copy`` pads, copies blocks and slices the padding off)."""
    x = torch.as_tensor(np.random.default_rng(0).uniform(
        0, 1, shape).astype(np.float32))
    y = copy_rows(x)
    assert torch.equal(y, x) and y.data_ptr() != x.data_ptr()
    np.testing.assert_array_equal(copy_rows_ref(x).numpy(),
                                  np.asarray(jnp.asarray(x.numpy())))
    with pytest.raises(TypeError, match="float32"):
        copy_rows(x.double())


@pytest.mark.parametrize("tool,port", [
    ("tools/bench_gather.py", bench_gather),
    ("tools/bench_gather3.py", bench_gather3)])
def test_tools_time_every_formulation_of_the_jax_tools(tool, port):
    """A CPU rehearsal of each tool (one call per formulation, no time)
    names every formulation its JAX tool times, and its kernel rows."""
    kw = {"sizes": (4096, 20_000)} if port is bench_gather3 else {}
    lines = []
    times = port.run("cpu", log=lines.append, **kw)
    want = _timed_names(ROOT / tool)
    assert want and set(want) <= set(times), set(want) - set(times)
    assert len(lines) == len(times)
    extra = ({"slab_pallas_dma_plain", "slab_pallas_dma_library"}
             if port is bench_gather else
             {f"copy_{s}{x}" for s in ("327k", "4p4M")
              for x in ("", "_plain", "_library")})
    assert set(times) == set(want) | extra


def test_tool_inputs_are_the_jax_tools_draws():
    """The slab inputs come from the JAX tool's generator in its order:
    seeded 0, after its row gathers' draws."""
    rng = np.random.default_rng(0)
    rng.uniform(-1, 1, (bench_gather.N, bench_gather.C))
    rng.uniform(-1, 1, (bench_gather.N, 16))
    rng.integers(0, bench_gather.N, bench_gather.T_TILES * bench_gather.K_CAP)
    rng.permutation(bench_gather.N)
    pairs = np.sort(rng.integers(0, 2 ** 31, bench_gather.M_PAIRS)
                    .astype(np.uint32))
    starts = np.sort(rng.integers(0, bench_gather.M_PAIRS - bench_gather.K_CAP,
                                  bench_gather.T_TILES))
    keys, st = bench_gather.slab_case("cpu")
    np.testing.assert_array_equal(keys.numpy().astype(np.uint32), pairs)
    np.testing.assert_array_equal(st.numpy(), starts)
