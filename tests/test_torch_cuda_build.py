"""The build cache of the hand-written CUDA kernels and the source patches of
the kernel variants tool, on the CPU: neither needs nvcc.

A kernel's library is named by a hash of its source, of the headers it may
include and of the flags, so an edit to a header (``csrc/mixed.cuh``, which
both mixed kernels include) builds anew instead of loading a stale library.
"""

import sys
from pathlib import Path

import pytest

from qed_splatter_tpu_torch import cuda as qcuda

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture
def csrc(tmp_path, monkeypatch):
    """A temporary ``csrc/`` with one source that includes one header."""
    (tmp_path / "k.cu").write_text('#include "h.cuh"\nint f() { return K; }\n')
    (tmp_path / "h.cuh").write_text("constexpr int K = 1;\n")
    monkeypatch.setattr(qcuda, "CSRC", tmp_path)
    monkeypatch.setattr(qcuda, "BUILD_DIR", tmp_path / "build")
    return tmp_path


def test_header_edit_changes_the_library_name(csrc):
    first = qcuda._lib_path("k")
    assert first == qcuda._lib_path("k")
    assert first.parent == csrc / "build" and first.name.startswith("libk-")
    (csrc / "h.cuh").write_text("constexpr int K = 2;\n")
    second = qcuda._lib_path("k")
    assert second != first
    (csrc / "other.cuh").write_text("// a new header\n")
    assert qcuda._lib_path("k") != second
    assert qcuda._lib_path("k", ("-DX=1",)) != qcuda._lib_path("k")


def test_header_beside_a_copied_source_is_hashed(csrc):
    """A copy under ``build/`` with a header of its own: the copy's header
    is in its name, the unpatched header of ``csrc/`` too."""
    sub = csrc / "build" / "variants" / "abc"
    sub.mkdir(parents=True)
    (sub / "k.cu").write_text((csrc / "k.cu").read_text())
    (sub / "h.cuh").write_text("constexpr int K = 1;\n")
    name = "build/variants/abc/k"
    first = qcuda._lib_path(name)
    assert first != qcuda._lib_path("k")      # the copy's header is hashed
    (sub / "h.cuh").write_text("constexpr int K = 3;\n")
    assert qcuda._lib_path(name) != first


def test_nvcc_is_given_the_csrc_include_path(csrc, monkeypatch):
    """``build`` runs one nvcc per source with ``-I csrc/``, so a copy of a
    source elsewhere still finds the headers."""
    calls = []

    class Proc:
        returncode = 1

        def __init__(self, cmd, **kwargs):
            calls.append(cmd)

        def communicate(self):
            return "", None

    monkeypatch.setattr(qcuda, "_nvcc", lambda: "nvcc")
    monkeypatch.setattr(qcuda.subprocess, "Popen", Proc)
    with pytest.raises(RuntimeError, match="nvcc failed"):
        qcuda.build(["k"])
    (cmd,) = calls
    assert cmd[cmd.index("-I") + 1] == str(csrc)
    assert cmd[-1] == str(csrc / "k.cu")


@pytest.fixture
def variants(csrc):
    sys.path.insert(0, str(ROOT / "tools"))
    try:
        import torch_kernel_variants
    finally:
        sys.path.remove(str(ROOT / "tools"))
    return torch_kernel_variants


def test_variant_patches_reach_the_header(csrc, variants):
    """A patch applies to whichever of the source and its headers holds its
    text once; the copy keeps both files side by side."""
    assert variants.patched_source("k", ()) == "k"
    name = variants.patched_source("k", (("K = 1", "K = 5"),))
    copy = csrc / f"{name}.cu"
    assert copy.read_text() == (csrc / "k.cu").read_text()
    assert (copy.parent / "h.cuh").read_text() == "constexpr int K = 5;\n"
    other = variants.patched_source("k", (("return K", "return 2 * K"),))
    assert other != name
    assert "2 * K" in (csrc / f"{other}.cu").read_text()
    assert (csrc / other).parent.joinpath("h.cuh").read_text() == \
        "constexpr int K = 1;\n"
    with pytest.raises(ValueError, match="not once"):
        variants.patched_source("k", (("K", "J"),))
    with pytest.raises(ValueError, match="not once"):
        variants.patched_source("k", (("absent", ""),))


def test_mixed_variants_patch_the_shipped_sources(variants):
    """Every patch of FWD_MIX_VARIANTS and MIX_VARIANTS matches the shipped
    composite.cu / composite_bwd.cu and mixed.cuh exactly once."""
    csrc = ROOT / "qed_splatter_tpu_torch" / "csrc"
    for name, table in (("composite", variants.FWD_MIX_VARIANTS),
                        ("composite_bwd", variants.MIX_VARIANTS)):
        texts = [(csrc / f"{name}.cu").read_text(),
                 (csrc / "mixed.cuh").read_text()]
        for label, patches, _ in table:
            for old, _new in patches:
                assert sum(t.count(old) for t in texts) == 1, (name, label,
                                                               old)
