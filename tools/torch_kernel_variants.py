#!/usr/bin/env python3
"""Time tuning variants of the PyTorch port's CUDA kernels on one GPU.

    python3 tools/torch_kernel_variants.py [--seed 0] [--out FILE.json]
                                           [--one-sweep] [--kernels LIST]
                                           [--parent DIR] [--sass DIR]

The kernels take their tuning constants from ``-D`` flags
(``csrc/composite.cu``: ``QED_FWD_PIX`` pixels per thread, ``QED_FWD_BATCH``
slots staged at a time, ``QED_FWD_CULL`` the warp cull before the exp,
``QED_FWD_FASTEXP`` ``__expf`` for ``expf``, ``QED_FWD_UNROLL`` slots per
trip of the depth loop; ``csrc/composite_bwd.cu``: ``QED_BWD_PIX`` pixels
per thread, ``QED_BWD_GROUP`` slots per warp reduction, ``QED_BWD_FASTDIV``;
``csrc/slab_gather.cu``: ``QED_SLAB_PAIRS`` 16-byte pairs per thread). The
mixed_precision kernels (``composite.cu``'s ``composite_mixed_kernel``,
``composite_bwd.cu``'s ``composite_bwd_mixed_kernel``) have no tuning flags
but the witness build ``QED_MIX_WITNESS=1`` (the intrinsics in place of
``csrc/mixed.cuh``'s exact forms): their variants are the build with one
step of its design undone, each written here as a patch of the text of the
source and of the headers it includes (FWD_MIX_VARIANTS, MIX_VARIANTS; a
patch whose text is not in those files exactly once fails), built from a
copy in a directory of its own under ``csrc/build/variants/``. This script
builds each variant beside the default build, runs it on the inputs of one
training step of ``chip_smoke.py``'s scene A (80k alive, K=256) and scene B
(288k alive, K=2048) at 1296x840 (float32; the mixed kernels on the state
``chip_smoke.py``'s mixed phase holds them on, beside the float32 kernel on
the same slabs, the forward with its handoff), holds it against the default
build's result (and the mixed kernels against their plain versions), and
prints one JSON line per variant with its CUDA-event time and, where nvcc
built it in this run, the registers, spills and blocks per SM of its
kernels. The mixed forward's builds are timed twice each, in turns, and
``--parent DIR`` (another tree's ``csrc/``) times that tree's mixed forward
beside them; ``--sass DIR`` writes the SASS (``cuobjdump -sass``) of the
default, witness and parent builds there and prints each D = 4 kernel's
opcode counts. The forward is timed
without and with the handoff to the backward. Its ``__expf`` variant is
measured only: its line counts the pixels that an alpha mask which flips
against ``expf`` moves by more than rounding (1e-4) on the step's slabs. The
identity copy (#7) is timed by CUDA-graph replays at the copy tool's two
shapes ([327,680, 10] and [4,396,032, 10] float32), into a new tensor and
into a preallocated one, beside ``Tensor.copy_`` and ``clone``. The window
gather runs on sorted random keys at each scene's tiles and K: the step
itself gathers no windows.
``--kernels`` (a comma list of composite, composite_bwd, composite_mixed,
composite_bwd_mixed, slab_gather, copy_rows) times only those.

``--one-sweep`` measures instead why the backward carries what lies behind
each slot back to front and takes T from the forward, not R_k = S -
prefix_k: on ``chip_smoke.py``'s chunked slabs with opaque stacks and on
each step's own slabs it prints the error of the kernel and of that
one-sweep form (plain PyTorch, S = gout . out + gacc acc from the forward
kernel's outputs) against the plain backward and a float64 autograd, as the
worst channel's max |err| over max |grad| and as the share of elements
outside ``atol=5e-5, rtol=1e-3``.

Needs CUDA and nvcc; imports no JAX.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import re
import statistics
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke  # noqa: E402
from qed_splatter_tpu_torch import cuda as qcuda  # noqa: E402
from qed_splatter_tpu_torch.cuda import CudaKernel, ptr  # noqa: E402

# (pixels per thread, batch length, cull, fastexp, unroll); the default first
FWD_VARIANTS = [(2, 256, 1, 0, 4), (1, 256, 1, 0, 4), (4, 256, 1, 0, 4),
                (4, 64, 1, 0, 4), (2, 64, 1, 0, 4), (2, 128, 1, 0, 4),
                (2, 256, 1, 0, 1), (2, 256, 1, 0, 2), (2, 256, 1, 0, 8),
                (2, 256, 0, 0, 4), (1, 256, 0, 0, 4), (4, 256, 0, 0, 4),
                (2, 256, 1, 1, 4)]
BWD_VARIANTS = [(2, 4, 0), (1, 4, 0), (1, 8, 0), (2, 2, 0), (2, 8, 0),
                (4, 2, 0), (4, 4, 0), (2, 4, 1)]
SLAB_VARIANTS = [4, 1, 2, 8]
# the mixed forward (composite.cu's composite_mixed_kernel): (label,
# patches of the text of composite.cu and mixed.cuh as (old, new),
# defines); the default build first, then each step of its design undone,
# then the steps that were tried and not kept, then other shapes, then the
# witness build with the intrinsics


def _bits(x):
    """bf16 rounding of the float ``x`` on its bits, in place: u + 0x7fff +
    bit 16 of u with the low half cleared, nearest even for a finite x."""
    u = f"__float_as_uint({x})"
    return (f"{x} = __uint_as_float(({u} + 0x7fffu + (({u} >> 16) & 1u)) & "
            "0xffff0000u);")


_LOGF = ("return log_normal(one_minus_alpha);",
         "return logf(one_minus_alpha);")
_ALPHA = """        const float alpha = keep ? fminf(a_raw, alpha_max) : 0.0f;
        const float l = mix_log(1.0f - alpha);"""
_TWO_BLOCKS = (
    ("__shared__ Slot s_slot[2][kMixBlock];",
     "__shared__ Slot s_slot[2][2 * kMixBlock];"),
    ("return min(kMixBlock - s % kMixBlock, n_t - s);",
     "return min(2 * kMixBlock, min(n_t - s, chunk_len - s % chunk_len));"),
    ("constexpr int kMixStage = (kMixBlock + kMixThreads - 1)",
     "constexpr int kMixStage = (2 * kMixBlock + kMixThreads - 1)"),
    ("#pragma unroll kMixUnroll\n    for (int j = 0; j < n; ++j) {",
     "for (int j0 = 0; j0 < n; j0 += kMixBlock) {\n#pragma unroll kMixUnroll"
     "\n    for (int j = j0; j < min(j0 + kMixBlock, n); ++j) {"),
    ("const int b = s / kMixBlock;", "const int b = (s + j0) / kMixBlock;"),
    ("      units[q] = 0;\n    }\n", "      units[q] = 0;\n    }\n    }\n"))
_KEEP = """#pragma unroll
      for (int q = 0; q < kMixPix; ++q) {
        const float a_raw = sb.y * expf(-sigma[q]);
        const bool keep = (sigma[q] >= 0.0f) && (a_raw > alpha_eps);
        const float alpha = keep ? fminf(a_raw, alpha_max) : 0.0f;
"""
_KEEP_WARP = """      float alphas[kMixPix];
      bool kept = false;
#pragma unroll
      for (int q = 0; q < kMixPix; ++q) {
        const float a_raw = sb.y * expf(-sigma[q]);
        const bool keep = (sigma[q] >= 0.0f) && (a_raw > alpha_eps);
        alphas[q] = keep ? fminf(a_raw, alpha_max) : 0.0f;
        kept = kept || keep;
      }
      if (!__any_sync(kFull, kept)) continue;
#pragma unroll
      for (int q = 0; q < kMixPix; ++q) {
        const float alpha = alphas[q];
"""
_ROUND = ("const float rb = round_bf16(l);\n"
          "        const float wb = round_bf16(w);")
WITNESS = ("-DQED_MIX_WITNESS=1",)
FWD_MIX_VARIANTS = [
    ("default", (), ()),
    ("logf itself", (_LOGF,), ()),
    ("E by __int2float_rn of the block's units",
     (("const float e = e_off[q] + esum[q];",
       "const float e = e_off[q] + __int2float_rn(units[q]) * kMixUnit;"),),
     ()),
    ("the int of bf16(l) by __float2int_rn",
     (("units[q] += mix_units(rb);",
       "units[q] += __float2int_rn(rb * kMixScale);"),), ()),
    ("unroll 2", (("constexpr int kMixUnroll = 4;",
                   "constexpr int kMixUnroll = 2;"),), ()),
    ("with l and w rounded to bf16 as one pair",
     ((_ROUND, "const __nv_bfloat162 lw = __floats2bfloat162_rn(l, w);\n"
       "        const float rb = __low2float(lw), wb = __high2float(lw);"),),
     ()),
    ("with bf16 rounding on the bits",
     ((_ROUND, "float rb = l, wb = w;\n        " + _bits("rb")
       + "\n        " + _bits("wb")),), ()),
    ("with the log's exponent by the magic number",
     (("  return __fmaf_rn(__fmul_rn(__int2float_rn(e), "
       "1.1920928955078125e-07f),\n",
       "  return __fmaf_rn(__fadd_rn(__int_as_float(((bits - 0x3f2aaaab) >> "
       "23) + 0x4b400000), -12582912.0f),\n"),), ()),
    ("with a warp test after the exact keep", ((_KEEP, _KEEP_WARP),), ()),
    ("with a warp test per pixel after the exact keep",
     ((_ALPHA, "        const float alpha = keep ? fminf(a_raw, alpha_max) "
       ": 0.0f;\n        if (!__any_sync(kFull, alpha > 0.0f)) continue;\n"
       "        const float l = mix_log(1.0f - alpha);"),), ()),
    ("with the registers bounded to 8 blocks per SM",
     (("__launch_bounds__(kMixThreads)", "__launch_bounds__(kMixThreads, 8)"),
      ), ()),
    ("with two blocks a batch", _TWO_BLOCKS, ()),
    ("one pixel a thread", (("constexpr int kMixPix = 2;",
                             "constexpr int kMixPix = 1;"),), ()),
    ("four pixels a thread", (("constexpr int kMixPix = 2;",
                               "constexpr int kMixPix = 4;"),), ()),
    ("the witness build", (), WITNESS),
]
# the mixed backward: (label, patches of composite_bwd.cu's and mixed.cuh's
# text as (old, new), defines); the default build first, then each step of
# the design undone, then other shapes
_MIX_BLOCKS = ("__launch_bounds__(kThreads, kMixMinBlocks)",
               "__launch_bounds__(kThreads)")
_MIX_GROUP = ("constexpr int kGroupM = 4;", "constexpr int kGroupM = 2;")
MIX_VARIANTS = [
    ("default", (), ()),
    ("no warp cull before the exp",
     (("bool on = __any_sync(kFull, near);", "bool on = true;"),), ()),
    ("the chunked instantiation for unchunked tiles too",
     (("k_chunk > 0 ? composite_bwd_mixed_kernel<D, true>",
       "true ? composite_bwd_mixed_kernel<D, true>"),), ()),
    ("the exact division",
     (("behind[q] * rcp_approx(om)", "__fdiv_rn(behind[q], om)"),), ()),
    ("logf itself", (_LOGF,), ()),
    ("the int of bf16(l) by __float2int_rn",
     (("units[q] -= mix_units(round_bf16(l));",
       "units[q] -= __float2int_rn(round_bf16(l) * kMixScale);"),), ()),
    ("the witness build", (), WITNESS),
    ("no bound on the registers", (_MIX_BLOCKS,), ()),
    ("two slots a warp reduction", (_MIX_GROUP,), ()),
    ("four pixels a thread", (), ("-DQED_BWD_PIX=4",)),
]
KERNELS = ("composite", "composite_bwd", "composite_mixed",
           "composite_bwd_mixed", "slab_gather", "copy_rows")


def fwd_defines(pix, batch, cull, fastexp, unroll):
    return (f"-DQED_FWD_PIX={pix}", f"-DQED_FWD_BATCH={batch}",
            f"-DQED_FWD_CULL={cull}", f"-DQED_FWD_FASTEXP={fastexp}",
            f"-DQED_FWD_UNROLL={unroll}")


def bwd_defines(pix, group, fastdiv):
    return (f"-DQED_BWD_PIX={pix}", f"-DQED_BWD_GROUP={group}",
            f"-DQED_BWD_FASTDIV={fastdiv}")


def slab_defines(pairs):
    return (f"-DQED_SLAB_PAIRS={pairs}",)


def patched_source(name, patches, csrc=None):
    """The name (relative to ``csrc/``, as :class:`CudaKernel` takes it) of
    a copy of ``<csrc>/<name>.cu`` and of the headers ``<csrc>/*.cuh`` it
    includes, in a directory of their own under ``csrc/build/variants/``,
    with each ``(old, new)`` patch applied to whichever of those files holds
    ``old`` (it must occur exactly once among them); the source itself
    without patches. ``csrc`` (default: the package's ``csrc/``) copies
    another tree's sources instead."""
    src = Path(csrc) if csrc is not None else qcuda.CSRC
    if not patches and src == qcuda.CSRC:
        return name
    texts = {f"{name}.cu": (src / f"{name}.cu").read_text()}
    texts.update((h.name, h.read_text()) for h in sorted(src.glob("*.cuh")))
    for old, new in patches:
        where = [f for f, text in texts.items() if old in text]
        found = sum(texts[f].count(old) for f in where)
        if found != 1:
            raise ValueError(f"{name}.cu and its headers hold {old!r} "
                             f"{found} times, not once")
        texts[where[0]] = texts[where[0]].replace(old, new)
    digest = hashlib.sha256(json.dumps(texts, sort_keys=True).encode()
                            ).hexdigest()[:12]
    out_dir = qcuda.BUILD_DIR / "variants" / digest
    out_dir.mkdir(parents=True, exist_ok=True)
    for f, text in texts.items():
        (out_dir / f).write_text(text)
    return f"build/variants/{digest}/{name}"


def step_inputs(n_alive, capacity, k_cap, seed, mixed=False):
    """The arguments one training step gives the forward kernel and the
    backward kernel, captured from the step itself;
    ``mixed``: the step of ``mixed_precision`` on the state on which
    ``chip_smoke.py``'s mixed phase holds its kernels, whose backward's
    forward's and backward's arguments (those of
    ``composite_tiles_fwd_mixed`` and ``composite_tiles_bwd_mixed``) are
    returned."""
    from qed_splatter_tpu_torch.configs import ModelConfig, \
        default_optimizers
    from qed_splatter_tpu_torch.engine.optim import GroupOptimizers
    from qed_splatter_tpu_torch.engine.train_step import init_train_state, \
        make_train_step
    from qed_splatter_tpu_torch.ops import rasterize_pallas as rp
    from qed_splatter_tpu_torch.ops import tiles

    params = chip_smoke.make_scene(n_alive, capacity, seed)
    batch = chip_smoke.train_batch(np.random.default_rng(seed))
    cfg = ModelConfig(camera_opt_mode="SO3xR3", max_per_tile=k_cap,
                      background_color="random", mixed_precision=mixed)
    optims = GroupOptimizers(default_optimizers())
    state = init_train_state(params, optims, num_cameras=4)
    step = make_train_step(cfg, optims, chip_smoke.W, chip_smoke.H,
                           has_depth=True)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    if mixed:           # the state chip_smoke.py's mixed phase times on
        del state
        state = chip_smoke.spread_state(n_alive, capacity, seed, optims)
        with chip_smoke.Capture(rp, "composite_tiles_fwd_mixed") as cap_f, \
                chip_smoke.Capture(rp, "composite_tiles_bwd_mixed") as cap_m:
            step.grads(state, batch, chip_smoke.background_generator(seed))
        torch.cuda.synchronize()
        return [[x.detach() if torch.is_tensor(x) else x for x in cap.args]
                for cap in (cap_f, cap_m)]
    with chip_smoke.Capture(rp, "composite_tiles_bwd") as cap_b, \
            chip_smoke.Capture(rp, "composite_tiles_fwd") as cap_f:
        step.grads(state, batch, gen)
    torch.cuda.synchronize()
    return cap_f.args, cap_b.args


def run_fwd(kernel, args, tail=False):
    """One launch of a build of the forward kernel on the arguments of
    ``composite_tiles_fwd``. Returns [out, acc, chunks run] and, with
    ``tail``, t_last and cut."""
    slabs, ntx, _, counts, k_chunk = args[:4], *args[4:8]
    t, d, k = slabs[2].shape
    outs = [torch.empty((t, c, 256), device="cuda") for c in (d, 1)]
    outs.append(torch.empty(t, dtype=torch.int32, device="cuda"))
    null = ctypes.c_void_p(None)
    tails = [null, null]
    if tail:
        outs += [torch.empty((t, 1, 256), device="cuda"),
                 torch.empty((t, 1, 256), dtype=torch.int32, device="cuda")]
        tails = [ptr(x) for x in outs[3:]]
    kernel(*(ptr(x.contiguous()) for x in slabs), ptr(counts),
           *(ptr(x) for x in outs[:3]), *tails, t, k, d, ntx, k_chunk, 1e-4)
    return outs


def run_bwd(kernel, args):
    slabs, gout, gacc = args[:4], args[4], args[5]
    ntx, _, k_chunk, runs, counts, t_last, cut = args[6:13]
    t, d, k = slabs[2].shape
    ins = [x.contiguous() for x in (*slabs, gout, gacc, runs, counts, t_last,
                                    cut)]
    grads = [torch.empty_like(x) for x in ins[:4]]
    kernel(*(ptr(x) for x in ins), *(ptr(x) for x in grads), t, k, d, ntx,
           k_chunk)
    return grads


def run_bwd_mixed(kernel, args):
    """One launch of a build of the mixed backward on the arguments of
    ``composite_tiles_bwd_mixed``."""
    slabs, gout, gacc = args[:4], args[4], args[5]
    ntx, _, k_chunk, runs, counts, handoff = args[6:12]
    t, d, k = slabs[2].shape
    ins = [x.contiguous() for x in (*slabs, gout, gacc, runs, counts,
                                    *handoff)]
    grads = [torch.empty_like(x) for x in ins[:4]]
    kernel(*(ptr(x) for x in ins), *(ptr(x) for x in grads), t, k, d, ntx,
           k_chunk)
    return grads


def kernel_names(symbols):
    """``name<template args>`` of each mangled kernel symbol, demangled by
    binutils' c++filt."""
    lines = subprocess.run(["c++filt"], input="\n".join(symbols),
                           capture_output=True, text=True, timeout=60,
                           check=True).stdout.splitlines()
    return [re.search(r"(\w+(?:<[^()]*>)?)\(", line).group(1)
            for line in lines]


def kernel_resources(build):
    """{kernel<template args>: registers, spill store bytes, static shared
    memory and blocks per SM} of one build, from nvcc's -Xptxas -v output;
    empty when the build came from the cache. Blocks per SM: the least of
    the register file (65,536, allocated 256 a warp at a time), 64 warps,
    32 blocks and 228 KB of shared memory (1 KB reserved per block), at 128
    threads a block (256 for the copy's scalar kernel, 32 for its bulk
    kernel with 64 KB of dynamic shared memory)."""
    log = qcuda.BUILD_LOGS.get(build, "").splitlines()
    symbols = [line.split("'")[1] for line in log
               if "Compiling entry function" in line]
    names = iter(kernel_names(symbols) if symbols else ())
    out, name = {}, None
    for line in log:
        if "Compiling entry function" in line:
            name = next(names)
            out[name] = {}
        elif name and "spill stores" in line:
            out[name]["spill_store_bytes"] = int(
                line.split("stack frame,")[1].split()[0])
        elif name and "Used" in line and "registers" in line:
            regs = int(line.split("Used")[1].split()[0])
            smem = re.search(r"(\d+) bytes smem", line)
            out[name]["registers"] = regs
            out[name]["smem_bytes"] = int(smem.group(1)) if smem else 0
    for name, r in out.items():
        if "registers" not in r:
            continue
        threads = 128
        dyn = 0
        if name.startswith("copy_bulk"):
            threads, dyn = 32, 4 * 16384
        elif name.startswith("copy_"):
            threads = 256
        warps = threads // 32
        per_warp = -(-r["registers"] * 32 // 256) * 256
        by_smem = (228 * 1024) // (r["smem_bytes"] + dyn + 1024)
        r["blocks_per_sm"] = min(65536 // (per_warp * warps), 64 // warps,
                                 32, by_smem)
    return out


def d4_resources(build):
    """:func:`kernel_resources` of the D = 4 kernels of one build."""
    return {name: r for name, r in kernel_resources(build).items()
            if name.split("<")[1].startswith("4")}


def fwd_rows(label, f_args):
    """One row per forward variant on one step's slabs."""
    from qed_splatter_tpu_torch.ops import rasterize_pallas as rp

    def kernel(defines):
        return CudaKernel("composite", rp.COMPOSITE.symbol,
                          rp.COMPOSITE.argtypes[:-1], defines)

    rows = []
    base = kernel(fwd_defines(*FWD_VARIANTS[0]))
    want = run_fwd(base, f_args)
    for variant in FWD_VARIANTS:
        defines = fwd_defines(*variant)
        kern = kernel(defines)
        got = run_fwd(kern, f_args)
        row = dict(zip(("pix", "batch", "cull", "fastexp", "unroll"),
                       variant))
        row = {"kernel": "composite", "scene": label, **row,
               "resources": d4_resources(" ".join(("composite", *defines)))}
        row["ms"] = chip_smoke.cuda_ms(lambda: run_fwd(kern, f_args), 20)
        row["ms_with_handoff"] = chip_smoke.cuda_ms(
            lambda: run_fwd(kern, f_args, tail=True), 20)
        row["exact"] = all(torch.equal(g, w) for g, w in zip(got, want))
        row["err_vs_default"] = max(chip_smoke.max_abs(g, w)
                                    for g, w in zip(got[:2], want[:2]))
        if variant[3]:      # what a flipped mask moves: far above rounding
            off = ((got[0] - want[0]).abs().amax(1, keepdim=True) > 1e-4) | (
                (got[1] - want[1]).abs() > 1e-4)
            row["pixels_moved_by_a_mask"] = int(off.sum())
        rows.append(row)
    for row in rows:
        print(json.dumps(row), flush=True)
    return rows


class Swapped:
    """``module.name`` replaced by ``value`` inside the block."""

    def __init__(self, module, name, value):
        self.module, self.name, self.value = module, name, value

    def __enter__(self):
        self.saved = getattr(self.module, self.name)
        setattr(self.module, self.name, self.value)

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.saved)


def cuobjdump() -> str:
    return str(Path(qcuda._nvcc()).parent / "cuobjdump")


def sass_opcodes(kern, kernel_name, out_dir, tag):
    """The SASS of one build (``cuobjdump -sass``) written to
    ``out_dir/<tag>.sass``, and the count of each opcode (its first word,
    before the first dot) in the function whose demangled name starts with
    ``kernel_name``: a static count of the whole function, for reading the
    depth loop by hand in the file."""
    lib = qcuda._lib_path(kern.source, kern.defines)
    text = subprocess.run([cuobjdump(), "-sass", str(lib)],
                          capture_output=True, text=True, timeout=300,
                          check=True).stdout
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    (out / f"{tag}.sass").write_text(text)
    funcs = re.split(r"\n\s*Function : ", text)[1:]
    names = kernel_names([f.split(None, 1)[0] for f in funcs])
    counts = {}
    for name, body in zip(names, funcs):
        if not name.startswith(kernel_name):
            continue
        ops = re.findall(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P[T0-9]+\s+)?"
                         r"([A-Z][A-Z0-9_]*)", body)
        hist = {}
        for op in ops:
            hist[op] = hist.get(op, 0) + 1
        counts[name] = dict(sorted(hist.items(), key=lambda x: -x[1]))
    return counts


def mixed_fwd_outputs(args):
    """out, acc, chunks run and the handoff (zeroed outside the blocks and
    chunks each tile ran) of ``composite_tiles_fwd_mixed`` on its
    arguments, by whichever kernel ``rp.COMPOSITE_MIXED`` is."""
    from qed_splatter_tpu_torch.ops import rasterize_pallas as rp

    slabs, (ntx, ts, counts, k_chunk) = args[:4], args[4:8]
    t, _, k = slabs[2].shape
    runs = torch.empty(t, dtype=torch.int32, device="cuda")
    out, acc, h = rp.composite_tiles_fwd_mixed(*slabs, ntx, ts, counts,
                                               k_chunk, runs, tail=True)
    return [out, acc, runs,
            *chip_smoke.handoff_run(h, runs, counts, k, k_chunk)]


def mixed_fwd_rows(label, f_args, parent=None, sass_dir=""):
    """One row per variant of the mixed forward on one mixed step's own
    inputs (``parent``: a tree's ``csrc/`` whose kernel is timed too), held
    against the default build and the plain version, beside the float32
    forward with its handoff on the same slabs. Every build is timed twice,
    in turns (the list, then the list reversed), on one card."""
    from qed_splatter_tpu_torch.ops import rasterize_pallas as rp

    slabs, (ntx, ts, counts, k_chunk) = f_args[:4], f_args[4:8]
    t, _, k = slabs[2].shape
    variants = [(v, p, d, None) for v, p, d in FWD_MIX_VARIANTS]
    if parent:
        variants.append(("the parent tree's kernel", (), (), parent))
    kerns = [CudaKernel(patched_source("composite", p, c),
                        rp.COMPOSITE_MIXED.symbol,
                        rp.COMPOSITE_MIXED.argtypes[:-1], d)
             for _, p, d, c in variants]
    runs_ref = torch.empty(t, dtype=torch.int32, device="cuda")
    ro, ra, hr = rp.composite_tiles_ref(*slabs, ntx, ts, counts, k_chunk,
                                        runs_ref, tail=True, mixed=True)
    plain_sums = chip_smoke.handoff_run(hr, runs_ref, counts, k, k_chunk)[1]
    rows, want = [], None
    for (variant, _, defines, _), kern in zip(variants, kerns):
        with Swapped(rp, "COMPOSITE_MIXED", kern):
            got = mixed_fwd_outputs(f_args)
        want = got if want is None else want
        rows.append({
            "kernel": "composite_mixed", "scene": label, "variant": variant,
            "exact_vs_default": all(torch.equal(g, w)
                                    for g, w in zip(got, want)),
            "err_vs_plain": max(chip_smoke.max_abs(got[0], ro),
                                chip_smoke.max_abs(got[1], ra)),
            "sums_equal_plain": torch.equal(got[4], plain_sums),
            "resources": {
                name: r for name, r in kernel_resources(
                    " ".join((kern.source, *defines))).items()
                if name.startswith("composite_mixed")},
            "ms_passes": []})
    f32_args = (*slabs, ntx, ts, counts, k_chunk,
                torch.empty(t, dtype=torch.int32, device="cuda"), True)
    f32 = {"kernel": "composite (float32, with its handoff, the same slabs)",
           "scene": label, "ms_passes": []}
    order = list(zip(rows, kerns))
    for pass_order in (order, order[::-1]):
        for row, kern in pass_order:
            with Swapped(rp, "COMPOSITE_MIXED", kern):
                row["ms_passes"].append(chip_smoke.cuda_ms(
                    lambda: rp.composite_tiles_fwd_mixed(
                        *slabs, ntx, ts, counts, k_chunk, None, True), 50))
        f32["ms_passes"].append(chip_smoke.cuda_ms(
            lambda: rp.composite_tiles_fwd(*f32_args), 50))
    for row in (*rows, f32):
        row["ms"] = statistics.mean(row["ms_passes"])
        print(json.dumps(row), flush=True)
    if sass_dir:
        for (variant, _, _, _), kern in zip(variants, kerns):
            if variant in ("default", "the witness build",
                           "the parent tree's kernel") and label == "A":
                tag = "composite-" + re.sub(r"\W+", "_", variant)
                ops = sass_opcodes(kern, "composite_", sass_dir, tag)
                ops = {"variant": variant, "sass_file": f"{tag}.sass",
                       "opcodes_d4": {n: h for n, h in ops.items()
                                      if "<4" in n}}
                print(json.dumps(ops), flush=True)
    return [*rows, f32]


def mixed_rows(label, m_args):
    """One row per variant of the mixed backward on one mixed step's own
    inputs, held against the default build and the plain version."""
    from qed_splatter_tpu_torch.ops import rasterize_pallas as rp

    def kernel(patches, defines):
        return CudaKernel(patched_source("composite_bwd", patches),
                          rp.COMPOSITE_BWD_MIXED.symbol,
                          rp.COMPOSITE_BWD_MIXED.argtypes[:-1], defines)

    slabs, gout, gacc = m_args[:4], m_args[4], m_args[5]
    ntx, ts, k_chunk, runs, counts = m_args[6:11]
    want = run_bwd_mixed(kernel(*MIX_VARIANTS[0][1:]), m_args)
    plain = rp.composite_tiles_bwd_ref(*slabs, gout, gacc, ntx, ts,
                                       k_chunk=k_chunk, chunks_run=runs,
                                       tile_counts=counts, mixed=True)
    rows = []
    for variant, patches, defines in MIX_VARIANTS:
        kern = kernel(patches, defines)
        got = run_bwd_mixed(kern, m_args)
        row = {"kernel": "composite_bwd_mixed", "scene": label,
               "variant": variant}
        row["ms"] = chip_smoke.cuda_ms(lambda: run_bwd_mixed(kern, m_args),
                                       20)
        row["err_vs_default"] = max(chip_smoke.bwd_channel_errs(got, want))
        row["exact_vs_default"] = all(torch.equal(g, w)
                                      for g, w in zip(got, want))
        row["err_vs_plain"] = max(chip_smoke.bwd_channel_errs(got, plain))
        row["resources"] = {
            name: r for name, r in kernel_resources(
                " ".join((kern.source, *defines))).items()
            if name.startswith("composite_bwd_mixed")}
        rows.append(row)
        print(json.dumps(row), flush=True)
    # the float32 backward on the same slabs, fed by the float32 forward
    runs32 = torch.empty_like(runs)
    t_last, cut = rp.composite_tiles_fwd(*slabs, ntx, ts, counts, k_chunk,
                                         runs32, True)[2:]
    f32_args = (*slabs, gout, gacc, ntx, ts, k_chunk, runs32, counts,
                t_last, cut)
    row = {"kernel": "composite_bwd (float32, the same slabs)",
           "scene": label,
           "ms": chip_smoke.cuda_ms(lambda: rp.composite_tiles_bwd(
               *f32_args), 20)}
    rows.append(row)
    print(json.dumps(row), flush=True)
    return rows


def copy_rows_rows():
    """The identity copy at the copy tool's two shapes, by CUDA-graph
    replays: into a new tensor per call and into one preallocated tensor,
    beside ``Tensor.copy_`` into that tensor and ``clone``."""
    from qed_splatter_tpu_torch.ops import copy_rows as cr
    from qed_splatter_tpu_torch.tools import bench_gather3 as bg3

    gen = torch.Generator(device="cuda").manual_seed(7)
    rows = []
    for n in (bg3.N_TAB, bg3.M_IDX):
        x = torch.rand((n, bg3.C), generator=gen, device="cuda")
        dst = torch.empty_like(x)
        row = {"kernel": "copy_rows", "shape": [n, bg3.C],
               "path": cr.copy_plan(x.data_ptr(), dst.data_ptr(),
                                    x.numel()).path,
               "exact": torch.equal(cr.copy_rows(x), x),
               "ms": chip_smoke.graph_ms(lambda: cr.copy_rows(x), 15),
               "ms_into": chip_smoke.graph_ms(
                   lambda: cr.copy_rows(x, out=dst), 15),
               "library_ms_into": chip_smoke.graph_ms(
                   lambda: dst.copy_(x), 15),
               "clone_ms": chip_smoke.graph_ms(lambda: x.clone(), 15),
               "bound_ms": 2 * x.numel() * 4
               / chip_smoke.PEAK_BYTES_PER_S * 1e3,
               "resources": kernel_resources("copy_rows")}
        rows.append(row)
        print(json.dumps(row), flush=True)
        del x, dst
    return rows


def slab_inputs(seed, t, k):
    """Sorted random int64 keys, T * K of them, and T sorted starts: the
    gather at a training step's tiles and K."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    m = t * k
    keys = torch.sort(torch.randint(0, 1 << 40, (m,), generator=gen,
                                    device="cuda")).values
    starts = torch.sort(torch.randint(0, m, (t,), generator=gen,
                                      device="cuda")).values
    return keys, starts, k


def run_slab(kernel, args):
    keys, starts, k = args
    t = starts.shape[0]
    out = torch.empty((t, k), dtype=torch.int64, device="cuda")
    kernel(ptr(keys), ptr(starts), ptr(out), keys.shape[0], t, k, -1)
    return out


@torch.no_grad()
def one_sweep_rows(case, args):
    """Errors of the kernel and of the one-sweep form on one backward call's
    arguments (those of ``composite_tiles_bwd``; a step's own slabs still
    require grad, hence ``no_grad``)."""
    from qed_splatter_tpu_torch.ops import rasterize_pallas as rp

    slabs, gout, gacc = args[:4], args[4], args[5]
    ntx, ts, k_chunk, runs, counts = args[6:11]
    out, acc = rp.composite_tiles_chunked(*slabs, ntx, tile_counts=counts)
    total = (gout * out).sum(1) + gacc[:, 0] * acc[:, 0]
    forms = {
        "kernel": rp.composite_tiles_bwd(*args),
        "one sweep, plain": rp.composite_tiles_bwd_sweeps_ref(
            *slabs, gout, gacc, ntx, ts, k_chunk, runs, counts, total=total),
    }
    plain = rp.composite_tiles_bwd_ref(*slabs, gout, gacc, ntx, ts,
                                       k_chunk=k_chunk, chunks_run=runs)
    f64 = [g.float() for g in rp.composite_tiles_bwd_ref(
        *(x.double() for x in slabs), gout.double(), gacc.double(), ntx, ts,
        k_chunk=k_chunk, chunks_run=runs)]
    rows = []
    for form, got in forms.items():
        row = {"measure": "one_sweep_error", "case": case, "form": form}
        for name, want in (("plain", plain), ("f64", f64)):
            row[f"worst_vs_{name}"] = max(
                chip_smoke.bwd_channel_errs(got, want))
            outside = sum(int(((g - w).abs() > 5e-5 + 1e-3 * w.abs()).sum())
                          for g, w in zip(got, want))
            row[f"outside_bar_vs_{name}"] = outside / sum(
                w.numel() for w in want)
        rows.append(row)
        print(json.dumps(row), flush=True)
    return rows


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default="")
    ap.add_argument("--one-sweep", action="store_true",
                    help="measure the one-sweep form's error instead")
    ap.add_argument("--kernels", default=",".join(KERNELS),
                    help="comma list of the kernels whose variants to time")
    ap.add_argument("--parent", default="",
                    help="another tree's csrc/ whose mixed forward is timed "
                         "beside the variants")
    ap.add_argument("--sass", default="",
                    help="a directory for the SASS of the mixed forward's "
                         "default, witness and parent builds")
    args = ap.parse_args()
    want_k = set(args.kernels.split(","))
    if not want_k <= set(KERNELS):
        ap.error(f"unknown kernels {sorted(want_k - set(KERNELS))}")
    if not torch.cuda.is_available():
        print("error: CUDA is not available", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    if not args.one_sweep:
        variants = {
            "composite": ("composite", fwd_defines, FWD_VARIANTS),
            "composite_bwd": ("composite_bwd", bwd_defines, BWD_VARIANTS),
            "slab_gather": ("slab_gather", slab_defines, SLAB_VARIANTS)}
        todo = [(src, defines(*v) if isinstance(v, tuple) else defines(v))
                for name, (src, defines, vs) in variants.items()
                if name in want_k for v in vs]
        if "composite_bwd_mixed" in want_k:
            todo += [(patched_source("composite_bwd", patches), defines)
                     for _, patches, defines in MIX_VARIANTS]
        if "composite_mixed" in want_k:
            todo += [(patched_source("composite", patches), defines)
                     for _, patches, defines in FWD_MIX_VARIANTS]
            if args.parent:
                todo.append((patched_source("composite", (), args.parent),
                             ()))
        with ThreadPoolExecutor(8) as pool:
            list(pool.map(lambda j: qcuda.build([j[0]], j[1]), todo))
    qcuda.build(qcuda.sources())
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()
    print(f"card: {smi}", flush=True)

    from qed_splatter_tpu_torch.ops import rasterize_pallas as rp
    from qed_splatter_tpu_torch.ops import tiles

    rows = []
    if args.one_sweep:
        gen = torch.Generator(device="cuda").manual_seed(args.seed)
        ntx, nty = -(-chip_smoke.W // 16), -(-chip_smoke.H // 16)
        t, d = ntx * nty, 4
        slabs, counts = chip_smoke.chunked_case(gen, t, d, ntx)
        gout = torch.randn((t, d, 256), generator=gen, device="cuda")
        gacc = torch.randn((t, 1, 256), generator=gen, device="cuda")
        runs = torch.empty(t, dtype=torch.int32, device="cuda")
        rp.composite_tiles_chunked(*slabs, ntx, tile_counts=counts,
                                   chunks_run=runs)
        rows += one_sweep_rows(
            f"random chunked slabs, K=2048, {t // 2 - t // 3} opaque stacks",
            (*slabs, gout, gacc, ntx, 16, rp.K_CHUNK, runs, counts))
        del slabs, gout, gacc
    elif "copy_rows" in want_k:
        rows += copy_rows_rows()
    f32_k = want_k & {"composite", "composite_bwd", "slab_gather"}
    for label, n_alive, cap, k_cap in (("A", 80_000, 131_072, 256),
                                       ("B", 288_000, 327_680, 2048)):
        mixed_k = want_k & {"composite_mixed", "composite_bwd_mixed"}
        if mixed_k and not args.one_sweep:
            f_args, m_args = step_inputs(n_alive, cap, k_cap, args.seed,
                                         mixed=True)
            if "composite_mixed" in want_k:
                rows += mixed_fwd_rows(label, f_args, args.parent, args.sass)
            if "composite_bwd_mixed" in want_k:
                rows += mixed_rows(label, m_args)
            del f_args, m_args
            torch.cuda.empty_cache()
        if not (f32_k or args.one_sweep):
            continue
        f_args, b_args = step_inputs(n_alive, cap, k_cap, args.seed)
        if args.one_sweep:
            rows += one_sweep_rows(f"train {label} step's slabs, K={k_cap}",
                                   b_args)
            del f_args, b_args
            torch.cuda.empty_cache()
            continue
        if "composite" in want_k:
            rows += fwd_rows(label, f_args)
        if "composite_bwd" in want_k:
            want = rp.composite_tiles_bwd(*b_args)
            for pix, group, fastdiv in BWD_VARIANTS:
                kern = CudaKernel("composite_bwd", rp.COMPOSITE_BWD.symbol,
                                  rp.COMPOSITE_BWD.argtypes[:-1],
                                  bwd_defines(pix, group, fastdiv))
                got = run_bwd(kern, b_args)
                err = max(chip_smoke.bwd_channel_errs(got, want))
                ms = chip_smoke.cuda_ms(lambda: run_bwd(kern, b_args), 20)
                rows.append({"kernel": "composite_bwd", "scene": label,
                             "pix": pix, "group": group, "fastdiv": fastdiv,
                             "ms": ms, "err_vs_default": err})
                print(json.dumps(rows[-1]), flush=True)
            del want
        if "slab_gather" in want_k:
            g_args = slab_inputs(args.seed, f_args[2].shape[0], k_cap)
            ref = tiles.slab_gather(*g_args, -1)
            for pairs in SLAB_VARIANTS:
                kern = CudaKernel("slab_gather", tiles.SLAB_GATHER.symbol,
                                  tiles.SLAB_GATHER.argtypes[:-1],
                                  slab_defines(pairs))
                exact = torch.equal(run_slab(kern, g_args), ref)
                ms = chip_smoke.cuda_ms(lambda: run_slab(kern, g_args), 100)
                rows.append({"kernel": "slab_gather", "scene": label,
                             "mode": "gather", "pairs": pairs, "ms": ms,
                             "exact": exact})
                print(json.dumps(rows[-1]), flush=True)
            del g_args
        del f_args, b_args
        torch.cuda.empty_cache()
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps({"card": smi, "rows": rows},
                                             indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
