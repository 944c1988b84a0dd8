"""Milliseconds a traced step of the photometric loss (``ops/ssim.py``,
with its L1 term): the device's busy time in the ``loss.ssim`` stage and
its backward stage (``splatbench.stages``)."""

from splatbench import stages


def read(run):
    return stages.layer_ms("ssim_ms", run)
