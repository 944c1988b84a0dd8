"""Milliseconds a traced step of the binning (``ops/tiles.py::
bin_gaussians``, the kernels of ``csrc/binning.cu``): the device's busy
time from each step's ``render.bin`` stage mark to the next mark
(``splatbench.stages``)."""

from splatbench import stages


def read(run):
    return stages.layer_ms("binning_ms", run)
