"""Milliseconds a traced step of the per-row render, projection and SH
(``ops/projection.py``, ``ops/sh.py``): the device's busy time in the
``render.project`` and ``render.sh`` stages and their backward stages
(``splatbench.stages``)."""

from splatbench import stages


def read(run):
    return stages.layer_ms("render_rows_ms", run)
