"""Milliseconds a traced step of the optimizer (``engine/optim.py``, every
group's Adam, with the step's gradient hygiene): the device's busy time in
the ``step.optimizer`` stage (``splatbench.stages``)."""

from splatbench import stages


def read(run):
    return stages.layer_ms("optimizer_ms", run)
