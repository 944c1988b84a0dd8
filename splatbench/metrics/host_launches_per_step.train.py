"""Host launches per training step in the traced stretch: the profiler's
CUDA runtime calls that put work on the device (graph launches, kernel
launches, asynchronous copies and sets), less the launches of the
program's own stage-mark kernels (``splatbench.trace``)."""


def read(run):
    t = run.trace
    if not t or not t.get("traced_steps"):
        return None
    return t["launches"] / t["traced_steps"]
