"""Milliseconds a traced step of the bilateral grid
(``models/bilateral_grid.py``): the device's busy time in the
``render.bilagrid`` stage (the camera's grid sliced and applied to the
render, then clamped) and in its backward stage, ``bwd.render.bilagrid``
(from the corrected image's gradient to the grids' and the render's),
read from ``run.trace["stages"]`` over ``run.trace["traced_steps"]``.
The grids' total variation falls in ``loss.other`` and their Adam in
``step.optimizer``. None where the program marks neither stage: the grid
off, tracing off, or a program without the grid's marks."""

STAGES = ("render.bilagrid", "bwd.render.bilagrid")


def read(run):
    t = run.trace
    if not t or not t.get("traced_steps"):
        return None
    st = t.get("stages") or {}
    got = [st[s] for s in STAGES if s in st]
    if not got:
        return None
    return 1e3 * sum(got) / t["traced_steps"]
