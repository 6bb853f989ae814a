"""Milliseconds a step on rank 0's device timeline from each ``grad_sync``
phase mark to the next mark (``_phases``): from the end of the backward
to the end of the gradient all-reduce, so the exchange that compute does
not hide, over the window's steps."""

from stgcn_bench.metrics import _phases


def read(ctx):
    if "steps" not in ctx:
        return None
    marks = _phases.markers(ctx)
    spans = [nxt[1] - k[1] for k, nxt in zip(marks, marks[1:])
             if _phases.kind(k) == "grad_sync"]
    if not spans:
        return None
    return sum(spans) / 1e3 / ctx["steps"]
