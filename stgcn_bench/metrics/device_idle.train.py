"""The share of the traced window in which the device runs nothing
(training, rank 0): one less the union of its operations' intervals over
the window."""

from stgcn_bench.metrics import _kernels


def read(ctx):
    return _kernels.idle_share(ctx) if "steps" in ctx else None
