"""The share of the traced window in which the device runs nothing
(serving): one less the union of its operations' intervals over the
window."""

from stgcn_bench.metrics import _kernels


def read(ctx):
    return _kernels.idle_share(ctx) if "requests" in ctx else None
