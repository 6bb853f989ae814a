"""Device milliseconds a step in NCCL's kernels on rank 0: the kernels of
the window that ``nccl_ms.train.d`` names, over the window's steps."""

from stgcn_bench import trace as tracing
from stgcn_bench.metrics import _kernels

NAME = "nccl_ms.train"


def claims(ctx):
    return _kernels.claimed(ctx, NAME)


def read(ctx):
    if "steps" not in ctx:
        return None
    found = claims(ctx)
    return tracing.device_ms(found) / ctx["steps"] if found else None
