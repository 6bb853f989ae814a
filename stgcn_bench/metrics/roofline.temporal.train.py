"""The temporal train ops' share of their roofline: the least time of a
step's gamma x 1 taps (each unit's temporal op, forward and backward:
``shapes.temporal_bound_ms``) times the window's steps, over the device
time of the kernels that ``roofline.temporal.train.d`` names."""

from stgcn_bench import shapes
from stgcn_bench.metrics import _kernels

NAME = "roofline.temporal.train"


def claims(ctx):
    return _kernels.claimed(ctx, NAME)


def read(ctx):
    if "steps" not in ctx:
        return None
    bound = shapes.temporal_bound_ms(ctx["cell"].config,
                                     ctx["batch"] // ctx["chips"],
                                     ctx["frames"], shapes.peaks(ctx))
    return _kernels.roofline(ctx, NAME, bound * ctx["steps"])
