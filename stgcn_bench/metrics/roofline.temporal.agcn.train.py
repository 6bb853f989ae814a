"""2s-AGCN's temporal train ops' share of their roofline: the least time
of a step's 9x1 convs, forward and backward, from the cell's shapes
(``costs.agcn.temporal_bound_ms``) times the window's steps, over the
device time of the kernels that ``roofline.temporal.agcn.train.d``
names."""

from stgcn_bench import shapes
from stgcn_bench.costs import agcn
from stgcn_bench.metrics import _kernels

NAME = "roofline.temporal.agcn.train"


def claims(ctx):
    return _kernels.claimed(ctx, NAME)


def read(ctx):
    if "steps" not in ctx or "bodies" not in ctx:
        return None
    bound = agcn.temporal_bound_ms(ctx["cell"].config,
                                   ctx["batch"] // ctx["chips"],
                                   ctx["frames"], ctx["bodies"],
                                   *shapes.peaks(ctx))
    return _kernels.roofline(ctx, NAME, bound * ctx["steps"])
