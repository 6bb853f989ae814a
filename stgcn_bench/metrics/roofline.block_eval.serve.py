"""``block_eval``'s share of its roofline: the least time of the eval units
of every batch that the window's requests made (bucket length by padded
batch, ``shapes.served_batches``), over the device time of the kernels
that ``roofline.block_eval.serve.d`` names."""

from stgcn_bench import shapes
from stgcn_bench.metrics import _kernels

NAME = "roofline.block_eval.serve"


def claims(ctx):
    return _kernels.claimed(ctx, NAME)


def read(ctx):
    if "requests" not in ctx:
        return None
    cell, pk = ctx["cell"], shapes.peaks(ctx)
    bound = sum(shapes.eval_bound_ms(cell.config, b, t, pk)
                for b, t in shapes.served_batches(cell.traffic,
                                                  ctx["requests"]))
    return _kernels.roofline(ctx, NAME, bound)
