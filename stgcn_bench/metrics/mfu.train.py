"""The train step's share of the cards' peak: the operations of the
window's steps (the frozen ``ModelFlops`` count at the cell's global batch
and frames) over the traced window's host seconds, over the bf16 peak of
every card the cell uses."""

from stgcn_bench import shapes


def read(ctx):
    if "steps" not in ctx or ctx.get("trace") is None:
        return None
    ops = shapes.flops(ctx["cell"].config, ctx["batch"], ctx["frames"],
                       train=True, nnz=0) * ctx["steps"]
    peak = shapes.peaks(ctx)[0] * ctx["chips"]
    return 100.0 * ops / ctx["window_s"] / peak
