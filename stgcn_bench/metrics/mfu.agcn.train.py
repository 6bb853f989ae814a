"""The 2s-AGCN train step's share of the cards' peak: the operations of
the window's steps (the frozen count ``costs.agcn.step_flops`` at the
cell's global batch, bodies and frames) over the traced window's host
seconds, over the bf16 peak of every card the cell uses."""

from stgcn_bench import shapes
from stgcn_bench.costs import agcn


def read(ctx):
    if "steps" not in ctx or "bodies" not in ctx or ctx.get("trace") is None:
        return None
    ops = agcn.step_flops(ctx["cell"].config, ctx["batch"], ctx["frames"],
                          ctx["bodies"]) * ctx["steps"]
    peak = shapes.peaks(ctx)[0] * ctx["chips"]
    return 100.0 * ops / ctx["window_s"] / peak
