"""Serving's share of the card's peak: the forward operations of every
answered clip at its own length (no padding) over the traced window's host
seconds, over the card's bf16 peak."""

from stgcn_bench import shapes


def read(ctx):
    if "requests" not in ctx or ctx.get("trace") is None:
        return None
    config = ctx["cell"].config
    per_len: dict = {}
    for _, lengths in ctx["requests"]:
        for n in lengths:
            per_len[int(n)] = per_len.get(int(n), 0) + 1
    ops = sum(c * shapes.flops(config, 1, t, train=False, nnz=0)
              for t, c in per_len.items())
    return 100.0 * ops / ctx["window_s"] / shapes.peaks(ctx)[0]
