"""Device milliseconds a step in kernels that no other per-layer metric of
the cell claims (BatchNorm statistics, casts, ReLU, the shortcut, dropout,
the loss, the optimizer): the window's kernels outside every reader's
``claims`` (the program's own kernels, NCCL's), over the window's steps."""

from stgcn_bench import trace as tracing


def read(ctx):
    rest = ctx.get("unclaimed")
    if "steps" not in ctx or not rest:
        return None
    return tracing.device_ms(rest) / ctx["steps"]
