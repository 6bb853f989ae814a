"""Device milliseconds a step in the tail of the train step's units (rank
0): the kernels, NCCL's left out, of the ``tail`` phases that the
program's phase marks bound (``_phases``), forward (the shortcut's
projection and add, the casts, the ReLU, dropout) and backward, over the
window's steps."""

from stgcn_bench.metrics import _phases


def read(ctx):
    return _phases.phase_ms(ctx, "tail")
