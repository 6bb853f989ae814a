"""Device milliseconds a step in the train step's BatchNorm statistics
(rank 0): the kernels, NCCL's left out, of the ``bn_stats`` phases that
the program's phase marks bound (``_phases``), forward (the batch
moments, the affine, the running update) and backward (their gradient),
over the window's steps.

This reader claims the marker kernels and nothing else, so that
``rest_ms.train`` leaves the marks out and keeps every phase's kernels."""

from stgcn_bench.metrics import _phases


def claims(ctx):
    return _phases.markers(ctx)


def read(ctx):
    return _phases.phase_ms(ctx, "bn_stats")
