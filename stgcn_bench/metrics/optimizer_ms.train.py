"""Device milliseconds a step in the train step's update (rank 0): the
kernels of the ``optimizer`` phase that the program's phase marks bound
(``_phases``): the optimizer's update, the copy of the BatchNorm running
statistics and the step's metrics, over the window's steps."""

from stgcn_bench.metrics import _phases


def read(ctx):
    return _phases.phase_ms(ctx, "optimizer")
