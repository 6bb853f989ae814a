"""Device milliseconds a step in 2s-AGCN's adaptive graph (rank 0): the
kernels of the ``adaptive`` phases that the program's phase marks bound
(``_phases``), forward (the embeddings, the Gram and the softmax) and
backward (the softmax's and the Gram's gradients, the embeddings' dx and
dW), over the window's steps."""

from stgcn_bench.metrics import _phases


def read(ctx):
    return _phases.phase_ms(ctx, "adaptive")
