"""Device-time microbenchmarking (port of ``stgcn_tpu/utils/benchmark.py``).

Timing one call with the host clock measures PyTorch's enqueue, not the
kernels: CUDA calls return before the device finishes.  ``device_time``
records a CUDA event before and after a whole loop of calls, synchronizes
once and divides by the count.  As the JAX version does, it cycles through
``distinct`` copies of the floating-point arguments, each perturbed by
``i * 1e-6``, so that no call repeats the previous one's inputs.  On the
CPU it uses ``time.perf_counter`` around the same loop.
"""

from __future__ import annotations

import time
from typing import Callable

import torch


def _perturbed(arg, i: int):
    if torch.is_tensor(arg) and arg.is_floating_point():
        return arg + torch.tensor(i * 1e-6, dtype=arg.dtype,
                                  device=arg.device)
    return arg


def device_time(fn: Callable, *example_args, iters: int = 100,
                distinct: int = 4, warmup: int = 2) -> float:
    """Mean seconds per call of ``fn(*example_args)``.

    The tensors' device decides the clock: CUDA events when any argument
    lies on a CUDA device, else ``time.perf_counter``.  ``warmup`` calls
    run first, untimed.
    """
    arg_sets = [tuple(_perturbed(a, i) for a in example_args)
                for i in range(distinct)]
    for i in range(warmup):
        fn(*arg_sets[i % distinct])
    on_cuda = any(torch.is_tensor(a) and a.is_cuda for a in example_args)
    if on_cuda:
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for i in range(iters):
            fn(*arg_sets[i % distinct])
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / 1e3 / iters
    t0 = time.perf_counter()
    for i in range(iters):
        fn(*arg_sets[i % distinct])
    return (time.perf_counter() - t0) / iters


def tflops(flop_count: float, seconds: float) -> float:
    return flop_count / seconds / 1e12
