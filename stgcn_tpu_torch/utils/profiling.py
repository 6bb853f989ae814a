"""Profiling and throughput accounting (port of
``stgcn_tpu/utils/profiling.py``).

* :func:`trace`: ``torch.profiler`` over a block (CPU, and the GPU's
  kernels when CUDA is present), written as a Chrome trace
  (``<log_dir>/trace.json``, viewable in Perfetto or ``chrome://tracing``);
  the train CLI's ``--train.profile_dir``;
* :class:`ModelFlops`: analytic operation and edge counts per step, for the
  CLI's ``[perf]`` line;
* :func:`param_table`: a listing of the parameter dictionaries;
* :func:`dump_computation`: the inspectable computation, the traced
  program and the captured CUDA graph of a function.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
from typing import Callable

import torch

from stgcn_tpu_torch.tree import tree_items


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the block and write ``log_dir/trace.json``; yields the
    ``torch.profiler.profile`` object (``key_averages()`` for sums by
    kernel)."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def spatial_conv_flops(n: int, t: int, v: int, c_in: int, c_out: int,
                       k: int) -> int:
    """Operations (2 per multiply-add) of the factored graph conv: the
    ``C_in -> K·C_out`` expansion, then the ``K`` aggregations over
    ``V x V``."""
    stage1 = 2 * n * t * v * c_in * k * c_out
    stage2 = 2 * n * t * k * v * v * c_out
    return stage1 + stage2


@dataclasses.dataclass(frozen=True)
class ModelFlops:
    """Analytic per-step compute accounting for an STGCN config."""

    fwd_flops: int
    edges_processed: int  # skeleton edges aggregated, summed over blocks
    frames: int

    @classmethod
    def of(cls, model, batch: int, t: int, train: bool = True
           ) -> "ModelFlops":
        cfg = model.config
        V = model.num_joints
        K = model.num_partitions
        nnz = int((model.adjacency != 0).sum())  # edges across partitions
        flops = 0
        edges = 0
        frames = 0
        c_prev = cfg.c_in
        t_cur = t
        for c_out, stride in cfg.plan:
            flops += spatial_conv_flops(batch, t_cur, V, c_prev, c_out, K)
            # every spatial conv aggregates each edge once per frame
            edges += batch * t_cur * nnz
            frames += batch * t_cur
            t_out = ((t_cur + 2 * ((cfg.gamma - 1) // 2) - cfg.gamma)
                     // stride + 1)
            flops += 2 * batch * t_out * V * cfg.gamma * c_out * c_out
            t_cur = t_out
            c_prev = c_out
        flops += 2 * batch * c_prev * cfg.num_classes
        if train:
            flops *= 3  # forward + ~2x backward
        return cls(fwd_flops=flops, edges_processed=edges, frames=frames)

    def edges_per_s(self, step_time_s: float) -> float:
        return self.edges_processed / step_time_s

    def tflops_per_s(self, step_time_s: float) -> float:
        return self.fwd_flops / step_time_s / 1e12


def param_table(params) -> str:
    """Human-readable parameter listing (counterpart of
    get_trainanble_parameters, src/utils/model_utils.py:10-13)."""
    lines = []
    total = 0
    for name, leaf in tree_items(params).items():
        n = leaf.numel()
        total += n
        lines.append(f"{name:60s} {str(tuple(leaf.shape)):>20s} {n:>10,d}")
    lines.append(f"{'TOTAL':60s} {'':>20s} {total:>10,d}")
    return "\n".join(lines)


class _Function(torch.nn.Module):
    """A function of tensors as a module, for ``torch.export``."""

    def __init__(self, fn: Callable):
        super().__init__()
        self.fn = fn

    def forward(self, *args):
        return self.fn(*args)


def dump_computation(fn: Callable, args: tuple, path_base: str
                     ) -> tuple[str, str]:
    """Write the traced and the compiled program of ``fn(*args)`` (port of
    ``stgcn_tpu/utils/profiling.py:76-92``, which writes the jaxpr and the
    optimized HLO) and return the two paths:

    * ``path_base + ".export.txt"``: the ``torch.export`` graph of ``fn``
      (non-strict, no gradients), every aten op it runs, the counterpart of
      the jaxpr;
    * ``path_base + ".cudagraph.txt"``: on a CUDA device, the CUDA graph of
      one call of ``fn`` (after an eager warm-up on the capture's stream),
      dumped by ``CUDAGraph.debug_dump`` as DOT text with a node for every
      kernel launch and copy, the counterpart of the optimized HLO; on the
      CPU, where nothing is captured, a line that says so.
    """
    traced_path = path_base + ".export.txt"
    graph_path = path_base + ".cudagraph.txt"
    with torch.no_grad():
        program = torch.export.export(_Function(fn), tuple(args),
                                      strict=False)
    with open(traced_path, "w") as f:
        f.write(program.graph_module.print_readable(print_output=False))
    device = next((a.device for a in args if torch.is_tensor(a)), None)
    if device is None or device.type != "cuda":
        with open(graph_path, "w") as f:
            f.write(f"no CUDA graph: fn ran on {device}, and only a CUDA "
                    "device captures one\n")
        return traced_path, graph_path
    stream = torch.cuda.Stream(device=device)
    stream.wait_stream(torch.cuda.current_stream(device))
    with torch.no_grad():
        with torch.cuda.stream(stream):
            fn(*args)                   # warm-up: builds, allocates
        graph = torch.cuda.CUDAGraph()
        graph.enable_debug_mode()
        with torch.cuda.graph(graph, stream=stream):
            fn(*args)
    graph.debug_dump(graph_path)
    return traced_path, graph_path
