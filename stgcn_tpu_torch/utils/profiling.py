"""Profiling and throughput accounting (port of
``stgcn_tpu/utils/profiling.py``).

* :func:`trace`: ``torch.profiler`` over a block (CPU, and the GPU's
  kernels when CUDA is present), written as a Chrome trace
  (``<log_dir>/trace.json``, viewable in Perfetto or ``chrome://tracing``);
  the train CLI's ``--train.profile_dir``;
* :func:`span`, :func:`mark` and :func:`boundary`: the program's own
  tracing (below), the counterpart of the JAX package's ``annotate``;
* :class:`ModelFlops`: analytic operation and edge counts per step, for the
  CLI's ``[perf]`` line;
* :func:`param_table`: a listing of the parameter dictionaries;
* :func:`dump_computation`: the inspectable computation, the traced
  program and the captured CUDA graph of a function.

**Tracing is on while a** ``torch.profiler`` **records** (the profiler's
own flag, ``torch.autograd.profiler._is_profiler_enabled``); there is no
other switch.  Off, a span costs one read of that flag and a mark two
(the flag and :func:`forced_marks`'s), and a captured step replays the
graph it would replay without this module.  On:

* **Host spans** (:func:`span`) are ``record_function`` ranges: inside
  ``Predictor.predict`` ``serve.bucket`` (grouping the clips by bucket),
  ``serve.collate`` (a chunk's wrap-pad, stack and batch pad, then its
  host cast, pinning and copy), ``serve.forward`` (the captured
  forward's call and its readback), ``serve.sync`` (the wait on a
  batch's result) and ``serve.gather`` (scattering the results, the
  argmax, the names); in ``CapturedStep``, ``graph.capture`` around each
  warm-up and capture.
* **Device phase marks** (:func:`mark`, :func:`boundary`): an empty
  kernel per phase of the train step, ``void stgcn_phase_mark<
  stgcn_phase::<kind>>()`` (``kernels/csrc/phase_mark.cu``), launched
  where the phase begins, forward and backward, and captured into the
  step's graph: a replayed step is one ``cudaGraphLaunch``, so no host
  range can say which phase a kernel belongs to, but a mark on the device
  timeline can.  A kernel belongs to the phase of the latest mark that
  started before it.  The kinds (:data:`PHASES`): ``input`` (the cast and
  layout of ``x``), per unit ``bn_stats`` (the batch moments, the affine,
  the running update), ``spatial`` (the spatial op and its weight casts),
  ``temporal`` (the temporal op and its weight casts) and ``tail`` (the
  shortcut, the casts, the ReLU and dropout), then ``head`` (pool,
  classifier, loss), ``grad_sync`` (on a mesh, from the end of the
  backward to the end of the gradient all-reduce) and ``optimizer`` (the
  update, the BN statistics' copy, the step's metrics).  A captured train
  step holds a marked graph of each signature beside its plain one and
  replays it while tracing is on (``training/graphs.py``).  On the CPU a
  mark appends its kind to :data:`MARK_LOG` instead.

Reading them: open ``trace.json`` in Perfetto (ui.perfetto.dev).  The
spans sit on the host thread's track, nested under the caller's; the
marks are empty kernels on the GPU stream's track, and a phase runs
from its mark to the next one (the SQL query ``select name,
ts from slice where name like '%stgcn_phase_mark%'`` lists them).
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import os
from typing import Callable

import torch
from torch.autograd import profiler as _autograd_profiler

from stgcn_tpu_torch.kernels.phase_mark import KINDS as PHASES
from stgcn_tpu_torch.kernels.phase_mark import phase_mark
from stgcn_tpu_torch.tree import tree_items

# the kinds of the marks placed on the CPU while tracing, newest last
MARK_LOG: collections.deque = collections.deque(maxlen=1 << 16)
_NO_SPAN = contextlib.nullcontext()
# marks on (True) or off (False) whatever the profiler: forced_marks
_FORCED: bool | None = None


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


def tracing() -> bool:
    """Whether a ``torch.profiler`` records (module docstring)."""
    return _autograd_profiler._is_profiler_enabled


def span(name: str):
    """A host span: ``record_function(name)`` while tracing, else a
    context that does nothing.  Names take a prefix (``serve.``,
    ``graph.``); ``window``, ``step`` and ``predict`` are left to the
    callers that time the program."""
    if _autograd_profiler._is_profiler_enabled:
        return torch.profiler.record_function(name)
    return _NO_SPAN


@contextlib.contextmanager
def forced_marks(on: bool):
    """Place the phase marks (``on``) or none, whether or not a profiler
    records: a captured step captures its plain and its marked graph
    (``training/graphs.py``)."""
    global _FORCED
    _FORCED = on
    try:
        yield
    finally:
        _FORCED = None


def _marking() -> bool:
    if _FORCED is None:
        return _autograd_profiler._is_profiler_enabled
    return _FORCED


def mark(kind: str, device: torch.device) -> None:
    """While tracing, mark the start of phase ``kind`` (one of
    :data:`PHASES`) on ``device``: the marker kernel on its current
    stream, or on the CPU an entry in :data:`MARK_LOG`."""
    if _marking():
        _mark(kind, device)


def _mark(kind: str, device: torch.device) -> None:
    if device.type == "cuda":
        phase_mark(kind, device)
    elif kind in PHASES:
        MARK_LOG.append(kind)
    else:
        raise ValueError(f"no phase {kind!r}; the phases are {PHASES}")


class _Boundary(torch.autograd.Function):
    """Identity on its tensors: the forward marks ``forward_kind``, the
    backward ``backward_kind`` (:func:`boundary`)."""

    @staticmethod
    def forward(ctx, forward_kind, backward_kind, *tensors):
        _mark(forward_kind, tensors[0].device)
        ctx.backward_kind = backward_kind
        ctx.device = tensors[0].device
        return tensors

    @staticmethod
    def backward(ctx, *grads):
        _mark(ctx.backward_kind, ctx.device)
        return (None, None, *grads)


def boundary(forward_kind: str, backward_kind: str, *tensors):
    """The tensors where one phase of the train step ends and the next
    begins: while tracing, through an identity ``autograd.Function`` whose
    forward marks ``forward_kind`` (the phase starting here) and whose
    backward, run once every gradient of the tensors has arrived, marks
    ``backward_kind`` (the phase whose backward starts there); else the
    tensors themselves.  Returns one tensor for one, else a tuple."""
    if _marking():
        tensors = _Boundary.apply(forward_kind, backward_kind, *tensors)
    return tensors[0] if len(tensors) == 1 else tensors


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
