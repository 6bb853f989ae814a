"""Captured steps: the port's counterpart of ``jax.jit``.

The JAX package compiles every step into one XLA program, traced once per
input signature, its train state donated and updated in place: the train
and eval steps (``stgcn_tpu/training/loop.py:37-92``), the serving forward
per ``(batch, T)`` bucket (``stgcn_tpu/serving.py:180-229``) and the mesh
steps (``stgcn_tpu/parallel/fused_dp.py:159,195``,
``stgcn_tpu/parallel/train.py:219,263``).  On a CUDA device the
counterpart is a CUDA graph, which :class:`CapturedStep` keeps for a step's
device work ``body(state, *inputs, generator=None) -> outputs``:

* **The cache.**  One graph per input signature: the shape and dtype of
  each input, and which inputs are None (a time mask given or not), what
  makes jit trace again.  :attr:`CapturedStep.cache_size` counts the
  graphs.
* **Warm-up, capture, replay.**  The first call at a signature runs the
  body eagerly, on a side stream, as the real step: the kernel library
  builds, cuBLAS and autograd set up, the optimizer's moments and NCCL's
  communicator come to exist.  The second call captures the body into a
  ``torch.cuda.CUDAGraph`` and replays it; every later call replays.
* **Memory.**  A graph keeps its step's working set reserved (about 1.2-1.5
  times the eager step's peak).  Every step on a device captures on one
  side stream into one memory pool (:func:`capture_pool`), so a graph
  reuses the temporaries of the graphs alive before it and a process
  holds about its largest graph's memory, not the sum over steps and
  buckets.  That memory, the largest working set captured into the pool,
  stays reserved while any graph of the pool lives, and is released with
  the last one: drop the steps and predictors no longer used.  What
  outlives a replay (outputs, gradients) stays allocated, held by its
  graph.  Steps therefore replay one at a time: never call two from two
  threads at once.
* **Buffers.**  Inputs are copied into static buffers.  The state
  (parameters, moments, BN statistics) is updated in place, and a graph
  holds the addresses of its tensors: a call that finds one of them moved
  (a restore that replaced them) drops the step's graphs and starts again
  with a warm-up.  Outputs are static tensors that the next call at the
  same signature overwrites: clone what you keep.
* **Host work.**  ``before(state)`` runs ahead of the device work on every
  call (the optimizer's count and per-step scalars) and returns the
  dropout seed or None; ``check(state, outputs)`` runs after the device
  work, eager or replayed, and returns what the call returns: it may read
  a small output tensor and raise, taking back what ``before`` did (the
  checked step, :mod:`stgcn_tpu_torch.training.checks`); ``after(state)``
  runs last (the step count).  Each graph has its own dropout generator,
  registered with it and seeded before every replay, so a replay draws
  the eager step's masks.
* **Recompute.**  A ``remat`` step's backward recomputes its blocks and
  draws their dropout masks again (:func:`stgcn_tpu_torch.ops.block.
  checkpointed`), each from a generator state of its own (the
  :class:`~stgcn_tpu_torch.ops.block.RecomputeStates` that the graph's
  :class:`~stgcn_tpu_torch.ops.block.DropoutGenerator` carries): the
  capture registers one a drawing stretch beside the dropout generator,
  and each is set to the step's seed at its stretch's offset before every
  replay.
* **Launch counts.**  The kernel wrappers count launches in Python
  (``kernels/__init__.py``), and the parallel paths their collectives
  (``parallel/collectives.COUNTS``), which a replay does not run: a
  capture's increase of each count is taken back and added again at every
  replay.
* **Phase marks.**  A train step's body marks its phases while a
  profiler records (:mod:`stgcn_tpu_torch.utils.profiling`).  A step
  made with ``marks=True`` captures two graphs of each signature, one
  after the other: the plain one, without marks whether or not a
  profiler records, then a *marked* one, in the same pool, on the
  signature's input buffers and with its dropout generator states (so it
  draws the same masks; it holds the gradients and outputs of one more
  graph).  A call replays the
  marked graph while tracing is on, else the plain one.  The marked graph
  is captured beside the plain one, and not at the first traced call,
  because a graph made while the profiler records reports its
  device-to-device copies as copies where one made before reports them
  as a kernel (``memcpy128``), so a traced replay would leave those
  copies out of the kernels that a reader of the trace counts (1.8 ms of
  the fused step's 58 on an H100); and no capture then falls inside a
  traced window.  Each warm-up and capture
  runs in a ``graph.capture`` span.
* **Eager.**  On the CPU, and with ``capture=False`` (the counterpart of
  ``jax.disable_jit()``), the body runs eagerly every call, through the
  same input and output buffers.  A step that cannot be captured names
  its reason (``eager_reason``: a gloo mesh's collectives, which run on
  the host) and runs eagerly, saying so once on a CUDA device;
  ``capture=True`` with a reason, or on the CPU, raises.  The training
  loop's ``debug_nans`` (autograd's anomaly mode, checked on the host
  after every backward op) runs its step with ``capture=False``.
"""

from __future__ import annotations

import dataclasses
import importlib
import weakref
from typing import Any, Callable

import torch

from stgcn_tpu_torch.ops.block import DropoutGenerator
from stgcn_tpu_torch.tree import tree_leaves, tree_map
from stgcn_tpu_torch.utils.profiling import forced_marks, span, tracing

# the kernel modules whose wrappers count their launches
_KERNEL_MODULES = ("adaptive_graph", "affine_relu", "block_eval",
                   "bn_moments", "spatial_block", "spatial_conv",
                   "temporal_block", "temporal_conv", "unit_tail")


def launch_counters() -> list[Callable]:
    """Every kernel wrapper with a ``launches`` count."""
    found = {}
    for name in _KERNEL_MODULES:
        module = importlib.import_module(f"stgcn_tpu_torch.kernels.{name}")
        for f in vars(module).values():
            if callable(f) and hasattr(f, "launches"):
                found[id(f)] = f
    return list(found.values())


def _collectives():
    """The parallel paths' collective counts (imported on use: the
    parallel package imports this module)."""
    return importlib.import_module("stgcn_tpu_torch.parallel.collectives")


@dataclasses.dataclass
class _Captures:
    """A device's side stream, its memory pool and the graphs alive in
    that pool."""

    stream: Any
    pool: tuple | None = None
    graphs: weakref.WeakSet = dataclasses.field(
        default_factory=weakref.WeakSet)


# device index -> its _Captures (module docstring: every step shares them)
_CAPTURES: dict = {}


def _captures(device: torch.device) -> _Captures:
    index = torch.device(device).index
    if index is None:
        index = torch.cuda.current_device()
    if index not in _CAPTURES:
        _CAPTURES[index] = _Captures(torch.cuda.Stream(device=index))
    return _CAPTURES[index]


def capture_pool(device: torch.device) -> tuple | None:
    """The memory pool the steps on ``device`` capture into (module
    docstring), as ``torch.cuda.graph_pool_handle`` gives it, or None
    before the first capture.  When its last graph is gone the pool is
    released and the next capture starts a new one."""
    return _captures(device).pool


@dataclasses.dataclass
class _Graph:
    """A captured graph and what its replays restore: its static outputs,
    the gradients it writes, the launch and collective counts of its
    capture."""

    graph: Any
    outputs: Any
    grads: list
    launches: list
    collectives: dict


@dataclasses.dataclass
class _Entry:
    """One input signature: its buffers and, once captured, its graphs
    (``graphs[marked]``: the plain one, and the one with phase marks)."""

    inputs: list
    generator: DropoutGenerator | None = None
    outputs: Any = None
    warm: bool = False
    graphs: dict = dataclasses.field(default_factory=dict)


class CapturedStep:
    """A step's device work, captured once per input signature and
    replayed (module docstring).

    ``body(state, *inputs, generator=None)``: the device work, in place on
    ``state``; ``state_tensors(state)``: every tensor it reads or writes
    in place, whose addresses a graph keeps; ``before``/``check``/
    ``after``: the host's work around it; ``capture``: None (capture on
    CUDA), True (capture or raise) or False (eager); ``eager_reason``: why
    this step cannot be captured, if it cannot; ``marks``: whether the
    body places phase marks, so that a marked graph is captured beside
    the plain one and replayed while tracing (module docstring).
    """

    def __init__(self, body: Callable, *, state_tensors: Callable,
                 before: Callable | None = None,
                 check: Callable | None = None,
                 after: Callable | None = None,
                 capture: bool | None = None,
                 eager_reason: str | None = None, marks: bool = False,
                 name: str = "step"):
        if capture and eager_reason:
            raise ValueError(f"{name} cannot be captured: {eager_reason}")
        self.body = body
        self.state_tensors = state_tensors
        self.before = before
        self.check = check
        self.after = after
        self.capture = capture
        self.eager_reason = eager_reason
        self.marks = marks
        self.name = name
        self.captured = False       # whether the last call captured/replayed
        self._entries: dict = {}
        self._addresses: tuple | None = None
        self._told = False

    @property
    def cache_size(self) -> int:
        """The number of signatures with a captured graph (jit's cache
        size; a signature's marked graph is not counted apart)."""
        return sum(bool(e.graphs) for e in self._entries.values())

    @property
    def marked_graphs(self) -> int:
        """The number of graphs captured with phase marks."""
        return sum(True in e.graphs for e in self._entries.values())

    @property
    def signatures(self) -> int:
        """The number of input signatures seen, each with its buffers
        (and, once captured, its graph)."""
        return len(self._entries)

    def reset(self) -> None:
        """Drop every graph and buffer; the next call warms up again."""
        self._entries.clear()
        self._addresses = None

    def _captures_on(self, device: torch.device) -> bool:
        if self.capture is False:
            return False
        if device.type != "cuda":
            if self.capture:
                raise ValueError(f"{self.name}: capture=True needs a CUDA "
                                 f"device, the inputs are on {device}")
            return False
        if self.eager_reason:
            if not self._told:
                print(f"[graph] {self.name} runs eagerly: "
                      f"{self.eager_reason}", flush=True)
                self._told = True
            return False
        return True

    def __call__(self, state, *inputs):
        device = next(x.device for x in inputs if x is not None)
        capturing = self.captured = self._captures_on(device)
        if capturing:
            addresses = tuple(t.data_ptr() for t in self.state_tensors(state))
            if addresses != self._addresses:
                self.reset()
        sig = (device, tuple(None if x is None else (tuple(x.shape), x.dtype)
                             for x in inputs))
        entry = self._entries.get(sig)
        if entry is None:
            entry = self._entries[sig] = _Entry(inputs=[
                None if x is None else torch.empty_like(
                    x, memory_format=torch.contiguous_format)
                for x in inputs])
        for buf, x in zip(entry.inputs, inputs):
            if x is not None:
                buf.copy_(x, non_blocking=True)
        if capturing and entry.warm and not entry.graphs:
            with span("graph.capture"):
                with forced_marks(False):
                    self._capture(state, entry, device, False)
                if self.marks:
                    with forced_marks(True):
                        self._capture(state, entry, device, True)
        key = self.before(state) if self.before is not None else None
        if key is not None:
            if entry.generator is None:
                entry.generator = DropoutGenerator(device)
            entry.generator.manual_seed(key)
            entry.generator.recompute.seed(key)
        captured = entry.graphs.get(self.marks and tracing())
        if captured is not None:
            for p, g in captured.grads:
                p.grad = g
            for f, n in captured.launches:
                f.launches += n
            if captured.collectives:
                _collectives().add_counts(captured.collectives)
            captured.graph.replay()
            out = captured.outputs
        elif capturing:
            with span("graph.capture"):
                out = self._eager(state, entry, True, device)
            entry.warm = True
            self._addresses = tuple(
                t.data_ptr() for t in self.state_tensors(state))
        else:
            out = self._eager(state, entry, False, device)
        if self.check is not None:
            out = self.check(state, out)
        if self.after is not None:
            self.after(state)
        return tree_map(lambda t: t, out)    # new containers, same tensors

    def _eager(self, state, entry: _Entry, warm_up: bool, device):
        """The body, eagerly, its outputs copied into the static ones; a
        warm-up runs on the side stream that the capture will use."""
        if entry.generator is not None:
            entry.generator.recompute.begin_eager()
        if warm_up:
            side = _captures(device).stream
            main = torch.cuda.current_stream(device)
            side.wait_stream(main)
            with torch.cuda.stream(side):
                out = self.body(state, *entry.inputs,
                                generator=entry.generator)
            main.wait_stream(side)
        else:
            out = self.body(state, *entry.inputs, generator=entry.generator)
        with torch.no_grad():
            if entry.outputs is None:
                entry.outputs = tree_map(lambda t: t.detach().clone(), out)
            else:
                for dst, src in zip(tree_leaves(entry.outputs),
                                    tree_leaves(out)):
                    dst.copy_(src)
        return entry.outputs

    def _capture(self, state, entry: _Entry, device, marked: bool) -> None:
        shared = _captures(device)
        if not shared.graphs:
            # a released pool cannot take a new graph: start another
            shared.pool = torch.cuda.graph_pool_handle()
        graph = torch.cuda.CUDAGraph()
        recompute = None
        if entry.generator is not None:
            # its state as a plain torch.Generator, the type the binding
            # takes (graphsafe_get_state shares the state, not a copy)
            graph.register_generator_state(
                entry.generator.graphsafe_get_state())
            recompute = entry.generator.recompute
            # a signature's second graph draws from its first one's states
            for state_ in recompute.capture_states(device,
                                                   fresh=not entry.graphs):
                graph.register_generator_state(state_)
        counters = launch_counters()
        counts = [f.launches for f in counters]
        issued = _collectives().read_counts()
        try:
            with torch.cuda.graph(graph, pool=shared.pool,
                                  stream=shared.stream):
                outputs = self.body(state, *entry.inputs,
                                    generator=entry.generator)
                if recompute is not None:
                    recompute.finish()
        except Exception as err:
            raise RuntimeError(
                f"capturing {self.name} in a CUDA graph failed; "
                f"capture=False runs it eagerly") from err
        finally:
            grown = [f.launches - n for f, n in zip(counters, counts)]
            for f, n in zip(counters, counts):
                f.launches = n
            collectives = _collectives().counts_since(issued)
            _collectives().reset_counts()
            _collectives().add_counts(issued)
        entry.graphs[marked] = _Graph(
            graph=graph, outputs=outputs,
            grads=[(t, t.grad) for t in self.state_tensors(state)
                   if t.requires_grad and t.grad is not None],
            launches=[(f, n) for f, n in zip(counters, grown) if n],
            collectives=collectives)
        shared.graphs.add(graph)
