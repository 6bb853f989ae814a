"""The ST-GCN unit, eval and train mode (port of
``stgcn_tpu/ops/block.py:92-290``).

This is the op-path oracle that the fused block kernels are held against.
Behaviour follows the reference's ``SpatialTemporalConv``
(src/network/st_graphconv.py:4-109):

* non-residual order: BN -> spatial -> temporal -> BN -> ReLU;
* residual order (full pre-activation): BN -> ReLU -> spatial -> BN -> ReLU
  -> temporal, plus a shortcut (identity when shapes match, strided 1x1
  projection otherwise), then the outer ReLU;
* in train mode dropout follows the outer ReLU, and the BatchNorms use the
  batch statistics and return new running statistics.

Parameters are dictionaries of tensors in the JAX package's layout
(``spatial.w`` is ``(C_in, K, C_out)``, ``temporal.w`` is
``(gamma, 1, C_in, C_out)``), so one block's parameters carry over from a
JAX pytree unchanged.  The adjacency modes (SURVEY.md Q2) are told apart as
there: a block with ``"A"`` owns its whole adjacency (``"reference"``), one
with ``"mask"`` multiplies the fixed adjacency by it (``"mask"``), one with
neither uses the fixed adjacency (``"fixed"``).

``spatial_impl`` and ``temporal_impl`` pick each conv's implementation on
``(N, T, V, C)`` (:mod:`stgcn_tpu_torch.ops.spatial_conv`,
:mod:`stgcn_tpu_torch.ops.temporal_conv`), or are callables built by
:mod:`stgcn_tpu_torch.parallel` (the time halo, channel tensor
parallelism, the joint exchange), which own their dtype handling, as in
the JAX package (``stgcn_tpu/ops/block.py:112-147``).  The other mesh
hooks are ``constrain(x, tag)`` (tags ``"spatial_in"`` and
``"adjacency"``, the spatial conv's inputs, then ``"spatial_out"`` and
``"block_out"``), ``bn_group`` (the ranks whose shards make the batch of
the train BatchNorms, the JAX ``bn_axis_names``) and ``channel_group``
(the ranks whose channel slices make the spatial output: bn2 of the
residual order normalizes its slice).  :func:`block_forward_vm` is the
unit on V-major ``(V, N, T, C)`` activations, the ``layout="vntc"`` route:
both convs run as the V-major kernels.
"""

from __future__ import annotations

import contextlib

import torch
from torch.utils.checkpoint import checkpoint

from stgcn_tpu_torch.kernels.spatial_conv import spatial_conv_fused_vm
from stgcn_tpu_torch.kernels.temporal_conv import temporal_conv_fused_vm
from stgcn_tpu_torch.ops.batchnorm import (
    batchnorm_eval,
    batchnorm_train,
    stat_dtype,
)
from stgcn_tpu_torch.ops.common import dropout
from stgcn_tpu_torch.ops.spatial_conv import spatial_conv
from stgcn_tpu_torch.ops.temporal_conv import pointwise_conv, temporal_conv
from stgcn_tpu_torch.utils.profiling import boundary

ADJACENCY_MODES = ("reference", "mask", "fixed")


def effective_adjacency(params: dict, adjacency: torch.Tensor) -> torch.Tensor:
    """The ``(K, V, V)`` adjacency this block's forward uses."""
    if "A" in params:
        return params["A"]
    if "mask" in params:
        return adjacency * params["mask"]
    return adjacency


def _conv_fns(params: dict, a: torch.Tensor, *, stride: int,
              compute_dtype, spatial_impl, temporal_impl, constrain):
    """The block's ``spatial(h)`` and ``temporal(h)``: the configured op,
    or a callable impl, between the ``constrain`` hook's tags."""
    c = constrain if constrain is not None else (lambda h, tag: h)

    def spatial(h):
        h, a_in = c(h, "spatial_in"), c(a, "adjacency")
        if callable(spatial_impl):
            out = spatial_impl(params["spatial"], a_in, h)
        else:
            out = spatial_conv(params["spatial"], a_in, h,
                               compute_dtype=compute_dtype, impl=spatial_impl)
        return c(out, "spatial_out")

    def temporal(h):
        if callable(temporal_impl):
            out = temporal_impl(params["temporal"], h, stride=stride)
        else:
            out = temporal_conv(params["temporal"], h, stride=stride,
                                compute_dtype=compute_dtype,
                                impl=temporal_impl)
        return c(out, "block_out")

    return spatial, temporal


def block_forward(params: dict, state: dict, x: torch.Tensor,
                  adjacency: torch.Tensor, *, stride: int = 1,
                  residual: bool = False,
                  compute_dtype: torch.dtype | None = None,
                  spatial_impl="einsum", temporal_impl="conv",
                  constrain=None, channel_group=None) -> torch.Tensor:
    """One eval-mode ST-GCN unit: ``(N, T, V, C_in) -> (N, T', V, C_out)``
    (the mesh hooks as in the module docstring)."""
    a = effective_adjacency(params, adjacency)
    spatial, temporal = _conv_fns(
        params, a, stride=stride, compute_dtype=compute_dtype,
        spatial_impl=spatial_impl, temporal_impl=temporal_impl,
        constrain=constrain)
    if residual:
        h = torch.relu(batchnorm_eval(params["bn1"], state["bn1"], x))
        h = spatial(h)
        h = torch.relu(batchnorm_eval(params["bn2"], state["bn2"], h,
                                      channel_group=channel_group))
        h = temporal(h)
        if "residual_proj" in params:
            shortcut = pointwise_conv(params["residual_proj"], x,
                                      stride=stride)
        else:
            shortcut = x
        out = h + shortcut
    else:
        h = batchnorm_eval(params["bn1"], state["bn1"], x)
        h = temporal(spatial(h))
        out = batchnorm_eval(params["bn2"], state["bn2"], h)
    return torch.relu(out)


def block_forward_train(params: dict, state: dict, x: torch.Tensor,
                        adjacency: torch.Tensor, *, stride: int = 1,
                        residual: bool = False,
                        compute_dtype: torch.dtype | None = None,
                        dropout_rate: float = 0.0,
                        generator: torch.Generator | None = None,
                        dropout_impl: str = "exact",
                        spatial_impl="einsum", temporal_impl="conv",
                        selective_remat: bool = False,
                        constrain=None, bn_group=None, channel_group=None
                        ) -> tuple[torch.Tensor, dict]:
    """One train-mode ST-GCN unit: ``(N, T, V, C_in) -> (N, T', V, C_out)``.

    Returns ``(out, new_state)``.  In mask mode the gradient lands on
    ``params["mask"]`` through ``adjacency * mask``.  The mesh hooks are
    those of the module docstring.

    ``selective_remat`` is the JAX package's ``remat="selective"``
    (``stgcn_tpu/ops/block.py:166-203``): the backward keeps only the
    block's input and the four conv boundaries, ``spatial_in``,
    ``spatial_out``, ``temporal_in`` and ``temporal_out``.  Each stretch
    between them runs as its own :func:`checkpointed` call, so BN, ReLU,
    the shortcut, the dropout mask and each conv's own intermediates are
    recomputed in the backward (a conv kernel's forward launches again).
    """
    a = effective_adjacency(params, adjacency)

    def run(fn, *args, draws=False):
        # only the stretch with the dropout draws: the others recompute
        # without a generator state of their own
        if not selective_remat:
            return fn(*args)
        return checkpointed(fn, generator if draws else None, *args)

    spatial, temporal = _conv_fns(
        params, a, stride=stride, compute_dtype=compute_dtype,
        spatial_impl=spatial_impl, temporal_impl=temporal_impl,
        constrain=constrain)

    def bn_relu(key, h):
        # the residual order's bn2 sits on the (channel-sharded) spatial
        # output
        h, s = batchnorm_train(
            params[key], state[key], h, group=bn_group,
            channel_group=channel_group if key == "bn2" else None)
        return (torch.relu(h) if residual else h), s

    new_state = {}
    # the phases between the stretches, marked while a profiler records
    x = boundary("bn_stats", "tail", x)
    h, new_state["bn1"] = run(lambda h: bn_relu("bn1", h), x)  # spatial_in
    h = boundary("spatial", "bn_stats", h)
    h = run(spatial, h)                                         # spatial_out
    if residual:
        h = boundary("bn_stats", "spatial", h)
        h, new_state["bn2"] = run(lambda h: bn_relu("bn2", h), h)
        h = boundary("temporal", "bn_stats", h)
        h = run(temporal, h)                                    # temporal_out
        h = boundary("tail", "temporal", h)

        def tail(h, x):
            if "residual_proj" in params:
                shortcut = pointwise_conv(params["residual_proj"], x,
                                          stride=stride)
            else:
                shortcut = x
            return _relu_dropout(h + shortcut, dropout_rate, generator,
                                 dropout_impl)

        return run(tail, h, x, draws=True), new_state
    h = boundary("temporal", "spatial", h)
    h = run(temporal, h)                        # temporal_in is spatial_out
    h = boundary("bn_stats", "temporal", h)

    def tail(h):
        out, s = batchnorm_train(params["bn2"], state["bn2"], h,
                                 group=bn_group)
        out = boundary("tail", "bn_stats", out)
        return _relu_dropout(out, dropout_rate, generator, dropout_impl), s

    out, new_state["bn2"] = run(tail, h, draws=True)
    return out, new_state


class RecomputeStates:
    """Where the recomputes of one step draw their dropout masks on a CUDA
    device (:func:`checkpointed`).

    A recompute must draw the forward's masks: the step's seed at the
    philox offset its stretch started from.  An eager step clones the
    generator's state as each drawing stretch starts (``clone_state``),
    records that offset, and its recompute switches the generator to the
    clone and back (``graphsafe_set_state``).  A CUDA graph takes no new
    generator state while it captures, so a captured step draws each
    recompute from a state of its own made before the capture
    (:meth:`capture_states`), registered with the graph and set before
    every replay to the step's seed at the offset its warm-up recorded
    (:meth:`seed`): the warm-up and the capture run the same stretches in
    the same order, so each draws from the same offset.
    """

    def __init__(self):
        self.offsets: list[int] = []    # the last eager call's stretches
        self.states: list[torch.Generator] = []     # the capture's
        self._taken = 0

    def begin_eager(self) -> None:
        """An eager call of the step begins: record its stretches anew."""
        self.offsets = []

    def capture_states(self, device: torch.device, fresh: bool = True
                       ) -> list:
        """Before a capture: one state a stretch the warm-up drew in, for
        the capture to register with its graph; new ones with ``fresh``,
        else those of the last capture, so that two graphs of one step
        draw from the same states."""
        if fresh or len(self.states) != len(self.offsets):
            self.states = [torch.Generator(device=device)
                           for _ in self.offsets]
        self._taken = 0
        return self.states

    def fork(self, generator: torch.Generator) -> torch.Generator:
        """A generator state at ``generator``'s position, for the
        recompute of the stretch that starts now."""
        if not torch.cuda.is_current_stream_capturing():
            self.offsets.append(generator.get_offset())
            return generator.clone_state()
        if self._taken == len(self.states):
            raise RuntimeError(
                "the captured step reached more drawing stretches than its "
                f"warm-up ({len(self.states)})")
        self._taken += 1
        return self.states[self._taken - 1]

    def finish(self) -> None:
        """After a capture: it drew from every state it registered."""
        if self._taken != len(self.states):
            raise RuntimeError(
                f"the captured step reached {self._taken} drawing stretches, "
                f"its warm-up {len(self.states)}")

    def seed(self, key: int) -> None:
        """Before a replay: each state at the step's seed and its
        stretch's offset."""
        for state, offset in zip(self.states, self.offsets):
            state.manual_seed(key)
            state.set_offset(offset)


class DropoutGenerator(torch.Generator):
    """A step's dropout generator with the :class:`RecomputeStates` of its
    recomputes (``recompute``), which
    :class:`~stgcn_tpu_torch.training.graphs.CapturedStep` makes one a
    graph; any other generator's recomputes draw from eager clones."""

    def __init__(self, device: torch.device):
        super().__init__()      # torch.Generator.__new__ took the device
        self.recompute = RecomputeStates()


def checkpointed(fn, generator: torch.Generator | None, *args):
    """``fn(*args)`` under ``torch.utils.checkpoint`` (non-reentrant): the
    backward keeps ``args`` and recomputes the rest by calling ``fn``
    again.  The checkpoint restores only the global RNGs, not an explicit
    generator, so a stretch that draws from ``generator`` passes it here
    and its recompute draws from the state the first call started from:
    on the CPU ``get_state`` taken before the first call and put back for
    the recompute (the later state restored after it); on CUDA a state of
    :class:`RecomputeStates` switched in with ``graphsafe_set_state``,
    which a CUDA graph can capture.  A stretch that draws nothing passes
    None and keeps no state.  Nothing here draws from the global RNGs, so
    the checkpoint does not save them.  What the recompute returns
    besides the saved tensors, such as new BN running statistics, is
    dropped: the caller keeps the first call's."""
    if generator is None:
        restore = None
    elif generator.device.type == "cpu":
        saved = generator.get_state()

        @contextlib.contextmanager
        def restore():
            later = generator.get_state()
            generator.set_state(saved)
            try:
                yield
            finally:
                generator.set_state(later)
    else:
        states = getattr(generator, "recompute", None) or RecomputeStates()
        fork = states.fork(generator)

        @contextlib.contextmanager
        def restore():
            own = generator.graphsafe_get_state()
            generator.graphsafe_set_state(fork)
            try:
                yield
            finally:
                generator.graphsafe_set_state(own)
    calls = 0

    def run(*inner):
        nonlocal calls
        calls += 1
        if calls == 1 or restore is None:
            return fn(*inner)
        with restore():
            return fn(*inner)

    return checkpoint(run, *args, use_reentrant=False,
                      preserve_rng_state=False)


def _relu_dropout(out, dropout_rate, generator, impl="exact"):
    out = torch.relu(out)
    if dropout_rate > 0.0:
        if generator is None:
            raise ValueError("dropout_rate > 0 in train mode needs a "
                             "generator")
        out = dropout(out, dropout_rate, generator=generator, impl=impl)
    return out


def block_forward_vm(params: dict, state: dict, x: torch.Tensor,
                     adjacency: torch.Tensor, *, stride: int = 1,
                     residual: bool = False, train: bool = False,
                     dropout_rate: float = 0.0,
                     generator: torch.Generator | None = None,
                     dropout_impl: str = "exact"
                     ) -> tuple[torch.Tensor, dict]:
    """One ST-GCN unit on V-major ``(V, N, T, C_in) -> (V, N, T', C_out)``
    (port of ``block_forward_vm``, ``stgcn_tpu/ops/block.py:213-290``).

    Both convs run as the V-major kernels (``spatial_conv_fused_vm`` on
    ``(V, N*T, C)``, ``temporal_conv_fused_vm`` on ``(V*N, T, C)``), in
    ``x``'s dtype; the parameters are the ``(N, T, V, C)`` block's.  BN
    reduces every axis but the channels, so its statistics do not depend on
    the layout.  ``train`` uses the batch statistics and dropout; returns
    ``(out, new_state)``, ``state`` itself in eval.
    """
    if train:
        x = boundary("bn_stats", "tail", x)
    a = effective_adjacency(params, adjacency)
    v, n, t, _ = x.shape

    def bn(key, h):
        if train:
            return batchnorm_train(params[key], state[key], h)
        return batchnorm_eval(params[key], state[key], h), state[key]

    def spatial(h):
        sp = params["spatial"]
        out = spatial_conv_fused_vm(h.reshape(v, n * t, h.shape[-1]),
                                    sp["w"], sp["b"], a.to(h.dtype))
        return out.reshape(v, n, t, out.shape[-1])

    def temporal(h):
        tp = params["temporal"]
        out = temporal_conv_fused_vm(h.reshape(v * n, t, h.shape[-1]),
                                     tp["w"][:, 0], tp["b"], stride)
        return out.reshape(v, n, -1, out.shape[-1])

    new_state = {}
    h, new_state["bn1"] = bn("bn1", x)
    if residual:
        h = spatial(torch.relu(h))
        h, new_state["bn2"] = bn("bn2", h)
        h = temporal(torch.relu(h))
        if "residual_proj" in params:
            # a plain product: outside any Pallas kernel in the JAX package
            # too (stgcn_tpu/ops/block.py:266-273)
            rp = params["residual_proj"]
            xs = x[:, :, ::stride] if stride != 1 else x
            acc = stat_dtype(xs)
            short = ((xs.to(acc) @ rp["w"].to(x.dtype).to(acc)).to(x.dtype)
                     + rp["b"].to(x.dtype))
        else:
            short = x
        out = h + short
    else:
        h = temporal(spatial(h))
        out, new_state["bn2"] = bn("bn2", h)
    if not train:
        return torch.relu(out), state
    return (_relu_dropout(out, dropout_rate, generator, dropout_impl),
            new_state)
