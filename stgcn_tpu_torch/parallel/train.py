"""Sharded train and eval steps on a mesh (port of
``stgcn_tpu/parallel/train.py``).

The JAX package jits the single-device step with shardings and lets GSPMD
insert the collectives.  Here each rank runs the single-device forward on
its shard through ``STGCN.apply``'s mesh hooks, and the collectives are
explicit (:mod:`.collectives`):

* channel mode: the BatchNorm statistics are all-reduced over
  ``data x time`` (bn2 of the residual order normalizes this rank's
  channel slice), the spatial conv is column parallel and the temporal
  conv row parallel over ``model`` (Megatron's ``f`` through the
  ``constrain`` hook, ``g`` in :func:`row_parallel_temporal_conv`), the
  temporal conv exchanges its halo over ``time`` (:mod:`.halo`) and the
  global pool sums over ``time``;
* joint mode (``shard_joints``): V is split over ``model``; the spatial
  conv exchanges the boundary joints (:mod:`.spatial_halo`), the
  statistics and the pool sum over ``model`` too.

Each rank's objective is its share of the global mean loss (``1 / (data x
time)``, and ``1 / model`` more in joint mode), so the gradient of every
leaf is the sum of the ranks' over ``data x time`` (channel mode; a
replicated leaf's is whole on every model rank, a sliced one's is the
slice's) or over every rank (joint mode): averaged over ``data``, summed
over ``time``.  The loss and accuracy are the global batch's on every
rank.  ``block_impl="fused"`` goes to :mod:`.fused_dp`.

Batches are global and identical on every rank (made from one seed);
:func:`shard_batch` takes this rank's slice, as the JAX ``shard_batch``
places each device's.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from stgcn_tpu_torch.parallel import mesh as mesh_lib
from stgcn_tpu_torch.parallel.collectives import (
    all_reduce_,
    gather_tensor,
    reduce_from_group,
)
from stgcn_tpu_torch.parallel.mesh import (
    AXIS_DATA,
    AXIS_MODEL,
    AXIS_TIME,
    Mesh,
)
from stgcn_tpu_torch.training import metrics as M
from stgcn_tpu_torch.training.graphs import CapturedStep
from stgcn_tpu_torch.training.loop import (
    begin_train_step,
    end_train_step,
    eval_sums,
)
from stgcn_tpu_torch.training.train_state import (
    TrainState,
    copy_state_,
    step_generator,
    train_state_from,
)
from stgcn_tpu_torch.tree import tree_leaves
from stgcn_tpu_torch.utils.profiling import mark


def create_sharded_train_state(model, optimizer, mesh: Mesh, seed: int = 0,
                               shard_joints: bool = False
                               ) -> tuple[TrainState, dict]:
    """This rank's train state: the weights of ``model.init_params(seed)``
    (the same on every rank), sliced by :func:`~.mesh.leaf_spec` in
    channel mode, whole in joint mode and on the fused path, on the mesh's
    device, with ``optimizer`` over the local leaves.  Returns ``(state,
    specs)``, ``specs`` the ``{key path: spec}`` of the parameters."""
    model.to(mesh.device)
    params, state = model.init_params(seed)
    replicated = shard_joints or model.config.block_impl == "fused"
    specs = (mesh_lib.replicated_param_specs(params) if replicated
             else mesh_lib.param_partition_specs(params))
    local = mesh_lib.shard_params(params, mesh, replicated=replicated)
    return train_state_from(local, state, optimizer, seed, mesh.device), \
        specs


def select_temporal_impl(mesh: Mesh, configured: str = "conv") -> str:
    """The JAX package's answer for a mesh: ``"halo"`` on any time-sharded
    mesh (the explicit exchange, each rank running the configured impl);
    else the configured impl, with ``pallas`` and ``auto`` taken to
    ``conv`` because the JAX package must (``pallas_call`` has no GSPMD
    partitioning rule).  Kept for parity: the port's steps resolve their
    impl with :func:`_resolve_temporal_impl`, which has no such rule to
    meet and keeps the configured impl on every mesh."""
    if mesh.shape[AXIS_TIME] > 1:
        return "halo"
    if configured in ("pallas", "pallas_interpret", "auto"):
        return "conv"
    return configured


def _check_layout(mesh: Mesh, model) -> None:
    if model.config.layout == "vntc" and mesh.size > 1:
        raise ValueError(
            "layout='vntc' cannot run under a multi-device mesh "
            f"(mesh shape {dict(mesh.shape)}); use layout='ntvc' — the "
            "time-sharded halo path already runs the fused kernels per shard")


def row_parallel_temporal_conv(conv: Callable, group) -> Callable:
    """Channel tensor parallelism's temporal conv: ``conv(params, x, *,
    stride)`` contracts this rank's ``C_in`` slice with the bias held
    back, the partial sums are all-reduced over ``group`` (Megatron's
    ``g``: identity backward) and the bias is added once, after it."""
    def conv_fn(params: dict, x: torch.Tensor, *, stride: int = 1
                ) -> torch.Tensor:
        b = params["b"]
        y = conv({"w": params["w"], "b": torch.zeros_like(b)}, x,
                 stride=stride)
        y = reduce_from_group(y, group)
        return (y + b.to(y.dtype)).to(y.dtype)

    return conv_fn


def _resolve_temporal_impl(mesh: Mesh, model, *, shard_joints: bool):
    """What ``block_forward`` receives: the configured impl on a data
    mesh (``"pallas"``: the ``temporal_conv`` kernel on each rank's
    slice), the halo conv around it on a time-sharded mesh, and under
    channel tensor parallelism (``model > 1``) either one, run at the
    model's compute dtype where there is no halo, inside
    :func:`row_parallel_temporal_conv`.  The halo's inner impl is the
    configured one, ``shift_sum`` and ``auto`` taken to ``conv`` as in
    the JAX package."""
    from stgcn_tpu_torch.ops.temporal_conv import temporal_conv
    from stgcn_tpu_torch.parallel.halo import make_halo_temporal_conv

    cfg = model.config
    channel_tp = not shard_joints and mesh.shape[AXIS_MODEL] > 1
    if mesh.shape[AXIS_TIME] > 1:
        inner = "conv" if cfg.temporal_impl in ("shift_sum", "auto") \
            else cfg.temporal_impl
        conv = make_halo_temporal_conv(mesh, inner_impl=inner)
    elif channel_tp:
        def conv(params, x, *, stride=1):
            return temporal_conv(params, x, stride=stride,
                                 compute_dtype=cfg.compute_dtype,
                                 impl=cfg.temporal_impl)
    else:
        return cfg.temporal_impl
    return (row_parallel_temporal_conv(conv, mesh.group(AXIS_MODEL))
            if channel_tp else conv)


def _resolve_spatial_impl(mesh: Mesh, model, *, shard_joints: bool):
    """Joint mode with a model axis: the boundary-joint exchange (the dense
    plan for ``adjacency_mode="reference"``); else the configured
    impl."""
    if shard_joints and mesh.shape[AXIS_MODEL] > 1:
        from stgcn_tpu_torch.parallel.spatial_halo import (
            make_halo_spatial_conv,
        )

        return make_halo_spatial_conv(
            mesh, model.adjacency.detach().cpu().numpy(),
            dense=model.config.adjacency_mode == "reference")
    return None


def apply_hooks(model, mesh: Mesh, shard_joints: bool = False) -> dict:
    """``STGCN.apply``'s mesh hooks for this rank (module docstring)."""
    stats_axes = (AXIS_DATA, AXIS_TIME) + ((AXIS_MODEL,) if shard_joints
                                          else ())
    pool_axes = (AXIS_TIME,) + ((AXIS_MODEL,) if shard_joints else ())
    channel_tp = not shard_joints and mesh.shape[AXIS_MODEL] > 1

    def group(axes):
        """The axes' group, or None where they hold one rank."""
        size = int(np.prod([mesh.shape[a] for a in axes]))
        return mesh.group(*axes) if size > 1 else None

    return dict(
        bn_group=group(stats_axes),
        pool_group=group(pool_axes),
        channel_group=mesh.group(AXIS_MODEL) if channel_tp else None,
        constrain=mesh_lib.activation_constrainer(mesh, shard_joints),
        temporal_impl=_resolve_temporal_impl(mesh, model,
                                             shard_joints=shard_joints),
        spatial_impl=_resolve_spatial_impl(mesh, model,
                                           shard_joints=shard_joints))


def _shard_index(mesh: Mesh, shard_joints: bool) -> tuple[int, ...]:
    """The rank's coordinates on the axes its activations are split over,
    for its dropout masks (channel-mode model ranks hold replicas and draw
    the same)."""
    axes = (AXIS_DATA, AXIS_TIME) + ((AXIS_MODEL,) if shard_joints else ())
    return tuple(mesh.index(a) for a in axes)


def make_sharded_grads(model, mesh: Mesh, *, shard_joints: bool = False,
                       use_time_mask: bool = False) -> Callable:
    """``grads(ts, x, y, time_mask=None, generator=None) -> (loss, acc,
    new_mstate)`` on this rank's slices, ``generator`` drawing its dropout
    masks (by default :func:`dropout_generator`'s): each parameter
    leaf's ``.grad`` then holds the global batch's gradient (of its
    slice); ``loss`` and ``acc`` are the global batch's.  The
    differentiable core of :func:`make_sharded_train_step`."""
    _check_layout(mesh, model)
    hooks = apply_hooks(model, mesh, shard_joints)
    sum_axes = mesh_lib.AXES if shard_joints else (AXIS_DATA, AXIS_TIME)
    sum_group = mesh.group(*sum_axes)
    share = 1.0 / int(np.prod([mesh.shape[a] for a in sum_axes]))
    data_group = mesh.group(AXIS_DATA)
    d_share = 1.0 / mesh.shape[AXIS_DATA]

    def grads(ts: TrainState, x, y, time_mask=None, generator=None):
        if generator is None:
            generator = dropout_generator(model, mesh, ts, x.device,
                                          shard_joints=shard_joints)
        leaves = tree_leaves(ts.params)
        for p in leaves:
            p.grad = None
        logits, new_ms = model.apply(
            ts.params, ts.model_state, x, train=True, generator=generator,
            time_mask=time_mask if use_time_mask else None, **hooks)
        loss = M.cross_entropy(logits, y)
        (loss * share).backward()
        mark("grad_sync", x.device)
        with torch.no_grad():
            got = [p.grad if p.grad is not None else torch.zeros_like(p)
                   for p in leaves]
            all_reduce_(got, sum_group, "gradients")
            # the logits are whole over time and model: average over data
            metrics = torch.stack([
                loss.detach(),
                M.accuracy(logits.detach(), y).to(loss.dtype)]) * d_share
            all_reduce_([metrics], data_group, "metrics")
        for p, g in zip(leaves, got):
            p.grad = g
        return metrics[0], metrics[1], new_ms

    return grads


def dropout_generator(model, mesh: Mesh, ts: TrainState, device, *,
                      shard_joints: bool = False):
    """An eager sharded step's dropout generator (None without dropout):
    the step's seed with this rank's shard coordinates."""
    if model.config.dropout_rate > 0:
        return step_generator(ts.seed, ts.step, device,
                              _shard_index(mesh, shard_joints))
    return None


def make_sharded_train_step(model, mesh: Mesh, *, shard_joints: bool = False,
                            use_time_mask: bool = False,
                            capture: bool | None = None) -> CapturedStep:
    """Sharded ``step(ts, x, y[, time_mask]) -> {"loss", "acc"}`` on this
    rank's slices (:func:`shard_batch`), updating ``ts`` in place.  On
    NCCL it is captured in a CUDA graph with its collectives, as the JAX
    package jits its step (``stgcn_tpu/parallel/train.py:219``); on gloo
    it runs eagerly (:class:`~stgcn_tpu_torch.training.graphs.
    CapturedStep`, ``capture``).

    ``block_impl="fused"`` runs the data-parallel fused step
    (:mod:`.fused_dp`), which refuses a time or model axis and a time
    mask, as in the JAX package."""
    from stgcn_tpu_torch.parallel.fused_dp import mesh_eager_reason

    if model.config.block_impl == "fused":
        from stgcn_tpu_torch.parallel.fused_dp import (
            check_dp_only,
            make_fused_dp_train_step,
        )

        check_dp_only(mesh)
        if use_time_mask:
            raise ValueError("block_impl='fused' does not support time_mask; "
                             "use block_impl='ops' for masked batches")
        return make_fused_dp_train_step(model, mesh, capture=capture)
    grads = make_sharded_grads(model, mesh, shard_joints=shard_joints,
                               use_time_mask=use_time_mask)

    def body(ts: TrainState, x, y, time_mask=None, *, generator=None):
        loss, acc, new_ms = grads(ts, x, y, time_mask, generator)
        mark("optimizer", x.device)
        ts.optimizer.update()
        copy_state_(ts.model_state, new_ms)
        return {"loss": loss, "acc": acc}

    return CapturedStep(
        body, state_tensors=lambda ts: ts.tensors() + list(model.buffers()),
        before=begin_train_step(model, _shard_index(mesh, shard_joints)),
        after=end_train_step, capture=capture,
        eager_reason=mesh_eager_reason(mesh), marks=True,
        name="mesh train step")


def make_sharded_eval_step(model, mesh: Mesh, *, shard_joints: bool = False,
                           capture: bool | None = None) -> CapturedStep:
    """Sharded ``step(ts, x, y) -> {"loss_sum", "correct", "count",
    "cm"}``: the global batch's sums on every rank, captured as
    :func:`make_sharded_train_step` is (``stgcn_tpu/parallel/
    train.py:263``).  The logits are whole over ``time`` and ``model``
    after the pool, so the sums of each data shard are summed over
    ``data``."""
    from stgcn_tpu_torch.parallel.fused_dp import mesh_eager_reason

    if model.config.block_impl == "fused":
        from stgcn_tpu_torch.parallel.fused_dp import make_fused_dp_eval_step

        return make_fused_dp_eval_step(model, mesh, capture=capture)

    _check_layout(mesh, model)
    hooks = apply_hooks(model, mesh, shard_joints)
    num_classes = model.config.num_classes
    data_group = mesh.group(AXIS_DATA)

    @torch.no_grad()
    def body(ts: TrainState, x, y, *, generator=None):
        logits, _ = model.apply(ts.params, ts.model_state, x, train=False,
                                **hooks)
        sums = eval_sums(logits, y, num_classes)
        sums["loss_sum"] = sums["loss_sum"].double()
        all_reduce_(list(sums.values()), data_group)
        return sums

    return CapturedStep(
        body, state_tensors=lambda ts: ts.tensors() + list(model.buffers()),
        capture=capture, eager_reason=mesh_eager_reason(mesh),
        name="mesh eval step")


def shard_batch(x, y, mesh: Mesh, shard_joints: bool = False,
                time_mask=None):
    """This rank's slice of a global batch (numpy arrays or tensors), on
    the mesh's device: N
    over ``data``, T over ``time`` and, with ``shard_joints``, V over
    ``model`` (:func:`~.mesh.batch_spec`).  Raises ``ValueError`` naming
    the batch and the axis where an axis does not divide its dimension,
    where the JAX package's ``device_put`` fails."""
    def tensor(a):
        return a if torch.is_tensor(a) else torch.as_tensor(np.asarray(a))

    x, y = tensor(x), tensor(y)

    def take(a, spec, name):
        for dim, axis in enumerate(spec):
            if axis is None:
                continue
            n, i = mesh.shape[axis], mesh.index(axis)
            if a.shape[dim] % n:
                raise ValueError(
                    f"{name} of shape {tuple(a.shape)}: dimension {dim} "
                    f"({a.shape[dim]}) is not divisible by the mesh's "
                    f"{axis} axis {n}")
            a = a.narrow(dim, a.shape[dim] // n * i, a.shape[dim] // n)
        return a.contiguous().to(mesh.device)

    out = (take(x, mesh_lib.batch_spec(shard_joints), "batch"),
           take(y, mesh_lib.label_spec(), "labels"))
    if time_mask is not None:
        out += (take(tensor(time_mask), mesh_lib.time_mask_spec(),
                     "time_mask"),)
    return out


def gather_train_state(ts: TrainState, mesh: Mesh, *,
                       replicated: bool = False) -> TrainState:
    """The whole train state from this model group's slices (a collective:
    every rank of the model group calls it): the parameters and the
    optimizer's per-leaf state (Adam's moments, the momentum trace)
    gathered over ``model`` as :func:`~.mesh.gather_params` gathers them,
    in a train state of the same optimizer over the whole leaves, which
    ``save_checkpoint`` writes in the JAX package's layout."""
    from stgcn_tpu_torch.tree import tree_items

    full = mesh_lib.gather_params(ts.params, mesh, replicated=replicated)
    opt = ts.optimizer.spec(tree_leaves(full))
    opt.count = ts.optimizer.count
    for (path, p), f in zip(tree_items(ts.params).items(),
                            tree_leaves(full)):
        dim = None if replicated else mesh_lib.sharded_dim(
            mesh_lib.leaf_spec(path))
        st = {}
        for k, v in ts.optimizer.state.get(p, {}).items():
            if dim is not None and v.shape == p.shape:
                v = gather_tensor(v, mesh.group(AXIS_MODEL), dim, "state")
            st[k] = v.clone()
        if st:
            opt.state[f] = st
    return TrainState(params=full, model_state=ts.model_state,
                      optimizer=opt, step=ts.step, seed=ts.seed)


@torch.no_grad()
def scatter_train_state(full: TrainState, ts: TrainState, mesh: Mesh, *,
                        replicated: bool = False) -> TrainState:
    """Load a whole train state (one restored from a checkpoint) into this
    rank's ``ts`` in place: each leaf and its optimizer state sliced as
    :func:`~.mesh.shard_params` slices it."""
    from stgcn_tpu_torch.tree import tree_items

    local = mesh_lib.shard_params(full.params, mesh, replicated=replicated)
    n, i = mesh.shape[AXIS_MODEL], mesh.index(AXIS_MODEL)
    for (path, p), f, src in zip(tree_items(ts.params).items(),
                                 tree_leaves(full.params),
                                 tree_leaves(local)):
        p.copy_(src)
        dim = None if replicated else mesh_lib.sharded_dim(
            mesh_lib.leaf_spec(path))
        st = {}
        for k, v in full.optimizer.state.get(f, {}).items():
            if dim is not None and v.shape == f.shape and n > 1:
                v = v.chunk(n, dim=dim)[i]
            st[k] = v.clone().to(p.device)
        ts.optimizer.state[p] = st
    ts.optimizer.count = full.optimizer.count
    ts.model_state = {"blocks": [
        {k: {n_: v.to(mesh.device) for n_, v in d.items()}
         for k, d in blk.items()} for blk in full.model_state["blocks"]]}
    ts.step, ts.seed = full.step, full.seed
    return ts
