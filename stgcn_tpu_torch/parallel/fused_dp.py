"""Data parallelism on the fused kernels (port of
``stgcn_tpu/parallel/fused_dp.py``).

The fused forwards (``models/fused.py``) run the whole-block kernels,
whose work is per sequence, so they shard over the batch with the
collectives data parallelism needs and no others:

* eval: none inside; each rank runs ``block_eval`` on its slice and the
  logits are all-gathered over ``data``;
* train: each rank runs ``fused_train_forward`` (``spatial_block``,
  ``spatial_block_save``, ``temporal_block``) with the BatchNorm
  statistics all-reduced over ``data`` inside the forward, so every rank
  normalizes with the global batch's statistics; its objective is its
  share of the global mean loss, and the gradients, the loss and the
  accuracy are summed over ``data`` (the JAX ``pmean``).

Only the ``data`` axis may be larger than one (:func:`check_dp_only`).
Dropout masks are drawn per rank, from a generator seeded with the seed,
the step and the rank's data index (the JAX ``fold_in(step_rng,
axis_index)``, ``:107``): a dropout run is statistically, not bitwise,
the one-rank run; BN statistics and gradients are exact.
"""

from __future__ import annotations

from typing import Callable

import torch

from stgcn_tpu_torch.parallel.collectives import all_gather, all_reduce_
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
from stgcn_tpu_torch.training.train_state import TrainState, copy_state_
from stgcn_tpu_torch.utils.profiling import mark


def check_dp_only(mesh: Mesh, what: str = "block_impl='fused'") -> None:
    if mesh.shape[AXIS_TIME] != 1 or mesh.shape[AXIS_MODEL] != 1:
        raise ValueError(
            f"{what} shards over the data axis only (the megakernel grid is "
            f"per-sequence); got mesh {dict(mesh.shape)}. Use "
            "block_impl='ops' for time/model-axis sharding.")


def fused_eval_forward_dp(model, params, state, x: torch.Tensor,
                          mesh: Mesh) -> torch.Tensor:
    """``models.fused.fused_eval_forward`` on this rank's slice ``x`` of
    the batch (one ``block_eval`` launch a block); returns the global
    ``(N, classes)`` logits, all-gathered over ``data``."""
    from stgcn_tpu_torch.models.fused import fused_eval_forward

    check_dp_only(mesh)
    logits = fused_eval_forward(model, params, state, x)
    return all_gather(logits, mesh.group(AXIS_DATA), 0, "logits")


def make_fused_dp_grads(model, mesh: Mesh) -> Callable:
    """``grads(params, mstate, generator, x, y) -> (loss, acc,
    new_mstate)`` on this rank's slices ``x``, ``y``: each parameter
    leaf's ``.grad`` then holds the global batch's gradient, and ``loss``
    and ``acc`` are the global batch's.  The differentiable core of the
    step, apart so that tests hold gradients (Adam-evolved weights are
    not comparable: several biases feed straight into BatchNorm)."""
    from stgcn_tpu_torch.models.fused import fused_train_forward
    from stgcn_tpu_torch.tree import tree_leaves

    check_dp_only(mesh)
    group = mesh.group(AXIS_DATA)
    share = 1.0 / mesh.shape[AXIS_DATA]

    def grads(params, mstate, generator, x, y):
        leaves = tree_leaves(params)
        for p in leaves:
            p.grad = None
        logits, new_ms = fused_train_forward(model, params, mstate, x,
                                             generator=generator,
                                             bn_group=group)
        loss = M.cross_entropy(logits, y)
        (loss * share).backward()
        mark("grad_sync", x.device)
        with torch.no_grad():
            got = [p.grad if p.grad is not None else torch.zeros_like(p)
                   for p in leaves]
            metrics = torch.stack([
                loss.detach(),
                M.accuracy(logits.detach(), y).to(loss.dtype)]) * share
            all_reduce_(got + [metrics], group, "gradients_and_metrics")
        for p, g in zip(leaves, got):
            p.grad = g
        return metrics[0], metrics[1], new_ms

    return grads


def make_fused_dp_train_step(model, mesh: Mesh, *,
                             capture: bool | None = None) -> CapturedStep:
    """``step(ts, x, y) -> {"loss", "acc"}`` on this rank's slices, with
    the contract of ``make_sharded_train_step``: captured in a CUDA graph
    with its collectives on NCCL (the JAX step is jitted, ``:159``), eager
    on gloo."""
    check_dp_only(mesh)
    sharded_grads = make_fused_dp_grads(model, mesh)

    def body(ts: TrainState, x, y, *, generator=None):
        loss, acc, new_ms = sharded_grads(ts.params, ts.model_state,
                                          generator, x, y)
        mark("optimizer", x.device)
        ts.optimizer.update()
        copy_state_(ts.model_state, new_ms)
        return {"loss": loss, "acc": acc}

    return CapturedStep(
        body, state_tensors=lambda ts: ts.tensors() + list(model.buffers()),
        before=begin_train_step(model, (mesh.index(AXIS_DATA),)),
        after=end_train_step, capture=capture,
        eager_reason=mesh_eager_reason(mesh), marks=True,
        name="fused mesh train step")


def make_fused_dp_eval_step(model, mesh: Mesh, *,
                            capture: bool | None = None) -> CapturedStep:
    """Sharded eval step over the fused forward: the global batch's sums
    (``loss_sum``, ``correct``, ``count``, ``cm``) on every rank (the JAX
    eval step, ``:195``)."""
    check_dp_only(mesh)
    num_classes = model.config.num_classes
    group = mesh.group(AXIS_DATA)

    @torch.no_grad()
    def body(ts: TrainState, x, y, *, generator=None):
        logits = fused_eval_forward_dp(model, ts.params, ts.model_state, x,
                                       mesh)
        y_all = all_gather(y, group, 0, "labels")
        return eval_sums(logits, y_all, num_classes)

    return CapturedStep(
        body, state_tensors=lambda ts: ts.tensors() + list(model.buffers()),
        capture=capture, eager_reason=mesh_eager_reason(mesh),
        name="fused mesh eval step")


def mesh_eager_reason(mesh: Mesh) -> str | None:
    """Why a step on ``mesh`` cannot be captured, or None: gloo runs its
    collectives on the host, which a CUDA graph cannot hold."""
    if mesh.backend == "gloo":
        return "gloo collectives run on the host, outside any CUDA graph"
    return None
