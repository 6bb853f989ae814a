"""Invariant checks around the train step (port of
``stgcn_tpu/training/checks.py``).

The JAX package asserts its invariants inside the jitted step with
``checkify``; the port's checked step runs eagerly, never captured in a
CUDA graph (each check reads a value back to the host), so the checks are
explicit tests between the stages of the step, each raising
:class:`InvariantError` with a message that names it:

* labels are within ``[0, num_classes)`` (an out-of-range label makes the
  cross-entropy gather garbage), before the forward;
* the loss is finite, after the forward;
* every gradient leaf is finite, after the backward.

A step that trips a check leaves the train state as it was: no update, no
new BN statistics, no step counted.  Each check reads one value back from
the device, so the checked step synchronises three times; use it while
debugging (``--train.check_invariants``), the unchecked step of
:mod:`stgcn_tpu_torch.training.loop` is the production path.
"""

from __future__ import annotations

from typing import Callable

import torch

from stgcn_tpu_torch.training.loop import apply_update, forward_backward
from stgcn_tpu_torch.training.train_state import TrainState


class InvariantError(RuntimeError):
    """An invariant of the checked train step did not hold."""


def make_checked_train_step(model) -> Callable:
    """Like ``make_train_step``: ``step(ts, x, y) -> {"loss", "acc"}``,
    raising :class:`InvariantError` when an invariant trips."""
    num_classes = model.config.num_classes

    def step(ts: TrainState, x: torch.Tensor, y: torch.Tensor) -> dict:
        if not bool(((y >= 0) & (y < num_classes)).all()):
            raise InvariantError(f"label out of range [0, {num_classes})")
        loss, logits, new_state = forward_backward(model, ts, x, y)
        if not bool(torch.isfinite(loss)):
            raise InvariantError(f"non-finite loss {float(loss)}")
        grads = [p.grad for p in ts.leaves() if p.grad is not None]
        if not bool(torch.stack([torch.isfinite(g).all()
                                 for g in grads]).all()):
            raise InvariantError("non-finite gradient")
        return apply_update(ts, loss, logits, new_state, y)

    return step
