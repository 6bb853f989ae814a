"""Invariant checks inside the train step (port of
``stgcn_tpu/training/checks.py``).

The JAX package asserts its invariants inside the jitted step with
``checkify`` and reads the error once, after the step.  The port's checked
step is a :class:`~stgcn_tpu_torch.training.graphs.CapturedStep` like the
unchecked one, captured in a CUDA graph on a CUDA device: its body
computes three flags on the device and keeps them in one small tensor,
which the step reads back once, after the replay, raising
:class:`InvariantError` with a message that names the first check that
failed:

* labels are within ``[0, num_classes)``; the cross-entropy gathers with
  the labels clamped into that range, as JAX's gather clamps (an
  out-of-range index would be a device-side assert that ends the CUDA
  context);
* the loss is finite;
* every gradient leaf is finite.

The optimizer update and the new BN statistics are predicated on the
flags on the device: a step that trips a check leaves the parameters,
moments and BN statistics bitwise as they were, and takes back the
optimizer's count and per-step scalars and leaves ``ts.step`` alone, so
the next step is the one an untripped run would take.  The read back
makes the checked step wait for its device work each step; use it while
debugging (``--train.check_invariants``): the unchecked step of
:mod:`stgcn_tpu_torch.training.loop` is the production path.

JAX's ``float_checks`` also trip on a NaN made inside any op, naming the
op; the port checks the loss and the gradients only, so a NaN that
cancels before either (a masked branch) passes here.
"""

from __future__ import annotations

import torch

from stgcn_tpu_torch.training import metrics as M
from stgcn_tpu_torch.training.graphs import CapturedStep
from stgcn_tpu_torch.training.loop import (
    begin_train_step,
    end_train_step,
    forward_backward,
)
from stgcn_tpu_torch.training.train_state import TrainState, copy_state_
from stgcn_tpu_torch.utils.profiling import mark


class InvariantError(RuntimeError):
    """An invariant of the checked train step did not hold."""


def _by_dtype(tensors: list[torch.Tensor]) -> list[list[torch.Tensor]]:
    groups: dict = {}
    for t in tensors:
        groups.setdefault(t.dtype, []).append(t)
    return list(groups.values())


def _flat(tensors: list[torch.Tensor]) -> torch.Tensor:
    return torch.cat([t.reshape(-1) for t in tensors])


@torch.no_grad()
def _keep_unless(ok: torch.Tensor, tensors: list, old: torch.Tensor
                 ) -> None:
    """``tensors`` keep their values where the device flag ``ok`` holds,
    else take back ``old`` (their flat copy from before), bitwise: one
    select over the tensors laid end to end."""
    chosen = torch.where(ok, _flat(tensors), old)
    sizes = [t.numel() for t in tensors]
    torch._foreach_copy_(tensors, [v.view_as(t) for v, t in
                                   zip(chosen.split(sizes), tensors)])


def make_checked_train_step(model, *, capture: bool | None = None
                            ) -> CapturedStep:
    """Like ``make_train_step``: ``step(ts, x, y) -> {"loss", "acc"}``,
    raising :class:`InvariantError` when an invariant trips (module
    docstring); ``capture`` as there."""
    num_classes = model.config.num_classes
    checks = (f"label out of range [0, {num_classes})", "non-finite loss",
              "non-finite gradient")

    def body(ts: TrainState, x, y, *, generator=None) -> dict:
        labels_ok = ((y >= 0) & (y < num_classes)).all()
        loss, logits, new_state = forward_backward(
            model, ts, x, y.clamp(0, num_classes - 1), generator=generator)
        mark("optimizer", x.device)
        grads = [p.grad for p in ts.leaves() if p.grad is not None]
        grads_ok = torch.stack([torch.isfinite(_flat(g)).all()
                                for g in _by_dtype(grads)]).all()
        flags = torch.stack([~labels_ok, ~torch.isfinite(loss.detach()),
                             ~grads_ok])
        ok = ~flags.any()
        updated = _by_dtype(ts.tensors())
        kept = [_flat(group) for group in updated]
        ts.optimizer.update()
        copy_state_(ts.model_state, new_state)
        for group, old in zip(updated, kept):
            _keep_unless(ok, group, old)
        return {"loss": loss.detach(), "acc": M.accuracy(logits.detach(), y),
                "flags": flags}

    def check(ts: TrainState, out: dict) -> dict:
        tripped = out["flags"].tolist()     # the step's one read back
        if any(tripped):
            ts.optimizer.revert_step()
            i = tripped.index(True)
            detail = f" {float(out['loss'])}" if i == 1 else ""
            raise InvariantError(checks[i] + detail)
        return {"loss": out["loss"], "acc": out["acc"]}

    return CapturedStep(
        body, state_tensors=lambda ts: ts.tensors() + list(model.buffers()),
        before=begin_train_step(model), check=check, after=end_train_step,
        capture=capture, marks=True, name="checked train step")

