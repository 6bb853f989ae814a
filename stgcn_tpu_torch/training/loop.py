"""Train and eval steps (port of ``make_train_step`` and ``make_eval_step``,
``stgcn_tpu/training/loop.py:35-93``).

One train step does the forward, the float32 cross-entropy, the backward and
the Adam update, and returns the loss and accuracy.  The JAX step is one
jitted function; this one runs eagerly (capturing it in a CUDA graph, and
the epoch loop ``Trainer`` with early stopping and checkpoints, are not
ported yet).
"""

from __future__ import annotations

from typing import Callable

import torch

from stgcn_tpu_torch.training import metrics as M
from stgcn_tpu_torch.training.train_state import TrainState, step_generator


def make_train_step(model, *, use_time_mask: bool = False) -> Callable:
    """``step(ts, x, y, time_mask=None) -> {"loss", "acc"}``.

    With ``use_time_mask`` the step passes an ``(N, T)`` validity mask to
    the forward, so the global pool ignores padded frames (the op path
    only, as in the JAX package); without it a given mask is ignored.

    Updates ``ts`` in place: its parameters (by ``ts.optimizer``, which
    ``create_train_state`` built, so unlike the JAX step this one takes no
    optimizer), ``model_state`` (the new BN running statistics) and
    ``step``.  After a step each parameter leaf's ``.grad`` holds that
    step's gradient.
    """

    def step(ts: TrainState, x: torch.Tensor, y: torch.Tensor,
             time_mask: torch.Tensor | None = None) -> dict:
        gen = None
        if model.config.dropout_rate > 0:
            gen = step_generator(ts.seed, ts.step, x.device)
        ts.optimizer.zero_grad(set_to_none=True)
        logits, new_state = model.apply(
            ts.params, ts.model_state, x, train=True, generator=gen,
            time_mask=time_mask if use_time_mask else None)
        loss = M.cross_entropy(logits, y)
        loss.backward()
        ts.optimizer.step()
        ts.model_state = new_state
        ts.step += 1
        return {"loss": loss.detach(), "acc": M.accuracy(logits.detach(), y)}

    return step


def make_eval_step(model) -> Callable:
    """``step(ts, x, y) -> {"loss_sum", "correct", "count", "cm"}``, the
    per-batch sums of the eval loop, from the running statistics."""
    num_classes = model.config.num_classes

    @torch.no_grad()
    def step(ts: TrainState, x: torch.Tensor, y: torch.Tensor) -> dict:
        logits, _ = model.apply(ts.params, ts.model_state, x, train=False)
        logp = torch.log_softmax(logits.to(torch.float32), dim=-1)
        nll = -logp.gather(-1, y[:, None].long())[:, 0]
        return {"loss_sum": nll.sum(),
                "correct": (logits.argmax(dim=-1) == y).sum(),
                "count": torch.tensor(y.shape[0], device=x.device),
                "cm": M.confusion_matrix(logits, y, num_classes)}

    return step
