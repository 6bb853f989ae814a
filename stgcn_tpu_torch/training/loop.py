"""Train and eval steps and the epoch driver (port of
``stgcn_tpu/training/loop.py``).

One train step does the forward, the float32 cross-entropy, the backward and
the optimizer update, and returns the loss and accuracy.  The JAX step is one
jitted function; this one is a :class:`~stgcn_tpu_torch.training.graphs.
CapturedStep`, captured in a CUDA graph per input signature on a CUDA device
and replayed, eager on the CPU or with ``capture=False``.  Its outputs are
static tensors that its next call overwrites.

:class:`Trainer` is the host-side epoch loop around the steps: evaluation,
early stopping on ``val_loss``, CSV/TensorBoard logging and checkpoints
named ``ckpt_<step>`` with the JAX package's metadata, so a run resumes in
either package.  As in the JAX package, the per-step losses stay on the
device and are fetched once an epoch, and an evaluation pass fetches its
sums once.
"""

from __future__ import annotations

import os
import time
from collections.abc import Iterable
from dataclasses import dataclass, field
from typing import Any, Callable

import numpy as np
import torch

from stgcn_tpu_torch import resolve_device
from stgcn_tpu_torch.training import metrics as M
from stgcn_tpu_torch.training.graphs import CapturedStep
from stgcn_tpu_torch.training.checkpoint import (
    checkpoint_metadata,
    latest_checkpoint,
    restore_checkpoint,
    save_checkpoint,
)
from stgcn_tpu_torch.training.optimizers import adam
from stgcn_tpu_torch.training.train_state import (
    TrainState,
    copy_state_,
    create_train_state,
    step_generator,
    step_key,
)
from stgcn_tpu_torch.utils.profiling import mark

def forward_backward(model, ts: TrainState, x: torch.Tensor,
                     y: torch.Tensor, time_mask: torch.Tensor | None = None,
                     generator: torch.Generator | None = None):
    """The forward, loss and backward of one train step, before the
    update: ``(loss, logits, new_model_state)``, each parameter leaf's
    ``.grad`` holding the step's gradient; ``generator`` draws the
    dropout masks (by default a new one seeded for ``ts.step``)."""
    if generator is None:
        generator = dropout_generator(model, ts, x.device)
    ts.optimizer.zero_grad(set_to_none=True)
    logits, new_state = model.apply(ts.params, ts.model_state, x,
                                    train=True, generator=generator,
                                    time_mask=time_mask)
    loss = M.cross_entropy(logits, y)
    loss.backward()
    return loss, logits, new_state


def apply_update(ts: TrainState, loss, logits, new_state, y) -> dict:
    """The optimizer update and the new BN statistics of a step
    :func:`forward_backward` ran, eagerly; returns its metrics."""
    ts.optimizer.step()
    copy_state_(ts.model_state, new_state)
    ts.step += 1
    return {"loss": loss.detach(), "acc": M.accuracy(logits.detach(), y)}


def dropout_generator(model, ts: TrainState, device: torch.device):
    """The generator of an eager step's dropout masks, or None without
    dropout."""
    if model.config.dropout_rate > 0:
        return step_generator(ts.seed, ts.step, device)
    return None


def begin_train_step(model, shard: tuple[int, ...] = ()) -> Callable:
    """A train step's host work before the device's: the optimizer's count
    and scalars; returns the step's dropout seed (None without
    dropout)."""
    def before(ts: TrainState) -> int | None:
        ts.optimizer.begin_step()
        if model.config.dropout_rate > 0:
            return step_key(ts.seed, ts.step, shard)
        return None
    return before


def end_train_step(ts: TrainState) -> None:
    ts.step += 1


def make_train_step(model, *, use_time_mask: bool = False,
                    capture: bool | None = None) -> CapturedStep:
    """``step(ts, x, y, time_mask=None) -> {"loss", "acc"}``.

    With ``use_time_mask`` the step passes an ``(N, T)`` validity mask to
    the forward, so the global pool ignores padded frames (the op path
    only, as in the JAX package); without it a given mask is ignored.

    Updates ``ts`` in place: its parameters (by ``ts.optimizer``, which
    ``create_train_state`` built, so unlike the JAX step this one takes no
    optimizer), ``model_state`` (the new BN running statistics, written
    into its tensors) and ``step``.  After a step each parameter leaf's
    ``.grad`` holds that step's gradient.  ``capture``: see
    :class:`CapturedStep` (a ``remat`` model's recompute is captured
    too).
    """

    def body(ts: TrainState, x, y, time_mask=None, *, generator=None):
        loss, logits, new_state = forward_backward(
            model, ts, x, y, time_mask if use_time_mask else None,
            generator)
        mark("optimizer", x.device)
        ts.optimizer.update()
        copy_state_(ts.model_state, new_state)
        return {"loss": loss.detach(), "acc": M.accuracy(logits.detach(), y)}

    return CapturedStep(
        body, state_tensors=lambda ts: ts.tensors() + list(model.buffers()),
        before=begin_train_step(model), after=end_train_step,
        capture=capture, marks=True, name="train step")


def make_eval_step(model, *, capture: bool | None = None) -> CapturedStep:
    """``step(ts, x, y) -> {"loss_sum", "correct", "count", "cm"}``, the
    per-batch sums of the eval loop, from the running statistics
    (static tensors, see :class:`CapturedStep`)."""
    num_classes = model.config.num_classes

    @torch.no_grad()
    def body(ts: TrainState, x, y, *, generator=None) -> dict:
        logits, _ = model.apply(ts.params, ts.model_state, x, train=False)
        return eval_sums(logits, y, num_classes)

    return CapturedStep(
        body, state_tensors=lambda ts: ts.tensors() + list(model.buffers()),
        capture=capture, name="eval step")


def eval_sums(logits, y, num_classes) -> dict:
    """The eval step's sums of one batch's logits and labels."""
    logp = torch.log_softmax(logits.to(torch.float32), dim=-1)
    nll = -logp.gather(-1, y[:, None].long())[:, 0]
    return {"loss_sum": nll.sum(),
            "correct": (logits.argmax(dim=-1) == y).sum(),
            "count": torch.full((), y.shape[0], dtype=torch.int64,
                                device=logits.device),
            "cm": M.confusion_matrix(logits, y, num_classes)}


@dataclass
class EarlyStopping:
    """val_loss monitor with patience, as the reference configures
    (patience=100, min_delta=0, mode=min; src/lightning_model.py:21-27)."""

    patience: int = 100
    min_delta: float = 0.0
    best: float = float("inf")
    bad_epochs: int = 0

    def update(self, value: float) -> bool:
        """Returns True when training should stop."""
        if value < self.best - self.min_delta:
            self.best = value
            self.bad_epochs = 0
        else:
            self.bad_epochs += 1
        return self.bad_epochs > self.patience


@dataclass
class TrainResult:
    epochs_run: int = 0
    history: list = field(default_factory=list)
    final_state: Any = None
    test_metrics: dict | None = None


class Trainer:
    """Host-side epoch driver around the train and eval steps.

    ``optimizer``: an optimizer factory such as ``make_optimizer(cfg)``
    (``adam(lr)`` when None).  ``device``: where the state and batches live,
    CUDA unless ``"cpu"`` is asked for.  The steps are captured in CUDA
    graphs there (:func:`make_train_step`), ``remat`` models too;
    ``check_invariants`` runs
    :func:`~stgcn_tpu_torch.training.checks.make_checked_train_step`,
    captured as well, which reads its three flags back once a step and
    raises on a trip.  ``debug_nans`` turns on autograd's anomaly
    detection for the duration of :meth:`fit`, which checks each backward
    op's output on the host: its step runs eagerly and says so.

    ``mesh`` (a :class:`stgcn_tpu_torch.parallel.mesh.Mesh`) runs the
    sharded steps of :mod:`stgcn_tpu_torch.parallel.train` on this rank's
    slice of every batch, on the mesh's device, with ``shard_joints``
    splitting the joints instead of the channels.  Every rank runs the
    same loop on the same global batches.  A checkpoint is written by the
    primary rank only, after the model-sharded leaves are gathered from
    their ranks; a restore slices them again.
    """

    def __init__(
        self,
        model,
        optimizer=None,
        *,
        lr: float = 1e-4,
        logger=None,
        checkpoint_dir: str = "",
        checkpoint_every_epochs: int = 10,
        log_every_steps: int = 10,
        seed: int = 0,
        debug_nans: bool = False,
        check_invariants: bool = False,
        mesh=None,
        shard_joints: bool = False,
        device: str | torch.device | None = None,
    ):
        if check_invariants and mesh is not None:
            raise ValueError(
                "check_invariants is only supported for single-device "
                "training (the checkify'd step is not built for a mesh); "
                "drop --train.check_invariants or the --parallel.* axes")
        self.model = model
        self.optimizer = optimizer or adam(lr)
        self.logger = logger
        self.checkpoint_dir = checkpoint_dir
        self.checkpoint_every_epochs = checkpoint_every_epochs
        self.log_every_steps = log_every_steps
        self.seed = seed
        self.debug_nans = debug_nans
        self.mesh = mesh
        self.shard_joints = shard_joints
        self.device = mesh.device if mesh is not None else \
            resolve_device(device)
        if debug_nans and self.device.type == "cuda":
            print("[graph] train step runs eagerly: debug_nans checks every "
                  "backward op on the host", flush=True)
        self._capture = False if debug_nans else None
        if mesh is not None:
            # built in init_state, as the JAX Trainer builds its
            self.train_step = self.eval_step = None
        elif check_invariants:
            from stgcn_tpu_torch.training.checks import (
                make_checked_train_step,
            )
            self.train_step = make_checked_train_step(model,
                                                      capture=self._capture)
        else:
            self.train_step = make_train_step(model, capture=self._capture)
        if mesh is None:
            self.eval_step = make_eval_step(model)

    # -- state ------------------------------------------------------------
    def init_state(self) -> TrainState:
        if self.mesh is None:
            return create_train_state(self.model, self.optimizer,
                                      seed=self.seed, device=self.device)
        from stgcn_tpu_torch.parallel import train as ptrain

        state, _ = ptrain.create_sharded_train_state(
            self.model, self.optimizer, self.mesh, seed=self.seed,
            shard_joints=self.shard_joints)
        if self.train_step is None:
            self.train_step = ptrain.make_sharded_train_step(
                self.model, self.mesh, shard_joints=self.shard_joints,
                capture=self._capture)
            self.eval_step = ptrain.make_sharded_eval_step(
                self.model, self.mesh, shard_joints=self.shard_joints)
        return state

    def _put_batch(self, x, y):
        if self.mesh is not None:
            from stgcn_tpu_torch.parallel.train import shard_batch

            return shard_batch(x, y, self.mesh,
                               shard_joints=self.shard_joints)
        return (torch.as_tensor(x).to(self.device),
                torch.as_tensor(y).to(self.device))

    def _replicated(self) -> bool:
        """Whether the mesh's state holds every leaf whole."""
        return self.shard_joints or self.model.config.block_impl == "fused"

    def maybe_resume(self, state: TrainState) -> tuple[TrainState, int]:
        """Restore the newest checkpoint into ``state`` if one exists;
        returns (state, epoch).  On a mesh every rank reads it and keeps
        its slices."""
        base = (latest_checkpoint(self.checkpoint_dir)
                if self.checkpoint_dir else None)
        if base is None:
            return state, 0
        if self.mesh is None:
            restored = restore_checkpoint(base, state)
        else:
            from stgcn_tpu_torch.parallel import train as ptrain

            full = ptrain.gather_train_state(state, self.mesh,
                                             replicated=self._replicated())
            restore_checkpoint(base, full)
            restored = ptrain.scatter_train_state(
                full, state, self.mesh, replicated=self._replicated())
        return restored, int(checkpoint_metadata(base).get("epoch", 0))

    # -- loops ------------------------------------------------------------
    def evaluate(self, state: TrainState, data: Iterable) -> dict:
        sums = None
        for x, y, _lens in data:
            out = self.eval_step(state, *self._put_batch(x, y))
            out["loss_sum"] = out["loss_sum"].double()
            # the step's outputs are overwritten by its next call
            sums = ({k: v.clone() for k, v in out.items()} if sums is None
                    else {k: sums[k] + v for k, v in out.items()})
        if sums is None:
            return {"loss": 0.0, "acc": 0.0, "confusion_matrix": None,
                    "count": 0}
        count = int(sums["count"])
        n = max(count, 1)
        return {
            "loss": float(sums["loss_sum"]) / n,
            "acc": int(sums["correct"]) / n,
            "confusion_matrix": sums["cm"].cpu().numpy(),
            "count": count,
        }

    def fit(
        self,
        state: TrainState,
        train_data: Callable[[int], Iterable],
        val_data: Callable[[], Iterable] | None = None,
        *,
        epochs: int = 1,
        min_epochs: int = 0,
        start_epoch: int = 0,
        early_stopping: EarlyStopping | None = None,
        eval_every_epochs: int = 1,
    ) -> TrainResult:
        """Run the training loop.

        Args:
          train_data: ``epoch -> iterable of (x, y, lengths)`` (a fresh,
            possibly reshuffled stream per epoch).
          val_data: ``() -> iterable`` for validation.
        """
        result = TrainResult()
        anomaly = torch.is_anomaly_enabled()
        if self.debug_nans:
            torch.autograd.set_detect_anomaly(True)
        step_i = state.step
        try:
            for epoch in range(start_epoch, epochs):
                t0 = time.time()
                metrics = []
                for x, y, _lens in train_data(epoch):
                    m = self.train_step(state, *self._put_batch(x, y))
                    step_i += 1
                    # a copy on the device: the step's outputs are
                    # overwritten by its next call
                    metrics.append(torch.stack([m["loss"], m["acc"]]))
                    if self.logger and step_i % self.log_every_steps == 0:
                        self.logger.log_dict(
                            {"step_loss": float(m["loss"]),
                             "step_acc": float(m["acc"])}, step_i)

                # one device-to-host fetch an epoch
                pairs = torch.stack(metrics).tolist() if metrics else []
                losses = [loss for loss, _ in pairs]
                accs = [acc for _, acc in pairs]
                epoch_metrics = {
                    "train_loss": float(np.mean(losses)) if losses else 0.0,
                    "train_acc": float(np.mean(accs)) if accs else 0.0,
                    "epoch_time_s": time.time() - t0,
                }
                if (val_data is not None
                        and (epoch + 1) % eval_every_epochs == 0):
                    vm = self.evaluate(state, val_data())
                    epoch_metrics["val_loss"] = vm["loss"]
                    epoch_metrics["val_acc"] = vm["acc"]
                if self.logger:
                    self.logger.log_dict(
                        {k: v for k, v in epoch_metrics.items()
                         if k != "epoch_time_s"}, epoch)
                result.history.append({"epoch": epoch, **epoch_metrics})
                result.epochs_run = epoch + 1

                if (self.checkpoint_dir and
                        (epoch + 1) % self.checkpoint_every_epochs == 0):
                    self.save(state, epoch + 1)

                if (early_stopping is not None and "val_loss" in epoch_metrics
                        and epoch + 1 >= min_epochs
                        and early_stopping.update(epoch_metrics["val_loss"])):
                    break
        finally:
            torch.autograd.set_detect_anomaly(anomaly)
        result.final_state = state
        if self.checkpoint_dir:
            self.save(state, result.epochs_run, final=True)
        return result

    def save(self, state: TrainState, epoch: int, final: bool = False) -> None:
        """``ckpt_<step>`` in ``checkpoint_dir``; on a mesh every rank
        takes part in gathering the sharded leaves and the primary rank
        writes."""
        meta = {"epoch": epoch, "step": state.step, "final": final}
        if self.mesh is not None:
            from stgcn_tpu_torch.parallel import train as ptrain
            from stgcn_tpu_torch.parallel.launcher import is_primary

            state = ptrain.gather_train_state(state, self.mesh,
                                              replicated=self._replicated())
            if not is_primary():
                return
            meta["writer"] = 0
        save_checkpoint(os.path.join(self.checkpoint_dir,
                                     f"ckpt_{state.step}"), state, meta)
