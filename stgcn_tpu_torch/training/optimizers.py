"""Optimizers and learning-rate schedules with optax's numerics (port of
``stgcn_tpu/training/optimizers.py``).

The JAX package composes optax transforms; the GPU machine has no optax, so
this module writes each formula out and applies it with PyTorch's
multi-tensor (``foreach``) ops over the parameter leaves, in place.

Schedules (:func:`make_schedule`), a function of the update count ``c``:

* ``constant``: ``lr``;
* ``cosine``: ``lr·0.5·(1 + cos(π·min(c, decay_steps)/decay_steps))``
  (``optax.cosine_decay_schedule``, alpha 0);
* ``step``: ``lr·factor^floor(c/decay_steps)`` for ``c > 0``, ``lr`` at 0
  (``optax.exponential_decay(..., staircase=True)``);
* with warmup ``w > 0``: ``(0 - lr)·(1 - min(c, w)/w) + lr`` below ``w``
  (``optax.linear_schedule(0, lr, w)``), then the schedule at ``c - w``
  (``optax.join_schedules``).

Optimizers (:func:`make_optimizer`), ``g`` the gradient, ``lr`` the
schedule's value:

* ``adam``: ``mu = (1-b1)·g + b1·mu``, ``nu = (1-b2)·g² + b2·nu``, then
  ``p += -lr·(mu/(1-b1^t)) / (sqrt(nu/(1-b2^t)) + eps)`` with ``t`` the
  count after the update;
* ``adamw``: adam with the decay inside the scaled update,
  ``p += -lr·(adam + weight_decay·p)`` (``optax.adamw``; ``torch.optim.
  AdamW`` scales ``p`` by ``1 - lr·wd`` first, the same value in other
  roundings);
* ``flat_adam``: adam's numerics in float32 whatever the parameters' dtype
  (the JAX package keeps its moments as float32 vectors);
* ``sgd``: ``p += -lr·g``; ``momentum``: ``trace = g + momentum·trace``,
  ``p += -lr·trace``; with ``weight_decay`` and ``nesterov``, in
  ``torch.optim.SGD``'s form (dampening 0): ``g += weight_decay·p``, then
  the trace, then ``p += -lr·(g + momentum·trace)`` with Nesterov (both
  off by default; :func:`make_optimizer` passes the config's decay to
  ``adamw`` only, as the JAX package does);
* with ``clip_norm > 0`` the gradient first goes through optax's
  ``clip_by_global_norm``: with ``n = sqrt(Σ g²)`` over every leaf, ``g``
  is kept when ``n < clip_norm`` and becomes ``g / n · clip_norm``
  otherwise (no epsilon, unlike ``torch.nn.utils.clip_grad_norm_``, which
  scales by ``clip_norm / (n + 1e-6)``).

**The schedule count.**  optax's ``scale_by_schedule`` evaluates the
schedule at the count *before* the update, so update ``i`` (from 0) takes
``lr(i)``: under warmup the first update has ``lr = 0``.  The JAX
package's ``flat_adam`` evaluates it at the count after the update,
``lr(i + 1)`` (``stgcn_tpu/training/optimizers.py:69-71``).  That quirk of
the reference is reproduced here, not fixed.

Optimizer state in a checkpoint (:func:`opt_state_tree`,
:func:`load_opt_state`) takes optax's tree for the same optimizer, so a
checkpoint moves between the packages.  Key paths under ``opt_state/``:

* ``adam``: ``0/count``, ``0/mu/<parameter path>``, ``0/nu/<path>``, and
  ``1/count`` when the learning rate is a schedule (``make_optimizer``
  always passes one; ``adam(1e-3)`` has a constant);
* ``adamw``: adam's ``0/...`` and ``2/count``;
* ``sgd``: ``1/count``; ``momentum``: ``0/trace/<path>`` and ``1/count``;
* ``flat_adam``: ``count``, ``flat_mu`` and ``flat_nu``, each moment one
  float32 vector of every parameter leaf raveled in the JAX package's leaf
  order (dictionary keys sorted, lists in order:
  :func:`stgcn_tpu_torch.tree.tree_leaves`);
* with clipping, the tree above under ``1/`` (``0`` is the clip's empty
  state).

Per parameter the optimizer keeps ``exp_avg`` (``mu``), ``exp_avg_sq``
(``nu``) and ``step`` (the count, a float32 scalar), as ``torch.optim.Adam``
names them, or ``momentum_buffer`` (``trace``); a restored run takes the
same next update.
"""

from __future__ import annotations

import dataclasses
import math
from collections.abc import Callable, Sequence

import numpy as np
import torch

from stgcn_tpu_torch.tree import tree_leaves, tree_map

Schedule = Callable[[int], float]

OPTIMIZERS = ("adam", "flat_adam", "adamw", "sgd", "momentum")
_ADAMS = ("adam", "flat_adam", "adamw")


# ---- schedules ----------------------------------------------------------

def constant_schedule(value: float) -> Schedule:
    return lambda count: value


def cosine_decay_schedule(init_value: float, decay_steps: int) -> Schedule:
    """``optax.cosine_decay_schedule(init_value, decay_steps)``."""
    if not decay_steps > 0:
        raise ValueError(f"the cosine schedule needs positive decay_steps, "
                         f"got {decay_steps}")

    def schedule(count):
        c = min(count, decay_steps)
        return init_value * (0.5 * (1 + math.cos(math.pi * c / decay_steps)))
    return schedule


def exponential_decay(init_value: float, transition_steps: int,
                      decay_rate: float) -> Schedule:
    """``optax.exponential_decay(..., staircase=True)`` (no
    ``transition_begin``, ``end_value``); a constant for
    ``transition_steps <= 0`` or a zero rate, as there."""
    if transition_steps <= 0 or decay_rate == 0:
        return constant_schedule(init_value)

    def schedule(count):
        p = math.floor(count / transition_steps)
        return init_value if count <= 0 else init_value * decay_rate ** p
    return schedule


def linear_schedule(init_value: float, end_value: float,
                    transition_steps: int) -> Schedule:
    """``optax.linear_schedule`` (``polynomial_schedule`` of power 1)."""
    if transition_steps <= 0:
        return constant_schedule(init_value)

    def schedule(count):
        c = min(max(count, 0), transition_steps)
        frac = 1 - c / transition_steps
        return (init_value - end_value) * frac + end_value
    return schedule


def join_schedules(schedules: Sequence[Schedule],
                   boundaries: Sequence[int]) -> Schedule:
    """``optax.join_schedules``: past each boundary the next schedule, at
    the count less the boundary."""
    def schedule(count):
        out = schedules[0](count)
        for boundary, sched in zip(boundaries, schedules[1:]):
            if count >= boundary:
                out = sched(count - boundary)
        return out
    return schedule


def make_schedule(cfg) -> Schedule:
    """The schedule of a ``TrainSection``-like config (``lr``,
    ``lr_schedule``, ``lr_warmup_steps``, ``lr_decay_steps``,
    ``lr_step_factor``)."""
    base = cfg.lr
    if cfg.lr_schedule == "constant":
        sched = constant_schedule(base)
    elif cfg.lr_schedule == "cosine":
        sched = cosine_decay_schedule(base, cfg.lr_decay_steps)
    elif cfg.lr_schedule == "step":
        sched = exponential_decay(base, cfg.lr_decay_steps,
                                  cfg.lr_step_factor)
    else:
        raise ValueError(f"unknown lr_schedule {cfg.lr_schedule!r}")
    if cfg.lr_warmup_steps > 0:
        warmup = linear_schedule(0.0, base, cfg.lr_warmup_steps)
        sched = join_schedules([warmup, sched], [cfg.lr_warmup_steps])
    return sched


# ---- optimizers ---------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class OptimizerSpec:
    """One of :data:`OPTIMIZERS` with its hyperparameters; call it on the
    parameter leaves to get the :class:`OptaxOptimizer` that updates them
    in place.  ``learning_rate`` is a number or a schedule (a function of
    the update count)."""

    name: str = "adam"
    learning_rate: float | Schedule = 1e-3
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 0.0
    momentum: float = 0.9
    clip_norm: float = 0.0
    nesterov: bool = False

    def __post_init__(self):
        if self.name not in OPTIMIZERS:
            raise ValueError(f"unknown optimizer {self.name!r}")

    @property
    def scheduled(self) -> bool:
        return callable(self.learning_rate)

    def lr(self, count: int) -> float:
        if not self.scheduled:
            return self.learning_rate
        # flat_adam's quirk: the count after the update (module docstring)
        return self.learning_rate(count + (self.name == "flat_adam"))

    def __call__(self, leaves: list[torch.Tensor]) -> "OptaxOptimizer":
        return OptaxOptimizer(leaves, self)


def adam(learning_rate: float | Schedule = 1e-3, b1: float = 0.9,
         b2: float = 0.999, eps: float = 1e-8) -> OptimizerSpec:
    return OptimizerSpec("adam", learning_rate, b1, b2, eps)


def flat_adam(learning_rate: float | Schedule = 1e-3, b1: float = 0.9,
              b2: float = 0.999, eps: float = 1e-8) -> OptimizerSpec:
    """Adam in float32 whose checkpoints store each moment as one flat
    vector."""
    return OptimizerSpec("flat_adam", learning_rate, b1, b2, eps)


def make_optimizer(cfg) -> OptimizerSpec:
    """The optimizer of a ``TrainSection``-like config (``optimizer``,
    ``weight_decay``, ``momentum``, ``grad_clip_norm`` and the schedule's
    fields), as the JAX package's ``make_optimizer`` builds it."""
    clip = cfg.grad_clip_norm if cfg.grad_clip_norm > 0 else 0.0
    decay = cfg.weight_decay if cfg.optimizer == "adamw" else 0.0
    return OptimizerSpec(cfg.optimizer, make_schedule(cfg),
                         weight_decay=decay, momentum=cfg.momentum,
                         clip_norm=clip)


class OptaxOptimizer(torch.optim.Optimizer):
    """The update of an :class:`OptimizerSpec` on a list of leaves; the
    gradient of a leaf without ``.grad`` counts as zeros, as in optax.

    :meth:`step` is :meth:`begin_step`, the host's part (the count, the
    schedule's value and Adam's bias corrections, computed as Python
    floats, and the moments made where they are missing), then
    :meth:`update`, the device's part.  The update reads the per-step
    scalars from 0-d tensors on the leaves' device, which
    :meth:`begin_step` fills, so a CUDA graph that captured
    :meth:`update` replays each step's values
    (:mod:`stgcn_tpu_torch.training.graphs`)."""

    def __init__(self, leaves: list[torch.Tensor], spec: OptimizerSpec):
        super().__init__(list(leaves), {})
        self.spec = spec
        self.count = 0          # updates taken
        self._host: dict[str, float] = {}
        self._scalars: dict[str, torch.Tensor] = {}

    def _params(self) -> list[torch.Tensor]:
        return [p for group in self.param_groups for p in group["params"]]

    def step(self, closure=None):
        self.begin_step()
        self.update()

    @torch.no_grad()
    def begin_step(self) -> None:
        """Advance the count and set this update's scalars: ``lr`` (the
        schedule at the count before the update, after it for
        ``flat_adam``), and for the Adams ``bc1``, ``bc2`` (``1 - b^t``,
        ``t`` the count after the update; float32 arithmetic for
        ``flat_adam``, as ``jnp.power`` of float32 operands) and each
        leaf's ``step``."""
        spec = self.spec
        params = self._params()
        self.count += 1
        host = self._step_values(self.count)
        step = torch.tensor(float(self.count), dtype=torch.float32)
        for p in params:
            st = self.state[p]
            if spec.name in _ADAMS:
                if "exp_avg" not in st:
                    dt = torch.float32 if spec.name == "flat_adam" else None
                    st["exp_avg"] = torch.zeros_like(p, dtype=dt)
                    st["exp_avg_sq"] = torch.zeros_like(p, dtype=dt)
                st["step"] = step
            elif spec.name == "momentum" and "momentum_buffer" not in st:
                st["momentum_buffer"] = torch.zeros_like(p)
        if not self._scalars and params:
            # the arithmetic type of the update: float64 leaves take the
            # values whole, as the Python floats did; flat_adam computes
            # in float32
            wide = (spec.name != "flat_adam"
                    and params[0].dtype == torch.float64)
            self._scalars = {k: torch.zeros(
                (), dtype=torch.float64 if wide else torch.float32,
                device=params[0].device) for k in host}
        self._set_scalars(host)

    def _step_values(self, t: int) -> dict[str, float]:
        """The host's scalars of update ``t`` (from 1)."""
        spec = self.spec
        host = {"lr": spec.lr(t - 1)}
        if spec.name == "flat_adam":
            host["bc1"], host["bc2"] = (float(np.float32(1.0) - np.power(
                np.float32(b), np.float32(t))) for b in (spec.b1, spec.b2))
        elif spec.name in _ADAMS:
            host["bc1"], host["bc2"] = 1 - spec.b1 ** t, 1 - spec.b2 ** t
        host["neg_lr"] = -host["lr"]
        return host

    def _set_scalars(self, host: dict[str, float]) -> None:
        for k, v in host.items():
            self._scalars[k].fill_(v)
        self._host = host

    @torch.no_grad()
    def revert_step(self) -> None:
        """Take back the last :meth:`begin_step`, for a step whose update
        did not land (the checked step's trip): the count, each leaf's
        ``step`` and the per-step scalars are the last update's again."""
        self.count -= 1
        step = torch.tensor(float(self.count), dtype=torch.float32)
        for st in self.state.values():
            if "step" in st:
                st["step"] = step
        if self.count:
            self._set_scalars(self._step_values(self.count))

    def state_tensors(self) -> list[torch.Tensor]:
        """The device tensors :meth:`update` reads and writes besides the
        leaves and their gradients: the moments and the per-step
        scalars."""
        keys = ("exp_avg", "exp_avg_sq", "momentum_buffer")
        return [st[k] for st in self.state.values() for k in keys
                if k in st] + list(self._scalars.values())

    @torch.no_grad()
    def update(self) -> None:
        """The update of the scalars :meth:`begin_step` set, in place."""
        spec, sc = self.spec, self._scalars
        params = self._params()
        grads = [torch.zeros_like(p) if p.grad is None else p.grad
                 for p in params]
        if spec.clip_norm > 0:
            grads = _clip_by_global_norm(grads, spec.clip_norm)
        if spec.name == "flat_adam":
            # -lr * mu_hat / (sqrt(nu_hat) + eps), in that order, float32
            mu_hat, denom = self._adam(params, grads)
            updates = torch._foreach_div(
                torch._foreach_mul(mu_hat, sc["neg_lr"]), denom)
            torch._foreach_add_(params, [u.to(p.dtype) for u, p
                                         in zip(updates, params)])
            return
        if spec.name in _ADAMS:
            updates = torch._foreach_div(*self._adam(params, grads))
            if spec.name == "adamw":
                torch._foreach_add_(updates, params, alpha=spec.weight_decay)
        elif spec.name == "momentum":
            if spec.weight_decay:
                grads = torch._foreach_add(grads, params,
                                           alpha=spec.weight_decay)
            trace = [self.state[p]["momentum_buffer"] for p in params]
            torch._foreach_mul_(trace, spec.momentum)
            torch._foreach_add_(trace, grads)
            updates = (torch._foreach_add(grads, trace, alpha=spec.momentum)
                       if spec.nesterov else trace)
        else:
            updates = grads
        _add_scaled_(params, updates, sc["neg_lr"], self._host["neg_lr"])

    def _adam(self, params, grads):
        """Moments updated in place; returns ``mu_hat`` and
        ``sqrt(nu_hat) + eps``, the bias-corrected moments."""
        spec, sc = self.spec, self._scalars
        if spec.name == "flat_adam":
            grads = [g.to(torch.float32) for g in grads]
        mu = [self.state[p]["exp_avg"] for p in params]
        nu = [self.state[p]["exp_avg_sq"] for p in params]
        torch._foreach_mul_(mu, spec.b1)
        torch._foreach_add_(mu, grads, alpha=1 - spec.b1)
        torch._foreach_mul_(nu, spec.b2)
        torch._foreach_addcmul_(nu, grads, grads, value=1 - spec.b2)
        mu_hat = torch._foreach_div(mu, sc["bc1"])
        denom = torch._foreach_sqrt(torch._foreach_div(nu, sc["bc2"]))
        torch._foreach_add_(denom, spec.eps)
        return mu_hat, denom


def _add_scaled_(params, updates, scale: torch.Tensor, host_scale: float
                 ) -> None:
    """``params += scale * updates``.  On the CPU one add with the host's
    float as ``alpha`` (a fused multiply-add there, the rounding every
    update had before the scalars moved to the device); elsewhere the
    multiply reads ``scale`` from the device, so a captured graph replays
    each step's value."""
    if params and params[0].device.type == "cpu":
        torch._foreach_add_(params, updates, alpha=host_scale)
    else:
        torch._foreach_add_(params, torch._foreach_mul(updates, scale))


def _clip_by_global_norm(grads: list[torch.Tensor], max_norm: float
                         ) -> list[torch.Tensor]:
    """optax's ``clip_by_global_norm`` (module docstring), on the device:
    no host synchronisation."""
    norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
    keep = norm < max_norm
    clipped = torch._foreach_mul(torch._foreach_div(grads, norm), max_norm)
    return [torch.where(keep, g, c) for g, c in zip(grads, clipped)]


# ---- optimizer state in optax's tree ------------------------------------

def opt_state_tree(optimizer: OptaxOptimizer, params: dict):
    """The optimizer's state as the JAX package's ``opt_state`` tree of
    numpy arrays (module docstring; zeros for a leaf not stepped yet)."""
    spec = optimizer.spec
    leaves = tree_leaves(params)
    count = np.asarray(optimizer.count, np.int32)

    def moments(key, dtype=None):
        out = []
        for p in leaves:
            m = optimizer.state.get(p, {}).get(key)
            m = torch.zeros_like(p) if m is None else m.detach()
            out.append(m.to(dtype or m.dtype).cpu().numpy())
        return out

    def as_tree(ms):
        index = {id(p): i for i, p in enumerate(leaves)}
        return tree_map(lambda p: ms[index[id(p)]], params)

    if spec.name == "flat_adam":
        core = {"count": count, **{
            f"flat_{n}": np.concatenate([m.ravel() for m in moments(
                key, torch.float32)])
            for n, key in (("mu", "exp_avg"), ("nu", "exp_avg_sq"))}}
    else:
        if spec.name in _ADAMS:
            first = {"count": count,
                     "mu": as_tree(moments("exp_avg")),
                     "nu": as_tree(moments("exp_avg_sq"))}
        elif spec.name == "momentum":
            first = {"trace": as_tree(moments("momentum_buffer"))}
        else:
            first = {}
        core = [first] + [{}] * (spec.name == "adamw") + [
            {"count": count} if spec.scheduled else {}]
    return [{}, core] if spec.clip_norm > 0 else core


def load_opt_state(optimizer: OptaxOptimizer, params: dict, tree) -> None:
    """Set the optimizer's state from an ``opt_state`` tree in the layout
    :func:`opt_state_tree` gives (numpy arrays or tensors)."""
    spec = optimizer.spec
    leaves = tree_leaves(params)
    if spec.clip_norm > 0:
        tree = tree[1]
    if spec.name == "flat_adam":
        count = tree["count"]
        sizes = [p.numel() for p in leaves]
        state = {key: np.split(np.asarray(tree[f"flat_{n}"]),
                               np.cumsum(sizes)[:-1])
                 for n, key in (("mu", "exp_avg"), ("nu", "exp_avg_sq"))}
    elif spec.name in _ADAMS:
        count = tree[0]["count"]
        state = {key: tree_leaves(tree[0][n])
                 for n, key in (("mu", "exp_avg"), ("nu", "exp_avg_sq"))}
    else:
        count = tree[-1]["count"] if spec.scheduled else 0
        state = ({"momentum_buffer": tree_leaves(tree[0]["trace"])}
                 if spec.name == "momentum" else {})
    for key, ms in state.items():
        if len(ms) != len(leaves):
            raise ValueError(f"opt_state holds {len(ms)} moments for "
                             f"{len(leaves)} parameter leaves")
    optimizer.count = int(np.asarray(count))
    step = torch.tensor(float(optimizer.count), dtype=torch.float32)
    moment_dtype = torch.float32 if spec.name == "flat_adam" else None
    for i, p in enumerate(leaves):
        st = {key: torch.as_tensor(np.array(ms[i])).reshape(p.shape).to(
            dtype=moment_dtype or p.dtype, device=p.device)
            for key, ms in state.items()}
        if spec.name in _ADAMS:
            st["step"] = step
        optimizer.state[p] = st
