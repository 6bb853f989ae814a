"""The checked train step (``stgcn_tpu_torch/training/checks.py``), a
``CapturedStep`` that runs its body eagerly on the CPU, against the JAX
package's ``make_checked_train_step``; and ``metrics.topk_accuracy``.

Held here, on a small model (2 blocks, C <= 16, T = 16, B = 4, the op
path, dropout 0: the two packages' masks differ), every input from a
numpy seed:

* **JAX parity.**  Good steps: the losses rtol 1e-4 and, with
  ``tests/test_torch_graphs.py``'s tolerances, the first step's gradients
  rtol 1e-4 (floor 1e-4 of the largest) and the BN statistics after it
  rtol 1e-4 (floor 1e-5).
* **Trips.**  An out-of-range label, a NaN in the input and a NaN
  gradient (a hook on the head's bias in the port, a custom VJP on it in
  JAX) trip both packages' steps, each naming the same check.
* **Where they differ.**  JAX's ``float_checks`` also flag a NaN made
  inside any op, naming the primitive; the port checks only the loss and
  the gradients.  A NaN made in a branch that ``where`` discards, with no
  gradient through it, trips JAX's step ("nan generated by primitive
  sqrt") and passes the port's, whose loss and gradients are finite
  (pinned; ROADMAP.md queue 3 item 4).
* **State.**  After a trip the port's state (parameters, BN statistics,
  moments, the optimizer's scalars), ``ts.step`` and the optimizer's count
  are bitwise as they were, and the next good step is bitwise the step of
  a run that never saw the bad batch, as JAX's next step is its own
  (the loss rtol 1e-4).
* **Remat.**  The checked step of a ``remat=True`` model, dropout 0.5,
  bitwise the unchecked step without remat (the recompute draws the
  forward's masks).
* **Trainer.**  ``Trainer(check_invariants=True)`` builds the checked
  step as a ``CapturedStep``.
* **topk_accuracy** against the JAX function at k=1 and k=3.
"""

import numpy as np
import optax
import pytest

import jax
import jax.numpy as jnp
import torch
from jax.experimental import checkify

from stgcn_tpu.graph.adjacency import Strategy
from stgcn_tpu.models.stgcn import STGCN as JaxSTGCN
from stgcn_tpu.models.stgcn import STGCNConfig as JaxConfig
from stgcn_tpu.training import metrics as jax_metrics
from stgcn_tpu.training.checks import (
    make_checked_train_step as jax_make_checked_train_step,
)
from stgcn_tpu.training.train_state import TrainState as JaxTrainState
from stgcn_tpu_torch.models import stgcn as tm
from stgcn_tpu_torch.models.convert import params_from_jax, params_to_numpy
from stgcn_tpu_torch.training import metrics
from stgcn_tpu_torch.training import optimizers as opt
from stgcn_tpu_torch.training.checks import (
    InvariantError,
    make_checked_train_step,
)
from stgcn_tpu_torch.training.graphs import CapturedStep
from stgcn_tpu_torch.training.loop import Trainer, make_train_step
from stgcn_tpu_torch.training.train_state import train_state_from
from stgcn_tpu_torch.tree import tree_leaves, tree_map

PLAN = ((8, 1), (16, 2))
N, T = 4, 16
CPU = torch.device("cpu")
COMMON = dict(plan=PLAN, strategy=Strategy.DISTANCE, d=1, residual=True)
LABEL = "label out of range"
# the check each package names for each bad batch (module docstring)
TRIPS = {"label": (LABEL, LABEL),
         "nan_input": ("non-finite loss", "non-finite loss"),
         "nan_gradient": ("non-finite gradient", "non-finite gradient")}


@pytest.fixture(autouse=True)
def few_torch_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(min(threads, 2))
    yield
    torch.set_num_threads(threads)


def batch(seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 1, (N, T, 25, 2)).astype(np.float32)
    return x, rng.integers(0, 6, N).astype(np.int32)


class HeadBias:
    """A model whose head's bias goes through ``fn`` before the forward
    (``config``, ``apply`` and ``buffers`` as the model's)."""

    def __init__(self, model, fn):
        self.model, self.fn, self.config = model, fn, model.config

    def apply(self, params, *args, **kw):
        fc = dict(params["fc"], b=self.fn(params["fc"]["b"]))
        return self.model.apply(dict(params, fc=fc), *args, **kw)

    def buffers(self):
        return self.model.buffers()


@jax.custom_vjp
def nan_gradient(b):
    """The identity, whose gradient is NaN (JAX's stand-in for the port's
    hook)."""
    return b


nan_gradient.defvjp(lambda b: (b, None),
                    lambda _, g: (g * jnp.float32(np.nan),))


@pytest.fixture(scope="module")
def jax_side():
    """The JAX model, its first state over the port's seed-0 weights (as
    numpy arrays in ``start``), the checked steps (each jitted once for
    the module: plain, and with the head's bias through
    ``nan_gradient``) and the state after one good step on
    ``batch(1)``."""
    model = JaxSTGCN(JaxConfig(**COMMON))
    start = tuple(params_to_numpy(t) for t in port_model().init_params(0))
    params, state = (jax.tree.map(jnp.asarray, t) for t in start)
    jts = JaxTrainState(params=params, model_state=state,
                        opt_state=optax.adam(1e-3).init(params),
                        step=jnp.zeros((), jnp.int32), rng=jax.random.key(0))
    steps = {"plain": jax_make_checked_train_step(model, optax.adam(1e-3)),
             "nan_gradient": jax_make_checked_train_step(
                 HeadBias(model, nan_gradient), optax.adam(1e-3))}
    x, y = batch(1)
    after_one, _ = steps["plain"](jts, jnp.asarray(x), jnp.asarray(y))
    return dict(model=model, jts=jts, start=start, steps=steps,
                after_one=after_one)


def port_state(start):
    return train_state_from(*params_from_jax(*start), opt.adam(1e-3), 0, CPU)


def port_model():
    return tm.STGCN(tm.STGCNConfig(**COMMON))


def _close(got, want, rtol, rel_atol):
    got_l = [np.asarray(g, np.float64) for g in tree_leaves(got)]
    want_l = [np.asarray(w, np.float64) for w in jax.tree.leaves(want)]
    assert len(got_l) == len(want_l)
    scale = max(float(np.abs(w).max(initial=0.0)) for w in want_l)
    for i, (g, w) in enumerate(zip(got_l, want_l)):
        np.testing.assert_allclose(g, w, rtol=rtol, atol=rel_atol * scale,
                                   err_msg=f"leaf {i}")


def test_good_steps_match_jax(jax_side):
    jax_model, jts = jax_side["model"], jax_side["jts"]
    x, y = batch(1)
    xj, yj = jnp.asarray(x), jnp.asarray(y)

    def loss_fn(params):
        logits, _ = jax_model.apply(params, jts.model_state, xj, train=True)
        return jax_metrics.cross_entropy(logits, yj)

    grads0 = jax.jit(jax.grad(loss_fn))(jts.params)
    model = port_model()
    ts = port_state(jax_side["start"])
    step = make_checked_train_step(model)
    assert isinstance(step, CapturedStep)
    losses, jax_losses = [], []
    for i in range(3):
        out = step(ts, torch.from_numpy(x), torch.from_numpy(y))
        assert sorted(out) == ["acc", "loss"]
        losses.append(float(out["loss"]))
        jts, met = jax_side["steps"]["plain"](jts, xj, yj)
        jax_losses.append(float(met["loss"]))
        if i == 0:
            _close(tree_map(lambda p: p.grad.numpy(), ts.params),
                   jax.tree.map(np.asarray, grads0), 1e-4, 1e-4)
            _close(params_to_numpy(ts.model_state),
                   jax.tree.map(np.asarray, jts.model_state), 1e-4, 1e-5)
    np.testing.assert_allclose(losses, jax_losses, rtol=1e-4, atol=1e-5)
    assert ts.step == ts.optimizer.count == 3


def bad_batch(case, x, y):
    x, y = x.copy(), y.copy()
    if case == "label":
        y[0] = 6
    elif case == "nan_input":
        x[1, 2, 3, 0] = np.nan
    return x, y


@pytest.mark.parametrize("case", sorted(TRIPS))
def test_trips_leave_the_state_and_the_next_step(jax_side, case):
    x, y = batch(1)
    good = (torch.from_numpy(x), torch.from_numpy(y))
    model = port_model()
    step, ref_step = (make_checked_train_step(model) for _ in range(2))
    ts, untripped = (port_state(jax_side["start"]) for _ in range(2))
    step(ts, *good)
    ref_step(untripped, *good)
    jts = jax_side["after_one"]

    before = [t.clone() for t in ts.tensors()]
    xb, yb = bad_batch(case, x, y)
    port_msg, jax_msg = TRIPS[case]
    handle = None
    if case == "nan_gradient":
        handle = ts.params["fc"]["b"].register_hook(
            lambda g: g * float("nan"))
    with pytest.raises(InvariantError, match=port_msg):
        step(ts, torch.from_numpy(xb), torch.from_numpy(yb))
    jax_step = jax_side["steps"]["nan_gradient" if handle else "plain"]
    with pytest.raises(checkify.JaxRuntimeError, match=jax_msg):
        jax_step(jts, jnp.asarray(xb), jnp.asarray(yb))
    if handle is not None:
        handle.remove()
    assert ts.step == ts.optimizer.count == 1
    for a, b in zip(before, ts.tensors(), strict=True):
        assert torch.equal(a, b)

    # the next good step: bitwise the untripped run's, and JAX's next
    got = step(ts, *good)
    want = ref_step(untripped, *good)
    _, met = jax_side["steps"]["plain"](jts, jnp.asarray(x), jnp.asarray(y))
    assert torch.equal(got["loss"], want["loss"])
    for a, b in zip(ts.tensors(), untripped.tensors(), strict=True):
        assert torch.equal(a, b)
    np.testing.assert_allclose(float(got["loss"]), float(met["loss"]),
                               rtol=1e-4)
    assert ts.step == ts.optimizer.count == 2


def test_a_discarded_nan_trips_only_jax(jax_side):
    """The bias selected whole over a square root of a negative number
    that no gradient reaches: JAX's step names the primitive, the port's
    takes its step (the difference ROADMAP.md queue 3 item 4 records)."""
    x, y = batch(1)

    def jax_masked(b):
        return jnp.where(True, b, jnp.sqrt(jax.lax.stop_gradient(b) - 1e9))

    def port_masked(b):
        return torch.where(torch.tensor(True), b,
                           torch.sqrt(b.detach() - 1e9))

    jax_step = jax_make_checked_train_step(
        HeadBias(jax_side["model"], jax_masked), optax.adam(1e-3))
    with pytest.raises(checkify.JaxRuntimeError,
                       match="nan generated by primitive: sqrt"):
        jax_step(jax_side["jts"], jnp.asarray(x), jnp.asarray(y))
    ts = port_state(jax_side["start"])
    out = make_checked_train_step(HeadBias(port_model(), port_masked))(
        ts, torch.from_numpy(x), torch.from_numpy(y))
    assert bool(torch.isfinite(out["loss"])) and ts.step == 1


def test_checked_remat_step_is_the_unchecked_step_without_remat():
    cfg = tm.STGCNConfig(**COMMON, dropout_rate=0.5, remat=True)
    remat, plain = tm.STGCN(cfg), tm.STGCN(tm.STGCNConfig(
        **COMMON, dropout_rate=0.5))
    params, state = remat.init_params(0)
    ts, ref = (train_state_from(params, state, opt.adam(1e-3), 0, CPU)
               for _ in range(2))
    checked, unchecked = make_checked_train_step(remat), make_train_step(
        plain)
    x, y = (torch.from_numpy(a) for a in batch(3))
    for _ in range(2):
        assert torch.equal(checked(ts, x, y)["loss"],
                           unchecked(ref, x, y)["loss"])
    for a, b in zip(ts.tensors() + [p.grad for p in ts.leaves()],
                    ref.tensors() + [p.grad for p in ref.leaves()],
                    strict=True):
        assert torch.equal(a, b)


def test_trainer_builds_the_checked_step_as_a_captured_step():
    model = tm.STGCN(tm.STGCNConfig(**COMMON))
    trainer = Trainer(model, check_invariants=True, device="cpu")
    assert isinstance(trainer.train_step, CapturedStep)
    assert trainer.train_step.eager_reason is None
    assert trainer.train_step.check is not None


@pytest.mark.parametrize("k", [1, 3])
def test_topk_accuracy_matches_jax(k):
    rng = np.random.default_rng(4)
    logits = rng.normal(0, 1, (32, 6)).astype(np.float32)
    labels = rng.integers(0, 6, 32).astype(np.int32)
    got = metrics.topk_accuracy(torch.from_numpy(logits),
                                torch.from_numpy(labels), k)
    want = jax_metrics.topk_accuracy(jnp.asarray(logits),
                                     jnp.asarray(labels), k)
    assert got.dtype == torch.float32
    assert float(got) == float(want)
