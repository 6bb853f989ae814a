"""The captured step (``stgcn_tpu_torch/training/graphs.py``) on the CPU,
where it runs its body eagerly through the same static input and output
buffers that a CUDA graph replays.

Held here, on a small model (3 blocks, C <= 16, T <= 32, B <= 8), every
input from a numpy seed:

* **JAX parity.**  Three steps of ``make_train_step`` (a ``CapturedStep``)
  against the JAX package's jitted ``make_train_step``, op path, dropout 0,
  with ``tests/test_torch_train_step.py``'s tolerances: losses rtol 1e-4,
  the step-0 gradients rtol 1e-4 (floor 1e-4 of the largest), the BN
  statistics after step 1 rtol 1e-4 (floor 1e-5) and after step 3 rtol
  1e-2 (floor 1e-3).
* **Eager parity.**  The same three steps bitwise equal to the eager port
  step (``forward_backward`` then ``apply_update``): parameters, moments,
  BN statistics, gradients and losses, for adam, ``flat_adam`` with warmup
  and cosine, adam with ``clip_norm > 0``, and with dropout 0.5.  The
  optimizer's update, its scalars now read from 0-d tensors, bitwise the
  Python-float update it replaced.
* **The cache.**  One entry per input signature: a new T, a new batch
  size and a time mask each add one; the same signature adds none.
* **Refusals.**  ``capture=True`` on the CPU and with a reason (a gloo
  mesh) raises; a ``remat`` step has no reason and builds with
  ``capture=True``.
* **Trainer.fit.**  Its epoch loss is the mean of the per-step losses, not
  the last step's output read again.
* **Predictor.predict_stream.**  Over distinct batches of two buckets at
  ``depth=2``, what ``predict_batch`` gives for each.
* **dump_computation.**  Both files written; the first names the op
  path's convolutions (``conv2d`` for the temporal ones, ``einsum`` for
  the graph conv), the second says no graph exists on the CPU.
"""

import dataclasses
import types

import numpy as np
import optax
import pytest

import jax
import jax.numpy as jnp
import torch

from stgcn_tpu.graph.adjacency import Strategy
from stgcn_tpu.models.stgcn import STGCN as JaxSTGCN
from stgcn_tpu.models.stgcn import STGCNConfig as JaxConfig
from stgcn_tpu.training import metrics as jax_metrics
from stgcn_tpu.training.loop import make_train_step as jax_make_train_step
from stgcn_tpu.training.train_state import (
    create_train_state as jax_create_train_state,
)
from stgcn_tpu_torch.models import stgcn as tm
from stgcn_tpu_torch.models.convert import params_from_jax, params_to_numpy
from stgcn_tpu_torch.parallel.fused_dp import mesh_eager_reason
from stgcn_tpu_torch.serving import Predictor
from stgcn_tpu_torch.training import optimizers as opt
from stgcn_tpu_torch.training.graphs import CapturedStep
from stgcn_tpu_torch.training.loop import (
    Trainer,
    apply_update,
    forward_backward,
    make_train_step,
)
from stgcn_tpu_torch.training.train_state import train_state_from
from stgcn_tpu_torch.tree import tree_leaves, tree_map
from stgcn_tpu_torch.utils.profiling import dump_computation

PLAN = ((16, 1), (16, 2), (8, 1))
N, T = 4, 16
STEPS = 3
CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def few_torch_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(min(threads, 2))
    yield
    torch.set_num_threads(threads)


def config(**kw):
    return tm.STGCNConfig(plan=PLAN, strategy=Strategy.DISTANCE, d=1,
                          residual=True, **kw)


def batch(rng, n=N, t=T):
    x = rng.normal(0, 1, (n, t, 25, 2)).astype(np.float32)
    y = rng.integers(0, 6, n).astype(np.int64)
    return torch.from_numpy(x), torch.from_numpy(y)


def state_pair(model, spec, seed=0):
    """Two train states over the same weights (``model.init_params``)."""
    params, state = model.init_params(seed)
    return [train_state_from(params, state, spec, seed, CPU)
            for _ in range(2)]


def everything(ts):
    """What a step leaves behind: parameters, BN statistics, the
    optimizer's moments and scalars, the last gradients."""
    return ts.tensors() + [p.grad for p in ts.leaves()]


def eager_step(model, ts, x, y):
    """The eager port step the captured one stands for."""
    return apply_update(ts, *forward_backward(model, ts, x, y), y)


OPTIMIZERS = {
    "adam": opt.adam(1e-3),
    "flat_adam_warmup_cosine": opt.OptimizerSpec(
        "flat_adam", opt.join_schedules(
            [opt.linear_schedule(0.0, 3e-3, 2),
             opt.cosine_decay_schedule(3e-3, 10)], [2])),
    "adam_clip": opt.OptimizerSpec("adam", 1e-2, clip_norm=0.05),
}


@pytest.mark.parametrize("dropout", [0.0, 0.5])
@pytest.mark.parametrize("name", sorted(OPTIMIZERS))
def test_captured_step_is_bitwise_the_eager_step(rng, name, dropout):
    model = tm.STGCN(config(dropout_rate=dropout))
    ts, ref = state_pair(model, OPTIMIZERS[name])
    step = make_train_step(model)
    x, y = batch(rng)
    for _ in range(STEPS):
        got = step(ts, x, y)
        want = eager_step(model, ref, x, y)
        assert torch.equal(got["loss"], want["loss"])
        assert torch.equal(got["acc"], want["acc"])
    assert not step.captured and step.cache_size == 0
    assert ts.step == ref.step == STEPS
    assert ts.optimizer.count == ref.optimizer.count == STEPS
    for a, b in zip(everything(ts), everything(ref), strict=True):
        assert torch.equal(a, b)


def _python_float_adam(leaves, grads, lr, count, b1=0.9, b2=0.999, eps=1e-8):
    """The update as it was written with the per-step scalars as Python
    floats (the multi-tensor ops of ``OptaxOptimizer`` before they read
    0-d tensors)."""
    state = [(torch.zeros_like(p), torch.zeros_like(p)) for p in leaves]
    for t, g in enumerate(grads, start=count + 1):
        mu = [m for m, _ in state]
        nu = [v for _, v in state]
        torch._foreach_mul_(mu, b1)
        torch._foreach_add_(mu, g, alpha=1 - b1)
        torch._foreach_mul_(nu, b2)
        torch._foreach_addcmul_(nu, g, g, value=1 - b2)
        mu_hat = torch._foreach_div(mu, 1 - b1 ** t)
        denom = torch._foreach_sqrt(torch._foreach_div(nu, 1 - b2 ** t))
        torch._foreach_add_(denom, eps)
        torch._foreach_add_(leaves, torch._foreach_div(mu_hat, denom),
                            alpha=-lr)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_optimizer_scalars_on_the_device_keep_the_update(rng, dtype):
    shapes = [(3, 4), (5,), (2, 2)]
    start = [rng.normal(0, 1, s) for s in shapes]
    grads = [[torch.tensor(rng.normal(0, 1, s), dtype=dtype)
              for s in shapes] for _ in range(STEPS)]
    leaves = [torch.tensor(p, dtype=dtype, requires_grad=True)
              for p in start]
    optimizer = opt.adam(1e-2)(leaves)
    for g in grads:
        for p, gg in zip(leaves, g):
            p.grad = gg
        optimizer.step()
    want = [torch.tensor(p, dtype=dtype) for p in start]
    _python_float_adam(want, grads, 1e-2, 0)
    for a, b in zip(leaves, want):
        assert torch.equal(a.detach(), b)
    assert all(t.dtype == dtype for t in optimizer._scalars.values())


def test_three_captured_steps_match_jax(rng):
    common = dict(plan=PLAN, strategy=Strategy.DISTANCE, d=1, residual=True)
    jax_model = JaxSTGCN(JaxConfig(**common))
    jts = jax_create_train_state(jax_model, optax.adam(1e-3), seed=0)
    x, y = batch(rng)
    xj, yj = jnp.asarray(x.numpy()), jnp.asarray(y.numpy())

    def loss_fn(params):
        logits, _ = jax_model.apply(params, jts.model_state, xj, train=True)
        return jax_metrics.cross_entropy(logits, yj)

    grads0 = jax.grad(loss_fn)(jts.params)
    start = tuple(jax.tree.map(np.asarray, t)
                  for t in (jts.params, jts.model_state))
    jax_step = jax_make_train_step(jax_model, optax.adam(1e-3), donate=False)
    jax_losses, jax_states = [], []
    for _ in range(STEPS):
        jts, met = jax_step(jts, xj, yj)
        jax_losses.append(float(met["loss"]))
        jax_states.append(jax.tree.map(np.asarray, jts.model_state))

    model = tm.STGCN(tm.STGCNConfig(**common))
    ts = train_state_from(*params_from_jax(*start), opt.adam(1e-3), 0, CPU)
    step = make_train_step(model)
    losses = []
    for i in range(STEPS):
        losses.append(float(step(ts, x, y)["loss"]))
        if i == 0:
            _close(tree_map(lambda p: p.grad.numpy(), ts.params),
                   jax.tree.map(np.asarray, grads0), 1e-4, 1e-4)
            _close(params_to_numpy(ts.model_state), jax_states[0], 1e-4,
                   1e-5)
    _close(params_to_numpy(ts.model_state), jax_states[-1], 1e-2, 1e-3)
    np.testing.assert_allclose(losses, jax_losses, rtol=1e-4, atol=1e-5)


def _close(got, want, rtol, rel_atol):
    got_l = [np.asarray(g, np.float64) for g in tree_leaves(got)]
    want_l = [np.asarray(w, np.float64) for w in jax.tree.leaves(want)]
    assert len(got_l) == len(want_l)
    scale = max(float(np.abs(w).max(initial=0.0)) for w in want_l)
    for i, (g, w) in enumerate(zip(got_l, want_l)):
        np.testing.assert_allclose(g, w, rtol=rtol, atol=rel_atol * scale,
                                   err_msg=f"leaf {i}")


def test_one_cache_entry_per_signature(rng):
    model = tm.STGCN(config())
    ts, _ = state_pair(model, opt.adam(1e-3))
    step = make_train_step(model, use_time_mask=True)
    x, y = batch(rng)
    mask = torch.ones(N, T, dtype=torch.bool)
    calls = [(x, y), (x, y), (*batch(rng, t=2 * T),), (*batch(rng, n=2),),
             (x, y, mask), (x, y, mask), (x, y)]
    seen = []
    for args in calls:
        step(ts, *args)
        seen.append(step.signatures)
    assert seen == [1, 1, 2, 3, 4, 4, 4]
    assert step.cache_size == 0 and ts.step == len(calls)


def test_capture_refusals(rng):
    x, y = batch(rng)
    model = tm.STGCN(config())
    ts, _ = state_pair(model, opt.adam(1e-3))
    with pytest.raises(ValueError, match="needs a CUDA device"):
        make_train_step(model, capture=True)(ts, x, y)
    # remat's recompute is captured: no reason, and capture=True builds
    # (and, on the CPU, refuses to run as every step does)
    remat = tm.STGCN(config(remat=True))
    assert make_train_step(remat).eager_reason is None
    captured = make_train_step(remat, capture=True)
    assert captured.capture and captured.eager_reason is None
    with pytest.raises(ValueError, match="needs a CUDA device"):
        captured(ts, x, y)
    gloo = types.SimpleNamespace(backend="gloo")
    reason = mesh_eager_reason(gloo)
    assert "gloo" in reason
    assert mesh_eager_reason(types.SimpleNamespace(backend="nccl")) is None
    with pytest.raises(ValueError, match="gloo"):
        CapturedStep(lambda s, generator=None: s, state_tensors=list,
                     capture=True, eager_reason=reason)


class _StepLog:
    def __init__(self):
        self.steps = []

    def log_dict(self, values, step):
        if "step_loss" in values:
            self.steps.append(values["step_loss"])


def test_fit_keeps_each_steps_loss(rng):
    model = tm.STGCN(config())
    log = _StepLog()
    trainer = Trainer(model, opt.adam(1e-2), logger=log, log_every_steps=1,
                      device="cpu")
    state = trainer.init_state()
    data = [tuple(t.numpy() for t in batch(rng)) + (None,)
            for _ in range(4)]
    result = trainer.fit(state, lambda epoch: data, epochs=1)
    assert len(log.steps) == 4 and len(set(log.steps)) == 4
    np.testing.assert_allclose(result.history[0]["train_loss"],
                               np.mean(log.steps), rtol=1e-6)


def test_predict_stream_over_buckets_matches_predict_batch(rng):
    model = tm.STGCN(config())
    pred = Predictor(model, buckets=(T, 2 * T), max_batch=N, device="cpu")
    xs = [rng.standard_normal((N, t, 25, 2)).astype(np.float32)
          for t in (T, 2 * T, T, 2 * T, T)]
    serial = [pred.predict_batch(x) for x in xs]
    assert not np.array_equal(serial[0], serial[2])
    assert pred._step.signatures == 2
    got = list(pred.predict_stream(xs, depth=2))
    assert len(got) == len(xs)
    for g, s in zip(got, serial):
        np.testing.assert_array_equal(g, s)


def test_dump_computation_writes_both_programs(rng, tmp_path):
    model = tm.STGCN(dataclasses.replace(config(), plan=PLAN[:2])).eval()
    x, _ = batch(rng, n=2)
    traced, graph = dump_computation(model, (x,), str(tmp_path / "fwd"))
    text = open(traced).read()
    # the temporal convs (cuDNN's conv2d) and the graph convs (einsum)
    assert text.count("aten.conv2d") >= 2 and "aten.einsum" in text
    assert "no CUDA graph" in open(graph).read()
