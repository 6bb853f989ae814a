"""The all-fused train and eval loop against the JAX package.

``block_impl="fused"`` runs every block on the fused train ops: blocks whose
graph trains and whose input has 256 channels on ``spatial_block_save``,
the rest on ``spatial_block``, as the JAX package routes them
(``stgcn_tpu/models/fused.py:248-268``).  Its eval, and the hybrid's, runs
``STGCN.apply(train=False)`` on one ``block_eval`` per fused block.  Here
the ops run their plain versions; the JAX side runs its Pallas kernels in
interpret mode, as the JAX package's own tests run them.

Train: three steps from the same weights on one batch, float32, dropout 0,
against the JAX ``make_train_step``, in mask, reference and fixed
adjacency mode.  Compared as in ``tests/test_torch_train_step.py``: losses
(rtol 1e-4), step-0 gradients (rtol 1e-4, floor 1e-4 of the largest) and
BN statistics after step 1 (rtol 1e-4, floor 1e-5 of the largest); after
step 3 at rtol 1e-2, since Adam turns rounding-level gradients into full
steps.  Eval logits at rtol 1e-4, atol 1e-5.
"""

import dataclasses

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
from stgcn_tpu_torch.models import fused
from stgcn_tpu_torch.models import stgcn as tm
from stgcn_tpu_torch.models.convert import params_from_jax, params_to_numpy
from stgcn_tpu_torch.training.loop import make_train_step
from stgcn_tpu_torch.training.optimizers import adam
from stgcn_tpu_torch.training.train_state import train_state_from

# a 256-channel input: block 0 has C_in = 256 (spatial_block_save where the
# graph trains), block 1 C_in = 16 (spatial_block)
PLAN = ((16, 1), (16, 2))
C_IN = 256
# block 0 alone, the cheaper check of the other two adjacency modes
WIDE = ((16, 2),)
# the eval plan, block 1 strided with a projection
EVAL_PLAN = ((16, 1), (32, 2))
N, T = 2, 16
CPU = torch.device("cpu")
RTOL, ATOL = 1e-4, 1e-5


def configs(plan=PLAN, **kw):
    common = {**dict(plan=plan, strategy=Strategy.DISTANCE, d=1,
                     residual=True), **kw}
    return JaxConfig(**common), tm.STGCNConfig(**common)


def randomized_jax_state(jax_model, rng):
    ts = jax_create_train_state(jax_model, optax.adam(1e-3), seed=0)

    def jitter(path, p):
        name = jax.tree_util.keystr(path)
        p = np.asarray(p)
        if "mask" in name or "'A'" in name:
            return jnp.asarray(p * rng.uniform(0.5, 1.5, p.shape), p.dtype)
        if "scale" in name or "offset" in name:
            return jnp.asarray(p + rng.normal(0, 0.2, p.shape), p.dtype)
        return jnp.asarray(p)

    params = jax.tree_util.tree_map_with_path(jitter, ts.params)
    state = jax.tree.map(
        lambda s: jnp.asarray(np.asarray(s) + rng.uniform(0, 0.3, s.shape),
                              s.dtype), ts.model_state)
    return dataclasses.replace(ts, params=params, model_state=state,
                               opt_state=optax.adam(1e-3).init(params))


def numpy_pair(params, state):
    return tuple(jax.tree.map(np.asarray, t) for t in (params, state))


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [np.asarray(tree, np.float64)]


def close_trees(got, want, rtol, rel_atol):
    got_l, want_l = _leaves(got), _leaves(want)
    assert len(got_l) == len(want_l)
    scale = max(float(np.abs(w).max(initial=0.0)) for w in want_l)
    for i, (g, w) in enumerate(zip(got_l, want_l)):
        assert g.shape == w.shape, i
        np.testing.assert_allclose(g, w, rtol=rtol, atol=rel_atol * scale,
                                   err_msg=f"leaf {i}")


def grads_like(params):
    if isinstance(params, dict):
        return {k: grads_like(v) for k, v in params.items()}
    if isinstance(params, list):
        return [grads_like(v) for v in params]
    return params.grad.numpy()


def batch(rng, n=N, t=T, c=2):
    x = rng.normal(0, 1, (n, t, 25, c)).astype(np.float32)
    y = np.asarray([0, 3, 5, 3][:n], np.int64)
    return x, y


@pytest.fixture()
def spatial_calls(monkeypatch):
    """Which spatial op each fused train block ran, in order."""
    calls = []
    for name in ("spatial_block", "spatial_block_save"):
        op = getattr(fused, name)

        def record(*args, _op=op, _name=name, **kw):
            calls.append((_name, args[0].shape[-1]))
            return _op(*args, **kw)

        monkeypatch.setattr(fused, name, record)
    return calls


@pytest.mark.parametrize("mode,plan,ops,residual", [
    ("mask", PLAN, [("spatial_block_save", 256), ("spatial_block", 16)],
     True),
    ("reference", WIDE, [("spatial_block_save", 256)], True),
    # a fixed graph needs no dA: no save at C_in = 256
    ("fixed", WIDE, [("spatial_block", 256)], True),
    # the post order of the non-residual block (the strategy table's
    # ablation rows), two blocks
    ("fixed", PLAN, [("spatial_block", 256), ("spatial_block", 16)],
     False)],
    ids=["mask", "reference", "fixed", "fixed_post"])
def test_three_fused_steps_match_jax(rng, spatial_calls, mode, plan, ops,
                                     residual):
    jcfg, tcfg = configs(plan=plan, c_in=C_IN, block_impl="fused",
                         adjacency_mode=mode, residual=residual)
    jax_model = JaxSTGCN(jcfg)
    jts = randomized_jax_state(jax_model, rng)
    x, y = batch(rng, c=C_IN)
    xj, yj = jnp.asarray(x), jnp.asarray(y)

    def loss_fn(params):
        logits, _ = jax_model.apply(params, jts.model_state, xj, train=True)
        return jax_metrics.cross_entropy(logits, yj)

    grads0 = jax.jit(jax.grad(loss_fn))(jts.params)
    start = numpy_pair(jts.params, jts.model_state)
    jax_step = jax_make_train_step(jax_model, optax.adam(1e-3), donate=False)
    jax_losses, jax_states = [], []
    for _ in range(3):
        jts, met = jax_step(jts, xj, yj)
        jax_losses.append(float(met["loss"]))
        jax_states.append(jax.tree.map(np.asarray, jts.model_state))

    model = tm.STGCN(tcfg)
    ts = train_state_from(*params_from_jax(*start), adam(1e-3), 0, CPU)
    step = make_train_step(model)
    xt, yt = torch.from_numpy(x), torch.from_numpy(y)
    losses = []
    for i in range(3):
        losses.append(float(step(ts, xt, yt)["loss"]))
        if i == 0:
            close_trees(grads_like(ts.params),
                        jax.tree.map(np.asarray, grads0), 1e-4, 1e-4)
            close_trees(params_to_numpy(ts.model_state), jax_states[0],
                        1e-4, 1e-5)
    close_trees(params_to_numpy(ts.model_state), jax_states[-1], 1e-2, 1e-3)
    np.testing.assert_allclose(losses, jax_losses, rtol=1e-4, atol=1e-5)
    # the save op on the C_in = 256 block only, and only where dA is needed
    assert spatial_calls == ops * 3


def jax_eval(jm):
    """The JAX eval forward, jitted (its Pallas kernels run in interpret
    mode, which is slow op by op)."""
    return jax.jit(lambda p, s, x, mask=None: jm.apply(
        p, s, x, train=False, time_mask=mask))


def eval_pair(rng, plan=EVAL_PLAN, **kw):
    jcfg, tcfg = configs(plan=plan, **kw)
    jax_model = JaxSTGCN(jcfg)
    jts = randomized_jax_state(jax_model, rng)
    params, state = params_from_jax(*numpy_pair(jts.params,
                                                jts.model_state))
    return jax_model, jts, tm.STGCN(tcfg), params, state


@pytest.mark.parametrize("block_impl,fused_blocks,masked", [
    ("fused", None, False), ("fused", None, True), ("hybrid", (1,), False),
    ("hybrid", (0, 1), False)])
def test_eval_apply_matches_jax(rng, monkeypatch, block_impl, fused_blocks,
                                masked):
    jm, jts, model, params, state = eval_pair(
        rng, block_impl=block_impl, fused_blocks=fused_blocks)
    x, _ = batch(rng, t=20)
    mask = None
    if masked:
        mask = np.zeros((N, 20), bool)
        mask[0, :11] = True
        mask[1, :] = True
    want, _ = jax_eval(jm)(jts.params, jts.model_state, jnp.asarray(x),
                           None if mask is None else jnp.asarray(mask))
    calls = []
    block_eval = fused.block_eval
    monkeypatch.setattr(fused, "block_eval",
                        lambda *a, **kw: calls.append(1) or block_eval(
                            *a, **kw))
    got, new_state = model.apply(
        params, state, torch.from_numpy(x), train=False,
        time_mask=None if mask is None else torch.from_numpy(mask))
    assert new_state is state
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)
    assert len(calls) == len(fused_blocks or EVAL_PLAN)


def test_fused_eval_plan_with_the_reference_chaining_fault(rng):
    """Plan ((64,2),(64,1)) puts a packable block after an unpackable one,
    where the JAX fused eval is wrong (stgcn_tpu/models/fused.py:127); the
    port's fused eval is held against the JAX ops path instead."""
    plan = ((64, 2), (64, 1))
    jm, jts, model, params, state = eval_pair(rng, plan=plan,
                                              block_impl="fused")
    jops = JaxSTGCN(dataclasses.replace(jm.config, block_impl="ops"))
    x, _ = batch(rng, t=32)
    want, _ = jax_eval(jops)(jts.params, jts.model_state, jnp.asarray(x))
    got, _ = model.apply(params, state, torch.from_numpy(x), train=False)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("block_impl,train", [("hybrid", False),
                                              ("hybrid", True),
                                              ("fused", True)])
def test_time_mask_refused_as_jax_refuses_it(rng, block_impl, train):
    jcfg, tcfg = configs(plan=((8, 1),), block_impl=block_impl,
                         fused_blocks=(0,) if block_impl == "hybrid" else None)
    x = np.zeros((2, 8, 25, 2), np.float32)
    mask = np.ones((2, 8), bool)
    # both refuse before they read a weight
    with pytest.raises(ValueError, match="time_mask"):
        JaxSTGCN(jcfg).apply(None, None, jnp.asarray(x), train=train,
                             time_mask=jnp.asarray(mask))
    with pytest.raises(ValueError, match="time_mask outside fused EVAL"):
        tm.STGCN(tcfg).apply(None, None, torch.from_numpy(x), train=train,
                             time_mask=torch.from_numpy(mask))


def test_masked_train_steps_match_jax(rng):
    jcfg, tcfg = configs(plan=((16, 1), (16, 2)))
    jax_model = JaxSTGCN(jcfg)
    jts = randomized_jax_state(jax_model, rng)
    x, y = batch(rng, t=20)
    mask = np.zeros((N, 20), bool)
    mask[0, :13] = True
    mask[1, :] = True
    start = numpy_pair(jts.params, jts.model_state)
    jax_step = jax_make_train_step(jax_model, optax.adam(1e-3), donate=False,
                                   use_time_mask=True)
    jax_losses = []
    for _ in range(3):
        jts, met = jax_step(jts, jnp.asarray(x), jnp.asarray(y),
                            jnp.asarray(mask))
        jax_losses.append(float(met["loss"]))
    ts = train_state_from(*params_from_jax(*start), adam(1e-3), 0, CPU)
    step = make_train_step(tm.STGCN(tcfg), use_time_mask=True)
    xt, yt, mt = (torch.from_numpy(a) for a in (x, y, mask))
    losses = [float(step(ts, xt, yt, mt)["loss"]) for _ in range(3)]
    np.testing.assert_allclose(losses, jax_losses, rtol=1e-4, atol=1e-5)
    # without use_time_mask the mask is not read, as in the JAX step
    ts = train_state_from(*params_from_jax(*start), adam(1e-3), 0, CPU)
    unmasked = make_train_step(tm.STGCN(tcfg))(ts, xt, yt, mt)
    assert abs(float(unmasked["loss"]) - losses[0]) > 1e-6
