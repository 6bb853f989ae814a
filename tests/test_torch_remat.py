"""Rematerialization of the op chain's train blocks (``STGCNConfig.remat``).

``True``/"full" runs each block under one checkpoint, "selective" each
stretch between the block's input and its four conv boundaries; the
backward recomputes the rest.  Held here:

* gradients in float64 equal to the step without remat (1e-12 of the
  largest: the recompute repeats the forward's arithmetic), with dropout
  0.5 from the same generator seed: ``torch.utils.checkpoint`` restores only
  the global RNGs, so the recompute must put the explicit generator back
  (trap a; a checkpoint without it draws another mask and these fail);
* the returned BN running statistics equal to the step without remat, so
  the recompute does not update them twice (trap b);
* the conv kernels' forward wrappers called twice a block on routes A and
  B, once without remat (trap c; on the CPU the wrappers run their plain
  versions, so this counts wrapper calls, which on a GPU are the kernels'
  launches);
* the bytes kept for the backward, by ``saved_tensors_hooks`` (each
  storage counted once): none > selective > full;
* the JAX package's two guards;
* the port against the JAX ``remat=True`` step on the op path in float64
  (no dropout: the two packages' masks differ): logits at 1e-9, the repo's
  float64 parity tolerance (``tests/test_torch_train_ops.py``), and
  gradients at 1e-6 of the largest: the two op paths' float64 gradients lie
  4e-8 of the largest apart with or without remat (BN's E[x^2] - E[x]^2
  over two blocks, summed in other orders), and a wrong mask or a missed
  recompute is off by far more.
"""

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from stgcn_tpu.graph.adjacency import Strategy
from stgcn_tpu.models.stgcn import STGCN as JaxSTGCN
from stgcn_tpu.models.stgcn import STGCNConfig as JaxConfig
from stgcn_tpu.training import metrics as jax_metrics
from stgcn_tpu_torch.kernels import spatial_conv as sc
from stgcn_tpu_torch.kernels import temporal_conv as tc
from stgcn_tpu_torch.models import stgcn as tm
from stgcn_tpu_torch.models.convert import params_from_jax
from stgcn_tpu_torch.training import metrics
from stgcn_tpu_torch.tree import tree_leaves, tree_map

PLAN = ((8, 1), (16, 2))
N, T = 2, 24
ROUTES = {"ops": {}, "A": dict(layout="vntc"),
          "B": dict(spatial_impl="pallas", temporal_impl="pallas")}
CASES = [("full", "ops", True), ("selective", "ops", True),
         ("full", "ops", False), ("selective", "ops", False),
         ("full", "A", True), ("full", "B", True),
         ("selective", "B", True)]


def config(remat, route="ops", residual=True, **kw):
    return tm.STGCNConfig(plan=PLAN, strategy=Strategy.DISTANCE,
                          residual=residual, dropout_rate=0.5,
                          dtype=torch.float64, remat=remat, **ROUTES[route],
                          **kw)


def batch():
    g = torch.Generator().manual_seed(3)
    x = torch.randn(N, T, 25, 2, generator=g, dtype=torch.float64)
    return x, torch.tensor([1, 4])


def train_step(cfg, hooks=None):
    """One forward and backward from seed-0 weights (BN affines moved) and
    a dropout generator of seed 7: ``(logits, new_state, grads)``."""
    model = tm.STGCN(cfg)
    params, state = model.init_params(0)
    g = torch.Generator().manual_seed(11)
    params = tree_map(lambda t: (t + 0.1 * torch.randn(
        t.shape, generator=g, dtype=t.dtype)).double().requires_grad_(True),
        params)
    state = tree_map(lambda t: t.double(), state)
    model.double()
    x, y = batch()
    with hooks or torch.autograd.graph.saved_tensors_hooks(lambda t: t,
                                                           lambda t: t):
        logits, new_state = model.apply(
            params, state, x, train=True,
            generator=torch.Generator().manual_seed(7))
        metrics.cross_entropy(logits, y).backward()
    return logits.detach(), new_state, [p.grad for p in tree_leaves(params)]


@pytest.mark.parametrize("remat,route,residual", CASES)
def test_gradients_and_state_equal_the_step_without_remat(remat, route,
                                                          residual):
    remat = True if remat == "full" else remat
    want = train_step(config(False, route, residual))
    got = train_step(config(remat, route, residual))
    torch.testing.assert_close(got[0], want[0], rtol=0, atol=0)
    scale = max(g.abs().max().item() for g in want[2])
    for a, b in zip(got[2], want[2]):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-12 * scale)
    # trap b: the BN statistics the step returns are the first forward's
    for a, b in zip(tree_leaves(got[1]), tree_leaves(want[1])):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def counting(monkeypatch, module, name):
    """Count calls of a kernel's forward or backward wrapper."""
    fn = getattr(module, name)
    calls = []

    def wrapped(*args, **kw):
        calls.append(1)
        return fn(*args, **kw)

    monkeypatch.setattr(module, name, wrapped)
    return calls


@pytest.mark.parametrize("remat,route", [(False, "A"), (True, "A"),
                                         (False, "B"), ("selective", "B")])
def test_recompute_runs_the_conv_forwards_again(monkeypatch, remat, route):
    calls = {name: counting(monkeypatch, mod, name) for mod, name in (
        (sc, "spatial_conv_forward"), (sc, "spatial_conv_backward"),
        (tc, "temporal_conv_forward"), (tc, "temporal_conv_backward"))}
    train_step(config(remat, route))
    forwards = len(PLAN) * (2 if remat else 1)
    assert {k: len(v) for k, v in calls.items()} == {
        "spatial_conv_forward": forwards, "temporal_conv_forward": forwards,
        "spatial_conv_backward": len(PLAN),
        "temporal_conv_backward": len(PLAN)}


def saved_bytes(cfg) -> int:
    """Bytes of the distinct storages autograd keeps for the backward."""
    seen = {}

    def pack(t):
        if t.numel():
            seen[t.untyped_storage().data_ptr()] = t.untyped_storage(
            ).nbytes()
        return t

    train_step(cfg, torch.autograd.graph.saved_tensors_hooks(pack,
                                                             lambda t: t))
    return sum(seen.values())


@pytest.mark.parametrize("residual", [True, False])
def test_saved_bytes_order(residual):
    none, selective, full = (saved_bytes(config(r, residual=residual))
                             for r in (False, "selective", True))
    assert none > selective > full > 0


def test_the_jax_guards():
    for block_impl in ("fused", "hybrid"):
        with pytest.raises(ValueError, match="remat must stay False"):
            tm.STGCNConfig(plan=PLAN, block_impl=block_impl, remat=True)
    with pytest.raises(ValueError, match="selective.*vntc"):
        tm.STGCNConfig(plan=PLAN, layout="vntc", remat="selective")
    with pytest.raises(ValueError, match="remat must be"):
        tm.STGCNConfig(plan=PLAN, remat="some")
    for remat in (True, "full", "selective"):
        assert tm.STGCNConfig(plan=PLAN, remat=remat).remat == remat
    assert tm.STGCNConfig(plan=PLAN, layout="vntc", remat=True).remat


@pytest.mark.parametrize("remat", [True, "selective"])
def test_port_matches_the_jax_remat_step(remat):
    common = dict(plan=PLAN, strategy=Strategy.DISTANCE, d=1, residual=True)
    jmodel = JaxSTGCN(JaxConfig(**common, remat=remat, dtype=jnp.float64))
    jparams, jstate = jmodel.init(jax.random.key(0))
    jparams, jstate = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64),
                                   (jparams, jstate))
    x, y = batch()

    def loss(p):
        logits, _ = jmodel.apply(p, jstate, jnp.asarray(x.numpy()),
                                 train=True)
        return jax_metrics.cross_entropy(logits, jnp.asarray(y.numpy())), \
            logits

    (_, jlogits), jgrads = jax.value_and_grad(loss, has_aux=True)(jparams)

    pmodel = tm.STGCN(dataclasses.replace(
        config(remat), dropout_rate=0.0))
    pmodel.double()
    params, state = params_from_jax(*jax.tree.map(np.asarray,
                                                  (jparams, jstate)))
    for leaf in tree_leaves(params):
        leaf.requires_grad_(True)
    logits, _ = pmodel.apply(params, state, x, train=True)
    metrics.cross_entropy(logits, y).backward()
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(jlogits),
                               rtol=1e-9, atol=1e-9)
    want = [np.asarray(a) for a in jax.tree.leaves(jgrads)]
    got = [p.grad.numpy() for p in tree_leaves(params)]
    scale = max(np.abs(w).max() for w in want)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-6 * scale)
