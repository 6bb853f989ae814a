"""The standalone-conv routes as a whole, held against the JAX package.

Route A is ``layout="vntc"`` (V-major activations through
``spatial_conv_fused_vm`` and ``temporal_conv_fused_vm``), route B is
``spatial_impl="pallas", temporal_impl="pallas"`` on ``(N, T, V, C)``
(``spatial_conv_fused`` and ``temporal_conv_fused``).  The port's
``STGCN.apply`` and the JAX ``STGCN.apply`` with the same configuration
start from the same randomised weights (handed over with
``params_from_jax``): train-mode logits, new BN statistics and every
parameter's gradient, and eval logits with and without a time mask.  On
the CPU the port's kernels run their plain versions; on the JAX side route
A's Pallas kernels run in interpret mode by themselves off the TPU and
route B's under ``force_tpu_interpret_mode``, as ``tests/test_vntc.py`` and
``tests/test_kernels.py`` run them.

Tolerances: float32 at rtol 1e-4 with an absolute floor of 1e-4 of the
largest compared value (logits, gradients) or 1e-5 (BN statistics): the
two packages sum in other orders.  bfloat16 eval logits at rtol and atol
5e-2 (both round activations at the same points; bf16 keeps 8 bits).
"""

import contextlib
import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
from jax.experimental.pallas import tpu as pltpu

from stgcn_tpu.graph.adjacency import Strategy, get_normalized_adjacency
from stgcn_tpu.models.stgcn import STGCN as JaxSTGCN
from stgcn_tpu.models.stgcn import STGCNConfig as JaxConfig
from stgcn_tpu.ops.block import block_forward_vm as jax_block_forward_vm
from stgcn_tpu.ops.block import init_block
from stgcn_tpu.ops.temporal_conv import temporal_conv as jax_temporal_conv
from stgcn_tpu.training import metrics as jax_metrics
from stgcn_tpu_torch.models import stgcn as tm
from stgcn_tpu_torch.models.convert import params_from_jax, params_to_numpy
from stgcn_tpu_torch.ops.block import block_forward_vm
from stgcn_tpu_torch.ops.temporal_conv import temporal_conv
from stgcn_tpu_torch.training import metrics
from stgcn_tpu_torch.training.loop import make_train_step
from stgcn_tpu_torch.training.optimizers import adam
from stgcn_tpu_torch.training.train_state import train_state_from
from stgcn_tpu_torch.tree import tree_leaves, tree_map

PLAN = ((8, 1), (16, 2), (16, 1))
N, T, V = 2, 16, 25
CPU = torch.device("cpu")
ROUTES = {"A": dict(layout="vntc"),
          "B": dict(spatial_impl="pallas", temporal_impl="pallas")}


def configs(route, residual=True, **kw):
    common = dict(plan=PLAN, strategy=Strategy.DISTANCE, d=1,
                  residual=residual, **ROUTES[route], **kw)
    return JaxConfig(**common), tm.STGCNConfig(**common)


def interpret(route):
    """Route B's Pallas kernels run in interpret mode only when asked."""
    return (pltpu.force_tpu_interpret_mode() if route == "B"
            else contextlib.nullcontext())


def randomized(jax_model, rng):
    """JAX init with the mask, the BN affines and statistics moved away from
    their fresh values."""
    params, state = jax_model.init(jax.random.key(0))

    def jitter(path, p):
        name = jax.tree_util.keystr(path)
        p = np.asarray(p)
        if "mask" in name:
            return p * rng.uniform(0.5, 1.5, p.shape).astype(p.dtype)
        if "scale" in name or "offset" in name:
            return p + rng.normal(0, 0.2, p.shape).astype(p.dtype)
        return p

    params = jax.tree_util.tree_map_with_path(jitter, params)
    state = jax.tree.map(
        lambda s: np.asarray(s) + rng.uniform(0, 0.3, s.shape).astype(
            s.dtype), state)
    return jax.tree.map(jnp.asarray, (params, state))


def batch(rng):
    x = rng.normal(0, 1, (N, T, V, 2)).astype(np.float32)
    return x, np.asarray([0, 3], np.int64)


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


def port_params(params, state, requires_grad=False):
    p, s = params_from_jax(*jax.tree.map(np.asarray, (params, state)))
    if requires_grad:
        for leaf in tree_leaves(p):
            leaf.requires_grad_(True)
    return p, s


@pytest.mark.parametrize("route", sorted(ROUTES))
@pytest.mark.parametrize("residual", [True, False])
def test_train_forward_and_gradients_match_jax(rng, route, residual):
    jcfg, tcfg = configs(route, residual)
    jax_model = JaxSTGCN(jcfg)
    params, state = randomized(jax_model, rng)
    x, y = batch(rng)

    def loss_fn(p):
        logits, new_state = jax_model.apply(p, state, jnp.asarray(x),
                                            train=True)
        return (jax_metrics.cross_entropy(logits, jnp.asarray(y)),
                (logits, new_state))

    with interpret(route):
        (_, (logits_j, state_j)), grads_j = jax.value_and_grad(
            loss_fn, has_aux=True)(params)

    p, s = port_params(params, state, requires_grad=True)
    model = tm.STGCN(tcfg)
    logits, new_state = model.apply(p, s, torch.from_numpy(x), train=True)
    grads = torch.autograd.grad(
        metrics.cross_entropy(logits, torch.from_numpy(y)), tree_leaves(p))
    close_trees(logits.detach().numpy(), np.asarray(logits_j), 1e-4, 1e-4)
    close_trees(params_to_numpy(new_state),
                jax.tree.map(np.asarray, state_j), 1e-4, 1e-5)
    close_trees([g.numpy() for g in grads],
                [np.asarray(g) for g in _leaves(grads_j)], 1e-4, 1e-4)


@pytest.mark.parametrize("route", sorted(ROUTES))
@pytest.mark.parametrize("masked", [False, True])
def test_eval_matches_jax(rng, route, masked):
    jcfg, tcfg = configs(route)
    jax_model = JaxSTGCN(jcfg)
    params, state = randomized(jax_model, rng)
    x, _ = batch(rng)
    mask = np.arange(T)[None, :] < np.asarray([[T], [9]])
    with interpret(route):
        want, _ = jax_model.apply(params, state, jnp.asarray(x),
                                  train=False,
                                  time_mask=jnp.asarray(mask) if masked
                                  else None)
    p, s = port_params(params, state)
    with torch.no_grad():
        got, same = tm.STGCN(tcfg).apply(
            p, s, torch.from_numpy(x), train=False,
            time_mask=torch.from_numpy(mask) if masked else None)
    assert same is s
    close_trees(got.numpy(), np.asarray(want), 1e-4, 1e-4)


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_bf16_eval_matches_jax(rng, route):
    jcfg, tcfg = configs(route, compute_dtype=jnp.bfloat16)
    tcfg = dataclasses.replace(tcfg, compute_dtype=torch.bfloat16)
    jax_model = JaxSTGCN(jcfg)
    params, state = randomized(jax_model, rng)
    x, _ = batch(rng)
    with interpret(route):
        want, _ = jax_model.apply(params, state, jnp.asarray(x), train=False)
    p, s = port_params(params, state)
    with torch.no_grad():
        got, _ = tm.STGCN(tcfg).apply(p, s, torch.from_numpy(x), train=False)
    assert str(got.dtype) == f"torch.{want.dtype}"
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=5e-2,
                               atol=5e-2)


@pytest.mark.parametrize("c_in,c_out,stride,residual", [
    (8, 8, 1, False),
    (8, 16, 2, False),
    (8, 8, 1, True),      # identity shortcut
    (8, 16, 2, True),     # strided 1x1-projection shortcut
])
def test_block_forward_vm_matches_jax(rng, c_in, c_out, stride, residual):
    a = jnp.asarray(get_normalized_adjacency(Strategy.DISTANCE, d=1),
                    jnp.float32)
    params, state = init_block(jax.random.key(0), c_in, c_out, a, gamma=9,
                               stride=stride, residual=residual,
                               adjacency_mode="mask")
    params = jax.tree.map(
        lambda q: q + jnp.asarray(rng.normal(0, 0.1, q.shape), q.dtype),
        params)
    x = rng.normal(0, 1, (V, N, 20, c_in)).astype(np.float32)

    def fn(p):
        out, new_state = jax_block_forward_vm(
            p, state, jnp.asarray(x), a, stride=stride, residual=residual,
            train=True, interpret=True)
        return jnp.sum(jnp.sin(out)), (out, new_state)

    (_, (out_j, state_j)), grads_j = jax.value_and_grad(
        fn, has_aux=True)(params)
    p, s = port_params(params, state, requires_grad=True)
    out, new_state = block_forward_vm(
        p, s, torch.from_numpy(x), torch.from_numpy(np.array(a)),
        stride=stride, residual=residual, train=True)
    g = torch.autograd.grad(torch.sin(out).sum(), tree_leaves(p))
    close_trees(out.detach().numpy(), np.asarray(out_j), 1e-4, 1e-4)
    close_trees(params_to_numpy(new_state),
                jax.tree.map(np.asarray, state_j), 1e-4, 1e-5)
    close_trees([t.numpy() for t in g],
                [np.asarray(t) for t in _leaves(grads_j)], 1e-4, 1e-4)


@pytest.mark.parametrize("stride", [1, 2])
def test_pallas_temporal_op_casts_like_jax(rng, stride):
    """``temporal_conv(impl="pallas")`` with a compute dtype: x and the taps
    are cast to it and the bias is added as it comes (float32)."""
    w = rng.normal(0, 0.1, (9, 1, 8, 8)).astype(np.float32)
    b = rng.normal(0, 0.3, 8).astype(np.float32)
    x = rng.normal(0, 1, (N, 17, V, 8)).astype(np.float32)
    want = jax_temporal_conv({"w": jnp.asarray(w), "b": jnp.asarray(b)},
                             jnp.asarray(x), stride=stride,
                             impl="pallas_interpret",
                             compute_dtype=jnp.bfloat16)
    got = temporal_conv({"w": torch.from_numpy(w), "b": torch.from_numpy(b)},
                        torch.from_numpy(x), stride=stride,
                        compute_dtype=torch.bfloat16, impl="pallas")
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-2,
                               atol=2e-2)


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_train_step_drives_the_route(rng, route):
    """``make_train_step`` takes the route as it takes the op chain: two
    steps on one batch give the op chain's losses (same arithmetic)."""
    _, tcfg = configs(route)
    x, y = batch(rng)
    start = tm.STGCN(tcfg).init_params(0)
    losses = {}
    for name, cfg in (("route", tcfg),
                      ("ops", tm.STGCNConfig(plan=PLAN,
                                             strategy=Strategy.DISTANCE,
                                             d=1, residual=True))):
        model = tm.STGCN(cfg)
        ts = train_state_from(*start, adam(1e-3), 0, CPU)
        step = make_train_step(model)
        losses[name] = [float(step(ts, torch.from_numpy(x),
                                   torch.from_numpy(y))["loss"])
                        for _ in range(2)]
    np.testing.assert_allclose(losses["route"], losses["ops"], rtol=1e-4)
    assert losses["route"][1] < losses["route"][0]


class TestConfig:
    @pytest.mark.parametrize("kw", [
        dict(layout="nchw"),
        dict(spatial_impl="xla"),
        dict(temporal_impl="fft"),
        dict(layout="vntc", block_impl="fused"),
        dict(layout="vntc", block_impl="hybrid"),
    ])
    def test_rejects_what_jax_rejects(self, kw):
        with pytest.raises(ValueError):
            JaxConfig(plan=PLAN, **kw)
        with pytest.raises(ValueError):
            tm.STGCNConfig(plan=PLAN, **kw)

    @pytest.mark.parametrize("impl", ["conv_vt", "shift_sum", "block"])
    def test_unported_temporal_impls_raise(self, impl):
        # these formulations are ported now: both configs take them, and
        # the eval forward on each matches the JAX one (float32, as above)
        jcfg = JaxConfig(plan=PLAN, temporal_impl=impl, residual=True)
        tcfg = tm.STGCNConfig(plan=PLAN, temporal_impl=impl, residual=True)
        assert tcfg.temporal_impl == jcfg.temporal_impl == impl
        jax_model = JaxSTGCN(jcfg)
        params, state = randomized(jax_model, np.random.default_rng(0))
        x, _ = batch(np.random.default_rng(1))
        want, _ = jax_model.apply(params, state, jnp.asarray(x), train=False)
        got, _ = tm.STGCN(tcfg).apply(*port_params(params, state),
                                      torch.from_numpy(x), train=False)
        close_trees(got.numpy(), np.asarray(want), 1e-4, 1e-4)

    def test_defaults_match_jax(self):
        jcfg, tcfg = JaxConfig(), tm.STGCNConfig()
        for name in ("layout", "spatial_impl", "temporal_impl"):
            assert getattr(tcfg, name) == getattr(jcfg, name)
