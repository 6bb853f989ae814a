"""Data parallelism on the fused kernels (``stgcn_tpu_torch.parallel.
fused_dp``) held against the JAX package's ``parallel/fused_dp.py``.

Two gloo ranks (``tests/torch_parallel_ranks.py``, started once for the
file) run, on a ``(2, 1, 1)`` mesh, the fused train step's differentiable
core (``make_fused_dp_grads``: the kernels' plain versions on each rank's
half of the batch, BN statistics all-reduced over ``data``), the fused
eval forward (``fused_eval_forward_dp``: ``block_eval``'s plain version
per rank, logits all-gathered) and ``Predictor(mesh=...)``.  The JAX side
runs the same functions on a ``(2, 1, 1)`` mesh of its virtual CPU
devices, its Pallas kernels in interpret mode, from the same weights and
batch, all in float64: the loss, every gradient, the new BN statistics,
the logits and the served probabilities within 1e-6 of the largest value
of each.  Also: the refusals of a time or model axis and of a time mask,
and a batch the data axis does not divide.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from stgcn_tpu.graph.adjacency import Strategy
from stgcn_tpu.models.stgcn import STGCN as JaxSTGCN
from stgcn_tpu.models.stgcn import STGCNConfig as JaxConfig
from stgcn_tpu.parallel.fused_dp import (
    fused_eval_forward_dp as jax_eval_dp,
    make_fused_dp_grads as jax_grads_dp,
)
from stgcn_tpu.parallel.mesh import make_mesh as jax_make_mesh
from stgcn_tpu.serving import Predictor as JaxPredictor
from stgcn_tpu_torch.models import stgcn as tm
from stgcn_tpu_torch.parallel import mesh as pmesh
from stgcn_tpu_torch.parallel import train as ptrain
from stgcn_tpu_torch.parallel.fused_dp import check_dp_only
from stgcn_tpu_torch.serving import Predictor

from torch_parallel_ranks import launch

PLAN = ((8, 1), (16, 2))
N, T, V = 8, 24, 25
REL = 1e-6
CONFIG = dict(plan=PLAN, strategy=Strategy.DISTANCE.value, d=1,
              residual=True, block_impl="fused", adjacency_mode="mask",
              mask_jitter=0.1)
SERVE_CONFIG = dict(CONFIG, adjacency_mode="fixed", mask_jitter=0.0)
BUCKETS = (32,)
MAX_BATCH = 4


def jax_model(cfg):
    return JaxSTGCN(JaxConfig(**dict(cfg, strategy=Strategy(cfg["strategy"]),
                                     dtype=jnp.float64)))


def numpy_tree(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float64), tree)


def leaves(tree):
    if isinstance(tree, dict):
        return [v for k in sorted(tree) for v in leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [v for t in tree for v in leaves(t)]
    return [np.asarray(tree, np.float64)]


def close_to_largest(got, want, rel=REL):
    got_l, want_l = leaves(got), leaves(want)
    assert len(got_l) == len(want_l)
    scale = max(float(np.abs(w).max(initial=0.0)) for w in want_l)
    for i, (g, w) in enumerate(zip(got_l, want_l)):
        assert g.shape == w.shape, (i, g.shape, w.shape)
        assert float(np.abs(g - w).max(initial=0.0)) <= rel * scale, i


def sequences():
    r = np.random.default_rng(3)
    return [r.standard_normal((20 + 3 * i, V, 2)) for i in range(5)]


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((N, T, V, 2))
    y = rng.integers(0, 6, N).astype(np.int64)
    params, state = numpy_tree(jax_model(CONFIG).init(jax.random.key(0)))
    s_params, s_state = numpy_tree(
        jax_model(SERVE_CONFIG).init(jax.random.key(1)))
    inputs = dict(mesh=(2, 1, 1), config=CONFIG, params=params, state=state,
                  x=x, y=y, serve_config=SERVE_CONFIG, serve_params=s_params,
                  serve_state=s_state, sequences=sequences(),
                  buckets=BUCKETS, max_batch=MAX_BATCH)
    out = launch("fused_dp", 2, inputs,
                 str(tmp_path_factory.mktemp("fused_dp")))
    return inputs, out


def test_grads_loss_and_bn_state_match_jax(setup):
    inp, out = setup
    model = jax_model(CONFIG)
    loss, acc, grads, state = jax_grads_dp(
        model, jax_make_mesh(2, 1, 1), interpret=True)(
        inp["params"], inp["state"], jax.random.key(7),
        jnp.asarray(inp["x"]), jnp.asarray(inp["y"]))
    for res in out:                 # every rank holds the whole result
        assert abs(res["loss"] - float(loss)) <= REL * abs(float(loss))
        assert res["acc"] == pytest.approx(float(acc))
        close_to_largest(res["grads"], jax.device_get(grads))
        close_to_largest(res["state"], jax.device_get(state))


def test_eval_logits_match_jax(setup):
    inp, out = setup
    want = jax_eval_dp(jax_model(CONFIG), inp["params"], inp["state"],
                       jnp.asarray(inp["x"]), jax_make_mesh(2, 1, 1),
                       interpret=True)
    for res in out:
        close_to_largest(res["logits"], np.asarray(want))


def test_predictor_on_a_mesh_matches_jax(setup):
    inp, out = setup
    want = JaxPredictor(jax_model(SERVE_CONFIG), inp["serve_params"],
                        inp["serve_state"], buckets=BUCKETS,
                        max_batch=MAX_BATCH, use_fused=True,
                        mesh=jax_make_mesh(2, 1, 1)).predict(
        [s.astype(np.float64) for s in sequences()])
    for res in out:
        close_to_largest(res["probs"], want.probs)


def fake_mesh(shape):
    return pmesh.Mesh(shape=dict(zip(pmesh.AXES, shape)),
                      coords=dict.fromkeys(pmesh.AXES, 0),
                      device=torch.device("cpu"), backend="gloo", groups={})


@pytest.mark.parametrize("shape", [(1, 2, 1), (2, 1, 2)])
def test_time_and_model_axes_refused(shape):
    model = tm.STGCN(tm.STGCNConfig(plan=PLAN, block_impl="fused"))
    with pytest.raises(ValueError, match="data axis only"):
        ptrain.make_sharded_train_step(model, fake_mesh(shape))
    with pytest.raises(ValueError, match="data axis only"):
        ptrain.make_sharded_eval_step(model, fake_mesh(shape))
    with pytest.raises(ValueError, match="data axis only"):
        Predictor(model, mesh=fake_mesh(shape))


def test_time_mask_and_odd_batches_refused():
    model = tm.STGCN(tm.STGCNConfig(plan=PLAN, block_impl="fused"))
    with pytest.raises(ValueError, match="time_mask"):
        ptrain.make_sharded_train_step(model, fake_mesh((2, 1, 1)),
                                       use_time_mask=True)
    with pytest.raises(ValueError, match="divisible"):
        Predictor(model, max_batch=3, mesh=fake_mesh((2, 1, 1)))
    with pytest.raises(ValueError, match="batch_pad='max'"):
        Predictor(model, batch_pad="pow2", mesh=fake_mesh((2, 1, 1)))
    check_dp_only(fake_mesh((8, 1, 1)))
