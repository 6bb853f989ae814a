"""Joint sharding (``shard_joints``: V over the ``model`` axis) held
against the JAX package.

* The port's own ``plan_boundary_exchange`` equals the JAX function's for
  the distance graph's adjacency over 5 ranks (V = 25), and for a dense
  support.
* On five gloo ranks (``tests/torch_parallel_ranks.py``, started once for
  the file) the joint-sharded step on a ``(1, 1, 5)`` mesh (the boundary
  joints' all-gather, the statistics and the pool over every rank): the
  loss, every gradient (the mask's, through the traced adjacency,
  included) and the new BN statistics against the JAX sharded step on the
  same mesh, float64, within 1e-6 of the largest value of each; in mask
  mode (the sparse plan) and in the trained-graph mode ``"reference"``
  (the dense plan; the JAX package keeps GSPMD there).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from stgcn_tpu.graph.adjacency import Strategy, get_normalized_adjacency
from stgcn_tpu.models.stgcn import STGCN as JaxSTGCN
from stgcn_tpu.models.stgcn import STGCNConfig as JaxConfig
from stgcn_tpu.parallel import mesh as jmesh
from stgcn_tpu.parallel import train as jtrain
from stgcn_tpu.parallel.spatial_halo import (
    plan_boundary_exchange as jax_plan,
)
from stgcn_tpu.training import metrics as JM
from stgcn_tpu_torch.parallel.spatial_halo import plan_boundary_exchange

from torch_parallel_ranks import launch

PLAN = ((8, 1), (16, 2))
N, T, V = 4, 16, 25
REL = 1e-6


def config(**kw):
    cfg = dict(plan=PLAN, strategy=Strategy.DISTANCE.value, d=1,
               residual=True, adjacency_mode="mask", mask_jitter=0.1)
    cfg.update(kw)
    return cfg


def jax_model(cfg):
    return JaxSTGCN(JaxConfig(**dict(cfg, strategy=Strategy(cfg["strategy"]),
                                     dtype=jnp.float64)))


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


@pytest.mark.parametrize("dense", [False, True])
def test_exchange_plan_matches_jax(dense):
    a = get_normalized_adjacency(Strategy.DISTANCE, 1)
    if dense:
        a = np.ones_like(a)
    got, want = plan_boundary_exchange(a, 5), jax_plan(a, 5)
    for f in ("n_shards", "v_local", "b_max", "idx_global",
              "exported_per_shard"):
        assert getattr(got, f) == getattr(want, f), f
    np.testing.assert_array_equal(got.sel, want.sel)
    np.testing.assert_array_equal(got.recv_mask, want.recv_mask)
    assert got.exchanged_joints == (25 if dense else want.exchanged_joints)
    if not dense:
        assert got.exchanged_joints < 25      # only the cut's joints
    with pytest.raises(ValueError, match="not divisible"):
        plan_boundary_exchange(a, 2)


def jax_joint_sharded(cfg, params, state, x, y):
    model = jax_model(cfg)
    mesh = jmesh.make_mesh(1, 1, 5)
    constrain = jmesh.activation_constrainer(mesh, shard_joints=True)
    t_impl = jtrain._resolve_temporal_impl(mesh, model, precision=None,
                                           shard_joints=True)
    s_impl = jtrain._resolve_spatial_impl(mesh, model, precision=None,
                                          shard_joints=True)
    rep = jmesh.replicated(mesh)

    def loss_fn(p, s, x, y):
        logits, new_s = model.apply(p, s, x, train=True, constrain=constrain,
                                    temporal_impl=t_impl,
                                    spatial_impl=s_impl)
        return JM.cross_entropy(logits, y), new_s

    fn = jax.jit(jax.value_and_grad(loss_fn, has_aux=True),
                 in_shardings=(rep, rep, NamedSharding(
                     mesh, jmesh.batch_spec(shard_joints=True)),
                     NamedSharding(mesh, P("data"))))
    (loss, new_s), g = fn(params, state, jnp.asarray(x), jnp.asarray(y))
    return float(loss), jax.device_get(g), jax.device_get(new_s)


CASES = {mode: dict(mesh=(1, 1, 5), config=config(adjacency_mode=mode),
                    shard_joints=True) for mode in ("mask", "reference")}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((N, T, V, 2))
    y = rng.integers(0, 6, N).astype(np.int64)
    cases = {}
    for name, case in CASES.items():
        params, state = jax.tree.map(
            lambda a: np.asarray(a, np.float64),
            jax_model(case["config"]).init(jax.random.key(0)))
        cases[name] = dict(case, params=params, state=state, x=x, y=y)
    out = launch("step", 5, {"cases": cases},
                 str(tmp_path_factory.mktemp("joints")))
    return cases, out


@pytest.mark.parametrize("mode", list(CASES))
def test_joint_sharded_step_matches_jax(ranks, mode):
    cases, out = ranks
    case = cases[mode]
    loss, grads, state = jax_joint_sharded(case["config"], case["params"],
                                           case["state"], case["x"],
                                           case["y"])
    for res in out:                 # every rank holds the whole result
        res = res[mode]
        assert abs(res["loss"] - loss) <= REL * abs(loss)
        close_to_largest(res["grads"], grads)
        close_to_largest(res["state"], state)
