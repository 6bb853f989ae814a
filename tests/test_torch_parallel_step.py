"""The port's sharded ops-path step (``stgcn_tpu_torch.parallel.train``)
held against the JAX package's on the same mesh.

Eight gloo ranks (``tests/torch_parallel_ranks.py``, started once for the
file) run every case; the JAX side runs ``model.apply`` under
``make_sharded_train_step``'s hooks (``activation_constrainer``, the
resolved temporal and spatial impls) on ``tests/conftest.py``'s 8 virtual
CPU devices.  Both start from the same JAX-initialized weights (mask mode
with jitter, so the mask has gradients) and the same numpy batch, in
float64.  Held per mesh, (2,1,1), (1,2,1), (1,1,2), (2,2,1) and (2,2,2):
the loss, every leaf's gradient (the port's model-sharded leaves gathered
whole) and the new BN statistics, within 1e-6 of the largest value of
each, against the JAX gradient on the same mesh and against the port's own
unsharded step.  The plan has residual blocks with a ``residual_proj``
(2 -> 8, and 8 -> 16 at stride 2) and an identity shortcut; one case is the
non-residual order, three route B (``spatial_impl``/``temporal_impl=
"pallas"``, the kernels' plain versions per rank, on a time x model, a
data and a model mesh, each rank calling both kernels' wrappers; the JAX
halo cannot run its Pallas kernel under ``shard_map`` on the CPU, so those
cases' JAX side is the same function on the op path).  Also: the masked step,
the eval step's sums, the shard/gather round trip (bitwise), the
partition specs, the validators and ``select_temporal_impl`` against the
JAX functions, and a short batch refused as the JAX ``device_put``
refuses it.
"""

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from stgcn_tpu.graph.adjacency import Strategy
from stgcn_tpu.models.stgcn import STGCN as JaxSTGCN
from stgcn_tpu.models.stgcn import STGCNConfig as JaxConfig
from stgcn_tpu.parallel import mesh as jmesh
from stgcn_tpu.parallel import train as jtrain
from stgcn_tpu.training import metrics as JM
from stgcn_tpu_torch.models import stgcn as tm
from stgcn_tpu_torch.models.convert import params_from_jax
from stgcn_tpu_torch.parallel import mesh as pmesh
from stgcn_tpu_torch.parallel import train as ptrain
from stgcn_tpu_torch.training.loop import forward_backward
from stgcn_tpu_torch.training.optimizers import adam
from stgcn_tpu_torch.training.train_state import train_state_from
from stgcn_tpu_torch.tree import tree_map

from torch_parallel_ranks import launch

PLAN = ((8, 1), (16, 2), (16, 1))
N, T, V = 8, 32, 25
MESHES = [(2, 1, 1), (1, 2, 1), (1, 1, 2), (2, 2, 1), (2, 2, 2)]
# float64 on both sides: every compared value within 1e-6 of the largest
REL = 1e-6


def config(**kw):
    cfg = dict(plan=PLAN, strategy=Strategy.DISTANCE.value, d=1,
               residual=True, adjacency_mode="mask", mask_jitter=0.1)
    cfg.update(kw)
    return cfg


def jax_model(cfg):
    cfg = dict(cfg, strategy=Strategy(cfg["strategy"]), dtype=jnp.float64)
    return JaxSTGCN(JaxConfig(**cfg))


def port_model(cfg):
    cfg = dict(cfg, strategy=Strategy(cfg["strategy"]), dtype=torch.float64)
    return tm.STGCN(tm.STGCNConfig(**cfg))


def weights(cfg):
    params, state = jax_model(cfg).init(jax.random.key(0))
    return jax.tree.map(lambda a: np.asarray(a, np.float64),
                        (params, state))


def batch(seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((N, T, V, 2)),
            rng.integers(0, 6, N).astype(np.int64))


MASK = (np.arange(T)[None, :] < np.array([32, 24, 32, 16, 28, 32, 20, 32]
                                         )[:, None]).astype(np.float64)


def jax_sharded(cfg, shape, params, state, x, y, time_mask=None):
    """The JAX sharded step's loss, gradient and new BN state: the forward
    ``make_sharded_train_step`` runs, differentiated."""
    model = jax_model(cfg)
    mesh = jmesh.make_mesh(*shape)
    constrain = jmesh.activation_constrainer(mesh)
    t_impl = jtrain._resolve_temporal_impl(mesh, model, precision=None,
                                           shard_joints=False)
    s_impl = jtrain._resolve_spatial_impl(mesh, model, precision=None,
                                          shard_joints=False)
    specs = jmesh.param_partition_specs(params)
    p_sh = jmesh.shardings_for(specs, mesh)
    rep = jmesh.replicated(mesh)

    def loss_fn(p, s, x, y, m):
        logits, new_s = model.apply(p, s, x, train=True, time_mask=m,
                                    constrain=constrain,
                                    temporal_impl=t_impl,
                                    spatial_impl=s_impl)
        return JM.cross_entropy(logits, y), new_s

    fn = jax.jit(jax.value_and_grad(loss_fn, has_aux=True),
                 in_shardings=(p_sh, rep,
                               NamedSharding(mesh, P("data", "time")),
                               NamedSharding(mesh, P("data")),
                               None if time_mask is None else
                               NamedSharding(mesh, P("data", "time"))))
    (loss, new_s), g = fn(params, state, jnp.asarray(x), jnp.asarray(y),
                          None if time_mask is None
                          else jnp.asarray(time_mask))
    return float(loss), jax.device_get(g), jax.device_get(new_s)


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
        err = float(np.abs(g - w).max(initial=0.0))
        assert err <= rel * scale, (i, err, scale)


CASES = {f"mesh{s}": dict(mesh=s, config=config()) for s in MESHES}
CASES["non_residual"] = dict(mesh=(2, 2, 2), config=config(residual=False))
# route B on a time x model mesh (the halo in the row-parallel conv), a
# data mesh and a model mesh (the kernel at the reference padding)
ROUTE_B = {"route_b": (1, 2, 2), "route_b_data": (2, 1, 1),
           "route_b_model": (1, 1, 2)}
for _name, _shape in ROUTE_B.items():
    CASES[_name] = dict(mesh=_shape, config=config(
        spatial_impl="pallas", temporal_impl="pallas"))
CASES["masked"] = dict(mesh=(2, 2, 1), config=config(), time_mask=MASK)
CASES["eval"] = dict(mesh=(2, 2, 2), config=config(), eval=True,
                     round_trip=True)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    x, y = batch()
    cases = {}
    for name, case in CASES.items():
        params, state = weights(case["config"])
        cases[name] = dict(case, params=params, state=state, x=x, y=y)
    out = launch("step", 8, {"cases": cases},
                 str(tmp_path_factory.mktemp("step")))
    return cases, out[0]


def port_unsharded(case):
    model = port_model(case["config"])
    p, s = params_from_jax(case["params"], case["state"])
    ts = train_state_from(p, s, adam(1e-3), 0, torch.device("cpu"))
    mask = case.get("time_mask")
    loss, _, new_s = forward_backward(
        model, ts, torch.from_numpy(case["x"]), torch.from_numpy(case["y"]),
        None if mask is None else torch.from_numpy(mask))
    grads = tree_map(lambda t: t.grad.numpy(), ts.params)
    return (float(loss.detach()), grads,
            tree_map(lambda t: t.detach().numpy(), new_s))


STEP_CASES = [f"mesh{s}" for s in MESHES] + ["non_residual", *ROUTE_B,
                                             "masked"]


@pytest.mark.parametrize("name", STEP_CASES)
def test_sharded_step_matches_jax(ranks, name):
    cases, got = ranks
    case = cases[name]
    # the JAX halo cannot run a Pallas kernel under shard_map's replication
    # check on the CPU, and the JAX package runs route B's temporal conv as
    # conv on a time-unsharded mesh: route B is held against the same
    # function on the JAX op path (and against the port's own route B
    # unsharded, below)
    cfg = config() if name in ROUTE_B else case["config"]
    loss, grads, state = jax_sharded(cfg, case["mesh"],
                                     case["params"], case["state"],
                                     case["x"], case["y"],
                                     case.get("time_mask"))
    res = got[name]
    assert abs(res["loss"] - loss) <= REL * abs(loss)
    close_to_largest(res["grads"], grads)
    close_to_largest(res["state"], state)


@pytest.mark.parametrize("name", STEP_CASES)
def test_sharded_step_matches_unsharded_port(ranks, name):
    cases, got = ranks
    loss, grads, state = port_unsharded(cases[name])
    res = got[name]
    assert abs(res["loss"] - loss) <= REL * abs(loss)
    close_to_largest(res["grads"], grads)
    close_to_largest(res["state"], state)


@pytest.mark.parametrize("name", STEP_CASES)
def test_route_b_runs_the_conv_kernels_on_every_mesh(ranks, name):
    """Route B calls both conv kernels' wrappers on every mesh (a data or
    model mesh included, where the JAX package must run conv); the op path
    calls neither."""
    calls = ranks[1][name]["kernel_calls"]
    if name in ROUTE_B:
        assert calls["spatial_conv"] > 0 and calls["temporal_conv"] > 0
    else:
        assert calls == {"spatial_conv": 0, "temporal_conv": 0}


def test_masked_step_uses_the_mask(ranks):
    cases, got = ranks
    unmasked = port_unsharded(dict(cases["masked"], time_mask=None))[0]
    assert abs(got["masked"]["loss"] - unmasked) > 1e-6


def test_eval_sums_match_jax(ranks):
    cases, got = ranks
    case = cases["eval"]
    model = jax_model(case["config"])
    mesh = jmesh.make_mesh(2, 2, 2)
    import optax
    state, shardings = jtrain.create_sharded_train_state(
        model, optax.adam(1e-3), mesh, seed=0)
    state = dataclasses.replace(state, params=case["params"],
                                model_state=case["state"])
    ev = jtrain.make_sharded_eval_step(model, mesh, shardings)
    want = jax.device_get(ev(state, *jtrain.shard_batch(
        case["x"], case["y"], mesh)))
    res = got["eval"]["eval"]
    assert abs(float(res["loss_sum"]) - float(want["loss_sum"])) <= \
        REL * abs(float(want["loss_sum"]))
    assert int(res["correct"]) == int(want["correct"])
    assert int(res["count"]) == N
    np.testing.assert_array_equal(res["cm"], want["cm"])


def test_shard_gather_round_trip_is_bitwise(ranks):
    assert ranks[1]["eval"]["round_trip"] is True


def test_partition_specs_match_jax():
    cfg = config()
    params, _ = weights(cfg)
    want = jmesh.param_partition_specs(jax.tree.map(jnp.asarray, params))
    flat = jax.tree_util.tree_flatten_with_path(
        want, is_leaf=lambda s: isinstance(s, P))[0]
    got = pmesh.param_partition_specs(params)
    assert len(got) == len(flat)
    for path, spec in flat:
        key = "/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                       for k in path)
        assert got[key] == tuple(spec), key
    assert any(s for s in got.values())


@pytest.mark.parametrize("args", [(64, 4), (30, 4), (40, 4), (32, 1),
                                  (36, 3, 3)])
def test_validate_time_sharding_matches_jax(args):
    def outcome(fn):
        try:
            fn(*args)
        except ValueError as e:
            return str(e)
        return None

    assert outcome(pmesh.validate_time_sharding) == \
        outcome(jmesh.validate_time_sharding)


@pytest.mark.parametrize("args", [(25, 5), (25, 1), (25, 2), (25, 25)])
def test_validate_joint_sharding_matches_jax(args):
    def outcome(fn):
        try:
            fn(*args)
        except ValueError as e:
            return str(e)
        return None

    assert outcome(pmesh.validate_joint_sharding) == \
        outcome(jmesh.validate_joint_sharding)


def fake_mesh(shape, coords=(0, 0, 0)):
    """A mesh's shape and coordinates, without groups (for the functions
    that read nothing else)."""
    return pmesh.Mesh(shape=dict(zip(pmesh.AXES, shape)),
                      coords=dict(zip(pmesh.AXES, coords)),
                      device=torch.device("cpu"), backend="gloo", groups={})


@pytest.mark.parametrize("shape", [(8, 1, 1), (1, 1, 8), (1, 8, 1),
                                   (2, 2, 1), (1, 2, 2), (2, 2, 2)])
@pytest.mark.parametrize("configured", ["conv", "pallas", "block", "auto",
                                        "shift_sum"])
def test_select_temporal_impl_matches_jax(shape, configured):
    assert ptrain.select_temporal_impl(fake_mesh(shape), configured) == \
        jtrain.select_temporal_impl(jmesh.make_mesh(*shape), configured)


def test_short_batch_refused_like_jax():
    x = np.zeros((7, 16, V, 2), np.float32)
    y = np.zeros(7, np.int64)
    with pytest.raises(ValueError, match="divisible by 2"):
        jtrain.shard_batch(x, y, jmesh.make_mesh(2, 1, 1))
    with pytest.raises(ValueError, match=r"batch .*\(7\) is not divisible "
                       r"by the mesh's data axis 2"):
        ptrain.shard_batch(x, y, fake_mesh((2, 1, 1)))


def test_mesh_too_small_raises():
    with pytest.raises(ValueError, match="needs 64 devices"):
        jmesh.make_mesh(4, 4, 4)
    with pytest.raises(ValueError, match="needs 64 devices"):
        pmesh.make_mesh(4, 4, 4, device="cpu")
