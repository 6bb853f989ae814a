"""The training slice as a whole against the JAX package.

The port's ``make_train_step`` and the JAX ``make_train_step`` start from the
same weights (the JAX ``create_train_state``'s, randomised and handed over
with ``params_from_jax``) and take three Adam steps on one batch, float32,
dropout 0: the hybrid (fused blocks on the port's spatial and temporal ops,
run here by their plain versions; on the JAX side the Pallas kernels in
interpret mode, as ``tests/test_hybrid.py`` runs them) and the op path.
Compared: the three losses (rtol 1e-4), the step-0 gradients of every
parameter (rtol 1e-4, absolute floor 1e-4 of the largest gradient) and the
BN running statistics after the first step (rtol 1e-4, floor 1e-5 of the
largest).  Parameters evolved by Adam are not compared: a gradient that is
0 in exact arithmetic (the temporal bias ahead of BN2 in the non-residual
order) is rounding noise that Adam turns into a full-size step, so the
statistics after the third step, which follow those parameters, are
compared at rtol 1e-2 only.
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
from stgcn_tpu.training.loop import make_eval_step as jax_make_eval_step
from stgcn_tpu.training.loop import make_train_step as jax_make_train_step
from stgcn_tpu.training.train_state import (
    create_train_state as jax_create_train_state,
)
from stgcn_tpu_torch.models import stgcn as tm
from stgcn_tpu_torch.models.convert import (
    params_from_jax,
    params_to_numpy,
    state_dict_from_params,
)
from stgcn_tpu_torch.training.loop import make_eval_step, make_train_step
from stgcn_tpu_torch.training.optimizers import adam
from stgcn_tpu_torch.training.train_state import (
    create_train_state,
    step_generator,
    train_state_from,
)
from stgcn_tpu_torch.tree import tree_leaves

# block 0: C_in=2 -> 64, stride 1 (the JAX packed route); block 1: stride 2
# with its projection (the unpacked route); block 2 on the op chain.
PLAN = ((64, 1), (16, 2), (16, 1))
N, T = 4, 16
CPU = torch.device("cpu")


def configs(residual, **kw):
    common = dict(plan=PLAN, strategy=Strategy.DISTANCE, d=1,
                  residual=residual, **kw)
    return JaxConfig(**common), tm.STGCNConfig(**common)


def batch(rng):
    x = rng.normal(0, 1, (N, T, 25, 2)).astype(np.float32)
    y = np.asarray([0, 3, 5, 3], np.int64)
    return x, y


def randomized_jax_state(jax_model, rng):
    ts = jax_create_train_state(jax_model, optax.adam(1e-3), seed=0)

    def jitter(path, p):
        name = jax.tree_util.keystr(path)
        p = np.asarray(p)
        if "mask" in name:
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
    """The ``.grad`` of every leaf, as a tree of numpy arrays."""
    if isinstance(params, dict):
        return {k: grads_like(v) for k, v in params.items()}
    if isinstance(params, list):
        return [grads_like(v) for v in params]
    return params.grad.numpy()


@pytest.mark.parametrize("block_impl,fused_blocks,residual", [
    ("hybrid", (0, 1), True),
    ("hybrid", (0, 1), False),
    ("ops", None, True),
])
def test_three_steps_match_jax(rng, block_impl, fused_blocks, residual):
    jcfg, tcfg = configs(residual, block_impl=block_impl,
                         fused_blocks=fused_blocks)
    jax_model = JaxSTGCN(jcfg)
    jts = randomized_jax_state(jax_model, rng)
    x, y = batch(rng)
    xj, yj = jnp.asarray(x), jnp.asarray(y)

    def loss_fn(params):
        logits, _ = jax_model.apply(params, jts.model_state, xj, train=True)
        return jax_metrics.cross_entropy(logits, yj)

    grads0 = jax.grad(loss_fn)(jts.params)
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
        if i == 0:
            close_trees(params_to_numpy(ts.model_state), jax_states[0],
                        1e-4, 1e-5)
    # Later statistics follow parameters that Adam moved: a gradient at
    # rounding-noise level (exactly 0 for the temporal bias ahead of BN2 in
    # the non-residual order) becomes a full learning-rate step whose sign
    # differs between the packages.
    close_trees(params_to_numpy(ts.model_state), jax_states[-1], 1e-2, 1e-3)
    np.testing.assert_allclose(losses, jax_losses, rtol=1e-4, atol=1e-5)
    assert ts.step == 3


def numpy_pair(params, state):
    return tuple(jax.tree.map(np.asarray, t) for t in (params, state))


def test_eval_step_matches_jax(rng):
    jcfg, tcfg = configs(True)
    jax_model = JaxSTGCN(jcfg)
    jts = randomized_jax_state(jax_model, rng)
    x, y = batch(rng)
    want = jax_make_eval_step(jax_model)(jts, jnp.asarray(x), jnp.asarray(y))
    model = tm.STGCN(tcfg)
    ts = train_state_from(
        *params_from_jax(*numpy_pair(jts.params, jts.model_state)), adam(),
        0, CPU)
    got = make_eval_step(model)(ts, torch.from_numpy(x), torch.from_numpy(y))
    np.testing.assert_allclose(float(got["loss_sum"]),
                               float(want["loss_sum"]), rtol=1e-5)
    assert int(got["correct"]) == int(want["correct"])
    np.testing.assert_array_equal(got["cm"].numpy(), np.asarray(want["cm"]))


class TestTrainState:
    def test_init_params_follow_the_module_weights(self):
        cfg = tm.STGCNConfig(plan=((8, 1), (16, 2)),
                             strategy=Strategy.DISTANCE, residual=True,
                             mask_jitter=0.1)
        model = tm.STGCN(cfg, seed=5)
        params, state = model.init_params(5)
        for block, bp in zip(model.conv, params["blocks"]):
            mp, _ = block.params_and_state()
            torch.testing.assert_close(bp["spatial"]["w"], mp["spatial"]["w"])
            torch.testing.assert_close(bp["temporal"]["w"],
                                       mp["temporal"]["w"])
            assert "A" not in bp and bp["mask"].shape == (2, 25, 25)
            assert bp["spatial"]["w"].is_contiguous()
            # 1 + 2*(randn - 0.5)*0.1: centred on 0.9, spread 0.2
            assert abs(float(bp["mask"].mean()) - 0.9) < 0.05
        assert state["blocks"][0]["bn1"]["var"].dtype == torch.float32
        again, _ = model.init_params(5)
        assert torch.equal(again["blocks"][1]["mask"],
                           params["blocks"][1]["mask"])

    def test_adjacency_modes(self):
        for mode, key in (("reference", "A"), ("fixed", None)):
            cfg = tm.STGCNConfig(plan=((8, 1),), adjacency_mode=mode)
            bp = tm.STGCN(cfg).init_params(0)[0]["blocks"][0]
            assert "mask" not in bp
            assert (key in bp) if key else ("A" not in bp)

    def test_trained_weights_fold_into_a_servable_state_dict(self, rng):
        cfg = tm.STGCNConfig(plan=((8, 1), (16, 2)),
                             strategy=Strategy.DISTANCE, residual=True,
                             mask_jitter=0.2)
        model = tm.STGCN(cfg)
        ts = create_train_state(model, adam(1e-2), device="cpu")
        x, y = batch(rng)
        step = make_train_step(model)
        for _ in range(2):
            step(ts, torch.from_numpy(x), torch.from_numpy(y))
        served = tm.STGCN(cfg, seed=123)
        served.load_state_dict(state_dict_from_params(
            ts.params, ts.model_state, residual=True,
            adjacency=model.adjacency))
        with torch.no_grad():
            want, _ = model.apply(ts.params, ts.model_state,
                                  torch.from_numpy(x))
            got = served(torch.from_numpy(x))
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)

    def test_dropout_steps_draw_new_masks(self, rng):
        cfg = tm.STGCNConfig(plan=((8, 1), (16, 2)), residual=True,
                             dropout_rate=0.5, block_impl="hybrid",
                             fused_blocks=(1,))
        model = tm.STGCN(cfg)
        ts = create_train_state(model, adam(), seed=3, device="cpu")
        x, y = batch(rng)
        losses = [float(make_train_step(model)(ts, torch.from_numpy(x),
                                               torch.from_numpy(y))["loss"])
                  for _ in range(2)]
        assert all(np.isfinite(losses))
        a = torch.rand(5, generator=step_generator(3, 0, torch.device("cpu")))
        b = torch.rand(5, generator=step_generator(3, 1, torch.device("cpu")))
        c = torch.rand(5, generator=step_generator(3, 0, torch.device("cpu")))
        assert not torch.equal(a, b) and torch.equal(a, c)

    def test_adam_matches_optax(self, rng):
        p0 = rng.normal(0, 1, 50).astype(np.float32)
        grads = [rng.normal(0, 1, 50).astype(np.float32) for _ in range(4)]
        opt = optax.adam(1e-2)
        pj, sj = jnp.asarray(p0), opt.init(jnp.asarray(p0))
        for g in grads:
            upd, sj = opt.update(jnp.asarray(g), sj, pj)
            pj = optax.apply_updates(pj, upd)
        pt = torch.from_numpy(p0.copy()).requires_grad_()
        topt = adam(1e-2)([pt])
        for g in grads:
            pt.grad = torch.from_numpy(g)
            topt.step()
        np.testing.assert_allclose(pt.detach().numpy(), np.asarray(pj),
                                   rtol=1e-6, atol=1e-7)
        assert tree_leaves({"b": pt, "a": [pt]}) == [pt, pt]


class TestConfig:
    def test_validation(self):
        with pytest.raises(ValueError, match="fused_blocks"):
            tm.STGCNConfig(plan=PLAN, block_impl="hybrid", fused_blocks=(2, 1))
        with pytest.raises(ValueError, match="fused_blocks"):
            tm.STGCNConfig(plan=PLAN, block_impl="hybrid", fused_blocks=(0, 9))
        with pytest.raises(ValueError, match="fused_from"):
            tm.STGCNConfig(plan=PLAN, block_impl="hybrid", fused_from=7)
        with pytest.raises(ValueError, match="block_impl"):
            tm.STGCNConfig(block_impl="megakernel")
        assert tm.STGCNConfig(dropout_impl="bits8").dropout_impl == "bits8"
        with pytest.raises(ValueError, match="dropout_impl"):
            tm.STGCNConfig(dropout_impl="approx")
        assert tm.STGCNConfig(plan=PLAN, fused_blocks=[0, 2]).fused_blocks \
            == (0, 2)

    @pytest.mark.parametrize("block_impl", ["fused", "hybrid"])
    def test_time_mask_refused_on_the_fused_train_step(self, block_impl):
        model = tm.STGCN(tm.STGCNConfig(plan=((8, 1),), fused_from=0,
                                        block_impl=block_impl))
        params, state = model.init_params(0)
        with pytest.raises(ValueError, match="time_mask"):
            model.apply(params, state, torch.zeros(2, 8, 25, 2), train=True,
                        time_mask=torch.ones(2, 8, dtype=torch.bool))

    def test_train_state_defaults_to_cuda(self):
        model = tm.STGCN(tm.STGCNConfig(plan=((8, 1),)))
        if torch.cuda.is_available():
            pytest.skip("a GPU is present; the CPU-only refusal is moot")
        with pytest.raises(RuntimeError, match="device='cpu'"):
            create_train_state(model, adam())
