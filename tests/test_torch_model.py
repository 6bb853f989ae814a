"""The port's STGCN and fused eval forward against the JAX package.

The same weights go to both packages through ``state_dict_from_jax``; BN
statistics, masks and biases are randomised first.  float32 tolerance:
rtol 1e-4, atol 1e-5.  Dense-Lambda adjacency is compared in float64 only.
"""

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from stgcn_tpu.graph.adjacency import Strategy
from stgcn_tpu.models.fused import fused_eval_forward as jax_fused_eval
from stgcn_tpu.models.stgcn import STGCN as JaxSTGCN
from stgcn_tpu.models.stgcn import STGCNConfig as JaxConfig
from stgcn_tpu_torch.models import stgcn as tm
from stgcn_tpu_torch.models.convert import state_dict_from_jax
from stgcn_tpu_torch.models.fused import fused_eval_forward

RTOL, ATOL = 1e-4, 1e-5

# Narrow plans with the stride and widening pattern of the two full plans.
PLAN_DEFAULT_SMALL = ((8, 1), (8, 1), (16, 2))
PLAN_9_SMALL = ((8, 1), (16, 2), (32, 2))


def distances_for_test(rng):
    # coarse values so that some joints tie, as gravity-center distances do
    return np.round(rng.uniform(0.0, 2.0, 25), 1)


def randomize(params, state, rng, dtype=np.float32):
    def jitter(p):
        return jnp.asarray(np.asarray(p) + rng.normal(0, 0.2, p.shape), dtype)

    params = jax.tree.map(jitter, params)
    blocks = [{k: {"mean": jnp.asarray(rng.normal(0, 0.3, v["mean"].shape),
                                       dtype),
                   "var": jnp.asarray(rng.uniform(0.5, 2.0, v["var"].shape),
                                      dtype)}
               for k, v in bs.items()} for bs in state["blocks"]]
    return params, {"blocks": blocks}


def build_pair(jcfg, rng, distances=None, torch_dtype=torch.float32,
               np_dtype=np.float32):
    """A JAX model with randomised weights and the port's copy of it."""
    jm = JaxSTGCN(jcfg, distances=distances)
    params, state = jm.init(jax.random.key(0))
    params, state = randomize(params, state, rng, np_dtype)
    tcfg = tm.STGCNConfig(
        c_in=jcfg.c_in, num_classes=jcfg.num_classes, gamma=jcfg.gamma,
        strategy=jcfg.strategy, d=jcfg.d, norm_mode=jcfg.norm_mode,
        adjacency_mode=jcfg.adjacency_mode, residual=jcfg.residual,
        final_softmax=jcfg.final_softmax, plan=jcfg.plan, dtype=torch_dtype)
    port = tm.STGCN(tcfg, distances=distances)
    port.load_state_dict(state_dict_from_jax(
        params, state, residual=jcfg.residual,
        adjacency=np.asarray(jm.adjacency)))
    return jm, params, state, port


STRATEGIES = [Strategy.UNI_LABELING, Strategy.DISTANCE,
              Strategy.SPATIAL_CONFIGURATION, Strategy.SYMMETRICAL]


class TestSTGCN:
    @pytest.mark.parametrize("plan", [PLAN_DEFAULT_SMALL, PLAN_9_SMALL],
                             ids=["default_shaped", "plan9_shaped"])
    @pytest.mark.parametrize("residual", [False, True])
    @pytest.mark.parametrize("strategy", STRATEGIES, ids=lambda s: s.name)
    def test_matches_jax_apply(self, rng, strategy, residual, plan):
        jcfg = JaxConfig(plan=plan, strategy=strategy, d=1,
                         residual=residual)
        dist = distances_for_test(rng)
        jm, params, state, port = build_pair(jcfg, rng, distances=dist)
        x = rng.normal(0, 1, (2, 24, 25, 2)).astype(np.float32)
        ref, _ = jm.apply(params, state, jnp.asarray(x), train=False)
        got = port(torch.from_numpy(x))
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref),
                                   rtol=RTOL, atol=ATOL)

    @pytest.mark.parametrize("mode", ["reference", "mask", "fixed"])
    def test_adjacency_modes_and_final_softmax(self, rng, mode):
        jcfg = JaxConfig(plan=PLAN_9_SMALL, strategy=Strategy.DISTANCE,
                         residual=True, adjacency_mode=mode,
                         final_softmax=True)
        jm, params, state, port = build_pair(jcfg, rng)
        x = rng.normal(0, 1, (2, 20, 25, 2)).astype(np.float32)
        ref, _ = jm.apply(params, state, jnp.asarray(x), train=False)
        got = port(torch.from_numpy(x)).detach()
        np.testing.assert_allclose(got.sum(-1).numpy(), 1.0, rtol=1e-5)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref),
                                   rtol=RTOL, atol=ATOL)

    def test_time_mask(self, rng):
        jcfg = JaxConfig(plan=PLAN_9_SMALL, strategy=Strategy.DISTANCE,
                         residual=True)
        jm, params, state, port = build_pair(jcfg, rng)
        x = rng.normal(0, 1, (2, 24, 25, 2)).astype(np.float32)
        mask = np.zeros((2, 24), bool)
        mask[0, :13] = True
        mask[1, :] = True
        ref, _ = jm.apply(params, state, jnp.asarray(x), train=False,
                          time_mask=jnp.asarray(mask))
        got = port(torch.from_numpy(x), torch.from_numpy(mask))
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref),
                                   rtol=RTOL, atol=ATOL)

    @pytest.mark.parametrize("residual", [False, True])
    def test_dense_lambda_float64(self, rng, residual):
        jcfg = JaxConfig(plan=PLAN_DEFAULT_SMALL, strategy=Strategy.DISTANCE,
                         residual=residual, norm_mode="reference",
                         dtype=jnp.float64)
        jm, params, state, port = build_pair(
            jcfg, rng, torch_dtype=torch.float64, np_dtype=np.float64)
        x = rng.normal(0, 1, (2, 16, 25, 2))
        ref, _ = jm.apply(params, state, jnp.asarray(x), train=False)
        got = port(torch.from_numpy(x)).detach()
        assert got.dtype == torch.float64
        np.testing.assert_allclose(got.numpy(), np.asarray(ref),
                                   rtol=1e-9, atol=1e-9)

    def test_seeded_init_is_reproducible(self):
        cfg = tm.STGCNConfig(plan=PLAN_9_SMALL, residual=True)
        a, b, c = tm.STGCN(cfg, seed=3), tm.STGCN(cfg, seed=3), tm.STGCN(
            cfg, seed=4)
        for k, v in a.state_dict().items():
            torch.testing.assert_close(v, b.state_dict()[k], rtol=0, atol=0)
        w = "conv.0.spatialConv.W.weight"
        assert not torch.equal(a.state_dict()[w], c.state_dict()[w])

    def test_full_plans_have_reference_layout(self):
        for plan, n in ((tm.DEFAULT_PLAN, 10), (tm.PLAN_9, 9)):
            m = tm.STGCN(tm.STGCNConfig(plan=plan, strategy=Strategy.DISTANCE,
                                        residual=True))
            sd = m.state_dict()
            assert len(m.conv) == n
            assert sd["conv.0.spatialConv.W.weight"].shape == (128, 2, 1, 1)
            assert sd[f"conv.{n - 1}.temporalConv.weight"].shape == (
                256, 256, 9, 1)
            assert sd["fc_layer.weight"].shape == (6, 256)


def fused(port, x, **kw):
    """The port's fused eval forward over the module's own weights."""
    return fused_eval_forward(port, *port.params_and_state(), x,
                              **kw).detach()


class TestFusedEvalForward:
    @pytest.mark.parametrize("residual", [False, True])
    def test_matches_jax_fused_with_packed_blocks(self, rng, residual):
        """A plan whose C=64 stride-1 blocks run the packed TPU kernel."""
        jcfg = JaxConfig(plan=((64, 1), (64, 1), (16, 2)),
                         strategy=Strategy.DISTANCE, residual=residual)
        jm, params, state, port = build_pair(jcfg, rng)
        x = rng.normal(0, 1, (2, 16, 25, 2)).astype(np.float32)
        ref = jax_fused_eval(jm, params, state, jnp.asarray(x),
                             interpret=True)
        got = fused(port, torch.from_numpy(x))
        np.testing.assert_allclose(got.numpy(), np.asarray(ref),
                                   rtol=RTOL, atol=ATOL)

    def test_masked_matches_jax_fused(self, rng):
        jcfg = JaxConfig(plan=((8, 1), (16, 2)), strategy=Strategy.DISTANCE,
                         residual=True)
        jm, params, state, port = build_pair(jcfg, rng)
        x = rng.normal(0, 1, (2, 20, 25, 2)).astype(np.float32)
        mask = np.zeros((2, 20), bool)
        mask[0, :11] = True
        mask[1, :] = True
        ref = jax_fused_eval(jm, params, state, jnp.asarray(x),
                             interpret=True, time_mask=jnp.asarray(mask))
        got = fused(port, torch.from_numpy(x),
                    time_mask=torch.from_numpy(mask))
        np.testing.assert_allclose(got.numpy(), np.asarray(ref),
                                   rtol=RTOL, atol=ATOL)
        # and the masked op path agrees
        ops = port(torch.from_numpy(x), torch.from_numpy(mask)).detach()
        np.testing.assert_allclose(got.numpy(), ops.numpy(),
                                   rtol=RTOL, atol=ATOL)

    def test_strided_then_packable_plan_matches_jax_ops(self, rng):
        """The plan ((64,2),(64,1)) hits the TPU chaining fault
        (stgcn_tpu/models/fused.py:127), so the port is held against the
        JAX ops path there."""
        jcfg = JaxConfig(plan=((64, 2), (64, 1)), strategy=Strategy.DISTANCE,
                         residual=True)
        jm, params, state, port = build_pair(jcfg, rng)
        x = rng.normal(0, 1, (2, 32, 25, 2)).astype(np.float32)
        ref, _ = jm.apply(params, state, jnp.asarray(x), train=False)
        got = fused(port, torch.from_numpy(x))
        np.testing.assert_allclose(got.numpy(), np.asarray(ref),
                                   rtol=RTOL, atol=ATOL)

    @pytest.mark.parametrize("residual", [False, True])
    def test_matches_op_path(self, rng, residual):
        jcfg = JaxConfig(plan=PLAN_9_SMALL, strategy=Strategy.SYMMETRICAL,
                         residual=residual, final_softmax=True)
        _, _, _, port = build_pair(jcfg, rng)
        x = torch.from_numpy(rng.normal(0, 1, (2, 24, 25, 2)).astype(
            np.float32))
        np.testing.assert_allclose(fused(port, x),
                                   port(x).detach(), rtol=RTOL, atol=ATOL)

    def test_bf16_close_to_f32(self, rng):
        jcfg = JaxConfig(plan=PLAN_9_SMALL, strategy=Strategy.DISTANCE,
                         residual=True)
        _, _, _, port = build_pair(jcfg, rng)
        x = torch.from_numpy(rng.normal(0, 1, (2, 24, 25, 2)).astype(
            np.float32))
        f32 = fused(port, x)
        port.config = dataclasses.replace(port.config,
                                          compute_dtype=torch.bfloat16)
        b16 = fused(port, x)
        assert b16.dtype == torch.bfloat16
        np.testing.assert_allclose(b16.float().numpy(), f32.numpy(),
                                   atol=0.1, rtol=0.05)
