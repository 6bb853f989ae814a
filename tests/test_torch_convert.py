"""Weights carried from the JAX package's pytrees into the port.

``state_dict_from_jax`` is the port's own copy of the JAX package's
``export_state_dict``: same keys, shapes and values, and the loaded port
model computes what the JAX model computes (float32: rtol 1e-4, atol 1e-5).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from stgcn_tpu.graph.adjacency import Strategy
from stgcn_tpu.models.importer import export_state_dict
from stgcn_tpu.models.stgcn import STGCN as JaxSTGCN
from stgcn_tpu.models.stgcn import STGCNConfig as JaxConfig
from stgcn_tpu_torch.models import stgcn as tm
from stgcn_tpu_torch.models.convert import state_dict_from_jax

PLAN = ((8, 1), (16, 2), (16, 1))


def jax_model(rng, residual, mode):
    jm = JaxSTGCN(JaxConfig(plan=PLAN, strategy=Strategy.SYMMETRICAL, d=1,
                            residual=residual, adjacency_mode=mode))
    params, state = jm.init(jax.random.key(2))
    params = jax.tree.map(lambda p: jnp.asarray(
        np.asarray(p) + rng.normal(0, 0.2, p.shape), np.float32), params)
    state = {"blocks": [
        {k: {"mean": jnp.asarray(rng.normal(0, 0.3, v["mean"].shape),
                                 np.float32),
             "var": jnp.asarray(rng.uniform(0.5, 2.0, v["var"].shape),
                                np.float32)}
         for k, v in bs.items()} for bs in state["blocks"]]}
    return jm, params, state


@pytest.mark.parametrize("mode", ["reference", "mask", "fixed"])
@pytest.mark.parametrize("residual", [False, True])
class TestStateDictFromJax:
    def test_matches_export_state_dict(self, rng, residual, mode):
        jm, params, state = jax_model(rng, residual, mode)
        adj = np.asarray(jm.adjacency)
        ref = export_state_dict(params, state, residual=residual,
                                adjacency=adj)
        got = state_dict_from_jax(params, state, residual=residual,
                                  adjacency=adj)
        assert sorted(got) == sorted(ref)
        for k, v in ref.items():
            assert tuple(got[k].shape) == np.shape(v), k
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(v),
                                          err_msg=k)

    def test_loaded_model_matches_jax(self, rng, residual, mode):
        jm, params, state = jax_model(rng, residual, mode)
        port = tm.STGCN(tm.STGCNConfig(plan=PLAN,
                                       strategy=Strategy.SYMMETRICAL, d=1,
                                       residual=residual,
                                       adjacency_mode=mode))
        port.load_state_dict(state_dict_from_jax(
            params, state, residual=residual,
            adjacency=np.asarray(jm.adjacency)))
        x = rng.normal(0, 1, (2, 20, 25, 2)).astype(np.float32)
        ref, _ = jm.apply(params, state, jnp.asarray(x), train=False)
        with torch.no_grad():
            got = port(torch.from_numpy(x))
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-4,
                                   atol=1e-5)


def test_port_state_dict_keys_are_the_reference_format(rng):
    """A fresh port model has exactly the keys the exporter writes."""
    jm, params, state = jax_model(rng, True, "mask")
    ref = export_state_dict(params, state, residual=True,
                            adjacency=np.asarray(jm.adjacency))
    port = tm.STGCN(tm.STGCNConfig(plan=PLAN, strategy=Strategy.SYMMETRICAL,
                                   d=1, residual=True))
    sd = port.state_dict()
    assert sorted(sd) == sorted(ref)
    for k, v in ref.items():
        assert tuple(sd[k].shape) == np.shape(v), k
