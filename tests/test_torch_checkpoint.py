"""Checkpoints of the port, and across the port and the JAX package.

``stgcn_tpu_torch.training.checkpoint`` writes the JAX package's format
(``.npz`` keyed by JAX key paths plus a JSON sidecar), so a checkpoint
written by either package restores in the other for the same config.
Held here: the port's round trip (bitwise), ``latest_checkpoint`` and
``skip_prefixes``; a JAX-written checkpoint restored in the port and a
port-written one restored in the JAX package, each compared by eval logits
and by one resumed Adam step (loss and parameters at rtol 1e-4, floor 1e-5
of the largest: both sides take the same update from the same moments,
summing in other orders); the repository's own training checkpoints
(``runs/synth_ckpt/ckpt_120``: optax Adam, K=3; ``runs/r3_e2e/ckpt/ckpt_69``:
``flat_adam``, K=2) restored by both packages on configs of their shapes,
compared by eval logits; and ``Predictor.from_checkpoint`` against the JAX
``Predictor.from_checkpoint``.  Float32 on the CPU.
"""

import dataclasses
import json
from pathlib import Path

import numpy as np
import optax
import pytest

import jax
import jax.numpy as jnp
import torch

from stgcn_tpu.graph.adjacency import Strategy
from stgcn_tpu.models.stgcn import DEFAULT_PLAN
from stgcn_tpu.models.stgcn import STGCN as JaxSTGCN
from stgcn_tpu.models.stgcn import STGCNConfig as JaxConfig
from stgcn_tpu.serving import Predictor as JaxPredictor
from stgcn_tpu.training import checkpoint as jax_ckpt
from stgcn_tpu.training.loop import make_train_step as jax_make_train_step
from stgcn_tpu.training.optimizers import flat_adam as jax_flat_adam
from stgcn_tpu.training.train_state import (
    create_train_state as jax_create_train_state,
)
from stgcn_tpu_torch.models import stgcn as tm
from stgcn_tpu_torch.serving import Predictor
from stgcn_tpu_torch.training import checkpoint as ckpt
from stgcn_tpu_torch.training.loop import make_train_step
from stgcn_tpu_torch.training.optimizers import adam, flat_adam
from stgcn_tpu_torch.training.train_state import create_train_state
from stgcn_tpu_torch.tree import tree_leaves

ROOT = Path(__file__).resolve().parents[1]
PLAN = ((16, 1), (16, 2))
N, T = 2, 16
RTOL, REL_ATOL = 1e-4, 1e-5


def configs(plan=PLAN, **kw):
    common = dict(plan=plan, strategy=Strategy.DISTANCE, residual=True,
                  **{"d": 1, **kw})
    return JaxConfig(**common), tm.STGCNConfig(**common)


def batch(rng, n=N, t=T):
    x = rng.normal(0, 1, (n, t, 25, 2)).astype(np.float32)
    y = np.asarray([0, 3, 5, 3][:n], np.int64)
    return x, y


def close(got, want, rtol=RTOL, rel_atol=REL_ATOL, what=""):
    got_l, want_l = ([np.asarray(t, np.float64) for t in g]
                     for g in (got, want))
    assert len(got_l) == len(want_l)
    scale = max(float(np.abs(w).max(initial=0.0)) for w in want_l)
    for i, (g, w) in enumerate(zip(got_l, want_l)):
        np.testing.assert_allclose(g, w, rtol=rtol, atol=rel_atol * scale,
                                   err_msg=f"{what} leaf {i}")


def port_state(tcfg, opt=adam, seed=0, steps=0, rng=None):
    model = tm.STGCN(tcfg)
    ts = create_train_state(model, opt(1e-3), seed, device="cpu")
    if steps:
        x, y = batch(rng)
        step = make_train_step(model)
        for _ in range(steps):
            step(ts, torch.from_numpy(x), torch.from_numpy(y))
    return model, ts


def port_logits(model, ts, x):
    with torch.no_grad():
        return model.apply(ts.params, ts.model_state, torch.from_numpy(x),
                           train=False)[0].numpy()


def jax_logits(jm, jts, x):
    forward = jax.jit(lambda p, s, x: jm.apply(p, s, x, train=False)[0])
    return np.asarray(forward(jts.params, jts.model_state, jnp.asarray(x)))


def jax_leaves(tree):
    """A JAX parameter tree's leaves in the port's leaf order (sorted dict
    keys, lists in order): JAX flattens dicts the same way."""
    return [np.asarray(t) for t in jax.tree.leaves(tree)]


class TestPortRoundTrip:
    @pytest.mark.parametrize("opt", [adam, flat_adam])
    def test_restored_state_resumes_bitwise(self, rng, tmp_path, opt):
        _, tcfg = configs(adjacency_mode="mask", mask_jitter=0.1)
        model, ts = port_state(tcfg, opt, seed=3, steps=2, rng=rng)
        path = ckpt.save_checkpoint(str(tmp_path / "ckpt_2"), ts,
                                    {"step": 2, "epoch": 1})
        assert path.endswith("ckpt_2.npz") and not list(
            tmp_path.glob("*.tmp"))
        assert ckpt.checkpoint_metadata(str(tmp_path / "ckpt_2")) == {
            "step": 2, "epoch": 1}
        _, fresh = port_state(tcfg, opt, seed=9)
        restored = ckpt.restore_checkpoint(str(tmp_path / "ckpt_2"), fresh)
        assert restored is fresh and (fresh.step, fresh.seed) == (2, 3)
        for a, b in zip(ts.leaves(), fresh.leaves()):
            assert torch.equal(a, b)
            sa, sb = ts.optimizer.state[a], fresh.optimizer.state[b]
            for key in ("step", "exp_avg", "exp_avg_sq"):
                assert torch.equal(sa[key], sb[key]), key
        x, y = (torch.from_numpy(a) for a in batch(rng))
        step = make_train_step(model)
        la, lb = (float(step(s, x, y)["loss"]) for s in (ts, fresh))
        assert la == lb
        for a, b in zip(ts.leaves(), fresh.leaves()):
            assert torch.equal(a, b)
        for a, b in zip(tree_leaves(ts.model_state),
                        tree_leaves(fresh.model_state)):
            assert torch.equal(a, b)

    def test_latest_skip_prefixes_and_errors(self, rng, tmp_path):
        _, tcfg = configs()
        model, ts = port_state(tcfg, steps=1, rng=rng)
        for step in (5, 40, 7):
            ckpt.save_checkpoint(str(tmp_path / f"ckpt_{step}"), ts)
        (tmp_path / "ckpt_x.npz").write_bytes(b"")
        assert ckpt.latest_checkpoint(str(tmp_path)) == str(
            tmp_path / "ckpt_40")
        assert ckpt.latest_checkpoint(str(tmp_path / "none")) is None
        assert ckpt.checkpoint_metadata(str(tmp_path / "ckpt_5")) == {}
        _, fresh = port_state(tcfg, seed=4)
        before = [t.clone() for t in fresh.leaves()]
        ckpt.restore_checkpoint(str(tmp_path / "ckpt_5"), fresh,
                                skip_prefixes=("params", "opt_state"))
        assert all(torch.equal(a, b) for a, b in zip(before, fresh.leaves()))
        assert not fresh.optimizer.state and fresh.step == 1
        assert torch.equal(fresh.model_state["blocks"][1]["bn2"]["mean"],
                           ts.model_state["blocks"][1]["bn2"]["mean"])
        # a tree target gives a new tree of the target's kinds of leaves
        tree = ckpt.restore_checkpoint(
            str(tmp_path / "ckpt_5"),
            {"params": {"fc": {"w": torch.zeros(16, 6)}},
             "step": np.zeros((), np.int32)})
        assert torch.equal(tree["params"]["fc"]["w"], ts.params["fc"]["w"])
        assert int(tree["step"]) == 1
        with pytest.raises(KeyError, match="missing leaf 'params/nope'"):
            ckpt.restore_checkpoint(str(tmp_path / "ckpt_5"),
                                    {"params": {"nope": torch.zeros(1)}})
        _, wide = port_state(configs(plan=((32, 1), (16, 2)))[1])
        with pytest.raises(ValueError, match="shape"):
            ckpt.restore_checkpoint(str(tmp_path / "ckpt_5"), wide)

    def test_seed_is_written_as_key_data(self):
        for seed in (0, 7, 2 ** 40 + 5):
            data = ckpt.seed_to_key_data(seed)
            assert data.dtype == np.uint32 and data.shape == (2,)
            assert ckpt.key_data_to_seed(data) == seed
        np.testing.assert_array_equal(
            ckpt.seed_to_key_data(7),
            np.asarray(jax.random.key_data(jax.random.key(7))))


@pytest.fixture(scope="module")
def jax_trained(tmp_path_factory):
    """A JAX train state two steps into training, saved by the JAX
    package."""
    rng = np.random.default_rng(1)
    jcfg, tcfg = configs(adjacency_mode="mask", mask_jitter=0.1)
    jm = JaxSTGCN(jcfg)
    jts = jax_create_train_state(jm, optax.adam(1e-3), seed=0)
    step = jax_make_train_step(jm, optax.adam(1e-3), donate=False)
    x, y = batch(rng)
    for _ in range(2):
        jts, _ = step(jts, jnp.asarray(x), jnp.asarray(y))
    base = str(tmp_path_factory.mktemp("jax") / "ckpt_2")
    jax_ckpt.save_checkpoint(base, jts, {"step": 2})
    return jm, jts, step, tcfg, base


def test_jax_checkpoint_resumes_in_the_port(rng, jax_trained):
    jm, jts, jax_step, tcfg, base = jax_trained
    model, ts = port_state(tcfg, seed=5)
    ckpt.restore_checkpoint(base, ts)
    assert ts.step == 2
    mu = jax_leaves(jts.opt_state[0].mu)
    for p, m in zip(ts.leaves(), mu):
        np.testing.assert_array_equal(
            ts.optimizer.state[p]["exp_avg"].numpy(), m)
    x, y = batch(rng)
    close([port_logits(model, ts, x)], [jax_logits(jm, jts, x)],
          what="eval logits")
    loss = float(make_train_step(model)(ts, torch.from_numpy(x),
                                        torch.from_numpy(y))["loss"])
    jts2, met = jax_step(jts, jnp.asarray(x), jnp.asarray(y))
    np.testing.assert_allclose(loss, float(met["loss"]), rtol=RTOL)
    close([t.detach() for t in ts.leaves()], jax_leaves(jts2.params),
          what="resumed parameters")


def test_port_checkpoint_resumes_in_jax(rng, tmp_path, jax_trained):
    jm, _, jax_step, tcfg, _ = jax_trained
    model, ts = port_state(tcfg, seed=2, steps=2, rng=rng)
    base = str(tmp_path / "ckpt_2")
    ckpt.save_checkpoint(base, ts)
    template = jax_create_train_state(jm, optax.adam(1e-3), seed=11)
    jts = jax_ckpt.restore_checkpoint(base, template)
    assert int(jts.step) == 2
    np.testing.assert_array_equal(np.asarray(jax.random.key_data(jts.rng)),
                                  ckpt.seed_to_key_data(2))
    x, y = batch(rng)
    close([port_logits(model, ts, x)], [jax_logits(jm, jts, x)],
          what="eval logits")
    loss = float(make_train_step(model)(ts, torch.from_numpy(x),
                                        torch.from_numpy(y))["loss"])
    jts2, met = jax_step(jts, jnp.asarray(x), jnp.asarray(y))
    np.testing.assert_allclose(loss, float(met["loss"]), rtol=RTOL)
    close([t.detach() for t in ts.leaves()], jax_leaves(jts2.params),
          what="resumed parameters")


# the repository's training checkpoints: 10 blocks, residual, fixed graph;
# K=3 is distance partitioning with d=2
RUNS = [("runs/synth_ckpt/ckpt_120", 2, False),
        ("runs/r3_e2e/ckpt/ckpt_69", 1, True)]


@pytest.mark.parametrize("base,d,flat", RUNS, ids=["adam", "flat_adam"])
def test_repository_checkpoints_restore_in_both(rng, base, d, flat):
    base = str(ROOT / base)
    jcfg, tcfg = configs(plan=DEFAULT_PLAN, d=d, adjacency_mode="fixed")
    jm = JaxSTGCN(jcfg)
    jopt = jax_flat_adam(1e-3) if flat else optax.adam(1e-3)
    # the template's structure only: every leaf is restored
    template = jax.eval_shape(lambda: jax_create_train_state(jm, jopt,
                                                             seed=0))
    jts = jax_ckpt.restore_checkpoint(base, template)
    model, ts = port_state(tcfg, flat_adam if flat else adam)
    ckpt.restore_checkpoint(base, ts)
    meta = ckpt.checkpoint_metadata(base)
    assert ts.step == int(jts.step) == meta["step"]
    with np.load(base + ".npz") as data:
        key = ("opt_state/flat_mu" if flat
               else "opt_state/0/mu/fc/w")
        mu = data[key][-256 * 6:].reshape(256, 6) if flat else data[key]
    np.testing.assert_array_equal(
        ts.optimizer.state[ts.params["fc"]["w"]]["exp_avg"].numpy(), mu)
    x, _ = batch(rng)
    close([port_logits(model, ts, x)], [jax_logits(jm, jts, x)],
          what="eval logits")


def test_predictor_from_checkpoint_matches_jax(rng, jax_trained):
    jm, _, _, tcfg, base = jax_trained
    seqs = [rng.normal(0, 1, (t, 25, 2)).astype(np.float32)
            for t in (12, 30, 32)]
    want = JaxPredictor.from_checkpoint(base, jm.config, buckets=(16, 32),
                                        max_batch=2).predict(seqs)
    pred = Predictor.from_checkpoint(base, tcfg, buckets=(16, 32),
                                     max_batch=2, device="cpu")
    got = pred.predict(seqs)
    np.testing.assert_allclose(got.probs, want.probs, rtol=1e-4, atol=1e-6)
    np.testing.assert_array_equal(got.labels, want.labels)
