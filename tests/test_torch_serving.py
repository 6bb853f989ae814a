"""The port's Predictor (on the CPU) against the JAX Predictor's op path.

Both get the same weights through ``state_dict_from_jax`` with randomised
BN statistics and biases.  float32 tolerance: rtol 1e-4, atol 1e-5.
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
from stgcn_tpu.serving import Predictor as JaxPredictor
from stgcn_tpu_torch import resolve_device
from stgcn_tpu_torch.models import stgcn as tm
from stgcn_tpu_torch.models.convert import state_dict_from_jax
from stgcn_tpu_torch.serving import Predictor

RTOL, ATOL = 1e-4, 1e-5
PLAN = ((8, 1), (16, 2))


def randomized_jax_model(seed=0):
    rng = np.random.default_rng(seed)
    jm = JaxSTGCN(JaxConfig(plan=PLAN, strategy=Strategy.DISTANCE, d=1,
                            residual=True))
    params, state = jm.init(jax.random.key(seed))
    params = jax.tree.map(lambda p: jnp.asarray(
        np.asarray(p) + rng.normal(0, 0.2, p.shape), np.float32), params)
    state = {"blocks": [
        {k: {"mean": jnp.asarray(rng.normal(0, 0.3, v["mean"].shape),
                                 np.float32),
             "var": jnp.asarray(rng.uniform(0.5, 2.0, v["var"].shape),
                                np.float32)}
         for k, v in bs.items()} for bs in state["blocks"]]}
    return jm, params, state


@pytest.fixture(scope="module")
def pair():
    jm, params, state = randomized_jax_model()
    port = tm.STGCN(tm.STGCNConfig(plan=PLAN, strategy=Strategy.DISTANCE,
                                   d=1, residual=True))
    port.load_state_dict(state_dict_from_jax(
        params, state, residual=True, adjacency=np.asarray(jm.adjacency)))
    return jm, params, state, port


def sequences(rng, lengths):
    return [rng.normal(0, 1, (t, 25, 2)).astype(np.float32) for t in lengths]


def jax_predictor(pair, **kw):
    jm, params, state, _ = pair
    return JaxPredictor(jm, params, state, use_fused=False,
                        persistent_cache=False, **kw)


class TestPredictor:
    def test_variable_length_matches_jax(self, pair, rng):
        seqs = sequences(rng, (40, 53, 66, 79, 130))
        ours = Predictor(pair[3], max_batch=4, device="cpu").predict(seqs)
        ref = jax_predictor(pair, max_batch=4).predict(seqs)
        assert ours.probs.shape == (5, 6)
        np.testing.assert_allclose(ours.probs, ref.probs, rtol=RTOL,
                                   atol=ATOL)
        np.testing.assert_array_equal(ours.labels, ref.labels)
        assert ours.label_names == ref.label_names

    @pytest.mark.parametrize("batch_pad", ["max", "pow2", "none"])
    def test_batch_pad_policies(self, pair, rng, batch_pad):
        seqs = sequences(rng, (50, 51, 52))
        ours = Predictor(pair[3], max_batch=8, batch_pad=batch_pad,
                         device="cpu")
        assert ours._padded_batch(3) == {"max": 8, "pow2": 4,
                                         "none": 3}[batch_pad]
        got = ours.predict(seqs).probs
        ref = jax_predictor(pair, max_batch=8,
                            batch_pad=batch_pad).predict(seqs).probs
        np.testing.assert_allclose(got, ref, rtol=RTOL, atol=ATOL)
        single = np.stack([ours.predict([s]).probs[0] for s in seqs])
        np.testing.assert_allclose(got, single, rtol=RTOL, atol=ATOL)

    def test_rejects_unknown_batch_pad(self, pair):
        with pytest.raises(ValueError, match="batch_pad"):
            Predictor(pair[3], batch_pad="half", device="cpu")

    def test_predict_stream_matches_predict_batch(self, pair, rng):
        pred = Predictor(pair[3], max_batch=4, device="cpu")
        xs = [rng.standard_normal((4, 64, 25, 2)).astype(np.float32)
              for _ in range(5)]
        serial = [pred.predict_batch(x) for x in xs]
        for depth in (1, 2, 8):
            got = list(pred.predict_stream(xs, depth=depth))
            assert len(got) == len(xs)
            for g, s in zip(got, serial):
                np.testing.assert_array_equal(g, s)

    def test_op_path_and_fused_path_agree(self, pair, rng):
        seqs = sequences(rng, (45, 100))
        fused = Predictor(pair[3], device="cpu").predict(seqs).probs
        ops = Predictor(pair[3], use_fused=False,
                        device="cpu").predict(seqs).probs
        np.testing.assert_allclose(fused, ops, rtol=RTOL, atol=ATOL)

    def test_from_state_dict_reference_format(self, pair, rng):
        jm, params, state, _ = pair
        sd = export_state_dict(params, state, residual=True,
                               adjacency=np.asarray(jm.adjacency))
        # reference dicts carry BatchNorm2d's counters; eval ignores them
        sd["conv.0.batch_n.num_batches_tracked"] = np.array(7)
        cfg = tm.STGCNConfig(plan=PLAN, strategy=Strategy.DISTANCE, d=1,
                             residual=True)
        pred = Predictor.from_state_dict(sd, cfg, max_batch=2, device="cpu")
        seqs = sequences(rng, (64, 70))
        ref = jax_predictor(pair, max_batch=2).predict(seqs)
        np.testing.assert_allclose(pred.predict(seqs).probs, ref.probs,
                                   rtol=RTOL, atol=ATOL)

    def test_bf16_serving_close_to_f32(self, pair, rng):
        import copy
        import dataclasses

        seqs = sequences(rng, (40, 77, 90))
        m16 = copy.deepcopy(pair[3])
        m16.config = dataclasses.replace(m16.config,
                                         compute_dtype=torch.bfloat16)
        p16 = Predictor(m16, max_batch=4, device="cpu")
        assert p16._transfer_dtype == torch.bfloat16
        got = p16.predict(seqs).probs
        ref = Predictor(pair[3], max_batch=4, device="cpu").predict(
            seqs).probs
        np.testing.assert_allclose(got.sum(axis=1), 1.0, rtol=1e-2)
        np.testing.assert_allclose(got, ref, atol=0.05)

    def test_warmup_runs_every_bucket(self, pair):
        pred = Predictor(pair[3], buckets=(64, 96), max_batch=2,
                         device="cpu")
        pred.warmup()


class TestDevice:
    def test_cuda_is_the_default_and_never_falls_back(self):
        if torch.cuda.is_available():
            assert resolve_device().type == "cuda"
        else:
            with pytest.raises(RuntimeError, match="CUDA"):
                resolve_device()
            with pytest.raises(RuntimeError, match="CUDA"):
                Predictor(tm.STGCN(tm.STGCNConfig(plan=PLAN)))

    def test_cpu_on_request(self):
        assert resolve_device("cpu").type == "cpu"
        with pytest.raises(ValueError, match="cuda"):
            resolve_device("meta")
