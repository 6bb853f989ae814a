"""``dropout_impl="bits8"``: one random byte an element, kept below
``round(keep * 256)`` and rescaled by that effective keep probability.

Mirrors ``tests/test_training.py``'s ``TestBits8Dropout`` on the port: the
keep rate and the unbiased mean (within 0.02 on 65536 elements: five
standard deviations of a Bernoulli(0.5) mean is 0.01), exact doubling at
rate 0.5, the gradient equal to mask / keep_eff, the degenerate
thresholds (0 or 256) taking the exact path, and one train step at model
level on the op path, on the fused path's plain versions and on the
hybrid.  The JAX package's masks come from other random bits, so the two
agree in distribution only: its own bits8 statistics are checked beside
the port's.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from stgcn_tpu.ops.common import dropout as jax_dropout
from stgcn_tpu_torch.graph.adjacency import Strategy
from stgcn_tpu_torch.models import stgcn as tm
from stgcn_tpu_torch.ops.common import DROPOUT_IMPLS, dropout
from stgcn_tpu_torch.training.loop import make_train_step
from stgcn_tpu_torch.training.optimizers import adam
from stgcn_tpu_torch.training.train_state import create_train_state


def gen(seed=0):
    return torch.Generator().manual_seed(seed)


@pytest.mark.parametrize("rate", [0.5, 0.3])
def test_keep_rate_and_unbiased_mean(rate):
    x = torch.ones(128, 512)
    y = dropout(x, rate, generator=gen(), impl="bits8")
    assert abs(float(y.mean()) - 1.0) < 0.02
    assert abs(float((y > 0).float().mean()) - (1 - rate)) < 0.02
    # the JAX package's bits8 draws other bits, with the same statistics
    yj = jax_dropout(jax.random.key(0), jnp.ones((128, 512)), rate,
                     train=True, impl="bits8")
    assert abs(float(yj.mean()) - 1.0) < 0.02
    assert abs(float((yj > 0).mean()) - (1 - rate)) < 0.02


def test_rate_half_doubles_exactly():
    y = dropout(torch.ones(64, 64), 0.5, generator=gen(), impl="bits8")
    assert set(torch.unique(y).tolist()) <= {0.0, 2.0}


@pytest.mark.parametrize("rate", [0.5, 0.3, 0.1])
def test_gradient_is_mask_over_effective_keep(rate):
    x = torch.ones(8, 64, requires_grad=True)
    out = dropout(x, rate, generator=gen(1), impl="bits8")
    out.sum().backward()
    keep_eff = round((1 - rate) * 256) / 256
    mask = out.detach() > 0
    torch.testing.assert_close(x.grad, torch.where(
        mask, torch.tensor(1 / keep_eff), torch.tensor(0.0)))


@pytest.mark.parametrize("rate", [0.001, 0.999])
def test_degenerate_thresholds_take_the_exact_path(rate):
    # round(0.999 * 256) = 256 keeps everything, round(0.001 * 256) = 0
    # nothing: both fall back to the float32 uniform, as in JAX
    x = torch.randn(32, 32, generator=gen(2))
    got = dropout(x, rate, generator=gen(3), impl="bits8")
    want = dropout(x, rate, generator=gen(3), impl="exact")
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_eval_and_rate_zero_pass_through_and_bad_impl_raises():
    x = torch.randn(4, 4, generator=gen())
    assert dropout(x, 0.5, generator=gen(), train=False, impl="bits8") is x
    assert dropout(x, 0.0, generator=gen(), impl="bits8") is x
    assert DROPOUT_IMPLS == ("exact", "bits8")
    with pytest.raises(ValueError, match="dropout impl"):
        dropout(x, 0.5, generator=gen(), impl="bits16")


@pytest.mark.parametrize("block_impl", ["ops", "fused", "hybrid"])
def test_model_level_train_step(block_impl):
    cfg = tm.STGCNConfig(plan=((8, 1), (16, 2)), strategy=Strategy.DISTANCE,
                         residual=True, dropout_rate=0.5,
                         dropout_impl="bits8", block_impl=block_impl,
                         fused_blocks=(1,) if block_impl == "hybrid" else
                         None)
    model = tm.STGCN(cfg)
    ts = create_train_state(model, adam(1e-3), seed=0, device="cpu")
    step = make_train_step(model)
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.standard_normal((4, 16, 25, 2)).astype(
        np.float32))
    y = torch.from_numpy(rng.integers(0, 6, 4))
    losses = [float(step(ts, x, y)["loss"]) for _ in range(2)]
    assert all(np.isfinite(losses))
    assert all(bool(torch.isfinite(p).all()) for p in ts.leaves())
