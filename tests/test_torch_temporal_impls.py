"""The temporal conv's op formulations, held against the JAX package.

``conv_vt``, ``shift_sum`` and ``block``
(``stgcn_tpu_torch.ops.temporal_conv``) against the JAX
``temporal_conv(impl=...)`` on the same weights and input: values and the
gradients of ``sum(sin(y))`` with respect to the weights, the bias and the
input, as ``tests/test_op_parity.py`` holds the JAX impls against each
other.  float64 at 1e-10 (the same products summed in other orders); with
``compute_dtype=bfloat16`` against the JAX package's bf16 output of the
same impl (both round the inputs and the result at the same points; one
bf16 ulp, 2^-7 relative, for a sum that lands on either side of a rounding
boundary) and against the float32 ``conv`` oracle (2% of its largest
value: two bf16 roundings of inputs and output).  Strides 1 and 2, T in
{37, 48} (37: the block formulation's last block is partial and its right
padding is cut by ``max(right, 0)``), with and without the padding's
shortfall at stride 2.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from stgcn_tpu.ops.temporal_conv import init_temporal_conv
from stgcn_tpu.ops.temporal_conv import temporal_conv as jax_temporal_conv
from stgcn_tpu_torch.ops.temporal_conv import TEMPORAL_IMPLS, temporal_conv

IMPLS = ("conv_vt", "shift_sum", "block")
HI = jax.lax.Precision.HIGHEST
CASES = [(4, 6, 9, 1, 37), (4, 6, 9, 2, 37), (6, 6, 9, 1, 48),
         (6, 6, 9, 2, 48), (3, 5, 5, 2, 48)]


def inputs(c_in, c_out, gamma, t, dtype=np.float64):
    rng = np.random.default_rng(c_in * 100 + t + gamma)
    params = init_temporal_conv(jax.random.key(1), c_in, c_out, gamma)
    params = {k: np.asarray(v, dtype) for k, v in params.items()}
    params["b"] = params["b"] + rng.normal(0, 0.1, c_out).astype(dtype)
    x = rng.standard_normal((2, t, 25, c_in)).astype(dtype)
    return params, x


def jax_value_and_grads(params, x, stride, impl, compute_dtype=None):
    def loss(p, x):
        y = jax_temporal_conv(p, x, stride=stride, impl=impl, precision=HI,
                              compute_dtype=compute_dtype)
        return jnp.sum(jnp.sin(y.astype(jnp.float64))), y

    (_, y), (gp, gx) = jax.value_and_grad(loss, argnums=(0, 1),
                                          has_aux=True)(
        jax.tree.map(jnp.asarray, params), jnp.asarray(x))
    return np.asarray(y.astype(jnp.float64)), gp, np.asarray(gx)


def port_value_and_grads(params, x, stride, impl, compute_dtype=None):
    p = {k: torch.tensor(v, requires_grad=True) for k, v in params.items()}
    xt = torch.tensor(x, requires_grad=True)
    y = temporal_conv(p, xt, stride=stride, impl=impl,
                      compute_dtype=compute_dtype)
    torch.sin(y.double()).sum().backward()
    return (y.detach().double().numpy(),
            {k: v.grad.numpy() for k, v in p.items()}, xt.grad.numpy())


def test_every_impl_is_accepted():
    assert set(IMPLS) | {"auto", "conv", "pallas"} == set(TEMPORAL_IMPLS)
    with pytest.raises(ValueError, match="temporal_impl"):
        temporal_conv({"w": torch.zeros(9, 1, 2, 2), "b": torch.zeros(2)},
                      torch.zeros(1, 9, 25, 2), impl="fft")


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("case", CASES, ids=lambda c: "ci{}co{}g{}s{}t{}"
                         .format(*c))
def test_float64_values_and_gradients_match_jax(impl, case):
    c_in, c_out, gamma, stride, t = case
    params, x = inputs(c_in, c_out, gamma, t)
    want_y, want_gp, want_gx = jax_value_and_grads(params, x, stride, impl)
    got_y, got_gp, got_gx = port_value_and_grads(params, x, stride, impl)
    assert got_y.shape == want_y.shape == (2, (t - 1) // stride + 1, 25,
                                           c_out)
    np.testing.assert_allclose(got_y, want_y, rtol=1e-10, atol=1e-10)
    np.testing.assert_allclose(got_gx, want_gx, rtol=1e-10, atol=1e-10)
    for k in ("w", "b"):
        np.testing.assert_allclose(got_gp[k], np.asarray(want_gp[k]),
                                   rtol=1e-10, atol=1e-10)


@pytest.mark.parametrize("impl", ("conv",) + IMPLS)
@pytest.mark.parametrize("stride,t", [(1, 37), (2, 48)])
def test_bfloat16_against_jax_and_the_float32_oracle(impl, stride, t):
    params, x = inputs(6, 6, 9, t, np.float32)
    oracle, _, _ = jax_value_and_grads(params, x, stride, "conv")
    want, _, _ = jax_value_and_grads(params, x, stride, impl,
                                     compute_dtype=jnp.bfloat16)
    got, _, _ = port_value_and_grads(params, x, stride, impl,
                                     compute_dtype=torch.bfloat16)
    scale = np.abs(oracle).max()
    np.testing.assert_allclose(got, oracle, rtol=0, atol=2e-2 * scale)
    np.testing.assert_allclose(got, want, rtol=2.0 ** -7, atol=1e-6 * scale)


@pytest.mark.parametrize("impl", ["shift_sum", "block"])
def test_bfloat16_taps_sum_in_float32(impl):
    """On bf16 activations and weights (as the model passes them),
    shift_sum and block round once, after the bias: the output is the
    float32 sum of the products plus the bias, rounded to bf16, not a sum
    of bf16 partials.  Sums in another float32 order may land on the other
    side of a rounding boundary: one ulp at most, in under 1% of the
    outputs."""
    params, x = inputs(6, 6, 9, 37, np.float32)
    bf = {k: torch.from_numpy(v).to(torch.bfloat16) for k, v in
          params.items()}
    xb = torch.from_numpy(x).to(torch.bfloat16)
    exact = temporal_conv({k: v.float() for k, v in bf.items()}, xb.float(),
                          impl="conv").to(torch.bfloat16)
    got = temporal_conv(bf, xb, impl=impl, compute_dtype=torch.bfloat16)
    assert got.dtype == torch.bfloat16
    diff = (got.float() - exact.float()).abs()
    assert (diff <= 2.0 ** -7 * exact.float().abs()).all()
    assert (diff > 0).float().mean() < 0.01
