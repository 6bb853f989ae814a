"""The port's train-mode ops against the JAX package.

Train BatchNorm, the train block on the op path (both orders, the three
adjacency modes, stride 2 with its projection), the BN affine of the fused
path and the fused train block (spatial and temporal ops with their plain
versions) are held against ``stgcn_tpu.ops`` and ``stgcn_tpu.models.fused``
on the same numpy-drawn inputs: values, new running statistics and
gradients.  The op path is compared in float64 at rtol 1e-9; the fused block
against the JAX fused block (Pallas kernels in interpret mode, which compute
in float32) in float32 at rtol 1e-4, with an absolute floor of 1e-4 of the
largest magnitude among the compared tensors.  Dropout's masks come from other random bits in
the two packages, so it is checked by its statistics.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from stgcn_tpu.graph.adjacency import Strategy, get_normalized_adjacency
from stgcn_tpu.models.fused import _bn_affine_train as jax_bn_affine
from stgcn_tpu.models.fused import (
    block_forward_fused_train as jax_fused_block,
)
from stgcn_tpu.ops.batchnorm import batchnorm as jax_batchnorm
from stgcn_tpu.ops.block import block_forward as jax_block_forward
from stgcn_tpu.ops.block import init_block
from stgcn_tpu_torch.models.convert import params_from_jax, params_to_numpy
from stgcn_tpu_torch.models.fused import (
    bn_affine_train,
    block_forward_fused_train,
)
from stgcn_tpu_torch.ops.batchnorm import batchnorm_train
from stgcn_tpu_torch.ops.block import block_forward_train
from stgcn_tpu_torch.ops.common import dropout

GAMMA = 9


def close(got, want, rtol, rel_atol, what=""):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    atol = rel_atol * max(float(np.abs(want).max(initial=0.0)), 1e-30)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol, err_msg=what)


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    return [np.asarray(tree, np.float64)]


def close_trees(got, want, rtol, rel_atol, path=""):
    """Leaf by leaf, with the absolute floor taken from the whole tree's
    largest magnitude: a gradient that is exactly 0 in exact arithmetic
    (the temporal bias ahead of BN2 in the non-residual order) is rounding
    noise on both sides."""
    scale = max(float(np.abs(x).max(initial=0.0)) for x in _leaves(want))
    got_l, want_l = _leaves(got), _leaves(want)
    assert len(got_l) == len(want_l), path
    for i, (g, w) in enumerate(zip(got_l, want_l)):
        np.testing.assert_allclose(g, w, rtol=rtol, atol=rel_atol * scale,
                                   err_msg=f"{path} leaf {i}")


@pytest.fixture(scope="module")
def adjacency():
    return get_normalized_adjacency(Strategy.DISTANCE, 1)


def random_block(rng, c_in, c_out, adjacency, *, stride, residual, mode,
                 dtype):
    """JAX ``init_block`` parameters and BN state, moved away from their
    fresh values (which would hide fold, mask and statistic bugs)."""
    params, state = init_block(jax.random.key(1), c_in, c_out,
                               jnp.asarray(adjacency, dtype), gamma=GAMMA,
                               stride=stride, residual=residual,
                               adjacency_mode=mode, dtype=dtype)
    np_dt = np.dtype(dtype)
    params = jax.tree.map(
        lambda p: np.asarray(p) + rng.normal(0, 0.2, p.shape).astype(np_dt),
        params)
    state = {k: {"mean": rng.normal(0, 0.3, v["mean"].shape).astype(np_dt),
                 "var": rng.uniform(0.5, 2.0, v["var"].shape).astype(np_dt)}
             for k, v in state.items()}
    return params, state


def torch_grads(loss, params):
    leaves, paths = [], []

    def walk(tree, path):
        for k, v in tree.items():
            if isinstance(v, dict):
                walk(v, path + (k,))
            else:
                leaves.append(v)
                paths.append(path + (k,))
    walk(params, ())
    grads = torch.autograd.grad(loss, leaves)
    out: dict = {}
    for path, g in zip(paths, grads):
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = g.numpy()
    return out


def with_grad(tree):
    return {k: with_grad(v) if isinstance(v, dict) else v.requires_grad_()
            for k, v in tree.items()}


class TestBatchNormTrain:
    def test_matches_jax_float64(self, rng):
        x = rng.normal(0.5, 2.0, (3, 7, 25, 6))
        params = {"scale": rng.normal(1, 0.2, 6),
                  "offset": rng.normal(0, 0.2, 6)}
        state = {"mean": rng.normal(0, 0.3, 6),
                 "var": rng.uniform(0.5, 2, 6)}
        ct = rng.normal(0, 1, x.shape)

        def jax_loss(p, x_):
            y, s = jax_batchnorm(p, state, x_, train=True)
            return jnp.sum(y * ct), (y, s)

        (_, (y_j, s_j)), g_j = jax.value_and_grad(
            jax_loss, argnums=(0, 1), has_aux=True)(params, jnp.asarray(x))
        tp, ts = params_from_jax(params, state)
        tx = torch.from_numpy(x).requires_grad_()
        tp = with_grad(tp)
        y, s = batchnorm_train(tp, ts, tx)
        close(y.detach(), y_j, 1e-10, 1e-12, "y")
        close_trees(params_to_numpy(s), s_j, 1e-10, 1e-12, "state")
        gx, gs, go = torch.autograd.grad((y * torch.from_numpy(ct)).sum(),
                                         [tx, tp["scale"], tp["offset"]])
        close(gx, g_j[1], 1e-9, 1e-12, "dx")
        close(gs, g_j[0]["scale"], 1e-9, 1e-12, "dscale")
        close(go, g_j[0]["offset"], 1e-9, 1e-12, "doffset")

    def test_bf16_statistics_in_float32(self, rng):
        x = torch.from_numpy(rng.normal(3.0, 0.5, (4, 16, 25, 8)).astype(
            np.float32)).to(torch.bfloat16)
        p = {"scale": torch.ones(8), "offset": torch.zeros(8)}
        s = {"mean": torch.zeros(8), "var": torch.ones(8)}
        y, new = batchnorm_train(p, s, x)
        assert y.dtype == torch.bfloat16
        assert new["mean"].dtype == torch.float32
        xf = x.float()
        n = xf[..., 0].numel()
        np.testing.assert_allclose(new["mean"].numpy(),
                                   0.1 * xf.mean(dim=(0, 1, 2)).numpy(),
                                   rtol=1e-5)
        unbiased = xf.var(dim=(0, 1, 2), unbiased=True)
        np.testing.assert_allclose(new["var"].numpy(),
                                   (0.9 + 0.1 * unbiased).numpy(), rtol=1e-4)
        assert n > 1

    def test_affine_form_matches_jax(self, rng):
        x = rng.normal(0.5, 2.0, (25, 3, 7, 6))
        params = {"scale": rng.normal(1, 0.2, 6),
                  "offset": rng.normal(0, 0.2, 6)}
        state = {"mean": rng.normal(0, 0.3, 6),
                 "var": rng.uniform(0.5, 2, 6)}
        s_j, t_j, st_j = jax_bn_affine(params, state,
                                       jnp.asarray(x, jnp.float32))
        tp, ts = params_from_jax(params, state, dtype=torch.float32)
        s, t, st = bn_affine_train(tp, ts, torch.from_numpy(x).float())
        close(s, s_j, 1e-5, 1e-6, "s")
        close(t, t_j, 1e-5, 1e-6, "t")
        close_trees(params_to_numpy(st), st_j, 1e-5, 1e-6, "state")
        # x * s + t is the normalized x
        y, _ = batchnorm_train(tp, ts, torch.from_numpy(x))
        close(torch.from_numpy(x) * s.double() + t.double(), y, 1e-5, 1e-6)


class TestDropout:
    @pytest.mark.parametrize("rate", [0.5, 0.2])
    def test_keep_rate_and_scale(self, rate):
        x = torch.ones(200_000)
        gen = torch.Generator().manual_seed(3)
        y = dropout(x, rate, generator=gen)
        kept = y != 0
        keep = 1 - rate
        # binomial standard error at n = 2e5 is under 1.2e-3: 5 sigma
        assert abs(kept.float().mean().item() - keep) < 6e-3
        assert torch.allclose(y[kept], torch.full_like(y[kept], 1 / keep))

    def test_dtype_determinism_and_rate_zero(self):
        x = torch.randn(4, 8, 25, 16).to(torch.bfloat16)
        a = dropout(x, 0.5, generator=torch.Generator().manual_seed(1))
        b = dropout(x, 0.5, generator=torch.Generator().manual_seed(1))
        assert a.dtype == torch.bfloat16 and torch.equal(a, b)
        assert dropout(x, 0.0, generator=None) is x
        assert dropout(x, 0.5, generator=None, train=False) is x


class TestTrainBlockOps:
    # (c_in, c_out, stride, residual)
    SHAPES = [(4, 8, 1, False), (4, 8, 2, True), (8, 8, 1, True)]

    @pytest.mark.parametrize("mode", ["mask", "reference", "fixed"])
    @pytest.mark.parametrize("c_in,c_out,stride,residual", SHAPES)
    def test_matches_jax_float64(self, rng, adjacency, mode, c_in, c_out,
                                 stride, residual):
        params, state = random_block(rng, c_in, c_out, adjacency,
                                     stride=stride, residual=residual,
                                     mode=mode, dtype=jnp.float64)
        x = rng.normal(0, 1, (2, 12, 25, c_in))
        t_out = (12 - 1) // stride + 1
        ct = rng.normal(0, 1, (2, t_out, 25, c_out))

        def jax_loss(p):
            out, s = jax_block_forward(p, state, jnp.asarray(x),
                                       jnp.asarray(adjacency), stride=stride,
                                       residual=residual, train=True)
            return jnp.sum(out * ct), (out, s)

        (_, (out_j, s_j)), g_j = jax.value_and_grad(
            jax_loss, has_aux=True)(params)
        tp, ts = params_from_jax(params, state)
        tp = with_grad(tp)
        out, s = block_forward_train(tp, ts, torch.from_numpy(x),
                                     torch.from_numpy(adjacency),
                                     stride=stride, residual=residual)
        close(out.detach(), out_j, 1e-9, 1e-12, "out")
        close_trees(params_to_numpy(s), s_j, 1e-9, 1e-12, "state")
        grads = torch_grads((out * torch.from_numpy(ct)).sum(), tp)
        close_trees(grads, g_j, 1e-8, 1e-11, "grad")
        if mode == "mask":     # Adam walks the mask, so its gradient lands
            assert np.abs(grads["mask"]).max() > 0

    def test_dropout_needs_a_generator(self, rng, adjacency):
        params, state = random_block(rng, 4, 8, adjacency, stride=1,
                                     residual=False, mode="mask",
                                     dtype=jnp.float32)
        tp, ts = params_from_jax(params, state)
        x = torch.zeros(1, 4, 25, 4)
        a = torch.from_numpy(adjacency.astype(np.float32))
        with pytest.raises(ValueError, match="generator"):
            block_forward_train(tp, ts, x, a, dropout_rate=0.5)
        out, _ = block_forward_train(tp, ts, x, a, dropout_rate=0.5,
                                     generator=torch.Generator())
        assert out.shape == (1, 4, 25, 8)


class TestFusedTrainBlock:
    # (c_in, c_out, stride, residual, mode): the packed (C_out = 64, stride
    # 1) and unpacked JAX routes, both orders, and a fixed graph (need_da off)
    CASES = [(2, 64, 1, True, "mask"), (8, 16, 2, True, "mask"),
             (16, 16, 1, True, "fixed"), (8, 16, 1, False, "mask"),
             (8, 16, 2, False, "reference")]

    @pytest.mark.parametrize("c_in,c_out,stride,residual,mode", CASES)
    def test_matches_jax_fused_block(self, rng, adjacency, c_in, c_out,
                                     stride, residual, mode):
        adj32 = adjacency.astype(np.float32)
        params, state = random_block(rng, c_in, c_out, adj32, stride=stride,
                                     residual=residual, mode=mode,
                                     dtype=jnp.float32)
        x = rng.normal(0, 1, (25, 2, 16, c_in)).astype(np.float32)
        t_out = (16 - 1) // stride + 1
        ct = rng.normal(0, 1, (25, 2, t_out, c_out)).astype(np.float32)

        def jax_loss(p):
            out, s = jax_fused_block(p, state, jnp.asarray(x),
                                     jnp.asarray(adj32), stride=stride,
                                     residual=residual, interpret=True)
            return jnp.sum(out * ct), (out, s)

        (_, (out_j, s_j)), g_j = jax.value_and_grad(
            jax_loss, has_aux=True)(params)
        tp, ts = params_from_jax(params, state)
        tp = with_grad(tp)
        out, s = block_forward_fused_train(tp, ts, torch.from_numpy(x),
                                           torch.from_numpy(adj32),
                                           stride=stride, residual=residual)
        close(out.detach(), out_j, 1e-4, 1e-4, "out")
        close_trees(params_to_numpy(s), s_j, 1e-4, 1e-4, "state")
        grads = torch_grads((out * torch.from_numpy(ct)).sum(), tp)
        close_trees(grads, g_j, 1e-4, 1e-4, "grad")
