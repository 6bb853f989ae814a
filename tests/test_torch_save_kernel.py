"""The save variant of the spatial op, held against the JAX package.

The plain PyTorch versions of ``spatial_block_save`` (the forward's ``z``
and saved ``y``, and the backward that reads ``y``) are compared with
``spatial_block_vm_save`` (``stgcn_tpu/kernels/block_fused.py:737``), run
in interpret mode on the CPU as the JAX package's own tests run its Pallas
kernels.  Inputs are drawn with numpy and handed to both packages, at the
width the JAX package sends there (``C_in = 256``) and at a narrow one.

Tolerances, as in ``tests/test_torch_train_kernels.py``: float32 values and
gradients at rtol 1e-4 with an absolute floor of 1e-4 of the compared
tensor's largest magnitude (gradients sum over all V*N*T rows, in other
orders).  bfloat16 inputs: the plain version rounds h, y_k and z where the
Pallas kernel does, so outputs agree to a bf16 ulp (rtol 2^-7, atol 1e-2).
The plain save op's gradients equal the plain ``spatial_block``'s exactly:
the saved y_k is the value the recompute gives.

The CUDA side cannot run here: the launch functions run against a fake
library, and the ``ctypes`` declarations are held against the sources.
"""

import contextlib
import ctypes
import re

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from stgcn_tpu.graph.adjacency import Strategy, get_normalized_adjacency
from stgcn_tpu.kernels.block_fused import (
    _spatial_block_fwd_save,
    spatial_block_vm_save,
)
from stgcn_tpu_torch.kernels import _build
from stgcn_tpu_torch.kernels import spatial_block as sb

V, N, T, K = 25, 2, 8, 2
ARGS = ("x", "s1", "t1", "w", "b", "a")


def close(got, want, rtol=1e-4, rel_atol=1e-4, what=""):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    atol = rel_atol * max(float(np.abs(want).max(initial=0.0)), 1e-30)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol, err_msg=what)


def t32(a):
    return torch.from_numpy(np.asarray(a, np.float32))


def inputs(rng, c_in, c_out, t=T):
    f = np.float32
    adjacency = get_normalized_adjacency(Strategy.DISTANCE, 1).astype(f)
    return dict(
        x=rng.normal(0, 1, (V, N, t, c_in)).astype(f),
        s1=rng.normal(1, 0.2, c_in).astype(f),
        t1=rng.normal(0, 0.2, c_in).astype(f),
        w=rng.normal(0, c_in ** -0.5, (c_in, K, c_out)).astype(f),
        b=rng.normal(0, 0.3, (K, c_out)).astype(f),
        # a mask-mode adjacency: the fixed one times a jittered mask
        a=adjacency * rng.uniform(0.5, 1.5, adjacency.shape).astype(f))


@pytest.mark.parametrize("c_in,c_out,relu1", [(256, 256, True),
                                              (256, 256, False),
                                              (8, 128, True)])
def test_values_saved_expansion_and_vjp(rng, c_in, c_out, relu1):
    d = inputs(rng, c_in, c_out)
    g = rng.normal(0, 1, (V, N, T, c_out)).astype(np.float32)
    jargs = [jnp.asarray(d[k]) for k in ARGS]

    def jax_fn(*args):
        return spatial_block_vm_save(*args, relu1, True)[..., :c_out]

    z_jax, vjp = jax.vjp(jax_fn, *jargs)
    grads_jax = vjp(jnp.asarray(g))
    # the expansion the Pallas forward saves: (V, M, K * cp)
    _, y_jax = _spatial_block_fwd_save(*jargs, relu1, True, None)
    cp = y_jax.shape[-1] // K
    y_jax = np.asarray(y_jax)[:, :N * T].reshape(V, N, T, K, cp)

    ins = [t32(d[k]) for k in ARGS]
    z, y = sb.spatial_block_save_forward_reference(*ins, relu1=relu1)
    close(z, z_jax, what="z")
    assert tuple(y.shape) == (K, V, N, T, c_out)
    close(y.permute(1, 2, 3, 0, 4), y_jax[..., :c_out], what="y")
    grads = sb.spatial_block_save_backward_reference(
        ins[0], t32(g), y, ins[1], ins[2], ins[3], ins[5], relu1=relu1)
    for name, got, want in zip(ARGS, grads, grads_jax):
        close(got, want, what="d" + name)


@pytest.mark.parametrize("relu1", [True, False])
def test_gradients_equal_the_recompute_op(rng, relu1):
    d = inputs(rng, 16, 24)
    g = t32(rng.normal(0, 1, (V, N, T, 24)))
    ins = [t32(d[k]).requires_grad_() for k in ARGS]
    before = (sb.spatial_block_save_forward.launches,
              sb.spatial_block_save_backward.launches)
    z_save = sb.spatial_block_save(*ins, relu1=relu1)
    saved = torch.autograd.grad(z_save, ins, g)
    assert (sb.spatial_block_save_forward.launches,
            sb.spatial_block_save_backward.launches) == before
    z = sb.spatial_block(*ins, relu1=relu1)
    recomputed = torch.autograd.grad(z, ins, g)
    assert torch.equal(z_save, z)
    for name, got, want in zip(ARGS, saved, recomputed):
        assert torch.equal(got, want), name


def test_bf16_rounds_like_the_pallas_kernel(rng):
    import ml_dtypes

    d = inputs(rng, 256, 256)
    bf = {k: d[k].astype(ml_dtypes.bfloat16) if k in ("x", "w", "b", "a")
          else d[k] for k in ARGS}
    z_jax, y_jax = _spatial_block_fwd_save(
        *[jnp.asarray(bf[k]) for k in ARGS], True, True, None)
    y_jax = np.asarray(y_jax, np.float32)[:, :N * T].reshape(V, N, T, K,
                                                              256)
    ins = [torch.from_numpy(np.asarray(bf[k], np.float32)).to(torch.bfloat16)
           if k in ("x", "w", "b", "a") else t32(bf[k]) for k in ARGS]
    z, y = sb.spatial_block_save_forward_reference(*ins, relu1=True)
    assert z.dtype == y.dtype == torch.bfloat16
    np.testing.assert_allclose(z.float().numpy(),
                               np.asarray(z_jax, np.float32),
                               rtol=2 ** -7, atol=1e-2)
    np.testing.assert_allclose(y.float().permute(1, 2, 3, 0, 4).numpy(),
                               y_jax, rtol=2 ** -7, atol=1e-2)


class TestLaunch:
    """The CUDA side, without a compiler or a card."""

    @pytest.mark.parametrize("name", ["spatial_block_save_fwd_launch",
                                      "spatial_block_save_bwd_launch"])
    def test_c_signature_matches_argtypes(self, name):
        src = (_build.CSRC / "spatial_block.cu").read_text()
        sig = re.search(r'extern "C" int %s\((.*?)\)\s*\{' % name, src,
                        re.S).group(1)
        kinds = [ctypes.c_void_p if "*" in p else ctypes.c_int
                 for p in sig.split(",")]
        assert kinds == _build.ENTRY_POINTS[name]

    def test_launches_count_apart_from_spatial_block(self, rng,
                                                     monkeypatch):
        calls = {}

        class FakeLib:
            def __getattr__(self, name):
                def launch(*args):
                    calls.setdefault(name, []).append(args)
                    return 0
                return launch

        class FakeStream:
            cuda_stream = 4321

        class FakeProperties:
            multi_processor_count = 132

        monkeypatch.setattr(_build, "load_library", lambda: FakeLib())
        monkeypatch.setattr(torch.cuda, "current_stream",
                            lambda dev=None: FakeStream())
        monkeypatch.setattr(torch.cuda, "device",
                            lambda dev: contextlib.nullcontext())
        monkeypatch.setattr(torch.cuda, "get_device_properties",
                            lambda dev: FakeProperties())
        d = inputs(rng, 256, 256, t=4)
        ins = [t32(d[k]) for k in ARGS]
        plain = (sb.spatial_block_forward.launches,
                 sb.spatial_block_backward.launches)
        before = (sb.spatial_block_save_forward.launches,
                  sb.spatial_block_save_backward.launches)
        z, y = sb._launch_save_forward(*ins, relu1=True)
        grads = sb._launch_save_backward(
            ins[0], torch.zeros(V, N, 4, 256), y, ins[1], ins[2], ins[3],
            ins[5], relu1=False)
        assert (sb.spatial_block_save_forward.launches,
                sb.spatial_block_save_backward.launches) == (before[0] + 1,
                                                             before[1] + 1)
        assert (sb.spatial_block_forward.launches,
                sb.spatial_block_backward.launches) == plain
        assert tuple(z.shape) == (V, N, 4, 256)
        assert tuple(y.shape) == (K, V, N, 4, 256)
        for got, p in zip(grads, ins):
            assert got.shape == p.shape and got.dtype == p.dtype
        (fwd,), (bwd,) = (calls["spatial_block_save_fwd_launch"],
                          calls["spatial_block_save_bwd_launch"])
        for args, name in ((fwd, "spatial_block_save_fwd_launch"),
                           (bwd, "spatial_block_save_bwd_launch")):
            declared = _build.ENTRY_POINTS[name]
            assert len(args) == len(declared) and args[-1] == 4321
        frames, fsmem, bsmem = sb.plan_frames(V, 256, 256)
        # fwd: ..., V, M, C_in, C_out, K, frames, relu1, smem
        assert fwd[8:16] == (V, N * 4, 256, 256, K, frames, 1, fsmem)
        # bwd: ..., V, M, C_in, C_out, K, frames, ctas, relu1, smem
        assert bwd[11:20] == (V, N * 4, 256, 256, K, frames,
                              min(2 * 132, -(-N * 4 // frames)), 0, bsmem)
