"""The standalone-conv routes' kernels, held against the JAX package.

The plain PyTorch versions of the port's ``spatial_conv`` and
``temporal_conv`` ops, in both layouts (values and VJPs), are compared with
the four Pallas kernels they replace, run in interpret mode on the CPU as
``tests/test_kernels.py`` and ``tests/test_vntc.py`` run them:
``spatial_conv_fused``, ``spatial_conv_fused_vm``, ``temporal_conv_fused``
and ``temporal_conv_fused_vm``.  Inputs are drawn with numpy and handed to
both packages.

Tolerances: float32 values and gradients at rtol 1e-4 with an absolute
floor of 1e-4 of the compared tensor's largest magnitude (the packages sum
in other orders; weight gradients sum N*T*V terms); bfloat16 at rtol and
an absolute floor of 2e-2 of the largest magnitude (a few bf16 ulps: both
sides round at the same points but sum in other orders).  The Pallas
kernels compute in float32 whatever their inputs, so the float64 checks
hold the plain versions against autograd of a float64 ``jax.numpy`` oracle
instead, at rtol 1e-10.

The CUDA side cannot run here: the ``ctypes`` declarations are held against
the C signatures read from the sources, each launch function runs against a
fake library, and the tile plans are held to the card's shared memory at
the shapes of DEFAULT_PLAN's ten blocks.
"""

import contextlib
import ctypes
import re

import ml_dtypes
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from stgcn_tpu.graph.adjacency import Strategy, get_normalized_adjacency
from stgcn_tpu.kernels.spatial_conv import (
    spatial_conv_fused as jax_spatial_conv,
    spatial_conv_fused_vm as jax_spatial_conv_vm,
)
from stgcn_tpu.kernels.temporal_conv import (
    temporal_conv_fused as jax_temporal_conv,
)
from stgcn_tpu.kernels.temporal_conv_vm import (
    temporal_conv_fused_vm as jax_temporal_conv_vm,
)
from stgcn_tpu_torch.kernels import _build
from stgcn_tpu_torch.kernels import spatial_block as sb
from stgcn_tpu_torch.kernels import spatial_conv as sc
from stgcn_tpu_torch.kernels import temporal_block as tb
from stgcn_tpu_torch.kernels import temporal_conv as tc
from stgcn_tpu_torch.kernels.block_eval import SMEM_LIMIT

V, N, T, K, GAMMA = 25, 2, 16, 2, 9
RTOL = 1e-4
BF16 = 2e-2
LAYOUTS = ["vntc", "ntvc"]


def close(got, want, rtol=RTOL, rel_atol=1e-4, what=""):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    atol = rel_atol * max(float(np.abs(want).max(initial=0.0)), 1e-30)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol, err_msg=what)


def tensor(a, dtype=torch.float32):
    return torch.from_numpy(np.asarray(a, np.float32)).to(dtype)


@pytest.fixture(scope="module")
def adjacency():
    return get_normalized_adjacency(Strategy.DISTANCE, 1).astype(np.float32)


def spatial_inputs(rng, layout, c_in, c_out, adjacency, t=T):
    f = np.float32
    shape = (V, N * t, c_in) if layout == "vntc" else (N, t, V, c_in)
    return dict(
        x=rng.normal(0, 1, shape).astype(f),
        w=rng.normal(0, c_in ** -0.5, (c_in, K, c_out)).astype(f),
        b=rng.normal(0, 0.3, (K, c_out)).astype(f),
        # a mask-mode adjacency: the fixed one times a jittered mask
        a=adjacency * rng.uniform(0.5, 1.5, adjacency.shape).astype(f))


def temporal_inputs(rng, layout, c_in, c_out, t=T):
    f = np.float32
    shape = (V * N, t, c_in) if layout == "vntc" else (N, t, V, c_in)
    return dict(
        x=rng.normal(0, 1, shape).astype(f),
        w=rng.normal(0, (GAMMA * c_in) ** -0.5,
                     (GAMMA, c_in, c_out)).astype(f),
        b=rng.normal(0, 0.3, c_out).astype(f))


def t_out_of(t, stride):
    return (t - 1) // stride + 1


def temporal_out_shape(layout, x_shape, c_out, stride):
    if layout == "vntc":
        return (x_shape[0], t_out_of(x_shape[1], stride), c_out)
    return (x_shape[0], t_out_of(x_shape[1], stride), x_shape[2], c_out)


SPATIAL_ARGS = ("x", "w", "b", "a")
TEMPORAL_ARGS = ("x", "w", "b")


def jax_spatial(layout):
    kernel = jax_spatial_conv_vm if layout == "vntc" else jax_spatial_conv
    return lambda x, w, b, a: kernel(x, w, b, a, None, True)


def jax_temporal(layout, stride):
    if layout == "vntc":
        return lambda x, w, b: jax_temporal_conv_vm(x, w, b, stride, None,
                                                    True)
    return lambda x, w, b: jax_temporal_conv(x, w, b, stride, None, None,
                                             True)


def spatial_oracle64(layout):
    """The graph conv in float64 ``jax.numpy``, for autograd."""
    def fn(x, w, b, a):
        xm = x if layout == "vntc" else x.reshape(-1, V, x.shape[-1])
        eq = "wmi,iko->kwmo" if layout == "vntc" else "mwi,iko->kmwo"
        y = jnp.einsum(eq, xm, w) + (b[:, None, None, :])
        if layout == "vntc":
            return jnp.einsum("kvw,kwmo->vmo", a, y)
        z = jnp.einsum("kvw,kmwo->mvo", a, y)
        return z.reshape(*x.shape[:-1], -1)
    return fn


def temporal_oracle64(layout, stride):
    """The temporal conv in float64 ``jax.numpy``, for autograd."""
    def fn(x, w, b):
        pad = (GAMMA - 1) // 2
        xp = jnp.pad(x, [(0, 0), (pad, pad)] + [(0, 0)] * (x.ndim - 2))
        t_out = t_out_of(x.shape[1], stride)
        out = 0.0
        for g in range(GAMMA):
            tap = xp[:, g:g + stride * (t_out - 1) + 1:stride]
            out = out + tap @ w[g]
        return out + b
    return fn


class TestSpatialConvAgainstPallas:
    # (c_in, c_out, need_da)
    CASES = [(8, 16, True), (8, 16, False), (2, 16, True)]

    @pytest.mark.parametrize("layout", LAYOUTS)
    @pytest.mark.parametrize("c_in,c_out,need_da", CASES)
    def test_values_and_vjp(self, rng, adjacency, layout, c_in, c_out,
                            need_da):
        d = spatial_inputs(rng, layout, c_in, c_out, adjacency)
        g = rng.normal(0, 1, d["x"].shape[:-1] + (c_out,)).astype(np.float32)
        z_jax, vjp = jax.vjp(jax_spatial(layout),
                             *[jnp.asarray(d[k]) for k in SPATIAL_ARGS])
        grads_jax = vjp(jnp.asarray(g))

        vmajor = layout == "vntc"
        ins = [tensor(d[k]) for k in SPATIAL_ARGS]
        z = sc.spatial_conv_forward_reference(*ins, vmajor=vmajor)
        close(z, z_jax, what="z")
        grads = sc.spatial_conv_backward_reference(
            ins[0], tensor(g), *ins[1:], vmajor=vmajor, need_da=need_da)
        for name, got, want in zip(SPATIAL_ARGS, grads, grads_jax):
            if name == "a" and not need_da:
                assert float(got.abs().max()) == 0.0
                continue
            close(got, want, what="d" + name)

    @pytest.mark.parametrize("layout", LAYOUTS)
    def test_bf16_against_the_pallas_kernel(self, rng, adjacency, layout):
        d = spatial_inputs(rng, layout, 8, 16, adjacency)
        bf = {k: v.astype(ml_dtypes.bfloat16) for k, v in d.items()}
        g = rng.normal(0, 1, d["x"].shape[:-1] + (16,)).astype(
            ml_dtypes.bfloat16)
        z_jax, vjp = jax.vjp(jax_spatial(layout),
                             *[jnp.asarray(bf[k]) for k in SPATIAL_ARGS])
        grads_jax = vjp(jnp.asarray(g))
        ins = [tensor(bf[k], torch.bfloat16) for k in SPATIAL_ARGS]
        vmajor = layout == "vntc"
        z = sc.spatial_conv_forward_reference(*ins, vmajor=vmajor)
        assert z.dtype == torch.bfloat16
        close(z.float(), np.asarray(z_jax, np.float32), BF16, BF16, "z")
        grads = sc.spatial_conv_backward_reference(
            ins[0], tensor(g, torch.bfloat16), *ins[1:], vmajor=vmajor)
        for name, got, want in zip(SPATIAL_ARGS, grads, grads_jax):
            close(got.float(), np.asarray(want, np.float32), BF16, BF16,
                  "d" + name)

    @pytest.mark.parametrize("layout", LAYOUTS)
    def test_float64_against_jax_autodiff(self, rng, adjacency, layout):
        d = {k: v.astype(np.float64) for k, v in spatial_inputs(
            rng, layout, 8, 16, adjacency).items()}
        g = rng.normal(0, 1, d["x"].shape[:-1] + (16,))
        z_jax, vjp = jax.vjp(spatial_oracle64(layout),
                             *[jnp.asarray(d[k]) for k in SPATIAL_ARGS])
        grads_jax = vjp(jnp.asarray(g))
        ins = [torch.from_numpy(d[k]) for k in SPATIAL_ARGS]
        vmajor = layout == "vntc"
        z = sc.spatial_conv_forward_reference(*ins, vmajor=vmajor)
        np.testing.assert_allclose(z.numpy(), np.asarray(z_jax), rtol=1e-10,
                                   atol=1e-12)
        grads = sc.spatial_conv_backward_reference(
            ins[0], torch.from_numpy(g), *ins[1:], vmajor=vmajor)
        for got, want in zip(grads, grads_jax):
            assert got.dtype == torch.float64
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=1e-10, atol=1e-10)

    @pytest.mark.parametrize("layout", LAYOUTS)
    @pytest.mark.parametrize("trained_graph", [True, False])
    def test_autograd_op_runs_the_plain_versions(self, rng, adjacency,
                                                 layout, trained_graph):
        d = spatial_inputs(rng, layout, 8, 16, adjacency)
        g = tensor(rng.normal(0, 1, d["x"].shape[:-1] + (16,)))
        ins = [tensor(d[k]).requires_grad_(k != "a" or trained_graph)
               for k in SPATIAL_ARGS]
        before = (sc.spatial_conv_forward.launches,
                  sc.spatial_conv_backward.launches)
        op = (sc.spatial_conv_fused_vm if layout == "vntc"
              else sc.spatial_conv_fused)
        z = op(*ins)
        wanted = [p for p in ins if p.requires_grad]
        grads = torch.autograd.grad(z, wanted, g)
        assert (sc.spatial_conv_forward.launches,
                sc.spatial_conv_backward.launches) == before
        plain = sc.spatial_conv_backward_reference(
            ins[0].detach(), g, *[p.detach() for p in ins[1:]],
            vmajor=layout == "vntc")
        for got, want in zip(grads, plain):
            assert torch.equal(got, want)


class TestTemporalConvAgainstPallas:
    # (c_in, c_out, stride, frames): odd frame counts leave input frames at
    # the end of T that no output tap of a stride-2 conv reaches
    CASES = [(8, 8, 1, 16), (8, 16, 1, 16), (16, 16, 2, 17), (8, 16, 2, 16)]

    @pytest.mark.parametrize("layout", LAYOUTS)
    @pytest.mark.parametrize("c_in,c_out,stride,t", CASES)
    def test_values_and_vjp(self, rng, layout, c_in, c_out, stride, t):
        d = temporal_inputs(rng, layout, c_in, c_out, t)
        g = rng.normal(0, 1, temporal_out_shape(
            layout, d["x"].shape, c_out, stride)).astype(np.float32)
        u_jax, vjp = jax.vjp(jax_temporal(layout, stride),
                             *[jnp.asarray(d[k]) for k in TEMPORAL_ARGS])
        grads_jax = vjp(jnp.asarray(g))

        vmajor = layout == "vntc"
        ins = [tensor(d[k]) for k in TEMPORAL_ARGS]
        u = tc.temporal_conv_forward_reference(*ins, stride=stride,
                                               vmajor=vmajor)
        close(u, u_jax, what="u")
        grads = tc.temporal_conv_backward_reference(
            ins[0], tensor(g), *ins[1:], stride=stride, vmajor=vmajor)
        for name, got, want in zip(TEMPORAL_ARGS, grads, grads_jax):
            close(got, want, what="d" + name)

    @pytest.mark.parametrize("layout", LAYOUTS)
    @pytest.mark.parametrize("stride", [1, 2])
    def test_bf16_against_the_pallas_kernel(self, rng, layout, stride):
        d = temporal_inputs(rng, layout, 16, 16)
        bf = {k: v.astype(ml_dtypes.bfloat16) for k, v in d.items()}
        g = rng.normal(0, 1, temporal_out_shape(
            layout, d["x"].shape, 16, stride)).astype(ml_dtypes.bfloat16)
        u_jax, vjp = jax.vjp(jax_temporal(layout, stride),
                             *[jnp.asarray(bf[k]) for k in TEMPORAL_ARGS])
        grads_jax = vjp(jnp.asarray(g))
        vmajor = layout == "vntc"
        ins = [tensor(bf[k], torch.bfloat16) for k in TEMPORAL_ARGS]
        u = tc.temporal_conv_forward_reference(*ins, stride=stride,
                                               vmajor=vmajor)
        assert u.dtype == torch.bfloat16
        close(u.float(), np.asarray(u_jax, np.float32), BF16, BF16, "u")
        grads = tc.temporal_conv_backward_reference(
            ins[0], tensor(g, torch.bfloat16), *ins[1:], stride=stride,
            vmajor=vmajor)
        for name, got, want in zip(TEMPORAL_ARGS, grads, grads_jax):
            close(got.float(), np.asarray(want, np.float32), BF16, BF16,
                  "d" + name)

    def test_bias_stays_in_its_dtype(self, rng):
        """bf16 activations and taps with a float32 bias: the bias is added
        in float32 before the one rounding, as ``temporal_conv_fused``
        adds it."""
        d = temporal_inputs(rng, "ntvc", 8, 8)
        x = tensor(d["x"], torch.bfloat16)
        w = tensor(d["w"], torch.bfloat16)
        b = tensor(d["b"]) + 1e-3           # not a bf16 value
        want = jax_temporal("ntvc", 1)(jnp.asarray(np.asarray(x.float()),
                                                   jnp.bfloat16),
                                       jnp.asarray(np.asarray(w.float()),
                                                   jnp.bfloat16),
                                       jnp.asarray(b.numpy()))
        got = tc.temporal_conv_forward_reference(x, w, b, stride=1,
                                                 vmajor=False)
        close(got.float(), np.asarray(want, np.float32), BF16, BF16)
        _, _, db = tc.temporal_conv_backward_reference(
            x, torch.ones_like(got), w, b, stride=1, vmajor=False)
        assert db.dtype == torch.float32

    @pytest.mark.parametrize("layout", LAYOUTS)
    @pytest.mark.parametrize("stride", [1, 2])
    def test_float64_against_jax_autodiff(self, rng, layout, stride):
        d = {k: v.astype(np.float64) for k, v in temporal_inputs(
            rng, layout, 8, 16, 17).items()}
        g = rng.normal(0, 1, temporal_out_shape(layout, d["x"].shape, 16,
                                                stride))
        u_jax, vjp = jax.vjp(temporal_oracle64(layout, stride),
                             *[jnp.asarray(d[k]) for k in TEMPORAL_ARGS])
        grads_jax = vjp(jnp.asarray(g))
        ins = [torch.from_numpy(d[k]) for k in TEMPORAL_ARGS]
        vmajor = layout == "vntc"
        u = tc.temporal_conv_forward_reference(*ins, stride=stride,
                                               vmajor=vmajor)
        np.testing.assert_allclose(u.numpy(), np.asarray(u_jax), rtol=1e-10,
                                   atol=1e-12)
        grads = tc.temporal_conv_backward_reference(
            ins[0], torch.from_numpy(g), *ins[1:], stride=stride,
            vmajor=vmajor)
        for got, want in zip(grads, grads_jax):
            assert got.dtype == torch.float64
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=1e-10, atol=1e-10)

    @pytest.mark.parametrize("layout", LAYOUTS)
    def test_autograd_op_runs_the_plain_versions(self, rng, layout):
        d = temporal_inputs(rng, layout, 8, 16)
        ins = [tensor(d[k]).requires_grad_() for k in TEMPORAL_ARGS]
        g = tensor(rng.normal(0, 1, temporal_out_shape(
            layout, d["x"].shape, 16, 2)))
        before = (tc.temporal_conv_forward.launches,
                  tc.temporal_conv_backward.launches)
        op = (tc.temporal_conv_fused_vm if layout == "vntc"
              else tc.temporal_conv_fused)
        u = op(*ins, 2)
        grads = torch.autograd.grad(u, ins, g)
        assert (tc.temporal_conv_forward.launches,
                tc.temporal_conv_backward.launches) == before
        plain = tc.temporal_conv_backward_reference(
            ins[0].detach(), g, *[p.detach() for p in ins[1:]], stride=2,
            vmajor=layout == "vntc")
        for got, want in zip(grads, plain):
            assert torch.equal(got, want)


class TestLaunch:
    """The CUDA side, without a compiler or a card."""

    ENTRY = {"spatial_conv_fwd_launch": "spatial_block.cu",
             "spatial_conv_bwd_launch": "spatial_block.cu",
             "temporal_conv_fwd_launch": "temporal_block.cu",
             "temporal_conv_bwd_launch": "temporal_block.cu",
             "temporal_mma_fwd_launch": "temporal_block.cu",
             "temporal_mma_bwd_launch": "temporal_block.cu",
             "spatial_mma_fwd_launch": "spatial_block.cu",
             "spatial_mma_bwd_launch": "spatial_block.cu"}

    @pytest.mark.parametrize("name", sorted(ENTRY))
    def test_c_signature_matches_argtypes(self, name):
        src = (_build.CSRC / self.ENTRY[name]).read_text()
        sig = re.search(r'extern "C" int %s\((.*?)\)\s*\{' % name, src,
                        re.S).group(1)
        kinds = [ctypes.c_void_p if "*" in p else ctypes.c_int
                 for p in sig.split(",")]
        assert kinds == _build.ENTRY_POINTS[name]

    @pytest.fixture()
    def fake_lib(self, monkeypatch):
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
        return calls

    @staticmethod
    def check_call(args, name, null=()):
        """One value per declared argument, of its kind; a pointer is
        null only at the positions ``null`` (unused by that launch)."""
        declared = _build.ENTRY_POINTS[name]
        assert len(args) == len(declared)
        for i, (value, kind) in enumerate(zip(args, declared)):
            if kind is ctypes.c_void_p:
                assert (value is None if i in null
                        else isinstance(value, int) and value)
            else:
                assert isinstance(value, int)
        assert args[-1] == 4321

    @pytest.mark.parametrize("layout", LAYOUTS)
    def test_spatial_launches(self, rng, adjacency, fake_lib, layout):
        vmajor = layout == "vntc"
        d = spatial_inputs(rng, layout, 2, 64, adjacency)
        ins = [tensor(d[k]) for k in SPATIAL_ARGS]
        before = (sc.spatial_conv_forward.launches,
                  sc.spatial_conv_backward.launches)
        z = sc._launch_forward(*ins, vmajor=vmajor)
        g = torch.zeros(*d["x"].shape[:-1], 64)
        grads = sc._launch_backward(ins[0], g, *ins[1:], vmajor=vmajor,
                                    need_da=False)
        assert (sc.spatial_conv_forward.launches,
                sc.spatial_conv_backward.launches) == (before[0] + 1,
                                                       before[1] + 1)
        assert tuple(z.shape) == d["x"].shape[:-1] + (64,)
        for got, p in zip(grads, ins):
            assert got.shape == p.shape and got.dtype == p.dtype
        (fwd,), (bwd,) = (fake_lib["spatial_conv_fwd_launch"],
                          fake_lib["spatial_conv_bwd_launch"])
        self.check_call(fwd, "spatial_conv_fwd_launch")
        self.check_call(bwd, "spatial_conv_bwd_launch")
        frames, fwd_smem, smem = sc.plan_frames(V, 2, 64)
        # ..., V, M, C_in, C_out, K, frames, vmajor, smem
        assert fwd[5:13] == (V, N * T, 2, 64, K, frames, int(vmajor),
                             fwd_smem)
        # ..., V, M, C_in, C_out, K, frames, ctas, vmajor, need_da, smem
        assert bwd[9:19] == (V, N * T, 2, 64, K, frames,
                             min(2 * 132, -(-N * T // frames)), int(vmajor),
                             0, smem)

    @pytest.mark.parametrize("layout", LAYOUTS)
    def test_spatial_bf16_launches(self, rng, adjacency, fake_lib, layout):
        """bf16 runs the warpgroup launchers without the affine, in
        either layout; one count per op call; the plans' values reach the
        launchers in order."""
        vmajor = layout == "vntc"
        d = spatial_inputs(rng, layout, 40, 24, adjacency)
        ins = [tensor(d[k], torch.bfloat16) for k in SPATIAL_ARGS]
        before = (sc.spatial_conv_forward.launches,
                  sc.spatial_conv_backward.launches)
        z = sc._launch_forward(*ins, vmajor=vmajor)
        assert tuple(z.shape) == d["x"].shape[:-1] + (24,)
        assert z.dtype == torch.bfloat16
        g = torch.zeros(*d["x"].shape[:-1], 24, dtype=torch.bfloat16)
        grads = sc._launch_backward(ins[0], g, *ins[1:], vmajor=vmajor,
                                    need_da=True)
        assert (sc.spatial_conv_forward.launches,
                sc.spatial_conv_backward.launches) == (before[0] + 1,
                                                       before[1] + 1)
        for got, p in zip(grads, ins):
            assert got.shape == p.shape and got.dtype == p.dtype
        assert "spatial_conv_fwd_launch" not in fake_lib
        assert "spatial_conv_bwd_launch" not in fake_lib
        (fwd,), (bwd,) = (fake_lib["spatial_mma_fwd_launch"],
                          fake_lib["spatial_mma_bwd_launch"])
        # no affine (s1, t1), no saved y; no h scratch (x's 40-channel rows
        # have 16-byte strides, so the dW kernel reads x); no ds1/dt1 slices
        self.check_call(fwd, "spatial_mma_fwd_launch", null=(1, 2, 7))
        self.check_call(bwd, "spatial_mma_bwd_launch",
                        null=(2, 3, 8, 11, 13))
        plan = sb.plan_spatial_mma_forward(V, 40, 24, K)
        # ..., V, M, C_in, C_out, K, frames, aff, save, relu1, vmajor, kc,
        # stages, smem
        assert fwd[8:21] == (V, N * T, 40, 24, K, plan["frames"], 0, 0, 0,
                             int(vmajor), plan["kc"], plan["stages"],
                             plan["smem"])
        plan = sb.plan_spatial_mma_backward(V, N * T, 40, 24, K, 132,
                                            reads_x=False)
        assert bwd[16:41] == (V, N * T, 40, 24, K, plan["frames"], 0, 0, 0,
                              int(vmajor), 1,
                              *[plan[k] for k in sb.BWD_PLAN_KEYS])

    @pytest.mark.parametrize("layout", LAYOUTS)
    def test_temporal_launches(self, rng, fake_lib, layout):
        vmajor = layout == "vntc"
        d = temporal_inputs(rng, layout, 8, 16, 17)
        ins = [tensor(d[k], torch.bfloat16) for k in TEMPORAL_ARGS]
        before = (tc.temporal_conv_forward.launches,
                  tc.temporal_conv_backward.launches)
        u = tc._launch_forward(*ins, stride=2, vmajor=vmajor)
        out_shape = temporal_out_shape(layout, d["x"].shape, 16, 2)
        assert tuple(u.shape) == out_shape and u.dtype == torch.bfloat16
        grads = tc._launch_backward(ins[0], torch.zeros(out_shape), *ins[1:],
                                    stride=2, vmajor=vmajor)
        assert (tc.temporal_conv_forward.launches,
                tc.temporal_conv_backward.launches) == (before[0] + 1,
                                                        before[1] + 1)
        for got, p in zip(grads, ins):
            assert got.shape == p.shape and got.dtype == p.dtype
        # bf16 runs the tensor-core launchers, without the affine
        assert "temporal_conv_fwd_launch" not in fake_lib
        (fwd,), (bwd,) = (fake_lib["temporal_mma_fwd_launch"],
                          fake_lib["temporal_mma_bwd_launch"])
        self.check_call(fwd, "temporal_mma_fwd_launch", null=(1, 2))
        self.check_call(bwd, "temporal_mma_bwd_launch", null=(2, 3, 7, 8))
        # V-major (R, T, C) runs as V = R joints of one sequence
        v, n = (V * N, 1) if vmajor else (V, N)
        bn, kc, stages, fwd_smem = tb.plan_mma_forward(17, 8, 16, 2, GAMMA)
        # ..., V, N, T, C_in, C_out, gamma, stride, pad, aff, relu2,
        # vmajor, bn, kc, stages, smem
        assert fwd[6:21] == (v, n, 17, 8, 16, GAMMA, 2, 4, 0, 0,
                             int(vmajor), bn, kc, stages, fwd_smem)
        # the dWt kernel fills one CTA an SM (132 on the fake card)
        plan = tb.plan_mma_backward(v * n, 17, 8, 16, 2, GAMMA, False, 132)
        assert bwd[10:30] == (v, n, 17, 8, 16, GAMMA, 2, 4, 0, 0,
                             int(vmajor),
                             plan["bn_dx"], plan["kc_dx"], plan["stages_dx"],
                             plan["tiles_x"], plan["dx_smem"],
                             plan["splits"], plan["split_rows"],
                             plan["dw_stages"], plan["dw_smem"])

    @pytest.mark.parametrize("stride", [1, 2])
    def test_temporal_launches_at_padding_0(self, rng, fake_lib, stride):
        """``padding=0`` (the time halo's valid conv) reaches both
        launchers, with the output ``gamma - 1`` frames shorter before the
        stride, and their planners."""
        d = temporal_inputs(rng, "ntvc", 8, 16, 17)
        ins = [tensor(d[k], torch.bfloat16) for k in TEMPORAL_ARGS]
        u = tc._launch_forward(*ins, stride=stride, vmajor=False, padding=0)
        t_out = (17 - GAMMA) // stride + 1
        assert tuple(u.shape) == (N, t_out, V, 16)
        grads = tc._launch_backward(ins[0], torch.zeros(tuple(u.shape)),
                                    *ins[1:], stride=stride, vmajor=False,
                                    padding=0)
        for got, p in zip(grads, ins):
            assert got.shape == p.shape and got.dtype == p.dtype
        (fwd,), (bwd,) = (fake_lib["temporal_mma_fwd_launch"],
                          fake_lib["temporal_mma_bwd_launch"])
        bn, kc, stages, fwd_smem = tb.plan_mma_forward(17, 8, 16, stride,
                                                       GAMMA, 0)
        assert fwd[6:21] == (V, N, 17, 8, 16, GAMMA, stride, 0, 0, 0, 0, bn,
                             kc, stages, fwd_smem)
        plan = tb.plan_mma_backward(V * N, 17, 8, 16, stride, GAMMA, False,
                                    132, 0)
        assert bwd[10:21] == (V, N, 17, 8, 16, GAMMA, stride, 0, 0, 0, 0)
        assert bwd[21:30] == tuple(plan[k] for k in (
            "bn_dx", "kc_dx", "stages_dx", "tiles_x", "dx_smem", "splits",
            "split_rows", "dw_stages", "dw_smem"))
        with pytest.raises(ValueError, match="padding"):
            tc._launch_forward(*ins, stride=1, vmajor=False, padding=5)

    def test_rejects_other_dtypes_and_shapes_on_the_cuda_path(self, rng,
                                                             fake_lib):
        d = temporal_inputs(rng, "ntvc", 8, 8)
        ins = [torch.from_numpy(d[k].astype(np.float64))
               for k in TEMPORAL_ARGS]
        with pytest.raises(TypeError, match="float32 or bfloat16"):
            tc._launch_forward(*ins, stride=1, vmajor=False)
        with pytest.raises(ValueError, match="x must be"):
            tc._launch_forward(tensor(d["x"]), tensor(d["w"]),
                               tensor(d["b"]), stride=1, vmajor=True)
        with pytest.raises(ValueError, match="x must be"):
            sc._launch_forward(tensor(d["x"]), torch.zeros(8, K, 8),
                               torch.zeros(K, 8), torch.zeros(K, V, V),
                               vmajor=True)

    # DEFAULT_PLAN's ten blocks: (c_in, c_out, stride)
    SHAPES = [(2, 64, 1), (64, 64, 1), (64, 128, 2), (128, 128, 1),
              (128, 256, 2), (256, 256, 1)]

    @pytest.mark.parametrize("c_in,c_out,stride", SHAPES)
    @pytest.mark.parametrize("rows", [V, V * 64])
    def test_tiles_fit_shared_memory(self, c_in, c_out, stride, rows):
        """Both layouts' temporal plans (V joints, or R = V*N rows of the
        V-major op) fit in shared memory and keep at most 32 rows."""
        tt, vg, smem = tc.plan_forward(rows, c_out, stride, GAMMA)
        assert smem == 4 * ((tt - 1) * stride + GAMMA) * vg * c_out
        assert smem <= SMEM_LIMIT and 1 <= vg <= min(rows, 32)
        ft, vg, smem = tc.plan_backward(rows, c_out, c_out, GAMMA)
        assert smem == 4 * (ft * c_out + (ft + GAMMA - 1) * c_out) * vg
        assert smem <= SMEM_LIMIT and 1 <= vg <= min(rows, 32)
        frames, fwd, bwd = sc.plan_frames(V, c_in, c_out)
        assert fwd <= bwd <= SMEM_LIMIT
