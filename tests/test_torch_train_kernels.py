"""The train path's spatial and temporal ops, held against the JAX package.

The plain PyTorch versions of the port's kernels (``spatial_block`` and
``temporal_block``: values and VJPs) are compared with the four Pallas
kernels they replace, run in interpret mode on the CPU as the JAX package's
own tests run them: ``spatial_block_vm``, ``spatial_block_packed``,
``temporal_block_vm`` and ``temporal_block_packed``.  Inputs are drawn with
numpy and handed to both packages.

Tolerances: float32 values and gradients at rtol 1e-4 with an absolute
floor of 1e-4 of the compared tensor's largest magnitude (the packages sum
in other orders, and weight gradients sum ~10^4 terms).  The Pallas kernels
compute in float32 whatever their inputs, so the float64 checks hold the
plain versions against autograd of a float64 ``jax.numpy`` oracle instead,
at rtol 1e-10.

The CUDA side cannot run here: the ``ctypes`` declarations are held against
the C signatures read from the sources, and each launch function runs
against a fake library.
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
from stgcn_tpu.kernels.block_fused import spatial_block_vm, temporal_block_vm
from stgcn_tpu.kernels.block_packed import (
    spatial_block_packed,
    temporal_block_packed,
)
from stgcn_tpu_torch.kernels import _build
from stgcn_tpu_torch.kernels import spatial_block as sb
from stgcn_tpu_torch.kernels import temporal_block as tb

V, N, T, K, GAMMA = 25, 2, 16, 2, 9
RTOL = 1e-4


def close(got, want, rtol=RTOL, rel_atol=1e-4, what=""):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    atol = rel_atol * max(float(np.abs(want).max(initial=0.0)), 1e-30)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol, err_msg=what)


def t32(a):
    return torch.from_numpy(np.asarray(a, np.float32))


@pytest.fixture(scope="module")
def adjacency():
    return get_normalized_adjacency(Strategy.DISTANCE, 1).astype(np.float32)


def spatial_inputs(rng, c_in, c_out, adjacency, t=T):
    f = np.float32
    return dict(
        x=rng.normal(0, 1, (V, N, t, c_in)).astype(f),
        s1=rng.normal(1, 0.2, c_in).astype(f),
        t1=rng.normal(0, 0.2, c_in).astype(f),
        w=rng.normal(0, c_in ** -0.5, (c_in, K, c_out)).astype(f),
        b=rng.normal(0, 0.3, (K, c_out)).astype(f),
        # a mask-mode adjacency: the fixed one times a jittered mask
        a=adjacency * rng.uniform(0.5, 1.5, adjacency.shape).astype(f))


def temporal_inputs(rng, c, t=T):
    f = np.float32
    return dict(
        z=rng.normal(0, 1, (V, N, t, c)).astype(f),
        s2=rng.normal(1, 0.2, c).astype(f),
        t2=rng.normal(0, 0.2, c).astype(f),
        wt=rng.normal(0, (GAMMA * c) ** -0.5, (GAMMA, c, c)).astype(f),
        bt=rng.normal(0, 0.3, c).astype(f))


SPATIAL_ARGS = ("x", "s1", "t1", "w", "b", "a")
TEMPORAL_ARGS = ("z", "s2", "t2", "wt", "bt")


class TestSpatialAgainstPallas:
    # (kernel, c_in, c_out, relu1, need_da)
    CASES = [("vm", 8, 16, True, True), ("vm", 8, 16, False, True),
             ("vm", 8, 16, True, False), ("vm", 2, 16, False, True),
             ("packed", 2, 64, True, True), ("packed", 8, 64, True, False),
             ("packed", 8, 64, False, True)]

    @pytest.mark.parametrize("kind,c_in,c_out,relu1,need_da", CASES)
    def test_values_and_vjp(self, rng, adjacency, kind, c_in, c_out, relu1,
                            need_da):
        d = spatial_inputs(rng, c_in, c_out, adjacency)
        g = rng.normal(0, 1, (V, N, T, c_out)).astype(np.float32)
        kernel = spatial_block_vm if kind == "vm" else spatial_block_packed

        def jax_fn(*args):
            return kernel(*args, relu1, True, None, need_da)[..., :c_out]

        z_jax, vjp = jax.vjp(jax_fn, *[jnp.asarray(d[k])
                                       for k in SPATIAL_ARGS])
        grads_jax = vjp(jnp.asarray(g))

        ins = [t32(d[k]) for k in SPATIAL_ARGS]
        z = sb.spatial_block_forward_reference(*ins, relu1=relu1)
        close(z, z_jax, what="z")
        grads = sb.spatial_block_backward_reference(
            ins[0], t32(g), *ins[1:], relu1=relu1, need_da=need_da)
        for name, got, want in zip(SPATIAL_ARGS, grads, grads_jax):
            close(got, want, what="d" + name)
        if not need_da:
            assert float(grads[5].abs().max()) == 0.0

    @pytest.mark.parametrize("relu1", [True, False])
    def test_autograd_op_runs_the_plain_versions(self, rng, adjacency,
                                                 relu1):
        d = spatial_inputs(rng, 8, 16, adjacency)
        g = t32(rng.normal(0, 1, (V, N, T, 16)))
        ins = [t32(d[k]).requires_grad_() for k in SPATIAL_ARGS]
        before = (sb.spatial_block_forward.launches,
                  sb.spatial_block_backward.launches)
        z = sb.spatial_block(*ins, relu1=relu1)
        grads = torch.autograd.grad(z, ins, g)
        assert (sb.spatial_block_forward.launches,
                sb.spatial_block_backward.launches) == before
        plain = sb.spatial_block_backward_reference(
            *[p.detach() for p in ins[:1]], g,
            *[p.detach() for p in ins[1:]], relu1=relu1)
        for got, want in zip(grads, plain):
            assert torch.equal(got, want)

    @pytest.mark.parametrize("relu1", [True, False])
    def test_float64_against_jax_autodiff(self, rng, adjacency, relu1):
        d = {k: v.astype(np.float64)
             for k, v in spatial_inputs(rng, 3, 5, adjacency, t=6).items()}
        g = rng.normal(0, 1, (V, N, 6, 5))

        def oracle(x, s1, t1, w, b, a):
            h = x * s1 + t1
            if relu1:
                h = jax.nn.relu(h)
            y = jnp.einsum("wnti,iko->kwnto", h, w) + b[:, None, None, None]
            return jnp.einsum("kvw,kwnto->vnto", a, y)

        z_jax, vjp = jax.vjp(oracle, *[jnp.asarray(d[k])
                                       for k in SPATIAL_ARGS])
        ins = [torch.from_numpy(d[k]) for k in SPATIAL_ARGS]
        close(sb.spatial_block_forward_reference(*ins, relu1=relu1), z_jax,
              rtol=1e-10, rel_atol=1e-12)
        grads = sb.spatial_block_backward_reference(
            ins[0], torch.from_numpy(g), *ins[1:], relu1=relu1)
        for name, got, want in zip(SPATIAL_ARGS, grads,
                                   vjp(jnp.asarray(g))):
            close(got, want, rtol=1e-10, rel_atol=1e-12, what="d" + name)


class TestTemporalAgainstPallas:
    # (kernel, c, stride, relu2)
    CASES = [("vm", 16, 1, True), ("vm", 16, 2, True), ("vm", 16, 2, False),
             ("vm", 16, 1, False), ("packed", 64, 1, True),
             ("packed", 64, 1, False)]

    @pytest.mark.parametrize("kind,c,stride,relu2", CASES)
    def test_values_and_vjp(self, rng, kind, c, stride, relu2):
        d = temporal_inputs(rng, c)
        t_out = (T - 1) // stride + 1
        g = rng.normal(0, 1, (V, N, t_out, c)).astype(np.float32)

        def jax_fn(z, s2, t2, wt, bt):
            if kind == "packed":
                return temporal_block_packed(z, s2, t2, wt, bt, relu2, True)
            zp = jnp.pad(z, [(0, 0), (0, 0), (0, 0), (0, 128 - c)])
            return temporal_block_vm(zp, s2, t2, wt, bt, stride, relu2, True)

        u_jax, vjp = jax.vjp(jax_fn, *[jnp.asarray(d[k])
                                       for k in TEMPORAL_ARGS])
        grads_jax = vjp(jnp.asarray(g))

        ins = [t32(d[k]) for k in TEMPORAL_ARGS]
        u = tb.temporal_block_forward_reference(*ins, stride=stride,
                                                relu2=relu2)
        assert tuple(u.shape) == (V, N, t_out, c)
        close(u, u_jax, what="u")
        grads = tb.temporal_block_backward_reference(
            ins[0], t32(g), *ins[1:], stride=stride, relu2=relu2)
        for name, got, want in zip(TEMPORAL_ARGS, grads, grads_jax):
            close(got, want, what="d" + name)

    @pytest.mark.parametrize("stride,relu2", [(1, True), (2, False)])
    def test_float64_against_jax_autodiff(self, rng, stride, relu2):
        d = {k: v.astype(np.float64)
             for k, v in temporal_inputs(rng, 4, t=11).items()}
        t_out = (11 - 1) // stride + 1
        g = rng.normal(0, 1, (V, N, t_out, 4))

        def oracle(z, s2, t2, wt, bt):
            h = z * s2 + t2
            if relu2:
                h = jax.nn.relu(h)
            hp = jnp.pad(h, [(0, 0), (0, 0), (4, 4), (0, 0)])
            out = bt
            for k in range(GAMMA):
                tap = hp[:, :, k:k + stride * (t_out - 1) + 1:stride]
                out = out + jnp.einsum("vnti,io->vnto", tap, wt[k])
            return out

        u_jax, vjp = jax.vjp(oracle, *[jnp.asarray(d[k])
                                       for k in TEMPORAL_ARGS])
        ins = [torch.from_numpy(d[k]) for k in TEMPORAL_ARGS]
        close(tb.temporal_block_forward_reference(*ins, stride=stride,
                                                  relu2=relu2),
              u_jax, rtol=1e-10, rel_atol=1e-12)
        grads = tb.temporal_block_backward_reference(
            ins[0], torch.from_numpy(g), *ins[1:], stride=stride,
            relu2=relu2)
        for name, got, want in zip(TEMPORAL_ARGS, grads,
                                   vjp(jnp.asarray(g))):
            close(got, want, rtol=1e-10, rel_atol=1e-12, what="d" + name)

    def test_autograd_op_runs_the_plain_versions(self, rng):
        d = temporal_inputs(rng, 8)
        ins = [t32(d[k]).requires_grad_() for k in TEMPORAL_ARGS]
        before = (tb.temporal_block_forward.launches,
                  tb.temporal_block_backward.launches)
        u = tb.temporal_block(*ins, stride=2, relu2=True)
        g = torch.randn_like(u)
        grads = torch.autograd.grad(u, ins, g)
        assert (tb.temporal_block_forward.launches,
                tb.temporal_block_backward.launches) == before
        plain = tb.temporal_block_backward_reference(
            ins[0].detach(), g, *[p.detach() for p in ins[1:]], stride=2,
            relu2=True)
        for got, want in zip(grads, plain):
            assert torch.equal(got, want)


def test_bf16_rounds_like_the_packed_kernel(rng, adjacency):
    """bfloat16 inputs: the plain versions round h, y_k, z and zh where the
    Pallas kernels do (both sum in float32), so they agree to a bf16 ulp."""
    import ml_dtypes

    d = spatial_inputs(rng, 8, 64, adjacency)
    bf = {k: d[k].astype(ml_dtypes.bfloat16) if k in ("x", "w", "b", "a")
          else d[k] for k in SPATIAL_ARGS}
    want = np.asarray(spatial_block_packed(
        *[jnp.asarray(bf[k]) for k in SPATIAL_ARGS], True, True),
        np.float32)
    ins = [torch.from_numpy(np.asarray(bf[k], np.float32)).to(torch.bfloat16)
           if k in ("x", "w", "b", "a") else t32(bf[k])
           for k in SPATIAL_ARGS]
    got = sb.spatial_block_forward_reference(*ins, relu1=True).float()
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=2 ** -7, atol=1e-2)


class TestLaunch:
    """The CUDA side, without a compiler or a card."""

    ENTRY = {"spatial_block_fwd_launch": "spatial_block.cu",
             "spatial_block_bwd_launch": "spatial_block.cu",
             "temporal_block_fwd_launch": "temporal_block.cu",
             "temporal_block_bwd_launch": "temporal_block.cu",
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

    def test_sources_and_library_name(self):
        names = {p.name for p in _build.sources()}
        assert {"block_eval.cu", "spatial_block.cu",
                "temporal_block.cu"} <= names
        assert _build.library_path().name.startswith("libstgcn_kernels-")

    @pytest.fixture()
    def fake_lib(self, monkeypatch):
        calls = {}

        class FakeLib:
            def __getattr__(self, name):
                def launch(*args):
                    calls.setdefault(name, []).append(args)
                    return 0
                return launch

        monkeypatch.setattr(_build, "load_library", lambda: FakeLib())

        class FakeStream:
            cuda_stream = 4321

        class FakeProperties:
            multi_processor_count = 132

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

    def test_spatial_launches(self, rng, adjacency, fake_lib):
        d = spatial_inputs(rng, 2, 64, adjacency)
        ins = [t32(d[k]) for k in SPATIAL_ARGS]
        before = (sb.spatial_block_forward.launches,
                  sb.spatial_block_backward.launches)
        z = sb._launch_forward(*ins, relu1=True)
        grads = sb._launch_backward(ins[0], torch.zeros(V, N, T, 64),
                                    *ins[1:], relu1=True, need_da=False)
        assert (sb.spatial_block_forward.launches,
                sb.spatial_block_backward.launches) == (before[0] + 1,
                                                        before[1] + 1)
        assert tuple(z.shape) == (V, N, T, 64)
        for got, p in zip(grads, ins):
            assert got.shape == p.shape and got.dtype == p.dtype
        (fwd,), (bwd,) = (fake_lib["spatial_block_fwd_launch"],
                          fake_lib["spatial_block_bwd_launch"])
        self.check_call(fwd, "spatial_block_fwd_launch")
        self.check_call(bwd, "spatial_block_bwd_launch")
        frames, _, smem = sb.plan_frames(V, 2, 64)
        # ..., V, M, C_in, C_out, K, frames, ctas, relu1, need_da, smem
        assert bwd[11:21] == (V, N * T, 2, 64, K, frames,
                              min(2 * 132, -(-N * T // frames)), 1,
                              0, smem)

    @pytest.mark.parametrize("save", [False, True])
    def test_spatial_bf16_launches(self, rng, adjacency, fake_lib, save):
        """bf16 goes to the warpgroup launchers (the save op's too), one
        count per op call whatever the number of kernels the backward
        launches; the plans' values reach the launchers in order."""
        d = spatial_inputs(rng, 2, 64, adjacency)
        ins = [torch.from_numpy(d[k]).to(torch.bfloat16)
               if k in ("x", "w", "b", "a") else t32(d[k])
               for k in SPATIAL_ARGS]
        fwd_fn, bwd_fn = ((sb.spatial_block_save_forward,
                           sb.spatial_block_save_backward) if save else
                          (sb.spatial_block_forward,
                           sb.spatial_block_backward))
        before = (fwd_fn.launches, bwd_fn.launches)
        g = torch.zeros(V, N, T, 64, dtype=torch.bfloat16)
        if save:
            z, y = sb._launch_save_forward(*ins, relu1=True)
            assert tuple(y.shape) == (K, V, N, T, 64)
            grads = sb._launch_save_backward(ins[0], g, y, *ins[1:4], ins[5],
                                             relu1=True)
        else:
            z = sb._launch_forward(*ins, relu1=True)
            grads = sb._launch_backward(ins[0], g, *ins[1:], relu1=True,
                                        need_da=False)
        assert (fwd_fn.launches, bwd_fn.launches) == (before[0] + 1,
                                                      before[1] + 1)
        assert tuple(z.shape) == (V, N, T, 64) and z.dtype == torch.bfloat16
        for got, p in zip(grads, ins):
            assert got.shape == p.shape and got.dtype == p.dtype
        for scalar in ("spatial_block_fwd_launch", "spatial_block_bwd_launch",
                       "spatial_block_save_fwd_launch",
                       "spatial_block_save_bwd_launch"):
            assert scalar not in fake_lib
        (fwd,), (bwd,) = (fake_lib["spatial_mma_fwd_launch"],
                          fake_lib["spatial_mma_bwd_launch"])
        # the save op writes y and its backward reads it in place of b;
        # with the affine the dx kernel always writes h for the dW kernel
        self.check_call(fwd, "spatial_mma_fwd_launch",
                        null=() if save else (7,))
        self.check_call(bwd, "spatial_mma_bwd_launch",
                        null=(6,) if save else (8,))
        plan = sb.plan_spatial_mma_forward(V, 2, 64, K)
        # ..., V, M, C_in, C_out, K, frames, aff, save, relu1, vmajor, kc,
        # stages, smem
        assert fwd[8:21] == (V, N * T, 2, 64, K, plan["frames"], 1,
                             int(save), 1, 1, plan["kc"], plan["stages"],
                             plan["smem"])
        plan = sb.plan_spatial_mma_backward(V, N * T, 2, 64, K, 132,
                                            save=save, need_da=save)
        # ..., V, M, C_in, C_out, K, frames, aff, save, relu1, vmajor,
        # need_da, then the plan's BWD_PLAN_KEYS
        assert bwd[16:41] == (V, N * T, 2, 64, K, plan["frames"], 1,
                              int(save), 1, 1, 0 if not save else 1,
                              *[plan[k] for k in sb.BWD_PLAN_KEYS])

    def test_temporal_launches(self, rng, fake_lib):
        d = temporal_inputs(rng, 16)
        ins = [t32(d[k]) for k in TEMPORAL_ARGS]
        before = (tb.temporal_block_forward.launches,
                  tb.temporal_block_backward.launches)
        u = tb._launch_forward(*ins, stride=2, relu2=False)
        grads = tb._launch_backward(ins[0], torch.zeros(V, N, 8, 16),
                                    *ins[1:], stride=2, relu2=False)
        assert (tb.temporal_block_forward.launches,
                tb.temporal_block_backward.launches) == (before[0] + 1,
                                                         before[1] + 1)
        assert tuple(u.shape) == (V, N, 8, 16)
        for got, p in zip(grads, ins):
            assert got.shape == p.shape and got.dtype == p.dtype
        self.check_call(fake_lib["temporal_block_fwd_launch"][0],
                        "temporal_block_fwd_launch")
        self.check_call(fake_lib["temporal_block_bwd_launch"][0],
                        "temporal_block_bwd_launch")

    def test_temporal_bf16_launches(self, rng, fake_lib):
        """bf16 goes to the tensor-core launchers, one count per op call
        whatever the number of kernels the backward launches."""
        d = temporal_inputs(rng, 16)
        ins = [torch.from_numpy(d[k]).to(torch.bfloat16)
               if k in ("z", "wt") else t32(d[k]) for k in TEMPORAL_ARGS]
        before = (tb.temporal_block_forward.launches,
                  tb.temporal_block_backward.launches)
        u = tb._launch_forward(*ins, stride=2, relu2=True)
        grads = tb._launch_backward(ins[0], torch.zeros(V, N, 8, 16,
                                                        dtype=torch.bfloat16),
                                    *ins[1:], stride=2, relu2=True)
        assert (tb.temporal_block_forward.launches,
                tb.temporal_block_backward.launches) == (before[0] + 1,
                                                         before[1] + 1)
        assert tuple(u.shape) == (V, N, 8, 16) and u.dtype == torch.bfloat16
        for got, p in zip(grads, ins):
            assert got.shape == p.shape and got.dtype == p.dtype
        assert "temporal_block_fwd_launch" not in fake_lib
        (fwd,), (bwd,) = (fake_lib["temporal_mma_fwd_launch"],
                          fake_lib["temporal_mma_bwd_launch"])
        self.check_call(fwd, "temporal_mma_fwd_launch")
        self.check_call(bwd, "temporal_mma_bwd_launch")
        bn, kc, stages, smem = tb.plan_mma_forward(T, 16, 16, 2, GAMMA)
        # ..., V, N, T, C_in, C_out, gamma, stride, pad, aff, relu2,
        # vmajor, bn, kc, stages, smem
        assert fwd[6:21] == (V, N, T, 16, 16, GAMMA, 2, 4, 1, 1, 1, bn, kc,
                             stages, smem)
        # the dWt kernel fills one CTA an SM (132 on the fake card)
        plan = tb.plan_mma_backward(V * N, T, 16, 16, 2, GAMMA, True, 132)
        assert bwd[10:30] == (V, N, T, 16, 16, GAMMA, 2, 4, 1, 1, 1,
                             plan["bn_dx"], plan["kc_dx"], plan["stages_dx"],
                             plan["tiles_x"], plan["dx_smem"],
                             plan["splits"], plan["split_rows"],
                             plan["dw_stages"], plan["dw_smem"])

    def test_rejects_other_dtypes_on_the_cuda_path(self, rng, fake_lib):
        d = temporal_inputs(rng, 16)
        ins = [torch.from_numpy(d[k].astype(np.float64))
               for k in TEMPORAL_ARGS]
        with pytest.raises(TypeError, match="float32 or bfloat16"):
            tb._launch_forward(*ins, stride=1, relu2=True)

    # the block shapes of DEFAULT_PLAN that the train path runs fused, and
    # the c256 blocks block_impl="fused" also sends: (c_in, c_out, stride)
    SHAPES = [(2, 64, 1), (64, 64, 1), (64, 128, 2), (128, 128, 1),
              (128, 256, 2), (256, 256, 1)]

    @pytest.mark.parametrize("c_in,c_out,stride", SHAPES)
    def test_tiles_fit_shared_memory(self, c_in, c_out, stride):
        frames, fwd, bwd = sb.plan_frames(V, c_in, c_out)
        assert fwd <= bwd <= sb.SMEM_LIMIT
        assert bwd == 4 * frames * V * (2 * c_in + 3 * c_out)
        tt, vg, smem = tb.plan_forward(V, c_out, stride, GAMMA)
        assert smem == 4 * ((tt - 1) * stride + GAMMA) * vg * c_out
        assert smem <= tb.SMEM_LIMIT
        ft, vg, smem = tb.plan_backward(V, c_out, GAMMA)
        assert smem == 4 * (2 * ft + GAMMA - 1) * vg * c_out
        assert smem <= tb.SMEM_LIMIT
        if c_out <= 128:
            assert vg == V     # every joint in one CTA on the main path
