"""The port's block ops and the plain version of its block kernel, held
against the JAX package on the CPU.

Oracles: ``fused_block_vm`` and ``fused_block_packed_eval`` in interpret
mode, and the JAX eval ``block_forward`` (ops path).  Inputs are drawn with
numpy and handed to both packages; BN statistics, masks and biases are
randomised, since fresh inits (mean 0, var 1, mask 1) hide fold and
adjacency bugs.  Tolerance in float32: rtol 1e-4, atol 1e-5 (the two
packages sum in different orders).  Dense-Lambda ("reference" norm mode)
adjacency has O(1e3) entries, so it is compared in float64 only.
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
from stgcn_tpu.kernels.block_fused import fused_block_vm
from stgcn_tpu.kernels.block_packed import fused_block_packed_eval
from stgcn_tpu.ops.block import block_forward as jax_block_forward
from stgcn_tpu.ops.block import init_block
from stgcn_tpu_torch.kernels import _build
from stgcn_tpu_torch.kernels import block_eval as be
from stgcn_tpu_torch.ops import batchnorm as tbn
from stgcn_tpu_torch.ops.block import block_forward, effective_adjacency

RTOL, ATOL = 1e-4, 1e-5
V, K, GAMMA = 25, 2, 9


def to_torch(tree, dtype=None):
    if isinstance(tree, dict):
        return {k: to_torch(v, dtype) for k, v in tree.items()}
    t = torch.from_numpy(np.array(tree))
    return t.to(dtype) if dtype is not None else t


def kernel_args(rng, c_in, c_out, proj):
    """Random ``fused_block_vm``-style arguments as numpy float32, with
    weights at the scale of torch's default init (1/sqrt(fan_in))."""
    def f(*shape, scale=0.3, loc=0.0):
        return rng.normal(loc, scale, shape).astype(np.float32)
    kw = dict(s1=f(c_in, loc=1.0), t1=f(c_in), w=f(c_in, K, c_out,
                                                   scale=c_in ** -0.5),
              b=f(K, c_out), a=f(K, V, V),
              wt=f(GAMMA, c_out, c_out, scale=(GAMMA * c_out) ** -0.5),
              bt=f(c_out), s2=f(c_out, loc=1.0), t2=f(c_out))
    if proj:
        kw.update(wr=f(c_in, c_out, scale=c_in ** -0.5), br=f(c_out))
    return kw


def port_block(x, kw, **flags):
    lengths = flags.pop("lengths", None)
    return be.block_eval_reference(
        torch.from_numpy(x), **to_torch(kw), **flags,
        lengths=None if lengths is None else torch.from_numpy(lengths))


# (c_in, c_out, stride, order, shortcut, relu1, masked)
VM_CASES = [
    (2, 8, 1, "post", "none", False, False),
    (8, 16, 2, "post", "none", False, False),
    (8, 8, 1, "pre", "id", True, False),
    (8, 16, 2, "pre", "proj", True, False),
    (8, 8, 1, "pre", "none", True, False),
    (8, 16, 1, "post", "proj", False, False),
    (8, 8, 1, "pre", "id", True, True),
    (8, 16, 2, "pre", "proj", True, True),
    (8, 16, 2, "post", "none", False, True),
]


class TestBlockEvalReference:
    @pytest.mark.parametrize("c_in,c_out,stride,order,shortcut,relu1,masked",
                             VM_CASES)
    def test_matches_fused_block_vm(self, rng, c_in, c_out, stride, order,
                                    shortcut, relu1, masked):
        t = 30 if stride == 2 else 32
        kw = kernel_args(rng, c_in, c_out, shortcut == "proj")
        x = rng.normal(0, 1, (V, 2, t, c_in)).astype(np.float32)
        flags = dict(stride=stride, order=order, shortcut=shortcut,
                     relu1=relu1)
        lengths = np.array([t - 11, t], np.int32) if masked else None
        ref = fused_block_vm(jnp.asarray(x),
                             **{k: jnp.asarray(v) for k, v in kw.items()},
                             **flags, lengths=lengths, interpret=True)
        got = port_block(x, kw, **flags, lengths=lengths)
        assert tuple(got.shape) == ref.shape
        if masked:
            # frames past a sequence's final length are unspecified
            for i, n_valid in enumerate((lengths - 1) // stride + 1):
                np.testing.assert_allclose(
                    got[:, i, :n_valid].numpy(),
                    np.asarray(ref)[:, i, :n_valid], rtol=RTOL, atol=ATOL)
        else:
            np.testing.assert_allclose(got.numpy(), np.asarray(ref),
                                       rtol=RTOL, atol=ATOL)

    @pytest.mark.parametrize("c_in,order,shortcut", [
        (2, "pre", "proj"), (64, "pre", "id"), (64, "post", "none")])
    def test_matches_fused_block_packed_eval(self, rng, c_in, order,
                                             shortcut):
        t = 16
        kw = kernel_args(rng, c_in, 64, shortcut == "proj")
        x = rng.normal(0, 1, (V, 2, t, c_in)).astype(np.float32)
        flags = dict(order=order, shortcut=shortcut, relu1=order == "pre")
        ref = fused_block_packed_eval(
            jnp.asarray(x), **{k: jnp.asarray(v) for k, v in kw.items()},
            **flags, interpret=True)
        # packed rows hold two frames each: back to the logical layout
        ref = np.asarray(ref)[:, :, :t // 2].reshape(V, 2, t, 64)
        got = port_block(x, kw, stride=1, **flags)
        np.testing.assert_allclose(got.numpy(), ref, rtol=RTOL, atol=ATOL)

    def test_wrapper_runs_plain_version_on_cpu(self, rng):
        kw = kernel_args(rng, 8, 16, True)
        x = rng.normal(0, 1, (V, 2, 20, 8)).astype(np.float32)
        flags = dict(stride=2, order="pre", shortcut="proj", relu1=True)
        before = be.block_eval.launches
        got = be.block_eval(torch.from_numpy(x), **to_torch(kw), **flags)
        assert be.block_eval.launches == before  # no kernel launched
        np.testing.assert_array_equal(got.numpy(),
                                      port_block(x, kw, **flags).numpy())

    def test_bf16_rounds_like_jax(self, rng):
        """bf16 activations: the plain version rounds at the kernel's
        points, so it stays within a few bf16 ulps of the TPU kernel run in
        interpret mode (sums are taken in other orders)."""
        kw = kernel_args(rng, 8, 8, False)
        x = rng.normal(0, 1, (V, 2, 16, 8)).astype(np.float32)
        flags = dict(stride=1, order="pre", shortcut="id", relu1=True)
        ref = fused_block_vm(jnp.asarray(x, jnp.bfloat16),
                             **{k: jnp.asarray(v) for k, v in kw.items()},
                             **flags, interpret=True)
        got = be.block_eval_reference(
            torch.from_numpy(x).to(torch.bfloat16), **to_torch(kw), **flags)
        assert got.dtype == torch.bfloat16
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(ref, np.float32),
                                   rtol=2e-2, atol=2e-2)

    @pytest.mark.parametrize("bad,match", [
        (dict(order="mid"), "order"),
        (dict(shortcut="id", stride=2), "identity"),
        (dict(shortcut="proj"), "wr"),
        (dict(shortcut="skip"), "shortcut"),
    ])
    def test_rejects_bad_flags(self, rng, bad, match):
        kw = kernel_args(rng, 8, 16, False)
        x = torch.zeros(V, 2, 16, 8)
        flags = dict(stride=1, order="post", shortcut="none", relu1=False)
        with pytest.raises(ValueError, match=match):
            be.block_eval(x, **to_torch(kw), **{**flags, **bad})


class TestKernelLaunchPlan:
    # the six block shapes of DEFAULT_PLAN: (c_in, c_out, stride)
    SHAPES = [(2, 64, 1), (64, 64, 1), (64, 128, 2), (128, 128, 1),
              (128, 256, 2), (256, 256, 1)]

    @pytest.mark.parametrize("itemsize", [2, 4])
    @pytest.mark.parametrize("c_in,c_out,stride", SHAPES)
    def test_tiles_fit_shared_memory(self, c_in, c_out, stride, itemsize):
        t = 304 if c_out == 64 or (c_out == 128 and stride == 2) else 76
        if itemsize == 2:
            # the warpgroup kernels: the spatial kernel (ring, constants,
            # adjacencies, h, y_k of a slab per partition), the taps and the
            # projection pass (ring, row offsets, constants, staged rows)
            plan = be.plan_mma(V, t, c_in, c_out, K, stride, GAMMA)
            assert plan["s_smem"] == be.spatial_smem(
                c_in, c_out, K, plan["s_kc"], plan["s_stages"])
            assert plan["frames"] * V <= be.GEMM_ROWS
            assert plan["bn"] >= c_out and plan["bn"] in be.N_TILES
            for key in ("s", "t", "p"):
                assert plan[f"{key}_smem"] <= be.SMEM_LIMIT
            for key in ("t", "p"):
                assert (plan[f"{key}_kc"], plan[f"{key}_stages"]) in be.RINGS
            # the spatial ring: W resident (a stage a chunk) or of RINGS
            assert (plan["s_kc"] == 64
                    and plan["s_stages"] <= be.MAX_RESIDENT) or (
                plan["s_kc"], plan["s_stages"]) in be.RINGS
        else:
            tt, vg, smem = be.plan_tiles(V, c_in, c_out, stride, GAMMA)
            tf = (tt - 1) * stride + GAMMA
            assert smem == itemsize * (tf * vg * c_out + V * c_in
                                       + V * c_out)
            assert smem <= be.SMEM_LIMIT
            rg = be.THREADS // c_out
            assert -(-V // rg) <= be.MAX_ROWS

    def test_rejects_too_wide(self):
        with pytest.raises(ValueError, match="C_out"):
            be.plan_tiles(V, 256, 512, 1, GAMMA)
        with pytest.raises(ValueError, match="C_out"):
            be.plan_mma(V, 20, 256, 512, K, 1, GAMMA)

    def test_c_signature_matches_argtypes(self):
        """No compiler runs here, so hold the ctypes declarations against
        the launchers' C signatures (float32 and bf16) by reading the
        source."""
        src = (_build.CSRC / "block_eval.cu").read_text()
        for name, argtypes in (("block_eval_launch",
                                _build.BLOCK_EVAL_ARGTYPES),
                               ("block_eval_mma_launch",
                                _build.BLOCK_EVAL_MMA_ARGTYPES)):
            sig = re.search(rf'extern "C" int {name}\((.*?)\)\s*\{{', src,
                            re.S).group(1)
            kinds = [ctypes.c_void_p if "*" in p else ctypes.c_int
                     for p in sig.split(",")]
            assert kinds == argtypes
            assert _build.ENTRY_POINTS[name] is argtypes

    @pytest.mark.parametrize("dtype,entry", [
        (torch.float32, "block_eval_launch"),
        (torch.bfloat16, "block_eval_mma_launch")])
    def test_launch_passes_declared_arguments(self, rng, monkeypatch, dtype,
                                              entry):
        """The CUDA launch path, with the library and stream faked: the
        wrapper passes one value per declared argument, of its kind, to
        the dtype's launcher, and counts the launch."""
        calls = []

        class FakeLib:
            def block_eval_launch(self, *args):
                calls.append(("block_eval_launch", args))
                return 0

            def block_eval_mma_launch(self, *args):
                calls.append(("block_eval_mma_launch", args))
                return 0

        monkeypatch.setattr(_build, "load_library", lambda: FakeLib())

        class FakeStream:
            cuda_stream = 1234

        monkeypatch.setattr(torch.cuda, "current_stream",
                            lambda dev=None: FakeStream())
        monkeypatch.setattr(torch.cuda, "device",
                            lambda dev: contextlib.nullcontext())
        kw = to_torch(kernel_args(rng, 8, 16, True))
        x = torch.zeros(V, 2, 20, 8, dtype=dtype)
        before = be.block_eval.launches
        out = be._launch(x, **kw, stride=2, order="pre", shortcut="proj",
                         relu1=True, final_relu=True,
                         lengths=torch.tensor([20, 7]))
        assert be.block_eval.launches == before + 1
        assert tuple(out.shape) == (V, 2, 10, 16) and out.dtype == dtype
        ((name, args),) = calls
        assert name == entry
        argtypes = _build.ENTRY_POINTS[entry]
        assert len(args) == len(argtypes)
        for value, kind in zip(args, argtypes):
            if kind is ctypes.c_void_p:
                assert value is None or (isinstance(value, int) and value)
            else:
                assert isinstance(value, int)
        assert args[-1] == 1234

    def test_library_name_follows_sources(self):
        path = _build.library_path()
        assert path.parent == _build.BUILD_DIR
        assert re.fullmatch(r"libstgcn_kernels-[0-9a-f]{64}\.so", path.name)
        assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS


@pytest.fixture(scope="module")
def adjacency():
    return get_normalized_adjacency(Strategy.DISTANCE, 1)


def randomized_block(rng, c_in, c_out, adjacency, *, stride, residual,
                     mode, dtype=jnp.float32):
    params, state = init_block(jax.random.key(1), c_in, c_out,
                               jnp.asarray(adjacency, dtype), gamma=GAMMA,
                               stride=stride, residual=residual,
                               adjacency_mode=mode, dtype=dtype)
    np_dt = np.dtype(dtype)

    def jitter(p):
        return jnp.asarray(np.asarray(p) + rng.normal(0, 0.2, p.shape), np_dt)

    params = jax.tree.map(jitter, params)
    state = {k: {"mean": jnp.asarray(rng.normal(0, 0.3, v["mean"].shape),
                                     np_dt),
                 "var": jnp.asarray(rng.uniform(0.5, 2.0, v["var"].shape),
                                    np_dt)}
             for k, v in state.items()}
    return params, state


class TestOpsBlock:
    @pytest.mark.parametrize("mode", ["reference", "mask", "fixed"])
    @pytest.mark.parametrize("stride,residual", [(1, False), (2, False),
                                                 (1, True), (2, True)])
    def test_matches_jax_block_forward(self, rng, adjacency, mode, stride,
                                       residual):
        c_in, c_out = (8, 8) if stride == 1 else (8, 16)
        params, state = randomized_block(rng, c_in, c_out, adjacency,
                                         stride=stride, residual=residual,
                                         mode=mode)
        x = rng.normal(0, 1, (2, 24, V, c_in)).astype(np.float32)
        ref, _ = jax_block_forward(params, state, jnp.asarray(x),
                                   jnp.asarray(adjacency), stride=stride,
                                   residual=residual, train=False)
        got = block_forward(to_torch(params), to_torch(state),
                            torch.from_numpy(x), torch.from_numpy(adjacency),
                            stride=stride, residual=residual)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref),
                                   rtol=RTOL, atol=ATOL)

    @pytest.mark.parametrize("residual", [False, True])
    def test_dense_lambda_adjacency_float64(self, rng, residual):
        adj64 = get_normalized_adjacency(Strategy.DISTANCE, 1,
                                         mode="reference").astype(np.float64)
        params, state = randomized_block(rng, 4, 8, adj64, stride=2,
                                         residual=residual, mode="fixed",
                                         dtype=jnp.float64)
        x = rng.normal(0, 1, (2, 16, V, 4))
        ref, _ = jax_block_forward(params, state, jnp.asarray(x),
                                   jnp.asarray(adj64), stride=2,
                                   residual=residual, train=False)
        got = block_forward(to_torch(params), to_torch(state),
                            torch.from_numpy(x), torch.from_numpy(adj64),
                            stride=2, residual=residual)
        assert got.dtype == torch.float64
        np.testing.assert_allclose(got.numpy(), np.asarray(ref),
                                   rtol=1e-9, atol=1e-9)

    @pytest.mark.parametrize("mode", ["reference", "mask", "fixed"])
    def test_effective_adjacency(self, rng, adjacency, mode):
        params, _ = randomized_block(rng, 4, 4, adjacency, stride=1,
                                     residual=False, mode=mode)
        from stgcn_tpu.ops.block import effective_adjacency as jax_eff

        ref = jax_eff(params, jnp.asarray(adjacency))
        got = effective_adjacency(to_torch(params),
                                  torch.from_numpy(adjacency))
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6)

    @pytest.mark.parametrize("residual", [False, True])
    def test_plain_kernel_matches_ops_block(self, rng, adjacency, residual):
        """The folded-BN block function equals the op chain."""
        from stgcn_tpu_torch.models.fused import fused_block_args

        params, state = randomized_block(rng, 8, 16, adjacency, stride=2,
                                         residual=residual, mode="mask")
        x = rng.normal(0, 1, (2, 20, V, 8)).astype(np.float32)
        tp, ts = to_torch(params), to_torch(state)
        ta = torch.from_numpy(adjacency)
        ref = block_forward(tp, ts, torch.from_numpy(x), ta, stride=2,
                            residual=residual)
        kw = fused_block_args(tp, ts, ta, residual=residual, stride=2)
        got = be.block_eval_reference(
            torch.from_numpy(x).permute(2, 0, 1, 3).contiguous(), **kw)
        np.testing.assert_allclose(got.permute(1, 2, 0, 3).numpy(),
                                   ref.numpy(), rtol=RTOL, atol=ATOL)

    def test_fold_batchnorm_matches_batchnorm(self, rng):
        p = {"scale": torch.from_numpy(rng.normal(1, 0.3, 16)),
             "offset": torch.from_numpy(rng.normal(0, 0.3, 16))}
        s = {"mean": torch.from_numpy(rng.normal(0, 0.3, 16)),
             "var": torch.from_numpy(rng.uniform(0.5, 2, 16))}
        x = torch.from_numpy(rng.normal(0, 1, (3, 4, 16)))
        scale, shift = tbn.fold_batchnorm_eval(p, s)
        np.testing.assert_allclose((x * scale + shift).numpy(),
                                   tbn.batchnorm_eval(p, s, x).numpy(),
                                   rtol=1e-12, atol=1e-12)
