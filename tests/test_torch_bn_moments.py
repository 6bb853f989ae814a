"""The BatchNorm statistics op (``stgcn_tpu_torch/kernels/bn_moments.py``).

The op's plain versions, through its ``autograd.Function``, are held
against autograd of the plain formula (``x.to(float32)``, ``mean``,
``square().mean``) in float64 at rtol 1e-12, and against the JAX package's
``_bn_affine_train`` on the CPU through ``bn_affine_train``: values, new
running statistics and the gradient of ``x``.  float32 at rtol 1e-5, and
bf16 inputs within one bf16 step of the gradient (both packages round it
to bf16 from float32 sums taken in other orders).

The CUDA side cannot run here: the ``ctypes`` declarations are held
against the C signatures read from the source, and the launch functions
run against a fake library (arguments, the partial sums' shape, the launch
counts, the dtypes refused).  The kernels themselves are checked on the
card by ``python3 chip_smoke.py --bn-moments``.
"""

import contextlib
import ctypes
import re

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from stgcn_tpu.models.fused import _bn_affine_train as jax_bn_affine
from stgcn_tpu_torch.graph.adjacency import Strategy
from stgcn_tpu_torch.kernels import _build
from stgcn_tpu_torch.kernels import bn_moments as bm
from stgcn_tpu_torch.models import stgcn as tm
from stgcn_tpu_torch.models.convert import params_from_jax, params_to_numpy
from stgcn_tpu_torch.models.fused import bn_affine_train
from stgcn_tpu_torch.training import optimizers as opt
from stgcn_tpu_torch.training.loop import make_eval_step, make_train_step
from stgcn_tpu_torch.training.train_state import train_state_from

WIDTHS = (2, 3, 64, 256)
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
SHAPE = (2, 6, 25)      # the (N, T, V) rows of a test activation


def formula(x):
    """Today's moments, the plain formula autograd differentiates."""
    xf = x.to(torch.promote_types(x.dtype, torch.float32))
    axes = tuple(range(x.dim() - 1))
    return xf.mean(dim=axes), xf.square().mean(dim=axes)


def activation(rng, c, dtype=torch.float64):
    x = rng.normal(0.4, 1.5, (*SHAPE, c))
    return torch.from_numpy(x).to(dtype)


# ---- the plain versions ----------------------------------------------------

class TestPlain:
    @pytest.mark.parametrize("c", WIDTHS)
    def test_float64_against_autograd_of_the_formula(self, rng, c):
        x = activation(rng, c).requires_grad_()
        g = [torch.from_numpy(rng.normal(0, 1, c)) for _ in range(2)]
        got = bm.bn_moments(x)
        want = formula(x)
        for a, b in zip(got, want):
            assert a.dtype == torch.float64
            np.testing.assert_allclose(a.detach(), b.detach(), rtol=1e-12)
        (dx,) = torch.autograd.grad(got, [x], g)
        (want_dx,) = torch.autograd.grad(want, [x], g)
        np.testing.assert_allclose(dx, want_dx, rtol=1e-12, atol=1e-15)

    @pytest.mark.parametrize("dtype", sorted(DTYPES))
    @pytest.mark.parametrize("c", WIDTHS)
    def test_same_as_the_formula(self, rng, c, dtype):
        """On the CPU the op computes what the formula and its autograd
        compute, to the bit: the statistics in float32, the gradient
        rounded to x's dtype once."""
        x = activation(rng, c, DTYPES[dtype]).requires_grad_()
        g = [torch.from_numpy(rng.normal(0, 1, c)).float() for _ in range(2)]
        got, want = bm.bn_moments(x), formula(x)
        for a, b in zip(got, want):
            assert a.dtype == torch.float32
            assert torch.equal(a, b)
        (dx,) = torch.autograd.grad(got, [x], g)
        (want_dx,) = torch.autograd.grad(want, [x], g)
        assert dx.dtype == x.dtype and torch.equal(dx, want_dx)

    def test_one_gradient_unused(self, rng):
        """A moment that takes no gradient reaches the backward as zeros."""
        x = activation(rng, 8, torch.float32).requires_grad_()
        mean, _ = bm.bn_moments(x)
        (dx,) = torch.autograd.grad(mean.sum(), [x])
        np.testing.assert_allclose(dx, np.full(x.shape, 1 / np.prod(SHAPE)),
                                   rtol=1e-6)

    def test_saves_only_x(self, rng):
        x = activation(rng, 16, torch.bfloat16).requires_grad_()
        mean, _ = bm.bn_moments(x)
        saved = mean.grad_fn.saved_tensors
        assert len(saved) == 1 and saved[0] is x


class TestAgainstJax:
    @pytest.mark.parametrize("dtype", sorted(DTYPES))
    @pytest.mark.parametrize("c", WIDTHS)
    def test_bn_affine_train(self, rng, c, dtype):
        """``bn_affine_train`` (the fused path's BatchNorm, through
        ``batch_moments``) against ``_bn_affine_train``: s, t, the new
        running statistics, and the gradient of x through s and t."""
        x32 = rng.normal(0.4, 1.5, (*SHAPE, c)).astype(np.float32)
        xj = jnp.asarray(x32).astype(jnp.dtype(dtype))
        x = torch.from_numpy(x32).to(DTYPES[dtype])
        params = {"scale": rng.normal(1, 0.2, c).astype(np.float32),
                  "offset": rng.normal(0, 0.2, c).astype(np.float32)}
        state = {"mean": rng.normal(0, 0.3, c).astype(np.float32),
                 "var": rng.uniform(0.5, 2, c).astype(np.float32)}
        cs, ct = (rng.normal(0, 1, c).astype(np.float32) for _ in range(2))

        def jax_loss(x_):
            s, t, st = jax_bn_affine(params, state, x_)
            return jnp.sum(s * cs) + jnp.sum(t * ct), (s, t, st)

        (_, (s_j, t_j, st_j)), dx_j = jax.value_and_grad(
            jax_loss, has_aux=True)(xj)
        tp, ts = params_from_jax(params, state, dtype=torch.float32)
        x.requires_grad_()
        s, t, st = bn_affine_train(tp, ts, x)
        loss = ((s * torch.from_numpy(cs)).sum()
                + (t * torch.from_numpy(ct)).sum())
        (dx,) = torch.autograd.grad(loss, [x])
        for got, want in ((s, s_j), (t, t_j)):
            np.testing.assert_allclose(got.detach(), np.asarray(want),
                                       rtol=1e-5, atol=1e-6)
        got_st = params_to_numpy(st)
        for k in ("mean", "var"):
            np.testing.assert_allclose(got_st[k], np.asarray(st_j[k]),
                                       rtol=1e-5, atol=1e-6)
        assert dx.dtype == x.dtype
        want = np.asarray(dx_j.astype(jnp.float32), np.float64)
        got = dx.float().numpy().astype(np.float64)
        scale = np.abs(want).max()
        if dtype == "float32":
            np.testing.assert_allclose(got, want, rtol=1e-4,
                                       atol=1e-5 * scale)
        else:   # one bf16 step of the largest gradient
            np.testing.assert_allclose(got, want, rtol=2 ** -7,
                                       atol=2 ** -8 * scale)


# ---- launches in a step ----------------------------------------------------

PLAN = ((8, 1), (16, 2), (16, 1))


def counting(monkeypatch):
    """Count the op's forward and backward calls on the CPU."""
    calls = {"fwd": 0, "bwd": 0}
    fwd, bwd = bm.bn_moments_forward, bm.bn_moments_backward

    def f(x):
        calls["fwd"] += 1
        return fwd(x)

    def b(x, g_mean, g_sq):
        calls["bwd"] += 1
        return bwd(x, g_mean, g_sq)

    monkeypatch.setattr(bm, "bn_moments_forward", f)
    monkeypatch.setattr(bm, "bn_moments_backward", b)
    return calls


@pytest.mark.parametrize("block_impl", ["fused", "ops"])
def test_every_batchnorm_of_a_train_step_once(monkeypatch, block_impl):
    """Two BatchNorms a unit each go through the op once forward; backward
    all but the first unit's first, whose input (the batch) takes no
    gradient; evaluation never calls it."""
    calls = counting(monkeypatch)
    model = tm.STGCN(tm.STGCNConfig(plan=PLAN, strategy=Strategy.DISTANCE,
                                    d=1, residual=True, block_impl=block_impl,
                                    dropout_rate=0.5))
    params, state = model.init_params(0)
    ts = train_state_from(params, state, opt.adam(1e-3), 0,
                          torch.device("cpu"))
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(0, 1, (4, 16, 25, 2)).astype(np.float32))
    y = torch.from_numpy(rng.integers(0, 6, 4))
    make_train_step(model)(ts, x, y)
    assert calls == {"fwd": 2 * len(PLAN), "bwd": 2 * len(PLAN) - 1}
    make_eval_step(model)(ts, x, y)
    assert calls == {"fwd": 2 * len(PLAN), "bwd": 2 * len(PLAN) - 1}


# ---- the CUDA side, without a compiler or a card ---------------------------

class TestLaunch:
    ENTRY = ("bn_moments_fwd_launch", "bn_moments_bwd_launch")

    @pytest.mark.parametrize("name", ENTRY)
    def test_c_signature_matches_argtypes(self, name):
        src = (_build.CSRC / "bn_moments.cu").read_text()
        sig = re.search(r'extern "C" int %s\((.*?)\)\s*\{' % name, src,
                        re.S).group(1)
        kinds = [ctypes.c_void_p if "*" in p else ctypes.c_int
                 for p in sig.split(",")]
        assert kinds == _build.ENTRY_POINTS[name]

    def test_source_is_built(self):
        assert "bn_moments.cu" in {p.name for p in _build.sources()}

    @pytest.mark.parametrize("c, vec, ctas", [
        (64, 8, 528), (128, 8, 528), (256, 8, 528), (2, 1, 528),
        (3, 1, 528), (4096, 8, 528)])
    def test_plan_at_the_cells_shapes(self, c, vec, ctas):
        rows = 64 * 304 * 25
        assert bm.plan_ctas(rows, c, vec, 132) == ctas

    def test_plan_of_few_rows(self):
        # C=64 in units of 8: 8 threads a row, 32 rows a pass
        assert bm.plan_ctas(33, 64, 8, 132) == 2
        assert bm.plan_ctas(1, 3, 1, 132) == 1

    def test_vector_width(self):
        assert bm.vector_width(torch.zeros(4, 64, dtype=torch.bfloat16)) == 8
        assert bm.vector_width(torch.zeros(4, 64)) == 4
        assert bm.vector_width(torch.zeros(4, 64, dtype=torch.float64)) == 2
        assert bm.vector_width(torch.zeros(4, 3, dtype=torch.bfloat16)) == 1
        # a contiguous view two bytes into its storage: no 16-byte loads
        off = torch.zeros(1 + 4 * 64, dtype=torch.bfloat16)[1:].view(4, 64)
        assert bm.vector_width(off) == 1

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
        made = []
        empty = torch.empty

        def recording_empty(*args, **kw):
            out = empty(*args, **kw)
            made.append((tuple(out.shape), out.dtype))
            return out

        monkeypatch.setattr(torch, "empty", recording_empty)
        calls["empty"] = made
        return calls

    @staticmethod
    def check_call(args, name):
        declared = _build.ENTRY_POINTS[name]
        assert len(args) == len(declared)
        for value, kind in zip(args, declared):
            if kind is ctypes.c_void_p:
                assert isinstance(value, int) and value
            else:
                assert isinstance(value, int)
        assert args[-1] == 4321

    @pytest.mark.parametrize("dtype, code, c, vec", [
        (torch.bfloat16, 1, 64, 8), (torch.bfloat16, 1, 3, 1),
        (torch.float32, 0, 256, 4), (torch.float32, 0, 2, 1),
        (torch.float64, 2, 64, 2)])
    def test_launches(self, fake_lib, dtype, code, c, vec):
        x = torch.zeros((*SHAPE, c), dtype=dtype)
        rows = int(np.prod(SHAPE))
        ctas = bm.plan_ctas(rows, c, vec, 132)
        acc = torch.promote_types(dtype, torch.float32)
        before = (bm.bn_moments_forward.launches,
                  bm.bn_moments_backward.launches)
        mean, mean_sq = bm._launch_forward(x)
        # the partial sums, then mean and mean_sq
        assert fake_lib["empty"] == [((ctas, 2, c), acc), ((c,), acc),
                                     ((c,), acc)]
        g = torch.zeros(c, dtype=torch.float32)
        dx = bm._launch_backward(x, g, g)
        assert (bm.bn_moments_forward.launches,
                bm.bn_moments_backward.launches) == (before[0] + 1,
                                                     before[1] + 1)
        assert mean.shape == mean_sq.shape == (c,) and mean.dtype == acc
        assert dx.shape == x.shape and dx.dtype == dtype
        (fwd,), (bwd,) = (fake_lib["bn_moments_fwd_launch"],
                          fake_lib["bn_moments_bwd_launch"])
        self.check_call(fwd, "bn_moments_fwd_launch")
        self.check_call(bwd, "bn_moments_bwd_launch")
        # ..., rows, C, dtype, vec, ctas, stream
        assert fwd[4:9] == (rows, c, code, vec, ctas)
        assert bwd[4:9] == (rows, c, code, vec, ctas)

    @pytest.mark.parametrize("dtype", [torch.float16, torch.int32])
    def test_refuses_other_dtypes(self, fake_lib, dtype):
        x = torch.zeros((*SHAPE, 8), dtype=dtype)
        with pytest.raises(TypeError, match="bn_moments takes"):
            bm._launch_forward(x)
        with pytest.raises(TypeError, match="bn_moments takes"):
            bm._launch_backward(x, torch.zeros(8), torch.zeros(8))
        assert "bn_moments_fwd_launch" not in fake_lib

    def test_refuses_bad_shapes(self, fake_lib):
        with pytest.raises(ValueError, match="non-empty"):
            bm._launch_forward(torch.zeros((0, 8)))
        with pytest.raises(ValueError, match=r"must be \(8,\)"):
            bm._launch_backward(torch.zeros((4, 8)), torch.zeros(4),
                                torch.zeros(8))

    def test_a_failed_launch_raises(self, monkeypatch, fake_lib):
        class FailingLib:
            def bn_moments_fwd_launch(self, *args):
                return 1

            def block_eval_error_string(self, err):
                return b"invalid argument"

        monkeypatch.setattr(_build, "load_library", lambda: FailingLib())
        with pytest.raises(RuntimeError, match="bn_moments forward"):
            bm._launch_forward(torch.zeros((4, 8)))

    def test_other_devices_refused(self):
        x = torch.zeros((4, 8), device="meta")
        with pytest.raises(ValueError, match="cuda or cpu"):
            bm.bn_moments_forward(x)
        with pytest.raises(ValueError, match="cuda or cpu"):
            bm.bn_moments_backward(x, x[0], x[0])
