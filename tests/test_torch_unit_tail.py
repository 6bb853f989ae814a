"""The units' tail op (``stgcn_tpu_torch/kernels/unit_tail.py``).

The op's plain versions, through its ``autograd.Function``, are held to
the bit against the PyTorch chain it replaces (``torch.relu(u.to(f32) +
short.to(f32)).to(dtype)``, then dropout's ``torch.where(draw < keep, out /
scale, 0)``) and its autograd in bf16 and float32, and against autograd of
the chain in float64: identity, projection and no shortcut; dropout
"exact" and "bits8" at rates 0.5 and 0.3, and none.  The fused train block
through the op is held against the JAX package's fused block on the CPU,
the JAX output and gradients taken through the torch generator's mask.

The CUDA side cannot run here: the ``ctypes`` declarations are held
against the C signatures read from the source, the launch functions run
against a fake library (arguments, the mask's ``ceil(n / 8)`` bytes, the
launch counts, the dtypes and shapes refused), and the kernels' names
against every pattern of the benchmark's metrics.  The kernels themselves
are checked on the card by ``python3 chip_smoke.py --unit-tail``.
"""

import contextlib
import ctypes
import re
from pathlib import Path

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from stgcn_bench import trace as tracing
from stgcn_tpu.graph.adjacency import get_normalized_adjacency
from stgcn_tpu.models.fused import (
    block_forward_fused_train as jax_fused_block,
)
from stgcn_tpu.ops.block import init_block
from stgcn_tpu_torch.graph.adjacency import Strategy
from stgcn_tpu_torch.kernels import _build
from stgcn_tpu_torch.kernels import unit_tail as ut
from stgcn_tpu_torch.models import stgcn as tm
from stgcn_tpu_torch.models.convert import params_from_jax, params_to_numpy
from stgcn_tpu_torch.models.fused import block_forward_fused_train
from stgcn_tpu_torch.ops.common import dropout, dropout_draw
from stgcn_tpu_torch.training import graphs
from stgcn_tpu_torch.training import optimizers as opt
from stgcn_tpu_torch.training.loop import make_eval_step, make_train_step
from stgcn_tpu_torch.training.train_state import train_state_from

SHAPE = (25, 2, 7, 16)      # (V, N, T, C): 5600 elements
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
# dropout's (impl, rate); rate 0 draws nothing
MODES = [("exact", 0.5), ("exact", 0.3), ("bits8", 0.5), ("bits8", 0.3),
         ("exact", 0.0)]
SHORTCUTS = ("identity", "proj", "none")
METRICS = Path(__file__).resolve().parents[1] / "stgcn_bench" / "metrics"


def chain(u, x, short_kind, w, rate, impl, seed):
    """Today's tail as the fused block formed it before the op: the
    projection (float32 matmul of x, rounded, plus the bias), the add and
    ReLU in float32 rounded to u's dtype, then ``dropout``."""
    acc = torch.promote_types(u.dtype, torch.float32)
    if short_kind == "none":
        out = torch.relu(u.to(acc)).to(u.dtype)
    else:
        short = x if short_kind == "identity" else (
            (x.to(acc) @ w[0].to(acc)).to(u.dtype) + w[1])
        out = torch.relu(u.to(acc) + short.to(acc)).to(u.dtype)
    if rate > 0:
        out = dropout(out, rate, generator=torch.Generator().manual_seed(seed),
                      impl=impl)
    return out


def through_op(u, x, short_kind, w, rate, impl, seed):
    """The same through the op, on the same generator's draw."""
    acc = torch.promote_types(u.dtype, torch.float32)
    short = {"none": None, "identity": x}.get(short_kind)
    if short_kind == "proj":
        short = (x.to(acc) @ w[0].to(acc)).to(u.dtype) + w[1]
    draw = (None, None, None)
    if rate > 0:
        draw = dropout_draw(u.shape, rate,
                            generator=torch.Generator().manual_seed(seed),
                            device=u.device, impl=impl)
    return ut.unit_tail(u, short, *draw)


def inputs(rng, dtype):
    u = torch.from_numpy(rng.normal(0, 1, SHAPE)).to(dtype).requires_grad_()
    x = torch.from_numpy(rng.normal(0, 1, SHAPE)).to(dtype).requires_grad_()
    w = (torch.from_numpy(rng.normal(0, 0.3, (SHAPE[-1], SHAPE[-1])))
         .to(dtype).requires_grad_(),
         torch.from_numpy(rng.normal(0, 0.1, SHAPE[-1])).to(dtype)
         .requires_grad_())
    dout = torch.from_numpy(rng.normal(0, 1, SHAPE)).to(dtype)
    return u, x, w, dout


def grads(out, u, x, w, short_kind, dout):
    wrt = [u] + ([x] if short_kind != "none" else [])
    wrt += list(w) if short_kind == "proj" else []
    return torch.autograd.grad(out, wrt, dout)


# ---- the plain versions ----------------------------------------------------

class TestPlain:
    @pytest.mark.parametrize("impl,rate", MODES)
    @pytest.mark.parametrize("short_kind", SHORTCUTS)
    @pytest.mark.parametrize("dtype", sorted(DTYPES))
    def test_same_as_the_chain(self, rng, dtype, short_kind, impl, rate):
        """Output and every gradient to the bit: the op rounds where the
        chain and its autograd round."""
        u, x, w, dout = inputs(rng, DTYPES[dtype])
        want = chain(u, x, short_kind, w, rate, impl, 5)
        got = through_op(u, x, short_kind, w, rate, impl, 5)
        assert got.dtype == u.dtype and torch.equal(got, want)
        for g, wg in zip(grads(got, u, x, w, short_kind, dout),
                         grads(want, u, x, w, short_kind, dout)):
            assert g.dtype == wg.dtype and torch.equal(g, wg)

    @pytest.mark.parametrize("impl,rate", MODES)
    @pytest.mark.parametrize("short_kind", SHORTCUTS)
    def test_float64_against_autograd_of_the_chain(self, rng, short_kind,
                                                   impl, rate):
        u, x, w, dout = inputs(rng, torch.float64)
        want = chain(u, x, short_kind, w, rate, impl, 6)
        got = through_op(u, x, short_kind, w, rate, impl, 6)
        np.testing.assert_allclose(got.detach(), want.detach(), rtol=1e-12)
        for g, wg in zip(grads(got, u, x, w, short_kind, dout),
                         grads(want, u, x, w, short_kind, dout)):
            np.testing.assert_allclose(g, wg, rtol=1e-12, atol=1e-15)

    def test_the_draw_keeps_its_share(self, rng):
        """Rate 0.3 keeps about 70% of the positive outputs, scaled by
        1/0.7; bits8 by its quantized 179/256."""
        u = torch.from_numpy(np.abs(rng.normal(0, 1, (64, 1000)))).float()
        for impl, scale in (("exact", 0.7), ("bits8", 179 / 256)):
            draw = dropout_draw(u.shape, 0.3, generator=torch.Generator()
                                .manual_seed(1), device=u.device, impl=impl)
            out = ut.unit_tail(u, None, *draw)
            kept = out != 0
            assert 0.68 < kept.float().mean() < 0.72
            np.testing.assert_allclose(out[kept], u[kept] / scale, rtol=1e-6)

    def test_saves_only_the_mask(self, rng):
        u, x, _, _ = inputs(rng, torch.bfloat16)
        draw = dropout_draw(SHAPE, 0.5, generator=torch.Generator(),
                            device=u.device)
        out = ut.unit_tail(u, x, *draw)
        (saved,) = out.grad_fn.saved_tensors
        # the plain version's bool mask; the kernels' packs 8 to a byte
        assert saved.dtype == torch.bool and saved.shape == SHAPE

    def test_short_takes_the_same_gradient(self, rng):
        u, x, _, dout = inputs(rng, torch.bfloat16)
        draw = dropout_draw(SHAPE, 0.5, generator=torch.Generator(),
                            device=u.device)
        du, dx = torch.autograd.grad(ut.unit_tail(u, x, *draw), [u, x], dout)
        assert torch.equal(du, dx)

    def test_other_devices_refused(self):
        x = torch.zeros(SHAPE, device="meta")
        with pytest.raises(ValueError, match="cuda or cpu"):
            ut.unit_tail_forward(x, None, None, None, None)
        with pytest.raises(ValueError, match="cuda or cpu"):
            ut.unit_tail_backward(x.bool(), x, None)


# ---- the fused train block through the op, against the JAX package --------

GAMMA = 9


def random_block(rng, c_in, c_out, adjacency, *, stride, residual):
    params, state = init_block(jax.random.key(1), c_in, c_out,
                               jnp.asarray(adjacency), gamma=GAMMA,
                               stride=stride, residual=residual,
                               adjacency_mode="mask", dtype=jnp.float32)
    params = jax.tree.map(
        lambda p: np.asarray(p) + rng.normal(0, 0.2, p.shape).astype(
            np.float32), params)
    state = {k: {"mean": rng.normal(0, 0.3, v["mean"].shape).astype(
                     np.float32),
                 "var": rng.uniform(0.5, 2.0, v["var"].shape).astype(
                     np.float32)}
             for k, v in state.items()}
    return params, state


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    return [tree]


class TestFusedBlock:
    # (c_in, c_out, stride, residual): the identity shortcut, the
    # projection at stride 2, the non-residual order
    CASES = [(16, 16, 1, True), (8, 16, 2, True), (8, 16, 1, False)]

    @pytest.mark.parametrize("impl,rate", [("exact", 0.5), ("bits8", 0.3)])
    @pytest.mark.parametrize("c_in,c_out,stride,residual", CASES)
    def test_matches_jax_fused_block(self, rng, c_in, c_out, stride,
                                     residual, impl, rate):
        """Float32: the port's block (its draw from a seeded generator)
        against the JAX fused block without dropout, its output and
        cotangent passed through the same mask: output, new statistics
        and every parameter gradient at rtol 1e-4, the absolute floor 1e-4
        of the largest magnitude."""
        adj = get_normalized_adjacency(Strategy.DISTANCE, 1).astype(
            np.float32)
        params, state = random_block(rng, c_in, c_out, adj, stride=stride,
                                     residual=residual)
        x = rng.normal(0, 1, (25, 2, 16, c_in)).astype(np.float32)
        t_out = (16 - 1) // stride + 1
        shape = (25, 2, t_out, c_out)
        ct = rng.normal(0, 1, shape).astype(np.float32)
        draw, keep_below, scale = dropout_draw(
            shape, rate, generator=torch.Generator().manual_seed(9),
            device="cpu", impl=impl)
        m = ((draw < keep_below).numpy() / scale).astype(np.float32)

        def jax_loss(p):
            out, s = jax_fused_block(p, state, jnp.asarray(x),
                                     jnp.asarray(adj), stride=stride,
                                     residual=residual, interpret=True)
            out = out * m
            return jnp.sum(out * ct), (out, s)

        (_, (out_j, s_j)), g_j = jax.value_and_grad(
            jax_loss, has_aux=True)(params)
        tp, ts = params_from_jax(params, state)
        for leaf in _leaves(tp):
            leaf.requires_grad_()
        out, s = block_forward_fused_train(
            tp, ts, torch.from_numpy(x), torch.from_numpy(adj),
            stride=stride, residual=residual, dropout_rate=rate,
            generator=torch.Generator().manual_seed(9), dropout_impl=impl)
        leaves = _leaves(tp)
        got_g = torch.autograd.grad((out * torch.from_numpy(ct)).sum(),
                                    leaves)
        want_g = _leaves(g_j)
        big = max(float(np.abs(np.asarray(g)).max()) for g in want_g)
        np.testing.assert_allclose(out.detach(), np.asarray(out_j),
                                   rtol=1e-4,
                                   atol=1e-4 * np.abs(out_j).max())
        for got, want in zip(_leaves(params_to_numpy(s)), _leaves(s_j)):
            np.testing.assert_allclose(got, np.asarray(want), rtol=1e-4,
                                       atol=1e-4)
        assert len(got_g) == len(want_g)
        for got, want in zip(got_g, want_g):
            np.testing.assert_allclose(got, np.asarray(want), rtol=1e-4,
                                       atol=1e-4 * big)


# ---- calls in a step -------------------------------------------------------

PLAN = ((8, 1), (16, 2), (16, 1))


def counting(monkeypatch):
    """Count the op's forward and backward calls on the CPU."""
    calls = {"fwd": 0, "bwd": 0}
    fwd, bwd = ut.unit_tail_forward, ut.unit_tail_backward

    def f(*args):
        calls["fwd"] += 1
        return fwd(*args)

    def b(*args):
        calls["bwd"] += 1
        return bwd(*args)

    monkeypatch.setattr(ut, "unit_tail_forward", f)
    monkeypatch.setattr(ut, "unit_tail_backward", b)
    return calls


@pytest.mark.parametrize("block_impl,residual,calls_a_unit", [
    ("fused", True, 1), ("fused", False, 1), ("hybrid", True, None),
    ("ops", True, 0)])
def test_once_a_fused_unit_each_way(monkeypatch, block_impl, residual,
                                    calls_a_unit):
    """The op runs once a fused unit each way, in both orders (the hybrid
    in its fused blocks only); the op chain and evaluation never call
    it."""
    calls = counting(monkeypatch)
    cfg = tm.STGCNConfig(plan=PLAN, strategy=Strategy.DISTANCE, d=1,
                         residual=residual, block_impl=block_impl,
                         dropout_rate=0.5, fused_from=1)
    model = tm.STGCN(cfg)
    params, state = model.init_params(0)
    ts = train_state_from(params, state, opt.adam(1e-3), 0,
                          torch.device("cpu"))
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(0, 1, (4, 16, 25, 2)).astype(np.float32))
    y = torch.from_numpy(rng.integers(0, 6, 4))
    make_train_step(model)(ts, x, y)
    if calls_a_unit is None:
        from stgcn_tpu_torch.models.fused import hybrid_fused_set

        calls_a_unit = len(hybrid_fused_set(cfg)) / len(PLAN)
    n = calls_a_unit * len(PLAN)
    assert calls == {"fwd": n, "bwd": n}
    make_eval_step(model)(ts, x, y)
    assert calls == {"fwd": n, "bwd": n}


def test_a_counted_kernel_module():
    counters = graphs.launch_counters()
    assert ut.unit_tail_forward in counters
    assert ut.unit_tail_backward in counters


# ---- the CUDA side, without a compiler or a card ---------------------------

C_KINDS = {"float": ctypes.c_float, "long": ctypes.c_longlong,
           "int": ctypes.c_int}
ENTRY = ("unit_tail_fwd_launch", "unit_tail_bwd_launch")


def kernel_names() -> list[str]:
    """Each kernel of the source as a profiler trace names it."""
    src = (_build.CSRC / "unit_tail.cu").read_text()
    names = re.findall(r"__global__ void __launch_bounds__\(\w+\)\s*(\w+)\(",
                       src)
    assert names == ["unit_tail_fwd_kernel", "unit_tail_bwd_kernel"]
    return [f"void unit_tail::(anonymous namespace)::{n}<__nv_bfloat16, "
            f"float, true>(__nv_bfloat16 const*, long, float)"
            for n in names]


def test_kernel_names_match_no_metric_pattern():
    """No per-layer metric claims the op's kernels: their time counts in
    ``tail_ms.train`` and ``rest_ms.train`` and in no roofline."""
    found = [p for d in METRICS.glob("*.d")
             for p in sum(tracing.patterns(d), [])]
    assert found
    for name in kernel_names():
        assert not any(p.search(name) for p in found), name


class TestLaunch:
    @pytest.mark.parametrize("name", ENTRY)
    def test_c_signature_matches_argtypes(self, name):
        src = (_build.CSRC / "unit_tail.cu").read_text()
        sig = re.search(r'extern "C" int %s\((.*?)\)\s*\{' % name, src,
                        re.S).group(1)
        kinds = [ctypes.c_void_p if "*" in p else C_KINDS[p.split()[0]]
                 for p in sig.split(",")]
        assert kinds == _build.ENTRY_POINTS[name]

    def test_source_is_built(self):
        assert "unit_tail.cu" in {p.name for p in _build.sources()}

    @pytest.mark.parametrize("n, ctas", [
        (64 * 304 * 25 * 64, 1056), (64 * 76 * 25 * 256, 1056),
        (8, 1), (2049 * 8, 9), (3, 1)])
    def test_plan(self, n, ctas):
        assert ut.plan_ctas(n, 132) == ctas

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
                assert value is None or (isinstance(value, int) and value)
            elif kind is ctypes.c_float:
                assert isinstance(value, float)
            else:
                assert isinstance(value, int)
        assert args[-1] == 4321

    @pytest.mark.parametrize("shape", [SHAPE, (25, 3, 37, 3)])
    @pytest.mark.parametrize("short_on", [True, False])
    @pytest.mark.parametrize("dtype, code", [(torch.bfloat16, 1),
                                             (torch.float32, 0)])
    @pytest.mark.parametrize("impl, rate, kind, keep, scale", [
        ("exact", 0.5, 1, 0.5, 0.5), ("exact", 0.3, 1, 0.7, 0.7),
        ("bits8", 0.3, 2, 179.0, 179 / 256), ("exact", 0.0, 0, 0.0, 1.0)])
    def test_launches(self, fake_lib, shape, short_on, dtype, code, impl,
                      rate, kind, keep, scale):
        u = torch.zeros(shape, dtype=dtype)
        short = torch.zeros(shape, dtype=dtype) if short_on else None
        draw = (dropout_draw(shape, rate, generator=torch.Generator(),
                             device="cpu", impl=impl)
                if rate else (None, None, None))
        n = u.numel()
        ctas = ut.plan_ctas(n, 132)
        before = (ut.unit_tail_forward.launches,
                  ut.unit_tail_backward.launches)
        out, bits = ut._launch_forward(u, short, *draw)
        # the output, then the mask: ceil(n / 8) bytes
        assert fake_lib["empty"] == [(((n + 7) // 8,), torch.uint8)]
        assert out.shape == u.shape and out.dtype == dtype
        du = ut._launch_backward(bits, torch.zeros_like(u), draw[2])
        assert du.shape == u.shape and du.dtype == dtype
        assert (ut.unit_tail_forward.launches,
                ut.unit_tail_backward.launches) == (before[0] + 1,
                                                    before[1] + 1)
        (fwd,), (bwd,) = (fake_lib["unit_tail_fwd_launch"],
                          fake_lib["unit_tail_bwd_launch"])
        self.check_call(fwd, "unit_tail_fwd_launch")
        self.check_call(bwd, "unit_tail_bwd_launch")
        assert (fwd[1] is None) == (not short_on)
        assert (fwd[2] is None) == (rate == 0)
        # ..., elements, dtype, draw kind, keep_below, scale, ctas, stream
        assert fwd[5:11] == (n, code, kind, keep, scale, ctas)
        # ..., elements, dtype, scaled, scale, ctas, stream
        assert bwd[3:8] == (n, code, int(rate > 0), scale, ctas)

    @pytest.mark.parametrize("dtype", [torch.float64, torch.float16,
                                       torch.int32])
    def test_refuses_other_dtypes(self, fake_lib, dtype):
        u = torch.zeros(SHAPE, dtype=dtype)
        with pytest.raises(TypeError, match="unit_tail takes"):
            ut._launch_forward(u, None, None, None, None)
        with pytest.raises(TypeError, match="unit_tail takes"):
            ut._launch_backward(torch.zeros(700, dtype=torch.uint8), u, None)
        assert "unit_tail_fwd_launch" not in fake_lib

    def test_refuses_mismatched_arguments(self, fake_lib):
        u = torch.zeros(SHAPE, dtype=torch.bfloat16)
        with pytest.raises(ValueError, match="short must be"):
            ut._launch_forward(u, torch.zeros(SHAPE[1:],
                                              dtype=torch.bfloat16),
                               None, None, None)
        with pytest.raises(TypeError, match="short must be"):
            ut._launch_forward(u, torch.zeros(SHAPE), None, None, None)
        with pytest.raises(ValueError, match="draw must be"):
            ut._launch_forward(u, None, torch.zeros(4), 0.5, 0.5)
        with pytest.raises(TypeError, match="draw must be float32 or uint8"):
            ut._launch_forward(u, None, torch.zeros(SHAPE,
                                                    dtype=torch.float64),
                               0.5, 0.5)
        with pytest.raises(ValueError, match="non-empty"):
            ut._launch_forward(u[:0], None, None, None, None)
        with pytest.raises(ValueError, match=r"mask must be \(700,\)"):
            ut._launch_backward(torch.zeros(699, dtype=torch.uint8), u, None)
        with pytest.raises(ValueError, match="mask must be"):
            ut._launch_backward(torch.zeros(700, dtype=torch.bool), u, None)
        assert "unit_tail_fwd_launch" not in fake_lib
        assert "unit_tail_bwd_launch" not in fake_lib

    def test_a_failed_launch_raises(self, monkeypatch, fake_lib):
        class FailingLib:
            def unit_tail_fwd_launch(self, *args):
                return 1

            def block_eval_error_string(self, err):
                return b"invalid argument"

        monkeypatch.setattr(_build, "load_library", lambda: FailingLib())
        with pytest.raises(RuntimeError, match="unit_tail forward"):
            ut._launch_forward(torch.zeros(SHAPE), None, None, None, None)
