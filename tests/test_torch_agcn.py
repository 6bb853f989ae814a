"""2s-AGCN in the port (``models/agcn.py``, ``graph/ntu.py``,
``kernels/adaptive_graph.py``) against the benchmark's plain reference
(``stgcn_bench/reference/agcn.py``), on the CPU in float64:

* the NTU graph's three subsets against ``normalize_digraph`` computed by
  hand from the edge list;
* the op path and the kernel path (the ops' plain versions) at a small
  size (4 narrow units, T=16, N=2, M=2): logits, every parameter's
  gradient, the new BatchNorm statistics, and the parameters after one
  and three steps of Nesterov SGD with weight decay;
* the kernel wrappers' refusal of what the bf16 kernels cannot take;
* the adaptive graph and the per-sample aggregation ops against the
  reference's per-subset loop, values and gradients;
* the C signatures of the new entry points against their ctypes
  declarations, and the phase marks of a step.
"""

import ctypes
import re

import numpy as np
import pytest
import torch

from stgcn_bench.reference import agcn as ref
from stgcn_tpu_torch.graph import ntu
from stgcn_tpu_torch.kernels import _build
from stgcn_tpu_torch.kernels import adaptive_graph as ag
from stgcn_tpu_torch.kernels.affine_relu import affine_add_relu
from stgcn_tpu_torch.models.agcn import AGCN, AGCNConfig
from stgcn_tpu_torch.training.loop import make_train_step
from stgcn_tpu_torch.training.optimizers import OptimizerSpec
from stgcn_tpu_torch.training.train_state import train_state_from
from stgcn_tpu_torch.tree import tree_map
from stgcn_tpu_torch.utils import profiling

PLAN = ((8, 1), (8, 1), (16, 2), (16, 1))
N, M, T, V, C = 2, 2, 16, 25, 3
CLASSES = 5
SGD = dict(lr=0.1, momentum=0.9, nesterov=True, weight_decay=1e-4)
F64 = torch.float64


def _params(seed=1):
    """Published-init weights, with the GCN BatchNorm's scale at 1 and B_k
    drawn in +-0.1 (as the benchmark draws them), in float64."""
    p, s = AGCN(AGCNConfig(plan=PLAN, num_classes=CLASSES)).init_params(seed)
    gen = torch.Generator().manual_seed(seed + 7)
    for u in p["units"]:
        u["bn_g"]["scale"].fill_(1.0)
        u["gcn"]["PA"].uniform_(-0.1, 0.1, generator=gen)
        for name in ("a_b", "b_b", "d_b"):
            u["gcn"][name].normal_(0.0, 0.1, generator=gen)
    return (tree_map(lambda t: t.to(F64), p), tree_map(lambda t: t.to(F64), s))


def _batch(seed=3):
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn(N, M, T, V, C, dtype=F64, generator=gen)
    x[0, 1] = 0.0                       # a one-person clip, zero-padded
    return x, torch.randint(0, CLASSES, (N,), generator=gen)


def _program(impl):
    return AGCN(AGCNConfig(plan=PLAN, num_classes=CLASSES, block_impl=impl))


def _strides():
    return [s for _, s in PLAN]


def test_ntu_subsets_by_hand():
    a = ntu.agcn_subsets()
    assert a.shape == (3, V, V) and a.dtype == np.float32
    np.testing.assert_array_equal(a[0], np.eye(V))
    for k, links in ((1, ntu.INWARD), (2, ntu.OUTWARD)):
        want = np.zeros((V, V))
        indeg = {}
        for i, j in links:
            indeg[i] = indeg.get(i, 0) + 1      # column i's sum
        for i, j in links:
            want[j, i] = 1.0 / indeg[i]
        np.testing.assert_allclose(a[k], want, rtol=1e-7)
    assert len(ntu.INWARD) == 24 and (1, 20) in ntu.INWARD
    np.testing.assert_allclose(a, ref.subsets(), rtol=1e-7)
    # every joint but the centre points inward along exactly one edge
    assert sorted(i for i, _ in ntu.INWARD) == [
        i for i in range(V) if i != ntu.CENTER]


def test_op_path_against_reference():
    _check_path_against_reference("ops")


def test_kernel_path_against_reference():
    """The default path, its ops' plain versions on the CPU."""
    assert AGCNConfig().block_impl == "kernels"
    _check_path_against_reference("kernels")


def _check_path_against_reference(impl):
    params, state = _params()
    x, y = _batch()
    model = _program(impl)
    leaves = tree_map(lambda t: t.clone().requires_grad_(True), params)
    logits, new_state = model.apply(leaves, state, x, train=True)
    loss = torch.nn.functional.cross_entropy(logits, y)
    grads = dict(zip(ref.leaves(leaves), torch.autograd.grad(
        loss, list(ref.leaves(leaves).values()))))

    rp = tree_map(lambda t: t.clone().requires_grad_(True), params)
    a = torch.from_numpy(ref.subsets()).to(F64)
    want_logits, want_state = ref.forward(rp, state, x, a, _strides())
    want_loss = torch.nn.functional.cross_entropy(want_logits, y)
    want_grads = dict(zip(ref.leaves(rp), torch.autograd.grad(
        want_loss, list(ref.leaves(rp).values()))))

    torch.testing.assert_close(logits, want_logits, rtol=1e-10, atol=1e-12)
    assert grads.keys() == want_grads.keys()
    # theta's bias has no gradient (the softmax over i takes out what it
    # adds along a column), so the floor is the largest gradient's
    scale = max(float(g.abs().max()) for g in want_grads.values())
    for k, g in grads.items():
        torch.testing.assert_close(g, want_grads[k], rtol=1e-8,
                                   atol=1e-10 * scale, msg=k)
    got_s, want_s = ref.leaves(new_state), ref.leaves(want_state)
    assert got_s.keys() == want_s.keys()
    for k in got_s:
        torch.testing.assert_close(got_s[k], want_s[k], rtol=1e-10,
                                   atol=1e-12, msg=k)


@pytest.mark.parametrize("impl", ["ops", "kernels"])
def test_sgd_step_against_reference(impl):
    """One and three steps of the captured train step (eager on the CPU)
    against ``torch.optim.SGD(momentum, nesterov, weight_decay)`` on the
    reference: losses, parameters, statistics."""
    params, state = _params()
    batches = [_batch(s) for s in (3, 4, 5)]
    spec = OptimizerSpec("momentum", SGD["lr"], momentum=SGD["momentum"],
                         weight_decay=SGD["weight_decay"], nesterov=True)
    ts = train_state_from(params, state, spec, 0, torch.device("cpu"))
    step = make_train_step(_program(impl))
    losses = [float(step(ts, x, y)["loss"]) for x, y in batches]
    want = ref.train(params, state, batches, _strides(), SGD, dtype=F64)
    np.testing.assert_allclose(losses, want["losses"], rtol=1e-10)
    got = ref.leaves(ts.params)
    for k, p in want["params"].items():
        torch.testing.assert_close(got[k].detach(), p, rtol=1e-9,
                                   atol=1e-12, msg=k)
    got_s = ref.leaves(ts.model_state)
    for k, s in want["state"].items():
        torch.testing.assert_close(got_s[k], s, rtol=1e-10, atol=1e-12,
                                   msg=k)


def _subset_loop(x_nctv, a_w, a_b, b_w, b_b, base):
    """The reference's per-subset loop up to the aggregation: the adaptive
    graphs and each subset's ``x ._V A_hat`` in ``(N, C, T, V)``."""
    n, c, t, v = x_nctv.shape
    graphs, aggs = [], []
    for i in range(base.shape[0]):
        a1 = ref._conv(x_nctv, a_w[i], a_b[i], ref._keep).permute(
            0, 3, 1, 2).contiguous().view(n, v, -1)
        a2 = ref._conv(x_nctv, b_w[i], b_b[i], ref._keep).view(n, -1, v)
        a1 = torch.softmax(torch.matmul(a1, a2) / a1.size(-1), -2)
        graphs.append(a1)
        aggs.append(torch.matmul(x_nctv.view(n, c * t, v),
                                 a1 + base[i]).view(n, c, t, v))
    return torch.stack(graphs, 1), torch.stack(aggs, 1)


def test_adaptive_ops_against_subset_loop():
    gen = torch.Generator().manual_seed(11)
    k, c_in, ce, nm = 3, 6, 4, 3
    x = torch.randn(V, nm, T, c_in, dtype=F64, generator=gen)
    a_w, b_w = (torch.randn(k, c_in, ce, dtype=F64, generator=gen)
                for _ in range(2))
    a_b, b_b = (torch.randn(k, ce, dtype=F64, generator=gen)
                for _ in range(2))
    base = torch.from_numpy(ref.subsets()).to(F64) + 0.05 * torch.randn(
        k, V, V, dtype=F64, generator=gen)
    inputs = [t.clone().requires_grad_(True)
              for t in (x, a_w, a_b, b_w, b_b)]
    xg, awg, abg, bwg, bbg = inputs
    w = torch.cat([torch.cat(list(awg), 1), torch.cat(list(bwg), 1)], 1)
    b = torch.cat([abg.reshape(-1), bbg.reshape(-1)])
    c = ag.adaptive_graph(xg, w, b, k)
    z = ag.sample_aggregate(xg, c + base)

    rin = [t.clone().requires_grad_(True) for t in (x, a_w, a_b, b_w, b_b)]
    want_c, want_agg = _subset_loop(rin[0].permute(1, 3, 2, 0).contiguous(), *rin[1:],
                                    base)
    torch.testing.assert_close(c, want_c, rtol=1e-10, atol=1e-14)
    got_agg = z.reshape(V, nm, T, k, c_in).permute(1, 3, 4, 2, 0)
    torch.testing.assert_close(got_agg, want_agg, rtol=1e-10, atol=1e-12)

    gz = torch.randn(got_agg.shape, dtype=F64, generator=gen)
    gc = torch.randn(c.shape, dtype=F64, generator=gen)
    got = torch.autograd.grad((got_agg * gz).sum() + (c * gc).sum(), inputs)
    want = torch.autograd.grad((want_agg * gz).sum() + (want_c * gc).sum(),
                               rin)
    for name, g, w_ in zip(("x", "a_w", "a_b", "b_w", "b_b"), got, want):
        torch.testing.assert_close(g, w_, rtol=1e-9, atol=1e-12, msg=name)


def test_aggregate_plain_versions_round_like_the_kernels():
    """bf16: z and dx rounded once from float32 sums; dA a float32 sum."""
    gen = torch.Generator().manual_seed(12)
    x = torch.randn(V, 2, 5, 4, generator=gen).to(torch.bfloat16)
    a = torch.rand(2, 3, V, V, generator=gen)
    z = ag.sample_aggregate_forward_reference(x, a)
    want = torch.einsum("vntc,nkvw->wntkc", x.double(), a.double())
    assert z.dtype == torch.bfloat16
    torch.testing.assert_close(z.double(), want.reshape(z.shape).to(
        torch.bfloat16).double(), rtol=2 ** -7, atol=1e-6)
    dz = torch.randn(z.shape, generator=gen).to(torch.bfloat16)
    dx, da = ag.sample_aggregate_backward_reference(x, a, dz)
    assert dx.dtype == torch.bfloat16 and da.dtype == torch.float32


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_wrappers_refuse_what_the_kernels_cannot_take(dtype):
    """Off the CPU the wrappers launch the bf16 kernels or raise: no
    silent fall-back to the plain versions."""
    x = torch.empty(V, 2, 5, 8, dtype=dtype, device="meta")
    w, b = torch.empty(8, 12, device="meta"), torch.empty(12, device="meta")
    a = torch.empty(2, 3, V, V, device="meta")
    before = (ag.adaptive_graph_forward.launches,
              ag.sample_aggregate_forward.launches)
    with pytest.raises(ValueError, match="bfloat16 on cuda"):
        ag.adaptive_graph_forward(x, w, b, 3)
    with pytest.raises(ValueError, match="bfloat16 on cuda"):
        ag.sample_aggregate_forward(x, a)
    with pytest.raises(ValueError, match="bfloat16 on cuda"):
        ag.sample_aggregate_backward(x, a, torch.empty_like(x))
    assert before == (ag.adaptive_graph_forward.launches,
                      ag.sample_aggregate_forward.launches)


ENTRY = [("adaptive_graph.cu", name) for name in (
    "agcn_gemm_launch", "agcn_gram_launch", "agcn_gram_bwd_launch",
    "agcn_agg_launch")] + [("affine_relu.cu", name) for name in (
        "affine_relu_fwd_launch", "affine_relu_bwd_launch")]
C_KINDS = {"float": ctypes.c_float, "long": ctypes.c_longlong,
           "int": ctypes.c_int}


@pytest.mark.parametrize("source,name", ENTRY, ids=[n for _, n in ENTRY])
def test_c_signature_matches_argtypes(source, name):
    src = (_build.CSRC / source).read_text()
    sig = re.search(r'extern "C" int %s\((.*?)\)\s*\{' % name, src,
                    re.S).group(1)
    kinds = [ctypes.c_void_p if "*" in p else C_KINDS[p.split()[0]]
             for p in sig.split(",")]
    assert kinds == _build.ENTRY_POINTS[name]


@pytest.mark.parametrize("shortcut", ["proj", "identity", "none"])
def test_affine_relu_plain_versions_against_autograd(shortcut):
    """The tail op's written-out backward against autograd of its forward
    (float64), and the forward against the unit's plain formula."""
    gen = torch.Generator().manual_seed(13)
    a, b = (torch.randn(V, 3, 4, 6, dtype=F64, generator=gen)
            for _ in range(2))
    sa, sb, t = (torch.randn(6, dtype=F64, generator=gen) for _ in range(3))
    b = None if shortcut == "none" else b
    sb = sb if shortcut == "proj" else None
    leaves = [p for p in (a, sa, t, b, sb) if p is not None]
    for p in leaves:
        p.requires_grad_(True)
    out = affine_add_relu(a, sa, t, b, sb)
    v = a * sa + t + (0 if b is None else (b * sb if sb is not None else b))
    torch.testing.assert_close(out, torch.relu(v), rtol=1e-14, atol=1e-14)
    g = torch.randn(out.shape, dtype=F64, generator=gen)
    got = torch.autograd.grad(out, leaves, g)
    want = torch.autograd.grad(torch.relu(v), leaves, g)
    for x, y in zip(got, want):
        torch.testing.assert_close(x, y, rtol=1e-12, atol=1e-12)


def test_config_and_apply_refuse():
    with pytest.raises(ValueError, match="block_impl"):
        AGCNConfig(block_impl="fused")
    with pytest.raises(ValueError, match="dropout"):
        AGCNConfig(dropout_rate=0.5)
    with pytest.raises(ValueError, match="coff_embedding"):
        AGCNConfig(plan=((10, 1),))
    params, state = _params()
    with pytest.raises(ValueError, match="train"):
        _program("ops").apply(params, state, _batch()[0], train=False)


def test_step_marks_every_phase_in_order():
    params, state = _params()
    x, _ = _batch()
    leaves = tree_map(lambda t: t.clone().requires_grad_(True), params)
    profiling.MARK_LOG.clear()
    with profiling.forced_marks(True):
        logits, _ = _program("kernels").apply(leaves, state, x, train=True)
        forward = list(profiling.MARK_LOG)
        logits.sum().backward()
    backward = list(profiling.MARK_LOG)[len(forward):]
    unit = ["adaptive", "spatial", "bn_stats", "tail", "temporal",
            "bn_stats", "tail"]
    assert forward == ["input"] + unit * len(PLAN) + ["head"]
    assert backward.count("adaptive") == len(PLAN)
    assert backward[0] == "tail" and set(backward) == set(unit)
