#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``stgcn_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each printing JSON lines; the first failure ends the run with a
non-zero exit code:

1. device       -- a CUDA device is present; its name and power limit.
2. build        -- nvcc builds the kernel library from the port's ``csrc/``.
3. kernel       -- ``block_eval`` against its plain PyTorch version on the
                   six block shapes of DEFAULT_PLAN at B=64, T=304 (float32
                   tightly, bfloat16 against a float32 oracle), order "post"
                   and masked lengths.
4. serve        -- a full-width ``Predictor`` (DEFAULT_PLAN, distance
                   partitioning, residual, bf16) answers three requests of
                   64-200 variable-length sequences through the kernel; the
                   launch count must be 10 per batch and the answers must
                   agree with the float32 op path.
5. time         -- CUDA-event times of each block's kernel and plain
                   version, of the eval forward, and serving throughput.
6. train_kernel -- the train path's ``spatial_block`` and ``temporal_block``
                   ops, forward and backward kernels, against their plain
                   versions at the shapes of DEFAULT_PLAN's blocks 0-6 at
                   B=64, T=304 (float32 tightly, bfloat16 against a float32
                   oracle), plus the non-residual order, a fixed graph and
                   stride 2.
7. train        -- ``bench.py``'s train step through ``make_train_step``:
                   full-width DEFAULT_PLAN, bf16, dropout 0.5, the hybrid
                   with blocks 0-6 fused, Adam 1e-3, B=64, T=304; 28 op
                   launches a step; finite loss and weights, moving BN
                   statistics; the float32 kernel path's gradient against
                   the float32 op path's; the loss falling on a repeated
                   batch.
8. train_time   -- CUDA-event times of the train step (kernel path and op
                   path) and of each fused block's ops, forward and
                   backward, beside their plain versions and bounds.
9. kernels      -- one line per kernel with its launches, error, times and
                   bound.

The last line is ``{"ok": true, "device": {...}}``.  Imports nothing of JAX.
"""

from __future__ import annotations

import copy
import dataclasses
import json
import signal
import subprocess
import sys
import time

import numpy as np

SEED = 0
DEADLINE_S = 900
B, T, V = 64, 304, 25
# Published dense peaks (NVIDIA data sheets): bf16 tensor FLOP/s, HBM B/s.
PEAKS = {"H100 SXM": (989e12, 3.35e12), "H100 PCIe": (756e12, 2.0e12)}
# f32: elementwise, both sides summing in float32 in other orders.
F32_RTOL, F32_ATOL = 1e-4, 1e-4
# bf16 kernel against the float32 oracle: max error within 2% of the
# output's range (bf16 keeps 8 bits; h, y_k and z are rounded on the way).
BF16_REL = 2e-2
# f32 whole-network check and bf16 serving check
FORWARD_REL = 1e-3
ARGMAX_AGREEMENT = 0.99


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def _deadline(signum, frame):
    raise TimeoutError(f"chip_smoke.py passed its {DEADLINE_S} s deadline")


def card_peaks(name: str) -> tuple[str, float, float]:
    part = "H100 PCIe" if "PCIe" in name else "H100 SXM"
    return (part, *PEAKS[part])


def cuda_time_ms(fn, reps: int = 3, warmup: int = 1) -> float:
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def block_cost(n, t, c_in, c_out, stride, k=2, gamma=9, itemsize=2):
    """(operations, bytes) one block must do and move: each input read once,
    each output written once."""
    t_out = (t - 1) // stride + 1
    ops = (2 * n * t * V * c_in * k * c_out + 2 * n * t * k * V * V * c_out
           + 2 * n * t_out * V * gamma * c_out * c_out)
    if c_in != c_out or stride != 1:
        ops += 2 * n * t_out * V * c_in * c_out
    weights = (c_in * k * c_out + k * c_out + k * V * V + gamma * c_out ** 2
               + c_out + (c_in * c_out + c_out if c_in != c_out or stride != 1
                          else 0))
    data = (n * t * V * c_in + n * t_out * V * c_out + weights) * itemsize
    return ops, data + 4 * (2 * c_in + 3 * c_out)  # + f32 affines and bias


def random_block_args(gen, c_in, c_out, proj, device):
    import torch

    def r(*shape, scale=1.0, loc=0.0):
        return torch.randn(*shape, generator=gen, device=device) * scale + loc

    kw = dict(s1=r(c_in, scale=0.3, loc=1.0), t1=r(c_in, scale=0.2),
              w=r(c_in, 2, c_out, scale=c_in ** -0.5),
              b=r(2, c_out, scale=0.1),
              a=torch.rand(2, V, V, generator=gen, device=device) * 0.3,
              wt=r(9, c_out, c_out, scale=(9 * c_out) ** -0.5),
              bt=r(c_out, scale=0.1), s2=r(c_out, scale=0.3, loc=1.0),
              t2=r(c_out, scale=0.2))
    if proj:
        kw.update(wr=r(c_in, c_out, scale=c_in ** -0.5),
                  br=r(c_out, scale=0.1))
    return kw


def randomize_batchnorm(model, gen) -> None:
    """Running statistics and affines away from their fresh values, which
    would hide a wrong fold."""
    import torch

    with torch.no_grad():
        for block in model.conv:
            for bn in (block.batch_n, block.batch_n_2):
                c = bn.weight.shape[0]
                bn.running_mean.copy_(torch.randn(c, generator=gen) * 0.3)
                bn.running_var.copy_(torch.rand(c, generator=gen) * 1.5 + 0.5)
                bn.weight.copy_(1.0 + torch.randn(c, generator=gen) * 0.2)
                bn.bias.copy_(torch.randn(c, generator=gen) * 0.2)


# ---- the train path --------------------------------------------------------
# bench.py:65-66 runs blocks 0-6 of DEFAULT_PLAN fused on the TPU
FUSED_BLOCKS = (0, 1, 2, 3, 4, 5, 6)
TRAIN_STEPS = 3      # full-width steps driven on the main path
FALL_STEPS = 10      # steps of the falling-loss check
# float32 train kernels against their plain versions: max error within
# 1e-4 of the largest |value| (sums of up to 5e5 terms in other orders)
F32_TRAIN_REL = 1e-4
# float32 kernel path's full gradient against the float32 op path's: max
# error within 1e-2 of the largest gradient.  Ten blocks of BatchNorm over
# 4x64 frames amplify float32 rounding: each float32 path lies ~4e-4 of the
# largest gradient from the float64 op path on the CPU, and the kernels and
# cuDNN round differently.  The sharper check: the kernel path is no
# further from the float64 op path than GRAD_VS_F64 times the float32 op
# path is.
GRAD_REL = 1e-2
GRAD_VS_F64 = 3.0


def fused_block_shapes() -> list[tuple[int, int, int, int]]:
    """``(c_in, c_out, stride, t_in)`` of DEFAULT_PLAN's fused blocks."""
    from stgcn_tpu_torch.models.stgcn import DEFAULT_PLAN

    shapes, c_prev, t = [], 2, T
    for i, (c_out, stride) in enumerate(DEFAULT_PLAN):
        if i in FUSED_BLOCKS:
            shapes.append((c_prev, c_out, stride, t))
        c_prev, t = c_out, (t - 1) // stride + 1
    return shapes


def spatial_cost(n, t, c_in, c_out, k=2, itemsize=2):
    """((ops, bytes) forward, (ops, bytes) backward) of the spatial op, the
    operations counted as the JAX CostEstimates do
    (stgcn_tpu/kernels/block_fused.py:641-644, :715-719), need_da on."""
    m = n * t
    stage1 = 2 * m * V * c_in * k * c_out
    agg = 2 * m * k * V * V * c_out
    weights = (c_in * k * c_out + k * c_out + k * V * V) * itemsize
    weights += 2 * c_in * 4                     # f32 affine
    x_b, z_b = m * V * c_in * itemsize, m * V * c_out * itemsize
    return ((stage1 + agg, x_b + z_b + weights),
            (3 * stage1 + 2 * agg, 2 * x_b + z_b + 2 * weights))


def temporal_cost(n, t, c, stride, gamma=9, itemsize=2):
    """((ops, bytes) forward, (ops, bytes) backward) of the temporal op
    (block_fused.py:1066-1069, :1126-1129)."""
    t_out = (t - 1) // stride + 1
    ops = 2 * n * t_out * V * gamma * c * c
    weights = gamma * c * c * itemsize + 3 * c * 4
    z_b, u_b = n * t * V * c * itemsize, n * t_out * V * c * itemsize
    return (ops, z_b + u_b + weights), (2 * ops, 2 * z_b + u_b + 2 * weights)


def random_spatial(gen, n, t, c_in, c_out, dev):
    import torch

    def r(*shape, scale=1.0, loc=0.0):
        return torch.randn(*shape, generator=gen, device=dev) * scale + loc

    return dict(x=r(V, n, t, c_in), s1=r(c_in, scale=0.3, loc=1.0),
                t1=r(c_in, scale=0.2),
                w=r(c_in, 2, c_out, scale=c_in ** -0.5),
                b=r(2, c_out, scale=0.1),
                a=torch.rand(2, V, V, generator=gen, device=dev) * 0.3)


def random_temporal(gen, n, t, c, dev):
    import torch

    def r(*shape, scale=1.0, loc=0.0):
        return torch.randn(*shape, generator=gen, device=dev) * scale + loc

    return dict(z=r(V, n, t, c), s2=r(c, scale=0.3, loc=1.0),
                t2=r(c, scale=0.2), wt=r(9, c, c, scale=(9 * c) ** -0.5),
                bt=r(c, scale=0.1))


def as_dtype(kw: dict, dt, acts=("x", "z", "w", "b", "a", "wt")) -> dict:
    """Activations and weights in ``dt``; affines and the temporal bias stay
    float32, as the train path passes them."""
    return {k: v.to(dt) if k in acts else v for k, v in kw.items()}


def check_op(name, direction, got, want, dt, **case) -> dict:
    """Max error of each output against the oracle, within the stated
    tolerance; raises if any is outside it."""
    import torch

    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    rel = F32_TRAIN_REL if dt == torch.float32 else BF16_REL
    worst = {"max_abs_err": 0.0, "max_rel_err": 0.0}
    for g, w in zip(got, want):
        err = (g.float() - w.float()).abs().max().item()
        scale = w.float().abs().max().item()
        if err > rel * max(scale, 1e-30):
            raise AssertionError(f"{name} {direction} disagrees with its "
                                 f"plain version: {case}, {err} > {rel} * "
                                 f"{scale}")
        worst["max_abs_err"] = max(worst["max_abs_err"], err)
        worst["max_rel_err"] = max(worst["max_rel_err"],
                                   err / max(scale, 1e-30))
    emit("train_kernel", op=name, direction=direction,
         dtype=str(dt).removeprefix("torch."), **case, **worst,
         tolerance=f"max_abs_err <= {rel} * max|oracle| per output", ok=True)
    return worst


def train_kernel_phase(dev, gen) -> dict:
    """Each train op's forward and backward kernel against its plain
    version; returns the largest bf16 errors per (op, direction)."""
    import torch

    from stgcn_tpu_torch.kernels import spatial_block as sb
    from stgcn_tpu_torch.kernels import temporal_block as tb

    worst: dict = {}

    def keep(key, res, dt):
        if dt == torch.bfloat16:
            cur = worst.setdefault(key, {"max_abs_err": 0.0,
                                         "max_rel_err": 0.0})
            for k in cur:
                cur[k] = max(cur[k], res[k])

    def spatial_case(ci, co, t, dt, relu1=True, need_da=True):
        kw = random_spatial(gen, B, t, ci, co, dev)
        k_in = as_dtype(kw, dt)
        oracle_in = {k: v.float() for k, v in k_in.items()}
        g = torch.randn(V, B, t, co, generator=gen, device=dev).to(dt)
        flags = dict(relu1=relu1)
        z = sb.spatial_block_forward(**k_in, **flags)
        grads = sb.spatial_block_backward(k_in["x"], g, **{
            k: k_in[k] for k in ("s1", "t1", "w", "b", "a")}, **flags,
            need_da=need_da)
        torch.cuda.synchronize()
        z_ref = sb.spatial_block_forward_reference(**oracle_in, **flags)
        g_ref = sb.spatial_block_backward_reference(
            oracle_in["x"], g.float(), **{
                k: oracle_in[k] for k in ("s1", "t1", "w", "b", "a")},
            **flags, need_da=need_da)
        case = dict(c_in=ci, c_out=co, t_in=t, relu1=relu1, need_da=need_da)
        keep(("spatial_block", "forward"),
             check_op("spatial_block", "forward", z, z_ref, dt, **case), dt)
        keep(("spatial_block", "backward"),
             check_op("spatial_block", "backward", grads, g_ref, dt, **case),
             dt)

    def temporal_case(c, stride, t, dt, relu2=True):
        kw = random_temporal(gen, B, t, c, dev)
        if not relu2:       # the non-residual order's identity affine
            kw["s2"], kw["t2"] = torch.ones_like(kw["s2"]), torch.zeros_like(
                kw["t2"])
        k_in = as_dtype(kw, dt)
        oracle_in = {k: v.float() for k, v in k_in.items()}
        flags = dict(stride=stride, relu2=relu2)
        u = tb.temporal_block_forward(**k_in, **flags)
        g = torch.randn(u.shape, generator=gen, device=dev).to(dt)
        grads = tb.temporal_block_backward(k_in["z"], g, **{
            k: k_in[k] for k in ("s2", "t2", "wt", "bt")}, **flags)
        torch.cuda.synchronize()
        u_ref = tb.temporal_block_forward_reference(**oracle_in, **flags)
        g_ref = tb.temporal_block_backward_reference(
            oracle_in["z"], g.float(), **{
                k: oracle_in[k] for k in ("s2", "t2", "wt", "bt")}, **flags)
        case = dict(c=c, stride=stride, t_in=t, relu2=relu2)
        keep(("temporal_block", "forward"),
             check_op("temporal_block", "forward", u, u_ref, dt, **case), dt)
        keep(("temporal_block", "backward"),
             check_op("temporal_block", "backward", grads, g_ref, dt,
                      **case), dt)

    shapes = sorted(set(fused_block_shapes()))
    for dt in (torch.bfloat16, torch.float32):
        for ci, co, stride, t in shapes:
            spatial_case(ci, co, t, dt)
            temporal_case(co, stride, t, dt)
        spatial_case(64, 64, T, dt, relu1=False)        # non-residual order
        spatial_case(64, 64, T, dt, need_da=False)      # fixed graph
        temporal_case(128, 2, T, dt, relu2=False)       # identity affine
    return worst


def train_phase(dev, gen, peak_flops, peak_bytes) -> dict:
    """The main path (bench.py's train step) and its checks, then the train
    step and per-op times.  Returns what the kernels line needs."""
    import torch

    from stgcn_tpu_torch.graph.adjacency import Strategy
    from stgcn_tpu_torch.kernels import spatial_block as sb
    from stgcn_tpu_torch.kernels import temporal_block as tb
    from stgcn_tpu_torch.models.convert import (
        params_from_jax,
        params_to_numpy,
    )
    from stgcn_tpu_torch.models.stgcn import DEFAULT_PLAN, STGCN, STGCNConfig
    from stgcn_tpu_torch.training.loop import make_train_step
    from stgcn_tpu_torch.training.metrics import cross_entropy
    from stgcn_tpu_torch.training.optimizers import adam
    from stgcn_tpu_torch.training.train_state import (
        create_train_state,
        train_state_from,
    )

    cfg = STGCNConfig(plan=DEFAULT_PLAN, strategy=Strategy.DISTANCE, d=1,
                      residual=True, dropout_rate=0.5,
                      compute_dtype=torch.bfloat16, block_impl="hybrid",
                      fused_blocks=FUSED_BLOCKS)
    model = STGCN(cfg, seed=SEED)
    ts = create_train_state(model, adam(1e-3), seed=SEED)
    state0 = [{k: v["mean"].clone() for k, v in b.items()}
              for b in ts.model_state["blocks"]]
    x = torch.randn(B, T, V, 2, generator=gen, device=dev)
    y = torch.randint(0, cfg.num_classes, (B,), generator=gen, device=dev)
    step = make_train_step(model)
    counters = {"spatial_block.forward": sb.spatial_block_forward,
                "spatial_block.backward": sb.spatial_block_backward,
                "temporal_block.forward": tb.temporal_block_forward,
                "temporal_block.backward": tb.temporal_block_backward}

    # ---- the main path: counts set to 0 just before, read just after ----
    for fn in counters.values():
        fn.launches = 0
    start = time.perf_counter()
    losses = [float(step(ts, x, y)["loss"]) for _ in range(TRAIN_STEPS)]
    torch.cuda.synchronize()
    seconds = time.perf_counter() - start
    launches = {name: fn.launches for name, fn in counters.items()}

    per_step = len(FUSED_BLOCKS)
    finite = all(np.isfinite(losses)) and all(
        bool(torch.isfinite(p).all()) for p in ts.leaves())
    moved = all(not torch.equal(b[k]["mean"], s0[k])
                for b, s0 in zip(ts.model_state["blocks"], state0)
                for k in ("bn1", "bn2"))
    ok = finite and moved and all(
        n == per_step * TRAIN_STEPS for n in launches.values())
    emit("train", steps=TRAIN_STEPS, losses=losses, seconds=seconds,
         launches=launches, launches_per_step={
             k: v / TRAIN_STEPS for k, v in launches.items()},
         finite=finite, bn_statistics_moved=moved, batch=B, frames=T,
         dtype="bfloat16", fused_blocks=list(FUSED_BLOCKS), ok=ok)
    if not ok:
        raise AssertionError("the train step did not run 7 launches of each "
                             "op a step, or gave non-finite values, or left "
                             "the BN statistics where they were")

    # ---- float32 kernel path against the float32 op path, one gradient --
    cfg32 = dataclasses.replace(cfg, compute_dtype=None, dropout_rate=0.0)
    xs = torch.randn(4, 64, V, 2, generator=gen, device=dev)
    ys = torch.randint(0, cfg.num_classes, (4,), generator=gen, device=dev)
    # the same float32 weights for the three: as drawn, and cast to float64
    init = [params_to_numpy(t) for t in STGCN(cfg32).init_params(SEED)]
    grads = {}
    for impl in ("hybrid", "ops", "ops64"):
        dt = torch.float64 if impl == "ops64" else torch.float32
        m = STGCN(dataclasses.replace(
            cfg32, block_impl=impl.removesuffix("64"), dtype=dt)).to(dev)
        ts1 = train_state_from(*params_from_jax(*init, dtype=dt), adam(),
                               SEED, dev)
        logits, _ = m.apply(ts1.params, ts1.model_state, xs.to(dt),
                            train=True)
        grads[impl] = torch.autograd.grad(cross_entropy(logits, ys),
                                          ts1.leaves())

    def grad_diff(a, b):
        return max((p.double() - q.double()).abs().max().item()
                   for p, q in zip(grads[a], grads[b]))

    grad_err = grad_diff("hybrid", "ops")
    grad_scale = max(b.abs().max().item() for b in grads["ops"])
    kernel_vs_f64, ops_vs_f64 = (grad_diff("hybrid", "ops64"),
                                 grad_diff("ops", "ops64"))

    # ---- the loss falls on a repeated batch, dropout off ----------------
    m_fall = STGCN(dataclasses.replace(cfg, dropout_rate=0.0), seed=SEED)
    ts_fall = create_train_state(m_fall, adam(1e-3), seed=SEED)
    step_fall = make_train_step(m_fall)
    fall = [float(step_fall(ts_fall, x, y)["loss"])
            for _ in range(FALL_STEPS)]
    ok = (grad_err <= GRAD_REL * grad_scale
          and kernel_vs_f64 <= GRAD_VS_F64 * ops_vs_f64
          and fall[-1] < fall[0])
    emit("train", f32_hybrid_vs_ops_grad_max_abs_err=grad_err,
         f32_ops_grad_max_abs=grad_scale,
         f32_hybrid_vs_f64_ops_grad_max_abs_err=kernel_vs_f64,
         f32_ops_vs_f64_ops_grad_max_abs_err=ops_vs_f64,
         tolerance=(f"max_abs_err <= {GRAD_REL} * max|ops gradient|, and "
                    f"hybrid vs f64 <= {GRAD_VS_F64} * f32 ops vs f64"),
         repeated_batch_losses=fall, ok=ok)
    if not ok:
        raise AssertionError("the float32 kernel path's gradient disagrees "
                             "with the op path's, or the loss did not fall")

    # ---- train_time: steps, then each fused block's ops -----------------
    step_ms = cuda_time_ms(lambda: step(ts, x, y), reps=3)
    m_ops = STGCN(dataclasses.replace(cfg, block_impl="ops"), seed=SEED)
    ts_ops = create_train_state(m_ops, adam(1e-3), seed=SEED)
    step_ops = make_train_step(m_ops)
    ops_step_ms = cuda_time_ms(lambda: step_ops(ts_ops, x, y), reps=3)
    del ts_ops, ts_fall
    totals: dict = {}
    for i, (ci, co, stride, t) in zip(FUSED_BLOCKS, fused_block_shapes()):
        sp = as_dtype(random_spatial(gen, B, t, ci, co, dev), torch.bfloat16)
        tp = as_dtype(random_temporal(gen, B, t, co, dev), torch.bfloat16)
        gz = torch.randn(V, B, t, co, generator=gen,
                         device=dev).to(torch.bfloat16)
        t_out = (t - 1) // stride + 1
        gu = torch.randn(V, B, t_out, co, generator=gen,
                         device=dev).to(torch.bfloat16)
        sp_rest = {k: sp[k] for k in ("s1", "t1", "w", "b", "a")}
        tp_rest = {k: tp[k] for k in ("s2", "t2", "wt", "bt")}
        fn = {
            ("spatial_block", "forward"): (
                lambda: sb.spatial_block_forward(**sp, relu1=True),
                lambda: sb.spatial_block_forward_reference(**sp, relu1=True)),
            ("spatial_block", "backward"): (
                lambda: sb.spatial_block_backward(sp["x"], gz, **sp_rest,
                                                  relu1=True),
                lambda: sb.spatial_block_backward_reference(
                    sp["x"], gz, **sp_rest, relu1=True)),
            ("temporal_block", "forward"): (
                lambda: tb.temporal_block_forward(**tp, stride=stride,
                                                  relu2=True),
                lambda: tb.temporal_block_forward_reference(
                    **tp, stride=stride, relu2=True)),
            ("temporal_block", "backward"): (
                lambda: tb.temporal_block_backward(tp["z"], gu, **tp_rest,
                                                   stride=stride, relu2=True),
                lambda: tb.temporal_block_backward_reference(
                    tp["z"], gu, **tp_rest, stride=stride, relu2=True)),
        }
        sp_cost = spatial_cost(B, t, ci, co)
        tp_cost = temporal_cost(B, t, co, stride)
        costs = {("spatial_block", "forward"): sp_cost[0],
                 ("spatial_block", "backward"): sp_cost[1],
                 ("temporal_block", "forward"): tp_cost[0],
                 ("temporal_block", "backward"): tp_cost[1]}
        row = {}
        for key, (kernel, plain) in fn.items():
            ms = cuda_time_ms(kernel)
            plain_ms = cuda_time_ms(plain)
            ops, nbytes = costs[key]
            t_ops, t_bytes = ops / peak_flops * 1e3, nbytes / peak_bytes * 1e3
            bound = max(t_ops, t_bytes)
            by = "operations" if t_ops >= t_bytes else "bytes"
            row[".".join(key)] = dict(ms=ms, plain_ms=plain_ms,
                                      bound_ms=bound, bound_by=by,
                                      gflop=ops / 1e9, mbytes=nbytes / 1e6)
            tot = totals.setdefault(key, dict(ms=0.0, plain_ms=0.0,
                                              bound_ms=0.0, ops_ms=0.0,
                                              bytes_ms=0.0))
            for name, val in (("ms", ms), ("plain_ms", plain_ms),
                              ("bound_ms", bound), ("ops_ms", t_ops),
                              ("bytes_ms", t_bytes)):
                tot[name] += val
        emit("train_time", block=i, c_in=ci, c_out=co, stride=stride,
             t_in=t, **row)
    emit("train_time", train_step_ms=step_ms,
         train_sequences_per_s=B / step_ms * 1e3,
         op_path_train_step_ms=ops_step_ms,
         op_path_train_sequences_per_s=B / ops_step_ms * 1e3,
         kernel_ms_per_step={".".join(k): v["ms"] for k, v in totals.items()},
         plain_ms_per_step={".".join(k): v["plain_ms"]
                            for k, v in totals.items()},
         bound_ms_per_step={".".join(k): v["bound_ms"]
                            for k, v in totals.items()},
         batch=B, frames=T, dtype="bfloat16")
    return {"launches": launches, "totals": totals}


def bound_kind(ops_ms: float, bytes_ms: float) -> str:
    return "operations" if ops_ms >= bytes_ms else "bytes"


def train_kernel_entry(name, source, replaces, launches, errors,
                       totals) -> dict:
    """The kernels-line entry of one train op: forward plus backward per
    step, with each direction beside it.  ``bound_by`` says which of the
    summed operation and byte times is larger."""
    parts = {}
    for direction in ("forward", "backward"):
        tot = totals[(name, direction)]
        parts[direction] = {
            "launches": launches[f"{name}.{direction}"],
            **errors[(name, direction)],
            "ms": tot["ms"], "plain_ms": tot["plain_ms"],
            "bound_ms": tot["bound_ms"],
            "bound_by": bound_kind(tot["ops_ms"], tot["bytes_ms"])}
    both = [totals[(name, d)] for d in ("forward", "backward")]
    return {
        "name": name, "route": "cuda", "source": source,
        "replaces": replaces,
        "launches": sum(p["launches"] for p in parts.values()),
        "max_abs_err": max(p["max_abs_err"] for p in parts.values()),
        "max_rel_err": max(p["max_rel_err"] for p in parts.values()),
        "ms": sum(p["ms"] for p in parts.values()),
        "plain_ms": sum(p["plain_ms"] for p in parts.values()),
        "bound_ms": sum(p["bound_ms"] for p in parts.values()),
        "bound_by": bound_kind(sum(t["ops_ms"] for t in both),
                               sum(t["bytes_ms"] for t in both)),
        # no single PyTorch call computes the affine(+ReLU) with the graph
        # conv, or with the temporal conv, and their gradients
        "library_ms": None,
        **parts,
    }


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke.py needs a CUDA device", file=sys.stderr)
        return 1
    signal.signal(signal.SIGALRM, _deadline)
    signal.alarm(DEADLINE_S)

    from stgcn_tpu_torch.graph.adjacency import Strategy
    from stgcn_tpu_torch.kernels import _build
    from stgcn_tpu_torch.kernels.block_eval import (
        block_eval,
        block_eval_reference,
        plan_tiles,
    )
    from stgcn_tpu_torch.models.fused import (
        fused_block_args,
        fused_eval_forward,
    )
    from stgcn_tpu_torch.models.stgcn import DEFAULT_PLAN, STGCN, STGCNConfig
    from stgcn_tpu_torch.serving import Predictor

    run_start = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")

    # ---- 1. device ---------------------------------------------------------
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(smi, flush=True)
    part, peak_flops, peak_bytes = card_peaks(name)
    emit("device", name=name, count=torch.cuda.device_count(),
         nvidia_smi=smi, peaks_from=part, torch=torch.__version__,
         cuda=torch.version.cuda)

    # ---- 2. build ----------------------------------------------------------
    lib_path, build_s = _build.build()
    _build.load_library()
    emit("build", library=str(lib_path.relative_to(_build.REPO_ROOT)),
         seconds=build_s)

    # ---- 3. kernel against its plain version -------------------------------
    # the six block shapes of DEFAULT_PLAN, with the frames the main path
    # gives each: (c_in, c_out, stride, shortcut, t_in)
    shapes = [(2, 64, 1, "proj", T), (64, 64, 1, "id", T),
              (64, 128, 2, "proj", T), (128, 128, 1, "id", T // 2),
              (128, 256, 2, "proj", T // 2), (256, 256, 1, "id", T // 4)]
    cases = [(ci, co, s, sc, t, "pre", dt) for dt in (torch.bfloat16,
                                                      torch.float32)
             for ci, co, s, sc, t in shapes]
    cases += [(64, 128, 2, "none", T, "post", torch.bfloat16),
              (64, 128, 2, "none", T, "post", torch.float32)]
    gen = torch.Generator(device=dev).manual_seed(SEED)
    kernel_max_err = 0.0
    for i, (ci, co, s, sc, t, order, dt) in enumerate(
            cases + [(128, 128, 1, "id", T // 2, "pre", torch.bfloat16),
                     (128, 256, 2, "proj", T // 2, "pre", torch.float32)]):
        masked = i >= len(cases)
        kw = random_block_args(gen, ci, co, sc == "proj", dev)
        x = torch.randn(V, B, t, ci, generator=gen, device=dev).to(dt)
        lengths = torch.randint(1, t + 1, (B,), generator=gen, device=dev)
        flags = dict(stride=s, order=order, shortcut=sc, relu1=order == "pre",
                     lengths=lengths if masked else None)
        out = block_eval(x, **kw, **flags)
        torch.cuda.synchronize()
        oracle = block_eval_reference(x.float(), **kw, **flags)
        err = (out.float() - oracle).abs().max().item()
        scale = oracle.abs().max().item()
        if dt == torch.float32:
            ok = torch.allclose(out, oracle, rtol=F32_RTOL, atol=F32_ATOL)
            tol = f"allclose rtol={F32_RTOL} atol={F32_ATOL}"
        else:
            ok = err <= BF16_REL * scale
            tol = f"max_abs_err <= {BF16_REL} * max|oracle|"
        emit("kernel", c_in=ci, c_out=co, stride=s, t_in=t, shortcut=sc,
             order=order, dtype=str(dt).removeprefix("torch."),
             masked=masked,
             tiles=plan_tiles(V, ci, co, s, 9, x.element_size())[:2],
             max_abs_err=err, max_abs_oracle=scale, tolerance=tol, ok=ok)
        if not ok:
            raise AssertionError(f"block_eval disagrees with its plain "
                                 f"version: {ci}->{co} s{s} {sc} {dt}")
        if dt == torch.bfloat16:
            kernel_max_err = max(kernel_max_err, err)

    # ---- 4. serve: the port's main path ------------------------------------
    cfg = STGCNConfig(plan=DEFAULT_PLAN, strategy=Strategy.DISTANCE, d=1,
                      residual=True, compute_dtype=torch.bfloat16)
    model = STGCN(cfg, seed=SEED)
    randomize_batchnorm(model, torch.Generator().manual_seed(SEED))
    model32 = copy.deepcopy(model)
    model32.config = dataclasses.replace(cfg, compute_dtype=None)
    buckets = (152, T)
    pred = Predictor(model, buckets=buckets, max_batch=B)
    oracle_pred = Predictor(model32, buckets=buckets, max_batch=B,
                            use_fused=False)
    pred.warmup()
    rng = np.random.default_rng(SEED)
    requests = []
    for n in (64, 131, 200):
        lens = rng.integers(40, T + 1, n)
        requests.append([rng.normal(0, 1, (int(t), V, 2)).astype(np.float32)
                         for t in lens])

    block_eval.launches = 0
    answers, batches = [], 0
    serve_start = time.perf_counter()
    for seqs in requests:
        before = block_eval.launches
        answers.append(pred.predict(seqs))
        per_bucket: dict[int, int] = {}
        for seq in seqs:
            bk = next(b for b in buckets if seq.shape[0] <= b)
            per_bucket[bk] = per_bucket.get(bk, 0) + 1
        n_batches = sum(-(-c // B) for c in per_bucket.values())
        batches += n_batches
        if block_eval.launches - before != 10 * n_batches:
            raise AssertionError(
                f"expected {10 * n_batches} block_eval launches for "
                f"{n_batches} batches, saw {block_eval.launches - before}")
    serve_s = time.perf_counter() - serve_start
    main_path_launches = block_eval.launches

    agree = total = 0
    max_prob_diff = 0.0
    for seqs, ans in zip(requests, answers):
        if ans.probs.shape != (len(seqs), 6) or not np.isfinite(
                ans.probs).all():
            raise AssertionError("serving output has the wrong shape or is "
                                 "not finite")
        ref = oracle_pred.predict(seqs)
        agree += int((ref.labels == ans.labels).sum())
        total += len(seqs)
        max_prob_diff = max(max_prob_diff,
                            float(np.abs(ref.probs - ans.probs).max()))
    agreement = agree / total
    # the float32 kernel chain against the float32 op path, on a small input
    xs = torch.randn(4, 64, V, 2, generator=gen, device=dev)
    with torch.inference_mode():
        fused32 = fused_eval_forward(model32, xs)
        ops32 = model32(xs)
    forward_err = (fused32 - ops32).abs().max().item()
    forward_scale = ops32.abs().max().item()
    ok = (agreement >= ARGMAX_AGREEMENT
          and forward_err <= FORWARD_REL * max(forward_scale, 1.0))
    emit("serve", requests=[len(s) for s in requests], batches=batches,
         launches=main_path_launches, launches_per_batch=(
             main_path_launches / batches), seconds=serve_s,
         argmax_agreement_vs_f32_ops=agreement,
         max_abs_prob_diff_vs_f32_ops=max_prob_diff,
         f32_fused_vs_ops_max_abs_err=forward_err,
         f32_ops_max_abs_logit=forward_scale, ok=ok)
    if not ok:
        raise AssertionError("serving answers disagree with the float32 "
                             "op path")

    # ---- 5. time ----------------------------------------------------------
    x = torch.randn(B, T, V, 2, generator=gen, device=dev).to(torch.bfloat16)
    h = x.permute(2, 0, 1, 3).contiguous()
    totals = dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, ops=0, bytes=0)
    bound_by = {}
    c_prev = cfg.c_in
    with torch.inference_mode():
        for i, blk in enumerate(model.conv):
            bp, bs = blk.params_and_state()
            kw = fused_block_args(bp, bs, model.adjacency, residual=True,
                                  stride=blk.stride)
            c_out = cfg.plan[i][0]
            ms = cuda_time_ms(lambda: block_eval(h, **kw))
            plain_ms = cuda_time_ms(lambda: block_eval_reference(h, **kw))
            ops, nbytes = block_cost(B, h.shape[2], c_prev, c_out, blk.stride)
            t_ops, t_bytes = ops / peak_flops * 1e3, nbytes / peak_bytes * 1e3
            bound = max(t_ops, t_bytes)
            by = "operations" if t_ops >= t_bytes else "bytes"
            bound_by[by] = bound_by.get(by, 0) + 1
            emit("time", block=i, c_in=c_prev, c_out=c_out, stride=blk.stride,
                 t_in=h.shape[2], ms=ms, plain_ms=plain_ms, bound_ms=bound,
                 bound_by=by, gflop=ops / 1e9, mbytes=nbytes / 1e6,
                 tflops=ops / ms / 1e9)
            for key, val in (("ms", ms), ("plain_ms", plain_ms),
                             ("bound_ms", bound), ("ops", ops),
                             ("bytes", nbytes)):
                totals[key] += val
            h = block_eval(h, **kw)
            c_prev = c_out
        fwd_ms = cuda_time_ms(lambda: fused_eval_forward(model, x))
        ops_ms = cuda_time_ms(lambda: model(x))
    batches_np = [rng.normal(0, 1, (B, T, V, 2)).astype(np.float32)
                  for _ in range(4)]
    pred.predict_batch(batches_np[0])
    start = time.perf_counter()
    for xb in batches_np:
        pred.predict_batch(xb)
    serial = len(batches_np) * B / (time.perf_counter() - start)
    start = time.perf_counter()
    for _ in pred.predict_stream(batches_np):
        pass
    pipelined = len(batches_np) * B / (time.perf_counter() - start)
    emit("time", eval_forward_ms=fwd_ms, op_path_forward_ms=ops_ms,
         kernel_ms_per_forward=totals["ms"],
         plain_ms_per_forward=totals["plain_ms"],
         bound_ms_per_forward=totals["bound_ms"],
         gflop_per_forward=totals["ops"] / 1e9,
         gbytes_per_forward=totals["bytes"] / 1e9,
         serving_serial_seq_per_s=serial,
         serving_pipelined_seq_per_s=pipelined, batch=B, frames=T,
         dtype="bfloat16", nvidia_smi=smi,
         run_seconds=time.perf_counter() - run_start)

    # ---- 6. train_kernel ----------------------------------------------------
    train_errors = train_kernel_phase(dev, gen)

    # ---- 7. train, 8. train_time: the train path ---------------------------
    train = train_phase(dev, gen, peak_flops, peak_bytes)

    # ---- 9. kernels ---------------------------------------------------------
    kernels = [{
        "name": "block_eval",
        "route": "cuda",
        "source": "stgcn_tpu_torch/kernels/csrc/block_eval.cu",
        "replaces": ("stgcn_tpu/kernels/block_fused.py:61 _mega_kernel "
                     "(fused_block_vm); stgcn_tpu/kernels/block_packed.py:596"
                     " _mega_packed_kernel (fused_block_packed_eval)"),
        "launches": main_path_launches,
        "max_abs_err": kernel_max_err,
        "ms": totals["ms"],
        "plain_ms": totals["plain_ms"],
        "bound_ms": totals["bound_ms"],
        "bound_by": max(bound_by, key=bound_by.get),
        "library_ms": None,
    }, train_kernel_entry(
        "spatial_block", "stgcn_tpu_torch/kernels/csrc/spatial_block.cu",
        "stgcn_tpu/kernels/block_fused.py:596 spatial_block_vm "
        "(_spatial_fwd_kernel :411, _spatial_bwd_kernel :433); "
        "stgcn_tpu/kernels/block_packed.py:188 spatial_block_packed "
        "(_sp_fwd_kernel :81, _sp_bwd_kernel :102)",
        train["launches"], train_errors, train["totals"]),
        train_kernel_entry(
        "temporal_block", "stgcn_tpu_torch/kernels/csrc/temporal_block.cu",
        "stgcn_tpu/kernels/block_fused.py:1013 temporal_block_vm "
        "(_temporal_fwd_kernel :890, _temporal_bwd_kernel :929); "
        "stgcn_tpu/kernels/block_packed.py:464 temporal_block_packed "
        "(_tp_fwd_kernel :365, _tp_bwd_kernel :393)",
        train["launches"], train_errors, train["totals"])]
    print(smi, flush=True)      # the card again, near the end of the output
    print(json.dumps({"kernels": kernels}), flush=True)
    signal.alarm(0)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
