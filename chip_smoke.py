#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``stgcn_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each printing one JSON line; the first failure ends the run with a
non-zero exit code:

1. device  -- a CUDA device is present; its name and power limit.
2. build   -- nvcc builds the kernel library from the port's ``csrc/``.
3. kernel  -- ``block_eval`` against its plain PyTorch version on the six
              block shapes of DEFAULT_PLAN at B=64, T=304 (float32 tightly,
              bfloat16 against a float32 oracle), order "post" and masked
              lengths.
4. serve   -- a full-width ``Predictor`` (DEFAULT_PLAN, distance
              partitioning, residual, bf16) answers three requests of
              64-200 variable-length sequences through the kernel; the
              launch count must be 10 per batch and the answers must agree
              with the float32 op path.
5. time    -- CUDA-event times of each block's kernel and plain version,
              of the eval forward, and serving throughput.
6. kernels -- one line per kernel with its launches, error, times and bound.

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

    # ---- 6. kernels ---------------------------------------------------------
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
    }]
    print(json.dumps({"kernels": kernels}), flush=True)
    signal.alarm(0)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
