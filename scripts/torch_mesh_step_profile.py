#!/usr/bin/env python3
"""Where a one-rank mesh's fused train step spends the time that the
unsharded fused step does not, on one GPU.

    python3 scripts/torch_mesh_step_profile.py [--out mesh_step.jsonl]

bench.py's fused step (full-width DEFAULT_PLAN, distance partitioning,
residual, dropout 0.5, bf16, Adam 1e-3, B=64, T=304) on a one-rank NCCL
mesh (``make_mesh(1, 1, 1)``), in four variants taken in turns (each
twice, in mirrored order):

* ``unsharded``: ``make_train_step`` without a mesh;
* ``mesh``: ``parallel.train.make_sharded_train_step``, what
  ``Trainer(mesh=...)`` runs: the BN statistics all-reduced inside the
  forward (and their gradients in the backward), the gradients, loss and
  accuracy all-reduced after it;
* ``bn_collectives``: the unsharded step with only the BN statistics'
  all-reduces;
* ``grad_all_reduce``: the unsharded step with only the gradient
  all-reduce.

For each: the step's ms by CUDA events, its host ms (a step's wall clock
with a synchronize at the end of the window) and issue ms (the wall clock
of the calls alone, before that synchronize), and from ``torch.profiler``
over three steps the device's busy ms and idle share, the NCCL kernels'
count and device ms, the collectives' count and host ms (the
``c10d::`` rows on the CPU), and the five largest device ops.  Then
one small collective alone: the host and device microseconds of a BN
statistics all-reduce (``(2, 256)`` float32) issued back to back.  One
JSON line each, also written to ``--out``.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

B, T, V = 64, 304, 25
STEPS = 5
PROFILED = 3
VARIANTS = ("unsharded", "mesh", "bn_collectives", "grad_all_reduce")


def make_step(kind: str, model, mesh):
    """The variant's ``step(ts, x, y)``."""
    import torch

    from stgcn_tpu_torch.models.fused import fused_train_forward
    from stgcn_tpu_torch.parallel.collectives import all_reduce_
    from stgcn_tpu_torch.parallel.train import make_sharded_train_step
    from stgcn_tpu_torch.training import metrics as M
    from stgcn_tpu_torch.training.loop import make_train_step
    from stgcn_tpu_torch.training.train_state import step_generator

    if kind == "unsharded":
        return make_train_step(model)
    if kind == "mesh":
        return make_sharded_train_step(model, mesh)
    group = mesh.group("data")

    def step(ts, x, y):
        gen = step_generator(ts.seed, ts.step, x.device)
        ts.optimizer.zero_grad(set_to_none=True)
        logits, new_ms = fused_train_forward(
            model, ts.params, ts.model_state, x, generator=gen,
            bn_group=group if kind == "bn_collectives" else None)
        loss = M.cross_entropy(logits, y)
        loss.backward()
        if kind == "grad_all_reduce":
            with torch.no_grad():
                all_reduce_([p.grad for p in ts.leaves()], group)
        ts.optimizer.step()
        ts.model_state = new_ms
        ts.step += 1
        return {"loss": loss.detach()}

    return step


def profile_rows(prof) -> dict:
    """Device busy ms, NCCL kernels, collectives' host rows and the top
    device ops of a profiled window (totals, not per step)."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    busy = nccl_ms = 0.0
    nccl_kernels = coll_calls = 0
    coll_host_ms = 0.0
    ops = []
    for e in prof.key_averages():
        dev_ms = e.self_device_time_total / 1e3
        if e.device_type == cuda:
            busy += dev_ms
            if "nccl" in e.key.lower():
                nccl_ms += dev_ms
                nccl_kernels += e.count
        else:
            if e.key.startswith("c10d::"):
                coll_calls += e.count
                coll_host_ms += e.cpu_time_total / 1e3
            if dev_ms > 0:
                ops.append((e.key, dev_ms))
    ops.sort(key=lambda r: -r[1])
    return dict(busy=busy, nccl_ms=nccl_ms, nccl_kernels=nccl_kernels,
                coll_calls=coll_calls, coll_host_ms=coll_host_ms,
                top=ops[:5])


def measure(kind: str, mesh, x, y) -> dict:
    import torch

    from stgcn_tpu_torch.graph.adjacency import Strategy
    from stgcn_tpu_torch.models.stgcn import DEFAULT_PLAN, STGCN, STGCNConfig
    from stgcn_tpu_torch.parallel.train import create_sharded_train_state
    from stgcn_tpu_torch.training.optimizers import adam

    cfg = STGCNConfig(plan=DEFAULT_PLAN, strategy=Strategy.DISTANCE, d=1,
                      residual=True, dropout_rate=0.5,
                      compute_dtype=torch.bfloat16, block_impl="fused")
    model = STGCN(cfg)
    ts, _ = create_sharded_train_state(model, adam(1e-3), mesh, seed=0)
    step = make_step(kind, model, mesh)
    for _ in range(2):
        step(ts, x, y)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    for _ in range(STEPS):
        step(ts, x, y)
    end.record()
    issue_ms = (time.perf_counter() - t0) * 1e3 / STEPS
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) * 1e3 / STEPS
    step_ms = start.elapsed_time(end) / STEPS

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(PROFILED):
            step(ts, x, y)
        torch.cuda.synchronize()
    rows = profile_rows(prof)
    busy = rows["busy"] / PROFILED
    return dict(variant=kind, step_ms=step_ms, host_ms=host_ms,
                issue_ms=issue_ms, device_busy_ms_per_step=busy,
                idle_share=1 - busy / step_ms,
                nccl_kernels_per_step=rows["nccl_kernels"] / PROFILED,
                nccl_device_ms_per_step=rows["nccl_ms"] / PROFILED,
                collectives_per_step=rows["coll_calls"] / PROFILED,
                collective_host_ms_per_step=rows["coll_host_ms"] / PROFILED,
                top_ops_ms_per_step=[[k, ms / PROFILED]
                                     for k, ms in rows["top"]])


def small_collective(mesh, reps: int = 200) -> dict:
    """A BN statistics all-reduce issued ``reps`` times back to back: the
    host microseconds a call takes to issue and the device microseconds
    a call adds (CUDA events over the run)."""
    import torch

    from stgcn_tpu_torch.parallel.collectives import all_reduce_sum

    t = torch.ones(2, 256, device=mesh.device)
    group = mesh.group("data")
    for _ in range(10):
        all_reduce_sum(t, group)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    for _ in range(reps):
        all_reduce_sum(t, group)
    end.record()
    host_us = (time.perf_counter() - t0) * 1e6 / reps
    torch.cuda.synchronize()
    return dict(variant="small_all_reduce", shape=[2, 256],
                host_us_per_call=host_us,
                device_us_per_call=start.elapsed_time(end) * 1e3 / reps)


def main() -> int:
    import torch

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out", default="")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    from stgcn_tpu_torch.parallel.mesh import make_mesh

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    torch.backends.cudnn.benchmark = False
    mesh = make_mesh(1, 1, 1)
    gen = torch.Generator(device=mesh.device).manual_seed(0)
    x = torch.randn(B, T, V, 2, generator=gen, device=mesh.device)
    y = torch.randint(0, 6, (B,), generator=gen, device=mesh.device)
    lines = []
    for kind in VARIANTS + VARIANTS[::-1]:
        lines.append(dict(measure(kind, mesh, x, y), nvidia_smi=smi,
                          backend=mesh.backend, batch=B, frames=T,
                          dtype="bfloat16"))
        print(json.dumps(lines[-1]), flush=True)
    lines.append(dict(small_collective(mesh), nvidia_smi=smi,
                      backend=mesh.backend))
    print(json.dumps(lines[-1]), flush=True)
    torch.distributed.destroy_process_group()
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text("".join(json.dumps(v) + "\n"
                                          for v in lines))
    return 0


if __name__ == "__main__":
    sys.exit(main())
