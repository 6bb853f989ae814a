#!/usr/bin/env python3
"""Edges/s and scaling over ranks of the PyTorch/CUDA port (the port's
``scripts/scaling_bench.py``; edges/s is BASELINE.json's north star).

One mode a run; each prints one JSON line a measurement:

``--cuda``
    one card, T=304, bf16, dropout 0.5: step ms, seq/s, ``edges_per_s``
    and ``train_tflops_per_s`` (``stgcn_tpu_torch/utils/profiling.py``
    ``ModelFlops``) of the JAX tool's configuration (the op path) at B=64
    and of the captured fused step (``bench_torch.py``'s) at B=64 and 256
    (``--batches``).  The op path is not run above B=64: its eager peak
    at B=64 was 23,234 MiB (PERF.md section 5), so its B=256 step would
    need about four times that, more than the card's 80 GB.
``--cpu-mesh``, ``--cpu-mesh-weak``
    the sharded op-path step on 1, 2, 4 and 8 gloo ranks on the CPU
    (``parallel/launcher.py``, ``make_mesh(n, 1, 1)``), the JAX tool's toy
    plan ``((16, 1), (32, 2))``, T=64: strong scaling at 32 sequences in
    all, weak at 8 a rank.  The ranks share the host's cores, so the
    absolute numbers mean little; the slope is the collectives' cost.
``--cards N``
    data=1, 2, 4 (up to N) over N cards, one rank a card on NCCL: the
    fused step captured with its collectives (``parallel/fused_dp.py``) at
    T=304, bf16, strong scaling (64 sequences in all) and weak (64 a
    rank).  ``--device cpu`` runs the same ranks on gloo, eagerly.
``--collectives``
    the collectives one eager sharded step issues on a ``--mesh d,t,m``
    (gloo ranks with ``--device cpu``, else one rank a card): count and
    bytes a rank, by kind (all-reduce, all-gather, point-to-point for the
    time halo) and by what they carry, from the counters of
    ``parallel/collectives.py``; ``--production``: DEFAULT_PLAN at B=64,
    T=304 (else the toy plan at B=8, T=32); ``--shard-joints``: joint
    sharding over the model axis.  The JSON has the JAX tool's shape.

The rank modes start their ranks as processes of this script
(``--worker``, given torchrun's variables) that meet at a ``file://``
rendezvous in a temporary directory; a worker also runs under
``torchrun``, which gives it the rendezvous in ``MASTER_ADDR``.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

T = 304
TOY_PLAN = ((16, 1), (32, 2))
CUDA_BATCHES = (64, 256)
OPS_MAX_BATCH = 64       # the op path's largest batch (module docstring)
MESH_SIZES = (1, 2, 4, 8)
CARD_DATA = (1, 2, 4)
CARD_BATCH = 64
# a world of ranks that has not ended by then is killed, every rank of it
RANK_TIMEOUT_S = 300


def timed_steps(run, device, steps: int = 10, warmup: int = 2) -> float:
    """Seconds a step ``run()`` takes after ``warmup`` calls (a captured
    step's warm-up and capture), on the host's clock between
    synchronisations; raises if a loss is not finite."""
    import torch

    def synchronize():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    for _ in range(warmup):
        run()
    synchronize()
    start = time.perf_counter()
    for _ in range(steps):
        m = run()
    synchronize()
    dt = (time.perf_counter() - start) / steps
    if not np.isfinite(float(m["loss"])):
        raise FloatingPointError(f"loss {m['loss']}")
    return dt


def flops_fields(model, batch: int, t: int, dt: float) -> dict:
    from stgcn_tpu_torch.utils.profiling import ModelFlops

    mf = ModelFlops.of(model, batch, t)
    return {"edges_per_step": mf.edges_processed,
            "edges_per_s": mf.edges_per_s(dt),
            "train_tflops_per_s": mf.tflops_per_s(dt)}


def bench_cuda(device: str, batches=CUDA_BATCHES, t: int = T,
               steps: int = 10) -> None:
    import bench_torch
    from stgcn_tpu_torch import resolve_device

    dev = resolve_device(device)
    smi = bench_torch.card(dev)
    rows = ([("ops", b) for b in batches if b <= OPS_MAX_BATCH]
            + [("fused", b) for b in batches])
    for impl, b in rows:
        run = bench_torch.train_case("bf16", b, t, dev, block_impl=impl)
        dt = timed_steps(run, dev, steps=steps)
        print(json.dumps({
            "mode": "cuda_single_card", "block_impl": impl, "batch": b,
            "t": t, "step_ms": dt * 1e3, "sequences_per_s": b / dt,
            **flops_fields(run.model, b, t, dt),
            "captured": run.step.captured, "device": dev.type,
            "card": smi}), flush=True)
        del run
        bench_torch.release()


# ---- the rank modes ----------------------------------------------------

def spawn(worker: list[str], world: int, device: str) -> list[str]:
    """Run ``world`` ranks of ``--worker`` with torchrun's variables;
    returns rank 0's JSON lines, or raises with a failed rank's
    output."""
    with tempfile.TemporaryDirectory() as tmp:
        init = f"file://{tmp}/rendezvous"
        env = {k: v for k, v in os.environ.items()
               if k not in ("MASTER_ADDR", "MASTER_PORT")}
        env.update(WORLD_SIZE=str(world), PYTHONPATH=str(REPO))
        if device == "cpu":
            env.update(CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="1")
        procs = [subprocess.Popen(
            [sys.executable, __file__, "--worker", "--init", init,
             "--device", device, *worker], cwd=REPO,
            env=dict(env, RANK=str(r), LOCAL_RANK=str(r)),
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for r in range(world)]
        deadline = time.monotonic() + RANK_TIMEOUT_S
        outs = []
        try:
            for p in procs:
                outs.append(p.communicate(
                    timeout=max(deadline - time.monotonic(), 1))[0])
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        for r, (p, out) in enumerate(zip(procs, outs)):
            if p.returncode:
                raise RuntimeError(f"rank {r} of {world} exited "
                                   f"{p.returncode}:\n{out[-4000:]}")
    return [line for line in outs[0].splitlines() if line.startswith("{")]


def _join(args) -> tuple:
    """This rank's device and backend, in its world."""
    import torch

    from stgcn_tpu_torch.parallel.launcher import initialize_distributed

    backend = "gloo" if args.device == "cpu" else "nccl"
    if args.device == "cpu":
        torch.set_num_threads(1)
    initialize_distributed(args.init, int(os.environ["WORLD_SIZE"]),
                           int(os.environ["RANK"]), backend=backend,
                           local_rank=int(os.environ.get("LOCAL_RANK", 0)))
    dev = (torch.device("cpu") if args.device == "cpu" else
           torch.device("cuda", torch.cuda.current_device()))
    return dev, backend


def _rank() -> int:
    import torch.distributed as dist

    return dist.get_rank() if dist.is_initialized() else 0


def _barrier() -> None:
    import torch.distributed as dist

    if dist.is_initialized() and dist.get_world_size() > 1:
        dist.barrier()


def mesh_step(model, mesh, batch: int, t: int, *,
              shard_joints: bool = False, capture: bool | None = None):
    """This rank's sharded train step, state and slices of one global
    batch from seed 0."""
    from stgcn_tpu_torch.data.synthetic import random_batch
    from stgcn_tpu_torch.parallel.train import (
        create_sharded_train_state,
        make_sharded_train_step,
        shard_batch,
    )
    from stgcn_tpu_torch.training.optimizers import adam

    ts, _ = create_sharded_train_state(model, adam(1e-3), mesh, seed=0,
                                       shard_joints=shard_joints)
    step = make_sharded_train_step(model, mesh, shard_joints=shard_joints,
                                   capture=capture)
    x, y = random_batch(np.random.default_rng(0), batch, t)
    return step, ts, shard_batch(x, y, mesh, shard_joints=shard_joints)


def worker_cpu_mesh(args, dev, backend) -> None:
    """One world of ``n`` gloo ranks: the toy plan's sharded step."""
    from stgcn_tpu_torch.graph.adjacency import Strategy
    from stgcn_tpu_torch.models.stgcn import STGCN, STGCNConfig
    from stgcn_tpu_torch.parallel.mesh import make_mesh

    n = int(os.environ["WORLD_SIZE"])
    b = args.batch * n if args.weak else args.batch
    model = STGCN(STGCNConfig(plan=TOY_PLAN, strategy=Strategy.DISTANCE,
                              d=1, dropout_rate=0.1, residual=True))
    mesh = make_mesh(n, 1, 1, device=dev)
    step, ts, (x, y) = mesh_step(model, mesh, b, args.frames)
    dt = timed_steps(lambda: step(ts, x, y), dev, steps=args.steps)
    if _rank() == 0:
        print(json.dumps({
            "mode": "cpu_mesh_weak" if args.weak else "cpu_mesh",
            "devices": n, "batch": b, "t": args.frames,
            "step_ms": dt * 1e3,
            **flops_fields(model, b, args.frames, dt),
            "backend": backend}), flush=True)


def worker_cards(args, dev, backend) -> None:
    """One world over the cards: data=1, 2, 4 meshes of its first ranks,
    the fused step strong and weak on each."""
    import bench_torch
    from stgcn_tpu_torch.models.stgcn import STGCN
    from stgcn_tpu_torch.parallel.mesh import make_mesh

    world = int(os.environ["WORLD_SIZE"])
    base = {}
    for n in (d for d in CARD_DATA if d <= world):
        mesh = make_mesh(n, 1, 1, device=dev)
        for mode, per_rank in (("strong", args.batch // n),
                               ("weak", args.batch)):
            if mesh is not None:
                model = STGCN(bench_torch.model_config("bf16"), seed=0)
                step, ts, (x, y) = mesh_step(model, mesh, per_rank * n,
                                             args.frames)
                dt = timed_steps(lambda: step(ts, x, y), dev,
                                 steps=args.steps)
                base.setdefault(mode, dt)
                ratio = dt / base[mode]
                if _rank() == 0:
                    print(json.dumps({
                        "mode": f"cards_{mode}", "ranks": n,
                        "batch": per_rank * n, "batch_per_rank": per_rank,
                        "t": args.frames, "step_ms": dt * 1e3,
                        "sequences_per_s": per_rank * n / dt,
                        **flops_fields(model, per_rank * n, args.frames,
                                       dt),
                        "step_time_vs_1rank": ratio,
                        "scaling_efficiency": (1 / (n * ratio)
                                               if mode == "strong"
                                               else 1 / ratio),
                        "captured": step.captured, "backend": backend,
                        "card": args.card}), flush=True)
                del step, ts, x, y, model
                bench_torch.release()
            _barrier()


def worker_collectives(args, dev, backend) -> None:
    """The collectives of one eager sharded step on ``--mesh``."""
    import torch.distributed as dist

    from stgcn_tpu_torch.graph.adjacency import Strategy
    from stgcn_tpu_torch.models.stgcn import STGCN, STGCNConfig
    from stgcn_tpu_torch.parallel import collectives
    from stgcn_tpu_torch.parallel.mesh import make_mesh

    shape = tuple(int(v) for v in args.mesh.split(","))
    if args.production:
        batch, t = 64, T
        cfg = STGCNConfig(strategy=Strategy.DISTANCE, d=1, dropout_rate=0.5,
                          residual=True)
    else:
        batch, t = 8, 32
        cfg = STGCNConfig(plan=TOY_PLAN, strategy=Strategy.DISTANCE, d=1,
                          dropout_rate=0.1, residual=True)
    model = STGCN(cfg)
    mesh = make_mesh(*shape, device=dev)
    step, ts, (x, y) = mesh_step(model, mesh, batch, t,
                                 shard_joints=args.shard_joints,
                                 capture=False)
    collectives.reset_counts()
    step(ts, x, y)
    counts = collectives.read_counts()
    every = [None] * dist.get_world_size() if dist.is_initialized() else []
    if every:
        dist.all_gather_object(every, counts)
    else:
        every = [counts]
    if _rank() != 0:
        return
    ops, by_what = {}, {}
    for (kind, what), (n, nbytes) in sorted(counts.items()):
        op = ops.setdefault(kind, {"count": 0,
                                   "bytes_per_device_per_step": 0})
        op["count"] += n
        op["bytes_per_device_per_step"] += nbytes
        by_what[f"{kind}/{what}"] = {"count": n,
                                     "bytes_per_device_per_step": nbytes}
    print(json.dumps({
        "mode": ("collective_bytes_production" if args.production
                 else "collective_bytes"),
        "plan_blocks": len(cfg.plan), "mesh": list(shape),
        "shard_joints": args.shard_joints, "batch": batch, "t": t,
        "ops": ops, "by_what": by_what,
        "total_bytes_per_device_per_step": sum(
            o["bytes_per_device_per_step"] for o in ops.values()),
        "total_bytes_by_rank": [sum(b for _, b in c.values())
                                for c in every],
        "param_count": sum(p.numel() for p in ts.leaves()),
        "step": "eager", "backend": backend, "card": args.card}),
        flush=True)


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    modes = ap.add_mutually_exclusive_group(required=True)
    modes.add_argument("--cuda", action="store_true")
    modes.add_argument("--cpu-mesh", action="store_true")
    modes.add_argument("--cpu-mesh-weak", action="store_true")
    modes.add_argument("--cards", type=int, default=0)
    modes.add_argument("--collectives", action="store_true")
    ap.add_argument("--device", default="cuda", help="cuda or cpu")
    ap.add_argument("--batches", default="",
                    help="--cuda: the batch sizes (64,256)")
    ap.add_argument("--ranks", default="",
                    help="--cpu-mesh*: the rank counts (1,2,4,8)")
    ap.add_argument("--frames", type=int, default=0)
    ap.add_argument("--steps", type=int, default=0)
    ap.add_argument("--batch", type=int, default=0,
                    help="--cards: sequences in all (strong) or a rank "
                         "(weak); --cpu-mesh*: in all or a rank")
    ap.add_argument("--production", action="store_true")
    ap.add_argument("--mesh", default="2,2,2")
    ap.add_argument("--shard-joints", action="store_true")
    # the rank side
    ap.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--weak", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--init", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--card", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)

    if args.worker:
        dev, backend = _join(args)
        if args.cards:
            worker_cards(args, dev, backend)
        elif args.collectives:
            worker_collectives(args, dev, backend)
        else:
            worker_cpu_mesh(args, dev, backend)
        _barrier()
        return 0

    if args.cuda:
        batches = ([int(v) for v in args.batches.split(",")]
                   if args.batches else CUDA_BATCHES)
        bench_cuda(args.device, batches, args.frames or T, args.steps or 10)
        return 0
    if args.cpu_mesh or args.cpu_mesh_weak:
        weak = args.cpu_mesh_weak
        sizes = ([int(v) for v in args.ranks.split(",")]
                 if args.ranks else MESH_SIZES)
        base = None
        for n in sizes:
            for line in spawn(
                    ["--cpu-mesh", "--frames", str(args.frames or 64),
                     "--steps", str(args.steps or 5),
                     "--batch", str(args.batch or (8 if weak else 32))]
                    + (["--weak"] if weak else []), n, "cpu"):
                row = json.loads(line)
                base = base or row["step_ms"]
                row["step_time_vs_1dev"] = row["step_ms"] / base
                print(json.dumps(row), flush=True)
        return 0
    extra = []
    if args.device != "cpu":
        import bench_torch
        import torch

        extra = ["--card", bench_torch.card(torch.device("cuda"))]
    if args.cards:
        worker = ["--cards", str(args.cards), "--frames",
                  str(args.frames or T), "--steps", str(args.steps or 10),
                  "--batch", str(args.batch or CARD_BATCH)] + extra
        for line in spawn(worker, args.cards, args.device):
            print(line, flush=True)
        return 0
    world = int(np.prod([int(v) for v in args.mesh.split(",")]))
    worker = (["--collectives", "--mesh", args.mesh] + extra
              + (["--production"] if args.production else [])
              + (["--shard-joints"] if args.shard_joints else []))
    for line in spawn(worker, world, args.device):
        print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
