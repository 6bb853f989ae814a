"""Training data parallel over the cards of one host: one process a card,
the program's sharded train step (``parallel.train.make_sharded_train_step``
on ``make_mesh(data=N)``, over NCCL, captured), each rank on its rows of
every global batch.

Rank 0 is the process the benchmark started: it writes the cell into a
rendezvous directory under ``TMPDIR``, starts the other ranks as processes
of their own, and after the window gathers their readings from files
there, runs the check against the reference over the whole batch, and
reports.  The ranks agree when to close the window: every ``vote_every``
steps they all-reduce, over a gloo group, whether any rank's clock has
passed the window's seconds.  The traffic file adds ``data`` (the ranks)
and ``vote_every`` to the training fields.
"""

from __future__ import annotations

import dataclasses
import datetime
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import torch

from stgcn_bench import harness, training
from stgcn_bench.trace import profiled

WAIT_S = 240            # how long rank 0 waits for a rank's report


def rank_argv(env: dict, cell, seed, seconds, trace, rank, rendezvous):
    return [sys.executable, env["script"], "--workload", cell.name,
            "--seed", str(seed), "--seconds", str(seconds), "--trace",
            str(int(trace)), "--rank", str(rank), "--rendezvous",
            str(rendezvous)]


def run(cell, seed: int, seconds: float, trace: bool, env: dict):
    rank = env.get("rank", 0)
    if rank != 0:
        rdv = Path(env["rendezvous"])
        saved = json.loads((rdv / "cell.json").read_text())
        cell = dataclasses.replace(cell, **{k: saved[k] for k in (
            "config", "traffic", "limits")})
        return rank_main(cell, seed, seconds, trace, env, rdv)
    # NCCL's shared-memory transport would write under /dev/shm; the
    # cards talk over NVLink
    os.environ.setdefault("NCCL_SHM_DISABLE", "1")
    rdv = Path(tempfile.mkdtemp(prefix="stgcn_bench_dp_"))
    procs = []
    try:
        (rdv / "cell.json").write_text(json.dumps(
            {"config": cell.config, "traffic": cell.traffic,
             "limits": cell.limits}))
        argv = env.get("rank_argv", rank_argv)
        for r in range(1, cell.traffic["data"]):
            log = open(rdv / f"rank{r}.log", "w")
            procs.append((r, log, subprocess.Popen(
                argv(env, cell, seed, seconds, trace, r, rdv),
                stdout=log, stderr=subprocess.STDOUT)))
        out = rank_main(cell, seed, seconds, trace, env, rdv)
        reports = [json.loads((rdv / f"rank{r}.json").read_text())
                   if _wait(p, WAIT_S) == 0 and (rdv / f"rank{r}.json")
                   .exists() else _failed(rdv, r)
                   for r, _, p in procs]
    finally:
        for _, log, p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
            log.close()
        shutil.rmtree(rdv, ignore_errors=True)
    peaks = [out["memory_peak_bytes"]] + [r["peak"] for r in reports]
    out["memory_peak_bytes"] = max(peaks)
    out["e2e"]["peak_mem_gib"] = max(peaks) / 2 ** 30
    if trace:
        out["busy_s"] += [r["busy_s"] for r in reports]
    out["forbidden"] = sorted({m for r in reports for m in r["forbidden"]})
    if any(r["steps"] != out["attempted"] for r in reports):
        raise RuntimeError("the ranks ran different numbers of steps")
    return out


def _wait(proc, seconds) -> int | None:
    try:
        return proc.wait(timeout=seconds)
    except subprocess.TimeoutExpired:
        return None


def _failed(rdv: Path, r: int):
    log = (rdv / f"rank{r}.log").read_text()[-4000:]
    raise RuntimeError(f"rank {r} did not report:\n{log}")


def rank_main(cell, seed: int, seconds: float, trace: bool, env: dict,
              rdv: Path):
    import torch.distributed as dist

    from stgcn_tpu_torch.parallel.mesh import make_mesh
    from stgcn_tpu_torch.parallel.train import make_sharded_train_step
    from stgcn_tpu_torch.training.train_state import train_state_from

    device, rank = env["device"], env.get("rank", 0)
    tr = cell.traffic
    world = tr["data"]
    dist.init_process_group(
        "nccl" if device.type == "cuda" else "gloo",
        init_method=f"file://{rdv / 'init'}", world_size=world, rank=rank,
        timeout=datetime.timedelta(seconds=WAIT_S))
    try:
        control = dist.new_group(backend="gloo")
        mesh = make_mesh(data=world, device=device)
        harness.set_tf32(cell.config)
        harness.stage(env, "world")
        params, state, xs, ys, distances = training.inputs(cell, seed,
                                                           device)
        model = training.program_model(cell, distances, device)
        ts = train_state_from(params, state,
                              harness.program_optimizer(cell.config), seed,
                              device)
        step = env.get("make_step", make_sharded_train_step)(model, mesh)
        per = tr["batch"] // world

        def local(a):
            return a[rank * per:(rank + 1) * per]

        harness.stage(env, "model")
        prog = training.first_steps(step, ts, xs, ys, cell.config,
                                    tr["check_steps"], local)
        harness.stage(env, "first_steps")

        def stop(elapsed, n):
            if n % tr["vote_every"]:
                return False
            flag = torch.tensor([int(elapsed >= seconds)])
            dist.all_reduce(flag, op=dist.ReduceOp.MAX, group=control)
            return bool(flag.item())

        training.synchronize(device)
        dist.barrier(group=control)
        setup_s = time.time() - env["start"]
        with profiled(trace) as rec:
            with torch.profiler.record_function("window"):
                steps, window_s, issue, last_loss = training.window(
                    step, ts, xs, ys, start=tr["check_steps"],
                    seconds=seconds, device=device, inflight=tr["inflight"],
                    local=local, stop=stop)
        peak = (torch.cuda.max_memory_allocated(device)
                if device.type == "cuda" else 0)
        dist.barrier(group=control)
        del step, ts, model
        training.release()
    finally:
        dist.destroy_process_group()
    busy = rec.trace.busy_s() if rec.trace else None
    if rank != 0:
        (rdv / f"rank{rank}.json").write_text(json.dumps({
            "steps": steps, "peak": peak, "busy_s": busy,
            "forbidden": harness.forbidden_modules()}))
        return None
    numbers, readings = training.reference_check(
        cell, seed, params, state, xs, ys, distances, prog, device,
        shards=world)
    return {
        "attempted": steps,
        "failed": 0 if last_loss == last_loss else steps,
        "e2e": {"setup_s": setup_s,
                "train_seq_per_s": steps * tr["batch"] / window_s,
                "peak_mem_gib": peak / 2 ** 30},
        "numbers": numbers,
        "memory_peak_bytes": peak,
        "trace": rec.trace,
        "busy_s": [busy] if rec.trace else None,
        "readings": readings,
        "check_inputs": {"params": params, "state": state, "xs": xs,
                         "ys": ys, "distances": distances},
        "ctx": {"steps": steps, "window_s": window_s,
                "batch": tr["batch"], "frames": tr["frames"],
                "issue_ms": training.mean(issue) * 1e3},
    }
