"""Training on one card: the program's train step (``make_train_step``,
captured) on a ring of distinct batches, one step each, back to back.

The first ``check_steps`` calls (the warm-up, the capture, a replay) run
before the window on the ring's first batches; the reference follows them
after the window has closed.  The window then goes on around the ring.
"""

from __future__ import annotations

import time

import torch

from stgcn_bench import harness, training
from stgcn_bench.trace import profiled


def run(cell, seed: int, seconds: float, trace: bool, env: dict) -> dict:
    from stgcn_tpu_torch.training.loop import make_train_step
    from stgcn_tpu_torch.training.train_state import train_state_from

    device = env["device"]
    tr = cell.traffic
    harness.set_tf32(cell.config)
    harness.stage(env, "imports")
    params, state, xs, ys, distances = training.inputs(cell, seed, device)
    harness.stage(env, "inputs")
    model = training.program_model(cell, distances, device)
    ts = train_state_from(params, state,
                          harness.program_optimizer(cell.config), seed,
                          device)
    step = env.get("make_step", make_train_step)(model)
    harness.stage(env, "model")
    prog = training.first_steps(step, ts, xs, ys, cell.config,
                                tr["check_steps"])
    training.synchronize(device)
    harness.stage(env, "first_steps")
    setup_s = time.time() - env["start"]
    with profiled(trace) as rec:
        with torch.profiler.record_function("window"):
            steps, window_s, issue, last_loss = training.window(
                step, ts, xs, ys, start=tr["check_steps"], seconds=seconds,
                device=device, inflight=tr["inflight"])
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    del step, ts, model
    training.release()
    numbers, readings = training.reference_check(
        cell, seed, params, state, xs, ys, distances, prog, device)
    return {
        "attempted": steps,
        "failed": 0 if last_loss == last_loss else steps,
        "e2e": {"setup_s": setup_s,
                "train_seq_per_s": steps * tr["batch"] / window_s,
                "peak_mem_gib": peak / 2 ** 30},
        "numbers": numbers,
        "memory_peak_bytes": peak,
        "trace": rec.trace,
        "busy_s": [rec.trace.busy_s()] if rec.trace else None,
        "readings": readings,
        "check_inputs": {"params": params, "state": state, "xs": xs,
                         "ys": ys, "distances": distances},
        "ctx": {"steps": steps, "window_s": window_s,
                "batch": tr["batch"], "frames": tr["frames"],
                "issue_ms": training.mean(issue) * 1e3},
    }
