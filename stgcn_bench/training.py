"""What the training cells share: the ring of batches, the program's train
state and step, the first steps that the check follows, the measured
window, and the check against the reference.

The traffic file of a training cell gives ``batch`` (the global batch),
``frames``, ``ring`` (distinct batches made from the seed, one a step in
turn), ``check_steps`` (the first steps, before the window, that the
reference follows) and ``inflight`` (steps issued ahead of the device).
"""

from __future__ import annotations

import gc
import json
import time
from collections import deque

import torch

from stgcn_bench import check, harness, weights
from stgcn_bench.reference import stgcn as ref


# the readings a limits file may name (``check.train_numbers``); each one
# it names is compared
COMPARED = ("loss_gap", "loss_first", "grad_gap", "grad_median",
            "change_gap", "change_median", "stats_gap")


def synchronize(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def inputs(cell, seed: int, device):
    """``(params, state, xs, ys, distances)``: the starting weights, then
    the ring ``(R, B, T, V, C)`` with its labels, and the joints'
    gravity-centre distances where the partitioning needs them, all drawn
    on ``device`` from one generator seeded with ``seed``."""
    cfg, tr = cell.config, cell.traffic
    g = cfg["stgcn_config"]
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    params, state = harness.make_weights(cfg, gen, trained=False)
    r, b, t = tr["ring"], tr["batch"], tr["frames"]
    v = cfg["graph"]["num_joints"]
    xs = weights.skeleton_clips(r * b, t, v, g["c_in"], gen).reshape(
        r, b, t, v, g["c_in"])
    ys = weights.labels(r * b, g["num_classes"], gen).reshape(r, b)
    distances = None
    if g["strategy"] == "spatial_configuration":
        distances = ref.gravity_distances(xs[..., :2])
    return params, state, xs, ys, distances


def program_model(cell, distances, device):
    from stgcn_tpu_torch.models.stgcn import STGCN

    return STGCN(harness.program_config(cell.config),
                 distances=distances).to(device)


def first_grads(ts, config: dict) -> dict:
    """The first step's gradient as the optimizer got it, read back from
    its state after that step (Adam's first moment over ``1 - b1``, or the
    momentum trace)."""
    opt = config["optimizer"]
    out = {}
    for path, p in ref.leaves(ts.params).items():
        st = ts.optimizer.state[p]
        if opt["name"] == "adam":
            out[path] = st["exp_avg"].detach() / (1.0 - opt["b1"])
        else:
            out[path] = st["momentum_buffer"].detach().clone()
    return out


def snapshot(tree) -> dict:
    return {k: v.detach().clone() for k, v in ref.leaves(tree).items()}


def first_steps(step, ts, xs, ys, config: dict, steps: int, local=None
                ) -> dict:
    """Drive the step through its first ``steps`` calls (the warm-up, the
    capture, replays) on the ring's first batches; ``local`` takes this
    rank's rows of a batch.  Returns what the check compares."""
    local = local or (lambda a: a)
    losses, grads = [], None
    for i in range(steps):
        out = step(ts, local(xs[i]), local(ys[i]))
        losses.append(float(out["loss"]))
        if i == 0:
            grads = first_grads(ts, config)
    return {"losses": losses, "first_grads": grads,
            "params": snapshot(ts.params), "state": snapshot(ts.model_state)}


def window(step, ts, xs, ys, *, start: int, seconds: float, device,
           inflight: int, local=None, stop=None):
    """Call the step on the ring's batches, from batch ``start`` on, until
    the host's clock has passed ``seconds``, then wait for the device.
    ``stop(elapsed, steps)``, where given, decides instead (ranks that must
    agree); it is asked every call.  Returns ``(steps, seconds,
    issue seconds of each call, last loss)``."""
    local = local or (lambda a: a)
    ring = xs.shape[0]
    pending: deque = deque()
    issue = []
    n, out = 0, None
    synchronize(device)
    t0 = time.perf_counter()
    while True:
        i = (start + n) % ring
        with torch.profiler.record_function("step"):
            s = time.perf_counter()
            out = step(ts, local(xs[i]), local(ys[i]))
            issue.append(time.perf_counter() - s)
        n += 1
        if device.type == "cuda":
            ev = torch.cuda.Event()
            ev.record()
            pending.append(ev)
            if len(pending) > inflight:
                pending.popleft().synchronize()
        elapsed = time.perf_counter() - t0
        if (stop(elapsed, n) if stop is not None else elapsed >= seconds):
            break
    synchronize(device)
    return n, time.perf_counter() - t0, issue, float(out["loss"])


def release() -> None:
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def reference_check(cell, seed: int, params, state, xs, ys, distances,
                    prog: dict, device, shards: int = 1) -> list:
    """Run the reference over the first steps and compare; returns the
    ``(name, value, limit)`` triples of the readings that the cell's
    limits name, and every reading, which it prints."""
    cfg, tr = cell.config, cell.traffic
    g = cfg["stgcn_config"]
    steps = tr["check_steps"]
    adjacency = harness.reference_adjacency(cfg, distances, device)
    out = ref.train(
        params, state, [(xs[i], ys[i]) for i in range(steps)], adjacency,
        [tuple(p) for p in g["plan"]], cfg["optimizer"], gamma=g["gamma"],
        dropout=g["dropout_rate"],
        keep_masks=lambda s: harness.keep_masks(
            cfg, seed, s, tr["batch"], tr["frames"], device, shards),
        remat=True)
    nums = check.train_numbers(prog, out, ref.leaves(params),
                               ref.leaves(state))
    lim = cell.limits
    print("check detail: " + json.dumps({
        "losses": prog["losses"], "reference": out["losses"],
        **{k: v for k, v in nums.items() if k not in ("quiet", "leaves")}}),
        flush=True)
    return [(name, nums[name], lim[name]) for name in COMPARED
            if name in lim], nums


def mean(values) -> float:
    values = list(values)
    return sum(values) / len(values) if values else float("nan")
