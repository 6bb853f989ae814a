"""Serving in a closed loop: one caller sends a request of many clips to
the program's ``Predictor.predict``, waits for its answer and sends the
next, for the whole window.

The traffic file gives the request sizes (``clips``: the least and most
clips a request), the clip lengths (``frames``), the ``Predictor``'s
``buckets``, ``max_batch`` and ``batch_pad``, the ``pool`` of distinct
clips made on the device from the seed (each request takes prefixes of
them), ``cycle`` (requests a cycle), ``warm_requests`` (untimed requests
of the set-up) and ``check_requests`` (answers compared, the largest
among them).

Every seed gives the same work in another order: a cycle holds one
request of each of ``cycle`` sizes spread evenly over the range, and a
request of ``n`` clips has lengths spread evenly over ``frames``; the seed
shuffles the sizes in each cycle and the lengths in each request, and
picks the pool's clips.
"""

from __future__ import annotations

import sys
import time

import numpy as np
import torch

from stgcn_bench import check, harness, training, weights
from stgcn_bench.reference import stgcn as ref
from stgcn_bench.trace import profiled


def schedule(traffic: dict, seed: int, count: int) -> list:
    """``count`` requests, each ``(pool indices, lengths)``."""
    rng = np.random.default_rng([seed, 7])
    lo, hi = traffic["clips"]
    f_lo, f_hi = traffic["frames"]
    m = traffic["cycle"]
    sizes = lo + np.floor((hi - lo + 1) * (np.arange(m) + 0.5) / m
                          ).astype(int)
    out = []
    while len(out) < count:
        for n in rng.permutation(sizes):
            lengths = f_lo + np.floor((f_hi - f_lo + 1)
                                      * (np.arange(n) + 0.5) / n).astype(int)
            out.append((rng.choice(traffic["pool"], size=n, replace=False),
                        rng.permutation(lengths)))
    return out[:count]


def served_model(cell, params, state, device):
    """The program's model with the benchmark's served weights copied into
    its parameters and statistics (mask mode folds the mask into the
    block's adjacency)."""
    from stgcn_tpu_torch.models.stgcn import STGCN

    model = STGCN(harness.program_config(cell.config, dropout_rate=0.0))
    model = model.to(device)
    with torch.no_grad():
        for blk, bp, bs in zip(model.conv, params["blocks"],
                               state["blocks"]):
            k, c_out = bp["spatial"]["b"].shape
            c_in = bp["spatial"]["w"].shape[0]
            blk.spatialConv.W.weight.copy_(
                bp["spatial"]["w"].permute(1, 2, 0).reshape(
                    k * c_out, c_in, 1, 1))
            blk.spatialConv.W.bias.copy_(bp["spatial"]["b"].reshape(-1))
            blk.spatialConv.A.copy_(model.adjacency * bp["mask"])
            blk.temporalConv.weight.copy_(
                bp["temporal"]["w"].permute(3, 2, 0, 1))
            blk.temporalConv.bias.copy_(bp["temporal"]["b"])
            if "residual_proj" in bp:
                blk.apply_residual.weight.copy_(
                    bp["residual_proj"]["w"].t()[:, :, None, None])
                blk.apply_residual.bias.copy_(bp["residual_proj"]["b"])
            for bn, key in ((blk.batch_n, "bn1"), (blk.batch_n_2, "bn2")):
                bn.weight.copy_(bp[key]["scale"])
                bn.bias.copy_(bp[key]["offset"])
                bn.running_mean.copy_(bs[key]["mean"])
                bn.running_var.copy_(bs[key]["var"])
        model.fc_layer.weight.copy_(params["fc"]["w"].t())
        model.fc_layer.bias.copy_(params["fc"]["b"])
    return model


def run(cell, seed: int, seconds: float, trace: bool, env: dict) -> dict:
    from stgcn_tpu_torch.serving import Predictor

    device = env["device"]
    cfg, tr = cell.config, cell.traffic
    g = cfg["stgcn_config"]
    harness.set_tf32(cfg)
    harness.stage(env, "imports")
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    params, state = harness.make_weights(cfg, gen, trained=True)
    v = cfg["graph"]["num_joints"]
    pool = weights.skeleton_clips(tr["pool"], tr["frames"][1], v,
                                  g["c_in"], gen).cpu().numpy()
    distances = None
    if g["strategy"] == "spatial_configuration":
        distances = ref.gravity_distances(torch.from_numpy(pool[..., :2]))
    harness.stage(env, "inputs")
    model = served_model(cell, params, state, device)
    predictor = Predictor(model, buckets=tuple(tr["buckets"]),
                          max_batch=tr["max_batch"],
                          batch_pad=tr["batch_pad"], device=device)
    predictor = env.get("wrap_predictor", lambda p: p)(predictor)
    requests = schedule(tr, seed, tr["max_requests"])

    def clips(spec):
        idx, lengths = spec
        return [pool[i, :n] for i, n in zip(idx, lengths)]

    harness.stage(env, "model")
    predictor.warmup()
    harness.stage(env, "capture")
    for spec in requests[-tr["warm_requests"]:]:
        predictor.predict(clips(spec))
    harness.stage(env, "warm_requests")
    setup_s = time.time() - env["start"]
    latency, answers = [], []
    n_clips = 0
    host = harness.host_counters()
    with profiled(trace) as rec:
        with torch.profiler.record_function("window"):
            t0 = time.perf_counter()
            for spec in requests[:-tr["warm_requests"]]:
                batch = clips(spec)
                with torch.profiler.record_function("predict"):
                    s = time.perf_counter()
                    out = predictor.predict(batch)
                    latency.append(time.perf_counter() - s)
                answers.append(out.probs)
                n_clips += len(batch)
                if time.perf_counter() - t0 >= seconds:
                    break
            window_s = time.perf_counter() - t0
    print(harness.host_line(host, harness.host_counters()), file=sys.stderr)
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    del predictor, model
    training.release()
    done = requests[:len(answers)]
    numbers = [("prob_gap", compare(cell, params, state, distances, pool,
                                    done, answers, seed, device),
                cell.limits["prob_gap"])]
    lat = np.asarray(latency) * 1e3
    return {
        "attempted": len(answers),
        "failed": sum(not np.isfinite(a).all() for a in answers),
        "e2e": {"setup_s": setup_s,
                "serve_seq_per_s": n_clips / window_s,
                "serve_p95_ms": float(np.percentile(lat, 95)),
                "peak_mem_gib": peak / 2 ** 30},
        "numbers": numbers,
        "memory_peak_bytes": peak,
        "trace": rec.trace,
        "busy_s": [rec.trace.busy_s()] if rec.trace else None,
        "check_inputs": {"params": params, "state": state, "pool": pool,
                         "distances": distances, "done": done},
        "ctx": {"window_s": window_s, "requests": done,
                "latency_ms": lat.tolist()},
    }


def picked(done: list, seed: int, count: int) -> list:
    """The requests the check compares: the window's largest and
    ``count - 1`` others drawn from the seed."""
    largest = int(np.argmax([len(idx) for idx, _ in done]))
    rng = np.random.default_rng([seed, 11])
    others = [int(i) for i in rng.permutation(len(done)) if i != largest]
    return [largest] + others[:count - 1]


def reference_probs(cell, params, state, distances, pool, requests,
                    device, rounding=None) -> torch.Tensor:
    """The reference's probabilities of every clip of ``requests``, in
    order."""
    cfg, tr = cell.config, cell.traffic
    g = cfg["stgcn_config"]
    adjacency = harness.reference_adjacency(cfg, distances, device)
    out = []
    for idx, lengths in requests:
        clips = [torch.from_numpy(pool[i, :n]).to(device)
                 for i, n in zip(idx, lengths)]
        out.append(ref.predict(params, state, clips, adjacency,
                               [tuple(p) for p in g["plan"]],
                               tr["buckets"], gamma=g["gamma"],
                               rounding=rounding, batch=tr["max_batch"]))
    return torch.cat(out)


def compare(cell, params, state, distances, pool, done, answers, seed,
            device) -> float:
    """The widest probability gap of the picked requests' clips against
    the reference."""
    chosen = picked(done, seed, cell.traffic["check_requests"])
    want = reference_probs(cell, params, state, distances, pool,
                           [done[r] for r in chosen], device)
    got = torch.cat([torch.from_numpy(answers[r]) for r in chosen])
    return check.prob_gap(got.to(device), want)
