#!/usr/bin/env python3
"""Serving latency and throughput of the PyTorch/CUDA port on one GPU (the
port's ``scripts/serving_bench.py``).

    python3 scripts/torch_serving_bench.py [--device cpu] [--out PATH]

Full-width DEFAULT_PLAN, distance partitioning, residual, bf16 compute,
random weights from seed 0, T=304, through the serving code of
``bench_torch.py``:

* ``results``: per-call latency of ``Predictor.predict_batch`` at batch 1,
  8, 32, 64 and 128 (from host numpy to host probabilities, the copies
  included): p50, p95 and seq/s over 20 calls, after the calls that warm
  up and capture that batch's graph;
* ``interleaved``: ``predict_batch`` one batch after another against
  ``predict_stream`` (two in flight), 8 batches of 64, in 6 alternating
  rounds, so drift between the rounds cancels in the ratio;
* ``device_resident``: the op-path forward (``STGCN.forward``) and the
  fused forward (one ``block_eval`` launch a block), softmax included, on
  two inputs staged on the device in turn, captured, 30 calls each.

Writes ``SERVING_torch.json`` (``--out``) with the card's name and power
limit, and prints each row as a JSON line.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import bench_torch  # noqa: E402

BATCHES = (1, 8, 32, 64, 128)
CALLS = 20             # timed calls of each batch size
ROUNDS, N_BATCHES = 6, 8
DEVICE_REPS = 30


def latency_row(pred, rng, batch: int, frames: int, calls: int) -> dict:
    """p50, p95 and seq/s of ``predict_batch`` at ``batch``, after the
    two calls that warm up and capture its graph."""
    x = rng.standard_normal((batch, frames, 25, 2)).astype(np.float32)
    for _ in range(2):
        pred.predict_batch(x)
    lat = []
    for _ in range(calls):
        start = time.perf_counter()
        pred.predict_batch(x)
        lat.append(time.perf_counter() - start)
    lat = np.sort(lat)
    return {"batch": batch, "t": frames,
            "p50_ms": float(lat[len(lat) // 2]) * 1e3,
            "p95_ms": float(lat[int(len(lat) * 0.95)]) * 1e3,
            "sequences_per_s": batch / float(np.mean(lat))}


def interleaved_row(pred, rng, batch: int, frames: int, n_batches: int,
                    rounds: int) -> dict:
    xs = [rng.standard_normal((batch, frames, 25, 2)).astype(np.float32)
          for _ in range(n_batches)]
    serial, piped = [], []
    for _ in range(rounds):
        s, p = bench_torch.predictor_rates(pred, xs, 1)
        serial += s
        piped += p
    return {"batch": batch, "t": frames, "n_batches": n_batches,
            "rounds": rounds,
            "serial_seq_per_s_median": float(np.median(serial)),
            "pipelined_seq_per_s_median": float(np.median(piped)),
            "serial_rounds": serial, "pipelined_rounds": piped,
            "pipelined_speedup_median": float(np.median(
                [p / s for p, s in zip(piped, serial)]))}


def device_rows(model, rng, batch: int, frames: int, reps: int,
                device) -> list[dict]:
    import torch

    xs = [torch.from_numpy(rng.standard_normal(
        (batch, frames, 25, 2)).astype(np.float32)).to(device)
        for _ in range(2)]
    rows = []
    for name, fused in (("op_path", False), ("fused", True)):
        lat = bench_torch.device_resident_s(model, fused, xs, reps, device)
        rows.append({"forward": name, "batch": batch, "t": frames,
                     "device_resident_p50_ms": lat[len(lat) // 2] * 1e3,
                     "device_resident_seq_per_s":
                         batch / float(np.mean(lat))})
    return rows


def main(argv: list[str] | None = None) -> int:
    from stgcn_tpu_torch import resolve_device
    from stgcn_tpu_torch.serving import Predictor

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", help="cuda or cpu")
    ap.add_argument("--batches", default=",".join(map(str, BATCHES)),
                    help="batch sizes of the latency rows")
    ap.add_argument("--frames", type=int, default=bench_torch.T)
    ap.add_argument("--stream-batch", type=int, default=bench_torch.BATCH,
                    help="batch of the interleaved and device rows")
    ap.add_argument("--out", default=str(REPO / "SERVING_torch.json"))
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    smi = bench_torch.card(device)
    print(smi or "device: cpu", flush=True)
    model = bench_torch.serving_model("bf16", device)
    pred = Predictor(model, buckets=(args.frames,),
                     max_batch=args.stream_batch, device=device)
    rng = np.random.default_rng(0)

    results = []
    for batch in (int(b) for b in args.batches.split(",")):
        results.append(latency_row(pred, rng, batch, args.frames, CALLS))
        print(json.dumps(results[-1]), flush=True)
    interleaved = interleaved_row(pred, rng, args.stream_batch,
                                  args.frames, N_BATCHES, ROUNDS)
    print(json.dumps(interleaved), flush=True)
    del pred
    bench_torch.release()
    device_resident = device_rows(model, rng, args.stream_batch,
                                  args.frames, DEVICE_REPS, device)
    for row in device_resident:
        print(json.dumps(row), flush=True)

    import torch

    out = {
        "comment": ("Eval-mode serving of the PyTorch/CUDA port (softmax "
                    "probabilities, bf16, DEFAULT_PLAN, random weights "
                    "from seed 0), written by "
                    "scripts/torch_serving_bench.py. 'results': "
                    "host-blocking per-call latency of "
                    "Predictor.predict_batch, host copies included, each "
                    "batch's CUDA graph captured before timing. "
                    "'interleaved': serial predict_batch against depth-2 "
                    "predict_stream in alternating rounds. "
                    "'device_resident': the forward alone on inputs "
                    "staged on the device, captured: the op path "
                    "(STGCN.forward) and the fused forward (block_eval)."),
        "device": device.type, "card": smi, "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "results": results, "interleaved": interleaved,
        "device_resident": device_resident,
    }
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    print(f"wrote {args.out}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
