"""Run one cell of the benchmark once.

    python3 stgcn_bench/run.py --workload NAME --seed N --seconds S --trace 0|1

Loads the cell named in ``BENCHMARK.json``, builds the program's objects
from the seed, warms up every shape the cell uses, measures for
``--seconds``, checks what the timed path produced against the plain
reference, and prints one JSON line last on standard output: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics with
``--trace 0``, its per-layer metrics with ``--trace 1``), ``device``, with
``--trace 1`` ``breakdown``, and ``checked`` (each compared number and its
limit).  Exits non-zero with no result where the cell's cards are missing,
where a run loaded JAX or the JAX package, or where anything fails.
A four-card cell starts its other ranks from this process.
"""

from __future__ import annotations

import argparse
import os
import sys
import time
from pathlib import Path

START = time.time()
REPO = Path(__file__).resolve().parent.parent
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

from stgcn_bench import harness  # noqa: E402

# the host's threads for PyTorch's own pools: the host's share of a step or
# a request is Python, launches and copies, which more threads only make
# noisier
HOST_THREADS = 1


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    # a four-card cell's other ranks (started by rank 0)
    ap.add_argument("--rank", type=int, default=0, help=argparse.SUPPRESS)
    ap.add_argument("--rendezvous", default=None, help=argparse.SUPPRESS)
    return ap.parse_args(argv)


def per_layer(cell, out: dict, device_name: str) -> tuple[dict, dict]:
    """The cell's per-layer metrics that their readers find something to
    read for, and the device ms of the window's kernels, by name, that no
    reader claims."""
    from stgcn_bench.metrics import _kernels

    ctx = dict(out["ctx"], trace=out["trace"], cell=cell, chips=cell.chips,
               device_name=device_name)
    readers = {m["name"]: harness.metric_reader(cell, m["name"])
               for m in cell.per_layer}
    claimed = {id(k) for r in readers.values() if hasattr(r, "claims")
               for k in r.claims(ctx)}
    # the window's kernels that no reader of the cell claims
    ctx["unclaimed"] = [k for k in _kernels.window_kernels(ctx)
                        if id(k) not in claimed]
    metrics = {}
    for m in cell.per_layer:
        value = readers[m["name"]].read(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    unclaimed: dict = {}
    for k in ctx["unclaimed"]:
        unclaimed[k[0]] = unclaimed.get(k[0], 0.0) + (k[2] - k[1]) / 1e3
    return metrics, unclaimed


def result_line(cell, out: dict, trace: bool, env: dict) -> tuple:
    import torch

    from stgcn_bench import trace as tracing

    numbers = out["numbers"]
    ok, checked = harness.checked_block(numbers)
    dev = env["device"]
    kind = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    if trace:
        metrics, unclaimed = per_layer(cell, out, kind)
        top = sorted(unclaimed.items(), key=lambda kv: -kv[1])[:20]
        print("device ms of the window's kernels that no metric claims: "
              + "; ".join(f"{tracing.short(n)} {v:.3f}" for n, v in top),
              file=sys.stderr)
    else:
        units = {m["name"]: m["unit"] for m in cell.end_to_end}
        metrics = {k: {"value": v, "unit": units[k]}
                   for k, v in out["e2e"].items() if k in units}
    device = {"platform": "gpu" if dev.type == "cuda" else "cpu",
              "kind": kind, "count": cell.chips,
              "memory_peak_bytes": int(out["memory_peak_bytes"])}
    result = {"correct": ok and out["failed"] == 0,
              "attempted": out["attempted"], "failed": out["failed"],
              "metrics": metrics, "device": device}
    if trace:
        busy = out["busy_s"]
        device["busy_s"] = sum(busy) / len(busy)
        device["window_s"] = out["trace"].window_s
        result["breakdown"] = tracing.breakdown(out["trace"])
    result["checked"] = checked
    return result, numbers


def main(argv=None) -> int:
    args = parse(argv)
    cell = harness.load_cell(args.workload, REPO)
    # before torch starts its thread pools
    os.environ["OMP_NUM_THREADS"] = str(HOST_THREADS)
    import torch

    torch.set_num_threads(HOST_THREADS)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"{cell.name} needs {cell.chips} CUDA card(s); {have} "
              "available", file=sys.stderr)
        return 2
    torch.cuda.set_device(args.rank)
    env = {"device": torch.device("cuda", args.rank),
           "start": min(START, harness.process_start()),
           "rank": args.rank, "rendezvous": args.rendezvous,
           "script": str(Path(__file__).resolve())}
    out = harness.driver(cell).run(cell, args.seed, args.seconds,
                                   bool(args.trace), env)
    harness.guard_modules()
    if out is None:         # a rank other than 0 reports through rank 0
        return 0
    found = out.get("forbidden") or []
    if found:
        print("forbidden modules loaded in a rank: " + ", ".join(found),
              file=sys.stderr)
        return 3
    print("set-up stages (s since the process began): " + ", ".join(
        f"{n} {t:.2f}" for n, t in env.get("stages", [])), file=sys.stderr)
    print(f"card: {harness.card_line()}; TF32 matmul "
          f"{torch.backends.cuda.matmul.allow_tf32}, cudnn "
          f"{torch.backends.cudnn.allow_tf32}", file=sys.stderr)
    result, numbers = result_line(cell, out, bool(args.trace), env)
    harness.emit(result, numbers)
    return 0


if __name__ == "__main__":
    sys.exit(main())
