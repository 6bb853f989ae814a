"""Readings that the limits of a cell's check are set from, on the card:

    python3 stgcn_bench/calibrate.py --workload NAME --seeds 12 \
        --controls 3 --seconds 1 [--base N]

For each of ``--seeds`` seeds, one run of the cell as the benchmark runs
it, with a short window: the numbers its check compares (the program's
readings, ``kind: program``).  For the first ``--controls`` seeds also the
control, the reference computed in 8-bit floats (e4m3 values and e5m2
gradients, scaled a tensor) against the reference, and the faults planted
in the reference: half of each batch left out (the mean taken over the
rest), and on several cards the exchange between them left out (each rank
as if alone, its gradient its share of its own rows', its statistics its
own rows'); the parameters, or the running statistics, left where they
began read without a run.  One JSON line each; the benchmark's own runs
never compute these.

``--program-f32`` runs the program in float32 (its scalar kernels) with
TF32 off, a witness of what its bfloat16 rounding alone moves.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

from stgcn_bench import check, harness, training  # noqa: E402
from stgcn_bench.reference import stgcn as ref  # noqa: E402

KEEP = ("loss_gap", "loss_first", "grad_gap", "grad_gap_moving",
        "grad_median", "change_gap", "change_median", "stats_gap",
        "stats_leaf", "grad_top", "change_top", "stats_top",
        "leaves")   # of check.train_numbers


def _train_readings(nums: dict) -> dict:
    return {k: nums[k] for k in KEEP}


def train_planted(cell, seed: int, inp: dict, device) -> list:
    """The control and the faults of a training cell, against the
    reference, on the inputs of one run."""
    cfg, tr = cell.config, cell.traffic
    g = cfg["stgcn_config"]
    shards = tr.get("data", 1)
    steps, b = tr["check_steps"], tr["batch"]
    adjacency = harness.reference_adjacency(cfg, inp["distances"], device)
    plan = [tuple(p) for p in g["plan"]]

    def masks(s, rows=None):
        m = harness.keep_masks(cfg, seed, s, b, tr["frames"], device,
                               shards)
        return m if rows is None or m is None else [x[:rows] for x in m]

    def train(rows=None, rounding=None):
        batches = [(inp["xs"][i][:rows], inp["ys"][i][:rows])
                   for i in range(steps)]
        return ref.train(inp["params"], inp["state"], batches, adjacency,
                         plan, cfg["optimizer"], gamma=g["gamma"],
                         dropout=g["dropout_rate"],
                         keep_masks=lambda s: masks(s, rows),
                         rounding=rounding, remat=True)

    start = ref.leaves(inp["params"])
    start_state = ref.leaves(inp["state"])
    want = train()
    out = [("control", train(rounding=ref.fp8_rounding)),
           ("fault_half_batch", train(rows=b // 2)),
           ("fault_state_unchanged", dict(want, params=start)),
           ("fault_stats_unchanged", dict(want, state=start_state))]
    if shards > 1:
        alone = train(rows=b // shards)
        alone["first_grads"] = {k: v / shards for k, v in
                                alone["first_grads"].items()}
        out.append(("fault_no_exchange", alone))
    return [(kind, _train_readings(check.train_numbers(got, want, start,
                                                       start_state)))
            for kind, got in out]


def serve_planted(cell, seed: int, inp: dict, device) -> list:
    from stgcn_bench.drivers import serve_closed

    chosen = serve_closed.picked(inp["done"], seed,
                                 cell.traffic["check_requests"])
    requests = [inp["done"][r] for r in chosen]
    args = (cell, inp["params"], inp["state"], inp["distances"], inp["pool"],
            requests, device)
    want = serve_closed.reference_probs(*args)
    control = serve_closed.reference_probs(*args,
                                           rounding=ref.fp8_rounding)
    return [("control", {"prob_gap": check.prob_gap(control, want)})]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--controls", type=int, default=3)
    ap.add_argument("--seconds", type=float, default=1.0)
    ap.add_argument("--base", type=int, default=3_000_000_019)
    ap.add_argument("--program-f32", action="store_true")
    args = ap.parse_args(argv)
    import torch

    cell = harness.load_cell(args.workload, REPO)
    if args.program_f32:
        cell.config["stgcn_config"]["compute_dtype"] = "float32"
        cell.config["tf32"] = {"matmul": False, "cudnn": False}
    device = torch.device("cuda", 0)
    env = {"device": device, "rank": 0, "rendezvous": None,
           "script": str(REPO / "stgcn_bench" / "run.py")}
    for i in range(args.seeds):
        seed = args.base + 7919 * i
        env["start"] = time.time()
        out = harness.driver(cell).run(cell, seed, args.seconds, False, env)
        line = {"seed": seed, "kind": "program",
                "numbers": {n: v for n, v, _ in out["numbers"]},
                "e2e": out["e2e"]}
        if "readings" in out:
            line["readings"] = _train_readings(out["readings"])
        print(json.dumps(line), flush=True)
        if i < args.controls:
            planted = (train_planted if "xs" in out["check_inputs"]
                       else serve_planted)
            for kind, readings in planted(cell, seed, out["check_inputs"],
                                          device):
                print(json.dumps({"seed": seed, "kind": kind,
                                  "readings": readings}), flush=True)
        del out
        training.release()
    harness.guard_modules()
    return 0


if __name__ == "__main__":
    sys.exit(main())
