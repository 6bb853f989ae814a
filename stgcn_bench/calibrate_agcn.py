"""Readings that the limits of a 2s-AGCN training cell's check are set
from, on the card:

    python3 stgcn_bench/calibrate_agcn.py --workload NAME --seeds 12 \
        --controls 3 --seconds 1 [--base N]

As ``calibrate.py`` does for the ST-GCN cells: for each of ``--seeds``
seeds one run of the cell as the benchmark runs it, with a short window
(the program's readings, ``kind: program``); for the first ``--controls``
seeds also the control, the reference computed in 8-bit floats (e4m3
values, e5m2 gradients, scaled a tensor), and the faults planted in the
reference: half of each batch left out, the adaptive graph ``C_k`` left
out (``A_k + B_k`` only), and the parameters or the running statistics
left where they began.  One JSON line each; the benchmark's own runs never
compute these.

``--program-f32`` runs the program in float32 on its witness path
(``block_impl: "ops"``, plain PyTorch ops) with TF32 off, a witness of
what its bfloat16 rounding alone moves.
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

from stgcn_bench import calibrate, harness, training  # noqa: E402
from stgcn_bench.reference import agcn as ref  # noqa: E402
from stgcn_bench.reference.stgcn import fp8_rounding  # noqa: E402

KEEP = calibrate.KEEP + ("stats_median", "grad_gap_live", "grad_leaf_live",
                         "grad_leaf", "change_leaf", "nought")


def planted(cell, inp: dict) -> list:
    """``(kind, readings)`` of the control and the faults against the
    reference, on the inputs of one run."""
    drv = harness.driver(cell)
    start = ref.leaves(inp["params"])
    start_state = ref.leaves(inp["state"])
    want = drv.reference_train(cell, inp)
    out = [("control", drv.reference_train(cell, inp,
                                           rounding=fp8_rounding)),
           ("fault_half_batch", drv.reference_train(
               cell, inp, rows=cell.traffic["batch"] // 2)),
           ("fault_no_adaptive", drv.reference_train(cell, inp,
                                                     adaptive=False)),
           ("fault_state_unchanged", dict(want, params=start)),
           ("fault_stats_unchanged", dict(want, state=start_state))]
    return [(kind, {k: v for k, v in drv.readings(got, want, inp).items()
                    if k in KEEP}) for kind, got in out]


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
        cell.config["agcn_config"]["compute_dtype"] = "float32"
        cell.config["agcn_config"]["block_impl"] = "ops"
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
                "e2e": out["e2e"],
                "readings": {k: v for k, v in out["readings"].items()
                             if k in KEEP and k != "leaves"}}
        print(json.dumps(line), flush=True)
        if i < args.controls:
            for kind, readings in planted(cell, out["check_inputs"]):
                readings.pop("leaves", None)
                print(json.dumps({"seed": seed, "kind": kind,
                                  "readings": readings}), flush=True)
        del out
        training.release()
    harness.guard_modules()
    return 0


if __name__ == "__main__":
    sys.exit(main())
