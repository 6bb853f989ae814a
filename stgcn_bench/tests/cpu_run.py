"""One run of a cell on the CPU, as ``run.py`` runs it but without its
look for a card, for the tests:

    python3 cpu_run.py WORKLOAD [--small] [--trace]

Prints the result line, then ``MODULES`` and the top-level names of every
module the process loaded.  ``--small`` cuts the cell as
``tests/small.py`` does."""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("workload")
    ap.add_argument("--small", action="store_true")
    ap.add_argument("--trace", action="store_true")
    args = ap.parse_args(argv)
    import torch

    from stgcn_bench import harness, run
    from stgcn_bench.tests.small import small_cell

    torch.set_num_threads(2)
    cell = (small_cell(args.workload, ROOT) if args.small
            else harness.load_cell(args.workload, ROOT))
    env = {"device": torch.device("cpu"), "start": time.time()}
    out = harness.driver(cell).run(cell, 2 ** 31 + 5, 0.3, args.trace, env)
    result, numbers = run.result_line(cell, out, args.trace, env)
    harness.emit(result, numbers)
    print("MODULES " + json.dumps(sorted({m.split(".")[0]
                                          for m in sys.modules})))
    return 0


if __name__ == "__main__":
    sys.exit(main())
