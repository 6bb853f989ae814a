#!/usr/bin/env python3
"""Strategy-table diagnosis through the PyTorch/CUDA port's CLI (the
port's ``scripts/strategy_diag.py``): does a strategy that sits at chance
in the table fail to express the task, or fail to converge?

    python3 scripts/torch_strategy_diag.py [--strategy 2]
        [--block-impl ops] [--only TAG] [--device cpu]

Sweeps one strategy over the JAX tool's :data:`GRID` of (lr, dropout,
epochs) and records train accuracy above all: a strategy that fits its
train set at some point of the grid can express the task, one that stays
at chance everywhere cannot.  Each point is one CLI run through
``torch_strategy_table.run_one`` (the table's base arguments, with the
point's partitioning, dropout and lr after them).  Writes
``STRATEGY_DIAG_torch.json`` (``--out``) after each point, and skips the
points it already holds, so a sweep resumes.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))

from torch_strategy_table import REPO, card, run_one  # noqa: E402

# (tag, lr, dropout, epochs): the JAX tool's grid (scripts/strategy_diag.py)
GRID = [
    ("baseline_lr1e-3_do0.5", "0.001", "0.5", 40),   # the failing setting
    ("lr1e-4_do0.5", "0.0001", "0.5", 40),           # reference's best lr
    ("lr1e-3_do0", "0.001", "0.0", 40),              # drop the dropout
    ("lr1e-4_do0", "0.0001", "0.0", 40),
    ("lr3e-4_do0_80ep", "0.0003", "0.0", 80),        # more budget
]


def diag_row(tag: str, lr: str, dropout: str, epochs: int, device: str,
             strategy: str, block_impl: str | None = None,
             overrides: tuple[str, ...] = ()) -> dict:
    """One grid point: the JAX tool's row fields."""
    row = run_one(tag, ["--model.partitioning", strategy,
                        "--model.dropout_rate", dropout, "--train.lr", lr],
                  device, epochs, block_impl, overrides=overrides)
    return {"tag": tag, "lr": float(lr), "dropout": float(dropout),
            "epochs": epochs, **{k: v for k, v in row.items()
                                 if k != "name"}}


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", help="cuda or cpu")
    ap.add_argument("--strategy", default="2",
                    help="0=uni 1=distance 2=spatial 3=symmetrical")
    ap.add_argument("--block-impl", default="ops")
    ap.add_argument("--only", default=None,
                    help="run a single grid tag (resumable sweep)")
    ap.add_argument("--out", default=str(REPO / "STRATEGY_DIAG_torch.json"))
    args = ap.parse_args(argv)

    path = Path(args.out)
    doc = {"comment": __doc__.split("\n\n")[1], "strategy": args.strategy,
           "block_impl": args.block_impl, "device": args.device,
           "card": card(args.device), "rows": []}
    if path.exists():
        doc = json.loads(path.read_text())
    done = {r["tag"] for r in doc["rows"]}
    for tag, lr, dropout, epochs in GRID:
        if (args.only and tag != args.only) or tag in done:
            continue
        doc["rows"].append(diag_row(tag, lr, dropout, epochs, args.device,
                                    args.strategy, args.block_impl))
        path.write_text(json.dumps(doc, indent=1))
    return 0 if all(r["rc"] == 0 for r in doc["rows"]) else 1


if __name__ == "__main__":
    sys.exit(main())
