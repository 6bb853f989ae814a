#!/usr/bin/env python3
"""Accuracy by partitioning strategy, trained to a plateau through the
PyTorch/CUDA port's CLI (the port's ``scripts/strategy_table.py``, the
analog of the reference's Table 1).

    python3 scripts/torch_strategy_table.py [--block-impl ops,fused]
        [--epochs 40] [--only distance,...] [--seed 0] [--device cpu]

Each configuration of :data:`CONFIGS` (the JAX tool's: the four
partitionings under the ablation setting, 9 layers, dropout 0.5,
``flat_adam`` lr 1e-3, no augmentation; and the reference's best recipe,
residual + augmentation + dropout 0 + lr 1e-4, with the spatial and the
distance partitioning) runs as its own ``python -m
stgcn_tpu_torch.cli.train`` process on the relational synthetic task
(classes that differ only in inter-joint phase structure), batch 16,
fixed 128-frame clips, bf16 on the card, once for each
``--block-impl`` (``--model.block_impl``; ``ops`` is the CLI's default,
as on the TPU run, ``fused`` trains on the hand-written kernels).  The
``[test]``, ``train_acc`` and ``val_acc`` lines the CLI prints are
parsed as the JAX tool parses them.

Writes ``STRATEGY_TABLE_torch.json`` (``--out``): each row beside the JAX
package's row of ``STRATEGY_TABLE_r05.json`` and, for each block
implementation, whether the r05 ordering held; the card's name and power
limit in the header.  The dropout and initialisation draw from torch, so
the accuracies match the JAX table in distribution only.
"""

from __future__ import annotations

import argparse
import json
import math
import re
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

from bench_torch import card  # noqa: E402

JAX_TABLE = REPO / "STRATEGY_TABLE_r05.json"
TIMEOUT_S = 1500

# (name, extra CLI args): the JAX tool's list (scripts/strategy_table.py)
CONFIGS = [
    ("uni_labeling", ["--model.partitioning", "0"]),
    ("distance", ["--model.partitioning", "1"]),
    ("spatial_configuration", ["--model.partitioning", "2"]),
    ("symmetrical", ["--model.partitioning", "3"]),
    # the reference's 80.47% recipe: residual + augmentation + dropout 0
    # at lr 1e-4 (STRATEGY_DIAG_r05.json: at lr 1e-3 the 3-partition
    # strategies stay at chance)
    ("best_spatial_residual_aug", [
        "--model.partitioning", "2", "--model.residual", "true",
        "--model.num_layers", "10", "--model.dropout_rate", "0.0",
        "--data.augment_data", "true", "--train.lr", "0.0001",
    ]),
    # the same recipe with the strategy that suits the relational task
    ("best_distance_residual_aug", [
        "--model.partitioning", "1", "--model.residual", "true",
        "--model.num_layers", "10", "--model.dropout_rate", "0.0",
        "--data.augment_data", "true", "--train.lr", "0.0001",
    ]),
]

# the r05 ordering of the test accuracies: each row above every later one
ORDERING = ("best_distance_residual_aug", "distance",
            ("uni_labeling", "spatial_configuration", "symmetrical"))


def base_args(device: str, epochs: int, f32: bool = False) -> list[str]:
    """The JAX tool's base arguments; ``f32``: float32 on the card too."""
    return [
        "--train.device", device,
        "--data.synthetic", "true",
        "--data.synthetic_style", "relational",
        "--data.batch_size", "16",
        "--data.collate_mode", "fixed", "--data.fixed_len", "128",
        "--model.num_layers", "9",
        "--model.dropout_rate", "0.5",
        "--train.lr", "0.001",
        "--train.optimizer", "flat_adam",
        "--train.epochs", str(epochs),
        "--parallel.precision",
        "bfloat16" if device != "cpu" and not f32 else "default",
    ]


def parse(out: str) -> dict:
    """The JAX tool's fields from the CLI's output: the ``[test]`` line
    and the ``train_acc``/``val_acc`` of the last epochs it prints, with
    their ``train_loss`` (``nan`` included, so a diverged run shows)."""
    m_test = re.search(r"\[test\] loss=([\d.]+) acc=([\d.]+) n=(\d+)", out)
    train_accs = [float(v) for v in re.findall(r"'train_acc': ([\d.]+)",
                                               out)]
    val_accs = [float(v) for v in re.findall(r"'val_acc': ([\d.]+)", out)]
    losses = [float(v) for v in re.findall(
        r"'train_loss': ([-+\w.]+)", out)]
    return {
        "test_loss": float(m_test.group(1)) if m_test else None,
        "test_acc": float(m_test.group(2)) if m_test else None,
        "test_n": int(m_test.group(3)) if m_test else None,
        "final_train_acc": train_accs[-1] if train_accs else None,
        "best_train_acc": max(train_accs) if train_accs else None,
        "final_val_acc": val_accs[-1] if val_accs else None,
        "train_losses": losses,
        "losses_finite": bool(losses) and all(map(math.isfinite, losses)),
    }


def run_one(name: str, extra: list[str], device: str, epochs: int,
            block_impl: str | None = None, seed: int | None = None,
            overrides: tuple[str, ...] = (), timeout_s: float = TIMEOUT_S,
            log_dir: str | None = None, f32: bool = False) -> dict:
    """One CLI run: the base arguments, then ``extra``, the block
    implementation, the seed and ``overrides`` (the CLI keeps a flag's
    last value).  Returns the parsed row; ``tail`` holds the output's end
    where the run failed.  With ``log_dir`` the whole output goes to
    ``<log_dir>/<name>_<block_impl>.log``.  ``f32``: float32 on the card
    (the parity configuration), which tells the kernels apart from bf16
    rounding."""
    cmd = [sys.executable, "-u", "-m", "stgcn_tpu_torch.cli.train",
           *base_args(device, epochs, f32), *extra]
    if block_impl:
        cmd += ["--model.block_impl", block_impl]
    if seed is not None:
        cmd += ["--train.seed", str(seed)]
    cmd += list(overrides)
    start = time.time()
    try:
        proc = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True,
                              timeout=timeout_s)
        rc, out = proc.returncode, proc.stdout + proc.stderr
    except subprocess.TimeoutExpired as err:
        partial = err.stdout or b""
        if isinstance(partial, bytes):
            partial = partial.decode(errors="replace")
        rc, out = -1, f"timed out after {timeout_s} s\n{partial}"
    row = {"name": name, "block_impl": block_impl or "ops", "seed": seed,
           "precision": "float32" if f32 or device == "cpu" else "bfloat16",
           "rc": rc, "wall_s": time.time() - start, **parse(out)}
    if log_dir:
        Path(log_dir).mkdir(parents=True, exist_ok=True)
        (Path(log_dir) / f"{name}_{row['block_impl']}.log").write_text(out)
    if rc != 0:
        row["tail"] = out[-2000:]
    print(json.dumps(row), flush=True)
    return row


def jax_rows() -> dict:
    """STRATEGY_TABLE_r05.json's rows by name."""
    table = json.loads(JAX_TABLE.read_text())
    return {r["name"]: r for key in ("ablation_rows_r4",
                                     "best_rows_corrected_lr1e-4")
            for r in table[key]}


def ordering(rows: list[dict]) -> dict | None:
    """Whether the test accuracies keep the r05 ordering, or None where a
    row of it did not run."""
    acc = {r["name"]: r["test_acc"] for r in rows}
    names = [ORDERING[0], ORDERING[1], *ORDERING[2]]
    if any(acc.get(n) is None for n in names):
        return None
    best, distance, rest = ORDERING
    return {"best_above_distance": acc[best] > acc[distance],
            "distance_above_the_rest": all(acc[distance] > acc[n]
                                           for n in rest),
            "test_acc": {n: acc[n] for n in names}}


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", help="cuda or cpu")
    ap.add_argument("--epochs", type=int, default=40)
    ap.add_argument("--block-impl", default="ops",
                    help="comma-separated --model.block_impl values")
    ap.add_argument("--only", default="",
                    help="comma-separated subset of config names")
    ap.add_argument("--seed", type=int, default=None,
                    help="--train.seed of every run (the CLI's 0 if none)")
    ap.add_argument("--out", default=str(REPO / "STRATEGY_TABLE_torch.json"))
    ap.add_argument("--log-dir", default=None,
                    help="keep each run's whole output here")
    ap.add_argument("--f32", action="store_true",
                    help="float32 on the card (the parity configuration)")
    args = ap.parse_args(argv)

    jax = jax_rows()
    only = set(args.only.split(",")) if args.only else None
    results, orderings = [], {}
    for impl in args.block_impl.split(","):
        rows = []
        for name, extra in CONFIGS:
            if only is not None and name not in only:
                continue
            row = run_one(name, extra, args.device, args.epochs, impl,
                          args.seed, log_dir=args.log_dir, f32=args.f32)
            row["jax_r05"] = jax.get(name)
            rows.append(row)
        orderings[impl] = ordering(rows)
        results += rows
    table = {
        "comment": (
            "Reference Table 1 analog through the PyTorch/CUDA port's CLI "
            "(scripts/torch_strategy_table.py) on the relational synthetic "
            f"task: {args.epochs} epochs, 9-layer plan, dropout 0.5, "
            "fixed-128 collation, batch 16, flat_adam lr 1e-3 (the best_* "
            "recipe: 10 layers, residual, augmentation, dropout 0, lr "
            "1e-4), bf16 on the card unless a row says float32; each row "
            "beside the JAX package's "
            "row of STRATEGY_TABLE_r05.json (jax_r05)."),
        "device": args.device, "card": card(args.device),
        "epochs": args.epochs, "seed": args.seed,
        "block_impls": args.block_impl.split(","),
        "results": results, "ordering_r05_held": orderings,
    }
    with open(args.out, "w") as f:
        json.dump(table, f, indent=1)
    print(f"wrote {args.out}", flush=True)
    return 0 if all(r["rc"] == 0 and r["losses_finite"]
                    for r in results) else 1


if __name__ == "__main__":
    sys.exit(main())
