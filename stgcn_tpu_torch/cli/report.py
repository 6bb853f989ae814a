"""Report figures: training curves and confusion matrices (port of
``stgcn_tpu/cli/report.py``).

Counterpart of src/scripts/report/generate_figures.py and generate_log.py:
moving-average smoothing, curves of several runs overlaid from CSV files
of the schema ``(Wall time, Step, Value)`` (what the port's and the JAX
package's ``CsvLogger`` write, and what the reference exported from
TensorBoard), and a confusion-matrix image.  The numpy and ``csv`` parts
need nothing else; matplotlib is imported only to draw.

Usage::

    python -m stgcn_tpu_torch.cli.report curves --csv a.csv --csv b.csv \
        --label runA --label runB --title "val acc" --out fig.png
    python -m stgcn_tpu_torch.cli.report confusion --npy cm.npy --out cm.png
"""

from __future__ import annotations

import argparse
import csv
import sys

import numpy as np

from stgcn_tpu_torch.utils.visualize import pyplot


def moving_average(y: np.ndarray, n: int = 10) -> np.ndarray:
    """Edge-padded moving average (generate_figures.py:9-12)."""
    y = np.asarray(y, float)
    if len(y) == 0:
        return y
    n = min(n, len(y))
    y_padded = np.pad(y, (n // 2, n - 1 - n // 2), mode="edge")
    return np.convolve(y_padded, np.ones(n) / n, mode="valid")


def read_metric_csv(path: str) -> tuple[np.ndarray, np.ndarray]:
    """``(steps, values)`` of a ``(Wall time, Step, Value)`` CSV, with or
    without its header row."""
    xs, ys = [], []
    with open(path, newline="") as f:
        reader = csv.reader(f)
        header = next(reader, None)
        if header and header[0].lower() not in ("wall time", "wall_time"):
            xs.append(float(header[1]))
            ys.append(float(header[2]))
        for row in reader:
            if not row:
                continue
            xs.append(float(row[1]))
            ys.append(float(row[2]))
    return np.asarray(xs), np.asarray(ys)


def plot_curves(csvs: list[str], labels: list[str], title: str,
                out_path: str, smooth: int = 10) -> None:
    plt = pyplot()
    fig, ax = plt.subplots(figsize=(8, 5))
    for path, label in zip(csvs, labels):
        x, y = read_metric_csv(path)
        ax.plot(x, moving_average(y, smooth), label=label)
    ax.set_xlabel("steps")
    ax.set_title(title)
    ax.legend()
    ax.grid(True, alpha=0.3)
    fig.savefig(out_path, bbox_inches="tight", dpi=120)
    plt.close(fig)


def plot_confusion_matrix(cm: np.ndarray, out_path: str,
                          class_names: list[str] | None = None) -> None:
    plt = pyplot()
    n = cm.shape[0]
    fig, ax = plt.subplots(figsize=(6, 5))
    im = ax.imshow(cm)
    ax.set_xticks(range(n))
    ax.set_yticks(range(n))
    if class_names:
        ax.set_xticklabels(class_names, rotation=45, ha="right")
        ax.set_yticklabels(class_names)
    ax.set_ylabel("True labels")
    ax.set_xlabel("Predicted labels")
    for (i, j), z in np.ndenumerate(cm):
        ax.text(j, i, f"{int(z):d}", ha="center", va="center",
                color="w" if z > cm.max() / 2 else "black")
    fig.colorbar(im)
    fig.savefig(out_path, bbox_inches="tight", dpi=120)
    plt.close(fig)


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(description="stgcn_tpu_torch report "
                                                 "figures")
    sub = parser.add_subparsers(dest="cmd", required=True)

    c = sub.add_parser("curves", help="overlaid smoothed training curves")
    c.add_argument("--csv", action="append", required=True)
    c.add_argument("--label", action="append", default=None)
    c.add_argument("--title", default="")
    c.add_argument("--smooth", type=int, default=10)
    c.add_argument("--out", required=True)

    m = sub.add_parser("confusion", help="confusion-matrix image")
    m.add_argument("--npy", required=True,
                   help=".npy file with the (C, C) matrix")
    m.add_argument("--out", required=True)
    m.add_argument("--kth-labels", action="store_true",
                   help="label the axes with the 6 KTH action names")

    args = parser.parse_args(argv)
    if args.cmd == "curves":
        labels = args.label or [f"run{i}" for i in range(len(args.csv))]
        if len(labels) != len(args.csv):
            parser.error("--label count must match --csv count")
        plot_curves(args.csv, labels, args.title, args.out, args.smooth)
    else:
        names = None
        if args.kth_labels:
            from stgcn_tpu_torch.graph.skeleton import KTH_LABELS
            names = list(KTH_LABELS)
        plot_confusion_matrix(np.load(args.npy), args.out, names)
    print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
