"""Minimal raw training loop of the PyTorch port: no Trainer, no CLI.

The counterpart of ``examples/minimal_train.py`` on ``stgcn_tpu_torch``:
build a model, make its train state and step, iterate on one synthetic
batch.  It runs on the GPU unless ``--device cpu`` is given.

Run: python examples/minimal_train_torch.py [--device cpu]
"""

import argparse
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from stgcn_tpu_torch.data.synthetic import random_batch  # noqa: E402
from stgcn_tpu_torch.graph.adjacency import Strategy  # noqa: E402
from stgcn_tpu_torch.models.stgcn import STGCN, STGCNConfig  # noqa: E402
from stgcn_tpu_torch.training.loop import make_train_step  # noqa: E402
from stgcn_tpu_torch.training.optimizers import adam  # noqa: E402
from stgcn_tpu_torch.training.train_state import (  # noqa: E402
    create_train_state,
)


def main(argv: list[str] | None = None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    parser.add_argument("--epochs", type=int, default=20)
    args = parser.parse_args(argv)

    model = STGCN(STGCNConfig(strategy=Strategy.DISTANCE, d=1,
                              plan=((16, 1), (32, 2)), residual=True))
    state = create_train_state(model, adam(1e-2), seed=0, device=args.device)
    step = make_train_step(model)

    x, y = random_batch(np.random.default_rng(0), batch=32, t=64)
    x = torch.from_numpy(x).to(args.device)
    y = torch.from_numpy(y).to(args.device)

    for epoch in range(args.epochs):
        metrics = step(state, x, y)
        print(f"epoch {epoch:2d}  loss {float(metrics['loss']):.4f}  "
              f"acc {float(metrics['acc']):.3f}")


if __name__ == "__main__":
    main()
