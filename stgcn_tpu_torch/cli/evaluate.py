"""Offline evaluation: restore a checkpoint, run a split, report (port of
``stgcn_tpu/cli/evaluate.py``).

Counterpart of the reference's evaluation notebook
(src/notebooks/experiments.ipynb cells 7-11: load the state dict, eval(),
batched predictions, confusion matrix and accuracy).  It reads either a
``.npz`` checkpoint of the port or of the JAX package (``--checkpoint``,
the parameters and BN statistics only, so a checkpoint of any optimizer
evaluates), or a reference PyTorch ``.pt`` state dict or Lightning
``.ckpt`` (``--torch-checkpoint``, through
:func:`stgcn_tpu_torch.models.convert.params_from_state_dict`).  The
forward is ``Trainer.evaluate`` on the path ``--model.block_impl`` names:
"fused" evaluates every block on the ``block_eval`` kernel.  It runs on the
GPU unless ``--train.device cpu`` asks for the CPU.

Usage::

    python -m stgcn_tpu_torch.cli.evaluate --checkpoint runs/ckpt_1200 \
        --data.synthetic true
    python -m stgcn_tpu_torch.cli.evaluate --torch-checkpoint model.pt \
        --model.norm_mode reference --model.adjacency_mode reference ...
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from stgcn_tpu_torch.cli.train import build_datasets, resolve_distances
from stgcn_tpu_torch.data import batches
from stgcn_tpu_torch.models.convert import params_from_state_dict
from stgcn_tpu_torch.models.stgcn import STGCN
from stgcn_tpu_torch.training.checkpoint import restore_checkpoint
from stgcn_tpu_torch.training.config import (
    apply_device,
    model_config_from,
    parse_config,
    precision_scope,
)
from stgcn_tpu_torch.training.loop import Trainer
from stgcn_tpu_torch.training.train_state import train_state_from


def load_torch_state_dict(path: str) -> dict:
    """A reference state dict from a ``.pt`` file (a state dict or a
    pickled module) or a Lightning ``.ckpt`` (unwrapped from its
    ``state_dict``).  ``torch.load`` unpickles, which can run code: load
    only files you trust."""
    sd = torch.load(path, map_location="cpu", weights_only=False)
    if hasattr(sd, "state_dict"):
        sd = sd.state_dict()
    if "state_dict" in sd:
        sd = sd["state_dict"]
    return sd


def main(argv: list[str] | None = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    # peel off the evaluate flags; the rest go to the config parser
    extra = argparse.ArgumentParser(add_help=False)
    extra.add_argument("--checkpoint", type=str, default="",
                       help="npz checkpoint basename (no .npz suffix)")
    extra.add_argument("--torch-checkpoint", type=str, default="",
                       help="reference PyTorch state-dict file (.pt/.ckpt); "
                            "unpickled, so only a file you trust")
    extra.add_argument("--split", choices=["train", "val", "test"],
                       default="test")
    extra.add_argument("--save-confusion", type=str, default="",
                       help="write the confusion matrix to this .npy path")
    args, rest = extra.parse_known_args(argv)
    cfg = parse_config(rest)
    device = apply_device(cfg)
    with precision_scope(cfg):
        metrics = evaluate_checkpoint(
            cfg, checkpoint=args.checkpoint,
            torch_checkpoint=args.torch_checkpoint, split=args.split,
            device=device)
    print(f"[eval] split={args.split} loss={metrics['loss']:.4f} "
          f"acc={metrics['acc']:.4f} n={metrics['count']}")
    print("[eval] confusion matrix:\n", metrics["confusion_matrix"])
    if args.save_confusion:
        np.save(args.save_confusion, np.asarray(metrics["confusion_matrix"]))
        print(f"[eval] wrote {args.save_confusion}")
    return 0


def evaluate_checkpoint(cfg, *, checkpoint: str = "",
                        torch_checkpoint: str = "", split: str = "test",
                        device: torch.device | None = None) -> dict:
    """``Trainer.evaluate`` of the weights in ``torch_checkpoint`` or
    ``checkpoint`` (neither: random weights) on ``split`` of the dataset
    the config names; returns its metrics (``loss``, ``acc``,
    ``confusion_matrix``, ``count``)."""
    train_ds, val_ds, test_ds = build_datasets(cfg)
    ds = {"train": train_ds, "val": val_ds, "test": test_ds}[split]
    model = STGCN(model_config_from(cfg),
                  distances=resolve_distances(cfg, train_ds))
    trainer = Trainer(model, lr=cfg.train.lr, device=device)
    state = trainer.init_state()

    if torch_checkpoint:
        params, mstate = params_from_state_dict(
            load_torch_state_dict(torch_checkpoint), len(model.config.plan),
            model.num_partitions, residual=model.config.residual)
        state = train_state_from(params, mstate, trainer.optimizer,
                                 state.seed, trainer.device)
        print(f"[eval] imported torch state dict from {torch_checkpoint}")
    elif checkpoint:
        # parameters and BN statistics only: the optimizer moments of any
        # optimizer's checkpoint are not read
        state = restore_checkpoint(checkpoint, state,
                                   skip_prefixes=("opt_state",))
        print(f"[eval] restored {checkpoint}")
    else:
        print("[eval] WARNING: evaluating a randomly initialized model "
              "(no --checkpoint given)")

    d = cfg.data
    return trainer.evaluate(
        state, batches(ds, d.batch_size, mode=d.collate_mode,
                       fixed_len=d.fixed_len))


if __name__ == "__main__":
    sys.exit(main())
