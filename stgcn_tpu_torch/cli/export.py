"""Export a checkpoint to deployable or reference-compatible formats (port of
``stgcn_tpu/cli/export.py``).

* ``pt`` / ``npz``: the reference-format state dict
  (:func:`stgcn_tpu_torch.models.convert.state_dict_from_params`, the
  counterpart of the JAX ``export_state_dict``) as a ``torch.save`` file or
  an ``.npz`` of the same names, which the reference code, the JAX
  package's importer and ``Predictor.from_state_dict`` load.
* ``pt2``: in place of the JAX package's ``stablehlo``, a
  ``torch.export`` program of the eval forward (softmax probabilities) with
  the checkpoint's weights in it, saved by ``torch.export.save``; it runs
  with ``torch.export.load(path).module()(x)`` on any machine with torch,
  without this package.  The traced forward is the op path
  (``block_impl="ops"``, ``STGCN.forward``) on the device the flags name,
  whatever ``--model.block_impl`` says: the kernels are ctypes calls that
  ``torch.export`` cannot trace.  The program takes ``(batch, seq_len, 25,
  C_in)`` float32 input on the device it was exported on
  (``--train.device``); ``--dynamic-batch`` makes the batch a
  ``torch.export.Dim``, else any other batch size is refused.  The JAX
  CLI's ``--platforms`` belongs to ``stablehlo`` and is not taken.

Usage::

    python -m stgcn_tpu_torch.cli.export --checkpoint runs/ckpt_1200 \
        --out model.pt [--format pt|npz|pt2] \
        [--batch 64 --seq-len 304 --dynamic-batch] [model/config flags...]
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np
import torch
from torch import nn

from stgcn_tpu_torch import resolve_device
from stgcn_tpu_torch.cli.train import resolve_distances
from stgcn_tpu_torch.models.convert import state_dict_from_params
from stgcn_tpu_torch.models.stgcn import STGCN
from stgcn_tpu_torch.training.checkpoint import restore_checkpoint
from stgcn_tpu_torch.training.config import (
    apply_device,
    model_config_from,
    parse_config,
)

FORMATS = ("pt", "npz", "pt2")


class SoftmaxForward(nn.Module):
    """The eval forward on the op path, as probabilities."""

    def __init__(self, model: STGCN):
        super().__init__()
        self.model = model

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.softmax(self.model(x), dim=-1)


def export_program(model: STGCN, *, batch: int, seq_len: int,
                   dynamic_batch: bool = False,
                   device: str | torch.device | None = None):
    """``torch.export`` program of ``model``'s eval forward (op path,
    softmax) at ``(batch, seq_len, 25, C_in)`` float32 input on
    ``device`` (CUDA unless the CPU is asked for); ``dynamic_batch``
    leaves the batch size free."""
    device = resolve_device(device)
    mod = SoftmaxForward(model).to(device).eval()
    x = torch.zeros(batch, seq_len, model.num_joints, model.config.c_in,
                    device=device)
    dynamic = ({"x": {0: torch.export.Dim("batch", min=1)}}
               if dynamic_batch else None)
    with torch.no_grad():
        return torch.export.export(mod, (x,), dynamic_shapes=dynamic)


def main(argv: list[str] | None = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    extra = argparse.ArgumentParser(add_help=False)
    extra.add_argument("--checkpoint", required=True)
    extra.add_argument("--out", required=True)
    extra.add_argument("--format", choices=[*FORMATS, "stablehlo"],
                       default=None,
                       help="pt | npz | pt2 (a torch.export program of the "
                            "op-path eval forward); stablehlo is the JAX "
                            "package's and is refused")
    extra.add_argument("--batch", type=int, default=64,
                       help="batch size of the pt2 program (it refuses any "
                            "other unless --dynamic-batch)")
    extra.add_argument("--dynamic-batch", action="store_true",
                       help="export the pt2 program with a free batch size")
    extra.add_argument("--seq-len", type=int, default=304,
                       help="sequence length of the pt2 program")
    args, rest = extra.parse_known_args(argv)
    cfg = parse_config(rest)

    fmt = args.format or ("pt" if args.out.endswith(".pt") else
                          "pt2" if args.out.endswith(".pt2") else
                          "stablehlo" if args.out.endswith(".stablehlo")
                          else "npz")
    if fmt == "stablehlo":
        raise SystemExit("--format stablehlo is the JAX package's "
                         "(jax.export); the port exports a torch.export "
                         "program: use --format pt2")

    model = STGCN(model_config_from(cfg),
                  distances=resolve_distances(cfg))
    params, state = model.init_params(0)
    tree = restore_checkpoint(args.checkpoint,
                              {"params": params, "model_state": state})
    sd = state_dict_from_params(tree["params"], tree["model_state"],
                                residual=model.config.residual,
                                adjacency=model.adjacency)
    if fmt == "pt2":
        model.load_state_dict(sd)
        prog = export_program(model, batch=args.batch, seq_len=args.seq_len,
                              dynamic_batch=args.dynamic_batch,
                              device=apply_device(cfg))
        torch.export.save(prog, args.out)
        b = "batch (dynamic)" if args.dynamic_batch else args.batch
        print(f"exported torch.export program of the op-path eval forward "
              f"(({b}, {args.seq_len}, {model.num_joints}, "
              f"{model.config.c_in}) -> ({b}, {model.config.num_classes})), "
              f"{os.path.getsize(args.out)} bytes to {args.out}")
        return 0
    if fmt == "pt":
        torch.save(sd, args.out)
    else:
        np.savez(args.out, **{k: v.numpy() for k, v in sd.items()})
    print(f"exported {len(sd)} tensors to {args.out} ({fmt})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
