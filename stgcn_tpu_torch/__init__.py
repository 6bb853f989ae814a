"""PyTorch/CUDA port of ``stgcn_tpu`` for NVIDIA Hopper (H100, sm_90a).

The JAX package ``stgcn_tpu`` stays beside this one as the reference that
each part of the port is held against.  This package imports ``torch`` and
``numpy`` only: nothing of JAX and nothing of ``stgcn_tpu``.

Entry points run on the GPU unless the caller passes ``device="cpu"``
(:func:`resolve_device`); a missing GPU raises instead of quietly running
on the CPU.
"""

from __future__ import annotations

import torch

__version__ = "0.1.0"


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """The device an entry point runs on: CUDA unless the CPU is asked for.

    ``None`` means ``"cuda"``.  A CUDA device without an available GPU
    raises ``RuntimeError``.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch versions on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"device must be 'cuda' or 'cpu', got {dev}")
    return dev
