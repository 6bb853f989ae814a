"""Eval-mode batch normalization (port of ``stgcn_tpu/ops/batchnorm.py``).

The reference wraps every block in ``BatchNorm2d`` (src/network/
st_graphconv.py:34,46) with eps 1e-5.  In eval mode that is a per-channel
affine from the running statistics, computed in at least float32 and cast
back to the activation dtype.  Train-mode statistics belong to the training
slice of the port.
"""

from __future__ import annotations

import torch


def stat_dtype(x: torch.Tensor) -> torch.dtype:
    """The dtype statistics and accumulations run in: at least float32."""
    return torch.promote_types(x.dtype, torch.float32)


def batchnorm_eval(params: dict, state: dict, x: torch.Tensor,
                   eps: float = 1e-5) -> torch.Tensor:
    """Normalize ``(..., C)`` per channel with the running statistics."""
    sd = stat_dtype(x)
    inv = torch.rsqrt(state["var"].to(sd) + eps) * params["scale"].to(sd)
    y = (x.to(sd) - state["mean"].to(sd)) * inv + params["offset"].to(sd)
    return y.to(x.dtype)


def fold_batchnorm_eval(params: dict, state: dict, eps: float = 1e-5
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """Fold eval-mode BN into a per-channel ``(scale, shift)`` pair.

    ``batchnorm_eval(x) == x * scale + shift``; the fused block kernel takes
    its BatchNorms in this form.
    """
    inv = torch.rsqrt(state["var"] + eps) * params["scale"]
    return inv, params["offset"] - state["mean"] * inv
