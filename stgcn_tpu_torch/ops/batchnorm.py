"""Batch normalization (port of ``stgcn_tpu/ops/batchnorm.py``).

The reference wraps every block in ``BatchNorm2d`` (src/network/
st_graphconv.py:34,46) with eps 1e-5.  In eval mode that is a per-channel
affine from the running statistics, computed in at least float32 and cast
back to the activation dtype.  In train mode the statistics are the batch's,
taken over every axis but the last (channels), in at least float32 as
``E[x^2] - E[x]^2``: the biased variance normalizes, and the unbiased one
goes into the running buffer with momentum 0.1.  The running statistics are
returned as new tensors (out of place, as in the JAX package), never
written into the old ones.
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


def batch_moments(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, int]:
    """Per-channel ``(mean, biased variance, count)`` of ``(..., C)`` in at
    least float32, as ``E[x^2] - E[x]^2``."""
    xf = x.to(stat_dtype(x))
    axes = tuple(range(x.dim() - 1))
    mean = xf.mean(dim=axes)
    var = xf.square().mean(dim=axes) - mean.square()
    return mean, var, x.numel() // x.shape[-1]


def running_update(state: dict, mean: torch.Tensor, var: torch.Tensor,
                   n: int, momentum: float = 0.1) -> dict:
    """New running statistics: the unbiased variance goes into the buffer."""
    unbiased = var.detach() * (n / max(n - 1, 1))
    return {"mean": (1 - momentum) * state["mean"] + momentum * mean.detach(),
            "var": (1 - momentum) * state["var"] + momentum * unbiased}


def batchnorm_train(params: dict, state: dict, x: torch.Tensor, *,
                    momentum: float = 0.1, eps: float = 1e-5
                    ) -> tuple[torch.Tensor, dict]:
    """Normalize ``(..., C)`` with the batch statistics; returns
    ``(y, new_state)``."""
    sd = stat_dtype(x)
    mean, var, n = batch_moments(x)
    inv = torch.rsqrt(var + eps) * params["scale"].to(sd)
    y = (x.to(sd) - mean) * inv + params["offset"].to(sd)
    return y.to(x.dtype), running_update(state, mean, var, n, momentum)
