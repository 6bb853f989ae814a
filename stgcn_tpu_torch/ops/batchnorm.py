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

On a mesh (:mod:`stgcn_tpu_torch.parallel`) the train statistics are the
global batch's: each rank's moments, weighted by its share of the equally
sized shards, are summed over the ranks of ``group`` with their gradients
(the SyncBatchNorm pattern, as the JAX ``axis_names`` path averages them,
``stgcn_tpu/ops/batchnorm.py:55-60``), and ``n`` is the global count.
With a ``channel_group`` the input holds this rank's slice of the
channels: the whole parameters and statistics are sliced to it, the
parameters' gradients gathered back, and the new statistics gathered
whole.
"""

from __future__ import annotations

import torch

from stgcn_tpu_torch.kernels.bn_moments import bn_moments


def stat_dtype(x: torch.Tensor) -> torch.dtype:
    """The dtype statistics and accumulations run in: at least float32."""
    return torch.promote_types(x.dtype, torch.float32)


def batchnorm_eval(params: dict, state: dict, x: torch.Tensor,
                   eps: float = 1e-5, channel_group=None) -> torch.Tensor:
    """Normalize ``(..., C)`` per channel with the running statistics
    (of this rank's channels with a ``channel_group``)."""
    if channel_group is not None:
        params, state = channel_slice(params, state, channel_group)
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


def batch_moments(x: torch.Tensor, group=None
                  ) -> tuple[torch.Tensor, torch.Tensor, int]:
    """Per-channel ``(mean, biased variance, count)`` of ``(..., C)`` in at
    least float32, as ``E[x^2] - E[x]^2``; with ``group``, of the whole
    batch its ranks hold in equal shards.  The moments are the
    :func:`~stgcn_tpu_torch.kernels.bn_moments.bn_moments` op's: one read
    of ``x`` on CUDA, the plain reductions on the CPU."""
    mean, mean_sq = bn_moments(x)
    n = x.numel() // x.shape[-1]
    if group is not None:
        from stgcn_tpu_torch.parallel.collectives import (
            all_reduce_sum,
            group_size,
        )

        size = group_size(group)
        mean, mean_sq = all_reduce_sum(
            torch.stack([mean, mean_sq]) * (1.0 / size), group,
            "batchnorm")
        n *= size
    return mean, mean_sq - mean.square(), n


def running_update(state: dict, mean: torch.Tensor, var: torch.Tensor,
                   n: int, momentum: float = 0.1) -> dict:
    """New running statistics: the unbiased variance goes into the buffer."""
    unbiased = var.detach() * (n / max(n - 1, 1))
    return {"mean": (1 - momentum) * state["mean"] + momentum * mean.detach(),
            "var": (1 - momentum) * state["var"] + momentum * unbiased}


def channel_slice(params: dict, state: dict, channel_group):
    """This rank's slice of a BatchNorm's parameters (gradients gathered
    back over ``channel_group``) and statistics."""
    from stgcn_tpu_torch.parallel.collectives import (
        rank_slice,
        scatter_to_group,
    )

    return ({k: scatter_to_group(v, channel_group, 0)
             for k, v in params.items()},
            {k: rank_slice(v, channel_group, 0) for k, v in state.items()})


def batchnorm_train(params: dict, state: dict, x: torch.Tensor, *,
                    momentum: float = 0.1, eps: float = 1e-5,
                    group=None, channel_group=None
                    ) -> tuple[torch.Tensor, dict]:
    """Normalize ``(..., C)`` with the batch statistics; returns
    ``(y, new_state)``.  ``group``: the ranks whose shards make the batch;
    ``channel_group``: the ranks whose channel slices make ``C`` (module
    docstring)."""
    if channel_group is not None:
        from stgcn_tpu_torch.parallel.collectives import gather_tensor

        params, state = channel_slice(params, state, channel_group)
        y, new = batchnorm_train(params, state, x, momentum=momentum,
                                 eps=eps, group=group)
        return y, {k: gather_tensor(v, channel_group, 0, "batchnorm")
                   for k, v in new.items()}
    sd = stat_dtype(x)
    mean, var, n = batch_moments(x, group)
    inv = torch.rsqrt(var + eps) * params["scale"].to(sd)
    y = (x.to(sd) - mean) * inv + params["offset"].to(sd)
    return y.to(x.dtype), running_update(state, mean, var, n, momentum)
