"""Partitioned spatial graph convolution (port of
``stgcn_tpu/ops/spatial_conv.py:55``).

The reference's ``SpatialConv`` (src/network/st_graphconv.py:139-151)::

    y[n,t,w,k,o] = sum_i x[n,t,w,i] * W[i,k,o] + b[k,o]      (1x1 conv)
    out[n,t,v,o] = sum_{k,w} A[k,v,w] * y[n,t,w,k,o]          (aggregation)

on channel-last ``(N, T, V, C)`` activations.  Both contractions accumulate
in at least float32; with ``compute_dtype`` the inputs and the stage-1
output are rounded to it, as in the JAX package.

``impl="pallas"`` runs the hand-written graph-conv kernel instead
(:func:`stgcn_tpu_torch.kernels.spatial_conv.spatial_conv_fused`, the port
of the Pallas ``spatial_conv_fused``), as ``stgcn_tpu/ops/block.py:148-160``
does.
"""

from __future__ import annotations

import torch

from stgcn_tpu_torch.kernels.spatial_conv import spatial_conv_fused
from stgcn_tpu_torch.ops.batchnorm import stat_dtype

SPATIAL_IMPLS = ("einsum", "pallas")


def spatial_conv(params: dict, adjacency: torch.Tensor, x: torch.Tensor, *,
                 compute_dtype: torch.dtype | None = None,
                 impl: str = "einsum") -> torch.Tensor:
    """``params``: ``{"w": (C_in, K, C_out), "b": (K, C_out)}``;
    ``adjacency``: the effective ``(K, V, V)``; ``x``: ``(N, T, V, C_in)``.
    Returns ``(N, T, V, C_out)`` in ``x``'s dtype.

    ``impl``: ``"einsum"`` (two PyTorch contractions) or ``"pallas"`` (the
    kernel, with ``x``, the weights and the adjacency cast to
    ``compute_dtype`` first).
    """
    if impl == "pallas":
        h, w, b, a = x, params["w"], params["b"], adjacency
        if compute_dtype is not None:
            h, w, b, a = (t.to(compute_dtype) for t in (h, w, b, a))
        return spatial_conv_fused(h, w, b, a).to(x.dtype)
    if impl != "einsum":
        raise ValueError(f"spatial_impl must be one of {SPATIAL_IMPLS}, got "
                         f"{impl!r}")
    out_dtype = x.dtype
    acc = stat_dtype(x)
    w = params["w"]
    if compute_dtype is not None:
        x = x.to(compute_dtype)
        w = w.to(compute_dtype)
    y = torch.einsum("ntwi,iko->ntwko", x.to(acc), w.to(acc))
    y = y + params["b"].to(acc)
    if compute_dtype is not None:
        y = y.to(compute_dtype)
    out = torch.einsum("kvw,ntwko->ntvo", adjacency.to(y.dtype).to(acc),
                       y.to(acc))
    return out.to(out_dtype)

