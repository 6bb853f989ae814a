"""The ST-GCN unit, eval and train mode (port of
``stgcn_tpu/ops/block.py:92-290``).

This is the op-path oracle that the fused block kernels are held against.
Behaviour follows the reference's ``SpatialTemporalConv``
(src/network/st_graphconv.py:4-109):

* non-residual order: BN -> spatial -> temporal -> BN -> ReLU;
* residual order (full pre-activation): BN -> ReLU -> spatial -> BN -> ReLU
  -> temporal, plus a shortcut (identity when shapes match, strided 1x1
  projection otherwise), then the outer ReLU;
* in train mode dropout follows the outer ReLU, and the BatchNorms use the
  batch statistics and return new running statistics.

Parameters are dictionaries of tensors in the JAX package's layout
(``spatial.w`` is ``(C_in, K, C_out)``, ``temporal.w`` is
``(gamma, 1, C_in, C_out)``), so one block's parameters carry over from a
JAX pytree unchanged.  The adjacency modes (SURVEY.md Q2) are told apart as
there: a block with ``"A"`` owns its whole adjacency (``"reference"``), one
with ``"mask"`` multiplies the fixed adjacency by it (``"mask"``), one with
neither uses the fixed adjacency (``"fixed"``).

``spatial_impl`` and ``temporal_impl`` pick each conv's implementation on
``(N, T, V, C)`` (:mod:`stgcn_tpu_torch.ops.spatial_conv`,
:mod:`stgcn_tpu_torch.ops.temporal_conv`).  :func:`block_forward_vm` is the
unit on V-major ``(V, N, T, C)`` activations, the ``layout="vntc"`` route:
both convs run as the V-major kernels.
"""

from __future__ import annotations

import torch

from stgcn_tpu_torch.kernels.spatial_conv import spatial_conv_fused_vm
from stgcn_tpu_torch.kernels.temporal_conv import temporal_conv_fused_vm
from stgcn_tpu_torch.ops.batchnorm import (
    batchnorm_eval,
    batchnorm_train,
    stat_dtype,
)
from stgcn_tpu_torch.ops.common import dropout
from stgcn_tpu_torch.ops.spatial_conv import spatial_conv
from stgcn_tpu_torch.ops.temporal_conv import pointwise_conv, temporal_conv

ADJACENCY_MODES = ("reference", "mask", "fixed")


def effective_adjacency(params: dict, adjacency: torch.Tensor) -> torch.Tensor:
    """The ``(K, V, V)`` adjacency this block's forward uses."""
    if "A" in params:
        return params["A"]
    if "mask" in params:
        return adjacency * params["mask"]
    return adjacency


def block_forward(params: dict, state: dict, x: torch.Tensor,
                  adjacency: torch.Tensor, *, stride: int = 1,
                  residual: bool = False,
                  compute_dtype: torch.dtype | None = None,
                  spatial_impl: str = "einsum",
                  temporal_impl: str = "conv") -> torch.Tensor:
    """One eval-mode ST-GCN unit: ``(N, T, V, C_in) -> (N, T', V, C_out)``."""
    a = effective_adjacency(params, adjacency)
    if residual:
        h = torch.relu(batchnorm_eval(params["bn1"], state["bn1"], x))
        h = spatial_conv(params["spatial"], a, h, compute_dtype=compute_dtype,
                         impl=spatial_impl)
        h = torch.relu(batchnorm_eval(params["bn2"], state["bn2"], h))
        h = temporal_conv(params["temporal"], h, stride=stride,
                          compute_dtype=compute_dtype, impl=temporal_impl)
        if "residual_proj" in params:
            shortcut = pointwise_conv(params["residual_proj"], x,
                                      stride=stride)
        else:
            shortcut = x
        out = h + shortcut
    else:
        h = batchnorm_eval(params["bn1"], state["bn1"], x)
        h = spatial_conv(params["spatial"], a, h, compute_dtype=compute_dtype,
                         impl=spatial_impl)
        h = temporal_conv(params["temporal"], h, stride=stride,
                          compute_dtype=compute_dtype, impl=temporal_impl)
        out = batchnorm_eval(params["bn2"], state["bn2"], h)
    return torch.relu(out)


def block_forward_train(params: dict, state: dict, x: torch.Tensor,
                        adjacency: torch.Tensor, *, stride: int = 1,
                        residual: bool = False,
                        compute_dtype: torch.dtype | None = None,
                        dropout_rate: float = 0.0,
                        generator: torch.Generator | None = None,
                        spatial_impl: str = "einsum",
                        temporal_impl: str = "conv"
                        ) -> tuple[torch.Tensor, dict]:
    """One train-mode ST-GCN unit: ``(N, T, V, C_in) -> (N, T', V, C_out)``.

    Returns ``(out, new_state)``.  In mask mode the gradient lands on
    ``params["mask"]`` through ``adjacency * mask``.
    """
    a = effective_adjacency(params, adjacency)
    new_state = {}
    h, new_state["bn1"] = batchnorm_train(params["bn1"], state["bn1"], x)
    if residual:
        h = torch.relu(h)
    h = spatial_conv(params["spatial"], a, h, compute_dtype=compute_dtype,
                     impl=spatial_impl)
    if residual:
        h, new_state["bn2"] = batchnorm_train(params["bn2"], state["bn2"], h)
        h = temporal_conv(params["temporal"], torch.relu(h), stride=stride,
                          compute_dtype=compute_dtype, impl=temporal_impl)
        if "residual_proj" in params:
            shortcut = pointwise_conv(params["residual_proj"], x,
                                      stride=stride)
        else:
            shortcut = x
        out = h + shortcut
    else:
        h = temporal_conv(params["temporal"], h, stride=stride,
                          compute_dtype=compute_dtype, impl=temporal_impl)
        out, new_state["bn2"] = batchnorm_train(params["bn2"], state["bn2"],
                                                h)
    return _relu_dropout(out, dropout_rate, generator), new_state


def _relu_dropout(out, dropout_rate, generator):
    out = torch.relu(out)
    if dropout_rate > 0.0:
        if generator is None:
            raise ValueError("dropout_rate > 0 in train mode needs a "
                             "generator")
        out = dropout(out, dropout_rate, generator=generator)
    return out


def block_forward_vm(params: dict, state: dict, x: torch.Tensor,
                     adjacency: torch.Tensor, *, stride: int = 1,
                     residual: bool = False, train: bool = False,
                     dropout_rate: float = 0.0,
                     generator: torch.Generator | None = None
                     ) -> tuple[torch.Tensor, dict]:
    """One ST-GCN unit on V-major ``(V, N, T, C_in) -> (V, N, T', C_out)``
    (port of ``block_forward_vm``, ``stgcn_tpu/ops/block.py:213-290``).

    Both convs run as the V-major kernels (``spatial_conv_fused_vm`` on
    ``(V, N*T, C)``, ``temporal_conv_fused_vm`` on ``(V*N, T, C)``), in
    ``x``'s dtype; the parameters are the ``(N, T, V, C)`` block's.  BN
    reduces every axis but the channels, so its statistics do not depend on
    the layout.  ``train`` uses the batch statistics and dropout; returns
    ``(out, new_state)``, ``state`` itself in eval.
    """
    a = effective_adjacency(params, adjacency)
    v, n, t, _ = x.shape

    def bn(key, h):
        if train:
            return batchnorm_train(params[key], state[key], h)
        return batchnorm_eval(params[key], state[key], h), state[key]

    def spatial(h):
        sp = params["spatial"]
        out = spatial_conv_fused_vm(h.reshape(v, n * t, h.shape[-1]),
                                    sp["w"], sp["b"], a.to(h.dtype))
        return out.reshape(v, n, t, out.shape[-1])

    def temporal(h):
        tp = params["temporal"]
        out = temporal_conv_fused_vm(h.reshape(v * n, t, h.shape[-1]),
                                     tp["w"][:, 0], tp["b"], stride)
        return out.reshape(v, n, -1, out.shape[-1])

    new_state = {}
    h, new_state["bn1"] = bn("bn1", x)
    if residual:
        h = spatial(torch.relu(h))
        h, new_state["bn2"] = bn("bn2", h)
        h = temporal(torch.relu(h))
        if "residual_proj" in params:
            # a plain product: outside any Pallas kernel in the JAX package
            # too (stgcn_tpu/ops/block.py:266-273)
            rp = params["residual_proj"]
            xs = x[:, :, ::stride] if stride != 1 else x
            acc = stat_dtype(xs)
            short = ((xs.to(acc) @ rp["w"].to(x.dtype).to(acc)).to(x.dtype)
                     + rp["b"].to(x.dtype))
        else:
            short = x
        out = h + short
    else:
        h = temporal(spatial(h))
        out, new_state["bn2"] = bn("bn2", h)
    if not train:
        return torch.relu(out), state
    return _relu_dropout(out, dropout_rate, generator), new_state
