"""Temporal convolution over frame sequences (port of
``stgcn_tpu/ops/temporal_conv.py:39,235``).

The reference applies ``Conv2d(C, C, (gamma, 1), stride=(s, 1),
padding=(p, 0))`` (src/network/st_graphconv.py:40-43).  Here it runs on
channel-last ``(N, T, V, C)`` activations with the JAX package's weight
layout ``(gamma, 1, C_in, C_out)``, through ``torch.nn.functional.conv2d``
in at least float32.  On a GPU that call goes to cuDNN, which uses TF32 for
float32 unless ``torch.backends.cudnn.allow_tf32`` is False.

``impl="pallas"`` runs the hand-written temporal-conv kernel instead
(:func:`stgcn_tpu_torch.kernels.temporal_conv.temporal_conv_fused`, the port
of the Pallas ``temporal_conv_fused``); ``"auto"`` is ``"conv"``, the JAX
package's pick off the TPU (``stgcn_tpu/ops/temporal_conv.py:82-98``).  Its
``"conv_vt"``, ``"shift_sum"`` and ``"block"`` impls are not ported.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from stgcn_tpu_torch.kernels.temporal_conv import temporal_conv_fused
from stgcn_tpu_torch.ops.batchnorm import stat_dtype

TEMPORAL_IMPLS = ("auto", "conv", "pallas")
# the JAX package's XLA formulations, which the port does not carry
UNPORTED_TEMPORAL_IMPLS = ("conv_vt", "shift_sum", "block")


def temporal_conv(params: dict, x: torch.Tensor, *, stride: int = 1,
                  compute_dtype: torch.dtype | None = None,
                  impl: str = "conv") -> torch.Tensor:
    """``(N, T, V, C_in) -> (N, T_out, V, C_out)``, with the reference's
    ``(gamma - 1) // 2`` frames of zero padding on both ends.

    ``impl``: ``"conv"`` or ``"auto"`` (``F.conv2d``), or ``"pallas"`` (the
    kernel, with ``x`` and the taps cast to ``compute_dtype`` and the bias
    as it comes).
    """
    w = params["w"]                      # (gamma, 1, C_in, C_out)
    if impl == "pallas":
        h, taps = x, w[:, 0]
        if compute_dtype is not None:
            h, taps = h.to(compute_dtype), taps.to(compute_dtype)
        return temporal_conv_fused(h, taps, params["b"], stride).to(x.dtype)
    if impl not in ("auto", "conv"):
        raise ValueError(f"temporal_impl must be one of {TEMPORAL_IMPLS}, "
                         f"got {impl!r}")
    padding = (w.shape[0] - 1) // 2
    out_dtype = x.dtype
    acc = stat_dtype(x)
    cd = compute_dtype or x.dtype
    xc = x.to(cd).to(acc).permute(0, 3, 1, 2)          # (N, C_in, T, V)
    wc = w.to(cd).to(acc).permute(3, 2, 0, 1)          # (C_out, C_in, g, 1)
    out = F.conv2d(xc, wc, stride=(stride, 1), padding=(padding, 0))
    out = out.permute(0, 2, 3, 1)
    if compute_dtype is not None:
        # the JAX package runs this conv wholly in the compute dtype
        out = out.to(compute_dtype)
    return (out + params["b"].to(out.dtype)).to(out_dtype)


def pointwise_conv(params: dict, x: torch.Tensor, *,
                   stride: int = 1) -> torch.Tensor:
    """1x1 conv with temporal stride (the residual projection,
    src/network/st_graphconv.py:28): subsample frames, then a channel
    matmul accumulated in at least float32."""
    if stride != 1:
        x = x[:, ::stride]
    acc = stat_dtype(x)
    out = torch.einsum("ntvi,io->ntvo", x.to(acc),
                       params["w"].to(x.dtype).to(acc))
    return (out + params["b"].to(x.dtype).to(acc)).to(x.dtype)
