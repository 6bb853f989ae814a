"""Temporal convolution over frame sequences (port of
``stgcn_tpu/ops/temporal_conv.py:39,235``).

The reference applies ``Conv2d(C, C, (gamma, 1), stride=(s, 1),
padding=(p, 0))`` (src/network/st_graphconv.py:40-43).  Here it runs on
channel-last ``(N, T, V, C)`` activations with the JAX package's weight
layout ``(gamma, 1, C_in, C_out)``, through ``torch.nn.functional.conv2d``
in at least float32.  On a GPU that call goes to cuDNN, which uses TF32 for
float32 unless ``torch.backends.cudnn.allow_tf32`` is False.

``impl`` picks the formulation, as in the JAX package
(``stgcn_tpu/ops/temporal_conv.py:39-228``):

* ``"conv"`` (and ``"auto"``, the JAX package's pick off the TPU,
  ``:82-98``): ``F.conv2d`` with the window over T;
* ``"conv_vt"``: the same conv with the two spatial axes swapped, a
  ``(1, gamma)`` window over ``(N, C, V, T)``;
* ``"shift_sum"``: the sum over the ``gamma`` taps of a strided slice of
  the padded input times that tap's ``(C_in, C_out)`` matrix;
* ``"block"``: the block-Toeplitz product, ``T`` cut into blocks of 8
  output frames, each block's overlapping input span gathered from shifted
  reshapes and contracted with a banded ``(span, 8, C_in, C_out)`` weight in
  one ``einsum``;
* ``"pallas"``: the hand-written temporal-conv kernel
  (:func:`stgcn_tpu_torch.kernels.temporal_conv.temporal_conv_fused`, the
  port of the Pallas ``temporal_conv_fused``).

The JAX package computes ``conv_vt``, ``shift_sum`` and ``block`` with XLA
ops outside any Pallas kernel, so here they are PyTorch calls too.  With a
``compute_dtype``, ``conv`` and ``conv_vt`` round the conv's output to it
before the bias (the JAX package runs that conv wholly in the compute
dtype, and adds the bias in the dtype the two promote to), while ``shift_sum`` and ``block`` sum every tap in float32 and
round once after the bias (its ``preferred_element_type``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from stgcn_tpu_torch.kernels.temporal_conv import temporal_conv_fused
from stgcn_tpu_torch.ops.batchnorm import stat_dtype

TEMPORAL_IMPLS = ("auto", "conv", "conv_vt", "shift_sum", "block", "pallas")
# output frames per block of the block-Toeplitz formulation
BLOCK_FRAMES = 8


def temporal_conv(params: dict, x: torch.Tensor, *, stride: int = 1,
                  padding: int | None = None,
                  compute_dtype: torch.dtype | None = None,
                  impl: str = "conv") -> torch.Tensor:
    """``(N, T, V, C_in) -> (N, T_out, V, C_out)``, with ``padding`` frames
    of zeros on both ends: ``None`` is the reference's ``(gamma - 1) // 2``,
    0 the valid conv the time halo runs on a shard's frames and their
    neighbours' (``stgcn_tpu/ops/temporal_conv.py:44,78-79``).

    ``impl``: one of ``TEMPORAL_IMPLS`` (module docstring); ``"pallas"``
    casts ``x`` and the taps to ``compute_dtype`` and passes the bias as it
    comes.
    """
    w = params["w"]                      # (gamma, 1, C_in, C_out)
    if impl == "pallas":
        h, taps = x, w[:, 0]
        if compute_dtype is not None:
            h, taps = h.to(compute_dtype), taps.to(compute_dtype)
        return temporal_conv_fused(h, taps, params["b"], stride,
                                   padding).to(x.dtype)
    if impl not in TEMPORAL_IMPLS:
        raise ValueError(f"temporal_impl must be one of {TEMPORAL_IMPLS}, "
                         f"got {impl!r}")
    if padding is None:
        padding = (w.shape[0] - 1) // 2
    if impl in ("shift_sum", "block"):
        fn = _shift_sum if impl == "shift_sum" else _block_toeplitz
        out_dtype = x.dtype
        if compute_dtype is not None:
            x, w = x.to(compute_dtype), w.to(compute_dtype)
        acc = stat_dtype(x)
        out = fn(x.to(acc), w[:, 0].to(acc), stride, padding)
        return (out + params["b"].to(acc)).to(out_dtype)
    out_dtype = x.dtype
    acc = stat_dtype(x)
    cd = compute_dtype or x.dtype
    xc = x.to(cd).to(acc)
    wc = w.to(cd).to(acc)
    if impl == "conv_vt":
        out = F.conv2d(xc.permute(0, 3, 2, 1),          # (N, C_in, V, T)
                       wc.permute(3, 2, 1, 0),          # (C_out, C_in, 1, g)
                       stride=(1, stride), padding=(0, padding))
        out = out.permute(0, 3, 2, 1)
    else:
        out = F.conv2d(xc.permute(0, 3, 1, 2),          # (N, C_in, T, V)
                       wc.permute(3, 2, 0, 1),          # (C_out, C_in, g, 1)
                       stride=(stride, 1), padding=(padding, 0))
        out = out.permute(0, 2, 3, 1)
    if compute_dtype is not None:
        # the JAX package runs this conv wholly in the compute dtype, then
        # adds the bias in the dtype the two promote to
        out = out.to(compute_dtype)
    b = params["b"]
    sum_dtype = torch.promote_types(out.dtype, b.dtype)
    return (out.to(sum_dtype) + b.to(sum_dtype)).to(out_dtype)


def _t_out(t: int, gamma: int, stride: int, padding: int) -> int:
    return (t + 2 * padding - gamma) // stride + 1


def _shift_sum(x: torch.Tensor, w: torch.Tensor, stride: int,
               padding: int) -> torch.Tensor:
    """``out[t] = sum_g x_pad[t * stride + g] @ w[g]`` in ``x``'s dtype
    (port of ``_temporal_conv_shift_sum``, ``:210-228``); ``w`` is
    ``(gamma, C_in, C_out)``."""
    gamma = w.shape[0]
    t_out = _t_out(x.shape[1], gamma, stride, padding)
    xp = F.pad(x, (0, 0, 0, 0, padding, padding))
    out = None
    for g in range(gamma):
        sl = xp[:, g:g + stride * (t_out - 1) + 1:stride]
        term = torch.einsum("ntvi,io->ntvo", sl, w[g])
        out = term if out is None else out + term
    return out


def _block_toeplitz(x: torch.Tensor, w: torch.Tensor, stride: int,
                    padding: int) -> torch.Tensor:
    """The block-Toeplitz product (port of ``_temporal_conv_block``,
    ``:162-207``): for each block of ``BLOCK_FRAMES`` output frames, its
    span of ``u = BLOCK_FRAMES * stride + gamma - stride`` input frames,
    gathered from ``m`` shifted reshapes of the padded input, times the
    banded weight ``W2[u, j] = w[u - j * stride]``; ``w`` is
    ``(gamma, C_in, C_out)``."""
    gamma, c_in, c_out = w.shape
    n, t, v, _ = x.shape
    t_out = _t_out(t, gamma, stride, padding)
    nb = -(-t_out // BLOCK_FRAMES)              # output blocks
    bis = BLOCK_FRAMES * stride                 # input frames per block
    u = bis + gamma - stride                    # input span of a block
    m = -(-u // bis)                            # shifted copies needed
    # left: the reference padding; right: enough for every shifted reshape
    right = (nb + m - 1) * bis - t - padding
    xp = F.pad(x, (0, 0, 0, 0, padding, max(right, 0)))
    parts = [xp[:, i * bis:(i + nb) * bis].reshape(n, nb, bis, v, c_in)
             for i in range(m)]
    x2 = torch.cat(parts, dim=2)[:, :, :u]
    g = (torch.arange(u, device=x.device)[:, None]
         - torch.arange(BLOCK_FRAMES, device=x.device)[None, :] * stride)
    valid = (g >= 0) & (g < gamma)              # (u, block) tap in range
    w2 = torch.where(valid[:, :, None, None], w[g.clamp(0, gamma - 1)],
                     torch.zeros((), dtype=w.dtype, device=w.device))
    out = torch.einsum("nbuvi,ujio->nbjvo", x2, w2)
    return out.reshape(n, nb * BLOCK_FRAMES, v, c_out)[:, :t_out]


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
