"""Whole-network eval forward built on the fused block kernel.

Port of ``fused_block_args`` and ``fused_eval_forward``
(``stgcn_tpu/models/fused.py:23-160``).  BatchNorms fold into per-channel
affines from the running statistics, and every block runs as one
:func:`stgcn_tpu_torch.kernels.block_eval.block_eval` call whose
spatial->temporal intermediate stays on chip.  Blocks pass logical
``(V, N, T, C)`` tensors to each other: the TPU version's padded-T and
packed-row chaining were layout workarounds for Mosaic and have no
counterpart here, so the port also has no counterpart of the fault in the
TPU chaining (``stgcn_tpu/models/fused.py:127``, ROADMAP.md queue 3).
The global pool and the classifier head stay plain PyTorch.
"""

from __future__ import annotations

import torch

from stgcn_tpu_torch.kernels.block_eval import block_eval
from stgcn_tpu_torch.ops.batchnorm import fold_batchnorm_eval, stat_dtype
from stgcn_tpu_torch.ops.block import effective_adjacency
from stgcn_tpu_torch.ops.common import linear


def fused_block_args(bp: dict, bs: dict, adjacency: torch.Tensor, *,
                     residual: bool, stride: int) -> dict:
    """Fold one block's parameters and BN statistics (the JAX package's
    layout, as ``STGCNBlock.params_and_state`` gives them) into
    ``block_eval`` arguments."""
    s1, t1 = fold_batchnorm_eval(bp["bn1"], bs["bn1"])
    s2, t2 = fold_batchnorm_eval(bp["bn2"], bs["bn2"])
    wr = br = None
    if residual and "residual_proj" in bp:
        wr, br = bp["residual_proj"]["w"], bp["residual_proj"]["b"]
        shortcut = "proj"
    elif residual:
        shortcut = "id"
    else:
        shortcut = "none"
    return dict(
        s1=s1, t1=t1, w=bp["spatial"]["w"], b=bp["spatial"]["b"],
        a=effective_adjacency(bp, adjacency), wt=bp["temporal"]["w"][:, 0],
        bt=bp["temporal"]["b"], s2=s2, t2=t2, wr=wr, br=br, stride=stride,
        order="pre" if residual else "post", shortcut=shortcut,
        relu1=residual)


def fused_eval_forward(model, x: torch.Tensor,
                       time_mask: torch.Tensor | None = None) -> torch.Tensor:
    """Eval logits of ``model`` (an ``STGCN``), one kernel per block.

    Args:
      x: ``(N, T, V, C_in)`` batch on the model's device.
      time_mask: optional ``(N, T)`` contiguous-prefix validity mask; the
        kernels take per-sequence lengths and the pool averages the valid
        frames only.

    Returns ``(N, classes)`` logits in the compute dtype (softmax applied if
    the config says so).
    """
    cfg = model.config
    h = x.to(cfg.compute_dtype or cfg.dtype)
    lengths = None
    if time_mask is not None:
        lengths = time_mask.to(torch.int32).sum(dim=1)
        h = h * time_mask[:, :, None, None].to(h.dtype)
    h = h.permute(2, 0, 1, 3).contiguous()          # (V, N, T, C)
    for block in model.conv:
        bp, bs = block.params_and_state()
        kw = fused_block_args(bp, bs, model.adjacency, residual=cfg.residual,
                              stride=block.stride)
        h = block_eval(h, **kw, lengths=lengths)
        if lengths is not None:
            # valid frames after a same-padded strided conv: ceil(len / s)
            lengths = (lengths - 1) // block.stride + 1
    acc = stat_dtype(h)
    if lengths is None:
        pooled = h.to(acc).mean(dim=(0, 2))
    else:
        valid = (torch.arange(h.shape[2], device=h.device)[None, :]
                 < lengths[:, None])
        m = valid[None, :, :, None].to(acc)
        total = (h.to(acc) * m).sum(dim=(0, 2))
        count = lengths[:, None].to(acc) * h.shape[0]
        pooled = total / torch.clamp(count, min=1.0)
    logits = linear(model.head_params(h.dtype), pooled.to(h.dtype))
    if cfg.final_softmax:
        logits = torch.softmax(logits, dim=-1)
    return logits
