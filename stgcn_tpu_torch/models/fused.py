"""Whole-network forwards built on the fused block kernels.

Eval: port of ``fused_block_args``, ``fused_eval_forward`` and
``hybrid_eval_forward`` (``stgcn_tpu/models/fused.py:23-160``, ``:465-513``),
on the parameter dictionaries of :meth:`STGCN.init_params` or
:meth:`STGCN.params_and_state`.  BatchNorms fold into per-channel affines
from the running statistics, and every fused block runs as one
:func:`stgcn_tpu_torch.kernels.block_eval.block_eval` call whose
spatial->temporal intermediate stays on chip; the hybrid runs the other
blocks on the ``(N, T, V, C)`` op chain.  Blocks pass logical
``(V, N, T, C)`` tensors to each other: the TPU version's padded-T and
packed-row chaining were layout workarounds for Mosaic and have no
counterpart here, so the port also has no counterpart of the fault in the
TPU chaining (``stgcn_tpu/models/fused.py:127``, ROADMAP.md queue 3).
The global pool and the classifier head stay plain PyTorch.

Train: port of ``_bn_affine_train``, ``block_forward_fused_train``,
``fused_train_forward``, ``hybrid_fused_set`` and ``hybrid_train_forward``
(``stgcn_tpu/models/fused.py:174-462``).  A fused train block is two
differentiable ops, ``kernels.spatial_block.spatial_block`` (or
``spatial_block_save`` where the graph trains and ``C_in >= 256``, as the
JAX package routes it) and ``kernels.temporal_block.temporal_block``, with
the BatchNorm batch statistics outside them as a differentiable per-channel
affine, so the whole BN gradient flows through the ops' ``ds``/``dt``.  The
shortcut add, the final ReLU and dropout are one op,
``kernels.unit_tail.unit_tail``, on dropout's draw from the generator (one
draw a unit, in unit order); the shortcut's projection stays a PyTorch
matmul.  The hybrid runs the blocks of ``hybrid_fused_set`` fused on
V-major ``(V, N, T, C)`` activations and the others on the ``(N, T, V,
C)`` op chain, transposing only where the regime changes.  The parameters
are the JAX package's dictionaries (:meth:`STGCN.init_params`), with the
mask mode's ``mask`` kept apart from the fixed adjacency.
"""

from __future__ import annotations

import torch

from stgcn_tpu_torch.kernels.block_eval import block_eval
from stgcn_tpu_torch.kernels.spatial_block import (
    spatial_block,
    spatial_block_save,
)
from stgcn_tpu_torch.kernels.temporal_block import temporal_block
from stgcn_tpu_torch.kernels.unit_tail import unit_tail
from stgcn_tpu_torch.ops.batchnorm import (
    batch_moments,
    batchnorm_train,
    fold_batchnorm_eval,
    running_update,
    stat_dtype,
)
from stgcn_tpu_torch.ops.block import (
    block_forward,
    block_forward_train,
    effective_adjacency,
)
from stgcn_tpu_torch.ops.common import dropout_draw, linear
from stgcn_tpu_torch.models.stgcn import _cast_tree
from stgcn_tpu_torch.utils.profiling import boundary, mark


def fused_block_args(bp: dict, bs: dict, adjacency: torch.Tensor, *,
                     residual: bool, stride: int) -> dict:
    """Fold one block's parameters and BN statistics (the JAX package's
    layout, as :meth:`STGCN.init_params` or ``STGCNBlock.params_and_state``
    give them) into ``block_eval`` arguments."""
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


def fused_eval_forward(model, params: dict, state: dict, x: torch.Tensor,
                       *, time_mask: torch.Tensor | None = None
                       ) -> torch.Tensor:
    """Eval logits of ``model`` (an ``STGCN``) with the weights ``params``
    and BN statistics ``state``, one kernel per block.

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
    for i, (_, stride) in enumerate(cfg.plan):
        kw = fused_block_args(params["blocks"][i], state["blocks"][i],
                              model.adjacency, residual=cfg.residual,
                              stride=stride)
        h = block_eval(h, **kw, lengths=lengths)
        if lengths is not None:
            # valid frames after a same-padded strided conv: ceil(len / s)
            lengths = (lengths - 1) // stride + 1
    if lengths is None:
        return _pool_head(cfg, params, h, (0, 2))
    acc = stat_dtype(h)
    valid = (torch.arange(h.shape[2], device=h.device)[None, :]
             < lengths[:, None])
    m = valid[None, :, :, None].to(acc)
    total = (h.to(acc) * m).sum(dim=(0, 2))
    count = lengths[:, None].to(acc) * h.shape[0]
    return _head(cfg, params, total / torch.clamp(count, min=1.0), h.dtype)


def hybrid_eval_forward(model, params: dict, state: dict,
                        x: torch.Tensor) -> torch.Tensor:
    """Eval logits: the blocks of :func:`hybrid_fused_set` as one
    ``block_eval`` launch each on V-major activations, the others on the
    ``(N, T, V, C)`` op chain (its ``spatial_impl``/``temporal_impl``),
    transposing only where the regime changes."""
    cfg = model.config
    cd = cfg.compute_dtype
    fused_set = hybrid_fused_set(cfg)
    h, layout = x.to(cd or cfg.dtype), "ntvc"
    for i, (_, stride) in enumerate(cfg.plan):
        h, layout = _to_layout(h, layout,
                               "vntc" if i in fused_set else "ntvc")
        bp, bs = params["blocks"][i], state["blocks"][i]
        if layout == "vntc":
            h = block_eval(h, **fused_block_args(
                bp, bs, model.adjacency, residual=cfg.residual,
                stride=stride))
        else:
            h = block_forward(
                _cast_tree(bp, cd) if cd else bp, bs, h, model.adjacency,
                stride=stride, residual=cfg.residual, compute_dtype=cd,
                spatial_impl=cfg.spatial_impl,
                temporal_impl=cfg.temporal_impl)
    return _pool_head(cfg, params, h, (0, 2) if layout == "vntc" else (1, 2))


def _to_layout(h: torch.Tensor, layout: str, want: str
               ) -> tuple[torch.Tensor, str]:
    """``h`` transposed between ``(N, T, V, C)`` ("ntvc") and
    ``(V, N, T, C)`` ("vntc") if ``want`` differs from ``layout``."""
    if want == layout:
        return h, layout
    perm = (2, 0, 1, 3) if want == "vntc" else (1, 2, 0, 3)
    return h.permute(perm).contiguous(), want


def _pool_head(cfg, params: dict, h: torch.Tensor, axes) -> torch.Tensor:
    """Logits from the float32 mean of ``h`` over the joint and frame
    ``axes``."""
    return _head(cfg, params, h.to(stat_dtype(h)).mean(dim=axes), h.dtype)


def _head(cfg, params: dict, pooled: torch.Tensor,
          dtype: torch.dtype) -> torch.Tensor:
    """The classifier on ``pooled`` cast to the activations' ``dtype``, its
    weights cast alike (the op path casts every weight at ``apply``)."""
    logits = linear(_cast_tree(params["fc"], dtype), pooled.to(dtype))
    if cfg.final_softmax:
        logits = torch.softmax(logits, dim=-1)
    return logits


def bn_affine_train(bn_params: dict, bn_state: dict, x: torch.Tensor, *,
                    momentum: float = 0.1, eps: float = 1e-5, group=None
                    ) -> tuple[torch.Tensor, torch.Tensor, dict]:
    """Batch-statistic BN as a differentiable affine ``(s, t, new_state)``.

    Statistics over every axis but the last, as ``batchnorm_train`` takes
    them; ``x * s + t`` is the normalized ``x``, and ``s``, ``t`` depend on
    ``x`` through the mean and variance, so autograd carries the full BN
    gradient through the fused ops' ``ds`` and ``dt``.  With ``group`` the
    statistics are the whole batch's that its ranks hold in equal shards
    (``batch_moments``; the JAX ``axis_name`` path,
    ``stgcn_tpu/models/fused.py:196-199``).
    """
    mean, var, n = batch_moments(x, group)
    s = bn_params["scale"].to(mean.dtype) * torch.rsqrt(var + eps)
    t = bn_params["offset"].to(mean.dtype) - mean * s
    return s, t, running_update(bn_state, mean, var, n, momentum)


def block_forward_fused_train(bp: dict, bs: dict, x: torch.Tensor,
                              adjacency: torch.Tensor, *, stride: int,
                              residual: bool, dropout_rate: float = 0.0,
                              generator: torch.Generator | None = None,
                              dropout_impl: str = "exact", bn_group=None
                              ) -> tuple[torch.Tensor, dict]:
    """One train-mode block on V-major ``(V, N, T, C_in)``: the spatial and
    temporal ops, BN statistics (over ``bn_group``'s ranks with one),
    shortcut, and the tail's add, ReLU and dropout as one op
    (:func:`~stgcn_tpu_torch.kernels.unit_tail.unit_tail`).  Returns
    ``(out, new_state)``.

    While a profiler records, the tensors between the phases pass through
    :func:`~stgcn_tpu_torch.utils.profiling.boundary`, which marks
    ``bn_stats``, ``spatial``, ``bn_stats``, ``temporal`` and ``tail`` in
    the forward and the same in reverse in the backward; each weight is
    cast in the phase that uses it."""
    cd = x.dtype
    new_state = {}
    x = boundary("bn_stats", "tail", x)
    s1, t1, new_state["bn1"] = bn_affine_train(bp["bn1"], bs["bn1"], x,
                                               group=bn_group)
    s1, t1 = boundary("spatial", "bn_stats", s1, t1)
    a = effective_adjacency(bp, adjacency).to(cd)
    # a fixed graph has no trained adjacency: skip the backward's y_k pass
    need_da = "A" in bp or "mask" in bp
    w, b = bp["spatial"]["w"].to(cd), bp["spatial"]["b"].to(cd)
    if need_da and x.shape[-1] >= 256:
        # wide blocks save y_k for dA rather than recompute it, as the JAX
        # package routes them (stgcn_tpu/models/fused.py:259-268)
        z = spatial_block_save(x, s1, t1, w, b, a, relu1=residual)
    else:
        z = spatial_block(x, s1, t1, w, b, a, relu1=residual,
                          need_da=need_da)
    if residual:
        z = boundary("bn_stats", "spatial", z)
        s2, t2, new_state["bn2"] = bn_affine_train(bp["bn2"], bs["bn2"], z,
                                                   group=bn_group)
        s2, t2 = boundary("temporal", "bn_stats", s2, t2)
        wt = bp["temporal"]["w"][:, 0].to(cd)
        bt = bp["temporal"]["b"].to(torch.float32)
        u = temporal_block(z, s2, t2, wt, bt, stride=stride, relu2=True)
        u = boundary("tail", "temporal", u)
        if "residual_proj" in bp:
            rp, acc = bp["residual_proj"], stat_dtype(x)
            xs = x[:, :, ::stride] if stride != 1 else x
            short = ((xs.to(acc) @ rp["w"].to(cd).to(acc)).to(cd)
                     + rp["b"].to(cd))
        else:
            short = x
    else:
        z = boundary("temporal", "spatial", z)
        wt = bp["temporal"]["w"][:, 0].to(cd)
        bt = bp["temporal"]["b"].to(torch.float32)
        c_out = wt.shape[-1]
        ident_s = torch.ones(c_out, dtype=torch.float32, device=x.device)
        u = temporal_block(z, ident_s, torch.zeros_like(ident_s), wt, bt,
                           stride=stride, relu2=False)
        u = boundary("bn_stats", "temporal", u)
        out, new_state["bn2"] = batchnorm_train(bp["bn2"], bs["bn2"], u,
                                                group=bn_group)
        u, short = boundary("tail", "bn_stats", out), None
    draw = keep_below = scale = None
    if dropout_rate > 0.0:
        if generator is None:
            raise ValueError("dropout_rate > 0 in train mode needs a "
                             "generator")
        draw, keep_below, scale = dropout_draw(
            u.shape, dropout_rate, generator=generator, device=u.device,
            impl=dropout_impl)
    return unit_tail(u, short, draw, keep_below, scale), new_state


def hybrid_fused_set(cfg) -> frozenset:
    """The block indices the hybrid runs fused: ``fused_blocks`` if given,
    else the ``[fused_from, n)`` suffix."""
    if cfg.fused_blocks is not None:
        return frozenset(cfg.fused_blocks)
    return frozenset(range(cfg.fused_from, len(cfg.plan)))


def _train_forward(model, params: dict, state: dict, x: torch.Tensor,
                   fused_set, generator, bn_group=None
                   ) -> tuple[torch.Tensor, dict]:
    cfg = model.config
    cd = cfg.compute_dtype
    mark("input", x.device)
    h, layout = x.to(cd or cfg.dtype), "ntvc"
    new_blocks = []
    for i, (_, stride) in enumerate(cfg.plan):
        h, layout = _to_layout(h, layout,
                               "vntc" if i in fused_set else "ntvc")
        if layout == "vntc":
            h, s = block_forward_fused_train(
                params["blocks"][i], state["blocks"][i], h, model.adjacency,
                stride=stride, residual=cfg.residual,
                dropout_rate=cfg.dropout_rate, generator=generator,
                dropout_impl=cfg.dropout_impl, bn_group=bn_group)
        else:
            h, s = block_forward_train(
                _cast_tree(params["blocks"][i], cd) if cd else
                params["blocks"][i], state["blocks"][i], h,
                model.adjacency, stride=stride, residual=cfg.residual,
                compute_dtype=cd, dropout_rate=cfg.dropout_rate,
                generator=generator, dropout_impl=cfg.dropout_impl,
                spatial_impl=cfg.spatial_impl,
                temporal_impl=cfg.temporal_impl, bn_group=bn_group)
        new_blocks.append(s)
    h = boundary("head", "tail", h)
    logits = _pool_head(cfg, params, h, (0, 2) if layout == "vntc"
                        else (1, 2))
    return logits, {"blocks": new_blocks}


def fused_train_forward(model, params: dict, state: dict, x: torch.Tensor, *,
                        generator: torch.Generator | None = None,
                        bn_group=None) -> tuple[torch.Tensor, dict]:
    """Train logits and new BN state with every block on the fused ops;
    with ``bn_group`` the BN statistics are its ranks' whole batch (the
    data-parallel step, :mod:`stgcn_tpu_torch.parallel.fused_dp`)."""
    return _train_forward(model, params, state, x,
                          frozenset(range(len(model.config.plan))), generator,
                          bn_group)


def hybrid_train_forward(model, params: dict, state: dict, x: torch.Tensor,
                         *, generator: torch.Generator | None = None
                         ) -> tuple[torch.Tensor, dict]:
    """Train logits and new BN state: the blocks of
    :func:`hybrid_fused_set` on the fused ops, the rest on the op chain."""
    return _train_forward(model, params, state, x,
                          hybrid_fused_set(model.config), generator)
