"""Affine(+ReLU) + temporal conv as one op: kernels, plain versions, autograd.

:func:`temporal_block` is the train path's temporal op on V-major
``(V, N, T, C)`` activations::

    u[t] = round(sum_g zh[t*s - pad + g] . Wt_g + bt),
    zh   = round(relu?(z * s2 + t2)), zero on the (gamma-1)/2 padding frames

It is the port of ``temporal_block_vm`` (``stgcn_tpu/kernels/block_fused.py``)
and ``temporal_block_packed`` (``stgcn_tpu/kernels/block_packed.py``), both of
which compute this function (the packed one for stride 1).  The op is a
``torch.autograd.Function`` whose forward and backward each launch one
hand-written CUDA kernel (``csrc/temporal_block.cu``) for a CUDA tensor, and
run the plain PyTorch versions :func:`temporal_block_forward_reference` and
:func:`temporal_block_backward_reference`, which round at the same points,
for a CPU tensor.

``temporal_block_forward.launches`` and ``temporal_block_backward.launches``
count the kernel launches, and nothing else.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from stgcn_tpu_torch.kernels.block_eval import SMEM_LIMIT, t_out_of
from stgcn_tpu_torch.kernels.spatial_block import (
    _acc,
    _check_cuda,
    _raise_on,
    partial_ctas,
)

FRAME_TILES = (16, 8, 4, 2, 1)


def check_args(z, wt, *, square: bool = True):
    """``z`` is ``(V, N, T, C)`` and ``wt`` ``(odd gamma, C, C_out)``, with
    ``C_out == C`` where ``square`` (the kernel of this op needs it; the
    plain versions take any ``C_out``)."""
    if z.dim() != 4:
        raise ValueError(f"z must be (V, N, T, C), got {tuple(z.shape)}")
    c = z.shape[-1]
    if (wt.dim() != 3 or wt.shape[1] != c or wt.shape[0] % 2 != 1
            or (square and wt.shape[2] != c)):
        want = f"(odd gamma, {c}, {c})" if square else f"(odd gamma, {c}, C_out)"
        raise ValueError(f"wt must be {want}, got {tuple(wt.shape)}")


def _post_activation(z, s2, t2, relu2, acc):
    zf = z.to(acc)
    pre = zf * s2.to(acc) + t2.to(acc)
    h = torch.relu(pre) if relu2 else pre
    return zf, pre, h.to(z.dtype).to(acc)


def temporal_block_forward_reference(z, s2, t2, wt, bt, *, stride: int,
                                     relu2: bool):
    """Plain PyTorch version of the forward kernel, same rounding points.

    ``z``: ``(V, N, T, C)``; ``s2, t2``: ``(C,)``; ``wt``:
    ``(gamma, C, C_out)`` in ``z``'s dtype; ``bt``: ``(C_out,)``.  Returns
    ``(V, N, T_out, C_out)``.
    """
    check_args(z, wt, square=False)
    acc = _acc(z.dtype)
    gamma, t = wt.shape[0], z.shape[2]
    pad = (gamma - 1) // 2
    t_out = t_out_of(t, stride, gamma)
    _, _, h = _post_activation(z, s2, t2, relu2, acc)
    hp = F.pad(h, (0, 0, pad, pad))
    u = None
    for g in range(gamma):
        tap = hp[:, :, g:g + stride * (t_out - 1) + 1:stride] @ wt[g].to(acc)
        u = tap if u is None else u + tap
    return (u + bt.to(acc)).to(z.dtype)


def temporal_block_backward_reference(z, g, s2, t2, wt, bt, *, stride: int,
                                      relu2: bool):
    """Plain PyTorch version of the backward kernel, written out (not left
    to autograd) with the rounding points of ``_temporal_bwd_kernel``.

    Returns ``(dz, ds2, dt2, dwt, dbt)``, each in its input's dtype.
    """
    check_args(z, wt, square=False)
    acc = _acc(z.dtype)
    gamma, t = wt.shape[0], z.shape[2]
    pad = (gamma - 1) // 2
    t_out = t_out_of(t, stride, gamma)
    zf, pre, h = _post_activation(z, s2, t2, relu2, acc)
    hp = F.pad(h, (0, 0, pad, pad))
    gf = g.to(z.dtype).to(acc)
    dhp = torch.zeros_like(hp)
    dwt = torch.zeros(wt.shape, dtype=acc, device=z.device)
    span = stride * (t_out - 1) + 1
    for k in range(gamma):
        dwt[k] = torch.einsum("vnti,vnto->io", hp[:, :, k:k + span:stride], gf)
        dhp[:, :, k:k + span:stride] += gf @ wt[k].to(acc).t()
    dpre = dhp[:, :, pad:pad + t]
    if relu2:
        dpre = torch.where(pre > 0, dpre, torch.zeros_like(dpre))
    axes = (0, 1, 2)
    return ((dpre * s2.to(acc)).to(z.dtype),
            (dpre * zf).sum(dim=axes).to(s2.dtype),
            dpre.sum(dim=axes).to(t2.dtype), dwt.to(wt.dtype),
            gf.sum(dim=axes).to(bt.dtype))


def _plan(v: int, c: int, frames_of) -> tuple[int, int, int]:
    for groups in range(1, v + 1):
        vg = -(-v // groups)
        for tile in FRAME_TILES:
            smem = 4 * frames_of(tile) * vg * c
            if smem <= SMEM_LIMIT:
                return tile, vg, smem
    raise ValueError(f"no temporal tile of C={c} fits in {SMEM_LIMIT} bytes "
                     f"of shared memory")


def plan_forward(v: int, c: int, stride: int, gamma: int
                 ) -> tuple[int, int, int]:
    """``(TT, VG, shared bytes)``: output frames and joints per forward CTA,
    all joints where possible; the CTA holds ``(TT-1)*s + gamma`` frames."""
    return _plan(v, c, lambda tt: (tt - 1) * stride + gamma)


def plan_backward(v: int, c: int, gamma: int) -> tuple[int, int, int]:
    """``(FT, VG, shared bytes)``: input frames and joints per backward work
    item; the CTA holds its FT frames and the rows of g whose taps reach
    them, spread over ``FT + gamma - 1`` frame positions."""
    return _plan(v, c, lambda ft: 2 * ft + gamma - 1)


def temporal_block_forward(z, s2, t2, wt, bt, *, stride: int, relu2: bool):
    """Forward kernel wrapper: plain version on the CPU, kernel on CUDA."""
    if z.device.type == "cpu":
        return temporal_block_forward_reference(z, s2, t2, wt, bt,
                                                stride=stride, relu2=relu2)
    if z.device.type != "cuda":
        raise ValueError(f"temporal_block runs on cuda or cpu, not {z.device}")
    return _launch_forward(z, s2, t2, wt, bt, stride=stride, relu2=relu2)


def _launch_forward(z, s2, t2, wt, bt, *, stride, relu2):
    from stgcn_tpu_torch.kernels._build import load_library

    check_args(z, wt)
    _check_cuda("temporal_block", z, (s2, t2, wt, bt))
    v, n, t, c = z.shape
    gamma = wt.shape[0]
    t_out = t_out_of(t, stride, gamma)
    tt, vg, smem = plan_forward(v, c, stride, gamma)
    cd, f32 = z.dtype, torch.float32
    args = [z.contiguous(), s2.to(f32).contiguous(), t2.to(f32).contiguous(),
            wt.to(cd).contiguous(), bt.to(f32).contiguous()]
    out = torch.empty((v, n, t_out, c), dtype=cd, device=z.device)
    lib = load_library()
    with torch.cuda.device(z.device):
        err = lib.temporal_block_fwd_launch(
            *[p.data_ptr() for p in args], out.data_ptr(), v, n, t, c, gamma,
            stride, t_out, tt, vg, int(relu2), int(cd == torch.bfloat16),
            smem, torch.cuda.current_stream(z.device).cuda_stream)
    _raise_on(lib, err, "temporal_block forward")
    temporal_block_forward.launches += 1
    return out


temporal_block_forward.launches = 0


def temporal_block_backward(z, g, s2, t2, wt, bt, *, stride: int,
                            relu2: bool):
    """Backward kernel wrapper: ``(dz, ds2, dt2, dwt, dbt)``, each in its
    input's dtype.  Plain version on the CPU, kernel on CUDA."""
    if z.device.type == "cpu":
        return temporal_block_backward_reference(
            z, g, s2, t2, wt, bt, stride=stride, relu2=relu2)
    if z.device.type != "cuda":
        raise ValueError(f"temporal_block runs on cuda or cpu, not {z.device}")
    return _launch_backward(z, g, s2, t2, wt, bt, stride=stride, relu2=relu2)


def _launch_backward(z, g, s2, t2, wt, bt, *, stride, relu2):
    from stgcn_tpu_torch.kernels._build import load_library

    check_args(z, wt)
    _check_cuda("temporal_block", z, (g, s2, t2, wt, bt))
    v, n, t, c = z.shape
    gamma = wt.shape[0]
    t_out = t_out_of(t, stride, gamma)
    if tuple(g.shape) != (v, n, t_out, c):
        raise ValueError(f"g must be {(v, n, t_out, c)}, got "
                         f"{tuple(g.shape)}")
    ft, vg, smem = plan_backward(v, c, gamma)
    items = -(-t // ft) * n * -(-v // vg)
    ctas = min(partial_ctas(z.device), items)
    cd, f32 = z.dtype, torch.float32
    args = [z.contiguous(), g.to(cd).contiguous(), s2.to(f32).contiguous(),
            t2.to(f32).contiguous(),
            wt.to(cd).transpose(1, 2).contiguous()]      # (gamma, C_out, C_in)
    sizes = (gamma * c * c, c, c, c)
    dz = torch.empty_like(args[0])
    partial = torch.empty((ctas, sum(sizes)), dtype=f32, device=z.device)
    grads = torch.empty(sum(sizes), dtype=f32, device=z.device)
    lib = load_library()
    with torch.cuda.device(z.device):
        err = lib.temporal_block_bwd_launch(
            *[p.data_ptr() for p in args], dz.data_ptr(), partial.data_ptr(),
            grads.data_ptr(), v, n, t, c, gamma, stride, t_out, ft, vg, ctas,
            int(relu2), int(cd == torch.bfloat16), smem,
            torch.cuda.current_stream(z.device).cuda_stream)
    _raise_on(lib, err, "temporal_block backward")
    temporal_block_backward.launches += 1
    dwt, dbt, ds2, dt2 = torch.split(grads, sizes)
    return (dz, ds2.to(s2.dtype), dt2.to(t2.dtype),
            dwt.view(gamma, c, c).to(wt.dtype), dbt.to(bt.dtype))


temporal_block_backward.launches = 0


class _TemporalBlock(torch.autograd.Function):
    @staticmethod
    def forward(ctx, z, s2, t2, wt, bt, stride, relu2):
        ctx.save_for_backward(z, s2, t2, wt, bt)
        ctx.flags = dict(stride=stride, relu2=relu2)
        return temporal_block_forward(z, s2, t2, wt, bt, **ctx.flags)

    @staticmethod
    def backward(ctx, g):
        z, s2, t2, wt, bt = ctx.saved_tensors
        return (*temporal_block_backward(z, g.contiguous(), s2, t2, wt, bt,
                                         **ctx.flags), None, None)


def temporal_block(z, s2, t2, wt, bt, *, stride: int, relu2: bool):
    """The differentiable temporal op: ``(V, N, T, C) -> (V, N, T_out, C)``
    with same-padding ``(gamma-1)/2`` and stride ``stride``."""
    return _TemporalBlock.apply(z, s2, t2, wt, bt, stride, relu2)
