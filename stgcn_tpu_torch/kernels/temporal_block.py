"""Affine(+ReLU) + temporal conv as one op: kernels, plain versions, autograd.

:func:`temporal_block` is the train path's temporal op on V-major
``(V, N, T, C)`` activations::

    u[t] = round(sum_g zh[t*s - pad + g] . Wt_g + bt),
    zh   = round(relu?(z * s2 + t2)), zero on the (gamma-1)/2 padding frames

It is the port of ``temporal_block_vm`` (``stgcn_tpu/kernels/block_fused.py``)
and ``temporal_block_packed`` (``stgcn_tpu/kernels/block_packed.py``), both of
which compute this function (the packed one for stride 1).  The op is a
``torch.autograd.Function`` whose forward and backward each run hand-written
CUDA kernels (``csrc/temporal_block.cu``) for a CUDA tensor: bfloat16 on the
tensor cores (:func:`plan_mma_forward`, :func:`plan_mma_backward`; the
backward is a dx kernel, a dWt kernel and the passes that sum their partial
slices), float32 on the scalar kernels (:func:`plan_forward`,
:func:`plan_backward`).  For a CPU tensor it runs the plain PyTorch versions
:func:`temporal_block_forward_reference` and
:func:`temporal_block_backward_reference`, which round at the same points.

``temporal_block_forward.launches`` and ``temporal_block_backward.launches``
count the op calls that launched kernels, one per call, and nothing else.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from stgcn_tpu_torch.kernels.block_eval import PAD, SMEM_LIMIT, pitch, t_out_of
from stgcn_tpu_torch.kernels.spatial_block import (
    MMA_KC,
    MMA_KR,
    _acc,
    _check_cuda,
    _f32,
    _ptr,
    _raise_on,
    _ring_bytes,
    dw_splits,
    dw_tile,
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
    """float32: ``(TT, VG, shared bytes)``, output frames and joints per
    forward CTA, all joints where possible; the CTA holds ``(TT-1)*s +
    gamma`` frames."""
    return _plan(v, c, lambda tt: (tt - 1) * stride + gamma)


def plan_backward(v: int, c: int, gamma: int) -> tuple[int, int, int]:
    """float32: ``(FT, VG, shared bytes)``, input frames and joints per
    backward work item; the CTA holds its FT frames and the rows of g whose
    taps reach them, spread over ``FT + gamma - 1`` frame positions."""
    return _plan(v, c, lambda ft: 2 * ft + gamma - 1)


# ---- bfloat16: the tensor-core kernels ---------------------------------
# shared rows are ``pitch(c)`` elements wide (block_eval.pitch, tap_mma.cuh)
# temporal_block.cu's mma_path::KC and KR equal spatial_block.cu's, so the
# two share the ring's byte count and the dW split planner
KC = MMA_KC    # weight rows per ring stage (mma_path::KC)
KR = MMA_KR    # dWt: rows of the GEMM's K per chunk (mma_path::KR)


def gemm_tile(n_out: int) -> tuple[int, int, int]:
    """``(WN, BM, BN)``: the 8 warps of a CTA are ``8/WN x WN`` tiles of
    32 x 32, so a CTA owns BM rows and BN of the ``n_out`` columns; N tiles
    of 128 above 64 columns, else of 64."""
    wn = 4 if n_out > 64 else 2
    return wn, 32 * (8 // wn), 32 * wn


def staged_rows(bm: int, rows_per_line: int, walk: int, ntap: int) -> int:
    """The most input rows a CTA of ``bm`` GEMM rows stages: each of the
    lines its rows touch needs ``(rows - 1) * walk + ntap`` of them."""
    segments = min(bm, -(-(bm - 1) // rows_per_line) + 1)
    return walk * (bm - segments) + segments * ntap


def parity_taps(gamma: int, stride: int, parity: int
                ) -> tuple[int, list[int], list[int]]:
    """dx of the input frames ``f = j*stride + parity``: ``(e0, taps,
    shifts)``; frame f takes tap ``taps[i]`` from g row ``j + shifts[i]``
    (``shifts[i] = e0 - i``), the only taps with ``t*s - pad + tap = f``:
    at stride 1 all of them, at stride 2 every other one."""
    pad = (gamma - 1) // 2
    tap0 = (parity + pad) % stride
    taps = list(range(tap0, gamma, stride))
    e0 = (parity + pad - tap0) // stride
    return e0, taps, [e0 - i for i in range(len(taps))]


def plan_mma_forward(t: int, c_in: int, c_out: int, stride: int,
                     gamma: int) -> tuple[int, int]:
    """``(WN, shared bytes)`` of the bf16 forward: the weight ring, the
    row offsets and the staged input frames of one CTA."""
    wn, bm, bn = gemm_tile(c_out)
    t_out = t_out_of(t, stride, gamma)
    rows = staged_rows(bm, t_out, stride, gamma)
    smem = _ring_bytes(bn) + 4 * bm + 2 * rows * pitch(c_in)
    if smem > SMEM_LIMIT:
        raise ValueError(f"no bf16 temporal tile of C_in={c_in} fits in "
                         f"{SMEM_LIMIT} bytes of shared memory")
    return wn, smem


def plan_mma_backward(lines: int, t: int, c_in: int, c_out: int,
                      stride: int, gamma: int, aff: bool, ctas: int) -> dict:
    """The bf16 backward's launch: the dx GEMM's ``wn_dx``, row tiles per
    parity ``tiles_x`` and ``dx_smem``; the dWt GEMM's
    ``nj_dw``, ``splits`` of ``split_rows`` rows (about ``ctas`` CTAs in
    all) and ``dw_smem``."""
    t_out = t_out_of(t, stride, gamma)
    wn_dx, bm, bn = gemm_tile(c_in)
    rows = 0
    for parity in range(stride):
        per_line = -(-(t - parity) // stride)
        if per_line > 0:
            ntap = len(parity_taps(gamma, stride, parity)[1])
            rows = max(rows, staged_rows(bm, per_line, 1, ntap))
    dx_smem = (_ring_bytes(bn) + 4 * bm + (2 * 4 * (8 // wn_dx) * bn
                                           if aff else 0)
               + 2 * rows * pitch(c_out))
    nj_dw, bm_dw, bn_dw = dw_tile(c_out)
    dw_smem = 2 * KR * ((bm_dw + PAD) + (bn_dw + PAD)) * 2
    if max(dx_smem, dw_smem) > SMEM_LIMIT:
        raise ValueError(f"no bf16 temporal tile of C_out={c_out} fits in "
                         f"{SMEM_LIMIT} bytes of shared memory")
    splits, split_rows = dw_splits(lines * t_out, gamma, c_in, c_out, ctas)
    return dict(wn_dx=wn_dx, tiles_x=-(-lines * -(-t // stride) // bm),
                dx_smem=dx_smem, nj_dw=nj_dw, splits=splits,
                split_rows=split_rows, dw_smem=dw_smem)


def launch_mma_forward(x, s2, t2, w, b, *, v, n, t, stride, relu2, aff,
                       vmajor, out_shape):
    """Launch the bf16 forward kernel of either op on ``x`` (V-major, or
    ``(N, T, V, C)``, as ``(V, N, T)`` joints, sequences and frames);
    ``s2``, ``t2`` are None without the affine."""
    from stgcn_tpu_torch.kernels._build import load_library

    gamma, c_in, c_out = w.shape
    wn, smem = plan_mma_forward(t, c_in, c_out, stride, gamma)
    args = [x.contiguous(), _f32(s2), _f32(t2), w.to(x.dtype).contiguous(),
            _f32(b)]
    out = torch.empty(out_shape, dtype=x.dtype, device=x.device)
    lib = load_library()
    with torch.cuda.device(x.device):
        err = lib.temporal_mma_fwd_launch(
            *[_ptr(p) for p in args], out.data_ptr(), v, n, t, c_in,
            c_out, gamma, stride, int(aff), int(relu2), int(vmajor), wn,
            smem, torch.cuda.current_stream(x.device).cuda_stream)
    _raise_on(lib, err, "temporal bf16 forward")
    return out


def launch_mma_backward(x, g, s2, t2, w, *, v, n, t, stride, relu2, aff,
                        vmajor):
    """Launch the bf16 backward kernels of either op: ``(dx, grads)``,
    grads the float32 ``[dWt | dbt (| ds2 | dt2)]``."""
    from stgcn_tpu_torch.kernels._build import load_library

    gamma, c_in, c_out = w.shape
    plan = plan_mma_backward(v * n, t, c_in, c_out, stride, gamma, aff,
                             partial_ctas(x.device))
    f32 = torch.float32
    args = [x.contiguous(), g.to(x.dtype).contiguous(), _f32(s2), _f32(t2),
            w.to(x.dtype).transpose(1, 2).contiguous()]  # (gamma, C_out, C_in)
    dx = torch.empty_like(args[0])
    e_dw = gamma * c_in * c_out + c_out
    partial_dw = torch.empty((plan["splits"], e_dw), dtype=f32,
                             device=x.device)
    partial_dx = (torch.empty((stride * plan["tiles_x"], 2 * c_in),
                              dtype=f32, device=x.device) if aff else None)
    grads = torch.empty(e_dw + (2 * c_in if aff else 0), dtype=f32,
                        device=x.device)
    lib = load_library()
    with torch.cuda.device(x.device):
        err = lib.temporal_mma_bwd_launch(
            *[_ptr(p) for p in args], dx.data_ptr(), partial_dw.data_ptr(),
            _ptr(partial_dx), grads.data_ptr(), v, n,
            t, c_in, c_out, gamma, stride, int(aff), int(relu2),
            int(vmajor), plan["wn_dx"], plan["tiles_x"], plan["dx_smem"],
            plan["nj_dw"], plan["splits"], plan["split_rows"],
            plan["dw_smem"], torch.cuda.current_stream(x.device).cuda_stream)
    _raise_on(lib, err, "temporal bf16 backward")
    return dx, grads


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
    if z.dtype == torch.bfloat16:
        out = launch_mma_forward(z, s2, t2, wt, bt, v=v, n=n, t=t,
                                 stride=stride, relu2=relu2, aff=True,
                                 vmajor=True, out_shape=(v, n, t_out, c))
        temporal_block_forward.launches += 1
        return out
    tt, vg, smem = plan_forward(v, c, stride, gamma)
    cd, f32 = z.dtype, torch.float32
    args = [z.contiguous(), s2.to(f32).contiguous(), t2.to(f32).contiguous(),
            wt.to(cd).contiguous(), bt.to(f32).contiguous()]
    out = torch.empty((v, n, t_out, c), dtype=cd, device=z.device)
    lib = load_library()
    with torch.cuda.device(z.device):
        err = lib.temporal_block_fwd_launch(
            *[p.data_ptr() for p in args], out.data_ptr(), v, n, t, c, gamma,
            stride, t_out, tt, vg, int(relu2), smem,
            torch.cuda.current_stream(z.device).cuda_stream)
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
    sizes = (gamma * c * c, c, c, c)
    if z.dtype == torch.bfloat16:
        dz, grads = launch_mma_backward(z, g, s2, t2, wt, v=v, n=n, t=t,
                                        stride=stride, relu2=relu2, aff=True,
                                        vmajor=True)
    else:
        ft, vg, smem = plan_backward(v, c, gamma)
        items = -(-t // ft) * n * -(-v // vg)
        ctas = min(partial_ctas(z.device), items)
        cd, f32 = z.dtype, torch.float32
        args = [z.contiguous(), g.to(cd).contiguous(),
                s2.to(f32).contiguous(), t2.to(f32).contiguous(),
                wt.to(cd).transpose(1, 2).contiguous()]  # (gamma, C_out, C_in)
        dz = torch.empty_like(args[0])
        partial = torch.empty((ctas, sum(sizes)), dtype=f32, device=z.device)
        grads = torch.empty(sum(sizes), dtype=f32, device=z.device)
        lib = load_library()
        with torch.cuda.device(z.device):
            err = lib.temporal_block_bwd_launch(
                *[p.data_ptr() for p in args], dz.data_ptr(),
                partial.data_ptr(), grads.data_ptr(), v, n, t, c, gamma,
                stride, t_out, ft, vg, ctas, int(relu2), smem,
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
