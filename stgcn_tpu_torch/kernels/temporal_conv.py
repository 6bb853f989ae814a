"""The standalone temporal convolution: kernels, plain versions, autograd.

:func:`temporal_conv_fused` on ``(N, T, V, C_in)`` and
:func:`temporal_conv_fused_vm` on V-major ``(R = V*N, T, C_in)``
activations compute the ``gamma x 1`` convolution with stride ``s`` and
``pad`` frames of zero padding on both ends, ``(gamma - 1) // 2`` unless
the caller gives ``padding`` (the time halo's valid conv of a shard's
frames and their neighbours' takes 0; ``T_out = (T + 2 pad - gamma) // s
+ 1``)::

    u[t] = round(sum_g x[t*s - pad + g] . W_g + b)

with ``W`` rounded to ``x``'s dtype, ``b`` added in float32 as it comes and
the sums in float32.  They are the ports of ``temporal_conv_fused``
(``stgcn_tpu/kernels/temporal_conv.py``) and ``temporal_conv_fused_vm``
(``stgcn_tpu/kernels/temporal_conv_vm.py``), the ``temporal_impl="pallas"``
and ``layout="vntc"`` routes' temporal convs.  The function is
:mod:`~stgcn_tpu_torch.kernels.temporal_block`'s with an identity affine
and no ReLU, and so are its kernels: the same CUDA source
(``csrc/temporal_block.cu``) built without the affine, reading and writing
either layout in place: bfloat16 on the tensor cores, float32 on the
scalar kernels.  The backward gives ``dx`` (rounded once, at the end, as
``_make_dx_kernel`` and ``_shiftsum_kernel`` round it), ``dw`` and
``db = sum g`` in float32.  For a CPU tensor the ops run the plain versions
:func:`temporal_conv_forward_reference` and
:func:`temporal_conv_backward_reference`, ``temporal_block``'s plain
versions with that identity affine.

``temporal_conv_forward.launches`` and ``temporal_conv_backward.launches``
count the op calls of both layouts that launched kernels, one per call, and
nothing else.
"""

from __future__ import annotations

import torch

from stgcn_tpu_torch.kernels.block_eval import SMEM_LIMIT, t_out_of
from stgcn_tpu_torch.kernels.spatial_block import (
    _check_cuda,
    _raise_on,
    partial_ctas,
)
from stgcn_tpu_torch.kernels.spatial_conv import (
    _as_vntc,
    _from_vntc,
    _identity_affine,
    _rounded,
)
from stgcn_tpu_torch.kernels.temporal_block import (
    FRAME_TILES,
    _padding,
    launch_mma_backward,
    launch_mma_forward,
    temporal_block_backward_reference,
    temporal_block_forward_reference,
)

# most rows (joints, or sequences of one joint) a CTA takes
MAX_ROW_GROUP = 32


def check_args(x, w, b, vmajor: bool) -> None:
    want = 3 if vmajor else 4
    if x.dim() != want:
        name = "(R, T, C_in)" if vmajor else "(N, T, V, C_in)"
        raise ValueError(f"x must be {name}, got {tuple(x.shape)}")
    c_in = x.shape[-1]
    if w.dim() != 3 or w.shape[1] != c_in or w.shape[0] % 2 != 1:
        raise ValueError(f"w must be (odd gamma, {c_in}, C_out), got "
                         f"{tuple(w.shape)}")
    if tuple(b.shape) != (w.shape[2],):
        raise ValueError(f"b must be ({w.shape[2]},), got {tuple(b.shape)}")


def temporal_conv_forward_reference(x, w, b, *, stride: int, vmajor: bool,
                                    padding: int | None = None):
    """Plain PyTorch version of the forward kernel.

    ``x``: ``(R, T, C_in)`` if ``vmajor`` else ``(N, T, V, C_in)``; ``w``:
    ``(gamma, C_in, C_out)``, rounded to ``x``'s dtype; ``b``: ``(C_out,)``;
    ``padding`` frames of zeros on both ends (``None``: same padding).
    Returns ``u`` in ``x``'s layout and dtype.
    """
    check_args(x, w, b, vmajor)
    u = temporal_block_forward_reference(
        _as_vntc(x, vmajor), *_identity_affine(x), w.to(x.dtype), b,
        stride=stride, relu2=False, pad=padding)
    return _from_vntc(u, vmajor)


def temporal_conv_backward_reference(x, g, w, b, *, stride: int,
                                     vmajor: bool,
                                     padding: int | None = None):
    """Plain PyTorch version of the backward kernel: ``(dx, dw, db)``, each
    in its input's dtype; ``w`` is rounded to ``x``'s dtype."""
    check_args(x, w, b, vmajor)
    dx, _, _, dw, db = temporal_block_backward_reference(
        _as_vntc(x, vmajor), _as_vntc(g, vmajor), *_identity_affine(x),
        _rounded(w, x.dtype), b, stride=stride, relu2=False, pad=padding)
    return _from_vntc(dx, vmajor), dw, db


def plan_conv(rows: int, bytes_of) -> tuple[int, int, int]:
    """``(frame tile, row group, shared bytes)``: the frame tile of
    ``FRAME_TILES`` and the group of at most ``MAX_ROW_GROUP`` rows that give
    a CTA the most (frame, row) pairs in shared memory, the larger tile on
    a tie; ``bytes_of(tile)`` is the shared memory one row needs."""
    best = None
    for tile in FRAME_TILES:
        per_row = bytes_of(tile)
        group = min(rows, MAX_ROW_GROUP, SMEM_LIMIT // per_row)
        if group >= 1 and (best is None or tile * group > best[0] * best[1]):
            best = (tile, group, group * per_row)
    if best is None:
        raise ValueError(f"no temporal tile fits in {SMEM_LIMIT} bytes of "
                         f"shared memory")
    return best


def plan_forward(rows, c_in, stride, gamma):
    """float32: ``(TT, VG, shared bytes)`` of the forward: a CTA holds the
    ``(TT-1)*s + gamma`` input frames of ``VG`` rows in float32."""
    return plan_conv(rows, lambda tt: 4 * ((tt - 1) * stride + gamma) * c_in)


def plan_backward(rows, c_in, c_out, gamma):
    """float32: ``(FT, VG, shared bytes)`` of the backward: a CTA holds ``FT`` input
    frames and the ``FT + gamma - 1`` frame positions of g of ``VG`` rows."""
    return plan_conv(rows,
                     lambda ft: 4 * (ft * c_in + (ft + gamma - 1) * c_out))


def _dims(x, vmajor) -> tuple[int, int, int]:
    """``(V, N, T)`` the kernel sees: ``(R, 1, T)`` for ``(R, T, C)``."""
    if vmajor:
        return x.shape[0], 1, x.shape[1]
    n, t, v, _ = x.shape
    return v, n, t


def temporal_conv_forward(x, w, b, *, stride: int, vmajor: bool,
                          padding: int | None = None):
    """Forward kernel wrapper: plain version on the CPU, kernel on CUDA."""
    if x.device.type == "cpu":
        return temporal_conv_forward_reference(x, w, b, stride=stride,
                                               vmajor=vmajor, padding=padding)
    if x.device.type != "cuda":
        raise ValueError(f"temporal_conv runs on cuda or cpu, not {x.device}")
    return _launch_forward(x, w, b, stride=stride, vmajor=vmajor,
                           padding=padding)


def _launch_forward(x, w, b, *, stride, vmajor, padding=None):
    from stgcn_tpu_torch.kernels._build import load_library

    check_args(x, w, b, vmajor)
    _check_cuda("temporal_conv", x, (w, b))
    v, n, t = _dims(x, vmajor)
    gamma, c_in, c_out = w.shape
    pad = _padding(gamma, padding)
    t_out = t_out_of(t, stride, gamma, pad)
    if t_out < 1:
        raise ValueError(f"T={t} frames give no output of a {gamma}-tap "
                         f"conv with padding {pad}")
    shape = (v, t_out, c_out) if vmajor else (n, t_out, v, c_out)
    if x.dtype == torch.bfloat16:
        out = launch_mma_forward(x, None, None, w, b, v=v, n=n, t=t,
                                 stride=stride, relu2=False, aff=False,
                                 vmajor=vmajor, out_shape=shape, pad=pad)
        temporal_conv_forward.launches += 1
        return out
    tt, vg, smem = plan_forward(v, c_in, stride, gamma)
    cd = x.dtype
    args = [x.contiguous(), w.to(cd).contiguous(),
            b.to(torch.float32).contiguous()]
    out = torch.empty(shape, dtype=cd, device=x.device)
    lib = load_library()
    with torch.cuda.device(x.device):
        err = lib.temporal_conv_fwd_launch(
            *[p.data_ptr() for p in args], out.data_ptr(), v, n, t, c_in,
            c_out, gamma, stride, pad, t_out, tt, vg, int(vmajor), smem,
            torch.cuda.current_stream(x.device).cuda_stream)
    _raise_on(lib, err, "temporal_conv forward")
    temporal_conv_forward.launches += 1
    return out


temporal_conv_forward.launches = 0


def temporal_conv_backward(x, g, w, b, *, stride: int, vmajor: bool,
                           padding: int | None = None):
    """Backward kernel wrapper: ``(dx, dw, db)``, each in its input's
    dtype.  Plain version on the CPU, kernel on CUDA."""
    if x.device.type == "cpu":
        return temporal_conv_backward_reference(x, g, w, b, stride=stride,
                                                vmajor=vmajor,
                                                padding=padding)
    if x.device.type != "cuda":
        raise ValueError(f"temporal_conv runs on cuda or cpu, not {x.device}")
    return _launch_backward(x, g, w, b, stride=stride, vmajor=vmajor,
                            padding=padding)


def _launch_backward(x, g, w, b, *, stride, vmajor, padding=None):
    from stgcn_tpu_torch.kernels._build import load_library

    check_args(x, w, b, vmajor)
    _check_cuda("temporal_conv", x, (g, w, b))
    v, n, t = _dims(x, vmajor)
    gamma, c_in, c_out = w.shape
    pad = _padding(gamma, padding)
    t_out = t_out_of(t, stride, gamma, pad)
    want = (v, t_out, c_out) if vmajor else (n, t_out, v, c_out)
    if tuple(g.shape) != want:
        raise ValueError(f"g must be {want}, got {tuple(g.shape)}")
    sizes = (gamma * c_in * c_out, c_out)
    if x.dtype == torch.bfloat16:
        dx, grads = launch_mma_backward(x, g, None, None, w, v=v, n=n, t=t,
                                        stride=stride, relu2=False,
                                        aff=False, vmajor=vmajor, pad=pad)
    else:
        ft, vg, smem = plan_backward(v, c_in, c_out, gamma)
        items = -(-t // ft) * n * -(-v // vg)
        ctas = min(partial_ctas(x.device), items)
        cd, f32 = x.dtype, torch.float32
        args = [x.contiguous(), g.to(cd).contiguous(),
                w.to(cd).transpose(1, 2).contiguous()]  # (gamma, C_out, C_in)
        dx = torch.empty_like(args[0])
        partial = torch.empty((ctas, sum(sizes)), dtype=f32, device=x.device)
        grads = torch.empty(sum(sizes), dtype=f32, device=x.device)
        lib = load_library()
        with torch.cuda.device(x.device):
            err = lib.temporal_conv_bwd_launch(
                *[p.data_ptr() for p in args], dx.data_ptr(),
                partial.data_ptr(), grads.data_ptr(), v, n, t, c_in, c_out,
                gamma, stride, pad, t_out, ft, vg, ctas, int(vmajor), smem,
                torch.cuda.current_stream(x.device).cuda_stream)
        _raise_on(lib, err, "temporal_conv backward")
    temporal_conv_backward.launches += 1
    dw, db = torch.split(grads, sizes)
    return (dx, dw.view(gamma, c_in, c_out).to(w.dtype), db.to(b.dtype))


temporal_conv_backward.launches = 0


class _TemporalConv(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, b, stride, vmajor, padding):
        ctx.save_for_backward(x, w, b)
        ctx.flags = dict(stride=stride, vmajor=vmajor, padding=padding)
        return temporal_conv_forward(x, w, b, **ctx.flags)

    @staticmethod
    def backward(ctx, g):
        x, w, b = ctx.saved_tensors
        return (*temporal_conv_backward(x, g.contiguous(), w, b,
                                        **ctx.flags), None, None, None)


def temporal_conv_fused(x, w, b, stride: int = 1,
                        padding: int | None = None):
    """The differentiable temporal conv on ``(N, T, V, C_in)``:
    ``-> (N, T_out, V, C_out)``, with ``padding`` frames of zeros on both
    ends (``None``: ``(gamma - 1) // 2``)."""
    return _TemporalConv.apply(x, w, b, stride, False, padding)


def temporal_conv_fused_vm(x, w, b, stride: int = 1):
    """The differentiable temporal conv on V-major ``(R, T, C_in)``:
    ``-> (R, T_out, C_out)``."""
    return _TemporalConv.apply(x, w, b, stride, True, None)
