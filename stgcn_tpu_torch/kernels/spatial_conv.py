"""The standalone graph convolution: kernels, plain versions, autograd.

:func:`spatial_conv_fused` on ``(N, T, V, C_in)`` and
:func:`spatial_conv_fused_vm` on V-major ``(V, M, C_in)`` activations
compute, for each frame::

    z = sum_k A_k . round(x . W_k + b_k)

with ``W``, ``b`` and ``A`` rounded to ``x``'s dtype and the sums in
float32.  They are the ports of ``spatial_conv_fused`` and
``spatial_conv_fused_vm`` (``stgcn_tpu/kernels/spatial_conv.py``), the
``spatial_impl="pallas"`` and ``layout="vntc"`` routes' spatial convs.  The
function is :mod:`~stgcn_tpu_torch.kernels.spatial_block`'s with an
identity affine and no ReLU, and so are its kernels: the same CUDA source
(``csrc/spatial_block.cu``) built without the affine, reading and writing
either layout in place, bfloat16 on the tensor cores and float32 on the
scalar kernels.  For a CPU tensor the ops run the plain versions
:func:`spatial_conv_forward_reference` and
:func:`spatial_conv_backward_reference`, which are ``spatial_block``'s plain
versions with that identity affine and so round where the Pallas kernels
do (the forward at ``_fwd_kernel``, the backward's t_k and recomputed y_k
at ``_bwd_kernel``).

``spatial_conv_forward.launches`` and ``spatial_conv_backward.launches``
count the op calls that launched kernels, one per call, in both layouts,
and nothing else.
"""

from __future__ import annotations

import torch

from stgcn_tpu_torch.kernels.spatial_block import (
    _check_cuda,
    _raise_on,
    check_args,
    launch_mma_backward,
    launch_mma_forward,
    partial_ctas,
    plan_frames,
    spatial_block_backward_reference,
    spatial_block_forward_reference,
)


def _as_vntc(x: torch.Tensor, vmajor: bool) -> torch.Tensor:
    """A ``(V, N, T, C)`` view of either layout: a V-major ``(V, M, C)``
    or ``(R, T, C)`` tensor gains a unit second axis, an ``(N, T, V, C)``
    one is permuted."""
    return x.unsqueeze(1) if vmajor else x.permute(2, 0, 1, 3)


def _from_vntc(y: torch.Tensor, vmajor: bool) -> torch.Tensor:
    return y.squeeze(1) if vmajor else y.permute(1, 2, 0, 3)


def _check_layout(x: torch.Tensor, vmajor: bool) -> None:
    want = 3 if vmajor else 4
    if x.dim() != want:
        name = "(V, M, C_in)" if vmajor else "(N, T, V, C_in)"
        raise ValueError(f"x must be {name}, got {tuple(x.shape)}")


def _identity_affine(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    one = torch.ones(x.shape[-1], dtype=torch.float32, device=x.device)
    return one, torch.zeros_like(one)


def _rounded(t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``t``'s values rounded to ``dtype``, kept in ``t``'s dtype (so its
    gradient comes back in that dtype unrounded, as from the kernel)."""
    return t.to(dtype).to(t.dtype)


def spatial_conv_forward_reference(x, w, b, a, *, vmajor: bool):
    """Plain PyTorch version of the forward kernel.

    ``x``: ``(V, M, C_in)`` if ``vmajor`` else ``(N, T, V, C_in)``; ``w``:
    ``(C_in, K, C_out)``, ``b``: ``(K, C_out)``, ``a``: ``(K, V, V)``, each
    rounded to ``x``'s dtype first.  Returns ``z`` in ``x``'s layout and
    dtype with ``C_out`` channels.
    """
    _check_layout(x, vmajor)
    cd = x.dtype
    z = spatial_block_forward_reference(
        _as_vntc(x, vmajor), *_identity_affine(x), _rounded(w, cd),
        _rounded(b, cd), _rounded(a, cd), relu1=False)
    return _from_vntc(z, vmajor)


def spatial_conv_backward_reference(x, g, w, b, a, *, vmajor: bool,
                                    need_da: bool = True):
    """Plain PyTorch version of the backward kernel: ``(dx, dw, db, da)``,
    each in its input's dtype; ``da`` is zero when ``need_da`` is False."""
    _check_layout(x, vmajor)
    cd = x.dtype
    dx, _, _, dw, db, da = spatial_block_backward_reference(
        _as_vntc(x, vmajor), _as_vntc(g, vmajor), *_identity_affine(x),
        _rounded(w, cd), _rounded(b, cd), _rounded(a, cd), relu1=False,
        need_da=need_da)
    return _from_vntc(dx, vmajor), dw, db, da


def _dims(x: torch.Tensor, vmajor: bool) -> tuple[int, int, int]:
    """``(V, M, C_in)`` of either layout."""
    if vmajor:
        return tuple(x.shape)
    n, t, v, c_in = x.shape
    return v, n * t, c_in


def spatial_conv_forward(x, w, b, a, *, vmajor: bool):
    """Forward kernel wrapper: plain version on the CPU, kernel on CUDA."""
    if x.device.type == "cpu":
        return spatial_conv_forward_reference(x, w, b, a, vmajor=vmajor)
    if x.device.type != "cuda":
        raise ValueError(f"spatial_conv runs on cuda or cpu, not {x.device}")
    return _launch_forward(x, w, b, a, vmajor=vmajor)


def _launch_forward(x, w, b, a, *, vmajor):
    from stgcn_tpu_torch.kernels._build import load_library

    _check_layout(x, vmajor)
    check_args(_as_vntc(x, vmajor), w, b, a)
    _check_cuda("spatial_conv", x, (w, b, a))
    v, m, c_in = _dims(x, vmajor)
    _, k, c_out = w.shape
    out_shape = (*x.shape[:-1], c_out)
    if x.dtype == torch.bfloat16:
        out, _ = launch_mma_forward(x, None, None, w, b, a, v=v, m=m,
                                    relu1=False, aff=False, save=False,
                                    vmajor=vmajor, out_shape=out_shape)
        spatial_conv_forward.launches += 1
        return out
    frames, smem, _ = plan_frames(v, c_in, c_out)
    cd = x.dtype
    x = x.contiguous()
    args = [x, w.to(cd).permute(1, 0, 2).contiguous(), b.to(cd).contiguous(),
            a.to(cd).contiguous()]
    out = torch.empty(out_shape, dtype=cd, device=x.device)
    lib = load_library()
    with torch.cuda.device(x.device):
        err = lib.spatial_conv_fwd_launch(
            *[p.data_ptr() for p in args], out.data_ptr(), v, m, c_in, c_out,
            k, frames, int(vmajor), smem,
            torch.cuda.current_stream(x.device).cuda_stream)
    _raise_on(lib, err, "spatial_conv forward")
    spatial_conv_forward.launches += 1
    return out


spatial_conv_forward.launches = 0


def spatial_conv_backward(x, g, w, b, a, *, vmajor: bool,
                          need_da: bool = True):
    """Backward kernel wrapper: ``(dx, dw, db, da)``, each in its input's
    dtype.  Plain version on the CPU, kernel on CUDA."""
    if x.device.type == "cpu":
        return spatial_conv_backward_reference(x, g, w, b, a, vmajor=vmajor,
                                               need_da=need_da)
    if x.device.type != "cuda":
        raise ValueError(f"spatial_conv runs on cuda or cpu, not {x.device}")
    return _launch_backward(x, g, w, b, a, vmajor=vmajor, need_da=need_da)


def _launch_backward(x, g, w, b, a, *, vmajor, need_da):
    from stgcn_tpu_torch.kernels._build import load_library

    _check_layout(x, vmajor)
    check_args(_as_vntc(x, vmajor), w, b, a)
    _check_cuda("spatial_conv", x, (g, w, b, a))
    v, m, c_in = _dims(x, vmajor)
    _, k, c_out = w.shape
    if tuple(g.shape) != (*x.shape[:-1], c_out):
        raise ValueError(f"g must be {(*x.shape[:-1], c_out)}, got "
                         f"{tuple(g.shape)}")
    sizes = (k * c_in * c_out, k * c_out, k * v * v)
    if x.dtype == torch.bfloat16:
        dx, grads = launch_mma_backward(x, g, None, None, w, b, a, None, v=v,
                                        m=m, relu1=False, aff=False,
                                        vmajor=vmajor, need_da=need_da)
    else:
        frames, _, smem = plan_frames(v, c_in, c_out)
        ctas = min(partial_ctas(x.device), -(-m // frames))
        cd, f32 = x.dtype, torch.float32
        wk = w.to(cd).permute(1, 0, 2)                    # (K, C_in, C_out)
        args = [x.contiguous(), g.to(cd).contiguous(), wk.contiguous(),
                wk.transpose(1, 2).contiguous(), b.to(cd).contiguous(),
                a.to(cd).contiguous()]
        dx = torch.empty_like(args[0])
        partial = torch.empty((ctas, sum(sizes)), dtype=f32, device=x.device)
        grads = torch.empty(sum(sizes), dtype=f32, device=x.device)
        lib = load_library()
        with torch.cuda.device(x.device):
            err = lib.spatial_conv_bwd_launch(
                *[p.data_ptr() for p in args], dx.data_ptr(),
                partial.data_ptr(), grads.data_ptr(), v, m, c_in, c_out, k,
                frames, ctas, int(vmajor), int(need_da), smem,
                torch.cuda.current_stream(x.device).cuda_stream)
        _raise_on(lib, err, "spatial_conv backward")
    spatial_conv_backward.launches += 1
    dw, db, da = torch.split(grads, sizes)
    dw = dw.view(k, c_in, c_out).permute(1, 0, 2)
    return (dx, dw.to(w.dtype), db.view(k, c_out).to(b.dtype),
            da.view(k, v, v).to(a.dtype))


spatial_conv_backward.launches = 0


class _SpatialConv(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, b, a, vmajor):
        ctx.save_for_backward(x, w, b, a)
        ctx.vmajor = vmajor
        return spatial_conv_forward(x, w, b, a, vmajor=vmajor)

    @staticmethod
    def backward(ctx, g):
        x, w, b, a = ctx.saved_tensors
        # a graph that is not trained needs no dA: skip the y_k recompute
        return (*spatial_conv_backward(x, g.contiguous(), w, b, a,
                                       vmajor=ctx.vmajor,
                                       need_da=ctx.needs_input_grad[3]),
                None)


def spatial_conv_fused(x, w, b, a):
    """The differentiable graph conv on ``(N, T, V, C_in)``:
    ``-> (N, T, V, C_out)``."""
    return _SpatialConv.apply(x, w, b, a, False)


def spatial_conv_fused_vm(x, w, b, a):
    """The differentiable graph conv on V-major ``(V, M, C_in)``:
    ``-> (V, M, C_out)``."""
    return _SpatialConv.apply(x, w, b, a, True)
