"""A post-activation unit's tail as one op: kernels, plain versions,
autograd.

:func:`affine_add_relu` takes channels-last ``(..., C)`` activations and
returns::

    out = round(relu(a sa + b sb + t))

``sa``, ``sb`` and ``t`` ``(C,)`` in at least float32 (the folded
BatchNorms of 2s-AGCN's units: ``BN_g(g) + down(x)`` before the GCN's
ReLU, ``BN_t(u) + res(x)`` before the unit's), ``b`` absent where there is
no shortcut and ``sb`` absent for an identity shortcut.  The temporal op's
prologue (an affine and a ReLU, ``temporal_block``) has no place for the
addend, so this one pass forms the sum; the backward is one pass that
writes ``da`` and ``db`` and sums the three channel gradients.  It
replaces no Pallas kernel: the JAX package has no post-activation unit.

For a CUDA tensor the forward and backward run the hand-written kernels of
``csrc/affine_relu.cu`` (bf16, float32 and float64; the channel sums in
per-CTA partial slices added in a fixed order); for a CPU tensor the plain
versions :func:`affine_relu_forward_reference` and
:func:`affine_relu_backward_reference`, which round at the same points.

``affine_relu_forward.launches`` and ``affine_relu_backward.launches``
count the op calls that launched kernels, one per call.
"""

from __future__ import annotations

import torch

from stgcn_tpu_torch.kernels.bn_moments import DTYPES
from stgcn_tpu_torch.kernels.spatial_block import _acc, _raise_on

THREADS = 256
CTAS_PER_SM = 2


def affine_relu_forward_reference(a, sa, t, b=None, sb=None):
    """Plain version of the forward: ``out`` in ``a``'s dtype."""
    acc = _acc(a.dtype)
    v = a.to(acc) * sa + t
    if b is not None:
        v = v + (b.to(acc) * sb if sb is not None else b.to(acc))
    return torch.relu(v).to(a.dtype)


def affine_relu_backward_reference(a, sa, out, dout, b=None, sb=None):
    """Plain version of the backward: ``(da, dsa, dt, db, dsb)``; ``db`` and
    ``dsb`` None where ``b`` (or ``sb``) is."""
    acc = _acc(a.dtype)
    m = torch.where(out.to(acc) <= 0, 0.0, dout.to(acc))
    axes = tuple(range(a.dim() - 1))
    da = (m * sa).to(a.dtype)
    dsa = (m * a.to(acc)).sum(dim=axes)
    dt = m.sum(dim=axes)
    db = dsb = None
    if b is not None:
        db = (m * sb if sb is not None else m).to(b.dtype)
        if sb is not None:
            dsb = (m * b.to(acc)).sum(dim=axes)
    return da, dsa, dt, db, dsb


def _ctas(device, n: int) -> int:
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return max(1, min(CTAS_PER_SM * sms, -(-n // THREADS)))


def _vec(p, acc):
    return None if p is None else p.to(acc).contiguous()


def affine_relu_forward(a, sa, t, b=None, sb=None):
    """Forward wrapper: plain version on the CPU, kernel on CUDA."""
    if a.device.type != "cuda":
        return affine_relu_forward_reference(a, sa, t, b, sb)
    from stgcn_tpu_torch.kernels._build import load_library

    acc = _acc(a.dtype)
    a = a.contiguous()
    b = None if b is None else b.to(a.dtype).contiguous()
    sa, sb, t = _vec(sa, acc), _vec(sb, acc), _vec(t, acc)
    out = torch.empty_like(a)
    n, c = a.numel(), a.shape[-1]
    lib = load_library()
    with torch.cuda.device(a.device):
        err = lib.affine_relu_fwd_launch(
            a.data_ptr(), sa.data_ptr(), None if b is None else b.data_ptr(),
            None if sb is None else sb.data_ptr(), t.data_ptr(),
            out.data_ptr(), n, c, DTYPES[a.dtype], _ctas(a.device, n),
            torch.cuda.current_stream(a.device).cuda_stream)
    _raise_on(lib, err, "affine_relu forward")
    affine_relu_forward.launches += 1
    return out


affine_relu_forward.launches = 0


def affine_relu_backward(a, sa, out, dout, b=None, sb=None):
    """Backward wrapper: ``(da, dsa, dt, db, dsb)``; plain version on the
    CPU, kernels on CUDA."""
    if a.device.type != "cuda":
        return affine_relu_backward_reference(a, sa, out, dout, b, sb)
    from stgcn_tpu_torch.kernels._build import load_library

    acc = _acc(a.dtype)
    a = a.contiguous()
    dout = dout.to(a.dtype).contiguous()
    sa, sb = _vec(sa, acc), _vec(sb, acc)
    c = a.shape[-1]
    rows = a.numel() // c
    ctas = _ctas(a.device, rows)
    da = torch.empty_like(a)
    db = None if b is None else torch.empty_like(a)
    partial = torch.empty((ctas, 3, c), dtype=acc, device=a.device)
    sums = torch.empty((3, c), dtype=acc, device=a.device)
    lib = load_library()
    with torch.cuda.device(a.device):
        err = lib.affine_relu_bwd_launch(
            a.data_ptr(), sa.data_ptr(), None if b is None else b.data_ptr(),
            None if sb is None else sb.data_ptr(), out.data_ptr(),
            dout.data_ptr(), da.data_ptr(),
            None if db is None else db.data_ptr(), partial.data_ptr(),
            sums.data_ptr(), rows, c, DTYPES[a.dtype], ctas,
            torch.cuda.current_stream(a.device).cuda_stream)
    _raise_on(lib, err, "affine_relu backward")
    affine_relu_backward.launches += 1
    dsb = sums[1] if sb is not None else None
    return da, sums[0], sums[2], db, dsb


affine_relu_backward.launches = 0


class _AffineRelu(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, sa, t, b, sb):
        out = affine_relu_forward(a, sa, t, b, sb)
        ctx.save_for_backward(a, sa, b, sb, out)
        return out

    @staticmethod
    def backward(ctx, dout):
        a, sa, b, sb, out = ctx.saved_tensors
        da, dsa, dt, db, dsb = affine_relu_backward(a, sa, out, dout, b, sb)
        return da, dsa, dt, db, dsb


def affine_add_relu(a: torch.Tensor, sa: torch.Tensor, t: torch.Tensor,
                    b: torch.Tensor | None = None,
                    sb: torch.Tensor | None = None) -> torch.Tensor:
    """The differentiable ``relu(a sa + b sb + t)`` over the last axis's
    channels, in ``a``'s dtype (``b`` None: no shortcut; ``sb`` None: an
    identity one)."""
    return _AffineRelu.apply(a, sa, t, b, sb)
