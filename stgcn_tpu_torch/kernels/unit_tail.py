"""The ST-GCN unit's tail as one op: kernels, plain version, autograd.

:func:`unit_tail` takes a fused train unit's temporal output ``u``, its
shortcut ``short`` (None for the non-residual order) and dropout's draw
(:func:`~stgcn_tpu_torch.ops.common.dropout_draw`; None at rate 0) and
returns the unit's output::

    out = where(draw < keep_below, relu(u + short) / scale, 0)

the sum and the ReLU in at least float32, rounded to ``u``'s dtype before
the division as the PyTorch chain it replaces rounds.  It replaces no Pallas
kernel: it stands for XLA's fusion of the shortcut add, ReLU and dropout in
``stgcn_tpu/models/fused.py`` ``block_forward_fused_train``.

The op is a ``torch.autograd.Function``.  For a CUDA tensor its forward and
backward run hand-written kernels (``csrc/unit_tail.cu``), bf16 or float32:
the forward reads ``u``, ``short`` and the draw once and writes ``out`` and
one bit an element, kept and ``relu(u + short) > 0``; the backward reads
the bits and ``dout`` and writes ``du``, the gradient of ``u`` and of
``short``.  Only the bits, packed 8 to a byte along the flat index, live
from the forward to the backward.  Both are bitwise the chain on CUDA
(:func:`unit_tail_forward_reference` and its autograd), which ATen rounds
at the same points.  For a CPU tensor the op runs the plain versions.

``unit_tail_forward.launches`` and ``unit_tail_backward.launches`` count
the op calls that launched kernels, one per call.
"""

from __future__ import annotations

import torch

from stgcn_tpu_torch.kernels.spatial_block import _acc, _raise_on
from stgcn_tpu_torch.ops.common import apply_dropout

# dtype codes of unit_tail_fwd_launch / unit_tail_bwd_launch
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# draw codes: 0 none, 1 float32 uniforms ("exact"), 2 bytes ("bits8")
DRAWS = {torch.float32: 1, torch.uint8: 2}
THREADS = 256
UNIT = 8            # elements a thread takes a step: the bits of one byte
CTAS_PER_SM = 8


def unit_tail_forward_reference(u, short, draw, keep_below, scale):
    """Plain version of the forward, the PyTorch chain the op replaces:
    ``(out, bit)``, ``bit`` the bool mask of the elements whose gradient
    passes (kept, and the ReLU's result not <= 0)."""
    acc = _acc(u.dtype)
    v = torch.relu(u.to(acc) + short.to(acc) if short is not None
                   else u.to(acc))
    out, bit = v.to(u.dtype), ~(v <= 0)
    if draw is not None:
        out = apply_dropout(out, draw, keep_below, scale)
        bit &= draw < keep_below
    return out, bit


def unit_tail_backward_reference(bit, dout, scale):
    """Plain version of the backward: ``dout / scale`` (``dout`` where the
    forward had no draw) where ``bit``, else 0, in ``dout``'s dtype."""
    zero = torch.zeros((), dtype=dout.dtype, device=dout.device)
    return torch.where(bit, dout / scale if scale is not None else dout,
                       zero)


def plan_ctas(n: int, sms: int) -> int:
    """CTAs over the ``ceil(n / UNIT)`` units: ``CTAS_PER_SM`` a
    streaming multiprocessor, or fewer where the units do not fill them."""
    units = -(-n // UNIT)
    return max(1, min(-(-units // THREADS), CTAS_PER_SM * sms))


def _ctas(device, n: int) -> int:
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return plan_ctas(n, sms)


def _check_device(t: torch.Tensor) -> None:
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unit_tail runs on cuda or cpu, not {t.device}")


def unit_tail_forward(u, short, draw, keep_below, scale):
    """Forward wrapper: ``(out, bits)``; plain version on the CPU (a bool
    mask), kernel on CUDA (the mask packed, ``ceil(n / 8)`` bytes)."""
    _check_device(u)
    if u.device.type == "cpu":
        return unit_tail_forward_reference(u, short, draw, keep_below, scale)
    return _launch_forward(u, short, draw, keep_below, scale)


def _check(u, short, draw) -> None:
    if u.dtype not in DTYPES:
        raise TypeError(f"unit_tail takes float32 or bfloat16, got "
                        f"{u.dtype}")
    if u.numel() == 0:
        raise ValueError("unit_tail needs a non-empty tensor")
    for name, t in (("short", short), ("draw", draw)):
        if t is None:
            continue
        if tuple(t.shape) != tuple(u.shape):
            raise ValueError(f"{name} must be {tuple(u.shape)}, got "
                             f"{tuple(t.shape)}")
        if t.device != u.device:
            raise ValueError(f"every unit_tail argument must be on "
                             f"{u.device}")
    if short is not None and short.dtype != u.dtype:
        raise TypeError(f"short must be {u.dtype}, got {short.dtype}")
    if draw is not None and draw.dtype not in DRAWS:
        raise TypeError(f"the draw must be float32 or uint8, got "
                        f"{draw.dtype}")


def _launch_forward(u, short, draw, keep_below, scale):
    from stgcn_tpu_torch.kernels._build import load_library

    _check(u, short, draw)
    u = u.contiguous()
    short = None if short is None else short.contiguous()
    draw = None if draw is None else draw.contiguous()
    n = u.numel()
    out = torch.empty_like(u)
    bits = torch.empty(-(-n // UNIT), dtype=torch.uint8, device=u.device)
    lib = load_library()
    with torch.cuda.device(u.device):
        err = lib.unit_tail_fwd_launch(
            u.data_ptr(), None if short is None else short.data_ptr(),
            None if draw is None else draw.data_ptr(), out.data_ptr(),
            bits.data_ptr(), n, DTYPES[u.dtype],
            0 if draw is None else DRAWS[draw.dtype],
            0.0 if draw is None else float(keep_below),
            1.0 if draw is None else float(scale), _ctas(u.device, n),
            torch.cuda.current_stream(u.device).cuda_stream)
    _raise_on(lib, err, "unit_tail forward")
    unit_tail_forward.launches += 1
    return out, bits


unit_tail_forward.launches = 0


def unit_tail_backward(bits, dout, scale):
    """Backward wrapper: ``du`` in ``dout``'s dtype, ``scale`` None where
    the forward had no draw.  Plain version on the CPU, kernel on CUDA."""
    _check_device(dout)
    if dout.device.type == "cpu":
        return unit_tail_backward_reference(bits, dout, scale)
    return _launch_backward(bits, dout, scale)


def _launch_backward(bits, dout, scale):
    from stgcn_tpu_torch.kernels._build import load_library

    if dout.dtype not in DTYPES:
        raise TypeError(f"unit_tail takes float32 or bfloat16, got "
                        f"{dout.dtype}")
    n = dout.numel()
    if bits.dtype != torch.uint8 or tuple(bits.shape) != (-(-n // UNIT),):
        raise ValueError(f"the mask must be ({-(-n // UNIT)},) uint8, got "
                         f"{tuple(bits.shape)} {bits.dtype}")
    if bits.device != dout.device:
        raise ValueError(f"every unit_tail argument must be on {dout.device}")
    dout = dout.contiguous()
    du = torch.empty_like(dout)
    lib = load_library()
    with torch.cuda.device(dout.device):
        err = lib.unit_tail_bwd_launch(
            bits.data_ptr(), dout.data_ptr(), du.data_ptr(), n,
            DTYPES[dout.dtype], int(scale is not None),
            1.0 if scale is None else float(scale), _ctas(dout.device, n),
            torch.cuda.current_stream(dout.device).cuda_stream)
    _raise_on(lib, err, "unit_tail backward")
    unit_tail_backward.launches += 1
    return du


unit_tail_backward.launches = 0


class _UnitTail(torch.autograd.Function):
    @staticmethod
    def forward(ctx, u, short, draw, keep_below, scale):
        out, bits = unit_tail_forward(u, short, draw, keep_below, scale)
        ctx.save_for_backward(bits)
        ctx.scale = None if draw is None else scale
        return out

    @staticmethod
    def backward(ctx, dout):
        (bits,) = ctx.saved_tensors
        du = unit_tail_backward(bits, dout, ctx.scale)
        return du, du if ctx.needs_input_grad[1] else None, None, None, None


def unit_tail(u: torch.Tensor, short: torch.Tensor | None,
              draw: torch.Tensor | None = None, keep_below=None,
              scale: float | None = None) -> torch.Tensor:
    """The differentiable unit output ``where(draw < keep_below, relu(u +
    short) / scale, 0)`` in ``u``'s dtype; ``short`` None: no shortcut,
    ``draw`` None: no dropout (``keep_below`` and ``scale`` unused)."""
    return _UnitTail.apply(u, short, draw, keep_below, scale)
