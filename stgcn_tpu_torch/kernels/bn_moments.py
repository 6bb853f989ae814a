"""Per-channel batch moments as one op: kernels, plain versions, autograd.

:func:`bn_moments` takes a channels-last ``(..., C)`` activation and
returns its per-channel ``(mean, mean_sq)``, the mean of ``x`` and of
``x**2`` over every axis but the last, in at least float32: the batch
statistics of a train-mode BatchNorm (``ops/batchnorm.batch_moments``).
It replaces no Pallas kernel.  It stands for the reduction that XLA fuses
out of the plain ``jnp.mean`` calls of ``_bn_affine_train``
(``stgcn_tpu/models/fused.py``).

The op is a ``torch.autograd.Function``.  For a CUDA tensor its forward
and backward run hand-written kernels (``csrc/bn_moments.cu``).  The
forward reads ``x`` once in its own dtype and writes per-CTA partial sums
``(ctas, 2, C)``, which a second kernel adds in a fixed order, so the
statistics are the same on every replay.  The backward is one elementwise
pass, ``dx = round(g_mean / n + (g_sq / n) * 2x)``.  The op saves only
``x``, so no float32 copy of the activation lives from the forward to the
backward.  The kernels take bf16 and float32, the train path's dtypes, and
float64, the op path's oracle dtype on the card.  For a CPU tensor it runs
the plain versions :func:`bn_moments_forward_reference` and
:func:`bn_moments_backward_reference`.

``bn_moments_forward.launches`` and ``bn_moments_backward.launches`` count
the op calls that launched kernels, one per call, and nothing else.
"""

from __future__ import annotations

import torch

from stgcn_tpu_torch.kernels.spatial_block import _acc, _raise_on

# dtype codes of bn_moments_fwd_launch / bn_moments_bwd_launch
DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float64: 2}
THREADS = 256       # threads of a CTA, vector units of a channel chunk
VECTOR_BYTES = 16   # a thread's channel unit on the vector path
CTAS_PER_SM = 4     # CTAs over the rows a streaming multiprocessor


def bn_moments_forward_reference(x: torch.Tensor
                                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the forward: ``(mean, mean_sq)`` over
    every axis of ``x`` but the last, in at least float32."""
    xf = x.to(_acc(x.dtype))
    axes = tuple(range(x.dim() - 1))
    return xf.mean(dim=axes), xf.square().mean(dim=axes)


def bn_moments_backward_reference(x: torch.Tensor, g_mean: torch.Tensor,
                                  g_sq: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the backward: autograd's arithmetic for
    :func:`bn_moments_forward_reference` written out, ``g_mean / n +
    (g_sq / n) * 2x`` in at least float32, rounded to ``x``'s dtype."""
    acc = _acc(x.dtype)
    n = x.numel() // x.shape[-1]
    xf = x.to(acc)
    return (g_mean.to(acc) / n + (g_sq.to(acc) / n) * (2 * xf)).to(x.dtype)


def vector_width(x: torch.Tensor) -> int:
    """Elements of a thread's channel unit: 16 bytes where ``C`` is a
    multiple of them and ``x`` starts on a 16-byte boundary, else 1."""
    vec = VECTOR_BYTES // x.element_size()
    if x.shape[-1] % vec == 0 and x.data_ptr() % VECTOR_BYTES == 0:
        return vec
    return 1


def plan_ctas(rows: int, c: int, vec: int, sms: int) -> int:
    """CTAs over the rows: ``CTAS_PER_SM`` a streaming multiprocessor, or
    fewer where the rows do not fill them (a pass of a CTA covers
    ``THREADS // units`` rows of its channel chunk)."""
    units = min(c // vec, THREADS)
    per_pass = THREADS // units
    return max(1, min(-(-rows // per_pass), CTAS_PER_SM * sms))


def _check(x: torch.Tensor) -> tuple[int, int]:
    """``(rows, C)`` of an ``x`` the kernels take."""
    if x.dtype not in DTYPES:
        raise TypeError(f"bn_moments takes float32, bfloat16 or float64, "
                        f"got {x.dtype}")
    if x.dim() < 1 or x.numel() == 0:
        raise ValueError(f"bn_moments needs a non-empty (..., C) tensor, got "
                         f"{tuple(x.shape)}")
    c = x.shape[-1]
    rows = x.numel() // c
    if rows >= 2 ** 31:
        raise ValueError(f"bn_moments takes fewer than 2**31 rows, got {rows}")
    return rows, c


def _launch_plan(x: torch.Tensor) -> tuple[int, int, int, int]:
    rows, c = _check(x)
    vec = vector_width(x)
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    return rows, c, vec, plan_ctas(rows, c, vec, sms)


def bn_moments_forward(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Forward kernel wrapper: plain version on the CPU, kernels on CUDA."""
    if x.device.type == "cpu":
        return bn_moments_forward_reference(x)
    if x.device.type != "cuda":
        raise ValueError(f"bn_moments runs on cuda or cpu, not {x.device}")
    return _launch_forward(x)


def _launch_forward(x):
    from stgcn_tpu_torch.kernels._build import load_library

    x = x.contiguous()
    rows, c, vec, ctas = _launch_plan(x)
    acc = _acc(x.dtype)
    partial = torch.empty((ctas, 2, c), dtype=acc, device=x.device)
    mean = torch.empty(c, dtype=acc, device=x.device)
    mean_sq = torch.empty(c, dtype=acc, device=x.device)
    lib = load_library()
    with torch.cuda.device(x.device):
        err = lib.bn_moments_fwd_launch(
            x.data_ptr(), partial.data_ptr(), mean.data_ptr(),
            mean_sq.data_ptr(), rows, c, DTYPES[x.dtype], vec, ctas,
            torch.cuda.current_stream(x.device).cuda_stream)
    _raise_on(lib, err, "bn_moments forward")
    bn_moments_forward.launches += 1
    return mean, mean_sq


bn_moments_forward.launches = 0


def bn_moments_backward(x: torch.Tensor, g_mean: torch.Tensor,
                        g_sq: torch.Tensor) -> torch.Tensor:
    """Backward kernel wrapper: ``dx`` in ``x``'s dtype.  Plain version on
    the CPU, kernel on CUDA."""
    if x.device.type == "cpu":
        return bn_moments_backward_reference(x, g_mean, g_sq)
    if x.device.type != "cuda":
        raise ValueError(f"bn_moments runs on cuda or cpu, not {x.device}")
    return _launch_backward(x, g_mean, g_sq)


def _launch_backward(x, g_mean, g_sq):
    from stgcn_tpu_torch.kernels._build import load_library

    x = x.contiguous()
    rows, c, vec, ctas = _launch_plan(x)
    acc = _acc(x.dtype)
    if tuple(g_mean.shape) != (c,) or tuple(g_sq.shape) != (c,):
        raise ValueError(f"the gradients must be ({c},), got "
                         f"{tuple(g_mean.shape)} and {tuple(g_sq.shape)}")
    if g_mean.device != x.device or g_sq.device != x.device:
        raise ValueError(f"every bn_moments argument must be on {x.device}")
    g_mean = g_mean.to(acc).contiguous()
    g_sq = g_sq.to(acc).contiguous()
    dx = torch.empty_like(x)
    lib = load_library()
    with torch.cuda.device(x.device):
        err = lib.bn_moments_bwd_launch(
            x.data_ptr(), g_mean.data_ptr(), g_sq.data_ptr(), dx.data_ptr(),
            rows, c, DTYPES[x.dtype], vec, ctas,
            torch.cuda.current_stream(x.device).cuda_stream)
    _raise_on(lib, err, "bn_moments backward")
    bn_moments_backward.launches += 1
    return dx


bn_moments_backward.launches = 0


class _BnMoments(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return bn_moments_forward(x)

    @staticmethod
    def backward(ctx, g_mean, g_sq):
        (x,) = ctx.saved_tensors
        return bn_moments_backward(x, g_mean, g_sq)


def bn_moments(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The differentiable per-channel ``(mean, mean_sq)`` of ``(..., C)``
    over every axis but the last, in at least float32."""
    return _BnMoments.apply(x)
