"""Affine(+ReLU) + graph conv as one op: kernels, plain versions, autograd.

:func:`spatial_block` is the train path's spatial op on V-major
``(V, N, T, C_in)`` activations::

    z = sum_k A_k . round(round(relu?(x * s1 + t1)) . W_k + b_k)

It is the port of ``spatial_block_vm`` (``stgcn_tpu/kernels/block_fused.py``)
and ``spatial_block_packed`` (``stgcn_tpu/kernels/block_packed.py``), both of
which compute this function; the port keeps no channel padding, so ``z`` has
exactly ``C_out`` channels.  The op is a ``torch.autograd.Function`` whose
forward and backward each launch one hand-written CUDA kernel
(``csrc/spatial_block.cu``) for a CUDA tensor, and run the plain PyTorch
versions :func:`spatial_block_forward_reference` and
:func:`spatial_block_backward_reference`, which round at the same points,
for a CPU tensor.

``spatial_block_forward.launches`` and ``spatial_block_backward.launches``
count the kernel launches, and nothing else.

:func:`spatial_block_save` is the port of ``spatial_block_vm_save``
(``stgcn_tpu/kernels/block_fused.py:737``): the same function, whose
forward also returns every rounded expansion
``y_k = round(round(relu?(x * s1 + t1)) . W_k + b_k)`` as a saved
``(K, V, N, T, C_out)`` tensor in ``x``'s dtype, and whose backward reads it
for the adjacency gradient where :func:`spatial_block` recomputes it.  The
JAX package sends a block there when its graph trains and ``C_in >= 256``
(``stgcn_tpu/models/fused.py:259-268``).  Its kernels are the save variants
of the same source; its plain versions are
:func:`spatial_block_save_forward_reference` and
:func:`spatial_block_save_backward_reference`, and
``spatial_block_save_forward.launches`` and
``spatial_block_save_backward.launches`` count its launches apart from
``spatial_block``'s.
"""

from __future__ import annotations

import torch

from stgcn_tpu_torch.kernels.block_eval import KERNEL_DTYPES, SMEM_LIMIT

FRAME_TILES = (8, 4, 2, 1)


def partial_ctas(device: torch.device) -> int:
    """CTAs of a backward kernel: two per SM of ``device``, each owning one
    slice of the partial weight-gradient sums.  The slices are added in a
    fixed order, so the gradients are the same on every run on one card."""
    return 2 * torch.cuda.get_device_properties(device).multi_processor_count


def _acc(dtype: torch.dtype) -> torch.dtype:
    return torch.promote_types(dtype, torch.float32)


def check_args(x, w, b, a):
    if x.dim() != 4:
        raise ValueError(f"x must be (V, N, T, C_in), got {tuple(x.shape)}")
    v, _, _, c_in = x.shape
    if w.dim() != 3 or w.shape[0] != c_in:
        raise ValueError(f"w must be ({c_in}, K, C_out), got {tuple(w.shape)}")
    _, k, c_out = w.shape
    if tuple(b.shape) != (k, c_out):
        raise ValueError(f"b must be ({k}, {c_out}), got {tuple(b.shape)}")
    if tuple(a.shape) != (k, v, v):
        raise ValueError(f"a must be ({k}, {v}, {v}), got {tuple(a.shape)}")


def spatial_block_forward_reference(x, s1, t1, w, b, a, *, relu1: bool):
    """Plain PyTorch version of the forward kernel, same rounding points.

    ``x``: ``(V, N, T, C_in)``; ``s1, t1``: ``(C_in,)``; ``w``:
    ``(C_in, K, C_out)``, ``b``: ``(K, C_out)``, ``a``: ``(K, V, V)`` in
    ``x``'s dtype.  Returns ``(V, N, T, C_out)`` in ``x``'s dtype.
    """
    return _forward_reference(x, s1, t1, w, b, a, relu1=relu1, save=False)[0]


def _forward_reference(x, s1, t1, w, b, a, *, relu1, save):
    """``(z, y)``: the output and, with ``save``, the rounded expansions
    ``(K, V, N, T, C_out)`` (else None), both in ``x``'s dtype."""
    check_args(x, w, b, a)
    cd, acc = x.dtype, _acc(x.dtype)

    def rnd(t):
        return t.to(cd).to(acc)

    h = x.to(acc) * s1.to(acc) + t1.to(acc)
    if relu1:
        h = torch.relu(h)
    h = rnd(h)
    z, ys = None, []
    for k in range(a.shape[0]):
        y = rnd(h @ w[:, k].to(acc) + b[k].to(acc))
        if save:
            ys.append(y)
        zk = torch.einsum("vw,wntc->vntc", a[k].to(acc), y)
        z = zk if z is None else z + zk
    return z.to(cd), torch.stack(ys).to(cd) if save else None


def spatial_block_backward_reference(x, g, s1, t1, w, b, a, *, relu1: bool,
                                     need_da: bool = True):
    """Plain PyTorch version of the backward kernel, written out (not left
    to autograd) with the rounding points of ``_spatial_bwd_kernel``.

    Returns ``(dx, ds1, dt1, dw, db, da)``, each in its input's dtype;
    ``da`` is zero when ``need_da`` is False.
    """
    check_args(x, w, b, a)
    *grads, da = _backward_reference(x, g, s1, t1, w, b, a, None,
                                     relu1=relu1, need_da=need_da)
    grads[4] = grads[4].to(b.dtype)
    return (*grads, da)


def _backward_reference(x, g, s1, t1, w, b, a, y, *, relu1, need_da):
    """The backward of both ops: dA reads the saved ``y`` if given, else
    recomputes y_k from ``b`` (``need_da``)."""
    cd, acc = x.dtype, _acc(x.dtype)

    def rnd(t, dtype=cd):
        return t.to(dtype).to(acc)

    xf = x.to(acc)
    gf = g.to(acc)
    s1f = s1.to(acc)
    pre = xf * s1f + t1.to(acc)
    h = rnd(torch.relu(pre) if relu1 else pre)
    dh = torch.zeros_like(h)
    dw = torch.zeros(w.shape, dtype=acc, device=x.device)
    db = torch.zeros(w.shape[1:], dtype=acc, device=x.device)
    da = torch.zeros(a.shape, dtype=acc, device=x.device)
    for k in range(a.shape[0]):
        wk, ak = w[:, k].to(acc), a[k].to(acc)
        tk = rnd(torch.einsum("vw,vntc->wntc", ak, gf), g.dtype)
        dh = dh + tk @ wk.t()
        dw[:, k] = torch.einsum("wnti,wntc->ic", h, tk)
        db[k] = tk.sum(dim=(0, 1, 2))
        if y is not None:
            da[k] = torch.einsum("vntc,wntc->vw", gf, y[k].to(acc))
        elif need_da:
            yk = rnd(h @ wk + b[k].to(acc))
            da[k] = torch.einsum("vntc,wntc->vw", gf, yk)
    dpre = torch.where(pre > 0, dh, torch.zeros_like(dh)) if relu1 else dh
    dx = (dpre * s1f).to(x.dtype)
    axes = (0, 1, 2)
    return (dx, (dpre * xf).sum(dim=axes).to(s1.dtype),
            dpre.sum(dim=axes).to(t1.dtype), dw.to(w.dtype), db.to(w.dtype),
            da.to(a.dtype))


def plan_frames(v: int, c_in: int, c_out: int) -> tuple[int, int, int]:
    """``(F, forward shared bytes, backward shared bytes)``: the largest
    frame count per CTA whose float32 buffers fit in shared memory."""
    for f in FRAME_TILES:
        fwd = 4 * f * v * (c_in + 2 * c_out)
        bwd = 4 * f * v * (2 * c_in + 3 * c_out)
        if bwd <= SMEM_LIMIT:
            return f, fwd, bwd
    raise ValueError(f"one frame of V={v}, C_in={c_in}, C_out={c_out} does "
                     f"not fit in {SMEM_LIMIT} bytes of shared memory")


def _check_cuda(name, x, tensors):
    if x.dtype not in KERNEL_DTYPES:
        raise TypeError(f"{name} takes float32 or bfloat16, got {x.dtype}")
    if any(t.device != x.device for t in tensors):
        raise ValueError(f"every {name} argument must be on {x.device}")


def _raise_on(lib, err: int, name: str) -> None:
    if err != 0:
        msg = lib.block_eval_error_string(err).decode()
        raise RuntimeError(f"{name} launch failed: CUDA error {err} ({msg})")


def spatial_block_forward(x, s1, t1, w, b, a, *, relu1: bool):
    """Forward kernel wrapper: plain version on the CPU, kernel on CUDA."""
    if x.device.type == "cpu":
        return spatial_block_forward_reference(x, s1, t1, w, b, a,
                                               relu1=relu1)
    if x.device.type != "cuda":
        raise ValueError(f"spatial_block runs on cuda or cpu, not {x.device}")
    return _launch_forward(x, s1, t1, w, b, a, relu1=relu1)


def _launch_forward(x, s1, t1, w, b, a, *, relu1):
    from stgcn_tpu_torch.kernels._build import load_library

    check_args(x, w, b, a)
    _check_cuda("spatial_block", x, (s1, t1, w, b, a))
    v, n, t, c_in = x.shape
    _, k, c_out = w.shape
    frames, smem, _ = plan_frames(v, c_in, c_out)
    cd = x.dtype
    f32 = torch.float32
    x = x.contiguous()
    args = [x, s1.to(f32).contiguous(), t1.to(f32).contiguous(),
            w.to(cd).permute(1, 0, 2).contiguous(), b.to(cd).contiguous(),
            a.to(cd).contiguous()]
    out = torch.empty((v, n, t, c_out), dtype=cd, device=x.device)
    lib = load_library()
    with torch.cuda.device(x.device):
        err = lib.spatial_block_fwd_launch(
            *[p.data_ptr() for p in args], out.data_ptr(), v, n * t, c_in,
            c_out, k, frames, int(relu1), int(cd == torch.bfloat16), smem,
            torch.cuda.current_stream(x.device).cuda_stream)
    _raise_on(lib, err, "spatial_block forward")
    spatial_block_forward.launches += 1
    return out


spatial_block_forward.launches = 0


def spatial_block_backward(x, g, s1, t1, w, b, a, *, relu1: bool,
                           need_da: bool = True):
    """Backward kernel wrapper: ``(dx, ds1, dt1, dw, db, da)``, each in its
    input's dtype.  Plain version on the CPU, kernel on CUDA."""
    if x.device.type == "cpu":
        return spatial_block_backward_reference(
            x, g, s1, t1, w, b, a, relu1=relu1, need_da=need_da)
    if x.device.type != "cuda":
        raise ValueError(f"spatial_block runs on cuda or cpu, not {x.device}")
    return _launch_backward(x, g, s1, t1, w, b, a, relu1=relu1,
                            need_da=need_da)


def _launch_backward(x, g, s1, t1, w, b, a, *, relu1, need_da):
    from stgcn_tpu_torch.kernels._build import load_library

    check_args(x, w, b, a)
    _check_cuda("spatial_block", x, (g, s1, t1, w, b, a))
    v, n, t, c_in = x.shape
    _, k, c_out = w.shape
    if tuple(g.shape) != (v, n, t, c_out):
        raise ValueError(f"g must be {(v, n, t, c_out)}, got {tuple(g.shape)}")
    frames, _, smem = plan_frames(v, c_in, c_out)
    m = n * t
    ctas = min(partial_ctas(x.device), -(-m // frames))
    cd = x.dtype
    f32 = torch.float32
    wk = w.to(cd).permute(1, 0, 2)                        # (K, C_in, C_out)
    args = [x.contiguous(), g.to(cd).contiguous(), s1.to(f32).contiguous(),
            t1.to(f32).contiguous(), wk.contiguous(),
            wk.transpose(1, 2).contiguous(), b.to(cd).contiguous(),
            a.to(cd).contiguous()]
    sizes = (k * c_in * c_out, k * c_out, k * v * v, c_in, c_in)
    dx = torch.empty_like(args[0])
    partial = torch.empty((ctas, sum(sizes)), dtype=f32, device=x.device)
    grads = torch.empty(sum(sizes), dtype=f32, device=x.device)
    lib = load_library()
    with torch.cuda.device(x.device):
        err = lib.spatial_block_bwd_launch(
            *[p.data_ptr() for p in args], dx.data_ptr(), partial.data_ptr(),
            grads.data_ptr(), v, m, c_in, c_out, k, frames, ctas, int(relu1),
            int(need_da), int(cd == torch.bfloat16), smem,
            torch.cuda.current_stream(x.device).cuda_stream)
    _raise_on(lib, err, "spatial_block backward")
    spatial_block_backward.launches += 1
    dw, db, da, ds1, dt1 = torch.split(grads, sizes)
    dw = dw.view(k, c_in, c_out).permute(1, 0, 2)
    return (dx, ds1.to(s1.dtype), dt1.to(t1.dtype), dw.to(w.dtype),
            db.view(k, c_out).to(b.dtype), da.view(k, v, v).to(a.dtype))


spatial_block_backward.launches = 0


class _SpatialBlock(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, s1, t1, w, b, a, relu1, need_da):
        ctx.save_for_backward(x, s1, t1, w, b, a)
        ctx.flags = dict(relu1=relu1, need_da=need_da)
        return spatial_block_forward(x, s1, t1, w, b, a, relu1=relu1)

    @staticmethod
    def backward(ctx, g):
        x, s1, t1, w, b, a = ctx.saved_tensors
        return (*spatial_block_backward(x, g.contiguous(), s1, t1, w, b, a,
                                        **ctx.flags), None, None)


def spatial_block(x, s1, t1, w, b, a, *, relu1: bool, need_da: bool = True):
    """The differentiable spatial op: ``(V, N, T, C_in) -> (V, N, T, C_out)``.

    ``need_da=False`` (only where the adjacency gradient is unused, i.e. a
    fixed graph) skips the y_k recompute in the backward and returns a zero
    adjacency gradient.
    """
    return _SpatialBlock.apply(x, s1, t1, w, b, a, relu1, need_da)


# ---- spatial_block_save: the forward saves y_k for the backward's dA -------


def spatial_block_save_forward_reference(x, s1, t1, w, b, a, *,
                                         relu1: bool):
    """Plain PyTorch version of the save forward kernel
    (``_spatial_fwd_kernel_save``): ``(z, y)``, ``z`` as
    :func:`spatial_block_forward_reference` gives it and ``y`` the rounded
    expansions ``round(h . W_k + b_k)`` as ``(K, V, N, T, C_out)``, both in
    ``x``'s dtype."""
    return _forward_reference(x, s1, t1, w, b, a, relu1=relu1, save=True)


def spatial_block_save_backward_reference(x, g, y, s1, t1, w, a, *,
                                          relu1: bool):
    """Plain PyTorch version of the save backward kernel
    (``_spatial_bwd_kernel_saved``): dA reads ``y``, the rest is
    :func:`spatial_block_backward_reference`'s.  Returns ``(dx, ds1, dt1,
    dw, db, da)``; ``db`` in ``w``'s dtype."""
    _check_saved(x, w, a, y)
    return _backward_reference(x, g, s1, t1, w, None, a, y, relu1=relu1,
                               need_da=True)


def _check_saved(x, w, a, y):
    v, n, t, _ = x.shape
    k, c_out = a.shape[0], w.shape[-1]
    if tuple(y.shape) != (k, v, n, t, c_out):
        raise ValueError(f"y must be {(k, v, n, t, c_out)}, got "
                         f"{tuple(y.shape)}")


def spatial_block_save_forward(x, s1, t1, w, b, a, *, relu1: bool):
    """Save forward kernel wrapper: ``(z, y)``.  Plain version on the CPU,
    kernel on CUDA."""
    if x.device.type == "cpu":
        return spatial_block_save_forward_reference(x, s1, t1, w, b, a,
                                                    relu1=relu1)
    if x.device.type != "cuda":
        raise ValueError(f"spatial_block_save runs on cuda or cpu, not "
                         f"{x.device}")
    return _launch_save_forward(x, s1, t1, w, b, a, relu1=relu1)


def _launch_save_forward(x, s1, t1, w, b, a, *, relu1):
    from stgcn_tpu_torch.kernels._build import load_library

    check_args(x, w, b, a)
    _check_cuda("spatial_block_save", x, (s1, t1, w, b, a))
    v, n, t, c_in = x.shape
    _, k, c_out = w.shape
    frames, smem, _ = plan_frames(v, c_in, c_out)
    cd = x.dtype
    f32 = torch.float32
    x = x.contiguous()
    args = [x, s1.to(f32).contiguous(), t1.to(f32).contiguous(),
            w.to(cd).permute(1, 0, 2).contiguous(), b.to(cd).contiguous(),
            a.to(cd).contiguous()]
    out = torch.empty((v, n, t, c_out), dtype=cd, device=x.device)
    y = torch.empty((k, v, n, t, c_out), dtype=cd, device=x.device)
    lib = load_library()
    with torch.cuda.device(x.device):
        err = lib.spatial_block_save_fwd_launch(
            *[p.data_ptr() for p in args], out.data_ptr(), y.data_ptr(), v,
            n * t, c_in, c_out, k, frames, int(relu1),
            int(cd == torch.bfloat16), smem,
            torch.cuda.current_stream(x.device).cuda_stream)
    _raise_on(lib, err, "spatial_block_save forward")
    spatial_block_save_forward.launches += 1
    return out, y


spatial_block_save_forward.launches = 0


def spatial_block_save_backward(x, g, y, s1, t1, w, a, *, relu1: bool):
    """Save backward kernel wrapper: ``(dx, ds1, dt1, dw, db, da)``.  Plain
    version on the CPU, kernel on CUDA."""
    if x.device.type == "cpu":
        return spatial_block_save_backward_reference(x, g, y, s1, t1, w, a,
                                                     relu1=relu1)
    if x.device.type != "cuda":
        raise ValueError(f"spatial_block_save runs on cuda or cpu, not "
                         f"{x.device}")
    return _launch_save_backward(x, g, y, s1, t1, w, a, relu1=relu1)


def _launch_save_backward(x, g, y, s1, t1, w, a, *, relu1):
    from stgcn_tpu_torch.kernels._build import load_library

    _check_saved(x, w, a, y)
    _check_cuda("spatial_block_save", x, (g, y, s1, t1, w, a))
    v, n, t, c_in = x.shape
    _, k, c_out = w.shape
    if tuple(g.shape) != (v, n, t, c_out):
        raise ValueError(f"g must be {(v, n, t, c_out)}, got {tuple(g.shape)}")
    frames, _, smem = plan_frames(v, c_in, c_out)
    m = n * t
    ctas = min(partial_ctas(x.device), -(-m // frames))
    cd = x.dtype
    f32 = torch.float32
    wk = w.to(cd).permute(1, 0, 2)                        # (K, C_in, C_out)
    args = [x.contiguous(), g.to(cd).contiguous(), y.to(cd).contiguous(),
            s1.to(f32).contiguous(), t1.to(f32).contiguous(),
            wk.contiguous(), wk.transpose(1, 2).contiguous(),
            a.to(cd).contiguous()]
    sizes = (k * c_in * c_out, k * c_out, k * v * v, c_in, c_in)
    dx = torch.empty_like(args[0])
    partial = torch.empty((ctas, sum(sizes)), dtype=f32, device=x.device)
    grads = torch.empty(sum(sizes), dtype=f32, device=x.device)
    lib = load_library()
    with torch.cuda.device(x.device):
        err = lib.spatial_block_save_bwd_launch(
            *[p.data_ptr() for p in args], dx.data_ptr(), partial.data_ptr(),
            grads.data_ptr(), v, m, c_in, c_out, k, frames, ctas, int(relu1),
            int(cd == torch.bfloat16), smem,
            torch.cuda.current_stream(x.device).cuda_stream)
    _raise_on(lib, err, "spatial_block_save backward")
    spatial_block_save_backward.launches += 1
    dw, db, da, ds1, dt1 = torch.split(grads, sizes)
    dw = dw.view(k, c_in, c_out).permute(1, 0, 2)
    return (dx, ds1.to(s1.dtype), dt1.to(t1.dtype), dw.to(w.dtype),
            db.view(k, c_out).to(w.dtype), da.view(k, v, v).to(a.dtype))


spatial_block_save_backward.launches = 0


class _SpatialBlockSave(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, s1, t1, w, b, a, relu1):
        z, y = spatial_block_save_forward(x, s1, t1, w, b, a, relu1=relu1)
        ctx.save_for_backward(x, s1, t1, w, a, y)
        ctx.relu1 = relu1
        return z

    @staticmethod
    def backward(ctx, g):
        x, s1, t1, w, a, y = ctx.saved_tensors
        dx, ds1, dt1, dw, db, da = spatial_block_save_backward(
            x, g.contiguous(), y, s1, t1, w, a, relu1=ctx.relu1)
        return dx, ds1, dt1, dw, db, da, None


def spatial_block_save(x, s1, t1, w, b, a, *, relu1: bool):
    """:func:`spatial_block` whose forward saves the rounded expansions y_k
    (``K * V * N * T * C_out`` elements in ``x``'s dtype) and whose backward
    reads them for dA instead of recomputing them; always computes dA."""
    return _SpatialBlockSave.apply(x, s1, t1, w, b, a, relu1)
