"""Affine(+ReLU) + graph conv as one op: kernels, plain versions, autograd.

:func:`spatial_block` is the train path's spatial op on V-major
``(V, N, T, C_in)`` activations::

    z = sum_k A_k . round(round(relu?(x * s1 + t1)) . W_k + b_k)

It is the port of ``spatial_block_vm`` (``stgcn_tpu/kernels/block_fused.py``)
and ``spatial_block_packed`` (``stgcn_tpu/kernels/block_packed.py``), both of
which compute this function; the port keeps no channel padding, so ``z`` has
exactly ``C_out`` channels.  The op is a ``torch.autograd.Function`` whose
forward and backward run hand-written CUDA kernels
(``csrc/spatial_block.cu``) for a CUDA tensor: bfloat16 on the tensor
cores (:func:`plan_spatial_mma_forward`, :func:`plan_spatial_mma_backward`;
the backward is a row kernel for t_k and dA, a dx kernel, a dW kernel and
the passes that sum their partial slices), float32 on the scalar kernels
(:func:`plan_frames`).  For a CPU tensor it runs the plain PyTorch versions
:func:`spatial_block_forward_reference` and
:func:`spatial_block_backward_reference`, which round at the same points.

``spatial_block_forward.launches`` and ``spatial_block_backward.launches``
count the op calls that launched kernels, one per call, and nothing else.

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

from stgcn_tpu_torch.kernels.block_eval import (
    KERNEL_DTYPES,
    PAD,
    SMEM_LIMIT,
    pitch,
)

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
    """float32: ``(F, forward shared bytes, backward shared bytes)``, the
    largest frame count per CTA whose float32 buffers fit in shared
    memory."""
    for f in FRAME_TILES:
        fwd = 4 * f * v * (c_in + 2 * c_out)
        bwd = 4 * f * v * (2 * c_in + 3 * c_out)
        if bwd <= SMEM_LIMIT:
            return f, fwd, bwd
    raise ValueError(f"one frame of V={v}, C_in={c_in}, C_out={c_out} does "
                     f"not fit in {SMEM_LIMIT} bytes of shared memory")


# ---- bfloat16: the tensor-core kernels ---------------------------------
# csrc/spatial_block.cu spatial_mma's tiles; shared rows are ``pitch(c)``
# elements wide (block_eval.pitch, tap_mma.cuh)
MMA_ROWS = 128     # rows (frame, joint) of a tile (spatial_mma::BM)
MMA_BN = 64        # columns of a y or dh column block (spatial_mma::BN)
MMA_KC = 32        # weight columns per ring stage (spatial_mma::KC)
MMA_KR = 64        # dW: rows of the GEMM's K per chunk (spatial_mma::KR)
VP = 32            # joints, zero-padded, of A's products (spatial_mma::VP)
MAX_FRAMES = 6     # frames of a tile (spatial_mma::MAX_FRAMES)
YR = MMA_ROWS + 16  # staged rows of g and y (spatial_mma::YR)


def mma_frames(v: int) -> int:
    """F, the frames of a bf16 tile: as many whole frames of ``v`` joints
    as fill the 128 rows of the ``mma`` tile (5 of 25 joints: 125 rows),
    at most MAX_FRAMES; each frame's VP-row window of the aggregation lies
    inside the YR staged rows."""
    if not 1 <= v <= VP:
        raise ValueError(f"the bf16 spatial kernels take 1..{VP} joints, "
                         f"got V={v}")
    frames = min(MAX_FRAMES, MMA_ROWS // v)
    assert (frames - 1) * v + VP <= YR
    return frames


def _ring_bytes(bn: int) -> int:
    return 2 * MMA_KC * (bn + PAD) * 2


def _mma_common(c_in: int, k: int) -> int:
    """Bytes of the ring, the padded adjacency and the staged h."""
    return (_ring_bytes(MMA_BN) + k * VP * (VP + PAD) * 2
            + MMA_ROWS * pitch(c_in) * 2)


def plan_spatial_mma_forward(v: int, c_in: int, c_out: int, k: int
                             ) -> tuple[int, int]:
    """``(F, shared bytes)`` of the bf16 forward: the weight ring, the K
    padded adjacencies, h of the tile's 128 rows and one partition's y of
    one column block."""
    frames = mma_frames(v)
    smem = _mma_common(c_in, k) + YR * (MMA_BN + PAD) * 2
    if smem > SMEM_LIMIT:
        raise ValueError(f"no bf16 spatial tile of C_in={c_in}, K={k} fits "
                         f"in {SMEM_LIMIT} bytes of shared memory")
    return frames, smem


def dw_tile(c_out: int) -> tuple[int, int, int]:
    """``(NJ, BM, BN)`` of a weight-gradient GEMM (this source's dW and
    temporal_block.cu's dWt): 64 input channels by 64 output channels up to
    64 of them, else by 128 (warps of 32 x 8*NJ)."""
    nj = 4 if c_out > 64 else 2
    return nj, 64, 32 * nj


def dw_splits(rows: int, mats: int, c_in: int, c_out: int,
              ctas: int) -> tuple[int, int]:
    """``(splits, rows per split)`` of a weight-gradient GEMM's K =
    ``rows`` for ``mats`` weight matrices (K partitions, or gamma taps):
    enough splits for about ``ctas`` CTAs over the matrix x channel tiles,
    each a whole number of MMA_KR-row chunks."""
    _, bm, bn = dw_tile(c_out)
    tiles = mats * -(-c_in // bm) * -(-c_out // bn)
    want = max(1, round(ctas / tiles))
    split_rows = -(-(-(-rows // want)) // MMA_KR) * MMA_KR
    return -(-rows // split_rows), split_rows


def plan_spatial_mma_backward(v: int, m: int, c_in: int, c_out: int, k: int,
                              ctas: int) -> dict:
    """The bf16 backward's launch: F ``frames``; the t kernel's ``ctas``
    (at most one per tile) and ``t_smem``; the dx GEMM's ``tiles_x`` row
    tiles and ``dx_smem``; the dW GEMM's ``nj_dw``, ``splits`` of
    ``split_rows`` rows and ``dw_smem``."""
    frames = mma_frames(v)
    t_smem = (_mma_common(c_in, k) + YR * pitch(c_out) * 2
              + YR * (MMA_BN + PAD) * 2 + k * 2 * VP * VP * 4)
    dx_smem = (2 * MMA_ROWS * (MMA_KC + PAD) * 2 + _ring_bytes(MMA_BN)
               + 2 * 4 * MMA_BN * 4)
    nj_dw, bm_dw, bn_dw = dw_tile(c_out)
    dw_smem = 2 * MMA_KR * ((bm_dw + PAD) + (bn_dw + PAD)) * 2
    if max(t_smem, dx_smem, dw_smem) > SMEM_LIMIT:
        raise ValueError(f"no bf16 spatial tile of C_in={c_in}, "
                         f"C_out={c_out}, K={k} fits in {SMEM_LIMIT} bytes "
                         f"of shared memory")
    rows = m * v
    splits, split_rows = dw_splits(rows, k, c_in, c_out, ctas)
    return dict(frames=frames, ctas=min(ctas, -(-m // frames)),
                t_smem=t_smem, tiles_x=-(-rows // MMA_ROWS), dx_smem=dx_smem,
                nj_dw=nj_dw, splits=splits, split_rows=split_rows,
                dw_smem=dw_smem)


def _f32(p):
    return None if p is None else p.to(torch.float32).contiguous()


def _ptr(p):
    return None if p is None else p.data_ptr()


def launch_mma_forward(x, s1, t1, w, b, a, *, v, m, relu1, aff, save,
                       vmajor, out_shape):
    """Launch the bf16 forward kernel of any op on this source on ``x``
    (V-major, or ``(N, T, V, C)``, as ``m`` frames of ``v`` joints):
    ``(z, y)``, ``y`` the saved ``(K, *out_shape)`` expansion with ``save``
    (else None); ``s1``, ``t1`` are None without the affine."""
    from stgcn_tpu_torch.kernels._build import load_library

    c_in, k, c_out = w.shape
    frames, smem = plan_spatial_mma_forward(v, c_in, c_out, k)
    cd = x.dtype
    args = [x.contiguous(), _f32(s1), _f32(t1),
            w.to(cd).permute(1, 0, 2).contiguous(), b.to(cd).contiguous(),
            a.to(cd).contiguous()]
    out = torch.empty(out_shape, dtype=cd, device=x.device)
    y = (torch.empty((k, *out_shape), dtype=cd, device=x.device) if save
         else None)
    lib = load_library()
    with torch.cuda.device(x.device):
        err = lib.spatial_mma_fwd_launch(
            *[_ptr(p) for p in args], out.data_ptr(), _ptr(y), v, m, c_in,
            c_out, k, frames, int(aff), int(save), int(relu1), int(vmajor),
            smem, torch.cuda.current_stream(x.device).cuda_stream)
    _raise_on(lib, err, "spatial bf16 forward")
    return out, y


def launch_mma_backward(x, g, s1, t1, w, b, a, y, *, v, m, relu1, aff,
                        vmajor, need_da):
    """Launch the bf16 backward kernels of any op on this source: ``(dx,
    grads)``, grads the float32 ``[dW | db | dA (| ds1 | dt1)]`` with dW
    as ``(K, C_in, C_out)``; ``y`` is the saved expansion (the save op) or
    None, ``b`` None with it."""
    from stgcn_tpu_torch.kernels._build import load_library

    c_in, k, c_out = w.shape
    plan = plan_spatial_mma_backward(v, m, c_in, c_out, k,
                                     partial_ctas(x.device))
    cd, f32 = x.dtype, torch.float32
    wk = w.to(cd).permute(1, 0, 2)                        # (K, C_in, C_out)
    args = [x.contiguous(), g.to(cd).contiguous(), _f32(s1), _f32(t1),
            wk.contiguous(), wk.transpose(1, 2).contiguous(),
            None if b is None else b.to(cd).contiguous(),
            a.to(cd).contiguous(),
            None if y is None else y.to(cd).contiguous()]
    dx = torch.empty_like(args[0])
    t = torch.empty((k, m * v, c_out), dtype=cd, device=x.device)
    e_dw = k * c_in * c_out + k * c_out
    partial_da = torch.empty((plan["ctas"], k * v * v), dtype=f32,
                             device=x.device)
    partial_dx = (torch.empty((plan["tiles_x"], 2 * c_in), dtype=f32,
                              device=x.device) if aff else None)
    partial_dw = torch.empty((plan["splits"], e_dw), dtype=f32,
                             device=x.device)
    grads = torch.empty(e_dw + k * v * v + (2 * c_in if aff else 0),
                        dtype=f32, device=x.device)
    lib = load_library()
    with torch.cuda.device(x.device):
        err = lib.spatial_mma_bwd_launch(
            *[_ptr(p) for p in args], dx.data_ptr(), t.data_ptr(),
            partial_da.data_ptr(), _ptr(partial_dx), partial_dw.data_ptr(),
            grads.data_ptr(), v, m, c_in, c_out, k, plan["frames"], int(aff),
            int(y is not None), int(relu1), int(vmajor), int(need_da),
            plan["ctas"], plan["t_smem"], plan["dx_smem"], plan["nj_dw"],
            plan["splits"], plan["split_rows"], plan["dw_smem"],
            torch.cuda.current_stream(x.device).cuda_stream)
    _raise_on(lib, err, "spatial bf16 backward")
    return dx, grads


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
    if x.dtype == torch.bfloat16:
        out, _ = launch_mma_forward(x, s1, t1, w, b, a, v=v, m=n * t,
                                    relu1=relu1, aff=True, save=False,
                                    vmajor=True, out_shape=(v, n, t, c_out))
        spatial_block_forward.launches += 1
        return out
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
            c_out, k, frames, int(relu1), 0, smem,
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
    m = n * t
    sizes = (k * c_in * c_out, k * c_out, k * v * v, c_in, c_in)
    if x.dtype == torch.bfloat16:
        dx, grads = launch_mma_backward(x, g, s1, t1, w, b, a, None, v=v, m=m,
                                        relu1=relu1, aff=True, vmajor=True,
                                        need_da=need_da)
    else:
        frames, _, smem = plan_frames(v, c_in, c_out)
        ctas = min(partial_ctas(x.device), -(-m // frames))
        cd = x.dtype
        f32 = torch.float32
        wk = w.to(cd).permute(1, 0, 2)                    # (K, C_in, C_out)
        args = [x.contiguous(), g.to(cd).contiguous(),
                s1.to(f32).contiguous(), t1.to(f32).contiguous(),
                wk.contiguous(), wk.transpose(1, 2).contiguous(),
                b.to(cd).contiguous(), a.to(cd).contiguous()]
        dx = torch.empty_like(args[0])
        partial = torch.empty((ctas, sum(sizes)), dtype=f32, device=x.device)
        grads = torch.empty(sum(sizes), dtype=f32, device=x.device)
        lib = load_library()
        with torch.cuda.device(x.device):
            err = lib.spatial_block_bwd_launch(
                *[p.data_ptr() for p in args], dx.data_ptr(),
                partial.data_ptr(), grads.data_ptr(), v, m, c_in, c_out, k,
                frames, ctas, int(relu1), int(need_da), 0, smem,
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
    if x.dtype == torch.bfloat16:
        out, y = launch_mma_forward(x, s1, t1, w, b, a, v=v, m=n * t,
                                    relu1=relu1, aff=True, save=True,
                                    vmajor=True, out_shape=(v, n, t, c_out))
        spatial_block_save_forward.launches += 1
        return out, y
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
            n * t, c_in, c_out, k, frames, int(relu1), 0, smem,
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
    m = n * t
    sizes = (k * c_in * c_out, k * c_out, k * v * v, c_in, c_in)
    if x.dtype == torch.bfloat16:
        dx, grads = launch_mma_backward(x, g, s1, t1, w, None, a, y, v=v, m=m,
                                        relu1=relu1, aff=True, vmajor=True,
                                        need_da=True)
    else:
        frames, _, smem = plan_frames(v, c_in, c_out)
        ctas = min(partial_ctas(x.device), -(-m // frames))
        cd = x.dtype
        f32 = torch.float32
        wk = w.to(cd).permute(1, 0, 2)                    # (K, C_in, C_out)
        args = [x.contiguous(), g.to(cd).contiguous(), y.to(cd).contiguous(),
                s1.to(f32).contiguous(), t1.to(f32).contiguous(),
                wk.contiguous(), wk.transpose(1, 2).contiguous(),
                a.to(cd).contiguous()]
        dx = torch.empty_like(args[0])
        partial = torch.empty((ctas, sum(sizes)), dtype=f32, device=x.device)
        grads = torch.empty(sum(sizes), dtype=f32, device=x.device)
        lib = load_library()
        with torch.cuda.device(x.device):
            err = lib.spatial_block_save_bwd_launch(
                *[p.data_ptr() for p in args], dx.data_ptr(),
                partial.data_ptr(), grads.data_ptr(), v, m, c_in, c_out, k,
                frames, ctas, int(relu1), 0, smem,
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
