"""Affine(+ReLU) + graph conv as one op: kernels, plain versions, autograd.

:func:`spatial_block` is the train path's spatial op on V-major
``(V, N, T, C_in)`` activations::

    z = sum_k A_k . round(round(relu?(x * s1 + t1)) . W_k + b_k)

It is the port of ``spatial_block_vm`` (``stgcn_tpu/kernels/block_fused.py``)
and ``spatial_block_packed`` (``stgcn_tpu/kernels/block_packed.py``), both of
which compute this function; the port keeps no channel padding, so ``z`` has
exactly ``C_out`` channels.  The op is a ``torch.autograd.Function`` whose
forward and backward run hand-written CUDA kernels
(``csrc/spatial_block.cu``) for a CUDA tensor: bfloat16 on Hopper's
warpgroup MMA (:func:`plan_spatial_mma_forward`,
:func:`plan_spatial_mma_backward`; the backward is a row kernel for t_k
and dA, a dx GEMM, a dW GEMM and the passes that sum their partial
slices), float32 on the scalar kernels (:func:`plan_frames`).  For a CPU
tensor it runs the plain PyTorch versions
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
    ATOM,
    HALF_SM,
    KERNEL_DTYPES,
    MAX_RESIDENT,
    N_TILES,
    PAD,
    RINGS,
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


# ---- bfloat16: the warpgroup kernels -------------------------------------
# csrc/spatial_block.cu spatial_wg's tiles and shared layouts; shared rows of
# h are ``pitch(c)`` elements wide (block_eval.pitch, tap_mma.cuh)
MMA_ROWS = 128     # rows (frame, joint) of a tile (spatial_wg::BM)
SLAB = 64          # output channels of a slab (spatial_wg::SN)
VP = 32            # joints, zero-padded, of A's products (spatial_wg::VP)
MAX_FRAMES = 6     # frames of a tile (spatial_wg::MAX_FRAMES)
YR = MMA_ROWS + 16  # rows of a slab buffer (spatial_wg::YR)
SLAB_BYTES = YR * (SLAB + PAD) * 2
DX_TILE = MMA_ROWS * 128   # dx: a stage's t box, 128 rows of 64 channels
DW_KR = 128        # dW: rows of a chunk (spatial_wg::DW_KR)
DW_BOX = DW_KR * 128       # dW: a box of 64 channels of a chunk
MAX_K = 4          # partitions the kernels take (spatial_wg::kMaxK)
GEMM_STAGES = (4, 3, 2)    # ring depths of the dx and dW kernels, preferred
ALIGN = 8          # elements of a 16-byte row stride: TMA's


def round_up(v: int, m: int) -> int:
    return -(-v // m) * m


def mma_frames(v: int) -> int:
    """F, the frames of a bf16 tile: as many whole frames of ``v`` joints
    as fill the 128 rows of two consumer warpgroups (5 of 25 joints: 125
    rows), at most MAX_FRAMES; each frame's VP-row window of the
    aggregation lies inside the YR rows of a slab buffer."""
    if not 1 <= v <= VP:
        raise ValueError(f"the bf16 spatial kernels take 1..{VP} joints, "
                         f"got V={v}")
    frames = min(MAX_FRAMES, MMA_ROWS // v)
    assert (frames - 1) * v + VP <= YR
    return frames


def fwd_smem(c_in: int, c_out: int, k: int, kc: int, stages: int) -> int:
    """Shared bytes of the forward (spatial_wg::fwd_smem_bytes): the slack
    that aligns the ring to a swizzle atom, ``stages`` stages of ``kc`` W
    rows by one slab with a full and an empty mbarrier each, the two h
    buffers' mbarriers, b_k as float32 per column (C_out rounded up to a
    slab), s1 and t1 per input channel, the K padded adjacencies, two
    buffers of h of a tile's rows at ``pitch(c_in)``, a slab's y_k for each
    partition."""
    return (ATOM + stages * (kc * 128 + 16) + 32 + 4 * k * round_up(c_out,
                                                                    SLAB)
            + 8 * round_up(c_in, 16) + 2 * k * VP * (VP + PAD)
            + 2 * 2 * MMA_ROWS * pitch(c_in) + k * SLAB_BYTES)


def t_smem(c_in: int, c_out: int, k: int, kc: int, stages: int, hbufs: int,
           gslots: int, save: bool) -> int:
    """Shared bytes of the backward's t kernel (spatial_wg::t_smem_bytes):
    the slack, the W ring and its mbarriers (``stages`` = 0 where y_k is
    not recomputed), the h and g buffers' mbarriers, b_k, s1 and t1, the dA
    sums ``[K][2][VP][VP]`` in float32, the K padded A_k^T, ``hbufs``
    buffers of h (0 where y_k is not recomputed), ``gslots`` g slab buffers
    (with ``save`` each also holds the K saved y_k slabs), and where y_k is
    recomputed (``hbufs`` > 0) its slab."""
    return (ATOM + stages * (kc * 128 + 16) + 64
            + 4 * k * round_up(c_out, SLAB) + 8 * round_up(c_in, 16)
            + 4 * k * 2 * VP * VP + 2 * k * VP * (VP + PAD)
            + hbufs * MMA_ROWS * pitch(c_in) * 2
            + gslots * (1 + (k if save else 0)) * SLAB_BYTES
            + (SLAB_BYTES if hbufs else 0))


def dx_smem(bn: int, stages: int, c_in: int, xtile: bool) -> int:
    """Shared bytes of the dx kernel (spatial_wg::dx_smem_bytes): the
    slack, the ring (a stage: a t box of 128 rows by 64 channels and
    ``bn`` / 64 boxes of W^T's 64 rows) and its mbarriers, the x tile's
    mbarrier, the column sums ``[2][8][bn]`` and s1, t1 ``[2][bn]`` in
    float32, and with ``xtile`` the tile's x rows at ``pitch(c_in)``."""
    return (ATOM + stages * (DX_TILE + bn * 128 + 16) + 16 + 2 * 8 * bn * 4
            + 2 * bn * 4 + (MMA_ROWS * pitch(c_in) * 2 if xtile else 0))


def dw_smem(k: int, stages: int) -> int:
    """Shared bytes of the dW kernel (spatial_wg::dw_smem_bytes): the
    slack, the ring (a stage: h's box and a t box for each partition, DW_KR
    rows by 64 channels each) and its mbarriers, db's column sums
    ``[64][8]`` in float32."""
    return ATOM + stages * ((1 + k) * DW_BOX + 16) + 64 * 8 * 4


def _check_k(k: int) -> None:
    if not 1 <= k <= MAX_K:
        raise ValueError(f"the bf16 spatial kernels take 1..{MAX_K} "
                         f"partitions, got K={k}")


def _w_ring(smem_of, c_in: int, c_out: int, k: int, what: str,
            bufs=((0, 0),)) -> tuple:
    """``(*buffers, kc, stages, shared bytes)`` of a W ring and the
    kernel's buffers (``bufs``, in order of preference), in order of
    preference: two CTAs an SM (HALF_SM each) with W resident (a stage for
    each of a tile's 64-row chunks, up to MAX_RESIDENT, loaded once a CTA)
    or a ring of three stages or more, the most buffers first; then one
    CTA with W resident or the deepest ring, then the most buffers."""
    chunks = -(-c_out // SLAB) * k * -(-c_in // 64)   # a tile's, kc = 64
    resident = [(64, max(2, chunks))] if chunks <= MAX_RESIDENT else []
    two = [ring for ring in RINGS if ring[1] >= 3]
    candidates = ([(HALF_SM, buf, ring) for buf in bufs
                   for ring in resident + two]
                  + [(SMEM_LIMIT, buf, ring) for ring in resident + list(RINGS)
                     for buf in bufs])
    for limit, buf, (kc, stages) in candidates:
        smem = smem_of(*buf, kc, stages)
        if smem <= limit:
            return (*buf, kc, stages, smem)
    raise ValueError(f"no bf16 spatial {what} tile of C_in={c_in}, "
                     f"C_out={c_out}, K={k} fits in {SMEM_LIMIT} bytes of "
                     f"shared memory")


def plan_spatial_mma_forward(v: int, c_in: int, c_out: int, k: int) -> dict:
    """The bf16 forward's launch: ``frames`` a tile and the W ring
    (``kc`` rows a stage, ``stages``) with its shared bytes ``smem``; two
    persistent CTAs an SM where ``smem`` <= HALF_SM, else one."""
    _check_k(k)
    frames = mma_frames(v)
    _, _, kc, stages, smem = _w_ring(
        lambda _h, _g, kc, st: fwd_smem(c_in, c_out, k, kc, st), c_in, c_out,
        k, "forward")
    return dict(frames=frames, kc=kc, stages=stages, smem=smem)


def plan_spatial_mma_backward(v: int, m: int, c_in: int, c_out: int, k: int,
                              sms: int, *, save: bool = False,
                              need_da: bool = True,
                              reads_x: bool = True) -> dict:
    """The bf16 backward's launch.  The t kernel: ``t_ctas`` persistent
    CTAs (two an SM, at most one a tile, whatever the shared bytes: a
    second wave where only one fits, so the save op's tiles fall to the
    CTAs the recompute's do and its dA sums in the same order), its
    W ring (``t_kc``, ``t_stages``) and ``t_hbufs`` h buffers where y_k is
    recomputed (need_da without save; else none, ``t_stages`` = 0),
    ``t_gslots`` g slab buffers, ``t_smem``: two CTAs an SM with the most
    buffers that allow it, else one with the most that fit.  The dx GEMM:
    ``tiles_x`` row tiles of 128, the N tile ``dx_bn`` (the whole C_in),
    ``dx_stages``, ``dx_smem``; it stages its tile's x rows (``dx_xtile``)
    where its epilogue ``reads_x`` (the affine, or an h scratch for the dW
    kernel), N <= 128 and a ring of three stages or more still fits (two
    CTAs an SM at N = 64).  The dW GEMM: ``dw_splits`` slices of
    ``dw_split_rows`` rows (whole chunks of DW_KR), about one CTA an SM
    over the channel tiles, ``dw_stages``, ``dw_smem``.  ``tp`` and ``hp`` are the row
    pitches of the t and h scratch tensors (16-byte strides)."""
    _check_k(k)
    if c_in > N_TILES[-1]:
        raise ValueError(f"the bf16 spatial backward takes C_in <= "
                         f"{N_TILES[-1]}, got {c_in}")
    frames = mma_frames(v)
    tiles = -(-m // frames)
    if need_da and not save:
        # a second h or g buffer, or both: two CTAs an SM with one of each
        # ran slower than one CTA with two of each (C = 128, H100)
        t_hbufs, t_gslots, t_kc, t_stages, smem = _w_ring(
            lambda hb, gs, kc, st: t_smem(c_in, c_out, k, kc, st, hb, gs,
                                          False), c_in, c_out, k, "t",
            bufs=((2, 2), (1, 2), (2, 1)))
    else:
        t_hbufs, t_kc, t_stages = 0, 64, 0
        fits = [(gs, t_smem(c_in, c_out, k, t_kc, 0, 0, gs, save))
                for gs in (2, 1)]
        t_gslots, smem = next(
            (f for limit in (HALF_SM, SMEM_LIMIT) for f in fits
             if f[1] <= limit), (0, None))
        if smem is None:
            raise ValueError(f"no bf16 spatial t tile of C_out={c_out}, "
                             f"K={k} fits in {SMEM_LIMIT} bytes")
    dx_bn = next(n for n in N_TILES if c_in <= n)
    limits = (HALF_SM, SMEM_LIMIT) if dx_bn == N_TILES[0] else (SMEM_LIMIT,)
    dx_xtile, dx_stages = next(
        (xt, st) for xt in ((True, False) if reads_x and dx_bn <= 128
                            else (False,))
        for limit in limits for st in (GEMM_STAGES[:2] if xt else GEMM_STAGES)
        if dx_smem(dx_bn, st, c_in, xt) <= limit)
    dw_stages = next((st for st in GEMM_STAGES
                      if dw_smem(k, st) <= SMEM_LIMIT), None)
    if dw_stages is None:
        raise ValueError(f"no bf16 spatial dW stage of K={k} fits in "
                         f"{SMEM_LIMIT} bytes of shared memory")
    rows = m * v
    channel_tiles = -(-c_in // 64) * -(-c_out // SLAB)
    want = max(1, round(sms / channel_tiles))
    split_rows = round_up(-(-rows // want), DW_KR)
    return dict(frames=frames, t_ctas=min(tiles, 2 * sms), t_kc=t_kc,
                t_stages=t_stages, t_hbufs=t_hbufs, t_gslots=t_gslots,
                t_smem=smem,
                tiles_x=-(-rows // MMA_ROWS), dx_bn=dx_bn,
                dx_stages=dx_stages, dx_xtile=int(dx_xtile),
                dx_smem=dx_smem(dx_bn, dx_stages, c_in, dx_xtile),
                dw_stages=dw_stages, dw_splits=-(-rows // split_rows),
                dw_split_rows=split_rows, dw_smem=dw_smem(k, dw_stages),
                tp=round_up(c_out, ALIGN), hp=round_up(c_in, ALIGN))


# the order of plan_spatial_mma_backward's values in spatial_mma_bwd_launch's
# arguments
BWD_PLAN_KEYS = ("t_ctas", "t_kc", "t_stages", "t_hbufs", "t_gslots",
                 "t_smem", "dx_bn", "dx_stages", "dx_xtile", "dx_smem",
                 "dw_stages", "dw_splits", "dw_split_rows", "dw_smem")


def x_rows_readable(x: torch.Tensor, aff: bool) -> bool:
    """Whether the dW kernel reads x itself (TMA: 16-byte row strides and a
    16-byte-aligned base, no affine); else the dx kernel writes h, or x,
    to a scratch at a padded pitch for it."""
    return not aff and x.shape[-1] % ALIGN == 0 and x.data_ptr() % 16 == 0


def sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _f32(p):
    return None if p is None else p.to(torch.float32).contiguous()


def _ptr(p):
    return None if p is None else p.data_ptr()


def _padded_rows(t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``t`` in ``dtype`` with its last axis zero-padded to a multiple of
    ALIGN (16-byte rows, which TMA reads), contiguous."""
    c = t.shape[-1]
    out = t.new_zeros((*t.shape[:-1], round_up(c, ALIGN)), dtype=dtype)
    out[..., :c] = t
    return out


def launch_mma_forward(x, s1, t1, w, b, a, *, v, m, relu1, aff, save,
                       vmajor, out_shape):
    """Launch the bf16 forward kernel of any op on this source on ``x``
    (V-major, or ``(N, T, V, C)``, as ``m`` frames of ``v`` joints):
    ``(z, y)``, ``y`` the saved ``(K, *out_shape)`` expansion with ``save``
    (else None); ``s1``, ``t1`` are None without the affine."""
    from stgcn_tpu_torch.kernels._build import load_library

    c_in, k, c_out = w.shape
    plan = plan_spatial_mma_forward(v, c_in, c_out, k)
    cd = x.dtype
    args = [x.contiguous(), _f32(s1), _f32(t1),
            _padded_rows(w.permute(1, 0, 2), cd), b.to(cd).contiguous(),
            a.to(cd).contiguous()]
    out = torch.empty(out_shape, dtype=cd, device=x.device)
    y = (torch.empty((k, *out_shape), dtype=cd, device=x.device) if save
         else None)
    lib = load_library()
    with torch.cuda.device(x.device):
        err = lib.spatial_mma_fwd_launch(
            *[_ptr(p) for p in args], out.data_ptr(), _ptr(y), v, m, c_in,
            c_out, k, plan["frames"], int(aff), int(save), int(relu1),
            int(vmajor), plan["kc"], plan["stages"], plan["smem"],
            torch.cuda.current_stream(x.device).cuda_stream)
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
    save = y is not None
    x = x.contiguous()
    reads_x = not x_rows_readable(x, aff)   # the affine, or an h scratch
    plan = plan_spatial_mma_backward(v, m, c_in, c_out, k,
                                     sm_count(x.device), save=save,
                                     need_da=need_da, reads_x=reads_x)
    cd, f32 = x.dtype, torch.float32
    wk = w.to(cd).permute(1, 0, 2)                        # (K, C_in, C_out)
    args = [x, g.to(cd).contiguous(), _f32(s1), _f32(t1),
            _padded_rows(wk, cd), _padded_rows(wk.transpose(1, 2), cd),
            None if b is None else b.to(cd).contiguous(),
            a.to(cd).contiguous(),
            None if y is None else y.to(cd).contiguous()]
    dx = torch.empty_like(x)
    rows = m * v
    t = torch.empty((k, rows, plan["tp"]), dtype=cd, device=x.device)
    h = (torch.empty((rows, plan["hp"]), dtype=cd, device=x.device)
         if reads_x else None)
    e_dw = k * c_in * c_out + k * c_out
    partial_da = torch.empty((plan["t_ctas"], k * v * v), dtype=f32,
                             device=x.device)
    partial_dx = (torch.empty((plan["tiles_x"], 2 * c_in), dtype=f32,
                              device=x.device) if aff else None)
    partial_dw = torch.empty((plan["dw_splits"], e_dw), dtype=f32,
                             device=x.device)
    grads = torch.empty(e_dw + k * v * v + (2 * c_in if aff else 0),
                        dtype=f32, device=x.device)
    lib = load_library()
    with torch.cuda.device(x.device):
        err = lib.spatial_mma_bwd_launch(
            *[_ptr(p) for p in args], dx.data_ptr(), t.data_ptr(), _ptr(h),
            partial_da.data_ptr(), _ptr(partial_dx), partial_dw.data_ptr(),
            grads.data_ptr(), v, m, c_in, c_out, k, plan["frames"], int(aff),
            int(save), int(relu1), int(vmajor), int(need_da),
            *[plan[key] for key in BWD_PLAN_KEYS],
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
            c_out, k, frames, int(relu1), smem,
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
                frames, ctas, int(relu1), int(need_da), smem,
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
            n * t, c_in, c_out, k, frames, int(relu1), smem,
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
                frames, ctas, int(relu1), smem,
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
