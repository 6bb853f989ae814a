"""Affine(+ReLU) + temporal conv as one op: kernels, plain versions, autograd.

:func:`temporal_block` is the train path's temporal op on V-major
``(V, N, T, C)`` activations::

    u[t] = round(sum_g zh[t*s - pad + g] . Wt_g + bt),
    zh   = round(relu?(z * s2 + t2)), zero on the (gamma-1)/2 padding frames

It is the port of ``temporal_block_vm`` (``stgcn_tpu/kernels/block_fused.py``)
and ``temporal_block_packed`` (``stgcn_tpu/kernels/block_packed.py``), both of
which compute this function (the packed one for stride 1).  The op is a
``torch.autograd.Function`` whose forward and backward each run hand-written
CUDA kernels (``csrc/temporal_block.cu``) for a CUDA tensor: bfloat16 on
Hopper's warpgroup MMA (``wgmma``, :func:`plan_mma_forward`,
:func:`plan_mma_backward`; the backward is a dx kernel, which also writes
the post-activation ``zh`` into a scratch tensor, a dWt kernel that reads
it, and the passes that sum their partial slices), float32 on the scalar
kernels (:func:`plan_forward`, :func:`plan_backward`).  For a CPU tensor it runs the plain PyTorch versions
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
    _acc,
    _check_cuda,
    _f32,
    _ptr,
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


def _padding(gamma: int, pad: int | None) -> int:
    """``pad`` frames of zeros on both ends; ``None`` is same padding.  The
    kernels take ``0 <= pad <= (gamma - 1) // 2``."""
    if pad is None:
        return (gamma - 1) // 2
    if not 0 <= 2 * pad <= gamma - 1:
        raise ValueError(f"padding must be in [0, {(gamma - 1) // 2}], got "
                         f"{pad}")
    return pad


def temporal_block_forward_reference(z, s2, t2, wt, bt, *, stride: int,
                                     relu2: bool, pad: int | None = None):
    """Plain PyTorch version of the forward kernel, same rounding points.

    ``z``: ``(V, N, T, C)``; ``s2, t2``: ``(C,)``; ``wt``:
    ``(gamma, C, C_out)`` in ``z``'s dtype; ``bt``: ``(C_out,)``; ``pad``
    frames of zeros on both ends (``None``: ``(gamma - 1) // 2``).  Returns
    ``(V, N, T_out, C_out)``.
    """
    check_args(z, wt, square=False)
    acc = _acc(z.dtype)
    gamma, t = wt.shape[0], z.shape[2]
    pad = _padding(gamma, pad)
    t_out = t_out_of(t, stride, gamma, pad)
    _, _, h = _post_activation(z, s2, t2, relu2, acc)
    hp = F.pad(h, (0, 0, pad, pad))
    u = None
    for g in range(gamma):
        tap = hp[:, :, g:g + stride * (t_out - 1) + 1:stride] @ wt[g].to(acc)
        u = tap if u is None else u + tap
    return (u + bt.to(acc)).to(z.dtype)


def temporal_block_backward_reference(z, g, s2, t2, wt, bt, *, stride: int,
                                      relu2: bool, pad: int | None = None):
    """Plain PyTorch version of the backward kernel, written out (not left
    to autograd) with the rounding points of ``_temporal_bwd_kernel``.

    Returns ``(dz, ds2, dt2, dwt, dbt)``, each in its input's dtype.
    """
    check_args(z, wt, square=False)
    acc = _acc(z.dtype)
    gamma, t = wt.shape[0], z.shape[2]
    pad = _padding(gamma, pad)
    t_out = t_out_of(t, stride, gamma, pad)
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


# ---- bfloat16: the warpgroup kernels ------------------------------------
# The constants of temporal_block.cu's mma_path; shared rows of staged
# input frames are ``pitch(c)`` elements wide (block_eval.pitch, tap_mma.cuh)
GEMM_ROWS = 128      # rows of a forward or dx tile: two warpgroups of 64 (BM)
KC = 64              # input channels of a weight ring stage (KC), or
KC_DEEP = 32         # half of it, where a ring of 64 would hold < 3 stages
ATOM = 1024          # swizzle atom: stages start aligned to it (kAtomBytes)
# (input channels, stages) of the weight ring, in order of preference (the
# kernel takes 2-4 stages, kMaxStages)
RINGS = ((KC, 4), (KC, 3), (KC_DEEP, 4), (KC_DEEP, 3), (KC, 2), (KC_DEEP, 2))
N_TILES = (64, 128, 256)  # wgmma N of a tile: the whole C_out up to 256
DW_KR = 128          # dWt: rows of g a chunk (DW_KR)
DW_BM = 64           # dWt: input channels of a CTA (DW_BM)
DW_BN = 64           # dWt: output channels of a CTA (DW_BN)
DW_TAPS = 9          # dWt: taps of a CTA, three per consumer warpgroup
DW_STAGES = (4, 3, 2)  # dWt: depths of the producer's ring, deepest first
DW_GBYTES = DW_KR * 128  # dWt: g of a stage, swizzled 128-byte rows


def gemm_tile(n_out: int) -> int:
    """BN, the N tile of the forward or dx GEMM: the whole ``n_out`` up to
    256, rounded up to a wgmma width of 64, 128 or 256 (wider outputs take
    several N tiles of 256)."""
    return next((bn for bn in N_TILES if n_out <= bn), N_TILES[-1])


def staged_rows(bm: int, rows_per_line: int, walk: int, ntap: int) -> int:
    """The most input rows a tile of ``bm`` GEMM rows stages: each of the
    lines its rows touch needs ``(rows - 1) * walk + ntap`` of them, so
    rows over ``s`` lines need ``walk * (bm - s) + s * ntap``: most with
    the most lines where ``ntap >= walk``, with the fewest where
    ``ntap < walk`` (one tap at stride 2)."""
    segments = min(bm, -(-(bm - 1) // rows_per_line) + 1)
    if ntap < walk:
        segments = -(-bm // rows_per_line)
    return walk * (bm - segments) + segments * ntap


def parity_taps(gamma: int, stride: int, parity: int,
                pad: int | None = None) -> tuple[int, list[int], list[int]]:
    """dx of the input frames ``f = j*stride + parity``: ``(e0, taps,
    shifts)``; frame f takes tap ``taps[i]`` from g row ``j + shifts[i]``
    (``shifts[i] = e0 - i``), the only taps with ``t*s - pad + tap = f``:
    at stride 1 all of them, at stride 2 every other one."""
    pad = _padding(gamma, pad)
    tap0 = (parity + pad) % stride
    taps = list(range(tap0, gamma, stride))
    e0 = (parity + pad - tap0) // stride
    return e0, taps, [e0 - i for i in range(len(taps))]


def gemm_smem(bn: int, kc: int, stages: int, staged: int, k_in: int,
              dx_aff: bool) -> int:
    """Shared bytes of the forward or dx kernel (mma_path::gemm_smem): the
    slack that aligns the ring to a swizzle atom, ``stages`` stages of
    ``kc x bn`` weights with a full and an empty mbarrier each, the 128
    row offsets, the eight warps' column sums (dx with the affine), the
    epilogue's two float32 constants a column and the ``staged`` input
    rows."""
    return (ATOM + stages * (bn * kc * 2 + 16) + 4 * GEMM_ROWS
            + (2 * 8 * bn * 4 if dx_aff else 0) + 2 * bn * 4
            + staged * pitch(k_in) * 2)


def plan_gemm(bn: int, staged: int, k_in: int, dx_aff: bool
              ) -> tuple[int, int, int]:
    """``(kc, stages, shared bytes)``: the first ring of RINGS that fits,
    three or four stages of 64 input channels where they do, else of
    32."""
    for kc, stages in RINGS:
        smem = gemm_smem(bn, kc, stages, staged, k_in, dx_aff)
        if smem <= SMEM_LIMIT:
            return kc, stages, smem
    raise ValueError(f"no bf16 temporal tile of C_in={k_in}, N tile {bn} "
                     f"fits in {SMEM_LIMIT} bytes of shared memory")


def _atoms(nbytes: int) -> int:
    return -(-nbytes // ATOM) * ATOM


def dw_zh_bytes(zrows: int) -> int:
    """A dWt stage's zh (mma_path::dw_zh_bytes): ``zrows`` 128-byte rows
    of 64 channels, 128B-swizzled, in whole swizzle atoms."""
    return _atoms(zrows * 128)


def dw_stage_bytes(zrows: int) -> int:
    """A dWt stage (mma_path::dw_stage_bytes): g's 128 rows x 64 columns,
    then zh, both swizzled and atom-aligned, then the rows' offsets; whole
    swizzle atoms."""
    return _atoms(DW_GBYTES + dw_zh_bytes(zrows) + 4 * DW_KR)


def dwt_smem(zrows: int, stages: int) -> int:
    """Shared bytes of the dWt kernel (mma_path::dwt_smem): the stages,
    their mbarriers and the producer's dbt sums."""
    return ATOM + stages * (dw_stage_bytes(zrows) + 16) + 128 * 8 * 4


def dwt_rows(t_out: int, stride: int, gamma: int) -> int:
    """The most zh rows a dWt chunk stages (mma_path::dwt_rows): DW_KR rows
    of g, their taps' frames (up to DW_TAPS of them) line by line, each
    line's from a multiple of 8 rows (whole 8-row TMA boxes)."""
    segments = min(DW_KR, -(-(DW_KR - 1) // t_out) + 1)
    return staged_rows(DW_KR, t_out, stride, min(gamma, DW_TAPS)) + 7 * segments


def dwt_splits(rows: int, gamma: int, c_in: int, c_out: int,
               ctas: int) -> tuple[int, int]:
    """``(splits, rows per split)`` of the dWt GEMM's K = ``rows``: enough
    splits for about ``ctas`` CTAs over the (tap group, C_in tile, C_out
    tile) CTAs of a split, each a whole number of DW_KR-row chunks."""
    tiles = -(-gamma // DW_TAPS) * -(-c_in // DW_BM) * -(-c_out // DW_BN)
    want = max(1, round(ctas / tiles))
    split_rows = -(-(-(-rows // want)) // DW_KR) * DW_KR
    return -(-rows // split_rows), split_rows


def plan_mma_forward(t: int, c_in: int, c_out: int, stride: int,
                     gamma: int, pad: int | None = None
                     ) -> tuple[int, int, int, int]:
    """``(BN, kc, stages, shared bytes)`` of the bf16 forward: the weight
    ring, the row offsets and the staged input frames of one tile."""
    bn = gemm_tile(c_out)
    t_out = t_out_of(t, stride, gamma, _padding(gamma, pad))
    return (bn, *plan_gemm(bn, staged_rows(GEMM_ROWS, t_out, stride, gamma),
                           c_in, False))


def dx_staged_rows(t: int, stride: int, gamma: int,
                   pad: int | None = None) -> int:
    """The most input rows a dx tile stages, over the input-frame
    parities."""
    rows = 0
    for parity in range(stride):
        per_line = -(-(t - parity) // stride)
        if per_line > 0:
            ntap = len(parity_taps(gamma, stride, parity, pad)[1])
            rows = max(rows, staged_rows(GEMM_ROWS, per_line, 1, ntap))
    return rows


def plan_mma_backward(lines: int, t: int, c_in: int, c_out: int,
                      stride: int, gamma: int, aff: bool, ctas: int,
                      pad: int | None = None) -> dict:
    """The bf16 backward's launch: the dx GEMM's N tile ``bn_dx``, ring
    (``kc_dx`` channels, ``stages_dx`` stages), row tiles per parity
    ``tiles_x`` and ``dx_smem``; the
    dWt GEMM's ``splits`` of ``split_rows`` rows (about ``ctas`` CTAs in
    all), its ring of ``dw_stages`` and ``dw_smem``."""
    t_out = t_out_of(t, stride, gamma, _padding(gamma, pad))
    bn = gemm_tile(c_in)
    kc, stages, dx_smem = plan_gemm(bn, dx_staged_rows(t, stride, gamma, pad),
                                    c_out, aff)
    zrows = dwt_rows(t_out, stride, gamma)
    dw_stages = next((n for n in DW_STAGES
                      if dwt_smem(zrows, n) <= SMEM_LIMIT), None)
    if dw_stages is None:
        raise ValueError(f"no bf16 dWt ring of T_out={t_out} fits in "
                         f"{SMEM_LIMIT} bytes of shared memory")
    splits, split_rows = dwt_splits(lines * t_out, gamma, c_in, c_out, ctas)
    return dict(bn_dx=bn, kc_dx=kc, stages_dx=stages,
                tiles_x=-(-lines * -(-t // stride) // GEMM_ROWS),
                dx_smem=dx_smem, splits=splits, split_rows=split_rows,
                dw_stages=dw_stages, dw_smem=dwt_smem(zrows, dw_stages))


def sm_count(device: torch.device) -> int:
    """The dWt kernel's CTAs to fill: one per SM (512 threads take an SM's
    registers)."""
    return torch.cuda.get_device_properties(device).multi_processor_count


def launch_mma_forward(x, s2, t2, w, b, *, v, n, t, stride, relu2, aff,
                       vmajor, out_shape, pad=None):
    """Launch the bf16 forward kernel of either op on ``x`` (V-major, or
    ``(N, T, V, C)``, as ``(V, N, T)`` joints, sequences and frames);
    ``s2``, ``t2`` are None without the affine; ``pad`` frames of zeros on
    both ends (``None``: same padding)."""
    from stgcn_tpu_torch.kernels._build import load_library

    gamma, c_in, c_out = w.shape
    pad = _padding(gamma, pad)
    bn, kc, stages, smem = plan_mma_forward(t, c_in, c_out, stride, gamma,
                                            pad)
    args = [x.contiguous(), _f32(s2), _f32(t2), w.to(x.dtype).contiguous(),
            _f32(b)]
    out = torch.empty(out_shape, dtype=x.dtype, device=x.device)
    lib = load_library()
    with torch.cuda.device(x.device):
        err = lib.temporal_mma_fwd_launch(
            *[_ptr(p) for p in args], out.data_ptr(), v, n, t, c_in,
            c_out, gamma, stride, pad, int(aff), int(relu2), int(vmajor), bn,
            kc, stages, smem,
            torch.cuda.current_stream(x.device).cuda_stream)
    _raise_on(lib, err, "temporal bf16 forward")
    return out


def launch_mma_backward(x, g, s2, t2, w, *, v, n, t, stride, relu2, aff,
                        vmajor, pad=None):
    """Launch the bf16 backward kernels of either op: ``(dx, grads)``,
    grads the float32 ``[dWt | dbt (| ds2 | dt2)]``."""
    from stgcn_tpu_torch.kernels._build import load_library

    gamma, c_in, c_out = w.shape
    pad = _padding(gamma, pad)
    plan = plan_mma_backward(v * n, t, c_in, c_out, stride, gamma, aff,
                             sm_count(x.device), pad)
    f32 = torch.float32
    args = [x.contiguous(), g.to(x.dtype).contiguous(), _f32(s2), _f32(t2),
            w.to(x.dtype).transpose(1, 2).contiguous()]  # (gamma, C_out, C_in)
    dx = torch.empty_like(args[0])
    e_dw = gamma * c_in * c_out + c_out
    partial_dw = torch.empty((plan["splits"], e_dw), dtype=f32,
                             device=x.device)
    partial_dx = (torch.empty((stride * plan["tiles_x"], 2 * c_in),
                              dtype=f32, device=x.device) if aff else None)
    # the dx kernel writes zh = round([relu](x * s2 + t2)) here for dWt
    zh = torch.empty_like(args[0]) if aff else None
    grads = torch.empty(e_dw + (2 * c_in if aff else 0), dtype=f32,
                        device=x.device)
    lib = load_library()
    with torch.cuda.device(x.device):
        err = lib.temporal_mma_bwd_launch(
            *[_ptr(p) for p in args], dx.data_ptr(), partial_dw.data_ptr(),
            _ptr(partial_dx), _ptr(zh), grads.data_ptr(), v, n,
            t, c_in, c_out, gamma, stride, pad, int(aff), int(relu2),
            int(vmajor), plan["bn_dx"], plan["kc_dx"], plan["stages_dx"],
            plan["tiles_x"],
            plan["dx_smem"], plan["splits"], plan["split_rows"],
            plan["dw_stages"], plan["dw_smem"],
            torch.cuda.current_stream(x.device).cuda_stream)
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
