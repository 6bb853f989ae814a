"""Whole eval block: wrapper, plain version, planners and launch count.

:func:`block_eval` computes one ST-GCN eval block on V-major
``(V, N, T, C_in)`` activations, with its BatchNorms folded into affines.
It is the port of ``fused_block_vm`` (``stgcn_tpu/kernels/block_fused.py``)
and ``fused_block_packed_eval`` (``stgcn_tpu/kernels/block_packed.py``),
without their TPU-layout arguments (``t_valid``, ``out_tp``, the packed
layout).  For a CUDA tensor it launches the hand-written kernels in
``csrc/block_eval.cu``: bfloat16 on Hopper's warpgroup MMA, a spatial
kernel that writes z to a scratch tensor and a taps kernel (after a
projection pass with the projection shortcut), planned by
:func:`plan_mma`; float32 on the scalar kernel, planned by
:func:`plan_tiles`.  For a CPU tensor it runs the plain PyTorch version
:func:`block_eval_reference`, which rounds at the same points.

``block_eval.launches`` counts the calls that launched kernels, one per
call whatever the kernels it launches, and nothing else.
"""

from __future__ import annotations

import torch

SMEM_LIMIT = 232_448        # bytes of shared memory a CTA may use (sm_90)
THREADS = 256               # threads of a float32 CTA (csrc/block_eval.cu)
MAX_ROWS = 32               # largest per-thread row count the kernel has
TILE_FRAMES = (16, 8, 4, 2, 1)
SHORTCUTS = {"none": 0, "id": 1, "proj": 2}
KERNEL_DTYPES = (torch.float32, torch.bfloat16)
PAD = 8                     # bf16 elements of shared-row padding (tap_mma.cuh)
# ---- bfloat16: the constants of block_eval.cu's be_mma ----
GEMM_ROWS = 128             # rows of a tile: two consumer warpgroups (BM)
SLAB = 64                   # spatial: output channels of a slab (SN)
VP = 32                     # joints, zero-padded, of A's products (VP)
MAX_FRAMES = 6              # spatial: frames of a tile (MAX_FRAMES)
YR = GEMM_ROWS + 16         # rows of a y buffer (YR)
ATOM = 1024                 # swizzle atom: rings start aligned to it
# shared bytes of a CTA that shares its SM with another: half of the SM's
# 228 KB less the 1 KB each CTA's block reserves (kHalfSmBytes)
HALF_SM = 233_472 // 2 - 1024
# (rows or input channels, stages) of a weight ring, in order of preference
# (2-4 stages of 64 or 32 rows)
RINGS = ((64, 4), (64, 3), (32, 4), (32, 3), (64, 2), (32, 2))
N_TILES = (64, 128, 256)    # wgmma N of the taps: the whole C_out
MAX_RESIDENT = 8            # spatial: stages of a resident W (kMaxResident)


def pitch(c: int) -> int:
    """Elements of a shared bf16 row of ``c`` channels: ``c`` rounded up to
    16 (a zero tail) plus ``PAD``, so ldmatrix rows are 16-byte aligned and
    free of bank conflicts."""
    return -(-c // 16) * 16 + PAD


def t_out_of(t: int, stride: int, gamma: int, pad: int | None = None) -> int:
    """Frames after a temporal conv of width gamma with ``pad`` frames of
    zeros on both ends (``None``: same padding, ``(gamma - 1) // 2``)."""
    if pad is None:
        pad = (gamma - 1) // 2
    return (t + 2 * pad - gamma) // stride + 1


def check_block_args(x, w, a, wt, wr, br, *, stride, order, shortcut,
                     lengths):
    """Raise ``ValueError`` on a block the kernel does not compute."""
    if x.dim() != 4:
        raise ValueError(f"x must be (V, N, T, C_in), got {tuple(x.shape)}")
    v, n, _, c_in = x.shape
    gamma, c_mid, c_out = wt.shape
    k = a.shape[0]
    if order not in ("pre", "post"):
        raise ValueError(f"order must be pre|post, got {order!r}")
    if shortcut not in SHORTCUTS:
        raise ValueError(f"shortcut must be none|id|proj, got {shortcut!r}")
    if shortcut == "id" and (stride != 1 or c_in != c_out):
        raise ValueError("identity shortcut needs stride 1 and C_in == C_out")
    if shortcut == "proj" and (wr is None or br is None):
        raise ValueError("shortcut='proj' needs wr/br")
    if tuple(w.shape) != (c_in, k, c_out) or c_mid != c_out:
        raise ValueError(f"w {tuple(w.shape)} / wt {tuple(wt.shape)} do not "
                         f"match C_in={c_in}, K={k}, C_out={c_out}")
    if tuple(a.shape) != (k, v, v):
        raise ValueError(f"a must be ({k}, {v}, {v}), got {tuple(a.shape)}")
    if gamma % 2 != 1 or stride < 1:
        raise ValueError(f"need an odd gamma and stride >= 1, got "
                         f"{gamma}, {stride}")
    if lengths is not None and tuple(lengths.shape) != (n,):
        raise ValueError(f"lengths must be ({n},), got "
                         f"{tuple(lengths.shape)}")


def block_eval_reference(x, s1, t1, w, b, a, wt, bt, s2, t2, wr=None,
                         br=None, *, stride: int, order: str, shortcut: str,
                         relu1: bool, final_relu: bool = True, lengths=None):
    """Plain PyTorch version of :func:`block_eval`, same rounding points.

    Products of values rounded to the activation dtype are summed in at
    least float32, which is what the kernel's float32 accumulators do.
    """
    check_block_args(x, w, a, wt, wr, br, stride=stride, order=order,
                     shortcut=shortcut, lengths=lengths)
    cd = x.dtype
    acc = torch.promote_types(cd, torch.float32)

    def rnd(t):
        return t.to(cd).to(acc)

    v, n, t, c_in = x.shape
    gamma, _, c_out = wt.shape
    pad_l = (gamma - 1) // 2
    t_out = t_out_of(t, stride, gamma)
    xf = x.to(acc)
    xin = xf
    if lengths is not None:
        valid = (torch.arange(t, device=x.device)[None, :]
                 < lengths.to(x.device)[:, None])
        xin = torch.where(valid[None, :, :, None], xf, torch.zeros_like(xf))
    h = xin * s1.to(acc) + t1.to(acc)
    if relu1:
        h = torch.relu(h)
    h = rnd(h)
    z = None
    for k in range(a.shape[0]):
        y = rnd(h @ rnd(w[:, k, :]) + rnd(b[k]))
        zk = torch.einsum("vw,wntc->vntc", rnd(a[k]), y)
        z = zk if z is None else z + zk
    if order == "pre":
        z = torch.relu(z * s2.to(acc) + t2.to(acc))
    z = rnd(z)
    zp = torch.nn.functional.pad(z, (0, 0, pad_l, pad_l))
    u = None
    for g in range(gamma):
        tap = zp[:, :, g:g + stride * (t_out - 1) + 1:stride] @ rnd(wt[g])
        u = tap if u is None else u + tap
    u = u + bt.to(acc)
    if order == "post":
        u = u * s2.to(acc) + t2.to(acc)
    if shortcut == "id":
        u = u + xf
    elif shortcut == "proj":
        xs = xf[:, :, ::stride][:, :, :t_out]
        u = u + rnd(xs @ rnd(wr) + br.to(acc))
    if final_relu:
        u = torch.relu(u)
    return u.to(cd)


def plan_tiles(v: int, c_in: int, c_out: int, stride: int, gamma: int
               ) -> tuple[int, int, int]:
    """float32: ``(TT, VG, shared-memory bytes)`` of the scalar kernel.

    A CTA holds z for ``(TT-1)*stride + gamma`` frames of ``VG`` joints,
    plus one frame's ``h`` and one partition's ``y``, all in float32.  The
    largest frame tile that fits is taken, with all joints in one CTA
    where possible.
    """
    if not 1 <= c_out <= THREADS:
        raise ValueError(f"block_eval takes C_out <= {THREADS}, got {c_out}")
    if v > MAX_ROWS * (THREADS // c_out):
        raise ValueError(f"V={v} is too many joints for C_out={c_out}")
    for groups in range(1, v + 1):
        vg = -(-v // groups)
        for tt in TILE_FRAMES:
            tf = (tt - 1) * stride + gamma
            smem = 4 * (tf * vg * c_out + v * c_in + v * c_out)
            if smem <= SMEM_LIMIT:
                return tt, vg, smem
    raise ValueError(f"no tile of C_in={c_in}, C_out={c_out} fits in "
                     f"{SMEM_LIMIT} bytes of shared memory")


def spatial_frames(v: int) -> int:
    """F, the whole frames of a spatial tile: as many as fit in the 128
    rows, at most MAX_FRAMES (each frame's 32-row aggregation window then
    lies in the YR rows of a y buffer)."""
    return min(MAX_FRAMES, GEMM_ROWS // v)


def spatial_smem(c_in: int, c_out: int, k: int, kc: int, stages: int) -> int:
    """Shared bytes of the spatial kernel (be_mma::spatial_smem): the slack
    that aligns the ring to a swizzle atom, ``stages`` stages of ``kc``
    weight rows by one 64-column slab with a full and an empty mbarrier
    each, the two h buffers' full and empty mbarriers, b_k, s2 and t2 as
    float32 per column (C_out rounded up to a slab), s1 and t1 per input
    channel (C_in rounded up to 16), the K adjacencies padded to VP x VP at
    pitch ``VP + PAD``, two buffers of h of a tile's 128 rows at
    ``pitch(c_in)`` and a slab's y_k for each partition, YR rows at pitch
    ``SLAB + PAD`` (y_0's also take the slab's z on its way out)."""
    cp = -(-c_out // SLAB) * SLAB
    return (ATOM + stages * (kc * 128 + 16) + 32 + 4 * (k + 2) * cp
            + 8 * (-(-c_in // 16) * 16) + 2 * k * VP * (VP + PAD)
            + 2 * 2 * GEMM_ROWS * pitch(c_in) + 2 * k * YR * (SLAB + PAD))


def taps_smem(bn: int, kc: int, stages: int, staged: int, k_in: int) -> int:
    """Shared bytes of the taps kernel (be_mma::taps_smem): the slack, the
    ring (``stages`` stages of ``kc`` input channels by ``bn``) and its
    barriers, the 128 row offsets, the epilogue's three float32 constants
    a column (bias, s2, t2) and the ``staged`` input rows at
    ``pitch(k_in)``."""
    return (ATOM + stages * (bn * kc * 2 + 16) + 4 * GEMM_ROWS + 3 * bn * 4
            + staged * pitch(k_in) * 2)


def _ring(smem_of, what: str) -> tuple[int, int, int]:
    """``(kc, stages, shared bytes)``: the first ring of RINGS that fits."""
    for kc, stages in RINGS:
        smem = smem_of(kc, stages)
        if smem <= SMEM_LIMIT:
            return kc, stages, smem
    raise ValueError(f"no bf16 block_eval {what} tile fits in {SMEM_LIMIT} "
                     f"bytes of shared memory")


def plan_mma(v: int, t: int, c_in: int, c_out: int, k: int, stride: int,
             gamma: int) -> dict:
    """The bf16 launch.  The spatial kernel's ``frames`` a tile and ring
    (``s_kc`` rows, ``s_stages``, ``s_smem``), in order of preference: two
    CTAs an SM (HALF_SM each) with W resident (a stage for each of a
    tile's 64-row chunks, up to MAX_RESIDENT, loaded once a CTA), two with
    a ring of three stages or more, one with W resident, one with any
    ring.  The taps kernel's N tile ``bn`` and ring (``t_kc``,
    ``t_stages``, ``t_smem``: the first of RINGS that fits), its tiles
    staging ``staged_rows(128, T_out, stride, gamma)`` rows of z; the
    projection pass's ring (``p_kc``, ``p_stages``, ``p_smem``), one tap
    over x."""
    from stgcn_tpu_torch.kernels.temporal_block import staged_rows

    if not 1 <= c_out <= N_TILES[-1]:
        raise ValueError(f"block_eval takes C_out <= {N_TILES[-1]}, got "
                         f"{c_out}")
    if not 1 <= v <= VP:
        raise ValueError(f"the bf16 block_eval takes V <= {VP}, got {v}")
    t_out = t_out_of(t, stride, gamma)
    bn = next(n for n in N_TILES if c_out <= n)
    chunks = -(-c_out // SLAB) * k * -(-c_in // 64)   # a tile's, kc = 64
    resident = [(64, chunks)] if 2 <= chunks <= MAX_RESIDENT else []
    for limit, min_stages in ((HALF_SM, 3), (SMEM_LIMIT, 2)):
        rings = [ring for ring in RINGS if ring[1] >= min_stages]
        fits = [(kc, st) for kc, st in resident + rings
                if spatial_smem(c_in, c_out, k, kc, st) <= limit]
        if fits:
            s_kc, s_stages = fits[0]
            break
    else:
        raise ValueError(f"no bf16 block_eval spatial tile of C_in={c_in} "
                         f"fits in {SMEM_LIMIT} bytes of shared memory")
    s_smem = spatial_smem(c_in, c_out, k, s_kc, s_stages)
    taps_rows = staged_rows(GEMM_ROWS, t_out, stride, gamma)
    t_kc, t_stages, t_smem = _ring(
        lambda kc, st: taps_smem(bn, kc, st, taps_rows, c_out), "taps")
    proj_rows = staged_rows(GEMM_ROWS, t_out, stride, 1)
    p_kc, p_stages, p_smem = _ring(
        lambda kc, st: taps_smem(bn, kc, st, proj_rows, c_in), "projection")
    return dict(frames=spatial_frames(v), s_kc=s_kc, s_stages=s_stages,
                s_smem=s_smem, bn=bn, t_kc=t_kc, t_stages=t_stages,
                t_smem=t_smem, p_kc=p_kc, p_stages=p_stages, p_smem=p_smem)


# the order of plan_mma's values in block_eval_mma_launch's arguments
MMA_PLAN_KEYS = ("frames", "s_kc", "s_stages", "s_smem", "bn", "t_kc",
                 "t_stages", "t_smem", "p_kc", "p_stages", "p_smem")


def block_eval(x, s1, t1, w, b, a, wt, bt, s2, t2, wr=None, br=None, *,
               stride: int, order: str, shortcut: str, relu1: bool,
               final_relu: bool = True, lengths=None):
    """One whole eval block: ``(V, N, T, C_in) -> (V, N, T_out, C_out)``.

    Args:
      x: activations, float32 or bfloat16 on a CUDA device (any float dtype
        on the CPU).
      s1, t1: ``(C_in,)`` folded BN1 affine.
      w, b: spatial weights ``(C_in, K, C_out)`` and bias ``(K, C_out)``.
      a: ``(K, V, V)`` effective adjacency.
      wt, bt: temporal weights ``(gamma, C_out, C_out)`` and bias.
      s2, t2: ``(C_out,)`` folded BN2 affine.
      wr, br: ``(C_in, C_out)`` / ``(C_out,)`` projection shortcut.
      order: "pre" (residual: BN2+ReLU between the convs) or "post".
      shortcut: "none" | "id" | "proj".
      relu1: ReLU after the BN1 affine.
      lengths: optional ``(N,)`` valid frame counts; input frames at or past
        a sequence's length are zeroed before the affine, and output frames
        past its final length are unspecified.

    Weights are rounded to ``x``'s dtype, affines and biases used in
    float32.  On a CPU tensor this runs :func:`block_eval_reference`.
    """
    if x.device.type == "cpu":
        return block_eval_reference(
            x, s1, t1, w, b, a, wt, bt, s2, t2, wr, br, stride=stride,
            order=order, shortcut=shortcut, relu1=relu1,
            final_relu=final_relu, lengths=lengths)
    if x.device.type != "cuda":
        raise ValueError(f"block_eval runs on cuda or cpu, not {x.device}")
    return _launch(x, s1, t1, w, b, a, wt, bt, s2, t2, wr, br,
                   stride=stride, order=order, shortcut=shortcut,
                   relu1=relu1, final_relu=final_relu, lengths=lengths)


block_eval.launches = 0


def _launch(x, s1, t1, w, b, a, wt, bt, s2, t2, wr, br, *, stride, order,
            shortcut, relu1, final_relu, lengths):
    from stgcn_tpu_torch.kernels._build import load_library

    check_block_args(x, w, a, wt, wr, br, stride=stride, order=order,
                     shortcut=shortcut, lengths=lengths)
    if x.dtype not in KERNEL_DTYPES:
        raise TypeError(f"block_eval takes float32 or bfloat16, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("block_eval needs a contiguous x")
    dev, cd = x.device, x.dtype
    given = [s1, t1, w, b, a, wt, bt, s2, t2, wr, br, lengths]
    if any(p is not None and p.device != dev for p in given):
        raise ValueError(f"every block_eval argument must be on {dev}")
    v, n, t, c_in = x.shape
    gamma, _, c_out = wt.shape
    k = a.shape[0]
    t_out = t_out_of(t, stride, gamma)

    def f32(p):
        return p.to(torch.float32).contiguous()

    def act(p):
        return p.to(cd).contiguous()

    args = [x, f32(s1), f32(t1), act(w.permute(1, 0, 2)), act(b), act(a),
            act(wt), f32(bt), f32(s2), f32(t2),
            act(wr) if shortcut == "proj" else None,
            f32(br) if shortcut == "proj" else None,
            (lengths.to(torch.int32).contiguous()
             if lengths is not None else None)]
    ptrs = [p.data_ptr() if p is not None else None for p in args]
    flags = (int(order == "pre"), SHORTCUTS[shortcut], int(relu1),
             int(final_relu))
    out = torch.empty((v, n, t_out, c_out), dtype=cd, device=dev)
    lib = load_library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        if cd == torch.bfloat16:
            plan = plan_mma(v, t, c_in, c_out, k, stride, gamma)
            z = torch.empty((v, n, t, c_out), dtype=cd, device=dev)
            err = lib.block_eval_mma_launch(
                *ptrs, out.data_ptr(), z.data_ptr(), v, n, t, c_in, c_out,
                k, gamma, stride, *flags,
                *(plan[key] for key in MMA_PLAN_KEYS), stream)
        else:
            tt, vg, smem = plan_tiles(v, c_in, c_out, stride, gamma)
            err = lib.block_eval_launch(
                *ptrs, out.data_ptr(), v, n, t, c_in, c_out, k, gamma,
                stride, t_out, tt, vg, *flags, smem, stream)
    if err != 0:
        msg = lib.block_eval_error_string(err).decode()
        raise RuntimeError(f"block_eval launch failed: CUDA error {err} "
                           f"({msg})")
    block_eval.launches += 1
    return out
