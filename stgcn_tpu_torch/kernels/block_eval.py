"""Whole eval block as one kernel: wrapper, plain version and launch count.

:func:`block_eval` computes one ST-GCN eval block on V-major
``(V, N, T, C_in)`` activations, with its BatchNorms folded into affines.
It is the port of ``fused_block_vm`` (``stgcn_tpu/kernels/block_fused.py``)
and ``fused_block_packed_eval`` (``stgcn_tpu/kernels/block_packed.py``),
without their TPU-layout arguments (``t_valid``, ``out_tp``, the packed
layout).  For a CUDA tensor it launches the hand-written kernel in
``csrc/block_eval.cu``, bfloat16 on the tensor cores and float32 on the
scalar kernel; for a CPU tensor it runs the plain PyTorch version
:func:`block_eval_reference`, which rounds at the same points.

``block_eval.launches`` counts the kernel launches, and nothing else.
"""

from __future__ import annotations

import torch

SMEM_LIMIT = 232_448        # bytes of shared memory a CTA may use (sm_90)
THREADS = 256               # threads per CTA, as in csrc/block_eval.cu
MAX_ROWS = 32               # largest per-thread row count the kernel has
TILE_FRAMES = (16, 8, 4, 2, 1)
SHORTCUTS = {"none": 0, "id": 1, "proj": 2}
KERNEL_DTYPES = (torch.float32, torch.bfloat16)
PAD = 8                     # bf16 elements of shared-row padding (tap_mma.cuh)
KC = 32                     # weight rows per ring stage (block_eval.cu)


def pitch(c: int) -> int:
    """Elements of a shared bf16 row of ``c`` channels: ``c`` rounded up to
    16 (a zero tail) plus ``PAD``, so ldmatrix rows are 16-byte aligned and
    free of bank conflicts."""
    return -(-c // 16) * 16 + PAD


def t_out_of(t: int, stride: int, gamma: int) -> int:
    """Frames after a same-padded temporal conv of width gamma."""
    pad_l = (gamma - 1) // 2
    return (t + 2 * pad_l - gamma) // stride + 1


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


def plan_tiles(v: int, c_in: int, c_out: int, stride: int, gamma: int,
               itemsize: int) -> tuple[int, int, int]:
    """``(TT, VG, shared-memory bytes)`` for one block's launch.

    A CTA holds z for ``(TT-1)*stride + gamma`` frames of ``VG`` joints,
    plus one frame's ``h`` and one partition's ``y``.  float32 (itemsize 4,
    the scalar kernel): all in float32, ``V*C_in`` and ``V*C_out``.  bf16
    (itemsize 2, the tensor-core kernel): z and h on rows of
    :func:`pitch` elements, h on 32 rows, y on ``V*C_out``, and the
    two-stage weight ring of ``KC`` rows of ``round64(C_out) + PAD``.  The
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
            if itemsize == 2:
                ring = 2 * KC * (-(-c_out // 64) * 64 + PAD)
                smem = 2 * (ring + tf * vg * pitch(c_out) + 32 * pitch(c_in)
                            + v * c_out)
            else:
                smem = itemsize * (tf * vg * c_out + v * c_in + v * c_out)
            if smem <= SMEM_LIMIT:
                return tt, vg, smem
    raise ValueError(f"no tile of C_in={c_in}, C_out={c_out} fits in "
                     f"{SMEM_LIMIT} bytes of shared memory")


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
    tt, vg, smem = plan_tiles(v, c_in, c_out, stride, gamma, x.element_size())

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
    out = torch.empty((v, n, t_out, c_out), dtype=cd, device=dev)
    lib = load_library()
    with torch.cuda.device(dev):
        err = lib.block_eval_launch(
            *[p.data_ptr() if p is not None else None for p in args],
            out.data_ptr(), v, n, t, c_in, c_out, k, gamma, stride, t_out,
            tt, vg, int(order == "pre"), SHORTCUTS[shortcut], int(relu1),
            int(final_relu), int(cd == torch.bfloat16), smem,
            torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        msg = lib.block_eval_error_string(err).decode()
        raise RuntimeError(f"block_eval launch failed: CUDA error {err} "
                           f"({msg})")
    block_eval.launches += 1
    return out
