"""The bf16 tensor-core temporal kernels' decomposition, proven on the CPU.

``csrc/temporal_block.cu`` computes the bf16 temporal op (``temporal_block``
and ``temporal_conv``) as implicit GEMMs whose index arithmetic a compiler
here cannot check: the forward and dx GEMMs flatten the rows as (line,
frame) and stage each CTA's input frames at per-row offsets; dx splits the
input frames by parity, each parity taking only its taps over contiguous g
rows; dWt splits its K = N*T_out*V rows across CTAs into partial slices
summed in order.  Here that decomposition is rendered in plain PyTorch,
with the kernels' tile geometry written out as the kernel computes it and
the planners' own tiles, splits and parity tap sets, and held in float64
against ``temporal_block_backward_reference`` (and the forward reference),
which ``tests/test_torch_train_kernels.py`` holds against the Pallas
kernels.  Tolerance: rtol 1e-10 of the largest magnitude (float64, sums
in other orders).

The planners are held to the card: every DEFAULT_PLAN shape and a 40
channel tail fit in shared memory, the staged-row bound covers every tile
the kernel can meet, and every ldmatrix row starts 16-byte aligned.
"""

import numpy as np
import pytest
import torch

from stgcn_tpu_torch.kernels import block_eval as be
from stgcn_tpu_torch.kernels import temporal_block as tb
from stgcn_tpu_torch.kernels import temporal_conv as tc
from stgcn_tpu_torch.kernels.block_eval import SMEM_LIMIT, t_out_of

V, N = 25, 2
CTAS = 2 * 132       # partial_ctas on an H100 SXM
F64 = torch.float64


def tile(r0, bm, total, per_line, walk, ntap, off0):
    """The kernel's geometry of the CTA whose rows start at ``r0``
    (temporal_block.cu tap_gemm_kernel): its row count, each row's staged
    row offset and the (line, frame) of each staged row."""
    rows = min(bm, total - r0)
    l0, ja0 = divmod(r0, per_line)
    first = min(per_line - ja0, rows)
    len_first = (first - 1) * walk + ntap
    len_full = (per_line - 1) * walk + ntap
    rest = rows - first
    staged = len_first + (rest // per_line) * len_full + (
        (rest % per_line - 1) * walk + ntap if rest % per_line else 0)
    rowoff = [r * walk if r < first else
              len_first + ((r - first) // per_line) * len_full
              + ((r - first) % per_line) * walk for r in range(rows)]
    frames = []
    for sr in range(staged):
        if sr < len_first:
            frames.append((l0, ja0 * walk + off0 + sr))
        else:
            q = sr - len_first
            frames.append((l0 + 1 + q // len_full, off0 + q % len_full))
    return rows, rowoff, frames


def gather(lines, frames):
    """Staged rows of ``lines`` (L, T, C): zero outside [0, T)."""
    t = lines.shape[1]
    rows = [lines[l, f] if 0 <= f < t else lines.new_zeros(lines.shape[2])
            for l, f in frames]
    return torch.stack(rows)


def implicit_gemm(lines, w, taps, shifts, per_line, walk, off0, bm):
    """out[(l, j)] = sum_i A[rowoff + shifts[i]] . w[taps[i]] over the
    kernel's CTAs of ``bm`` rows: ``(L, per_line, C_out)``."""
    total = lines.shape[0] * per_line
    out = lines.new_zeros(lines.shape[0] * per_line, w.shape[2])
    for r0 in range(0, total, bm):
        rows, rowoff, frames = tile(r0, bm, total, per_line, walk,
                                    len(taps), off0)
        a = gather(lines, frames)
        off = torch.tensor(rowoff)
        acc = sum(a[off + sh] @ w[tp] for tp, sh in zip(taps, shifts))
        out[r0:r0 + rows] = acc
    return out.view(lines.shape[0], per_line, w.shape[2])


def as_lines(x, vmajor):
    """(V, N, T, C) or (N, T, V, C) -> (L, T, C) in the kernel's line
    order (v*N + n, or n*V + v)."""
    if vmajor:
        return x.reshape(-1, x.shape[2], x.shape[3])
    return x.permute(0, 2, 1, 3).reshape(-1, x.shape[1], x.shape[3])


def from_lines(y, shape, vmajor):
    if vmajor:
        return y.reshape(shape)
    n, _, v, _ = shape
    return y.reshape(n, v, y.shape[1], y.shape[2]).permute(0, 2, 1, 3)


def render_forward(z, s2, t2, wt, bt, *, stride, relu2, aff, vmajor):
    gamma, _, c_out = wt.shape
    t = z.shape[2] if vmajor else z.shape[1]
    t_out = t_out_of(t, stride, gamma)
    zl = as_lines(z, vmajor)
    if aff:
        zl = zl * s2 + t2
        zl = torch.relu(zl) if relu2 else zl
    _, bm, _ = tb.gemm_tile(c_out)
    taps = list(range(gamma))
    u = implicit_gemm(zl, wt, taps, taps, t_out, stride, -(gamma // 2), bm)
    shape = ((z.shape[0], z.shape[1], t_out, c_out) if vmajor
             else (z.shape[0], t_out, z.shape[2], c_out))
    return from_lines(u + bt, shape, vmajor)


def render_backward(z, g, s2, t2, wt, *, stride, relu2, aff, vmajor):
    """dx by input-frame parity over the planner's row tiles, with the
    ds2/dt2 column sums taken per tile and summed in slice order; dWt and
    dbt as split-K over the planner's splits, summed in slice order."""
    gamma, c_in, c_out = wt.shape
    t = z.shape[2] if vmajor else z.shape[1]
    t_out = t_out_of(t, stride, gamma)
    zl, gl = as_lines(z, vmajor), as_lines(g, vmajor)
    lines = zl.shape[0]
    plan = tb.plan_mma_backward(lines, t, c_in, c_out, stride, gamma, aff,
                                CTAS)
    _, bm, _ = tb.gemm_tile(c_in)
    wtt = wt.transpose(1, 2)
    dz = zl.new_zeros(zl.shape)
    slices = []
    for parity in range(stride):
        per_line = -(-(t - parity) // stride)
        e0, taps, _ = tb.parity_taps(gamma, stride, parity)
        ntap = len(taps)
        for r0 in range(0, plan["tiles_x"] * bm, bm):
            if r0 >= lines * per_line:      # an empty slice
                slices.append(zl.new_zeros(2, c_in))
                continue
            rows, rowoff, frames = tile(r0, bm, lines * per_line, per_line,
                                        1, ntap, e0 - (ntap - 1))
            a = gather(gl, frames)
            off = torch.tensor(rowoff)
            acc = sum(a[off + (ntap - 1 - i)] @ wtt[tp]
                      for i, tp in enumerate(taps))
            gr = torch.arange(r0, r0 + rows)
            l, j = gr // per_line, gr % per_line
            f = j * stride + parity
            if aff:
                zv = zl[l, f]
                pre = zv * s2 + t2
                dp = torch.where(pre > 0, acc, 0.0) if relu2 else acc
                dz[l, f] = dp * s2
                slices.append(torch.stack([(dp * zv).sum(0), dp.sum(0)]))
            else:
                dz[l, f] = acc
                slices.append(zl.new_zeros(2, c_in))
    assert len(slices) == stride * plan["tiles_x"]
    ds = sum(slices[1:], slices[0]) if aff else None

    # dWt: zh at frame t*s - pad + tap of each (line, t) row, split-K
    zh = zl * s2 + t2 if aff else zl
    zh = torch.relu(zh) if aff and relu2 else zh
    rows = lines * t_out
    splits, split_rows = tb.dw_splits(rows, gamma, c_in, c_out, CTAS)
    assert (splits, split_rows) == (plan["splits"], plan["split_rows"])
    assert (splits - 1) * split_rows < rows <= splits * split_rows
    g_rows = gl.reshape(rows, c_out)
    r = torch.arange(rows)
    l, tt = r // t_out, r % t_out
    parts = []
    for k in range(splits):
        sel = slice(k * split_rows, min(rows, (k + 1) * split_rows))
        dwt = []
        for tap in range(gamma):
            f = tt[sel] * stride - gamma // 2 + tap
            ok = (f >= 0) & (f < t)
            a = torch.where(ok[:, None], zh[l[sel], f.clamp(0, t - 1)], 0.0)
            dwt.append(a.t() @ g_rows[sel])
        parts.append((torch.stack(dwt), g_rows[sel].sum(0)))
    dwt = sum(p[0] for p in parts[1:]) + parts[0][0]
    dbt = sum(p[1] for p in parts[1:]) + parts[0][1]
    return from_lines(dz, z.shape, vmajor), ds, dwt, dbt


def inputs(rng, t, c_in, c_out, gamma, stride, vmajor=True):
    t_out = t_out_of(t, stride, gamma)

    def f64(*shape, scale=1.0, loc=0.0):
        return torch.from_numpy(rng.normal(loc, scale, shape)).to(F64)

    zshape = (V, N, t, c_in) if vmajor else (N, t, V, c_in)
    gshape = (V, N, t_out, c_out) if vmajor else (N, t_out, V, c_out)
    return dict(z=f64(*zshape), g=f64(*gshape),
                s2=f64(c_in, scale=0.3, loc=1.0), t2=f64(c_in, scale=0.2),
                wt=f64(gamma, c_in, c_out, scale=(gamma * c_in) ** -0.5),
                bt=f64(c_out, scale=0.1))


def close(got, want, what):
    scale = max(float(want.abs().max()), 1e-30)
    err = float((got - want).abs().max())
    assert err <= 1e-10 * scale, f"{what}: error {err}, largest {scale}"


# (T, C): odd frame counts and channel counts that are not multiples of 16
SIZES = [(37, 40), (19, 24)]


class TestDecomposition:
    @pytest.mark.parametrize("t,c", SIZES)
    @pytest.mark.parametrize("gamma", [9, 3])
    @pytest.mark.parametrize("stride", [1, 2])
    @pytest.mark.parametrize("relu2", [True, False])
    def test_temporal_block(self, rng, t, c, gamma, stride, relu2):
        d = inputs(rng, t, c, c, gamma, stride)
        flags = dict(stride=stride, relu2=relu2)
        u = render_forward(d["z"], d["s2"], d["t2"], d["wt"], d["bt"],
                           aff=True, vmajor=True, **flags)
        close(u, tb.temporal_block_forward_reference(
            d["z"], d["s2"], d["t2"], d["wt"], d["bt"], **flags), "u")
        dz, ds, dwt, dbt = render_backward(
            d["z"], d["g"], d["s2"], d["t2"], d["wt"], aff=True,
            vmajor=True, **flags)
        want = tb.temporal_block_backward_reference(
            d["z"], d["g"], d["s2"], d["t2"], d["wt"], d["bt"], **flags)
        for got, ref, name in zip((dz, ds[0], ds[1], dwt, dbt), want,
                                  ("dz", "ds2", "dt2", "dwt", "dbt")):
            close(got, ref, name)

    @pytest.mark.parametrize("t,c", SIZES)
    @pytest.mark.parametrize("stride", [1, 2])
    @pytest.mark.parametrize("layout", ["vntc", "ntvc"])
    def test_temporal_conv(self, rng, t, c, stride, layout):
        """Without the affine, both layouts, C_in != C_out."""
        vmajor = layout == "vntc"
        d = inputs(rng, t, c, c - 8, 9, stride, vmajor)
        if vmajor:      # the op's V-major input is (R, T, C)
            x = d["z"].reshape(V * N, t, c)
            g = d["g"].reshape(V * N, -1, c - 8)
        else:
            x, g = d["z"], d["g"]
        u = render_forward(d["z"], None, None, d["wt"], d["bt"], stride=stride,
                           relu2=False, aff=False, vmajor=vmajor)
        want_u = tc.temporal_conv_forward_reference(x, d["wt"], d["bt"],
                                                    stride=stride,
                                                    vmajor=vmajor)
        close(u.reshape(want_u.shape), want_u, "u")
        dx, _, dw, db = render_backward(d["z"], d["g"], None, None, d["wt"],
                                        stride=stride, relu2=False, aff=False,
                                        vmajor=vmajor)
        want = tc.temporal_conv_backward_reference(x, g, d["wt"], d["bt"],
                                                   stride=stride,
                                                   vmajor=vmajor)
        close(dx.reshape(want[0].shape), want[0], "dx")
        close(dw, want[1], "dw")
        close(db, want[2], "db")

    @pytest.mark.parametrize("stride", [1, 2])
    @pytest.mark.parametrize("gamma", [9, 3, 1])
    def test_parity_taps_cover_every_tap_once(self, gamma, stride):
        """Each (output row, tap) pair lands on exactly one input frame's
        parity list, at the g row the parity's shift gives."""
        pad = (gamma - 1) // 2
        seen = set()
        for parity in range(stride):
            e0, taps, shifts = tb.parity_taps(gamma, stride, parity)
            assert shifts == [e0 - i for i in range(len(taps))]
            for j in range(6):
                f = j * stride + parity
                for tap, sh in zip(taps, shifts):
                    t = j + sh
                    assert t * stride - pad + tap == f
                    seen.add(tap)
        assert seen == set(range(gamma))
        if stride == 2 and gamma == 9:
            assert tb.parity_taps(9, 2, 0)[1] == [0, 2, 4, 6, 8]
            assert tb.parity_taps(9, 2, 1)[1] == [1, 3, 5, 7]


# DEFAULT_PLAN's blocks at B=64, T=304 as the temporal ops see them:
# (C, stride, T_in), and the odd-width case of chip_smoke.py
MAIN = [(64, 1, 304), (128, 2, 304), (128, 1, 152), (256, 2, 152),
        (256, 1, 76), (40, 1, 37), (40, 2, 37)]
BLOCKS = [(2, 64, 1), (64, 64, 1), (64, 128, 2), (128, 128, 1),
          (128, 256, 2), (256, 256, 1), (40, 40, 1), (40, 40, 2)]


class TestPlans:
    @pytest.mark.parametrize("c,stride,t", MAIN)
    @pytest.mark.parametrize("lines", [V * 64, V])
    def test_temporal_plans_fit(self, c, stride, t, lines):
        wn, smem = tb.plan_mma_forward(t, c, c, stride, 9)
        assert smem <= SMEM_LIMIT and wn in (2, 4)
        plan = tb.plan_mma_backward(lines, t, c, c, stride, 9, True, CTAS)
        assert plan["dx_smem"] <= SMEM_LIMIT
        assert plan["dw_smem"] <= SMEM_LIMIT
        _, bm, _ = tb.gemm_tile(c)
        assert plan["tiles_x"] * bm >= lines * -(-t // stride)
        t_out = t_out_of(t, stride, 9)
        assert plan["splits"] * plan["split_rows"] >= lines * t_out
        assert plan["split_rows"] % tb.KR == 0

    @pytest.mark.parametrize("c_in,c_out,stride", BLOCKS)
    def test_block_eval_plan_fits(self, c_in, c_out, stride):
        tt, vg, smem = be.plan_tiles(V, c_in, c_out, stride, 9, 2)
        assert smem <= SMEM_LIMIT and vg == V and tt >= 2

    @pytest.mark.parametrize("c", [2, 24, 40, 64, 128, 256])
    def test_ldmatrix_rows_are_16_byte_aligned(self, c):
        """Every shared row a kernel reads with ldmatrix: activations at
        ``pitch`` elements, weight-ring and dWt rows at ``BN + PAD`` and
        ``BM + PAD``; each region of the carve-up starts aligned."""
        assert (2 * be.pitch(c)) % 16 == 0
        assert be.pitch(c) >= c and be.pitch(c) % 16 == be.PAD
        wn, bm, bn = tb.gemm_tile(c)
        _, dw_bm, dw_bn = tb.dw_tile(c)
        for width in (bm, bn, dw_bm, dw_bn, -(-c // 64) * 64):
            assert (2 * (width + be.PAD)) % 16 == 0
        assert (2 * 2 * tb.KC * (bn + be.PAD)) % 16 == 0    # the ring
        assert (4 * bm) % 16 == 0                          # row offsets
        assert (4 * 2 * (8 // wn) * bn) % 16 == 0          # column sums
        # 16 bytes modulo 128 between rows: ldmatrix's eight rows of one
        # phase fall in eight bank groups
        if c % 64 == 0:
            assert (2 * be.pitch(c)) % 128 == 16

    @pytest.mark.parametrize("per_line", [1, 2, 7, 19, 37, 64, 76, 152])
    @pytest.mark.parametrize("walk,ntap", [(1, 9), (2, 9), (1, 5), (1, 4),
                                           (1, 3)])
    def test_staged_rows_bound_every_tile(self, per_line, walk, ntap):
        for bm in (64, 128):
            bound = tb.staged_rows(bm, per_line, walk, ntap)
            lines = bm + 3
            total = lines * per_line
            worst = max(len(tile(r0, bm, total, per_line, walk, ntap, 0)[2])
                        for r0 in range(0, total, bm))
            assert worst <= bound
