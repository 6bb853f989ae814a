"""The bf16 warpgroup temporal kernels' decomposition, proven on the CPU.

``csrc/temporal_block.cu`` computes the bf16 temporal op (``temporal_block``
and ``temporal_conv``) as implicit GEMMs whose index arithmetic a compiler
here cannot check: the forward and dx GEMMs flatten the rows as (line,
frame) into tiles of 128 rows (two warpgroups of 64) and stage each tile's
input frames at per-row offsets, the halo included; dx splits the input
frames by parity, each parity taking only its taps over contiguous g rows;
dWt stages each chunk of 128 g rows with the zh frames its taps read once
and computes every tap of its tap group from that one staging, over the
splits of its K = N*T_out*V rows, whose partial slices are summed in
order.  Here that decomposition is rendered in plain PyTorch, with the
kernels' tile geometry written out as the kernel computes it and the
planners' own tiles, splits and parity tap sets, and held in float64
against ``temporal_block_backward_reference`` (and the forward reference),
which ``tests/test_torch_train_kernels.py`` holds against the Pallas
kernels.  Tolerance: rtol 1e-10 of the largest magnitude (float64, sums
in other orders).

The planners are held to the card: every DEFAULT_PLAN shape and the odd
widths (C=40, and C=36, whose weights TMA cannot read) fit in 232,448
bytes of shared memory with a weight ring of at least three stages, the
staged-row bound covers every tile the kernels can meet, every ldmatrix
row starts 16-byte aligned, every swizzled stage starts on a 1024-byte
atom, and TMA's 16-byte strides hold exactly where C % 8 == 0.
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


def tile(r0, bm, total, per_line, walk, ntap, off0, pad8=False):
    """The kernel's geometry of the tile whose rows start at ``r0``
    (temporal_block.cu Tile): its row count, each row's staged row offset
    and the (line, frame) of each staged row; with ``pad8`` (the dWt
    kernel's staging) each line's frames start on a multiple of 8 rows and
    the rows between hold no frame (frame None)."""
    def padded(n):
        return -(-n // 8) * 8 if pad8 else n

    rows = min(bm, total - r0)
    l0, ja0 = divmod(r0, per_line)
    first = min(per_line - ja0, rows)
    len_first = (first - 1) * walk + ntap
    len_full = (per_line - 1) * walk + ntap
    lp_first, lp_full = padded(len_first), padded(len_full)
    rest = rows - first
    staged = lp_first + (rest // per_line) * lp_full + padded(
        (rest % per_line - 1) * walk + ntap if rest % per_line else 0)
    rowoff = [r * walk if r < first else
              lp_first + ((r - first) // per_line) * lp_full
              + ((r - first) % per_line) * walk for r in range(rows)]
    frames = []
    for sr in range(staged):
        if sr < lp_first:
            frames.append((l0, ja0 * walk + off0 + sr
                           if sr < len_first else None))
        else:
            q, pos = divmod(sr - lp_first, lp_full)
            frames.append((l0 + 1 + q, off0 + pos if pos < len_full
                           else None))
    return rows, rowoff, frames


def gather(lines, frames):
    """Staged rows of ``lines`` (L, T, C): zero outside [0, T) and on
    padding rows."""
    t = lines.shape[1]
    rows = [lines[l, f] if f is not None and 0 <= f < t
            else lines.new_zeros(lines.shape[2]) for l, f in frames]
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
    taps = list(range(gamma))
    u = implicit_gemm(zl, wt, taps, taps, t_out, stride, -(gamma // 2),
                      tb.GEMM_ROWS)
    shape = ((z.shape[0], z.shape[1], t_out, c_out) if vmajor
             else (z.shape[0], t_out, z.shape[2], c_out))
    return from_lines(u + bt, shape, vmajor)


def render_backward(z, g, s2, t2, wt, *, stride, relu2, aff, vmajor):
    """dx by input-frame parity over the planner's row tiles, with the
    ds2/dt2 column sums taken per tile and summed in slice order; dWt and
    dbt over the planner's splits, each split's chunks of DW_KR rows staged
    once (g and the zh frames of a tap group's taps) and every tap of the
    group computed from that staging, the slices summed in order."""
    gamma, c_in, c_out = wt.shape
    t = z.shape[2] if vmajor else z.shape[1]
    t_out = t_out_of(t, stride, gamma)
    zl, gl = as_lines(z, vmajor), as_lines(g, vmajor)
    lines = zl.shape[0]
    plan = tb.plan_mma_backward(lines, t, c_in, c_out, stride, gamma, aff,
                                CTAS)
    bm = tb.GEMM_ROWS
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

    # dWt: each chunk of DW_KR g rows stages, per tap group, the zh frames
    # of its rows' taps (walk s, the group's taps as the halo, each line's
    # frames from a multiple of 8 rows) once; every tap of the group reads
    # them at the row's offset plus its place
    zh = zl * s2 + t2 if aff else zl
    zh = torch.relu(zh) if aff and relu2 else zh
    rows = lines * t_out
    splits, split_rows = tb.dwt_splits(rows, gamma, c_in, c_out, CTAS)
    assert (splits, split_rows) == (plan["splits"], plan["split_rows"])
    assert (splits - 1) * split_rows < rows <= splits * split_rows
    g_rows = gl.reshape(rows, c_out)
    pad = gamma // 2
    parts = []
    for k in range(splits):
        end = min(rows, (k + 1) * split_rows)
        dwt = zl.new_zeros(gamma, c_in, c_out)
        for kb in range(k * split_rows, end, tb.DW_KR):
            g_chunk = zl.new_zeros(tb.DW_KR, c_out)
            g_chunk[:min(tb.DW_KR, end - kb)] = g_rows[kb:end][:tb.DW_KR]
            for tap_lo in range(0, gamma, tb.DW_TAPS):
                ntap = min(tb.DW_TAPS, gamma - tap_lo)
                n, rowoff, frames = tile(kb, tb.DW_KR, end, t_out, stride,
                                         ntap, tap_lo - pad, pad8=True)
                assert len(frames) <= tb.dwt_rows(t_out, stride, gamma)
                a = gather(zh, frames)
                off = torch.tensor(rowoff + [0] * (tb.DW_KR - n))
                for i in range(ntap):
                    dwt[tap_lo + i] += a[off + i].t() @ g_chunk
        parts.append((dwt, g_rows[k * split_rows:end].sum(0)))
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


# (T, C): odd frame counts and channel counts that are not multiples of 16,
# and one (C=36) that is not a multiple of 8
SIZES = [(37, 40), (19, 24), (29, 36)]


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
# (C, stride, T_in), and the odd widths of chip_smoke.py
MAIN = [(64, 1, 304), (128, 2, 304), (128, 1, 152), (256, 2, 152),
        (256, 1, 76), (40, 1, 37), (40, 2, 37), (36, 1, 37), (36, 2, 37)]
BLOCKS = [(2, 64, 1), (64, 64, 1), (64, 128, 2), (128, 128, 1),
          (128, 256, 2), (256, 256, 1), (40, 40, 1), (40, 40, 2)]


class TestPlans:
    @pytest.mark.parametrize("c,stride,t", MAIN)
    @pytest.mark.parametrize("lines", [V * 64, V])
    def test_temporal_plans_fit(self, c, stride, t, lines):
        """Every tile fits with a ring of at least three stages, the N tile
        covers C_out, the dx tiles cover every row and the dWt splits every
        g row, in whole chunks."""
        bn, kc, stages, smem = tb.plan_mma_forward(t, c, c, stride, 9)
        assert smem <= SMEM_LIMIT and bn in tb.N_TILES and bn >= c
        assert (kc, stages) in tb.RINGS and stages >= 3
        plan = tb.plan_mma_backward(lines, t, c, c, stride, 9, True, CTAS)
        assert plan["dx_smem"] <= SMEM_LIMIT and plan["bn_dx"] >= c
        assert (plan["kc_dx"], plan["stages_dx"]) in tb.RINGS
        assert plan["stages_dx"] >= 3
        assert plan["dw_smem"] <= SMEM_LIMIT and plan["dw_stages"] >= 3
        assert plan["tiles_x"] * tb.GEMM_ROWS >= lines * -(-t // stride)
        t_out = t_out_of(t, stride, 9)
        assert plan["splits"] * plan["split_rows"] >= lines * t_out
        assert plan["split_rows"] % tb.DW_KR == 0

    @pytest.mark.parametrize("c_in,c_out,stride", BLOCKS)
    def test_block_eval_plan_fits(self, c_in, c_out, stride):
        """block_eval's bf16 kernels at the frames each block takes on the
        main path (T=37 for the odd widths): the spatial kernel, the taps
        and the projection pass each fit, the taps and the projection with
        a ring of three stages or more and the spatial kernel with its W
        resident or such a ring, the taps' N tile covers C_out and a
        spatial tile holds whole frames."""
        t = {64: 304, 128: 304 if stride == 2 else 152,
             256: 152 if stride == 2 else 76}.get(c_out, 37)
        plan = be.plan_mma(V, t, c_in, c_out, 2, stride, 9)
        for key in ("s", "t", "p"):
            assert plan[f"{key}_smem"] <= SMEM_LIMIT
        chunks = -(-c_out // 64) * 2 * -(-c_in // 64)
        for key in ("t", "p"):
            assert plan[f"{key}_stages"] >= 3
        assert plan["s_stages"] >= 3 or plan["s_stages"] == chunks
        assert plan["bn"] in tb.N_TILES and plan["bn"] >= c_out
        assert plan["frames"] * V <= tb.GEMM_ROWS

    @pytest.mark.parametrize("c", [2, 24, 36, 40, 64, 128, 256])
    def test_ldmatrix_rows_are_16_byte_aligned(self, c):
        """Every shared row a kernel reads with ldmatrix: the staged input
        frames at ``pitch`` elements, 16 bytes apart modulo 128 where a row
        holds a multiple of 64 channels (ldmatrix's eight rows of one phase
        in eight bank groups), and dWt's zh rows, 128 bytes of 64 channels
        whose 16-byte chunks the swizzle spreads over eight bank groups
        for any eight consecutive rows; the regions before the staged rows
        keep them aligned."""
        assert (2 * be.pitch(c)) % 16 == 0
        assert be.pitch(c) >= c and be.pitch(c) % 16 == be.PAD
        if c % 64 == 0:
            assert (2 * be.pitch(c)) % 128 == 16
        assert 2 * tb.DW_BM == 128
        for chunk in range(8):
            for r0 in range(8):
                assert len({chunk ^ ((r0 + r) & 7) for r in range(8)}) == 8
        bn = tb.gemm_tile(c)
        for kc, stages in tb.RINGS:
            for dx_aff in (False, True):
                # everything before the staged rows: slack, ring, barriers,
                # row offsets, column sums
                head = tb.gemm_smem(bn, kc, stages, 0, c, dx_aff) - tb.ATOM
                assert head % 16 == 0
        # dWt: g, then the row offsets, then the zh rows of a stage
        assert (tb.DW_KR * 128 + 4 * tb.DW_KR) % 16 == 0

    @pytest.mark.parametrize("c", [36, 40, 64, 128, 256])
    def test_swizzled_stages_start_on_an_atom(self, c):
        """Every 128B-swizzled tile starts 1024-byte aligned: the weight
        stages (64-column tiles of 64 K rows) and the dWt stages (g first,
        then whole atoms); one k16 step is two atoms."""
        bn = tb.gemm_tile(c)
        assert bn % 64 == 0
        for kc in (tb.KC, tb.KC_DEEP):
            assert kc % 16 == 0 and (kc * 128) % tb.ATOM == 0  # a tile
            assert (bn * kc * 2) % tb.ATOM == 0                # a stage
        assert (16 * 128) % tb.ATOM == 0             # a k16 step of B
        for t_out, stride in ((304, 1), (152, 2), (76, 1), (37, 1), (19, 2)):
            zrows = tb.dwt_rows(t_out, stride, 9)
            assert tb.DW_GBYTES % tb.ATOM == 0                  # zh's start
            assert tb.dw_zh_bytes(zrows) % tb.ATOM == 0
            assert tb.dw_stage_bytes(zrows) % tb.ATOM == 0
            assert tb.dwt_smem(zrows, 3) <= SMEM_LIMIT
            assert tb.dw_stage_bytes(zrows) >= (tb.DW_GBYTES + zrows * 128
                                                + 4 * tb.DW_KR)

    @pytest.mark.parametrize("c", [36, 40, 64, 128, 256])
    def test_tma_reads_weights_with_16_byte_strides(self, c):
        """The weights' TMA map (wg::encode_weight_map) steps 2N bytes a K
        row and 2KN a tap of bf16 (gamma, K, N), dWt's maps 2C a row and
        2TC a frame: all multiples of 16, as TMA needs, exactly where the
        row's width is a multiple of 8 (wg::tma_can_read), so C=36 takes
        the plain-load producer and the cp.async staging."""
        for k, n in ((c, c), (c, c - 4)):
            strides = (2 * n, 2 * k * n, 2 * n * 19)
            assert all(s % 16 == 0 for s in strides) == (n % 8 == 0)

    @pytest.mark.parametrize("gamma", [1, 3, 9, 11, 19])
    def test_dwt_tap_groups_cover_every_tap_once(self, gamma):
        """dWt's CTAs take DW_TAPS taps a group, each of its three consumer
        warpgroups the taps cw, cw + 3, cw + 6 of it: every tap once."""
        seen = []
        for tap_lo in range(0, gamma, tb.DW_TAPS):
            ntap = min(tb.DW_TAPS, gamma - tap_lo)
            for cw in range(3):
                seen += [tap_lo + cw + 3 * i for i in range(3)
                         if cw + 3 * i < ntap]
        assert sorted(seen) == list(range(gamma))

    @pytest.mark.parametrize("per_line", [1, 2, 7, 19, 37, 64, 76, 152])
    @pytest.mark.parametrize("walk,ntap", [(1, 9), (2, 9), (1, 5), (1, 4),
                                           (1, 3), (2, 1)])
    def test_staged_rows_bound_every_tile(self, per_line, walk, ntap):
        """Over the GEMM tiles of 128 rows and the dWt chunks of 128 rows
        (which may end early, at a split's end; their lines' frames padded
        to 8 rows, a multiple of 8 in all)."""
        lines = tb.GEMM_ROWS + 3
        total = lines * per_line
        tiles = {pad8: [tile(r0, tb.GEMM_ROWS, end, per_line, walk, ntap, 0,
                             pad8)[2]
                        for end in (total, total - 5)
                        for r0 in range(0, end, tb.GEMM_ROWS)]
                 for pad8 in (False, True)}
        assert tb.GEMM_ROWS == tb.DW_KR
        assert (max(map(len, tiles[False]))
                <= tb.staged_rows(tb.GEMM_ROWS, per_line, walk, ntap))
        if walk * (per_line - 1) + ntap >= ntap:   # dwt_rows's bound
            segments = min(tb.DW_KR, -(-(tb.DW_KR - 1) // per_line) + 1)
            bound = (tb.staged_rows(tb.DW_KR, per_line, walk, ntap)
                     + 7 * segments)
            assert max(map(len, tiles[True])) <= bound
            assert all(len(f) % 8 == 0 for f in tiles[True])
