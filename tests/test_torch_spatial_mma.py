"""The bf16 warpgroup spatial kernels' decomposition, proven on the CPU.

``csrc/spatial_block.cu`` computes the bf16 spatial ops (``spatial_block``,
``spatial_block_save`` and ``spatial_conv``) as tiles whose index arithmetic
a compiler here cannot check:

* the forward takes F whole frames a tile (F V of two warpgroups' 128
  rows); per slab of 64 output channels and per partition, y_k =
  round(h . W_k + b_k) accumulates W_k's chunks of kc C_in rows in order
  (``y_slab``, which the backward's recompute shares), and z = sum_k A_k .
  y_k per frame with the joints padded to 32 (A's padding columns zero,
  the rows past the tile zero or b);
* the backward's t kernel loops persistent CTAs over those tiles and, per
  slab: t_k = round(A_k^T . g) per frame, out to a scratch t (K, M*V,
  round8(C_out)) in x's row order with its padding columns zero; dA_k =
  sum g . y_k^T over 16 x 16 sub-tiles split by k16-step parity, y_k from
  ``y_slab`` (or the saved y), kept per CTA and summed in CTA order (two
  CTAs an SM whatever the variant, so the save op's dA is the
  recompute's);
* the dx kernel is one GEMM over 128-row tiles of x's rows with depth
  K * C_out, in chunks of one partition's 64 channels, dh = sum t_k .
  W_k^T; its epilogue's column sums of dpre * x and dpre go to one slice a
  tile, summed in tile order, and it writes h (or x) at a padded pitch
  where the dW kernel cannot read x itself;
* the dW kernel splits the rows into the planner's slices of whole
  128-row chunks, dW_k = h^T . t_k per 64 x 64 channel tile and db_k = sum
  t_k per slice, summed in slice order.

Here that decomposition is rendered in plain PyTorch with the kernels'
tile geometry and the planners' own choices, and held in float64 against
the plain versions (``spatial_block_*_reference``, ``spatial_conv_*``),
which ``tests/test_torch_train_kernels.py``,
``tests/test_torch_save_kernel.py`` and ``tests/test_torch_conv_kernels.py``
hold against the Pallas kernels.  Tolerance: rtol 1e-10 of the largest
magnitude (float64, sums in other orders).  The rounding points (y_k, t_k)
are rendered as the kernels place them: a rounding to the input's dtype,
which the float64 check passes through unchanged.

The planners are held to the card: every DEFAULT_PLAN shape, the 40 and
36 channel widths and three partitions fit in 232,448 bytes of shared
memory; rings of their stages with a full and an empty mbarrier each;
every swizzled stage and box on a 1024-byte atom; 16-byte TMA strides
(the weights and scratch tensors padded to them); and only activation
rows without 16-byte strides go through plain loads.
"""

import pytest
import torch

from stgcn_tpu_torch.kernels import block_eval as be
from stgcn_tpu_torch.kernels import spatial_block as sb
from stgcn_tpu_torch.kernels import spatial_conv as sc
from stgcn_tpu_torch.kernels.block_eval import SMEM_LIMIT

V = 25
SMS = 132            # streaming multiprocessors of an H100 SXM
F64 = torch.float64
BM, SN, VP, YR = sb.MMA_ROWS, sb.SLAB, sb.VP, sb.YR


def rnd(t, dtype):
    """A kernel rounding point: to the activations' dtype and back."""
    return t.to(dtype).to(t.dtype)


def as_vm(x, vmajor):
    """(V, M, C) of either layout ((V, N, T, C) or (V, M, C) when vmajor,
    (N, T, V, C) otherwise)."""
    if vmajor:
        return x.reshape(x.shape[0], -1, x.shape[-1])
    n, t, v, c = x.shape
    return x.permute(2, 0, 1, 3).reshape(v, n * t, c)


def rows_of(vm, vmajor):
    """(V*M, C): the rows of x, dx and the scratch tensors in x's order,
    (v, m) at v*M + m V-major and at m*V + v frame-major."""
    v, m, c = vm.shape
    return (vm.reshape(v * m, c) if vmajor
            else vm.permute(1, 0, 2).reshape(m * v, c))


def from_rows(rows, v, m, vmajor):
    c = rows.shape[-1]
    return (rows.reshape(v, m, c) if vmajor
            else rows.reshape(m, v, c).permute(1, 0, 2))


def h_of(x, s1, t1, relu1, aff):
    if not aff:
        return x
    pre = x * s1 + t1
    return rnd(torch.relu(pre) if relu1 else pre, x.dtype)


def tile_rows(vm, m0, fc, nrows):
    """The tile's staged rows f*V + v of frames m0 .. m0+fc-1, zero
    below ``nrows``."""
    v, _, c = vm.shape
    rows = vm.new_zeros(nrows, c)
    rows[:fc * v] = vm[:, m0:m0 + fc].permute(1, 0, 2).reshape(fc * v, c)
    return rows


def slab_of(vm, m0, fc, n0):
    """stage_slab: columns n0 .. n0 + 63 of the tile's rows, YR rows, zero
    past the tile's frames and past C."""
    rows = tile_rows(vm, m0, fc, YR)[:, n0:n0 + SN]
    return torch.nn.functional.pad(rows, (0, SN - rows.shape[1]))


def padded(a):
    out = a.new_zeros(VP, VP)
    out[:a.shape[0], :a.shape[1]] = a
    return out


def y_slab(hs, w, b, k, n0, kc):
    """y_slab: round(h . W_k[:, n0 .. n0 + 63] + b_k) of the tile's BM rows
    as the sum of W_k's chunks of kc C_in rows in order (C_in padded to
    16, the padding zero), zero past C_out; rows past BM are zero.  The
    forward and the t kernel both call it."""
    c_in, _, c_out = w.shape
    cols = min(SN, c_out - n0)
    acc = hs.new_zeros(BM, cols)
    for c0 in range(0, -(-c_in // 16) * 16, kc):
        acc += hs[:, c0:c0 + kc] @ w[c0:c0 + kc, k, n0:n0 + cols]
    ys = hs.new_zeros(YR, SN)
    ys[:BM, :cols] = rnd(acc + b[k, n0:n0 + cols], hs.dtype)
    return ys


def render_forward(x, s1, t1, w, b, a, *, relu1, aff, vmajor, save=False):
    """z (and with ``save`` y) by the forward kernel's tiles, in
    ``(V, M, C_out)`` (and ``(K, V, M, C_out)``)."""
    vm = as_vm(x, vmajor)
    v, m, _ = vm.shape
    c_in, k_parts, c_out = w.shape
    plan = sb.plan_spatial_mma_forward(v, c_in, c_out, k_parts)
    frames = plan["frames"]
    h = h_of(vm, s1, t1, relu1, aff)
    z = vm.new_zeros(v, m, c_out)
    y = vm.new_zeros(k_parts, v, m, c_out)
    for m0 in range(0, m, frames):
        fc = min(frames, m - m0)
        hs = tile_rows(h, m0, fc, BM)
        for n0 in range(0, c_out, SN):
            cols = min(SN, c_out - n0)
            ys = [y_slab(hs, w, b, k, n0, plan["kc"])
                  for k in range(k_parts)]
            acc = vm.new_zeros(frames, VP, SN)
            for k in range(k_parts):
                ap = padded(a[k])
                for f in range(frames):
                    acc[f] += ap @ ys[k][f * v:f * v + VP]
                y[k, :, m0:m0 + fc, n0:n0 + cols] = ys[k][:fc * v, :cols] \
                    .reshape(fc, v, cols).permute(1, 0, 2)
            z[:, m0:m0 + fc, n0:n0 + cols] = acc[:fc, :v, :cols].permute(
                1, 0, 2)
    return (z, y) if save else z


def render_backward(x, g, s1, t1, w, b, a, y=None, *, relu1, aff, vmajor,
                    need_da=True, sms=SMS):
    """``(dx (V, M, C_in), ds1, dt1, dw (C_in, K, C_out), db, da)`` by the
    three backward kernels' tiles and the planner's choices; ``y`` the
    saved ``(K, V, M, C_out)`` expansion (the save op) or None."""
    vm, gm = as_vm(x, vmajor), as_vm(g, vmajor)
    v, m, c_in = vm.shape
    k_parts, c_out = w.shape[1], w.shape[2]
    save = y is not None
    need_da = need_da or save
    plan = sb.plan_spatial_mma_backward(v, m, c_in, c_out, k_parts, sms,
                                        save=save, need_da=need_da)
    frames = plan["frames"]
    tiles = -(-m // frames)
    assert plan["t_ctas"] <= min(tiles, 2 * sms)
    h = h_of(vm, s1, t1, relu1, aff)
    rows = m * v

    # the t kernel: t_k to the scratch in x's row order, dA per CTA (tiles
    # cta, cta + t_ctas, ...) summed in CTA order
    t = vm.new_zeros(k_parts, rows, plan["tp"])
    slices = []
    for cta in range(plan["t_ctas"]):
        sda = vm.new_zeros(k_parts, 2, VP, VP)
        for tile in range(cta, tiles, plan["t_ctas"]):
            m0 = tile * frames
            fc = min(frames, m - m0)
            hs = tile_rows(h, m0, fc, BM)
            for n0 in range(0, round_up(c_out, SN), SN):
                gs = slab_of(gm, m0, fc, n0)
                for k in range(k_parts):
                    at = padded(a[k].t())
                    tb = vm.new_zeros(YR, SN)
                    for f in range(fc):
                        tb[f * v:f * v + v] = rnd(at @ gs[f * v:f * v + VP],
                                                  x.dtype)[:v]
                    cols = min(SN, c_out - n0)
                    pieces = -(-cols // 8) * 8     # whole 16-byte pieces
                    for f in range(fc):
                        dst = slice_rows(m0 + f, v, m, vmajor)
                        t[k, dst, n0:n0 + pieces] = tb[f * v:f * v + v,
                                                       :pieces]
                if not need_da:
                    continue
                steps = -(-min(SN, c_out - n0) // 16)
                for k in range(k_parts):
                    ys = (slab_of(y[k], m0, fc, n0) if save else
                          y_slab(hs, w, b, k, n0, plan["t_kc"]))
                    for f in range(fc):
                        for kk in range(steps):
                            ga = gs[f * v:f * v + VP, kk * 16:kk * 16 + 16]
                            yb = ys[f * v:f * v + VP, kk * 16:kk * 16 + 16]
                            sda[k, kk % 2] += ga @ yb.t()
        slices.append(sda[:, 0, :v, :v] + sda[:, 1, :v, :v])
    da = sum(slices[1:], slices[0])
    assert not t[:, :, c_out:].any()            # the padding stays zero

    # the dx kernel: 128-row tiles, chunks of one partition's 64 channels
    wt = torch.nn.functional.pad(w.permute(1, 2, 0),
                                 (0, plan["dx_bn"] - c_in))
    xr = rows_of(vm, vmajor)
    hr = rows_of(h, vmajor)
    dx = xr.new_zeros(rows, c_in)
    h_scratch = (None if not aff and c_in % sb.ALIGN == 0
                 else xr.new_zeros(rows, plan["hp"]))
    col_slices = []
    nco = -(-c_out // SN)
    assert plan["tiles_x"] * BM >= rows
    for r0 in range(0, plan["tiles_x"] * BM, BM):
        sel = slice(r0, min(rows, r0 + BM))
        dh = xr.new_zeros(sel.stop - sel.start, plan["dx_bn"])
        for ch in range(k_parts * nco):
            k, o0 = ch // nco, (ch % nco) * SN
            dh += t[k, sel, o0:min(c_out, o0 + SN)] @ wt[k, o0:o0 + SN]
        dh = dh[:, :c_in]
        if aff:
            pre = xr[sel] * s1 + t1
            dp = torch.where(pre > 0, dh, 0.0) if relu1 else dh
            dx[sel] = rnd(dp * s1, x.dtype)
            col_slices.append(torch.stack([(dp * xr[sel]).sum(0),
                                           dp.sum(0)]))
        else:
            dx[sel] = rnd(dh, x.dtype)
        if h_scratch is not None:
            h_scratch[sel, :c_in] = hr[sel]
    ds = sum(col_slices[1:], col_slices[0]) if aff else None

    # the dW kernel: split-K over whole 128-row chunks, 64 x 64 tiles
    src = hr if h_scratch is None else h_scratch[:, :c_in]
    splits, split_rows = plan["dw_splits"], plan["dw_split_rows"]
    assert (splits - 1) * split_rows < rows <= splits * split_rows
    assert split_rows % sb.DW_KR == 0
    parts = []
    for s in range(splits):
        dw_s = xr.new_zeros(k_parts, c_in, c_out)
        for r0 in range(s * split_rows, min(rows, (s + 1) * split_rows),
                        sb.DW_KR):
            sel = slice(r0, min(rows, r0 + sb.DW_KR))
            for c0 in range(0, c_in, 64):
                for n0 in range(0, c_out, SN):
                    for k in range(k_parts):
                        dw_s[k, c0:c0 + 64, n0:n0 + SN] += (
                            src[sel, c0:c0 + 64].t()
                            @ t[k, sel, n0:min(c_out, n0 + SN)])
        parts.append((dw_s, t[:, s * split_rows:(s + 1) * split_rows,
                               :c_out].sum(1)))
    dw = sum(p[0] for p in parts[1:]) + parts[0][0]
    db = sum(p[1] for p in parts[1:]) + parts[0][1]
    return (from_rows(dx, v, m, vmajor), None if ds is None else ds[0],
            None if ds is None else ds[1], dw.permute(1, 0, 2), db, da)


def round_up(v, mult):
    return -(-v // mult) * mult


def slice_rows(mf, v, m, vmajor):
    """The scratch rows of frame mf's V joints, in joint order."""
    if vmajor:
        return torch.arange(v) * m + mf
    return torch.arange(mf * v, mf * v + v)


def inputs(rng, m, c_in, c_out, k=2, adjacency=None):
    def f64(*shape, scale=1.0, loc=0.0):
        return torch.from_numpy(rng.normal(loc, scale, shape)).to(F64)

    if adjacency is None:
        a = torch.from_numpy(rng.uniform(0, 0.3, (k, V, V))).to(F64)
    else:
        a = adjacency
    return dict(x=f64(V, m, c_in), g=f64(V, m, c_out),
                s1=f64(c_in, scale=0.3, loc=1.0), t1=f64(c_in, scale=0.2),
                w=f64(c_in, k, c_out, scale=c_in ** -0.5),
                b=f64(k, c_out, scale=0.1), a=a)


def close(got, want, what):
    scale = max(float(want.abs().max()), 1e-30)
    err = float((got - want).abs().max())
    assert err <= 1e-10 * scale, f"{what}: error {err}, largest {scale}"


# (frames M = N*T, C_in, C_out, K): DEFAULT_PLAN-like narrow widths (the
# stem's C_in = 2), the 40-channel tail, two slabs (72 > 64), two dW
# input-channel tiles (72 > 64), a third partition, frame counts that
# leave the last tile short (M % 5 != 0), and 36 channels, whose rows have
# no 16-byte stride (plain loads; the weights and scratch padded to 40)
SIZES = [(14, 2, 16, 2), (12, 16, 16, 2), (9, 16, 24, 2), (7, 40, 40, 2),
         (11, 72, 72, 2), (8, 24, 16, 3), (6, 36, 36, 2)]
GRAD_NAMES = ("dx", "ds1", "dt1", "dw", "db", "da")


class TestDecomposition:
    @pytest.mark.parametrize("m,c_in,c_out,k", SIZES)
    @pytest.mark.parametrize("relu1", [True, False])
    def test_spatial_block(self, rng, m, c_in, c_out, k, relu1):
        d = inputs(rng, m, c_in, c_out, k)
        x = d["x"].reshape(V, 1, m, c_in)          # (V, N, T, C) with N = 1
        g = d["g"].reshape(V, 1, m, c_out)
        rest = (d["s1"], d["t1"], d["w"], d["b"], d["a"])
        z = render_forward(x, *rest, relu1=relu1, aff=True, vmajor=True)
        want = sb.spatial_block_forward_reference(x, *rest, relu1=relu1)
        close(z, want.reshape(V, m, c_out), "z")
        got = render_backward(x, g, *rest, relu1=relu1, aff=True,
                              vmajor=True)
        want = sb.spatial_block_backward_reference(x, g, *rest, relu1=relu1)
        for gv, wv, name in zip(got, want, GRAD_NAMES):
            close(gv.reshape(wv.shape), wv, name)

    @pytest.mark.parametrize("m,c_in,c_out,k", SIZES[:4])
    @pytest.mark.parametrize("ctas", [SMS, 1])
    def test_fixed_graph_and_few_ctas(self, rng, m, c_in, c_out, k, ctas):
        """need_da off gives dA = 0 (no y_k recompute: no W ring, no h);
        one SM's two CTAs loop over several tiles each and keep dA across
        them, and the dW kernel's splits shrink to its one SM."""
        d = inputs(rng, m, c_in, c_out, k)
        x = d["x"].reshape(V, 1, m, c_in)
        g = d["g"].reshape(V, 1, m, c_out)
        rest = (d["s1"], d["t1"], d["w"], d["b"], d["a"])
        for need_da in (True, False):
            plan = sb.plan_spatial_mma_backward(V, m, c_in, c_out, k, ctas,
                                                need_da=need_da)
            assert (plan["t_stages"] == 0) == (not need_da)
            assert (plan["t_hbufs"] == 0) == (not need_da)
            got = render_backward(x, g, *rest, relu1=True, aff=True,
                                  vmajor=True, need_da=need_da, sms=ctas)
            want = sb.spatial_block_backward_reference(
                x, g, *rest, relu1=True, need_da=need_da)
            for gv, wv, name in zip(got, want, GRAD_NAMES):
                close(gv.reshape(wv.shape), wv, name)

    @pytest.mark.parametrize("m,c_in,c_out,k", SIZES)
    def test_spatial_block_save(self, rng, m, c_in, c_out, k):
        """The saved y is the forward's y_slab, which the recompute calls
        too: the backward reads it in place of recomputing."""
        d = inputs(rng, m, c_in, c_out, k)
        x = d["x"].reshape(V, 1, m, c_in)
        g = d["g"].reshape(V, 1, m, c_out)
        rest = (d["s1"], d["t1"], d["w"], d["b"], d["a"])
        z, y = render_forward(x, *rest, relu1=True, aff=True, vmajor=True,
                              save=True)
        want_z, want_y = sb.spatial_block_save_forward_reference(
            x, *rest, relu1=True)
        close(z, want_z.reshape(V, m, c_out), "z")
        close(y, want_y.reshape(k, V, m, c_out), "y")
        got = render_backward(x, g, d["s1"], d["t1"], d["w"], None, d["a"],
                              y, relu1=True, aff=True, vmajor=True)
        want = sb.spatial_block_save_backward_reference(
            x, g, want_y, d["s1"], d["t1"], d["w"], d["a"], relu1=True)
        for gv, wv, name in zip(got, want, GRAD_NAMES):
            close(gv.reshape(wv.shape), wv, name)

    @pytest.mark.parametrize("m,c_in,c_out,k", SIZES)
    @pytest.mark.parametrize("layout", ["vntc", "ntvc"])
    def test_spatial_conv(self, rng, m, c_in, c_out, k, layout):
        """Without the affine, both layouts (N = 1 sequence of M frames
        for (N, T, V, C)); the scratch rows follow x's order in each."""
        vmajor = layout == "vntc"
        d = inputs(rng, m, c_in, c_out, k)
        if vmajor:
            x, g = d["x"], d["g"]
        else:
            x = d["x"].permute(1, 0, 2).reshape(1, m, V, c_in)
            g = d["g"].permute(1, 0, 2).reshape(1, m, V, c_out)
        wba = (d["w"], d["b"], d["a"])
        z = render_forward(x, None, None, *wba, relu1=False, aff=False,
                           vmajor=vmajor)
        want = sc.spatial_conv_forward_reference(x, *wba, vmajor=vmajor)
        close(z, as_vm(want, vmajor), "z")
        dx, _, _, dw, db, da = render_backward(
            x, g, None, None, *wba, relu1=False, aff=False, vmajor=vmajor)
        want = sc.spatial_conv_backward_reference(x, g, *wba, vmajor=vmajor)
        close(dx, as_vm(want[0], vmajor), "dx")
        for gv, wv, name in zip((dw, db, da), want[1:], ("dw", "db", "da")):
            close(gv, wv, name)

    def test_frames_fill_the_tile(self):
        """F = 5 frames of 25 joints: 125 rows of the two warpgroups' 128,
        and every frame's 32-row window of the aggregation inside a slab
        buffer's rows; V = 32 is the largest the padded adjacency takes."""
        assert sb.mma_frames(25) == 5
        for v in range(1, VP + 1):
            f = sb.mma_frames(v)
            assert f * v <= BM and (f - 1) * v + VP <= YR
            assert 1 <= f <= sb.MAX_FRAMES
        with pytest.raises(ValueError, match="joints"):
            sb.mma_frames(VP + 1)


# DEFAULT_PLAN's spatial shapes at B=64, T=304 as (M frames, C_in, C_out),
# and the odd widths of chip_smoke.py
MAIN = [(64 * 304, 2, 64), (64 * 304, 64, 64), (64 * 304, 64, 128),
        (64 * 152, 128, 128), (64 * 152, 128, 256), (64 * 76, 256, 256),
        (64 * 37, 40, 40), (64 * 37, 36, 36)]
# (save, need_da) of the three backward variants
VARIANTS = ((False, True), (True, True), (False, False))


def w_ring_ok(kc, stages, c_in, c_out, k):
    """A W ring the kernels take: resident (kc 64, a stage for each of a
    tile's chunks, at most MAX_RESIDENT) or one of RINGS."""
    chunks = -(-c_out // SN) * k * -(-c_in // 64)
    return ((kc == 64 and chunks <= stages <= be.MAX_RESIDENT)
            or (kc, stages) in be.RINGS)


class TestPlans:
    @pytest.mark.parametrize("m,c_in,c_out", MAIN)
    @pytest.mark.parametrize("k", [2, 3])
    def test_plans_fit(self, m, c_in, c_out, k):
        """Shared bytes within 232,448 as the kernels carve them (the
        rings' stages with a full and an empty mbarrier each, 16 bytes a
        stage); two CTAs an SM only within HALF_SM; the dW kernel about one
        CTA an SM, its splits whole chunks."""
        plan = sb.plan_spatial_mma_forward(V, c_in, c_out, k)
        assert plan["frames"] == 5
        assert plan["smem"] == sb.fwd_smem(c_in, c_out, k, plan["kc"],
                                           plan["stages"]) <= SMEM_LIMIT
        assert w_ring_ok(plan["kc"], plan["stages"], c_in, c_out, k)
        rows = m * V
        for save, need_da in VARIANTS:
            bp = sb.plan_spatial_mma_backward(V, m, c_in, c_out, k, SMS,
                                              save=save, need_da=need_da)
            rec = need_da and not save
            assert bp["t_smem"] == sb.t_smem(
                c_in, c_out, k, bp["t_kc"], bp["t_stages"], bp["t_hbufs"],
                bp["t_gslots"], save) <= SMEM_LIMIT
            assert bp["t_gslots"] in (1, 2)
            if rec:
                assert bp["t_hbufs"] in (1, 2)
                assert w_ring_ok(bp["t_kc"], bp["t_stages"], c_in, c_out, k)
            else:
                assert bp["t_stages"] == bp["t_hbufs"] == 0
            assert bp["t_ctas"] == min(-(-m // 5), 2 * SMS)
            assert bp["dx_bn"] in be.N_TILES and bp["dx_bn"] >= c_in
            assert bp["dx_smem"] == sb.dx_smem(
                bp["dx_bn"], bp["dx_stages"], c_in, bp["dx_xtile"]) \
                <= SMEM_LIMIT
            if bp["dx_xtile"]:
                assert bp["dx_stages"] >= 3
            assert bp["dw_smem"] == sb.dw_smem(k, bp["dw_stages"]) \
                <= SMEM_LIMIT
            assert 2 <= bp["dx_stages"] <= 4 and 2 <= bp["dw_stages"] <= 4
            assert bp["tiles_x"] * BM >= rows
            assert bp["dw_split_rows"] % sb.DW_KR == 0
            assert ((bp["dw_splits"] - 1) * bp["dw_split_rows"] < rows
                    <= bp["dw_splits"] * bp["dw_split_rows"])
            tiles = -(-c_in // 64) * -(-c_out // SN)
            assert bp["dw_splits"] * tiles <= 2 * SMS + tiles

    @pytest.mark.parametrize("c", [2, 16, 24, 36, 40, 64, 72, 128, 256])
    def test_ldmatrix_rows_are_16_byte_aligned(self, c):
        """Every shared row a kernel reads with ldmatrix starts 16-byte
        aligned: h at ``pitch`` elements, the slab buffers at SN + PAD, the
        padded adjacency at VP + PAD; every region of the forward's and the
        t kernel's carve-ups too; every swizzled stage and box (TMA writes
        them, wgmma and ldmatrix read them at sw128 offsets) is whole
        1024-byte atoms; and the scratch rows TMA reads have 16-byte
        strides."""
        pad = be.PAD
        assert (2 * be.pitch(c)) % 16 == 0
        for width in (SN, VP):
            assert (2 * (width + pad)) % 16 == 0
        k, cp = 3, round_up(c, SN)
        regions = [4 * k * cp, 8 * round_up(c, 16), 4 * k * 2 * VP * VP,
                   2 * k * VP * (VP + pad), 2 * BM * be.pitch(c),
                   sb.SLAB_BYTES]
        assert all(r % 16 == 0 for r in regions)
        for kc in (32, 64):
            assert (kc * 128) % be.ATOM == 0             # a W stage
        for bn in be.N_TILES:
            assert (sb.DX_TILE + bn * 128) % be.ATOM == 0  # a dx stage
        assert sb.DW_BOX % be.ATOM == 0                  # a dW box
        bp = sb.plan_spatial_mma_backward(V, 37, c, c, 2, SMS)
        assert (2 * bp["tp"]) % 16 == 0 and (2 * bp["hp"]) % 16 == 0
        assert bp["tp"] - c < sb.ALIGN and bp["hp"] - c < sb.ALIGN

    @pytest.mark.parametrize("c", [2, 36, 40, 64, 128, 256])
    def test_plain_load_producers(self, c):
        """TMA reads every weight ring and scratch tensor: the wrappers
        pad W (K, C_in, C_out) and W^T (K, C_out, C_in) to 16-byte rows
        with zero columns, and the t and h scratch are allocated at such a
        pitch.  Only activation rows without 16-byte strides (x staged as
        h, g and the saved y staged as slabs) take plain loads; the dW
        kernel reads x itself only without the affine and with 16-byte
        rows, else the dx kernel's h."""
        w = torch.randn(c, 2, c)
        padded_w = sb._padded_rows(w.permute(1, 0, 2), torch.bfloat16)
        assert padded_w.shape[-1] % sb.ALIGN == 0
        assert torch.equal(padded_w[..., :c], w.permute(1, 0, 2).to(
            torch.bfloat16))
        assert not padded_w[..., c:].any()
        x = torch.zeros(V, 4, c, dtype=torch.bfloat16)
        aligned_rows = c % sb.ALIGN == 0
        assert sb.x_rows_readable(x, aff=False) == aligned_rows
        assert not sb.x_rows_readable(x, aff=True)
        assert (c in (2, 36)) == (not aligned_rows)
