"""The bf16 tensor-core spatial kernels' decomposition, proven on the CPU.

``csrc/spatial_block.cu`` computes the bf16 spatial ops (``spatial_block``,
``spatial_block_save`` and ``spatial_conv``) as tiles whose index arithmetic
a compiler here cannot check:

* the forward takes F whole frames a CTA (F V rows of a 128-row ``mma``
  tile), computes y_k = round(h . W_k + b_k) per column block of 64 and
  aggregates z = sum_k A_k . y_k per frame with the joints padded to 32
  (A's padding columns zero, the rows past the tile zero or b);
* the backward's row kernel loops a fixed number of CTAs over those tiles:
  t_k = round(A_k^T . g) per frame (stored for the next two kernels) and
  dA_k = sum g . y_k^T over 16 x 16 sub-tiles split by k16-step parity,
  kept per CTA and summed in CTA order;
* the dx kernel is a GEMM over 128-row tiles of the M*V rows, dh = sum_k
  t_k . W_k^T, whose column sums of dpre * x and dpre go to one slice a
  tile, summed in tile order;
* the dW kernel splits the rows into the planner's slices, dW_k = h^T . t_k
  and db_k = sum t_k per slice, summed in slice order.

Here that decomposition is rendered in plain PyTorch with the kernels'
tile geometry and the planners' own choices, and held in float64 against
the plain versions (``spatial_block_*_reference``, ``spatial_conv_*``),
which ``tests/test_torch_train_kernels.py``,
``tests/test_torch_save_kernel.py`` and ``tests/test_torch_conv_kernels.py``
hold against the Pallas kernels.  Tolerance: rtol 1e-10 of the largest
magnitude (float64, sums in other orders).  The rounding points (y_k, t_k)
are rendered as the kernels place them: a rounding to the input's dtype,
which the float64 check passes through unchanged.

The planners are held to the card: every DEFAULT_PLAN shape and a 40
channel tail fit in shared memory, and every ldmatrix row starts 16-byte
aligned.
"""

import pytest
import torch

from stgcn_tpu_torch.kernels import block_eval as be
from stgcn_tpu_torch.kernels import spatial_block as sb
from stgcn_tpu_torch.kernels import spatial_conv as sc
from stgcn_tpu_torch.kernels.block_eval import SMEM_LIMIT

V = 25
CTAS = 2 * 132       # partial_ctas on an H100 SXM
F64 = torch.float64
BM, BN, VP, YR = sb.MMA_ROWS, sb.MMA_BN, sb.VP, sb.YR


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


def padded(a):
    out = a.new_zeros(VP, VP)
    out[:a.shape[0], :a.shape[1]] = a
    return out


def y_block(hs, w, b, k, nb):
    """y_tile: the BN columns from nb of round(h . W_k + b_k) for the
    BM rows of the tile, zero past C_out; rows past BM of ys are zero."""
    c_out = w.shape[2]
    ys = hs.new_zeros(YR, BN)
    cols = min(BN, c_out - nb)
    ys[:BM, :cols] = rnd(hs @ w[:, k, nb:nb + cols] + b[k, nb:nb + cols],
                         hs.dtype)
    return ys


def render_forward(x, s1, t1, w, b, a, *, relu1, aff, vmajor, save=False):
    """z (and with ``save`` y) by the forward kernel's tiles, in
    ``(V, M, C_out)`` (and ``(K, V, M, C_out)``)."""
    vm = as_vm(x, vmajor)
    v, m, _ = vm.shape
    c_out, k_parts = w.shape[2], w.shape[1]
    frames = sb.mma_frames(v)
    h = h_of(vm, s1, t1, relu1, aff)
    z = vm.new_zeros(v, m, c_out)
    y = vm.new_zeros(k_parts, v, m, c_out)
    for m0 in range(0, m, frames):
        fc = min(frames, m - m0)
        hs = tile_rows(h, m0, fc, BM)
        for nb in range(0, c_out, BN):
            acc = vm.new_zeros(frames, VP, BN)
            for k in range(k_parts):
                ys = y_block(hs, w, b, k, nb)
                ap = padded(a[k])
                for f in range(frames):
                    acc[f] += ap @ ys[f * v:f * v + VP]
                cols = min(BN, c_out - nb)
                y[k, :, m0:m0 + fc, nb:nb + cols] = ys[:fc * v, :cols].reshape(
                    fc, v, cols).permute(1, 0, 2)
            cols = min(BN, c_out - nb)
            z[:, m0:m0 + fc, nb:nb + cols] = acc[:fc, :v, :cols].permute(
                1, 0, 2)
    return (z, y) if save else z


def render_backward(x, g, s1, t1, w, b, a, y=None, *, relu1, aff, vmajor,
                    need_da=True, ctas=CTAS):
    """``(dx (V, M, C_in), ds1, dt1, dw (C_in, K, C_out), db, da)`` by the
    three backward kernels' tiles and the planner's splits; ``y`` the saved
    ``(K, V, M, C_out)`` expansion (the save op) or None."""
    vm, gm = as_vm(x, vmajor), as_vm(g, vmajor)
    v, m, c_in = vm.shape
    k_parts, c_out = w.shape[1], w.shape[2]
    plan = sb.plan_spatial_mma_backward(v, m, c_in, c_out, k_parts, ctas)
    frames = plan["frames"]
    tiles = -(-m // frames)
    assert plan["ctas"] == min(ctas, tiles)
    h = h_of(vm, s1, t1, relu1, aff)
    save = y is not None
    need_da = need_da or save

    # the row kernel: t_k to the scratch, dA per CTA in CTA order
    t_rows = vm.new_zeros(k_parts, m * v, c_out)
    slices = []
    for cta in range(plan["ctas"]):
        sda = vm.new_zeros(k_parts, 2, VP, VP)
        for tile in range(cta, tiles, plan["ctas"]):
            m0 = tile * frames
            fc = min(frames, m - m0)
            gs = tile_rows(gm, m0, fc, YR)
            hs = tile_rows(h, m0, fc, BM)
            for k in range(k_parts):
                at = padded(a[k].t())
                for f in range(fc):
                    tk = rnd(at @ gs[f * v:f * v + VP], x.dtype)
                    t_rows[k, (m0 + f) * v:(m0 + f + 1) * v] = tk[:v]
                if not need_da:
                    continue
                dacc = vm.new_zeros(2, VP, VP)
                for nb in range(0, c_out, BN):
                    if save:
                        ys = tile_rows(y[k, :, :, nb:nb + BN], m0, fc, YR)
                        ys = torch.nn.functional.pad(ys, (0, BN - ys.shape[1]))
                    else:
                        ys = y_block(hs, w, b, k, nb)
                    steps = -(-min(BN, c_out - nb) // 16)
                    for f in range(fc):
                        for kk in range(steps):
                            ga = gs[f * v:f * v + VP,
                                    nb + kk * 16:nb + kk * 16 + 16]
                            yb = ys[f * v:f * v + VP, kk * 16:kk * 16 + 16]
                            # zero columns of g past C_out pair with y's
                            ga = torch.nn.functional.pad(
                                ga, (0, 16 - ga.shape[1]))
                            dacc[kk % 2] += ga @ yb.t()
                sda[k] += dacc
        slices.append(sda[:, 0, :v, :v] + sda[:, 1, :v, :v])
    da = sum(slices[1:], slices[0])

    # the dx kernel: 128-row tiles of the rows m*V + v
    wt = w.permute(1, 2, 0)                                 # (K, C_out, C_in)
    rows = m * v
    xr = vm.permute(1, 0, 2).reshape(rows, c_in)
    dx = xr.new_zeros(rows, c_in)
    col_slices = []
    assert plan["tiles_x"] * BM >= rows
    for r0 in range(0, plan["tiles_x"] * BM, BM):
        sel = slice(r0, min(rows, r0 + BM))
        dh = sum(t_rows[k, sel] @ wt[k] for k in range(k_parts))
        if aff:
            pre = xr[sel] * s1 + t1
            dp = torch.where(pre > 0, dh, 0.0) if relu1 else dh
            dx[sel] = rnd(dp * s1, x.dtype)
            col_slices.append(torch.stack([(dp * xr[sel]).sum(0),
                                           dp.sum(0)]))
        else:
            dx[sel] = rnd(dh, x.dtype)
    ds = sum(col_slices[1:], col_slices[0]) if aff else None

    # the dW kernel: split-K over the planner's row slices
    hr = h.permute(1, 0, 2).reshape(rows, c_in)
    splits, split_rows = plan["splits"], plan["split_rows"]
    assert (splits - 1) * split_rows < rows <= splits * split_rows
    assert split_rows % sb.MMA_KR == 0
    parts = []
    for s in range(splits):
        sel = slice(s * split_rows, min(rows, (s + 1) * split_rows))
        parts.append((torch.stack([hr[sel].t() @ t_rows[k, sel]
                                   for k in range(k_parts)]),
                      t_rows[:, sel].sum(1)))
    dw = sum(p[0] for p in parts[1:]) + parts[0][0]
    db = sum(p[1] for p in parts[1:]) + parts[0][1]
    dx = dx.reshape(m, v, c_in).permute(1, 0, 2)
    return (dx, None if ds is None else ds[0], None if ds is None else ds[1],
            dw.permute(1, 0, 2), db, da)


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
# stem's C_in = 2), the 40-channel tail, two column blocks (72 > 64), two
# dW input-channel tiles (72 > 64), a third partition, and frame counts
# that leave the last tile short (M % 5 != 0)
SIZES = [(14, 2, 16, 2), (12, 16, 16, 2), (9, 16, 24, 2), (7, 40, 40, 2),
         (11, 72, 72, 2), (8, 24, 16, 3)]
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
    @pytest.mark.parametrize("ctas", [CTAS, 2])
    def test_fixed_graph_and_few_ctas(self, rng, m, c_in, c_out, k, ctas):
        """need_da off gives dA = 0; two CTAs loop over several tiles
        each and keep dA across them."""
        d = inputs(rng, m, c_in, c_out, k)
        x = d["x"].reshape(V, 1, m, c_in)
        g = d["g"].reshape(V, 1, m, c_out)
        rest = (d["s1"], d["t1"], d["w"], d["b"], d["a"])
        for need_da in (True, False):
            got = render_backward(x, g, *rest, relu1=True, aff=True,
                                  vmajor=True, need_da=need_da, ctas=ctas)
            want = sb.spatial_block_backward_reference(
                x, g, *rest, relu1=True, need_da=need_da)
            for gv, wv, name in zip(got, want, GRAD_NAMES):
                close(gv.reshape(wv.shape), wv, name)

    @pytest.mark.parametrize("m,c_in,c_out,k", SIZES)
    def test_spatial_block_save(self, rng, m, c_in, c_out, k):
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
        for (N, T, V, C))."""
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
        """F = 5 frames of 25 joints: 125 rows of the 128-row tile, and
        every frame's 32-row window of the aggregation inside the staged
        rows; V = 32 is the largest the padded adjacency takes."""
        assert sb.mma_frames(25) == 5
        for v in range(1, VP + 1):
            f = sb.mma_frames(v)
            assert f * v <= BM and (f - 1) * v + VP <= YR
            assert 1 <= f <= sb.MAX_FRAMES
        with pytest.raises(ValueError, match="joints"):
            sb.mma_frames(VP + 1)


# DEFAULT_PLAN's spatial shapes at B=64, T=304 as (M frames, C_in, C_out),
# and the odd width of chip_smoke.py
MAIN = [(64 * 304, 2, 64), (64 * 304, 64, 64), (64 * 304, 64, 128),
        (64 * 152, 128, 128), (64 * 152, 128, 256), (64 * 76, 256, 256),
        (64 * 37, 40, 40)]


class TestPlans:
    @pytest.mark.parametrize("m,c_in,c_out", MAIN)
    @pytest.mark.parametrize("k", [2, 3])
    def test_plans_fit(self, m, c_in, c_out, k):
        frames, smem = sb.plan_spatial_mma_forward(V, c_in, c_out, k)
        assert frames == 5 and smem <= SMEM_LIMIT
        plan = sb.plan_spatial_mma_backward(V, m, c_in, c_out, k, CTAS)
        for key in ("t_smem", "dx_smem", "dw_smem"):
            assert plan[key] <= SMEM_LIMIT, key
        assert plan["ctas"] == min(CTAS, -(-m // 5))
        assert plan["tiles_x"] * BM >= m * V
        assert plan["splits"] * plan["split_rows"] >= m * V
        assert plan["split_rows"] % sb.MMA_KR == 0
        # about CTAS CTAs of the dW GEMM
        nj, bm, bn = sb.dw_tile(c_out)
        tiles = k * -(-c_in // bm) * -(-c_out // bn)
        assert plan["splits"] * tiles <= 2 * CTAS + tiles

    @pytest.mark.parametrize("c", [2, 16, 24, 40, 64, 72, 128, 256])
    def test_ldmatrix_rows_are_16_byte_aligned(self, c):
        """Every shared row a kernel reads with ldmatrix: h and g at
        ``pitch`` elements, ys and the ring at BN + PAD, the padded
        adjacency at VP + PAD, the dx kernel's t chunks at KC + PAD, the dW
        rows at 64 + PAD and BN_dw + PAD; and every region of each
        carve-up starts 16-byte aligned."""
        pad = be.PAD
        assert (2 * be.pitch(c)) % 16 == 0
        for width in (BN, VP, sb.MMA_KC, 64, sb.dw_tile(c)[2]):
            assert (2 * (width + pad)) % 16 == 0
        regions = [2 * sb.MMA_KC * (BN + pad) * 2,         # ring
                   VP * (VP + pad) * 2,                    # one adjacency
                   BM * be.pitch(c) * 2,                   # hs
                   YR * be.pitch(c) * 2,                   # gs
                   YR * (BN + pad) * 2,                    # ys
                   2 * BM * (sb.MMA_KC + pad) * 2]         # dx t ring
        assert all(r % 16 == 0 for r in regions)
        # 16 bytes modulo 128 between rows: the eight rows of one ldmatrix
        # phase fall in eight bank groups
        for width in (BN, sb.MMA_KC):
            assert (2 * (width + pad)) % 128 in (16, 80)
