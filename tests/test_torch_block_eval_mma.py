"""The bf16 warpgroup block_eval kernels' decomposition, proven on the CPU.

``csrc/block_eval.cu`` computes the bf16 eval block in two kernels a call
(three with the projection shortcut), with z passing through a scratch
tensor, and index arithmetic that no compiler here can check:

* the spatial kernel tiles the M = N*T frames into whole frames (row
  ``f*V + v`` of 128), computes each partition's y_k on the tile's 128 rows
  per slab of 64 output channels into a buffer of YR rows, and aggregates
  each frame as its 32-row window from row ``f*V`` times A_k padded to
  32 x 32 (whose zero columns cancel the next frame's rows in the window);
* the taps kernel is an implicit GEMM over (line, output frame) rows in
  tiles of 128, each tile's z frames staged once with the halo and row r
  reading tap g at its staged offset + g (temporal_block.cu's Tile); the
  projection pass is the same GEMM with one tap over x at frame t*s, and
  the taps' epilogue reads the rounded projection back.

Here that decomposition is rendered in plain PyTorch with the planners'
own frames and the kernels' tile geometry, and held against
``block_eval_reference`` (which ``tests/test_torch_ops.py`` holds against
the Pallas kernels): in float64 with no rounding, to rtol 1e-10 of the
largest magnitude (sums in other orders), and with bf16 inputs and the
kernels' bf16 rounding points (h, y_k, z, the projection, the output),
summed in float64, against the reference's float32 sums of the same bf16
values: within one bf16 ulp elementwise but for a share of 1e-3 (where two
sums of one rounding point fall on either side of a bf16 boundary).

The planner is held to the card: every DEFAULT_PLAN block and the odd
widths fit in 232,448 bytes of shared memory with rings of at least three
stages or, for the spatial kernel, W resident (two CTAs an SM up to C_in =
64), every swizzled stage starts on a 1024-byte atom, every ldmatrix row
starts 16-byte aligned, and TMA's 16-byte strides hold exactly where
C_out % 8 == 0.
"""

import numpy as np
import pytest
import torch

from stgcn_tpu_torch.kernels import block_eval as be
from stgcn_tpu_torch.kernels.temporal_block import staged_rows
from test_torch_temporal_mma import implicit_gemm, tile

V, N, K, GAMMA = 25, 2, 2, 9
F64 = torch.float64
BM = be.GEMM_ROWS


def no_round(t):
    return t


def bf16_round(t):
    return t.to(torch.bfloat16).to(F64)


def render_spatial(x, s1, t1, w, b, a, s2, t2, *, lengths, order, relu1,
                   rnd):
    """z as block_eval_spatial_kernel writes it, (V, N, T, C_out)."""
    v, n, t, c_in = x.shape
    c_out = w.shape[2]
    m = n * t
    frames = be.spatial_frames(v)
    assert frames * v <= BM and (frames - 1) * v + be.VP <= be.YR
    xm = x.reshape(v, m, c_in)
    live = torch.ones(n, t, dtype=torch.bool)
    if lengths is not None:
        live = torch.arange(t)[None, :] < lengths[:, None]
    live = live.reshape(m)
    ap = x.new_zeros(K, be.VP, be.VP)   # A_k padded with zero rows, columns
    ap[:, :v, :v] = a
    z = x.new_zeros(v, m, c_out)
    for m0 in range(0, m, frames):
        fc = min(frames, m - m0)
        h = x.new_zeros(BM, c_in)       # rows past fc*V stay zero
        for f in range(fc):
            xf = xm[:, m0 + f] if live[m0 + f] else xm.new_zeros(v, c_in)
            hf = xf * s1 + t1
            h[f * v:(f + 1) * v] = rnd(torch.relu(hf) if relu1 else hf)
        for n0 in range(0, c_out, be.SLAB):
            cols = slice(n0, min(n0 + be.SLAB, c_out))
            zs = x.new_zeros(frames, v, cols.stop - n0)
            for k in range(K):
                y = x.new_zeros(be.YR, cols.stop - n0)
                y[:BM] = rnd(h @ w[:, k, cols] + b[k, cols])
                for f in range(frames):
                    zs[f] += (ap[k] @ y[f * v:f * v + be.VP])[:v]
            for f in range(fc):
                z[:, m0 + f, cols] = zs[f]
    if order == "pre":
        z = torch.relu(z * s2 + t2)
    return rnd(z).reshape(v, n, t, c_out)


def taps_gemm(src, w, t_out, stride, off0):
    """The taps kernel's GEMM over ``src`` (V, N, T, C) as lines v*N + n:
    ``(lines, T_out, C_out)``, every tile's staged rows within the
    planner's bound."""
    lines = src.reshape(-1, src.shape[2], src.shape[3])
    ntap = w.shape[0]
    total = lines.shape[0] * t_out
    for r0 in range(0, total, BM):
        frames = tile(r0, BM, total, t_out, stride, ntap, off0)[2]
        assert len(frames) <= staged_rows(BM, t_out, stride, ntap)
    taps = list(range(ntap))
    return implicit_gemm(lines, w, taps, taps, t_out, stride, off0, BM)


def render_block(x, kw, *, stride, order, shortcut, relu1, lengths, rnd):
    """block_eval's bf16 decomposition: z from the spatial kernel, the
    projection pass, the taps and their epilogue."""
    v, n, t, c_in = x.shape
    c_out = kw["wt"].shape[2]
    t_out = be.t_out_of(t, stride, GAMMA)
    z = render_spatial(x, kw["s1"], kw["t1"], kw["w"], kw["b"], kw["a"],
                       kw["s2"], kw["t2"], lengths=lengths, order=order,
                       relu1=relu1, rnd=rnd)
    u = taps_gemm(z, kw["wt"], t_out, stride, -(GAMMA // 2)) + kw["bt"]
    if order == "post":
        u = u * kw["s2"] + kw["t2"]
    if shortcut == "id":
        u = u + x.reshape(-1, t, c_in)
    elif shortcut == "proj":
        proj = taps_gemm(x, kw["wr"][None], t_out, stride, 0)
        u = u + rnd(proj + kw["br"])
    return rnd(torch.relu(u)).reshape(v, n, t_out, c_out)


def block_inputs(rng, c_in, c_out, t, proj, masked):
    def f(*shape, scale=1.0, loc=0.0):
        return torch.from_numpy(rng.normal(loc, scale, shape))

    kw = dict(s1=f(c_in, scale=0.3, loc=1.0), t1=f(c_in, scale=0.2),
              w=f(c_in, K, c_out, scale=c_in ** -0.5), b=f(K, c_out, scale=0.1),
              a=torch.from_numpy(rng.uniform(0, 0.3, (K, V, V))),
              wt=f(GAMMA, c_out, c_out, scale=(GAMMA * c_out) ** -0.5),
              bt=f(c_out, scale=0.1), s2=f(c_out, scale=0.3, loc=1.0),
              t2=f(c_out, scale=0.2))
    if proj:
        kw.update(wr=f(c_in, c_out, scale=c_in ** -0.5), br=f(c_out, scale=0.1))
    lengths = (torch.from_numpy(rng.integers(1, t + 1, N)) if masked
               else None)
    return f(V, N, t, c_in), kw, lengths


# (C_in, C_out, stride, shortcut, order, masked, T): C in {2, 36, 40, 64}
# (36 not a multiple of 8: the plain-load paths), both strides, the three
# shortcuts, both orders, with and without lengths
CASES = [(2, 40, 1, "proj", "pre", False, 19),
         (36, 36, 1, "id", "pre", True, 19),
         (40, 40, 2, "proj", "pre", True, 23),
         (40, 64, 2, "none", "post", False, 19),
         (64, 64, 1, "id", "post", True, 11),
         (36, 40, 2, "proj", "post", True, 17)]


class TestDecomposition:
    @pytest.mark.parametrize("c_in,c_out,stride,shortcut,order,masked,t",
                             CASES)
    def test_float64(self, rng, c_in, c_out, stride, shortcut, order, masked,
                     t):
        x, kw, lengths = block_inputs(rng, c_in, c_out, t,
                                      shortcut == "proj", masked)
        flags = dict(stride=stride, order=order, shortcut=shortcut,
                     relu1=order == "pre", lengths=lengths)
        got = render_block(x, kw, rnd=no_round, **flags)
        want = be.block_eval_reference(x, **kw, **flags)
        scale = float(want.abs().max())
        assert float((got - want).abs().max()) <= 1e-10 * scale

    @pytest.mark.parametrize("c_in,c_out,stride,shortcut,order,masked,t",
                             CASES)
    def test_bf16_rounding_points(self, rng, c_in, c_out, stride, shortcut,
                                  order, masked, t):
        x, kw, lengths = block_inputs(rng, c_in, c_out, t,
                                      shortcut == "proj", masked)
        # the kernels' inputs: bf16 activations and weights, float32
        # affines and biases
        x = bf16_round(x)
        for key in ("w", "b", "a", "wt", "wr"):
            if key in kw:
                kw[key] = bf16_round(kw[key])
        for key in ("s1", "t1", "bt", "s2", "t2", "br"):
            if key in kw:
                kw[key] = kw[key].float().to(F64)
        flags = dict(stride=stride, order=order, shortcut=shortcut,
                     relu1=order == "pre", lengths=lengths)
        got = render_block(x, kw, rnd=bf16_round, **flags)
        want = be.block_eval_reference(
            x.to(torch.bfloat16),
            **{k: v.to(torch.bfloat16) if k in ("w", "b", "a", "wt", "wr")
               else v.float() for k, v in kw.items()}, **flags).to(F64)
        tol = 2.0 ** -7 * want.abs() + 1e-6 * want.abs().max()
        outside = int(((got - want).abs() > tol).sum())
        assert outside <= 1e-3 * want.numel()
        assert float((got - want).abs().max()) <= 2e-2 * float(
            want.abs().max())


# DEFAULT_PLAN's blocks at B=64, T=304 as block_eval sees them, and the
# odd widths of chip_smoke.py: (C_in, C_out, stride, T_in)
PLAN_BLOCKS = [(2, 64, 1, 304), (64, 64, 1, 304), (64, 128, 2, 304),
               (128, 128, 1, 152), (128, 256, 2, 152), (256, 256, 1, 76),
               (40, 40, 1, 37), (40, 40, 2, 37), (36, 36, 1, 37),
               (36, 36, 2, 37)]


class TestPlan:
    @pytest.mark.parametrize("c_in,c_out,stride,t", PLAN_BLOCKS)
    def test_fits_shared_memory(self, c_in, c_out, stride, t):
        """Each kernel's shared bytes are the layout's, within 232,448; the
        taps and the projection with a ring of three stages or more; the
        spatial kernel two CTAs an SM up to C_in = 64, each with W resident
        (a 64-row stage for each of a tile's chunks) where that fits beside
        the other, else such a ring; the N tile covers C_out."""
        p = be.plan_mma(V, t, c_in, c_out, K, stride, GAMMA)
        t_out = be.t_out_of(t, stride, GAMMA)
        assert p["frames"] == 5 and p["bn"] >= c_out
        assert p["s_smem"] == be.spatial_smem(c_in, c_out, K, p["s_kc"],
                                              p["s_stages"])
        assert p["t_smem"] == be.taps_smem(
            p["bn"], p["t_kc"], p["t_stages"],
            staged_rows(BM, t_out, stride, GAMMA), c_out)
        assert p["p_smem"] == be.taps_smem(
            p["bn"], p["p_kc"], p["p_stages"],
            staged_rows(BM, t_out, stride, 1), c_in)
        for key in ("s", "t", "p"):
            assert p[f"{key}_smem"] <= be.SMEM_LIMIT
        for key in ("t", "p"):
            assert (p[f"{key}_kc"], p[f"{key}_stages"]) in be.RINGS
            assert p[f"{key}_stages"] >= 3
        chunks = -(-c_out // be.SLAB) * K * -(-c_in // 64)
        resident = (p["s_kc"], p["s_stages"]) == (64, chunks)
        assert resident or ((p["s_kc"], p["s_stages"]) in be.RINGS
                            and p["s_stages"] >= 3)
        assert not resident or chunks <= be.MAX_RESIDENT
        assert (p["s_smem"] <= be.HALF_SM) == (c_in <= 64)
        if be.spatial_smem(c_in, c_out, K, 64, chunks) <= be.HALF_SM:
            assert resident

    @pytest.mark.parametrize("c", [2, 36, 40, 64, 128, 256])
    def test_swizzled_stages_start_on_an_atom(self, c):
        """The rings start on a 1024-byte atom (the slack before them) and
        every stage and 64-column tile is whole atoms; one k16 step of B
        is two atoms."""
        bn = next(n for n in be.N_TILES if c <= n)
        for kc, _ in be.RINGS:
            assert (kc * 128) % be.ATOM == 0            # a spatial stage
            assert (bn * kc * 2) % be.ATOM == 0         # a taps stage
        assert (16 * 128) % be.ATOM == 0

    @pytest.mark.parametrize("c", [2, 36, 40, 64, 128, 256])
    def test_ldmatrix_rows_are_16_byte_aligned(self, c):
        """Every region after the ring starts 16-byte aligned (the
        barriers, constants and adjacency are whole 16-byte pieces) and
        every row read by ldmatrix (h, y, A, the staged rows) is a
        multiple of 16 bytes wide; y's and A's rows 16 bytes apart modulo
        128 (y) or on distinct 16-byte chunks of a 128-byte line over
        eight rows (A), so one phase's eight rows hit eight bank groups."""
        for kc, stages in be.RINGS:
            for k in (1, 2, 3):
                ring = stages * (kc * 128 + 16)
                consts = 4 * (k + 2) * -(-c // be.SLAB) * be.SLAB
                adjacency = 2 * k * be.VP * (be.VP + be.PAD)
                for offset in (ring, ring + consts,
                               ring + consts + adjacency,
                               ring + consts + adjacency
                               + 2 * BM * be.pitch(c)):
                    assert offset % 16 == 0
            head = be.taps_smem(64, kc, stages, 0, c) - be.ATOM
            assert head % 16 == 0
        assert (2 * be.pitch(c)) % 16 == 0
        yp, ap = 2 * (be.SLAB + be.PAD), 2 * (be.VP + be.PAD)
        assert yp % 128 == 16
        assert len({(r * ap) % 128 // 16 for r in range(8)}) == 8

    @pytest.mark.parametrize("c", [2, 36, 40, 64, 128, 256])
    def test_tma_reads_weights_with_16_byte_strides(self, c):
        """The weights' TMA maps (W as (K, C_in, C_out), Wt, Wr as one tap)
        step 2 C_out bytes a row and 2 C_in C_out a matrix: multiples of 16
        exactly where C_out % 8 == 0 (wg::tma_can_read); C=36 takes the
        plain-load producer, and x's rows (C_in = 2 too) plain loads."""
        for c_in in (2, c):
            strides = (2 * c, 2 * c_in * c)
            assert all(s % 16 == 0 for s in strides) == (c % 8 == 0)

    @pytest.mark.parametrize("v", [1, 5, 16, 17, 25, 32])
    def test_aggregation_windows_stay_in_y(self, v):
        """Frame f reads y rows f*V .. f*V + 31: inside the YR rows of a
        buffer for every tile's frames, and the z units cover every
        (frame, 16 columns) of a slab with at most MAXU a warp."""
        frames = be.spatial_frames(v)
        assert 1 <= frames <= be.MAX_FRAMES and frames * v <= BM
        assert (frames - 1) * v + be.VP <= be.YR
        units = frames * (be.SLAB // 16)
        assert -(-units // 8) <= be.MAX_FRAMES * (be.SLAB // 16) // 8

    def test_rejects_wide_graphs(self):
        with pytest.raises(ValueError, match="V <= 32"):
            be.plan_mma(33, 20, 8, 8, K, 1, GAMMA)
