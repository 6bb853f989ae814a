"""The time halo (``stgcn_tpu_torch.parallel.halo``) and the temporal
conv's ``padding`` it runs on.

* ``padding``: the port's ``temporal_conv`` op against the JAX
  ``temporal_conv(..., padding=p)`` for every impl (``"pallas"`` is the
  kernel's plain version here) at strides 1 and 2 and paddings 0, 2 and
  the default, in float64 within 1e-12 of the largest value; the plain
  kernel version's gradients at ``padding=0`` against autograd of the
  op's ``conv``.
* The halo conv on four gloo ranks (``tests/torch_parallel_ranks.py``,
  started once for the file), at time 2 and 4, strides 1 and 2, with the
  overlapped and the monolithic exchange, inner impls ``conv`` and
  ``pallas``: each rank's output frames and the gradients of its input
  shard and of the weights (summed over the time ranks) against the
  unsharded op on the whole clip, float64 within 1e-12 of the largest;
  a shard too short for an interior (4 frames, a 9-tap conv) takes the
  monolithic exchange; and the recorded order shows the interior conv
  launched after the exchange was issued and before it was waited on,
  the counterpart of ``tests/test_halo_overlap.py:80``.
* ``overlap_split``: each edge strip covers the frames that read a halo
  (the JAX package's edges) and has at least ``EDGE_FRAMES`` output
  frames, which the bf16 temporal kernels' planners fit in shared memory
  at every width and stride of DEFAULT_PLAN.
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from stgcn_tpu.ops.temporal_conv import temporal_conv as jax_temporal_conv
from stgcn_tpu_torch.kernels import temporal_block as tb
from stgcn_tpu_torch.kernels.temporal_conv import (
    temporal_conv_backward_reference,
)
from stgcn_tpu_torch.ops.temporal_conv import temporal_conv
from stgcn_tpu_torch.parallel.halo import EDGE_FRAMES, overlap_split

from torch_parallel_ranks import launch

REL = 1e-12
N, V, C_IN, C_OUT, GAMMA = 2, 3, 4, 5, 9


def close(got, want, rel=REL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    scale = float(np.abs(want).max())
    assert float(np.abs(got - want).max()) <= rel * scale


@pytest.mark.parametrize("impl", ["conv", "pallas", "conv_vt", "shift_sum",
                                  "block"])
@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("padding", [0, 2, None])
def test_padding_matches_jax(impl, stride, padding):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((N, 20, V, C_IN))
    w = rng.standard_normal((GAMMA, 1, C_IN, C_OUT))
    b = rng.standard_normal(C_OUT)
    want = jax_temporal_conv({"w": jnp.asarray(w), "b": jnp.asarray(b)},
                             jnp.asarray(x), stride=stride, padding=padding)
    got = temporal_conv({"w": torch.from_numpy(w), "b": torch.from_numpy(b)},
                        torch.from_numpy(x), stride=stride, padding=padding,
                        impl=impl)
    close(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("stride", [1, 2])
def test_kernel_backward_at_padding_0(stride):
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.standard_normal((N, 21, V, C_IN)))
    w = torch.from_numpy(rng.standard_normal((GAMMA, C_IN, C_OUT)))
    b = torch.from_numpy(rng.standard_normal(C_OUT))
    xg, wg, bg = (t.clone().requires_grad_() for t in (x, w, b))
    y = temporal_conv({"w": wg[:, None], "b": bg}, xg, stride=stride,
                      padding=0)
    g = torch.from_numpy(rng.standard_normal(tuple(y.shape)))
    (y * g).sum().backward()
    dx, dw, db = temporal_conv_backward_reference(x, g, w, b, stride=stride,
                                                  vmajor=False, padding=0)
    for got, want in ((dx, xg.grad), (dw, wg.grad), (db, bg.grad)):
        close(got.numpy(), want.numpy())


def test_padding_out_of_range_refused():
    x = torch.zeros(1, 12, V, C_IN)
    w = torch.zeros(GAMMA, 1, C_IN, C_OUT)
    with pytest.raises(ValueError, match="padding"):
        temporal_conv({"w": w, "b": torch.zeros(C_OUT)}, x, padding=5,
                      impl="pallas")


def halo_case(time, stride, overlap, impl, t, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((N, t, V, C_IN))
    t_out = (t - 1) // stride + 1
    return dict(mesh=(1, time, 1), stride=stride, overlap=overlap, impl=impl,
                x=x, g=rng.standard_normal((N, t_out, V, C_OUT)),
                params={"w": rng.standard_normal((GAMMA, 1, C_IN, C_OUT)),
                        "b": rng.standard_normal(C_OUT)})


CASES = {}
for _time in (2, 4):
    for _stride in (1, 2):
        for _overlap in (True, False):
            for _impl in ("conv", "pallas"):
                # 80 frames a rank: two 16-frame edge strips and an
                # interior at both strides
                CASES[(_time, _stride, _overlap, _impl)] = halo_case(
                    _time, _stride, _overlap, _impl, 80 * _time,
                    len(CASES))
# 4 frames a shard: no output frame has its taps all local
CASES["small"] = halo_case(2, 1, True, "conv", 8, 99)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return launch("halo", 4, {"cases": CASES},
                  str(tmp_path_factory.mktemp("halo")))


@pytest.mark.parametrize("key", [k for k in CASES if k != "small"],
                         ids=lambda k: "t{}-s{}-{}-{}".format(
                             k[0], k[1], "overlap" if k[2] else "mono",
                             k[3]))
def test_halo_matches_unsharded(ranks, key):
    time = CASES[key]["mesh"][1]
    for r in range(time):
        res = ranks[r][key]
        close(res["y"], res["y_whole"])
        close(res["dx"], res["dx_whole"])
        close(res["dw"], res["dw_whole"])
        close(res["db"], res["db_whole"])


def test_interior_conv_runs_while_the_exchange_is_in_flight(ranks):
    for r in range(4):
        order = ranks[r][(4, 1, True, "pallas")]["record"]
        assert order == ["exchange_issued", "interior_conv",
                         "exchange_waited", "edge_conv"], order


@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("t", [8, 16, 32, 33, 38, 66, 76, 80, 152])
def test_overlap_split_covers_the_halo_frames(t, stride):
    pad = (GAMMA - 1) // 2
    split = overlap_split(t, stride, GAMMA)
    t_out = t // stride
    j_lo = -(-pad // stride)                    # the JAX package's edges
    j_hi = (t + pad - GAMMA) // stride
    if split is None:
        assert t_out < 2 * EDGE_FRAMES + 1 or j_hi < j_lo
        return
    left, right = split
    assert min(left, right) >= EDGE_FRAMES and left + right < t_out
    assert left >= j_lo and t_out - right <= j_hi + 1


@pytest.mark.parametrize("c", [64, 128, 256])
@pytest.mark.parametrize("stride", [1, 2])
def test_edge_strips_plan_on_the_bf16_kernels(c, stride):
    """An edge strip's valid conv (``EDGE_FRAMES`` output frames) fits the
    bf16 temporal kernels' shared memory, forward and backward."""
    t = (EDGE_FRAMES - 1) * stride + GAMMA
    tb.plan_mma_forward(t, c, c, stride, GAMMA, 0)
    tb.plan_mma_backward(25 * 32, t, c, c, stride, GAMMA, False, 132, 0)


def test_small_shard_takes_the_monolithic_exchange(ranks):
    for r in range(2):
        res = ranks[r]["small"]
        assert "interior_conv" not in res["record"]
        close(res["y"], res["y_whole"])
        close(res["dx"], res["dx_whole"])
