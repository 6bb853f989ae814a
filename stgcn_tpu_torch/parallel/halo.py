"""Explicit halo-exchange temporal convolution (port of
``stgcn_tpu/parallel/halo.py``).

The ``gamma x 1`` temporal conv is local in time: an output frame needs
``(gamma-1)/2`` input frames on each side.  On a time-sharded mesh each
rank holds ``T / time`` frames, so

* the ``(gamma-1)/2``-frame boundary slabs go to the time neighbours with
  ``batch_isend_irecv``; ranks at the sequence's ends take zeros, exactly
  the conv's zero padding;
* each rank runs a local *valid* conv (``padding=0``) on its frames and
  the received slabs, with the configured single-device impl: ``"pallas"``
  is the ``temporal_conv`` kernel, at ``padding=0``.

Under channel tensor parallelism the sharded step wraps this conv in
``train.row_parallel_temporal_conv``, which completes the partial ``C_in``
contraction over ``model``; the halo itself exchanges over ``time`` only.

With ``overlap=True`` the exchange is issued first, the interior output
frames, whose inputs are all local, are convolved while it is in flight,
and the two edge strips are convolved after it is waited on
(:func:`overlap_split`).  The JAX package's edges are the few frames
that read a halo; here each edge strip has at least ``EDGE_FRAMES``
output frames, and a shard too short for two such strips and an
interior takes the monolithic exchange.

The backward of the exchange (:class:`_HaloRecv`) sends each slab's
gradient back to the rank that owns those frames, the transpose that
``shard_map`` derives for ``ppermute`` in the JAX package.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from stgcn_tpu_torch.parallel.collectives import count, nbytes_of
from stgcn_tpu_torch.parallel.mesh import AXIS_TIME, Mesh

# The fewest output frames an edge strip gets.  The bf16 temporal kernels
# stage each 128-row tile's input frames line by line, so a conv whose
# lines hold few output frames stages several times the rows: below 9
# output frames at C=256 and stride 2 (5 at stride 1, 4 at C <= 128) no
# weight ring fits in shared memory beside them
# (kernels/temporal_block.py plan_mma_forward, plan_mma_backward).
EDGE_FRAMES = 16


def overlap_split(t: int, stride: int, gamma: int) -> tuple[int, int] | None:
    """``(left, right)``: the output frames of the two edge strips of a
    shard of ``t`` frames, each at least ``EDGE_FRAMES`` and all those
    that read a halo, the frames between them its interior; None where
    the shard has no room for an interior (or ``t`` does not divide by
    the stride): the monolithic exchange."""
    if t % stride:
        return None
    pad_l = (gamma - 1) // 2
    t_out = t // stride
    j_lo = -(-pad_l // stride)               # first interior output frame
    j_hi = (t + pad_l - gamma) // stride     # last one
    left = max(j_lo, EDGE_FRAMES)
    right = max(t_out - 1 - j_hi, EDGE_FRAMES)
    return (left, right) if left + right < t_out else None


def _exchange(left: torch.Tensor | None, right: torch.Tensor | None,
              recv_shapes, mesh: Mesh, group):
    """Issue the two-way exchange with the time neighbours: ``left`` goes
    to the previous rank and ``right`` to the next; returns ``(works,
    (from_prev, from_next), kept)``, zeros where there is no neighbour.
    ``kept`` holds the sent tensors until the works are waited on."""
    prev, nxt = mesh.neighbour(AXIS_TIME, -1), mesh.neighbour(AXIS_TIME, 1)
    from_prev = torch.zeros(recv_shapes[0], dtype=recv_shapes[2],
                            device=mesh.device)
    from_next = torch.zeros(recv_shapes[1], dtype=recv_shapes[2],
                            device=mesh.device)
    ops, kept = [], []
    if prev is not None:
        if left is not None:
            kept.append(left.contiguous())
            count("point-to-point", "time_halo", nbytes_of(kept[-1]))
            ops.append(dist.P2POp(dist.isend, kept[-1], prev, group))
        ops.append(dist.P2POp(dist.irecv, from_prev, prev, group))
    if nxt is not None:
        if right is not None:
            kept.append(right.contiguous())
            count("point-to-point", "time_halo", nbytes_of(kept[-1]))
            ops.append(dist.P2POp(dist.isend, kept[-1], nxt, group))
        ops.append(dist.P2POp(dist.irecv, from_next, nxt, group))
    works = dist.batch_isend_irecv(ops) if ops else []
    return works, (from_prev, from_next), kept


class _HaloRecv(torch.autograd.Function):
    """``(halo_l, halo_r)`` from an issued exchange: forward waits for it;
    backward sends ``d halo_l`` to the previous rank and ``d halo_r`` to
    the next, and adds what the neighbours send back to ``x``'s first
    ``pad_r`` and last ``pad_l`` frames."""

    @staticmethod
    def forward(ctx, x, pending, mesh, group, pad_l, pad_r, record):
        works, (halo_l, halo_r), _ = pending
        for w in works:
            w.wait()
        if record is not None:
            record.append("exchange_waited")
        ctx.mesh, ctx.group = mesh, group
        ctx.pads, ctx.x_shape = (pad_l, pad_r), x.shape
        return halo_l, halo_r

    @staticmethod
    def backward(ctx, g_l, g_r):
        pad_l, pad_r = ctx.pads
        n, t = ctx.x_shape[0], ctx.x_shape[1]
        rest = tuple(ctx.x_shape[2:])
        works, (d_first, d_last), _kept = _exchange(
            g_l, g_r, ((n, pad_r) + rest, (n, pad_l) + rest, g_l.dtype),
            ctx.mesh, ctx.group)
        for w in works:
            w.wait()
        dx = torch.zeros(ctx.x_shape, dtype=g_l.dtype, device=g_l.device)
        dx[:, :pad_r] += d_first
        dx[:, t - pad_l:] += d_last
        return dx, None, None, None, None, None, None


def make_halo_temporal_conv(mesh: Mesh, *, inner_impl: str = "conv",
                            overlap: bool = True,
                            record: list | None = None):
    """A temporal-conv callable for ``block_forward``: ``f(params, x, *,
    stride) -> y``.

    ``x`` is this rank's ``(N, T/time, V, C_in)`` shard (its ``V /
    model`` joints in joint mode; its ``C_in / model`` channels, with
    ``params["w"]`` sliced alike, under channel tensor parallelism, where
    the result is this rank's partial sum); the result is this rank's
    output frames.  ``inner_impl`` is the
    single-device impl each rank runs (``"pallas"``: the kernel).
    ``record``, when given, collects ``"exchange_issued"``,
    ``"interior_conv"``, ``"exchange_waited"`` and ``"edge_conv"`` in the
    order they happen, to show the overlap.
    """
    from stgcn_tpu_torch.ops.temporal_conv import temporal_conv

    time_group = mesh.group(AXIS_TIME)

    def note(event):
        if record is not None:
            record.append(event)

    def conv_fn(params: dict, x: torch.Tensor, *, stride: int = 1
                ) -> torch.Tensor:
        gamma = params["w"].shape[0]
        pad_l = (gamma - 1) // 2          # reference padding
        pad_r = gamma - 1 - pad_l

        def run_conv(x_h):
            return temporal_conv(params, x_h, stride=stride, padding=0,
                                 impl=inner_impl)

        t = x.shape[1]
        if t < max(pad_l, pad_r):
            raise ValueError(f"a time shard of {t} frames is shorter "
                             f"than the {gamma}-tap conv's halo")
        split = overlap_split(t, stride, gamma) if overlap else None
        rest = tuple(x.shape[2:])
        pending = _exchange(
            x[:, :pad_r], x[:, t - pad_l:],
            ((x.shape[0], pad_l) + rest, (x.shape[0], pad_r) + rest,
             x.dtype), mesh, time_group)
        note("exchange_issued")
        if split is not None:
            # 1) interior: local frames only, while the slabs travel
            left, right = split
            last = t // stride - right            # first right-edge frame
            y_int = run_conv(x[:, left * stride - pad_l:
                               (last - 1) * stride - pad_l + gamma])
            note("interior_conv")
        halo_l, halo_r = _HaloRecv.apply(x, pending, mesh, time_group,
                                         pad_l, pad_r, record)
        if split is None:
            return run_conv(torch.cat([halo_l, x, halo_r], dim=1))
        # 2) the edge strips, over a halo and the boundary frames
        need = (left - 1) * stride - pad_l + gamma
        y = torch.cat([
            run_conv(torch.cat([halo_l, x[:, :need]], dim=1)),
            y_int,
            run_conv(torch.cat([x[:, last * stride - pad_l:], halo_r],
                               dim=1))], dim=1)
        note("edge_conv")
        return y

    return conv_fn
