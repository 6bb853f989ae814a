"""Explicit boundary-joint exchange for the joint-sharded spatial conv
(port of ``stgcn_tpu/parallel/spatial_halo.py``).

With ``shard_joints`` the joint axis V is split over the ``model`` axis.
The aggregation ``out[v] = sum_{k,w} A[k,v,w] * y[k,w]`` needs, on each
rank, only the columns ``w`` its output rows read: for a skeleton graph
the joints on the other side of a cut.  :func:`plan_boundary_exchange`
(the port's own copy of the JAX function) derives from the adjacency's
support which local joints each rank exports; the exchange is one
all-gather of only those joints' ``C_in`` features, issued before the
local aggregation, which does not depend on it.

The support is fixed in the fixed and mask modes (``A * M`` keeps the
zeros).  The trained-graph mode ``adjacency_mode="reference"`` can grow
it, so it takes the dense plan, every joint exported (the JAX package
keeps GSPMD there, ``stgcn_tpu/parallel/train.py:144-158``).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.distributed as dist

from stgcn_tpu_torch.parallel.collectives import (
    count,
    nbytes_of,
    rank_slice,
    sum_over,
)
from stgcn_tpu_torch.parallel.mesh import AXIS_MODEL, Mesh


@dataclasses.dataclass(frozen=True)
class ExchangePlan:
    """Static boundary-exchange plan derived from the adjacency support."""

    n_shards: int
    v_local: int
    b_max: int                 # exported joints per shard (padded uniform)
    sel: np.ndarray            # (n_shards, v_local, b_max) 0/1 export select
    idx_global: tuple          # (n_shards*b_max,) global joint id per slot
    recv_mask: np.ndarray      # (n_shards, n_shards*b_max) 1 = slot consumed
    exported_per_shard: tuple  # true (unpadded) export counts, for reporting

    @property
    def exchanged_joints(self) -> int:
        return int(sum(self.exported_per_shard))


def plan_boundary_exchange(adjacency: np.ndarray,
                           n_shards: int) -> ExchangePlan:
    """Derive the static exchange from ``|A| > 0`` support.

    Correct for any adjacency whose support cannot grow during training:
    the fixed adjacency and the mask mode.
    """
    A = np.asarray(adjacency)
    k, v, _ = A.shape
    if v % n_shards:
        raise ValueError(f"V={v} not divisible by {n_shards} shards")
    v_l = v // n_shards
    support = (np.abs(A) > 0).any(axis=0)  # (V, V): row v reads col w

    def shard_of(j):
        return j // v_l

    needed = []  # per shard: remote columns its rows read
    for s in range(n_shards):
        rows = support[s * v_l:(s + 1) * v_l]
        cols = set(np.nonzero(rows.any(axis=0))[0].tolist())
        needed.append({w for w in cols if shard_of(w) != s})
    contrib = []  # per shard: own joints some other shard reads
    for s in range(n_shards):
        own = set(range(s * v_l, (s + 1) * v_l))
        exported = sorted(own & set().union(
            *(needed[t] for t in range(n_shards) if t != s)) if n_shards > 1
            else set())
        contrib.append(exported)
    b_max = max((len(c) for c in contrib), default=0)
    b_max = max(b_max, 1)  # keep shapes static even with an empty cut

    sel = np.zeros((n_shards, v_l, b_max), np.float32)
    idx_global = np.zeros((n_shards, b_max), np.int64)
    valid = np.zeros((n_shards, b_max), bool)
    for s, exported in enumerate(contrib):
        for m, j in enumerate(exported):
            sel[s, j - s * v_l, m] = 1.0
            idx_global[s, m] = j
            valid[s, m] = True
        for m in range(len(exported), b_max):
            idx_global[s, m] = s * v_l  # arbitrary; masked out everywhere

    recv_mask = np.zeros((n_shards, n_shards * b_max), np.float32)
    for s in range(n_shards):
        for o in range(n_shards):
            if o == s:
                continue  # own columns live in the local diagonal block
            for m in range(b_max):
                if valid[o, m]:
                    recv_mask[s, o * b_max + m] = 1.0

    return ExchangePlan(
        n_shards=n_shards, v_local=v_l, b_max=b_max, sel=sel,
        idx_global=tuple(int(i) for i in idx_global.reshape(-1)),
        recv_mask=recv_mask,
        exported_per_shard=tuple(len(c) for c in contrib))


class _GatherRecv(torch.autograd.Function):
    """The gathered exports of an issued all-gather: forward waits for it
    and concatenates along the joints; backward sums each rank's slot
    gradients over the group and returns this rank's (a reduce-scatter,
    as an all-reduce and a slice)."""

    @staticmethod
    def forward(ctx, x_sel, pending, group):
        work, parts = pending
        work.wait()
        ctx.group = group
        return torch.cat(parts, dim=2)

    @staticmethod
    def backward(ctx, g):
        return (rank_slice(sum_over(g, ctx.group, "joint_halo"), ctx.group,
                           2), None, None)


def make_halo_spatial_conv(mesh: Mesh, adjacency, *, dense: bool = False):
    """Spatial conv for ``block_forward(spatial_impl=...)`` on joint
    shards: ``f(params, A_eff, x) -> y`` on this rank's ``(N, T', V/model,
    C_in)``.  Stage 1 is joint-local; the aggregation reads local columns
    from A's diagonal block and boundary columns from the all-gather of the
    exported joints' features.  ``A_eff`` (the mask-trained adjacency)
    flows through; only its support is fixed, from ``adjacency``, or all
    ones with ``dense``.
    """
    n_shards = mesh.shape[AXIS_MODEL]
    a_np = np.asarray(adjacency)
    plan = plan_boundary_exchange(np.ones_like(a_np) if dense else a_np,
                                  n_shards)
    group = mesh.group(AXIS_MODEL)
    s_idx = mesh.index(AXIS_MODEL)
    v_l = plan.v_local
    idx = torch.tensor(plan.idx_global, device=mesh.device)
    sel = torch.from_numpy(plan.sel[s_idx]).to(mesh.device)
    recv = torch.from_numpy(plan.recv_mask[s_idx]).to(mesh.device)

    def conv_fn(params: dict, a_eff: torch.Tensor, x: torch.Tensor
                ) -> torch.Tensor:
        w, b = params["w"], params["b"]
        acc = torch.promote_types(x.dtype, torch.float32)
        # 1) the boundary exports' all-gather, issued first
        x_sel = torch.einsum("ntvc,vb->ntbc", x, sel.to(x.dtype))
        parts = [torch.empty_like(x_sel) for _ in range(n_shards)]
        count("all-gather", "joint_halo", nbytes_of(x_sel) * n_shards)
        work = dist.all_gather(parts, x_sel.detach().contiguous(),
                               group=group, async_op=True)
        # 2) stage 1 and the diagonal block's aggregation, local only
        wa = w.to(acc)
        y_loc = torch.einsum("ntwi,iko->ntwko", x.to(acc), wa) + b.to(acc)
        a_rows = a_eff[:, s_idx * v_l:(s_idx + 1) * v_l]     # (K, v_l, V)
        a_loc = a_rows[:, :, s_idx * v_l:(s_idx + 1) * v_l]
        out = torch.einsum("kvw,ntwko->ntvo", a_loc.to(acc), y_loc)
        # 3) the boundary columns, from the gathered exports
        xg = _GatherRecv.apply(x_sel, (work, parts), group)
        y_bnd = torch.einsum("ntwi,iko->ntwko", xg.to(acc), wa) + b.to(acc)
        a_bnd = a_rows[:, :, idx].to(acc) * recv.to(acc)
        out = out + torch.einsum("kvB,ntBko->ntvo", a_bnd, y_bnd)
        return out.to(x.dtype)

    conv_fn.plan = plan
    return conv_fn
