"""The collectives of the parallel paths, as autograd functions with their
backwards stated.

The JAX package gets every collective from GSPMD or ``shard_map``
(``stgcn_tpu/parallel/train.py:1-19``); here each is explicit.  Two
conventions fix what a backward must do:

* Over ``data`` and ``time`` (and over ``model`` in joint mode) each rank's
  objective is its share of the loss, and the gradient of a parameter is
  the sum of the ranks' gradients.  A collective there is a function of
  every rank's tensors, and its backward is its exact adjoint:
  :func:`all_reduce_sum` (BN statistics, the pool) all-reduces in both
  directions, the SyncBatchNorm pattern; :func:`all_gather` sums the
  gathered gradients back to their owners.
* Over ``model`` in channel mode the objective is replicated, as in
  Megatron-LM: :func:`copy_to_group` (the column-parallel spatial conv's
  replicated input) is the identity forward and an all-reduce backward,
  :func:`reduce_from_group` (the row-parallel temporal conv's partial
  sums) the reverse, and :func:`scatter_to_group` (a replicated
  parameter used on this rank's channels) slices forward and all-gathers
  backward.

Every function issues its collective on any group, one rank included, so
a one-rank mesh runs the same code as a wider one.

Each collective is counted where it is issued (:data:`COUNTS`), by kind
(``all-reduce``, ``all-gather``, ``point-to-point``) and by what it moves
(``what``: ``gradients``, ``batchnorm``, ``time_halo``, ...), as the
kernel wrappers count their launches: a captured step adds the counts of
its capture again at every replay (``training/graphs.py``).
"""

from __future__ import annotations

import torch
import torch.distributed as dist


# (kind, what) -> [collectives issued, bytes a rank]: an all-reduce's
# buffer, an all-gather's gathered result (the shape the JAX package's
# scripts/scaling_bench.py reads off each collective in the compiled HLO),
# a point-to-point send's tensor
COUNTS: dict[tuple[str, str], list[int]] = {}


def count(kind: str, what: str, nbytes: int) -> None:
    """Count one collective of ``kind`` moving ``nbytes`` for ``what``."""
    entry = COUNTS.setdefault((kind, what), [0, 0])
    entry[0] += 1
    entry[1] += nbytes


def reset_counts() -> None:
    COUNTS.clear()


def read_counts() -> dict:
    """``{(kind, what): (count, bytes)}`` since the last reset."""
    return {k: tuple(v) for k, v in COUNTS.items()}


def counts_since(before: dict) -> dict:
    """What was counted after ``before`` (a :func:`read_counts`)."""
    grown = {}
    for key, (n, nbytes) in read_counts().items():
        n0, b0 = before.get(key, (0, 0))
        if (n, nbytes) != (n0, b0):
            grown[key] = (n - n0, nbytes - b0)
    return grown


def add_counts(counts: dict) -> None:
    """Add ``{(kind, what): (count, bytes)}`` (a replay's, or a
    :func:`read_counts` after a reset, to restore it)."""
    for (kind, what), (n, nbytes) in counts.items():
        entry = COUNTS.setdefault((kind, what), [0, 0])
        entry[0] += n
        entry[1] += nbytes


def nbytes_of(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def group_size(group) -> int:
    return dist.get_world_size(group)


def group_rank(group) -> int:
    return dist.get_rank(group)


def sum_over(t: torch.Tensor, group, what: str = "sum") -> torch.Tensor:
    """``t`` summed over the group's ranks, as a new tensor (no
    autograd)."""
    out = t.contiguous().clone()
    count("all-reduce", what, nbytes_of(out))
    dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
    return out


def _all_gather(t: torch.Tensor, group, dim: int,
                what: str = "gather") -> torch.Tensor:
    t = t.contiguous()
    parts = [torch.empty_like(t) for _ in range(group_size(group))]
    count("all-gather", what, nbytes_of(t) * len(parts))
    dist.all_gather(parts, t, group=group)
    return torch.cat(parts, dim=dim)


def rank_slice(t: torch.Tensor, group, dim: int) -> torch.Tensor:
    """This rank's equal share of ``t`` along ``dim``."""
    n = group_size(group)
    if t.shape[dim] % n:
        raise ValueError(f"dimension {dim} of size {t.shape[dim]} does not "
                         f"split over {n} ranks")
    return t.chunk(n, dim=dim)[group_rank(group)].contiguous()


class _AllReduceSum(torch.autograd.Function):
    """y = sum over the group's ranks; adjoint: the same sum of the
    ranks' gradients."""

    @staticmethod
    def forward(ctx, x, group, what):
        ctx.group, ctx.what = group, what
        return sum_over(x, group, what)

    @staticmethod
    def backward(ctx, g):
        return sum_over(g, ctx.group, ctx.what), None, None


class _CopyToGroup(torch.autograd.Function):
    """Megatron's f: identity forward, all-reduce backward."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x

    @staticmethod
    def backward(ctx, g):
        return sum_over(g, ctx.group, "tensor_parallel"), None


class _ReduceFromGroup(torch.autograd.Function):
    """Megatron's g: all-reduce forward, identity backward."""

    @staticmethod
    def forward(ctx, x, group):
        return sum_over(x, group, "tensor_parallel")

    @staticmethod
    def backward(ctx, g):
        return g, None


class _ScatterToGroup(torch.autograd.Function):
    """This rank's slice of a replicated tensor along ``dim``; backward:
    the slices' gradients all-gathered, so every rank holds the whole."""

    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return rank_slice(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return (_all_gather(g, ctx.group, ctx.dim, "tensor_parallel"), None,
                None)


class _AllGather(torch.autograd.Function):
    """Concatenation of every rank's tensor along ``dim``; adjoint: each
    piece's gradient summed over the ranks and returned to its owner (a
    reduce-scatter, written as an all-reduce and a slice, which every
    backend runs)."""

    @staticmethod
    def forward(ctx, x, group, dim, what):
        ctx.group, ctx.dim, ctx.what = group, dim, what
        return _all_gather(x, group, dim, what)

    @staticmethod
    def backward(ctx, g):
        return (rank_slice(sum_over(g, ctx.group, ctx.what), ctx.group,
                           ctx.dim), None, None, None)


def all_reduce_sum(x: torch.Tensor, group, what: str = "sum"
                   ) -> torch.Tensor:
    return _AllReduceSum.apply(x, group, what)


def copy_to_group(x: torch.Tensor, group) -> torch.Tensor:
    return _CopyToGroup.apply(x, group)


def reduce_from_group(x: torch.Tensor, group) -> torch.Tensor:
    return _ReduceFromGroup.apply(x, group)


def scatter_to_group(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    return _ScatterToGroup.apply(x, group, dim)


def all_gather(x: torch.Tensor, group, dim: int, what: str = "gather"
               ) -> torch.Tensor:
    return _AllGather.apply(x, group, dim, what)


@torch.no_grad()
def gather_tensor(x: torch.Tensor, group, dim: int, what: str = "gather"
                  ) -> torch.Tensor:
    """:func:`all_gather` outside autograd (weights, BN statistics)."""
    return _all_gather(x, group, dim, what)


@torch.no_grad()
def all_reduce_(tensors: list[torch.Tensor], group, what: str = "sum"
                ) -> None:
    """Sum each tensor over the group in place, as one flat buffer of each
    dtype (one collective a dtype, not one a tensor)."""
    by_dtype: dict = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for ts in by_dtype.values():
        flat = torch.cat([t.reshape(-1) for t in ts])
        count("all-reduce", what, nbytes_of(flat))
        dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=group)
        for t, f in zip(ts, flat.split([t.numel() for t in ts])):
            t.copy_(f.view_as(t))
