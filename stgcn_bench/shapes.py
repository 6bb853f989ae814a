"""Shapes of the cells' work, for the metric readers: each unit's widths
and frames, the bounds of the kernels' work from the frozen cost
functions (``stgcn_bench/costs``), and the card's peaks."""

from __future__ import annotations

from stgcn_bench.costs import kernels as costs
from stgcn_bench.costs.flops import ModelFlops
from stgcn_bench.reference.stgcn import bucket


def units(config: dict, frames: int) -> list[tuple[int, int, int, int]]:
    """``(c_in, c_out, stride, t_in)`` of every unit."""
    g = config["stgcn_config"]
    out, c_prev, t = [], g["c_in"], frames
    for c_out, stride in g["plan"]:
        out.append((c_prev, c_out, stride, t))
        c_prev, t = c_out, (t - 1) // stride + 1
    return out


def partitions(config: dict) -> int:
    g = config["stgcn_config"]
    return 3 if g["strategy"] == "spatial_configuration" else g["d"] + 1


def peaks(ctx: dict) -> tuple[float, float]:
    _, flops, nbytes = costs.card_peaks(ctx.get("device_name", ""))
    return flops, nbytes


def _ms(cost, pk) -> float:
    return costs.bound_ms(cost, *pk)["bound_ms"]


def spatial_bound_ms(config: dict, batch: int, frames: int, pk) -> float:
    """The least time of a train step's spatial ops, forward and backward:
    for each unit the lesser of the bounds of the two ways the op can keep
    the expansion for the adjacency gradient (recompute it, or save it)."""
    k, v = partitions(config), config["graph"]["num_joints"]
    total = 0.0
    for c_in, c_out, _, t in units(config, frames):
        recompute = sum(_ms(c, pk) for c in costs.spatial_cost(
            batch, t, c_in, c_out, k, v=v))
        save = sum(_ms(c, pk) for c in costs.save_cost(
            batch, t, c_in, c_out, k, v=v))
        total += min(recompute, save)
    return total


def temporal_bound_ms(config: dict, batch: int, frames: int, pk) -> float:
    """The least time of a train step's temporal ops, forward and
    backward."""
    g, v = config["stgcn_config"], config["graph"]["num_joints"]
    return sum(_ms(c, pk) for c_in, c_out, stride, t in units(config, frames)
               for c in costs.temporal_cost(batch, t, c_out, stride,
                                            g["gamma"], v=v))


def eval_bound_ms(config: dict, batch: int, frames: int, pk) -> float:
    """The least time of the eval units of one batch (``block_eval``)."""
    g, v = config["stgcn_config"], config["graph"]["num_joints"]
    k = partitions(config)
    return sum(_ms(costs.block_cost(batch, t, c_in, c_out, stride, k,
                                    g["gamma"], v=v), pk)
               for c_in, c_out, stride, t in units(config, frames))


def flops(config: dict, batch: int, frames: int, train: bool,
          nnz: int) -> int:
    g = config["stgcn_config"]
    return ModelFlops.of([tuple(p) for p in g["plan"]], c_in=g["c_in"],
                         gamma=g["gamma"], classes=g["num_classes"],
                         v=config["graph"]["num_joints"],
                         k=partitions(config), nnz=nnz, batch=batch,
                         t=frames, train=train).fwd_flops


def served_batches(traffic: dict, requests) -> list[tuple[int, int]]:
    """``(padded batch, frames)`` of every batch the requests make: the
    clips of a request grouped by bucket, ``max_batch`` at a time, each
    partial batch padded to ``max_batch``."""
    out = []
    mb = traffic["max_batch"]
    for _, lengths in requests:
        counts: dict = {}
        for n in lengths:
            b = bucket(int(n), traffic["buckets"])
            counts[b] = counts.get(b, 0) + 1
        for b, c in counts.items():
            full, rest = divmod(c, mb)
            out += [(mb, b)] * full
            if rest:
                out.append((_padded(rest, mb, traffic["batch_pad"]), b))
    return out


def _padded(n: int, max_batch: int, pad: str) -> int:
    """A partial batch's rows as the ``Predictor`` pads them."""
    if pad == "max":
        return max_batch
    if pad == "pow2":
        return min(1 << (n - 1).bit_length(), max_batch)
    return n
