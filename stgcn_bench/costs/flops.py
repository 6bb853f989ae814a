"""Operations a step of the network must do: a frozen copy of the
program's analytic count (``ModelFlops`` in its ``utils/profiling.py``),
which the benchmark's model-level utilization reads.  The program may
change its own; this one stays."""

from __future__ import annotations

import dataclasses


def spatial_conv_flops(n: int, t: int, v: int, c_in: int, c_out: int,
                       k: int) -> int:
    """Operations (2 per multiply-add) of the factored graph conv: the
    ``C_in -> K C_out`` expansion, then the ``K`` aggregations over
    ``V x V``."""
    stage1 = 2 * n * t * v * c_in * k * c_out
    stage2 = 2 * n * t * k * v * v * c_out
    return stage1 + stage2


@dataclasses.dataclass(frozen=True)
class ModelFlops:
    """Operations, skeleton edges aggregated and frames of one step."""

    fwd_flops: int          # a forward's operations; 3x that in training
    edges_processed: int
    frames: int

    @classmethod
    def of(cls, plan, *, c_in: int, gamma: int, classes: int, v: int,
           k: int, nnz: int, batch: int, t: int, train: bool = True
           ) -> "ModelFlops":
        """``nnz``: the nonzero entries of the ``(K, V, V)`` adjacency."""
        flops = edges = frames = 0
        c_prev, t_cur = c_in, t
        for c_out, stride in plan:
            flops += spatial_conv_flops(batch, t_cur, v, c_prev, c_out, k)
            edges += batch * t_cur * nnz
            frames += batch * t_cur
            t_out = ((t_cur + 2 * ((gamma - 1) // 2) - gamma) // stride + 1)
            flops += 2 * batch * t_out * v * gamma * c_out * c_out
            t_cur, c_prev = t_out, c_out
        flops += 2 * batch * c_prev * classes
        if train:
            flops *= 3      # forward and about twice that backward
        return cls(fwd_flops=flops, edges_processed=edges, frames=frames)
