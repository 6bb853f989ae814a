"""The numbers that decide ``correct``: what the timed path produced against
what the reference gives for the same inputs.

Training (the first three steps, which run through the window's own step
and feed before the window opens); a cell's limits file names which of
these it compares:

* ``loss_gap``: the largest ``|loss - loss_ref| / |loss_ref|`` of the
  three steps (``loss_first``: the first step's);
* ``grad_gap``: the first step's gradient as the optimizer got it, by the
  worst leaf: ``| |g| - |g_ref| |`` over the larger of ``|g_ref|`` and the
  median leaf's ``|g_ref|`` (``grad_median``: the median leaf's gap);
* ``change_gap``: the parameters' change over the three steps, by the
  worst leaf in the same way, over the elements whose first reference
  gradient is at least a thousandth of the median leaf's root mean square
  gradient (``change_median``: the median leaf's gap).  Rounding alone
  moves the others under Adam, whose first update is ``lr`` whatever the
  gradient's size: a spatial bias's first partition (the joint itself,
  whose normalized adjacency has equal row sums) adds a constant over the
  joints, which the BatchNorm after it takes out again;
* ``stats_gap``: the BatchNorm running statistics' change over the three
  steps (every unit's ``mean`` and ``var``), by the worst leaf in the same
  way.  Statistics that the step leaves where they were read 1.

Serving: ``prob_gap``, the largest ``|p - p_ref|`` over the classes of the
sampled clips.
"""

from __future__ import annotations

import torch

# an element whose first reference gradient is under this share of the
# median leaf's root mean square gradient is left out of the change
QUIET = 1e-3


def _norms(tree: dict) -> dict:
    return {k: float(torch.linalg.vector_norm(v.double())) for k, v in
            tree.items()}


def _median(values) -> float:
    vals = sorted(values)
    n = len(vals)
    return vals[n // 2] if n % 2 else 0.5 * (vals[n // 2 - 1] + vals[n // 2])


def leaf_gaps(got: dict, want: dict) -> dict:
    """Each leaf's ``| |got| - |want| |`` over the larger of ``|want|``
    and the median leaf's ``|want|``."""
    g, w = _norms(got), _norms(want)
    floor = _median(w.values())
    out = {}
    for k in w:
        denom = max(w[k], floor)
        out[k] = abs(g[k] - w[k]) / denom if denom > 0 else abs(g[k] - w[k])
    return out


def worst(gaps: dict) -> tuple[float, str]:
    """``(gap, leaf)`` of the worst leaf; a NaN counts as worst."""
    value, where = 0.0, ""
    for k, v in gaps.items():
        if not v <= value:
            value, where = v, k
    return value, where


def _change(after: dict, start: dict, keep: dict | None = None) -> dict:
    out = {}
    for k, v in after.items():
        d = v.double() - start[k].double()
        out[k] = d[keep[k]] if keep is not None else d
    return out


def train_numbers(prog: dict, ref: dict, start: dict, start_state: dict
                  ) -> dict:
    """``prog``: ``losses``, ``first_grads``, ``params`` and ``state`` (the
    running statistics, after the steps) of the program; ``ref`` the same
    of the reference; ``start`` and ``start_state`` the parameters and
    statistics both began from, each a ``{leaf path: tensor}``."""
    losses = [abs(a - b) / abs(b) for a, b in zip(prog["losses"],
                                                 ref["losses"])]
    if len(prog["losses"]) != len(ref["losses"]):
        losses.append(float("inf"))
    rms = [float(g.double().square().mean().sqrt())
           for g in ref["first_grads"].values()]
    tau = QUIET * _median(rms)
    keep = {k: g.abs() >= tau for k, g in ref["first_grads"].items()}
    moving = [k for k, m in keep.items() if bool(m.any())]
    grads = leaf_gaps(prog["first_grads"], ref["first_grads"])
    grads_moving = leaf_gaps(
        {k: prog["first_grads"][k][keep[k]] for k in moving},
        {k: ref["first_grads"][k][keep[k]] for k in moving})
    kept = {k: keep[k] for k in moving}
    change = leaf_gaps(
        _change({k: prog["params"][k] for k in moving}, start, kept),
        _change({k: ref["params"][k] for k in moving}, start, kept))
    stats = leaf_gaps(_change(prog["state"], start_state),
                      _change(ref["state"], start_state))
    grad_gap, grad_leaf = worst(grads)
    change_gap, change_leaf = worst(change)
    stats_gap, stats_leaf = worst(stats)

    def top(gaps):
        return sorted(gaps.items(), key=lambda kv: -kv[1])[:5]

    return {"loss_gap": max(losses), "loss_first": losses[0],
            "grad_gap": grad_gap, "grad_leaf": grad_leaf,
            "grad_gap_moving": worst(grads_moving)[0],
            "grad_median": _median(grads.values()),
            "change_gap": change_gap, "change_leaf": change_leaf,
            "change_median": _median(change.values()),
            "stats_gap": stats_gap, "stats_leaf": stats_leaf,
            "grad_top": top(grads), "change_top": top(change),
            "stats_top": top(stats),
            "leaves": {"grad": grads, "change": change, "stats": stats,
                       "ref_grad_norm": _norms(ref["first_grads"])},
            "quiet": {k: int((~m).sum()) for k, m in keep.items()
                      if not m.all()}}


def prob_gap(probs: torch.Tensor, ref: torch.Tensor) -> float:
    return float((probs.double() - ref.double()).abs().max())
