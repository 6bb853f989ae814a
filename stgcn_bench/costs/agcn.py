"""What a 2s-AGCN step must compute and move: the analytic operation count
of the whole step (for ``mfu.agcn.train``) and the least time of the
adaptive graph and per-sample aggregation ops (for
``roofline.adaptive.train``) and of the 9x1 temporal convs (for
``roofline.temporal.agcn.train``), from the configuration's shapes, counted
from the equations of ``model/agcn.py`` (2 operations a multiply-add).
Each input byte is counted read once and each output byte written once;
activations in bf16, the adjacency and its gradient in float32."""

from __future__ import annotations

from stgcn_bench.costs.kernels import bound_ms, temporal_cost

K = 3


def units(config: dict, frames: int) -> list[tuple[int, int, int, int]]:
    """``(c_in, c_out, stride, t_in)`` of every unit."""
    g = config["agcn_config"]
    out, c_prev, t = [], g["c_in"], frames
    for c_out, stride in g["plan"]:
        out.append((c_prev, c_out, stride, t))
        c_prev, t = c_out, (t - 1) // stride + 1
    return out


def unit_flops(n, t, c_in, c_out, stride, *, first: bool, ce: int,
               v: int = 25, gamma: int = 9) -> dict:
    """A unit's forward operations by part, ``n`` samples of ``t``
    frames."""
    t_out = (t - 1) // stride + 1
    out = {"embed": 2 * n * t * v * c_in * 2 * K * ce,
           "gram": 2 * n * K * v * v * ce * t,
           "aggregate": 2 * n * t * K * v * v * c_in,
           "wd": 2 * n * t * v * K * c_in * c_out,
           "temporal": 2 * n * t_out * v * gamma * c_out * c_out}
    if c_in != c_out:
        out["down"] = 2 * n * t * v * c_in * c_out
    if not first and (c_in != c_out or stride != 1):
        out["res"] = 2 * n * t_out * v * c_in * c_out
    return out


def step_flops(config: dict, batch: int, frames: int, bodies: int) -> int:
    """Operations of a train step: the forward's, times 3 (the backward
    about twice the forward), as the benchmark's ``ModelFlops`` counts."""
    g, v = config["agcn_config"], config["graph"]["num_joints"]
    n = batch * bodies
    total = 0
    for i, (c_in, c_out, stride, t) in enumerate(units(config, frames)):
        total += sum(unit_flops(
            n, t, c_in, c_out, stride, first=i == 0,
            ce=c_out // g["coff_embedding"], v=v, gamma=g["gamma"]).values())
    total += 2 * batch * g["plan"][-1][0] * g["num_classes"]
    return 3 * total


def adaptive_cost(n, t, c_in, ce, v=25, itemsize=2):
    """((ops, bytes) forward, (ops, bytes) backward) of the adaptive graph
    op: the embeddings and the Gram forward (x in, C out); dtheta/dphi,
    dx and dW backward (x and dC in, dx and dW out)."""
    embed = 2 * n * t * v * c_in * 2 * K * ce
    gram = 2 * n * K * v * v * ce * t
    x_b = n * t * v * c_in * itemsize
    c_b = n * K * v * v * 4
    w_b = (c_in + 1) * 2 * K * ce * itemsize
    return ((embed + gram, x_b + c_b + w_b),
            (2 * embed + 2 * gram, 2 * x_b + c_b + 2 * w_b))


def aggregate_cost(n, t, c_in, v=25, itemsize=2):
    """((ops, bytes) forward, (ops, bytes) backward) of the per-sample
    aggregation: z from x and the adjacency forward; dx and dA from x, dz
    and the adjacency backward."""
    ops = 2 * n * t * K * v * v * c_in
    x_b = n * t * v * c_in * itemsize
    a_b = n * K * v * v * 4
    return ((ops, x_b + K * x_b + a_b),
            (2 * ops, 2 * x_b + K * x_b + 2 * a_b))


def adaptive_bound_ms(config: dict, batch: int, frames: int, bodies: int,
                      peak_flops: float, peak_bytes: float) -> float:
    """The least time of a step's adaptive graph and aggregation ops,
    forward and backward, each op at the larger of its operation and byte
    times."""
    g, v = config["agcn_config"], config["graph"]["num_joints"]
    n = batch * bodies
    total = 0.0
    for c_in, c_out, _, t in units(config, frames):
        ce = c_out // g["coff_embedding"]
        for cost in (*adaptive_cost(n, t, c_in, ce, v),
                     *aggregate_cost(n, t, c_in, v)):
            total += bound_ms(cost, peak_flops, peak_bytes)["bound_ms"]
    return total


def temporal_bound_ms(config: dict, batch: int, frames: int, bodies: int,
                      peak_flops: float, peak_bytes: float) -> float:
    """The least time of a step's temporal ops (each unit's 9x1 conv of
    ``C_out`` channels, strided, with the op's affine prologue), forward
    and backward, as ``costs.kernels.temporal_cost`` counts one."""
    g, v = config["agcn_config"], config["graph"]["num_joints"]
    n = batch * bodies
    return sum(bound_ms(cost, peak_flops, peak_bytes)["bound_ms"]
               for _, c_out, stride, t in units(config, frames)
               for cost in temporal_cost(n, t, c_out, stride, g["gamma"],
                                         v=v))
