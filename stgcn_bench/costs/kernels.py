"""What each of the program's kernels must compute and move, and the least
time that takes on a card: frozen copies of the cost and bound functions
of the program's card check (``chip_smoke.py``), with the joint count as
an argument.  Each input byte is counted read once and each output byte
written once.  The roofline readers of ``stgcn_bench/metrics`` divide
these bounds by the kernels' measured time."""

from __future__ import annotations

# Published dense peaks of one card (NVIDIA data sheets, at the full power
# limit): bf16 tensor-core operations a second, HBM bytes a second.
PEAKS = {"H100 SXM": (989e12, 3.35e12), "H100 PCIe": (756e12, 2.0e12)}


def card_peaks(name: str) -> tuple[str, float, float]:
    """``(part, operations/s, bytes/s)`` of a card by its device name."""
    part = "H100 PCIe" if "PCIe" in name else "H100 SXM"
    return (part, *PEAKS[part])


def block_cost(n, t, c_in, c_out, stride, k=2, gamma=9, itemsize=2, v=25):
    """(operations, bytes) of one whole eval unit (``block_eval``)."""
    t_out = (t - 1) // stride + 1
    ops = (2 * n * t * v * c_in * k * c_out + 2 * n * t * k * v * v * c_out
           + 2 * n * t_out * v * gamma * c_out * c_out)
    if c_in != c_out or stride != 1:
        ops += 2 * n * t_out * v * c_in * c_out
    weights = (c_in * k * c_out + k * c_out + k * v * v + gamma * c_out ** 2
               + c_out + (c_in * c_out + c_out if c_in != c_out or stride != 1
                          else 0))
    data = (n * t * v * c_in + n * t_out * v * c_out + weights) * itemsize
    return ops, data + 4 * (2 * c_in + 3 * c_out)  # + f32 affines and bias


def spatial_cost(n, t, c_in, c_out, k=2, itemsize=2, affine=True, v=25):
    """((ops, bytes) forward, (ops, bytes) backward) of the spatial train
    op (affine, ReLU, graph conv), its adjacency gradient on."""
    m = n * t
    stage1 = 2 * m * v * c_in * k * c_out
    agg = 2 * m * k * v * v * c_out
    weights = (c_in * k * c_out + k * c_out + k * v * v) * itemsize
    if affine:
        weights += 2 * c_in * 4                 # f32 affine
    x_b, z_b = m * v * c_in * itemsize, m * v * c_out * itemsize
    return ((stage1 + agg, x_b + z_b + weights),
            (3 * stage1 + 2 * agg, 2 * x_b + z_b + 2 * weights))


def save_cost(n, t, c_in, c_out, k=2, itemsize=2, v=25):
    """``spatial_cost`` of the op that saves the expansion: the forward
    also writes it and the backward reads it instead of recomputing it."""
    (f_ops, f_bytes), (_, b_bytes) = spatial_cost(n, t, c_in, c_out, k,
                                                  itemsize, v=v)
    m = n * t
    y_b = k * m * v * c_out * itemsize
    b_ops = 2 * (2 * m * v * c_in * k * c_out) + 2 * (2 * m * k * v * v
                                                     * c_out)
    return (f_ops, f_bytes + y_b), (b_ops, b_bytes + y_b)


def temporal_cost(n, t, c, stride, gamma=9, itemsize=2, affine=True, v=25):
    """((ops, bytes) forward, (ops, bytes) backward) of the temporal train
    op (affine, ReLU, gamma x 1 conv)."""
    t_out = (t - 1) // stride + 1
    ops = 2 * n * t_out * v * gamma * c * c
    weights = gamma * c * c * itemsize + (3 if affine else 1) * c * 4
    z_b, u_b = n * t * v * c * itemsize, n * t_out * v * c * itemsize
    return (ops, z_b + u_b + weights), (2 * ops, 2 * z_b + u_b + 2 * weights)


def bound_ms(cost, peak_flops, peak_bytes) -> dict:
    """The least time for ``(ops, bytes)``: the larger of the operation
    and byte times, and which of the two it is."""
    ops, nbytes = cost
    t_ops, t_bytes = ops / peak_flops * 1e3, nbytes / peak_bytes * 1e3
    return dict(bound_ms=max(t_ops, t_bytes), ops_ms=t_ops,
                bytes_ms=t_bytes, gflop=ops / 1e9, mbytes=nbytes / 1e6)
