#!/usr/bin/env python3
"""Per-block and per-kernel device times of the port's bf16 spatial ops.

    python3 scripts/torch_spatial_profile.py [--batch 64] [--reps 5] [--out F]

For each block of DEFAULT_PLAN at T=304 (C_in -> C_out, T_in; random
inputs from a fixed seed, K=2 partitions, 25 joints), four ops of
``csrc/spatial_block.cu``: ``spatial_conv`` in both layouts (route A's
V-major and route B's ``(N, T, V, C)``), ``spatial_block`` (V-major, the
affine and ReLU, a trained graph) and ``spatial_block_save``.  Each op
gives its forward's CUDA-event ms, its backward's CUDA-event ms and, from
one ``torch.profiler`` window over ``--reps`` calls, the backward's device
ms a call by kernel: ``t`` (t_k and dA), ``dx``, ``dw``, ``reduce`` (the
passes that sum the partial slices) and ``other`` (the wrapper's casts and
copies), beside the raw kernel names.  Bounds are ``chip_smoke.py``'s
``spatial_cost`` and ``save_cost`` over the card's published peaks.
Prints one JSON line per block and op, a line of sums over the ten
blocks, then the card's name and power limit; ``--out`` also writes
every line to a file.  Needs a CUDA device; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

V, T = 25, 304


def event_ms(fn, reps: int) -> float:
    """CUDA-event ms a call of ``fn`` over ``reps`` calls, after one."""
    import torch

    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--batch", type=int, default=64)
    parser.add_argument("--reps", type=int, default=5)
    parser.add_argument("--out", default=None,
                        help="also write every line to this file")
    args = parser.parse_args()
    sink = open(args.out, "w") if args.out else None

    def say(line: str) -> None:
        print(line, flush=True)
        if sink:
            sink.write(line + "\n")
            sink.flush()

    import torch

    if not torch.cuda.is_available():
        print("torch_spatial_profile.py needs a CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from stgcn_tpu_torch.kernels import spatial_block as sb
    from stgcn_tpu_torch.kernels import spatial_conv as sc

    dev, bf = torch.device("cuda"), torch.bfloat16
    _, peak_flops, peak_bytes = cs.card_peaks(torch.cuda.get_device_name(0))
    gen = torch.Generator(device=dev).manual_seed(0)
    n = args.batch

    def r(*shape, scale=1.0, loc=0.0):
        return torch.randn(*shape, generator=gen, device=dev) * scale + loc

    def bound(cost) -> float:
        return cs.bound_ms(cost, peak_flops, peak_bytes)["bound_ms"]

    sums: dict = {}
    shapes = cs.plan_block_shapes()
    rows: dict = {}
    for block, (ci, co, _, t) in enumerate(shapes):
        key = (ci, co, t)
        if key not in rows:
            x = r(V, n, t, ci).to(bf)
            g = r(V, n, t, co).to(bf)
            s1, t1 = r(ci, scale=0.3, loc=1.0), r(ci, scale=0.2)
            w = r(ci, 2, co, scale=ci ** -0.5).to(bf)
            b = r(2, co, scale=0.1).to(bf)
            a = (torch.rand(2, V, V, generator=gen, device=dev) * 0.3).to(bf)
            _, y = sb.spatial_block_save_forward(x, s1, t1, w, b, a,
                                                 relu1=True)
            ops = {}
            for layout, vmajor in (("vntc", True), ("ntvc", False)):
                xl = (x.reshape(V, n * t, ci) if vmajor
                      else x.permute(1, 2, 0, 3).contiguous())
                gl = (g.reshape(V, n * t, co) if vmajor
                      else g.permute(1, 2, 0, 3).contiguous())
                ops[f"spatial_conv.{layout}"] = (
                    lambda xl=xl, v=vmajor: sc.spatial_conv_forward(
                        xl, w, b, a, vmajor=v),
                    lambda xl=xl, gl=gl, v=vmajor: sc.spatial_conv_backward(
                        xl, gl, w, b, a, vmajor=v),
                    cs.spatial_cost(n, t, ci, co, affine=False))
            ops["spatial_block"] = (
                lambda: sb.spatial_block_forward(x, s1, t1, w, b, a,
                                                 relu1=True),
                lambda: sb.spatial_block_backward(x, g, s1, t1, w, b, a,
                                                  relu1=True),
                cs.spatial_cost(n, t, ci, co))
            ops["spatial_block_save"] = (
                lambda: sb.spatial_block_save_forward(x, s1, t1, w, b, a,
                                                      relu1=True),
                lambda: sb.spatial_block_save_backward(x, g, y, s1, t1, w, a,
                                                       relu1=True),
                cs.save_cost(n, t, ci, co))
            rows[key] = {}
            for name, (fwd, bwd, cost) in ops.items():
                kernels = cs.kernel_ms_by_name(bwd, args.reps)
                rows[key][name] = {
                    "forward_ms": event_ms(fwd, args.reps),
                    "forward_bound_ms": bound(cost[0]),
                    "backward_ms": event_ms(bwd, args.reps),
                    "backward_bound_ms": bound(cost[1]),
                    "backward_by_part": cs.spatial_parts_ms(kernels),
                    "backward_kernels": kernels}
            del x, g, y
        for name, row in rows[key].items():
            say(json.dumps({"block": block, "c_in": ci, "c_out": co,
                            "t_in": t, "batch": n, "op": name, **row}))
            parts = row["backward_by_part"]
            tot = sums.setdefault(name, dict(
                forward_ms=0.0, forward_bound_ms=0.0, backward_ms=0.0,
                backward_bound_ms=0.0, **dict.fromkeys(parts, 0.0)))
            for k in ("forward_ms", "forward_bound_ms", "backward_ms",
                      "backward_bound_ms"):
                tot[k] += row[k]
            for p, ms in parts.items():
                tot[p] += ms
    say(json.dumps({"sums_over_ten_blocks": sums, "batch": n, "frames": T,
                    "dtype": "bfloat16"}))
    say(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
