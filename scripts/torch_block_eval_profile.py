#!/usr/bin/env python3
"""Per-block and per-kernel device times of the port's bf16 ``block_eval``.

    python3 scripts/torch_block_eval_profile.py [--batch 64] [--reps 10]

For each block of DEFAULT_PLAN at T=304 (a random full-width model, the
residual network with distance partitioning, bf16), the CUDA-event ms of a
``block_eval`` call, of the port's split at the same shapes (the
``spatial_block`` forward, then the ``temporal_block`` forward, V-major,
without the shortcut) and, from one ``torch.profiler`` window over
``--reps`` calls, the device ms a call of every kernel ``block_eval``
launches (the spatial kernel, the projection pass, the taps, the
wrapper's casts).  Then the eval forward's ms and the sum of the blocks'.
Prints one JSON line per block, a summary line, then the card's name and
power limit.  Needs a CUDA device; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import re
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


def kernel_ms(fn, reps: int) -> dict:
    """Device ms a call of each CUDA kernel ``fn`` launches, by a short
    name (the kernel's own, with its template arguments)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {}
    for ev in prof.key_averages():
        total = (getattr(ev, "device_time_total", None)
                 or getattr(ev, "cuda_time_total", 0))
        if total:
            m = re.search(r"(\w+_kernel(<[^()]*>)?)", ev.key)
            name = m.group(1) if m else ev.key[:60]
            out[name] = out.get(name, 0.0) + total / reps / 1e3
    return out


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--batch", type=int, default=64)
    parser.add_argument("--reps", type=int, default=10)
    args = parser.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("torch_block_eval_profile.py needs a CUDA device",
              file=sys.stderr)
        return 1
    from stgcn_tpu_torch.graph.adjacency import Strategy
    from stgcn_tpu_torch.kernels.block_eval import block_eval
    from stgcn_tpu_torch.kernels.spatial_block import spatial_block_forward
    from stgcn_tpu_torch.kernels.temporal_block import temporal_block_forward
    from stgcn_tpu_torch.models.fused import (
        fused_block_args,
        fused_eval_forward,
    )
    from stgcn_tpu_torch.models.stgcn import DEFAULT_PLAN, STGCN, STGCNConfig

    dev = torch.device("cuda")
    cfg = STGCNConfig(plan=DEFAULT_PLAN, strategy=Strategy.DISTANCE, d=1,
                      residual=True, compute_dtype=torch.bfloat16)
    model = STGCN(cfg, seed=0).to(dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn(args.batch, T, V, 2, generator=gen,
                    device=dev).to(torch.bfloat16)
    h = x.permute(2, 0, 1, 3).contiguous()
    total = split_total = 0.0
    with torch.inference_mode():
        for i, blk in enumerate(model.conv):
            bp, bs = blk.params_and_state()
            kw = fused_block_args(bp, bs, model.adjacency, residual=True,
                                  stride=blk.stride)
            sw = {k: kw[k].to(h.dtype) for k in ("w", "b", "a", "wt")}

            def split():
                z = spatial_block_forward(h, kw["s1"], kw["t1"], sw["w"],
                                          sw["b"], sw["a"],
                                          relu1=kw["relu1"])
                return temporal_block_forward(z, kw["s2"], kw["t2"],
                                              sw["wt"], kw["bt"],
                                              stride=blk.stride, relu2=True)

            ms = event_ms(lambda: block_eval(h, **kw), args.reps)
            split_ms = event_ms(split, args.reps)
            total += ms
            split_total += split_ms
            print(json.dumps({
                "block": i, "c_in": h.shape[3], "c_out": cfg.plan[i][0],
                "stride": blk.stride, "t_in": h.shape[2], "ms": ms,
                "split_ms": split_ms,
                "kernels_ms": kernel_ms(lambda: block_eval(h, **kw),
                                        args.reps)}), flush=True)
            h = block_eval(h, **kw)
        weights = model.params_and_state()
        forward_ms = event_ms(lambda: fused_eval_forward(model, *weights, x),
                              args.reps)
    print(json.dumps({"batch": args.batch, "frames": T,
                      "block_eval_ms_per_forward": total,
                      "split_ms_per_forward": split_total,
                      "eval_forward_ms": forward_ms,
                      "rest_ms_per_forward": forward_ms - total}),
          flush=True)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
