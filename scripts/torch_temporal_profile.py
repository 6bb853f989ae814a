#!/usr/bin/env python3
"""Per-kernel device times of the port's bf16 temporal ops on one GPU.

    python3 scripts/torch_temporal_profile.py [--batch 64] [--reps 5]

For each temporal shape of DEFAULT_PLAN at T=304 (C, stride, T_in), one
``torch.profiler`` window over ``--reps`` calls of each direction of
``temporal_block`` (V-major, the affine and ReLU) and ``temporal_conv``
(both layouts): the device ms a call of every kernel the op launches (the
forward GEMM; the dx GEMM, the dWt kernel and the reduction passes of
the backward), beside cuDNN's conv of the same shape.  Prints one JSON
line per shape and op, then the card's name and power limit.  Inputs are
random from a fixed seed.  Needs a CUDA device; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

V, T = 25, 304


def shapes() -> list[tuple[int, int, int]]:
    """(C, stride, T_in) of DEFAULT_PLAN's temporal convs, in plan order."""
    from stgcn_tpu_torch.models.stgcn import DEFAULT_PLAN

    out, t = [], T
    for c, stride in DEFAULT_PLAN:
        out.append((c, stride, t))
        t = (t - 1) // stride + 1
    return list(dict.fromkeys(out))


def kernel_ms(fn, reps: int) -> dict:
    """Device ms a call of each CUDA kernel ``fn`` launches."""
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
            out[ev.key[:90]] = total / reps / 1e3
    return out


def main() -> int:
    import torch

    from stgcn_tpu_torch.kernels import temporal_block as tb
    from stgcn_tpu_torch.kernels import temporal_conv as tc

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_temporal_profile.py needs a CUDA device", file=sys.stderr)
        return 1
    dev, bf = torch.device("cuda"), torch.bfloat16
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device=dev).manual_seed(0)
    n = args.batch

    def r(*shape, scale=1.0, loc=0.0):
        return torch.randn(*shape, generator=gen, device=dev) * scale + loc

    for c, stride, t in shapes():
        t_out = (t - 1) // stride + 1
        w = r(9, c, c, scale=(9 * c) ** -0.5)
        b = r(c, scale=0.1)
        z = r(V, n, t, c).to(bf)
        g = r(V, n, t_out, c).to(bf)
        s2, t2 = r(c, scale=0.3, loc=1.0), r(c, scale=0.2)
        wb = w.to(bf)
        ops = {"temporal_block": (
            lambda: tb.temporal_block_forward(z, s2, t2, wb, b, stride=stride,
                                              relu2=True),
            lambda: tb.temporal_block_backward(z, g, s2, t2, wb, b,
                                               stride=stride, relu2=True))}
        for layout, vmajor in (("vntc", True), ("ntvc", False)):
            x = (z.reshape(V * n, t, c) if vmajor
                 else z.permute(1, 2, 0, 3).contiguous())
            gx = (g.reshape(V * n, t_out, c) if vmajor
                  else g.permute(1, 2, 0, 3).contiguous())
            ops[f"temporal_conv.{layout}"] = (
                lambda x=x, v=vmajor: tc.temporal_conv_forward(
                    x, wb, b, stride=stride, vmajor=v),
                lambda x=x, gx=gx, v=vmajor: tc.temporal_conv_backward(
                    x, gx, wb, b, stride=stride, vmajor=v))
        # cuDNN's conv on the V-major shape (channels_last NCHW views)
        xc = z.reshape(V * n, t, c).unsqueeze(2).permute(0, 3, 1, 2)
        gc = g.reshape(V * n, t_out, c).unsqueeze(2).permute(0, 3, 1, 2)
        wc = wb.permute(2, 1, 0).unsqueeze(-1).contiguous(
            memory_format=torch.channels_last)
        ops["cudnn"] = (
            lambda: torch.nn.functional.conv2d(xc, wc, b.to(bf),
                                               stride=(stride, 1),
                                               padding=(4, 0)),
            lambda: torch.ops.aten.convolution_backward(
                gc, xc, wc, [c], [stride, 1], [4, 0], [1, 1], False, [0, 0],
                1, [True, True, True]))
        for name, (fwd, bwd) in ops.items():
            print(json.dumps({"c": c, "stride": stride, "t_in": t,
                              "batch": n, "op": name,
                              "forward": kernel_ms(fwd, args.reps),
                              "backward": kernel_ms(bwd, args.reps)}),
                  flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
