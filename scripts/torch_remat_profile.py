#!/usr/bin/env python3
"""Where a rematerialized train step's time goes, on one GPU.

    python3 scripts/torch_remat_profile.py [--out remat.jsonl]

bench.py's step (full-width DEFAULT_PLAN, distance partitioning, residual,
dropout 0.5, bf16, Adam, B=64, T=304) on route A (``layout="vntc"``) and
route B (``spatial_impl``/``temporal_impl="pallas"``), each without remat
and with it (route A ``remat=True``, route B ``remat=True`` and
"selective"), in turns (none, remat, remat, none).  For each: the step's
ms by CUDA events, its host ms (a step's wall clock with a synchronize),
the device's busy ms and idle share and the ten largest device ops by
``torch.profiler`` over three steps (busy: the device rows, kernels and
copies; the ops: the PyTorch ops that launched them), and the forward's
and backward's ms apart by CUDA events.  One JSON line each, also written
to ``--out``.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

B, T, V = 64, 304, 25
STEPS = 3
CASES = [("A", dict(layout="vntc"), False), ("A", dict(layout="vntc"), True),
         ("B", dict(spatial_impl="pallas", temporal_impl="pallas"), False),
         ("B", dict(spatial_impl="pallas", temporal_impl="pallas"), True),
         ("B", dict(spatial_impl="pallas", temporal_impl="pallas"),
          "selective")]


def device_ms(prof) -> tuple[float, list]:
    """Device ms of the profiled window, summed over its kernels and
    copies (the rows on the device, so that no op's time counts twice),
    and the ten PyTorch ops that launched the most of it."""
    import torch

    events = prof.key_averages()
    busy = sum(e.self_device_time_total for e in events
               if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3
    ops = [(e.key, e.self_device_time_total / 1e3) for e in events
           if e.device_type == torch.autograd.DeviceType.CPU
           and e.self_device_time_total > 0]
    ops.sort(key=lambda r: -r[1])
    return busy, ops[:10]


def measure(route, kw, remat, x, y) -> dict:
    import torch

    from stgcn_tpu_torch.graph.adjacency import Strategy
    from stgcn_tpu_torch.models.stgcn import DEFAULT_PLAN, STGCN, STGCNConfig
    from stgcn_tpu_torch.training.loop import forward_backward, make_train_step
    from stgcn_tpu_torch.training.optimizers import adam
    from stgcn_tpu_torch.training.train_state import create_train_state

    cfg = STGCNConfig(plan=DEFAULT_PLAN, strategy=Strategy.DISTANCE, d=1,
                      residual=True, dropout_rate=0.5,
                      compute_dtype=torch.bfloat16, remat=remat, **kw)
    model = STGCN(cfg, seed=0)
    ts = create_train_state(model, adam(1e-3), seed=0)
    step = make_train_step(model)
    for _ in range(2):
        step(ts, x, y)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    for _ in range(STEPS):
        step(ts, x, y)
    end.record()
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) * 1e3 / STEPS
    step_ms = start.elapsed_time(end) / STEPS

    # the forward and the backward apart, by events around each
    marks = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    fwd = bwd = 0.0
    for _ in range(STEPS):
        ts.optimizer.zero_grad(set_to_none=True)
        marks[0].record()
        logits, _ = model.apply(ts.params, ts.model_state, x, train=True,
                                generator=torch.Generator(
                                    device=x.device).manual_seed(1))
        loss = torch.nn.functional.cross_entropy(logits.float(), y)
        marks[1].record()
        loss.backward()
        marks[2].record()
        torch.cuda.synchronize()
        fwd += marks[0].elapsed_time(marks[1]) / STEPS
        bwd += marks[1].elapsed_time(marks[2]) / STEPS

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(STEPS):
            forward_backward(model, ts, x, y)
        torch.cuda.synchronize()
    busy, top = device_ms(prof)
    return dict(route=route, remat=remat, step_ms=step_ms,
                host_ms=host_ms, forward_ms=fwd, backward_ms=bwd,
                device_busy_ms_per_step=busy / STEPS,
                idle_share=1 - busy / STEPS / step_ms,
                top_ops_ms_per_step=[[k, ms / STEPS] for k, ms in top])


def main() -> int:
    import torch

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out", default="")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn(B, T, V, 2, generator=gen, device=dev)
    y = torch.randint(0, 6, (B,), generator=gen, device=dev)
    lines = []
    order = CASES[:2] + CASES[1:2] + CASES[:1] + CASES[2:] + CASES[2:3]
    for route, kw, remat in order:
        line = dict(measure(route, kw, remat, x, y), nvidia_smi=smi,
                    batch=B, frames=T, dtype="bfloat16")
        print(json.dumps(line), flush=True)
        lines.append(line)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text("".join(json.dumps(v) + "\n"
                                          for v in lines))
    return 0


if __name__ == "__main__":
    sys.exit(main())
