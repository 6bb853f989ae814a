#!/usr/bin/env python3
"""Benchmark of the PyTorch/CUDA port: the flagship ST-GCN's training
throughput on one GPU, and its serving rates.

    python3 bench_torch.py [--f32] [--no-b128] [--no-serving] [--device cpu]

Prints ONE JSON line with the keys of ``bench.py`` (the JAX package's
benchmark):

``value``
    sequences/s of the train step users run: ``make_train_step``'s
    captured step (a CUDA graph, replayed) on the fused kernels, bf16
    compute with float32 master weights and BN statistics (``--f32``: all
    float32, the parity configuration), distance partitioning d=1,
    residual, dropout 0.5, Adam 1e-3, B=64, T=304, 25 joints, 10 blocks;
``vs_baseline``
    that rate over the port's own op path (``block_impl="ops"``: cuBLAS
    and cuDNN), captured, at the same configuration, timed in turns with
    the fused step in this process;
``b128_sequences_per_s``, ``b128_vs_baseline``
    the fused step at B=128, over the same B=64 op-path rate;
``eval_forward_ms_fused``
    the median ms of the fused eval forward and softmax at B=64 on an
    input already on the device (``models/fused.fused_eval_forward``,
    one ``block_eval`` launch a block), captured as the JAX package jits
    it, two staged inputs in turn, 20 calls;
``serving_serial_seq_per_s``, ``serving_pipelined_seq_per_s``
    ``Predictor(buckets=(304,), max_batch=64)``: ``predict_batch`` one
    batch after another against ``predict_stream`` two batches in
    flight, 6 batches, two rounds of each in turn after one untimed
    round (the first round pins its host memory), medians;

and one line on stderr: each step's ms (the fused step run eagerly,
``capture=False``, timed in the same turns: ``eager_step_ms``), frames/s,
the card's name and power limit as ``nvidia-smi`` gives them, and
whether cuBLAS and cuDNN may use TF32.  PyTorch's defaults are kept, as
the CLI keeps them: cuDNN's float32 convolutions, which the op path runs
inside its bf16 blocks, then use TF32, which ``chip_smoke.py`` turns
off.  A row
that fails ends the run with a non-zero exit code.  ``--batch``,
``--frames`` and ``--steps`` make the run smaller (the metric's name says
the sizes); on the CPU every kernel runs its plain PyTorch version.
"""

from __future__ import annotations

import argparse
import gc
import json
import math
import subprocess
import sys
import time

import numpy as np
import torch

from stgcn_tpu_torch import resolve_device
from stgcn_tpu_torch.data.synthetic import random_batch
from stgcn_tpu_torch.graph.adjacency import Strategy
from stgcn_tpu_torch.models.fused import fused_eval_forward
from stgcn_tpu_torch.models.stgcn import STGCN, STGCNConfig
from stgcn_tpu_torch.serving import Predictor
from stgcn_tpu_torch.training.graphs import CapturedStep
from stgcn_tpu_torch.training.loop import make_train_step
from stgcn_tpu_torch.training.optimizers import adam
from stgcn_tpu_torch.training.train_state import create_train_state

BATCH, T = 64, 304
STEPS = 20            # timed steps of each train case
FORWARD_REPS = 20     # timed calls of the eval forward
SERVE_BATCHES = 6     # batches of each Predictor round
SERVE_ROUNDS = 2      # rounds of serial, then pipelined
# The block implementation, hard-coded to the race winner on the H100 as
# bench.py hard-codes the TPU's: captured, B=64, T=304, bf16, the fused
# step took 58.84 ms, route A 81.23, route B 82.93, the hybrid 170.69
# and the op path 273.85 (PERF.md section 5, the table of captured
# against eager steps: chip_smoke.py phase graph, run 9; NVIDIA H100 80GB
# HBM3, 700.00 W).
BLOCK_IMPL = "fused"


def model_config(precision: str, **kw) -> STGCNConfig:
    """bench.py's configuration, with ``kw`` replaced."""
    base = dict(strategy=Strategy.DISTANCE, d=1, residual=True,
                dropout_rate=0.5, block_impl=BLOCK_IMPL,
                compute_dtype=torch.bfloat16 if precision == "bf16"
                else None)
    return STGCNConfig(**{**base, **kw})


def metric_name(batch: int, frames: int, precision: str) -> str:
    """bench.py's metric name, at these sizes."""
    return f"train_throughput_stgcn10_b{batch}_t{frames}_{precision}"


def synchronize(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def release() -> None:
    """Between cases: drop what cycles hold (a graph held in one keeps
    the capture pool reserved) and the allocator's cached blocks."""
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def card(device: str | torch.device) -> str | None:
    """The card's name and power limit as nvidia-smi gives them, or None
    on the CPU."""
    if torch.device(device).type != "cuda":
        return None
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]


def train_case(precision: str, batch: int, frames: int,
               device: torch.device, *, block_impl: str = BLOCK_IMPL,
               capture: bool | None = None):
    """``run() -> metrics``: one train step of this configuration, on its
    own state and one batch from seed 0; ``run.step`` is the step and
    ``run.model`` the model."""
    model = STGCN(model_config(precision, block_impl=block_impl), seed=0)
    ts = create_train_state(model, adam(1e-3), seed=0, device=device)
    step = make_train_step(model, capture=capture)
    x, y = random_batch(np.random.default_rng(0), batch, frames)
    x, y = torch.from_numpy(x).to(device), torch.from_numpy(y).to(device)

    def run():
        return step(ts, x, y)

    run.step, run.model = step, model
    return run


def time_in_turns(cases: dict, steps: int, device: torch.device,
                  warmup: int = 2) -> dict:
    """Seconds a step of each case: ``warmup`` calls of each first (a
    captured step's warm-up and its capture), then ``steps`` steps of each
    in two turns, the second in the reverse order, each turn timed on the
    host's clock from one synchronisation to the next.  Raises if a loss
    is not finite."""
    for run in cases.values():
        for _ in range(warmup):
            run()
    total = dict.fromkeys(cases, 0.0)
    order = list(cases)
    for turn, n in enumerate((steps // 2, steps - steps // 2)):
        for name in (order if turn == 0 else order[::-1]):
            synchronize(device)
            start = time.perf_counter()
            for _ in range(n):
                out = cases[name]()
            synchronize(device)
            total[name] += time.perf_counter() - start
            if n and not math.isfinite(float(out["loss"])):
                raise FloatingPointError(f"{name}: loss {out['loss']}")
    return {name: s / steps for name, s in total.items()}


def bench_train(precision: str, batch: int, frames: int, steps: int,
                device: torch.device, b128: bool = True) -> dict:
    """Step seconds of the captured fused step, the same step eager and
    the captured op path, in turns at ``batch``; with ``b128``, of the
    captured fused step at twice the batch.  ``captured``: whether the
    fused step ran as a graph."""
    cases = {"fused": train_case(precision, batch, frames, device),
             "eager": train_case(precision, batch, frames, device,
                                 capture=False),
             "ops": train_case(precision, batch, frames, device,
                               block_impl="ops")}
    out = {"step_s": time_in_turns(cases, steps, device),
           "captured": cases["fused"].step.captured}
    del cases
    release()
    if b128:
        run = train_case(precision, 2 * batch, frames, device)
        out["b128_step_s"] = time_in_turns({"fused": run}, steps,
                                           device)["fused"]
        del run
        release()
    return out


def serving_model(precision: str, device: torch.device) -> STGCN:
    return STGCN(model_config(precision, dropout_rate=0.0),
                 seed=0).to(device).eval()


def device_forward(use_fused: bool) -> CapturedStep:
    """``f(model, x) -> probabilities`` of a batch already on the device:
    the fused eval forward (one ``block_eval`` launch a block) or the op
    path (``STGCN.forward``), then the softmax; captured on CUDA, as the
    JAX package jits its forward."""
    def body(model, x, *, generator=None):
        logits = (fused_eval_forward(model, *model.params_and_state(), x)
                  if use_fused else model(x))
        return torch.softmax(logits, dim=-1)

    return CapturedStep(
        body, state_tensors=lambda m: [*m.parameters(), *m.buffers()],
        name="fused eval forward" if use_fused else "eval forward")


def device_resident_s(model: STGCN, use_fused: bool, xs: list, reps: int,
                      device: torch.device) -> list[float]:
    """Seconds of each of ``reps`` forwards on the staged inputs ``xs`` in
    turn, each from an idle device to its output ready, sorted."""
    fwd = device_forward(use_fused)
    lat = []
    with torch.inference_mode():
        for x in xs:                  # the warm-up, then the capture
            fwd(model, x)
        for i in range(reps):
            synchronize(device)
            start = time.perf_counter()
            fwd(model, xs[i % len(xs)])
            synchronize(device)
            lat.append(time.perf_counter() - start)
    return sorted(lat)


def predictor_rates(pred: Predictor, xs: list, rounds: int
                    ) -> tuple[list, list]:
    """seq/s of ``predict_batch`` over ``xs`` one after another and of
    ``predict_stream`` over them, in alternating rounds."""
    serial, piped = [], []
    n = sum(x.shape[0] for x in xs)
    for _ in range(rounds):
        start = time.perf_counter()
        for x in xs:
            pred.predict_batch(x)
        serial.append(n / (time.perf_counter() - start))
        start = time.perf_counter()
        got = sum(o.shape[0] for o in pred.predict_stream(iter(xs)))
        piped.append(got / (time.perf_counter() - start))
    return serial, piped


def bench_serving(precision: str, batch: int, frames: int,
                  device: torch.device, reps: int = FORWARD_REPS,
                  n_batches: int = SERVE_BATCHES,
                  rounds: int = SERVE_ROUNDS) -> dict:
    """bench.py's three serving keys."""
    model = serving_model(precision, device)
    rng = np.random.default_rng(0)
    xs = [torch.from_numpy(rng.standard_normal(
        (batch, frames, 25, 2)).astype(np.float32)).to(device)
        for _ in range(2)]
    lat = device_resident_s(model, True, xs, reps, device)
    pred = Predictor(model, buckets=(frames,), max_batch=batch,
                     device=device)
    pred.warmup()
    batches = [rng.standard_normal((batch, frames, 25, 2)).astype(
        np.float32) for _ in range(n_batches)]
    predictor_rates(pred, batches, 1)
    serial, piped = predictor_rates(pred, batches, rounds)
    del pred
    release()
    return {"eval_forward_ms_fused": lat[len(lat) // 2] * 1e3,
            "serving_serial_seq_per_s": float(np.median(serial)),
            "serving_pipelined_seq_per_s": float(np.median(piped))}


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--f32", action="store_true",
                    help="all float32 (the parity configuration)")
    ap.add_argument("--no-b128", action="store_true")
    ap.add_argument("--no-serving", action="store_true")
    ap.add_argument("--device", default="cuda", help="cuda or cpu")
    ap.add_argument("--batch", type=int, default=BATCH)
    ap.add_argument("--frames", type=int, default=T)
    ap.add_argument("--steps", type=int, default=STEPS,
                    help="timed steps of each train case")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    precision = "f32" if args.f32 else "bf16"
    smi = card(device)

    train = bench_train(precision, args.batch, args.frames, args.steps,
                        device, b128=not args.no_b128)
    step_s = train["step_s"]
    rate = args.batch / step_s["fused"]
    base = args.batch / step_s["ops"]
    out = {"metric": metric_name(args.batch, args.frames, precision),
           "value": rate, "unit": "sequences/s", "vs_baseline": rate / base}
    if not args.no_b128:
        b128 = 2 * args.batch / train["b128_step_s"]
        out["b128_sequences_per_s"] = b128
        out["b128_vs_baseline"] = b128 / base
    if not args.no_serving:
        out.update(bench_serving(precision, args.batch, args.frames,
                                 device))
    print(json.dumps(out), flush=True)
    print(f"[bench] device={device.type} card={smi!r} precision={precision}"
          f" block_impl={BLOCK_IMPL} captured={train['captured']}"
          f" step_ms={step_s['fused'] * 1e3}"
          f" eager_step_ms={step_s['eager'] * 1e3}"
          f" ops_step_ms={step_s['ops'] * 1e3}"
          f" frames_per_s={rate * args.frames}"
          + (f" b128_step_ms={train['b128_step_s'] * 1e3}"
             if not args.no_b128 else "")
          + f" tf32_matmul={torch.backends.cuda.matmul.allow_tf32}"
            f" tf32_cudnn={torch.backends.cudnn.allow_tf32}",
          file=sys.stderr, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
