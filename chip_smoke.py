#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``stgcn_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each printing JSON lines; the first failure ends the run with a
non-zero exit code:

1. device       -- a CUDA device is present; its name and power limit.
2. build        -- nvcc builds the kernel library from the port's ``csrc/``;
                   then ``sass``: ``cuobjdump -sass`` counts the tensor-core
                   instructions of every bf16 tensor-core kernel: HGMMA
                   (wgmma) in the temporal taps' GEMM and dWt kernels, in
                   block_eval's spatial and taps kernels and in the spatial
                   ops' forward, dx and dW kernels and their t kernel where
                   it recomputes y_k (every instantiation but the save
                   op's), HMMA (mma.sync) in the spatial forward and t
                   kernels (the aggregation, t_k and dA); the run fails if
                   one has none of its kind;
                   ``cuobjdump -res-usage`` gives each one's registers,
                   stack and spill bytes beside it.
3. kernel       -- ``block_eval`` against its plain PyTorch version on the
                   six block shapes of DEFAULT_PLAN at B=64, T=304 (float32
                   tightly, bfloat16 against a float32 oracle and, tightly,
                   against the plain version on the same bf16 inputs, and
                   each bf16 case launched twice on one input, bitwise
                   equal), order "post", masked lengths, an odd width
                   (C=40, T=37, strides 1 and 2) and C=36 (whose weights
                   TMA cannot read: the plain-load producers).
4. serve        -- a full-width ``Predictor`` (DEFAULT_PLAN, distance
                   partitioning, residual, bf16) answers three requests of
                   64-200 variable-length sequences through the kernel; the
                   launch count must be 10 per batch and the answers must
                   agree with the float32 op path.
5. time         -- CUDA-event times of each block's kernel and plain
                   version and of the port's split at the same shapes
                   (``split_ms``: the spatial_block forward, then the
                   temporal_block forward, V-major, without the shortcut),
                   of the eval forward and the rest of it beside the
                   kernels, and serving throughput.
6. train_kernel -- the train path's ``spatial_block`` and ``temporal_block``
                   ops, forward and backward kernels, against their plain
                   versions at the shapes of DEFAULT_PLAN's blocks 0-6 at
                   B=64, T=304 (float32 tightly, bfloat16 against a float32
                   oracle), plus the non-residual order, a fixed graph and
                   stride 2; both ops' bf16 tensor-core kernels also
                   tightly against the plain version on the same bf16
                   inputs, their backwards twice (bitwise equal), and at
                   an odd width (C=40, T=37; the temporal op at strides 1
                   and 2, and at C=36, whose weights TMA cannot read;
                   the spatial op at C=36 too, whose rows take plain loads).
   Then ``bn_moments``: the BatchNorm statistics op's kernels at the
                   cells' BatchNorm shapes (bf16 and float32) and at small
                   odd ones (float64 too) against float64 and the plain
                   versions, each twice bitwise, timed beside the bound.
   Then ``unit_tail``: the units' tail op's kernels bitwise against
                   PyTorch's chain and its autograd on the same draw at
                   the cells' unit shapes and small odd ones, timed beside
                   the bound (``--unit-tail`` below).
7. train        -- ``bench.py``'s train step through ``make_train_step``:
                   full-width DEFAULT_PLAN, bf16, dropout 0.5, the hybrid
                   with blocks 0-6 fused, Adam 1e-3, B=64, T=304; 28 op
                   launches a step; finite loss and weights, moving BN
                   statistics; the float32 kernel path's gradient against
                   the float32 op path's; the loss falling on a repeated
                   batch.
8. train_time   -- CUDA-event times of the train step (kernel path and op
                   path) and of each fused block's ops, forward and
                   backward, beside their plain versions and bounds, and
                   cuDNN's conv of the same temporal shape beside
                   temporal_block (``conv_library_ms``: without the affine,
                   so a yardstick and not that op's ``library_ms``).
9. conv_kernel  -- the standalone-conv routes' ``spatial_conv`` and
                   ``temporal_conv`` ops, forward and backward kernels, in
                   both layouts (V-major and (N, T, V, C)), against their
                   plain versions at the shapes of DEFAULT_PLAN's ten blocks
                   at B=64, T=304 (float32 tightly, bfloat16 against a
                   float32 oracle), plus a fixed graph; both ops' bf16
                   tensor-core kernels also tightly, their backwards twice,
                   and at an odd width (C=40, T=37, both layouts; the
                   temporal op at strides 1 and 2; both ops at C=36); the
                   temporal op also at ``padding=0`` (the time halo's
                   valid conv: 160 frames of C=64 at stride 1 and of C=128
                   at stride 2, and the odd width), both layouts and
                   dtypes.
10. route_train -- the train step of route A (``layout="vntc"``) and of
                   route B (``spatial_impl``/``temporal_impl="pallas"``):
                   bench.py's configuration on the op chain; 10 launches of
                   each conv op's forward and backward a step; finite loss
                   and weights, moving BN statistics; the float32 gradient
                   against the float32 and float64 op paths; the loss
                   falling on a repeated batch; the bf16 eval forward's
                   argmax against the float32 op path's, with and without
                   a time mask.
11. route_time  -- CUDA-event times of both routes' train steps and the op
                   path's, and of each conv op per block shape, direction
                   and layout beside its plain version, its bound,
                   cuDNN's conv (the temporal op) and the op path's own
                   graph conv (``op_ms``, the spatial op); the spatial
                   backward's device ms by kernel (t, dx, dW, the
                   reductions; ``torch.profiler``).
12. save_kernel -- ``spatial_block_save``'s forward and backward kernels
                   against their plain versions at blocks 8-9's shape
                   (float32 tightly, bfloat16 against a float32 oracle and
                   tightly against the plain version, the backward twice),
                   relu1 on and off, and at the odd widths (C=40 and 36);
                   its six gradients bitwise against ``spatial_block``'s
                   (the recompute kernel).
13. fused_train -- bench.py's step with every block fused
                   (``block_impl="fused"``): 8 launches of ``spatial_block``,
                   2 of ``spatial_block_save`` and 10 of ``temporal_block``
                   each way a step; finite values, moving BN statistics; a
                   fixed graph runs no save; the float32 gradient against
                   the float32 and float64 op paths; the loss falling on a
                   repeated batch; ``make_eval_step`` on "fused" (10
                   ``block_eval`` launches a batch) and "hybrid", argmax
                   against the float32 op path, with and without a time
                   mask.
14. checkpoint  -- the fused train state saved and restored into a fresh
                   one: eval logits bitwise equal, one more step from each
                   the same, and ``Predictor.from_checkpoint`` answering as
                   a ``Predictor`` over the saved weights.
15. fused_time  -- CUDA-event times of the fused step beside the op path,
                   the hybrid and routes A and B, of the save op at blocks
                   8-9 beside its plain version, the recompute op and its
                   bound (their backwards' device ms by kernel too), of the
                   fused step's kernels with cuDNN's conv
                   beside temporal_block, and of the fused eval step.
16. cli_train   -- the training entry point end to end:
                   ``stgcn_tpu_torch.cli.train.main`` in this process on a
                   synthetic KTH-format dataset written to disk (25
                   subjects, 599 sequences of 120-480 frames), through the
                   CLI's own flags at full width (bench.py's step with
                   every block fused, spatial-configuration partitioning
                   and a trained graph, bf16, B=64, fixed T=304): two
                   epochs with a checkpoint each (8/2/10 launches of
                   spatial_block / spatial_block_save / temporal_block
                   each way a train step, 10 block_eval launches a
                   validation or test batch; finite losses; ``ckpt_<step>``
                   with the JAX metadata), the same command resumed for a
                   third epoch (the step count continues), and the README
                   quick-start shape on the hybrid with bucketed batches
                   for two epochs, reported apart; then one fused epoch
                   with ``--train.check_invariants`` and one route A
                   epoch with ``--parallel.remat true`` (20 forward and
                   10 backward launches of each conv op a step, 10
                   forwards an eval batch), each captured and printing no
                   ``[graph] ... runs eagerly`` line.  Each epoch's steps are
                   measured by the work they did (rows x padded frames over
                   B x T) and by CUDA events around each step; its host
                   share is the epoch time no step covers, beside a step
                   of the CLI's own configuration timed in this phase.
17. tools       -- the user tools on cli_train's dataset, checkpoints
                   and logs: the C++ batch loader built by g++ in the run
                   from ``native/npy_loader.cc``, its fixed and bucket
                   batches over the train split bitwise the numpy ones,
                   and a fused CLI run on it (two epochs: the native line,
                   its launches, Trainer ms per step of work and host share
                   beside the numpy run's); ``cli.evaluate`` on the fused
                   checkpoint with ``--model.block_impl`` fused (10
                   ``block_eval`` launches a batch) and ops (none), rc 0,
                   confusion matrices within 1% of the sequences, each
                   saved as ``.npy``; ``cli.export``: the ``pt`` file's
                   ``Predictor.from_state_dict`` against
                   ``Predictor.from_checkpoint`` (float32, 1e-6), the
                   dynamic-batch ``pt2`` program on the card at B=64 and
                   17, T=304, argmax against the fused ``Predictor``
                   (>= 99%), its forward ms beside the eval forward's;
                   ``cli.preprocess`` openpose, distances, check and
                   reprocess on a JSON keypoint tree made from the seed
                   (six actions, person-less frames), the files equal to
                   the tree's keypoints; ``report.read_metric_csv`` on
                   cli_train's CSV logs (no plot: matplotlib is absent).
18. route_options -- at bench.py's width (B=64, T=304, bf16, dropout 0.5),
                   from a generator of its own: route A with ``remat=True``
                   and route B with ``remat="selective"`` each against the
                   same step without remat (same weights, batch and dropout
                   generator): gradients bitwise equal (or within 1e-6 of
                   the largest), 20 forward and 10 backward launches of
                   each conv op (10 and 10 without), step ms and peak
                   memory; the fused step with ``dropout_impl="bits8"``
                   (8/2/10 launches each way, finite, the loss falling over
                   10 steps, step ms beside exact dropout); the op path
                   with ``temporal_impl`` conv_vt, shift_sum and block, one
                   step each in float32 and bf16 without dropout: float32
                   gradients within 1e-2 of the largest of the float32
                   conv oracle's, bf16 ones no further from it than 3x the
                   bf16 conv path's (their share of the largest beside
                   2%), step ms.
20. parallel    -- the mesh paths of ``stgcn_tpu_torch.parallel`` (run
                   before 19).  (a) One rank, in this process, on NCCL
                   (``make_mesh(1, 1, 1)``), every collective issued:
                   ``Trainer(mesh=...)`` on bench.py's fused step (B=64,
                   T=304, bf16, dropout 0.5, Adam 1e-3), 8/2/10 launches of
                   spatial_block / spatial_block_save / temporal_block each
                   way a step over 10 steps on a repeated batch whose loss
                   falls; the float32 sharded gradient within 1e-6 of the
                   largest of the unsharded fused step's (and whether
                   bitwise equal); the sharded fused eval step, 10
                   ``block_eval`` launches a batch; ``Predictor(mesh=...)``
                   bitwise equal to ``Predictor``; the step's ms in turns
                   with the unsharded fused step's.  (b) Two ranks on the
                   one card, spawned: NCCL is probed first (all-reduce and
                   point-to-point); where it refuses two ranks on one
                   device the cases run on gloo, named on each line.
                   data=2 on the fused kernels at bench.py's width (32
                   sequences a rank, float32, dropout 0), 8/2/10 launches
                   each way per rank, BN statistics within 1e-5 of the
                   largest of the one-process B=64 step's; in bf16 the
                   loss falls over 10 steps, the step ms beside the
                   one-rank step's and the gradient all-reduce's ms.
                   data=2 on route B (10 ``spatial_conv`` and 10
                   ``temporal_conv`` launches each way per rank), model=2
                   on the op path and on route B (the temporal kernel row
                   parallel), and time=2 on route B (the halo runs
                   ``temporal_conv`` at ``padding=0`` on each rank's 152
                   frames), launches per rank.  Every case's float32
                   gradient is held against the float64 op path, no
                   further from it than 3x the one-process float32 step of
                   the same path; that step within 1e-3 of the largest
                   float64 gradient, and the two-rank gradient within
                   2e-3 of the largest of both; its distance from the
                   one-process float32 step is reported beside 1e-4 of the
                   largest (``within_two_rel``), which float32's other
                   summation orders do not meet.  Where the backend cannot
                   carry a case's collectives, its line says ``ran:
                   false`` with the error; the data-parallel cases must
                   run.  ``python3 chip_smoke.py --parallel-cards``
                   runs the same cases alone with one rank a card over
                   every card of the machine (up to 4) on NCCL, the fused,
                   model and time cases timed beside the one-process bf16
                   step.
21. graph       -- the compiled step (run after 18, before 20): every
                   step is captured in a CUDA graph per input signature on
                   the card by default (``training/graphs.CapturedStep``),
                   so every phase above drives captured steps; this one
                   holds them against the eager ones.  For the fused
                   step, routes A and B, the hybrid and the op path
                   (bench.py's step: bf16, B=64, T=304, dropout 0.5, Adam),
                   route A with ``remat=True``, route B with
                   ``remat="selective"`` and the checked fused step
                   (``make_checked_train_step``; each case's batch from a
                   generator of its own): a
                   captured step (a warm-up, then GRAPH_REPLAYS replays)
                   against as many eager steps and a second eager run, all
                   from the same weights, seed and batch, cuDNN
                   deterministic: parameters, moments, BN statistics,
                   gradients and losses bitwise equal where the two eager
                   runs are (else no further apart than they are); the
                   wrapper launches a replay counts (8/2/10 fused, 10/10
                   routes, 7/0/7 hybrid, none on the op path, 20 forward
                   and 10 backward of each conv op with remat) and every
                   eager step counts, and the kernels a
                   ``torch.profiler`` trace of one replay and of one eager
                   step counts by name, equal (a trace short of them is
                   taken again, at most TRACE_TRIES in all: a trace can
                   lose a record); each step's ms
                   captured (a step captured anew with cuDNN's default
                   algorithms) and eager in turns after warm steps, the
                   host's ms to issue it (and a replay alone) and the
                   device's idle share.  A remat case's state, gradients
                   and losses bitwise the captured step without remat's
                   (else its gradients within 1e-6 of the largest), its
                   graph's pool below that step's (each alone), the
                   three timed in turns.  The checked case: a replay with
                   a label of 6 and one with a NaN in the input raise
                   ``InvariantError`` naming the check (the NaN trips the
                   gradient's on the fused kernels, whose ReLU takes it
                   to 0), the state bitwise unchanged, the next good
                   replay the eager checked step's; its ms within 10% of
                   the unchecked captured step's, in turns.  A
                   ``Predictor`` with a graph a bucket (152 and 304 frames)
                   bitwise the eager one, ``predict_stream`` too, 10
                   ``block_eval`` launches a batch; serial and pipelined
                   seq/s captured and eager in alternating rounds.  In
                   phase 16 each CLI run must be captured, its per-step
                   losses differ and average to the printed epoch loss; its
                   graphs and peak memory are reported.  In phase 20 the
                   one-rank NCCL ``Trainer(mesh)`` step captured (its BN
                   and gradient all-reduces in the graph) bitwise the
                   captured unsharded step (bf16, dropout 0), a replay's
                   collective counts (``parallel/collectives.COUNTS``)
                   equal to an eager step's, both timed captured and
                   eager in turns; the mesh's route B step with
                   ``remat="selective"`` captured, bitwise the captured
                   unsharded remat step (dropout 0) and, with dropout
                   0.5, the captured mesh step without remat.
22. bench_tools -- the measurement tools (run after 21, before 20), each
                   through its entry point: ``bench_torch.main`` in this
                   process, its one JSON line with ``bench.py``'s keys,
                   finite, its fused step ms within 10% of phase 21's
                   captured fused step, the kernels launched exactly
                   (8/2/10 a train step, 10 ``block_eval`` a forward);
                   ``scripts/torch_serving_bench.py`` at batches 1 and 64;
                   ``scripts/torch_scaling_bench.py --cuda`` at B=64 (op
                   path and fused, captured, edges/s); and
                   ``scripts/torch_strategy_table.py --only distance
                   --epochs 2 --block-impl fused`` as a process of its
                   own: rc 0, finite losses, a parsed test accuracy.
                   ``--parallel-cards`` adds ``torch_scaling_bench.py
                   --cards N`` (strong and weak data=1, 2, 4) and
                   ``--collectives --production`` on data=N.
19. kernels     -- one line per kernel with its launches, error, times and
                   bound (block_eval's also with its ``split_ms``).

``{"phase": "run"}`` gives the whole run's seconds.  The last line is
``{"ok": true, "device": {...}}``.  Imports nothing of JAX.

``python3 chip_smoke.py --trace [--parallel-cards]`` checks the phase
marks of the captured train step alone (``utils/profiling.py``), on one
card or data parallel over the machine's cards (up to 4, NCCL, one rank
a card): three steps of the fused step at the KTH cell's width from one
state, with tracing off (the plain graph) and under ``torch.profiler``
(the marked graph, captured beside the plain one), whose loss,
parameters and BN statistics must be bitwise equal; the marked replays'
marks in the declared order; the phases' kernel ms summing to the
replays' non-NCCL kernel ms; every kernel that ``stgcn_bench``'s roofline
patterns claim inside its own phase (spatial or temporal).  Its
``{"phase": "trace"}`` line gives the per-phase ms a step, the markers'
device us a step, each call's host ms (the second captures both
graphs) and the BatchNorm statistics op's launches a replay, which must
be 2 a unit forward and one fewer backward, and the tail op's, one a unit
each way, its kernels all in the tail phase.

``python3 chip_smoke.py --bn-moments`` checks that op alone
(``kernels/bn_moments.py``): its kernels as in phase 6, the plain
formula's device operations by the aten op that launched them, its
launches a replay of the captured KTH and NTU train steps (20 + 19,
18 + 17), two runs of each bitwise, and none in a serving request.

``python3 chip_smoke.py --unit-tail`` checks the units' tail op alone
(``kernels/unit_tail.py``): its two kernels bitwise against PyTorch's
chain (the plain version) and its autograd on the same draw, at the ST-GCN
cells' unit shapes (bf16; float32 at one) and small odd ones (C=40, an
element count that is no multiple of 8, views off the 16-byte boundary),
dropout "exact" and "bits8" at rates 0.5 and 0.3 and none, with and
without the shortcut, each kernel twice bitwise; each kernel's device ms
through a CUDA graph beside its byte bound and the chain's; its launches
a replay of the captured KTH and NTU train steps (10 + 10, 9 + 9), two
runs of each bitwise; none in a serving request or a 2s-AGCN step.
"""

from __future__ import annotations

import copy
import dataclasses
import json
import re
import signal
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

SEED = 0
DEADLINE_S = 900
B, T, V = 64, 304, 25
# Published dense peaks (NVIDIA data sheets): bf16 tensor FLOP/s, HBM B/s.
PEAKS = {"H100 SXM": (989e12, 3.35e12), "H100 PCIe": (756e12, 2.0e12)}
# f32: elementwise, both sides summing in float32 in other orders.
F32_RTOL, F32_ATOL = 1e-4, 1e-4
# bf16 kernel against the float32 oracle: max error within 2% of the
# output's range (bf16 keeps 8 bits; h, y_k and z are rounded on the way).
BF16_REL = 2e-2
# bf16 tensor-core kernels against their plain version on the same
# bf16-rounded inputs (which sums in float32): bf16 outputs within one bf16
# ulp elementwise, |got - want| <= 2^-7 |want| + 1e-6 max|want| (the two
# round the same float32 sums, taken in other orders); float32 gradients
# within 1e-3 of the largest.
TIGHT_ULP = 2.0 ** -7
TIGHT_FLOOR = 1e-6
TIGHT_GRAD_REL = 1e-3
# block_eval rounds to bf16 three times inside (y_k, z, the projection):
# where the two float32 sums of one of those round to neighbouring bf16
# values, the output moves by a few ulps.  That happens to 0.01-0.02% of
# the outputs at DEFAULT_PLAN's shapes (none at the small odd width), so
# its tight check allows a share of 1e-3 beyond one ulp; the 2%-of-max
# check above still holds every element.
BLOCK_EVAL_TIGHT_SHARE = 1e-3
# The bf16 spatial kernels round to bf16 inside, as block_eval does: y_k
# in the forward, t_k in the backward (spatial_block.cu).  Where the two
# float32 sums of one of those round to neighbouring bf16 values, an
# output moves by an ulp or more: 0.005% of the outputs at most at
# DEFAULT_PLAN's shapes in the first card runs.  The tight check allows a
# share of 1e-3 beyond one ulp; the 2%-of-max check holds every element.
SPATIAL_TIGHT_SHARE = 1e-3
# the odd width of the tensor-core checks: channel tails and the parity
# split at both strides
ODD_C, ODD_T = 40, 37
# the wgmma kernels' second odd width (the temporal ops' and block_eval's):
# not a multiple of 8, so their weights cannot go through TMA (16-byte
# strides) and take the plain-load producer; drawn from a generator of its
# own
ODD_C8 = 36
# the bf16 kernels with mma.sync (HMMA), by patterns of their symbols'
# names: the spatial ops' forward (the aggregation) and t kernel (t_k and
# dA), which also run wgmma
MMA_KERNELS = ("spatial_wg_fwd_kernel", "spatial_wg_t_kernel")
# the bf16 kernels on wgmma (HGMMA): the temporal ops', block_eval's and
# the spatial ops'; the t kernel only where it recomputes y_k (SAVE false,
# the second template argument, mangled or not), the save op's reads it
WGMMA_KERNELS = ("tap_gemm_kernel", "tap_dwt_kernel",
                 "block_eval_spatial_kernel", "block_eval_taps_kernel",
                 "spatial_wg_fwd_kernel", "spatial_wg_dx_kernel",
                 "spatial_wg_dw_kernel",
                 r"spatial_wg_t_kernel(ILb[01]ELb0E|<(true|false), false)")
# the spatial backward's kernels by the pieces the time phases report
SPATIAL_PARTS = {"t": "_t_kernel", "dx": "_dx_kernel", "dw": "_dw_kernel",
                 "reduce": "reduce"}
# f32 whole-network check and bf16 serving check
FORWARD_REL = 1e-3
ARGMAX_AGREEMENT = 0.99


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def _deadline(signum, frame):
    raise TimeoutError(f"chip_smoke.py passed its {DEADLINE_S} s deadline")


def card_peaks(name: str) -> tuple[str, float, float]:
    part = "H100 PCIe" if "PCIe" in name else "H100 SXM"
    return (part, *PEAKS[part])


def cuda_time_ms(fn, reps: int = 3, warmup: int = 2) -> float:
    """CUDA-event ms of a call of ``fn``, over ``reps`` calls after
    ``warmup``: two by default, a captured step's warm-up and its
    capture."""
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def block_cost(n, t, c_in, c_out, stride, k=2, gamma=9, itemsize=2):
    """(operations, bytes) one block must do and move: each input read once,
    each output written once."""
    t_out = (t - 1) // stride + 1
    ops = (2 * n * t * V * c_in * k * c_out + 2 * n * t * k * V * V * c_out
           + 2 * n * t_out * V * gamma * c_out * c_out)
    if c_in != c_out or stride != 1:
        ops += 2 * n * t_out * V * c_in * c_out
    weights = (c_in * k * c_out + k * c_out + k * V * V + gamma * c_out ** 2
               + c_out + (c_in * c_out + c_out if c_in != c_out or stride != 1
                          else 0))
    data = (n * t * V * c_in + n * t_out * V * c_out + weights) * itemsize
    return ops, data + 4 * (2 * c_in + 3 * c_out)  # + f32 affines and bias


def random_block_args(gen, c_in, c_out, proj, device):
    import torch

    def r(*shape, scale=1.0, loc=0.0):
        return torch.randn(*shape, generator=gen, device=device) * scale + loc

    kw = dict(s1=r(c_in, scale=0.3, loc=1.0), t1=r(c_in, scale=0.2),
              w=r(c_in, 2, c_out, scale=c_in ** -0.5),
              b=r(2, c_out, scale=0.1),
              a=torch.rand(2, V, V, generator=gen, device=device) * 0.3,
              wt=r(9, c_out, c_out, scale=(9 * c_out) ** -0.5),
              bt=r(c_out, scale=0.1), s2=r(c_out, scale=0.3, loc=1.0),
              t2=r(c_out, scale=0.2))
    if proj:
        kw.update(wr=r(c_in, c_out, scale=c_in ** -0.5),
                  br=r(c_out, scale=0.1))
    return kw


def randomize_batchnorm(model, gen) -> None:
    """Running statistics and affines away from their fresh values, which
    would hide a wrong fold."""
    import torch

    with torch.no_grad():
        for block in model.conv:
            for bn in (block.batch_n, block.batch_n_2):
                c = bn.weight.shape[0]
                bn.running_mean.copy_(torch.randn(c, generator=gen) * 0.3)
                bn.running_var.copy_(torch.rand(c, generator=gen) * 1.5 + 0.5)
                bn.weight.copy_(1.0 + torch.randn(c, generator=gen) * 0.2)
                bn.bias.copy_(torch.randn(c, generator=gen) * 0.2)


# ---- the train path --------------------------------------------------------
# bench.py:65-66 runs blocks 0-6 of DEFAULT_PLAN fused on the TPU
FUSED_BLOCKS = (0, 1, 2, 3, 4, 5, 6)
TRAIN_STEPS = 3      # full-width steps driven on the main path
FALL_STEPS = 10      # steps of the falling-loss check
# float32 train kernels against their plain versions: max error within
# 1e-4 of the largest |value| (sums of up to 5e5 terms in other orders)
F32_TRAIN_REL = 1e-4
# float32 kernel path's full gradient against the float32 op path's: max
# error within 1e-2 of the largest gradient.  Ten blocks of BatchNorm over
# 4x64 frames amplify float32 rounding: each float32 path lies ~4e-4 of the
# largest gradient from the float64 op path on the CPU, and the kernels and
# cuDNN round differently.  The sharper check: the kernel path is no
# further from the float64 op path than GRAD_VS_F64 times the float32 op
# path is.
GRAD_REL = 1e-2
GRAD_VS_F64 = 3.0


def plan_block_shapes() -> list[tuple[int, int, int, int]]:
    """``(c_in, c_out, stride, t_in)`` of DEFAULT_PLAN's ten blocks."""
    from stgcn_tpu_torch.models.stgcn import DEFAULT_PLAN

    shapes, c_prev, t = [], 2, T
    for c_out, stride in DEFAULT_PLAN:
        shapes.append((c_prev, c_out, stride, t))
        c_prev, t = c_out, (t - 1) // stride + 1
    return shapes


def bench_config(**kw):
    """bench.py's train configuration (full-width DEFAULT_PLAN, distance
    partitioning, residual, dropout 0.5, bf16), with ``kw`` replaced."""
    import torch

    from stgcn_tpu_torch.graph.adjacency import Strategy
    from stgcn_tpu_torch.models.stgcn import DEFAULT_PLAN, STGCNConfig

    base = dict(plan=DEFAULT_PLAN, strategy=Strategy.DISTANCE, d=1,
                residual=True, dropout_rate=0.5,
                compute_dtype=torch.bfloat16)
    return STGCNConfig(**{**base, **kw})


def fused_block_shapes() -> list[tuple[int, int, int, int]]:
    """``(c_in, c_out, stride, t_in)`` of DEFAULT_PLAN's fused blocks."""
    return [s for i, s in enumerate(plan_block_shapes()) if i in FUSED_BLOCKS]


def spatial_cost(n, t, c_in, c_out, k=2, itemsize=2, affine=True):
    """((ops, bytes) forward, (ops, bytes) backward) of the spatial op, the
    operations counted as the JAX CostEstimates do
    (stgcn_tpu/kernels/block_fused.py:641-644, :715-719), need_da on;
    ``affine=False`` for the plain graph conv (spatial_conv.py:139, :259)."""
    m = n * t
    stage1 = 2 * m * V * c_in * k * c_out
    agg = 2 * m * k * V * V * c_out
    weights = (c_in * k * c_out + k * c_out + k * V * V) * itemsize
    if affine:
        weights += 2 * c_in * 4                 # f32 affine
    x_b, z_b = m * V * c_in * itemsize, m * V * c_out * itemsize
    return ((stage1 + agg, x_b + z_b + weights),
            (3 * stage1 + 2 * agg, 2 * x_b + z_b + 2 * weights))


def temporal_cost(n, t, c, stride, gamma=9, itemsize=2, affine=True):
    """((ops, bytes) forward, (ops, bytes) backward) of the temporal op
    (block_fused.py:1066-1069, :1126-1129); ``affine=False`` for the plain
    temporal conv, whose only float32 vector is the bias."""
    t_out = (t - 1) // stride + 1
    ops = 2 * n * t_out * V * gamma * c * c
    weights = gamma * c * c * itemsize + (3 if affine else 1) * c * 4
    z_b, u_b = n * t * V * c * itemsize, n * t_out * V * c * itemsize
    return (ops, z_b + u_b + weights), (2 * ops, 2 * z_b + u_b + 2 * weights)


def bound_ms(cost, peak_flops, peak_bytes) -> dict:
    """The least time for ``(ops, bytes)``: the larger of the operation
    and byte times, and which of the two it is."""
    ops, nbytes = cost
    t_ops, t_bytes = ops / peak_flops * 1e3, nbytes / peak_bytes * 1e3
    return dict(bound_ms=max(t_ops, t_bytes), ops_ms=t_ops,
                bytes_ms=t_bytes, gflop=ops / 1e9, mbytes=nbytes / 1e6)


def random_spatial(gen, n, t, c_in, c_out, dev):
    import torch

    def r(*shape, scale=1.0, loc=0.0):
        return torch.randn(*shape, generator=gen, device=dev) * scale + loc

    return dict(x=r(V, n, t, c_in), s1=r(c_in, scale=0.3, loc=1.0),
                t1=r(c_in, scale=0.2),
                w=r(c_in, 2, c_out, scale=c_in ** -0.5),
                b=r(2, c_out, scale=0.1),
                a=torch.rand(2, V, V, generator=gen, device=dev) * 0.3)


def random_temporal(gen, n, t, c, dev):
    import torch

    def r(*shape, scale=1.0, loc=0.0):
        return torch.randn(*shape, generator=gen, device=dev) * scale + loc

    return dict(z=r(V, n, t, c), s2=r(c, scale=0.3, loc=1.0),
                t2=r(c, scale=0.2), wt=r(9, c, c, scale=(9 * c) ** -0.5),
                bt=r(c, scale=0.1))


def as_dtype(kw: dict, dt, acts=("x", "z", "w", "b", "a", "wt")) -> dict:
    """Activations and weights in ``dt``; affines and the temporal bias stay
    float32, as the train path passes them."""
    return {k: v.to(dt) if k in acts else v for k, v in kw.items()}


def check_op(name, direction, got, want, dt, phase="train_kernel",
             allclose=False, **case) -> dict:
    """Max error of each output against the oracle, within the stated
    tolerance; raises if any is outside it.  ``allclose`` holds a float32
    output elementwise (rtol F32_RTOL, atol F32_ATOL) instead of against
    its largest value."""
    import torch

    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    elementwise = allclose and dt == torch.float32
    rel = F32_TRAIN_REL if dt == torch.float32 else BF16_REL
    worst = {"max_abs_err": 0.0, "max_rel_err": 0.0}
    for g, w in zip(got, want):
        err = (g.float() - w.float()).abs().max().item()
        scale = w.float().abs().max().item()
        ok = (torch.allclose(g.float(), w.float(), rtol=F32_RTOL,
                             atol=F32_ATOL) if elementwise
              else err <= rel * max(scale, 1e-30))
        if not ok:
            raise AssertionError(f"{name} {direction} disagrees with its "
                                 f"plain version: {case}, error {err}, "
                                 f"largest value {scale}")
        worst["max_abs_err"] = max(worst["max_abs_err"], err)
        worst["max_rel_err"] = max(worst["max_rel_err"],
                                   err / max(scale, 1e-30))
    tol = (f"allclose rtol={F32_RTOL} atol={F32_ATOL}" if elementwise
           else f"max_abs_err <= {rel} * max|oracle| per output")
    emit(phase, op=name, direction=direction,
         dtype=str(dt).removeprefix("torch."), **case, **worst,
         tolerance=tol, ok=True)
    return worst


def check_tight(name, direction, got, want, phase, share=0.0,
                **case) -> None:
    """A bf16 tensor-core kernel against its plain version on the same bf16
    inputs: bf16 outputs within one ulp elementwise (all but ``share`` of
    them), float32 gradients within TIGHT_GRAD_REL of the largest; raises
    if not."""
    import torch

    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    outside, values, worst, grads_ok = 0, 0, 0.0, True
    for g, w in zip(got, want):
        err = (g.float() - w.float()).abs()
        scale = w.float().abs().max().item()
        if g.dtype == torch.bfloat16:
            tol = TIGHT_ULP * w.float().abs() + TIGHT_FLOOR * scale
            outside += int((err > tol).sum().item())
            values += w.numel()
        else:
            grads_ok &= err.max().item() <= TIGHT_GRAD_REL * scale
        worst = max(worst, err.max().item() / max(scale, 1e-30))
    ok = grads_ok and outside <= share * values
    emit(phase, op=name, direction=direction, check="tight_bf16", **case,
         outside_one_ulp=outside, bf16_values=values, max_rel_err=worst,
         tolerance=(f"bf16 |err| <= {TIGHT_ULP} |plain| + {TIGHT_FLOOR} "
                    f"max|plain| (all but a share of {share}); f32 "
                    f"gradients <= {TIGHT_GRAD_REL} max|plain|"), ok=ok)
    if not ok:
        raise AssertionError(f"{name} {direction}: {outside} of {values} "
                             f"values beyond one bf16 ulp, or a gradient "
                             f"beyond {TIGHT_GRAD_REL}, {case}")


def check_repeat(name, first, second, phase, direction="backward",
                 **case) -> None:
    """Two runs of one bf16 kernel on the same inputs: every output bitwise
    equal (no atomics; partial sums are added in a fixed order)."""
    import torch

    same = all(torch.equal(a, b) for a, b in zip(first, second))
    emit(phase, op=name, direction=direction, check="determinism", **case,
         bitwise_equal=same, ok=same)
    if not same:
        raise AssertionError(f"{name}'s {direction} differs between two "
                             f"runs: {case}")


def sass_phase(lib_path) -> dict:
    """Tensor-core instructions in each bf16 tensor-core kernel of the built
    library, from ``cuobjdump -sass`` beside ``nvcc``: HGMMA (wgmma) in
    every WGMMA_KERNELS kernel, HMMA (mma.sync) in every MMA_KERNELS one;
    fails if a kernel has none of its kind, or if a family is missing."""
    from stgcn_tpu_torch.kernels import _build

    cuobjdump = Path(_build.find_nvcc()).parent / "cuobjdump"
    sass = subprocess.run([str(cuobjdump), "-sass", str(lib_path)],
                          capture_output=True, text=True, timeout=300,
                          check=True).stdout
    counts, current = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            current = m.group(1)
            counts[current] = {"HMMA": 0, "HGMMA": 0}
        elif current is not None:
            for op in ("HGMMA", "HMMA"):
                if op in line:
                    counts[current][op] += 1

    def family(names, op):
        return {k: v[op] for k, v in counts.items()
                if any(re.search(name, k) for name in names)}

    hmma, hgmma = family(MMA_KERNELS, "HMMA"), family(WGMMA_KERNELS, "HGMMA")
    ok = all(all(found.values())
             and all(any(re.search(name, k) for k in found)
                     for name in names)
             for found, names in ((hmma, MMA_KERNELS),
                                  (hgmma, WGMMA_KERNELS)))
    emit("sass", cuobjdump=str(cuobjdump), kernels=len(hmma) + len(hgmma),
         hmma=hmma, hgmma=hgmma,
         resources=resource_usage(cuobjdump, lib_path, {**hmma, **hgmma}),
         ok=ok)
    if not ok:
        raise AssertionError("a bf16 wgmma kernel has no HGMMA "
                             "instruction, a bf16 mma.sync kernel no HMMA, "
                             "or one is missing from the library")
    return {**hmma, **hgmma}


def kernel_ms_by_name(fn, reps: int = 3) -> dict:
    """Device ms a call of each CUDA kernel ``fn`` launches, by a short
    name (the kernel's own, with its template arguments), from one
    ``torch.profiler`` window over ``reps`` calls after one."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out: dict = {}
    for ev in prof.key_averages():
        total = (getattr(ev, "device_time_total", None)
                 or getattr(ev, "cuda_time_total", 0))
        if total:
            m = re.search(r"(\w+_kernel(<[^()]*>)?|\w*reduce\w*)", ev.key)
            name = m.group(1) if m else ev.key[:60]
            out[name] = out.get(name, 0.0) + total / reps / 1e3
    return out


def spatial_parts_ms(kernels: dict) -> dict:
    """A spatial backward's device ms by piece: t (t_k and dA), dx, dw,
    reduce (the ordered sums of the slices) and other (the wrapper's casts
    and copies)."""
    out = dict.fromkeys((*SPATIAL_PARTS, "other"), 0.0)
    for name, ms in kernels.items():
        part = next((p for p, key in SPATIAL_PARTS.items() if key in name),
                    "other")
        out[part] += ms
    return out


def resource_usage(cuobjdump, lib_path, kernels) -> dict:
    """Registers, stack and local (spill) bytes a thread of each of
    ``kernels``, from ``cuobjdump -res-usage``; empty where the tool
    prints nothing it can read (a report, not a check)."""
    out = subprocess.run([str(cuobjdump), "-res-usage", str(lib_path)],
                         capture_output=True, text=True, timeout=300).stdout
    usage, current = {}, None
    for line in out.splitlines():
        m = re.search(r"Function (\S+?):?$", line.strip())
        if m:
            current = m.group(1)
            continue
        m = re.search(r"REG:(\d+) STACK:(\d+) SHARED:\d+ LOCAL:(\d+)", line)
        if m and current in kernels:
            usage[current] = dict(zip(("registers", "stack", "local"),
                                      map(int, m.groups())))
    return usage


def train_kernel_phase(dev, gen, odd_gen) -> dict:
    """Each train op's forward and backward kernel against its plain
    version; returns the largest bf16 errors per (op, direction).  The
    odd-width cases draw from ``odd_gen``, so the other phases see the
    inputs they saw before those cases existed."""
    import torch

    from stgcn_tpu_torch.kernels import spatial_block as sb
    from stgcn_tpu_torch.kernels import temporal_block as tb

    worst: dict = {}

    def keep(key, res, dt):
        if dt == torch.bfloat16:
            cur = worst.setdefault(key, {"max_abs_err": 0.0,
                                         "max_rel_err": 0.0})
            for k in cur:
                cur[k] = max(cur[k], res[k])

    def spatial_case(ci, co, t, dt, relu1=True, need_da=True, rng=gen):
        kw = random_spatial(rng, B, t, ci, co, dev)
        k_in = as_dtype(kw, dt)
        oracle_in = {k: v.float() for k, v in k_in.items()}
        g = torch.randn(V, B, t, co, generator=rng, device=dev).to(dt)
        flags = dict(relu1=relu1)
        z = sb.spatial_block_forward(**k_in, **flags)
        grads = sb.spatial_block_backward(k_in["x"], g, **{
            k: k_in[k] for k in ("s1", "t1", "w", "b", "a")}, **flags,
            need_da=need_da)
        torch.cuda.synchronize()
        z_ref = sb.spatial_block_forward_reference(**oracle_in, **flags)
        g_ref = sb.spatial_block_backward_reference(
            oracle_in["x"], g.float(), **{
                k: oracle_in[k] for k in ("s1", "t1", "w", "b", "a")},
            **flags, need_da=need_da)
        case = dict(c_in=ci, c_out=co, t_in=t, relu1=relu1, need_da=need_da)
        keep(("spatial_block", "forward"),
             check_op("spatial_block", "forward", z, z_ref, dt, **case), dt)
        keep(("spatial_block", "backward"),
             check_op("spatial_block", "backward", grads, g_ref, dt, **case),
             dt)
        if dt == torch.bfloat16:
            tight_spatial_block(k_in, g, flags, need_da, case)

    def temporal_case(c, stride, t, dt, relu2=True, rng=gen):
        kw = random_temporal(rng, B, t, c, dev)
        if not relu2:       # the non-residual order's identity affine
            kw["s2"], kw["t2"] = torch.ones_like(kw["s2"]), torch.zeros_like(
                kw["t2"])
        k_in = as_dtype(kw, dt)
        oracle_in = {k: v.float() for k, v in k_in.items()}
        flags = dict(stride=stride, relu2=relu2)
        u = tb.temporal_block_forward(**k_in, **flags)
        g = torch.randn(u.shape, generator=rng, device=dev).to(dt)
        grads = tb.temporal_block_backward(k_in["z"], g, **{
            k: k_in[k] for k in ("s2", "t2", "wt", "bt")}, **flags)
        torch.cuda.synchronize()
        u_ref = tb.temporal_block_forward_reference(**oracle_in, **flags)
        g_ref = tb.temporal_block_backward_reference(
            oracle_in["z"], g.float(), **{
                k: oracle_in[k] for k in ("s2", "t2", "wt", "bt")}, **flags)
        case = dict(c=c, stride=stride, t_in=t, relu2=relu2)
        keep(("temporal_block", "forward"),
             check_op("temporal_block", "forward", u, u_ref, dt, **case), dt)
        keep(("temporal_block", "backward"),
             check_op("temporal_block", "backward", grads, g_ref, dt,
                      **case), dt)
        if dt == torch.bfloat16:
            # float32 weights (bf16 values): the kernel is the same and the
            # gradients come back unrounded
            rest = {k: k_in[k].float() for k in ("s2", "t2", "wt", "bt")}
            twice = [tb.temporal_block_backward(k_in["z"], g, **rest,
                                                **flags) for _ in range(2)]
            torch.cuda.synchronize()
            check_tight("temporal_block", "forward", u,
                        tb.temporal_block_forward_reference(**k_in, **flags),
                        "train_kernel", **case)
            check_tight("temporal_block", "backward", twice[0],
                        tb.temporal_block_backward_reference(
                            k_in["z"], g, **rest, **flags),
                        "train_kernel", **case)
            check_repeat("temporal_block", *twice, "train_kernel", **case)

    shapes = sorted(set(fused_block_shapes()))
    for dt in (torch.bfloat16, torch.float32):
        for ci, co, stride, t in shapes:
            spatial_case(ci, co, t, dt)
            temporal_case(co, stride, t, dt)
        spatial_case(64, 64, T, dt, relu1=False)        # non-residual order
        spatial_case(64, 64, T, dt, need_da=False)      # fixed graph
        temporal_case(128, 2, T, dt, relu2=False)       # identity affine
    for stride in (1, 2):                               # odd width
        temporal_case(ODD_C, stride, ODD_T, torch.bfloat16, rng=odd_gen)
    # the spatial op's odd width draws from a generator of its own, so the
    # cases above keep their inputs
    spatial_odd = torch.Generator(device=dev).manual_seed(SEED + 2)
    spatial_case(ODD_C, ODD_C, ODD_T, torch.bfloat16, rng=spatial_odd)
    # C=36 (weights without 16-byte strides), from a generator of its own
    odd8 = torch.Generator(device=dev).manual_seed(SEED + 6)
    for stride in (1, 2):
        temporal_case(ODD_C8, stride, ODD_T, torch.bfloat16, rng=odd8)
    # the spatial op at C=36 (rows without 16-byte strides: plain loads),
    # from a generator of its own
    spatial_odd8 = torch.Generator(device=dev).manual_seed(SEED + 12)
    spatial_case(ODD_C8, ODD_C8, ODD_T, torch.bfloat16, rng=spatial_odd8)
    return worst


def tight_spatial_block(k_in, g, flags, need_da, case) -> None:
    """``spatial_block``'s bf16 tensor-core kernels tightly against the
    plain version on the same bf16 inputs (all but SPATIAL_TIGHT_SHARE of
    the values within one ulp); the backward twice, bitwise."""
    import torch

    from stgcn_tpu_torch.kernels import spatial_block as sb

    # float32 weights (bf16 values): the kernel is the same and the
    # gradients come back unrounded
    rest = {k: k_in[k].float() for k in ("s1", "t1", "w", "b", "a")}
    z = sb.spatial_block_forward(**k_in, **flags)
    twice = [sb.spatial_block_backward(k_in["x"], g, **rest, **flags,
                                       need_da=need_da) for _ in range(2)]
    torch.cuda.synchronize()
    check_tight("spatial_block", "forward", z,
                sb.spatial_block_forward_reference(**k_in, **flags),
                "train_kernel", share=SPATIAL_TIGHT_SHARE, **case)
    check_tight("spatial_block", "backward", twice[0],
                sb.spatial_block_backward_reference(
                    k_in["x"], g, **rest, **flags, need_da=need_da),
                "train_kernel", share=SPATIAL_TIGHT_SHARE, **case)
    check_repeat("spatial_block", *twice, "train_kernel", **case)


def train_phase(dev, gen, peak_flops, peak_bytes) -> dict:
    """The main path (bench.py's train step) and its checks, then the train
    step and per-op times.  Returns what the kernels line needs."""
    import torch

    from stgcn_tpu_torch.kernels import spatial_block as sb
    from stgcn_tpu_torch.kernels import temporal_block as tb
    from stgcn_tpu_torch.models.convert import (
        params_from_jax,
        params_to_numpy,
    )
    from stgcn_tpu_torch.models.stgcn import STGCN
    from stgcn_tpu_torch.training.loop import make_train_step
    from stgcn_tpu_torch.training.metrics import cross_entropy
    from stgcn_tpu_torch.training.optimizers import adam
    from stgcn_tpu_torch.training.train_state import (
        create_train_state,
        train_state_from,
    )

    cfg = bench_config(block_impl="hybrid", fused_blocks=FUSED_BLOCKS)
    model = STGCN(cfg, seed=SEED)
    ts = create_train_state(model, adam(1e-3), seed=SEED)
    state0 = [{k: v["mean"].clone() for k, v in b.items()}
              for b in ts.model_state["blocks"]]
    x = torch.randn(B, T, V, 2, generator=gen, device=dev)
    y = torch.randint(0, cfg.num_classes, (B,), generator=gen, device=dev)
    step = make_train_step(model)
    counters = {"spatial_block.forward": sb.spatial_block_forward,
                "spatial_block.backward": sb.spatial_block_backward,
                "temporal_block.forward": tb.temporal_block_forward,
                "temporal_block.backward": tb.temporal_block_backward}

    # ---- the main path: counts set to 0 just before, read just after ----
    for fn in counters.values():
        fn.launches = 0
    start = time.perf_counter()
    losses = [float(step(ts, x, y)["loss"]) for _ in range(TRAIN_STEPS)]
    torch.cuda.synchronize()
    seconds = time.perf_counter() - start
    launches = {name: fn.launches for name, fn in counters.items()}

    per_step = len(FUSED_BLOCKS)
    finite = all(np.isfinite(losses)) and all(
        bool(torch.isfinite(p).all()) for p in ts.leaves())
    moved = all(not torch.equal(b[k]["mean"], s0[k])
                for b, s0 in zip(ts.model_state["blocks"], state0)
                for k in ("bn1", "bn2"))
    ok = finite and moved and all(
        n == per_step * TRAIN_STEPS for n in launches.values())
    emit("train", steps=TRAIN_STEPS, losses=losses, seconds=seconds,
         launches=launches, launches_per_step={
             k: v / TRAIN_STEPS for k, v in launches.items()},
         finite=finite, bn_statistics_moved=moved, batch=B, frames=T,
         dtype="bfloat16", fused_blocks=list(FUSED_BLOCKS), ok=ok)
    if not ok:
        raise AssertionError("the train step did not run 7 launches of each "
                             "op a step, or gave non-finite values, or left "
                             "the BN statistics where they were")

    # ---- float32 kernel path against the float32 op path, one gradient --
    cfg32 = dataclasses.replace(cfg, compute_dtype=None, dropout_rate=0.0)
    xs = torch.randn(4, 64, V, 2, generator=gen, device=dev)
    ys = torch.randint(0, cfg.num_classes, (4,), generator=gen, device=dev)
    # the same float32 weights for the three: as drawn, and cast to float64
    init = [params_to_numpy(t) for t in STGCN(cfg32).init_params(SEED)]
    grads = {}
    for impl in ("hybrid", "ops", "ops64"):
        dt = torch.float64 if impl == "ops64" else torch.float32
        m = STGCN(dataclasses.replace(
            cfg32, block_impl=impl.removesuffix("64"), dtype=dt)).to(dev)
        ts1 = train_state_from(*params_from_jax(*init, dtype=dt), adam(),
                               SEED, dev)
        logits, _ = m.apply(ts1.params, ts1.model_state, xs.to(dt),
                            train=True)
        grads[impl] = torch.autograd.grad(cross_entropy(logits, ys),
                                          ts1.leaves())

    def grad_diff(a, b):
        return max((p.double() - q.double()).abs().max().item()
                   for p, q in zip(grads[a], grads[b]))

    grad_err = grad_diff("hybrid", "ops")
    grad_scale = max(b.abs().max().item() for b in grads["ops"])
    kernel_vs_f64, ops_vs_f64 = (grad_diff("hybrid", "ops64"),
                                 grad_diff("ops", "ops64"))

    # ---- the loss falls on a repeated batch, dropout off ----------------
    m_fall = STGCN(dataclasses.replace(cfg, dropout_rate=0.0), seed=SEED)
    ts_fall = create_train_state(m_fall, adam(1e-3), seed=SEED)
    step_fall = make_train_step(m_fall)
    fall = [float(step_fall(ts_fall, x, y)["loss"])
            for _ in range(FALL_STEPS)]
    ok = (grad_err <= GRAD_REL * grad_scale
          and kernel_vs_f64 <= GRAD_VS_F64 * ops_vs_f64
          and fall[-1] < fall[0])
    emit("train", f32_hybrid_vs_ops_grad_max_abs_err=grad_err,
         f32_ops_grad_max_abs=grad_scale,
         f32_hybrid_vs_f64_ops_grad_max_abs_err=kernel_vs_f64,
         f32_ops_vs_f64_ops_grad_max_abs_err=ops_vs_f64,
         tolerance=(f"max_abs_err <= {GRAD_REL} * max|ops gradient|, and "
                    f"hybrid vs f64 <= {GRAD_VS_F64} * f32 ops vs f64"),
         repeated_batch_losses=fall, ok=ok)
    if not ok:
        raise AssertionError("the float32 kernel path's gradient disagrees "
                             "with the op path's, or the loss did not fall")

    # ---- train_time: steps, then each fused block's ops -----------------
    step_ms = cuda_time_ms(lambda: step(ts, x, y), reps=3)
    m_ops = STGCN(dataclasses.replace(cfg, block_impl="ops"), seed=SEED)
    ts_ops = create_train_state(m_ops, adam(1e-3), seed=SEED)
    step_ops = make_train_step(m_ops)
    ops_step_ms = cuda_time_ms(lambda: step_ops(ts_ops, x, y), reps=3)
    del ts_ops, ts_fall
    totals: dict = {}
    # cuDNN's conv of each block's temporal shape draws from a generator of
    # its own, so the kernels' inputs stay those of earlier runs
    lib_gen = torch.Generator(device=dev).manual_seed(SEED + 8)
    conv_lib: dict = {}
    for i, (ci, co, stride, t) in zip(FUSED_BLOCKS, fused_block_shapes()):
        sp = as_dtype(random_spatial(gen, B, t, ci, co, dev), torch.bfloat16)
        tp = as_dtype(random_temporal(gen, B, t, co, dev), torch.bfloat16)
        gz = torch.randn(V, B, t, co, generator=gen,
                         device=dev).to(torch.bfloat16)
        t_out = (t - 1) // stride + 1
        gu = torch.randn(V, B, t_out, co, generator=gen,
                         device=dev).to(torch.bfloat16)
        sp_rest = {k: sp[k] for k in ("s1", "t1", "w", "b", "a")}
        tp_rest = {k: tp[k] for k in ("s2", "t2", "wt", "bt")}
        fn = {
            ("spatial_block", "forward"): (
                lambda: sb.spatial_block_forward(**sp, relu1=True),
                lambda: sb.spatial_block_forward_reference(**sp, relu1=True)),
            ("spatial_block", "backward"): (
                lambda: sb.spatial_block_backward(sp["x"], gz, **sp_rest,
                                                  relu1=True),
                lambda: sb.spatial_block_backward_reference(
                    sp["x"], gz, **sp_rest, relu1=True)),
            ("temporal_block", "forward"): (
                lambda: tb.temporal_block_forward(**tp, stride=stride,
                                                  relu2=True),
                lambda: tb.temporal_block_forward_reference(
                    **tp, stride=stride, relu2=True)),
            ("temporal_block", "backward"): (
                lambda: tb.temporal_block_backward(tp["z"], gu, **tp_rest,
                                                   stride=stride, relu2=True),
                lambda: tb.temporal_block_backward_reference(
                    tp["z"], gu, **tp_rest, stride=stride, relu2=True)),
        }
        sp_cost = spatial_cost(B, t, ci, co)
        tp_cost = temporal_cost(B, t, co, stride)
        costs = {("spatial_block", "forward"): sp_cost[0],
                 ("spatial_block", "backward"): sp_cost[1],
                 ("temporal_block", "forward"): tp_cost[0],
                 ("temporal_block", "backward"): tp_cost[1]}
        row = {}
        for key, (kernel, plain) in fn.items():
            ms = cuda_time_ms(kernel)
            plain_ms = cuda_time_ms(plain)
            ops, nbytes = costs[key]
            t_ops, t_bytes = ops / peak_flops * 1e3, nbytes / peak_bytes * 1e3
            bound = max(t_ops, t_bytes)
            by = "operations" if t_ops >= t_bytes else "bytes"
            row[".".join(key)] = dict(ms=ms, plain_ms=plain_ms,
                                      bound_ms=bound, bound_by=by,
                                      gflop=ops / 1e9, mbytes=nbytes / 1e6)
            tot = totals.setdefault(key, dict(ms=0.0, plain_ms=0.0,
                                              bound_ms=0.0, ops_ms=0.0,
                                              bytes_ms=0.0))
            for name, val in (("ms", ms), ("plain_ms", plain_ms),
                              ("bound_ms", bound), ("ops_ms", t_ops),
                              ("bytes_ms", t_bytes)):
                tot[name] += val
        for direction, ms in temporal_conv_library_ms(lib_gen, co, stride, t,
                                                      dev).items():
            row[f"temporal_block.{direction}"]["conv_library_ms"] = ms
            conv_lib[direction] = conv_lib.get(direction, 0.0) + ms
        emit("train_time", block=i, c_in=ci, c_out=co, stride=stride,
             t_in=t, **row)
    emit("train_time", train_step_ms=step_ms,
         train_sequences_per_s=B / step_ms * 1e3,
         op_path_train_step_ms=ops_step_ms,
         op_path_train_sequences_per_s=B / ops_step_ms * 1e3,
         kernel_ms_per_step={".".join(k): v["ms"] for k, v in totals.items()},
         plain_ms_per_step={".".join(k): v["plain_ms"]
                            for k, v in totals.items()},
         bound_ms_per_step={".".join(k): v["bound_ms"]
                            for k, v in totals.items()},
         conv_library_ms_per_step={f"temporal_block.{d}": v
                                   for d, v in conv_lib.items()},
         batch=B, frames=T, dtype="bfloat16")
    return {"launches": launches, "totals": totals, "conv_library": conv_lib}


def temporal_conv_library_ms(gen, c, stride, t, dev) -> dict:
    """direction -> CUDA-event ms of cuDNN's conv (``library_fns``) at the
    temporal op's shape of one block, V-major, bf16: the plain temporal
    conv without ``temporal_block``'s affine and ReLU, so a yardstick beside
    that op (``conv_library_ms``), not its ``library_ms``."""
    import torch

    args, g = random_conv(gen, "temporal_conv", c, c, stride, t, True, dev)
    args = {k: v.to(torch.bfloat16) for k, v in args.items()}
    lib = library_fns(args, g.to(torch.bfloat16), True, stride)
    return {d: cuda_time_ms(fn) for d, fn in lib.items()}


def bound_kind(ops_ms: float, bytes_ms: float) -> str:
    return "operations" if ops_ms >= bytes_ms else "bytes"


def train_kernel_entry(name, source, replaces, launches, errors,
                       totals) -> dict:
    """The kernels-line entry of one train op: forward plus backward per
    step, with each direction beside it.  ``bound_by`` says which of the
    summed operation and byte times is larger."""
    parts = {}
    for direction in ("forward", "backward"):
        tot = totals[(name, direction)]
        parts[direction] = {
            "launches": launches[f"{name}.{direction}"],
            **errors[(name, direction)],
            "ms": tot["ms"], "plain_ms": tot["plain_ms"],
            "bound_ms": tot["bound_ms"],
            "bound_by": bound_kind(tot["ops_ms"], tot["bytes_ms"])}
    both = [totals[(name, d)] for d in ("forward", "backward")]
    return {
        "name": name, "route": "cuda", "source": source,
        "replaces": replaces,
        "launches": sum(p["launches"] for p in parts.values()),
        "max_abs_err": max(p["max_abs_err"] for p in parts.values()),
        "max_rel_err": max(p["max_rel_err"] for p in parts.values()),
        "ms": sum(p["ms"] for p in parts.values()),
        "plain_ms": sum(p["plain_ms"] for p in parts.values()),
        "bound_ms": sum(p["bound_ms"] for p in parts.values()),
        "bound_by": bound_kind(sum(t["ops_ms"] for t in both),
                               sum(t["bytes_ms"] for t in both)),
        # no single PyTorch call computes the affine(+ReLU) with the graph
        # conv, or with the temporal conv, and their gradients
        "library_ms": None,
        **parts,
    }


# ---- the standalone-conv routes --------------------------------------------
# route A: the V-major route; route B: (N, T, V, C) on the standalone kernels
ROUTES = {"A": dict(layout="vntc"),
          "B": dict(spatial_impl="pallas", temporal_impl="pallas")}
ROUTE_STEPS = 2      # full-width steps of each route on the main path
EVAL_BATCHES = 4     # batches of B sequences in each argmax check
CONV_OPS = ("spatial_conv", "temporal_conv")
LAYOUTS = {"vntc": True, "ntvc": False}      # layout name -> vmajor


def conv_counters() -> dict:
    from stgcn_tpu_torch.kernels import spatial_conv as sc
    from stgcn_tpu_torch.kernels import temporal_conv as tc

    return {"spatial_conv.forward": sc.spatial_conv_forward,
            "spatial_conv.backward": sc.spatial_conv_backward,
            "temporal_conv.forward": tc.temporal_conv_forward,
            "temporal_conv.backward": tc.temporal_conv_backward}


def random_conv(gen, op, ci, co, stride, t, vmajor, dev, padding=None):
    """Inputs of one conv op at a block's shape in one layout, float32, and
    a cotangent of its output (the temporal op's with ``padding`` frames of
    zeros, ``None`` the same padding)."""
    import torch

    def r(*shape, scale=1.0):
        return torch.randn(*shape, generator=gen, device=dev) * scale

    if op == "spatial_conv":
        x = r(*((V, B * t, ci) if vmajor else (B, t, V, ci)))
        args = dict(x=x, w=r(ci, 2, co, scale=ci ** -0.5),
                    b=r(2, co, scale=0.1),
                    a=torch.rand(2, V, V, generator=gen, device=dev) * 0.3)
        return args, r(*x.shape[:-1], co)
    pad = 4 if padding is None else padding
    t_out = (t + 2 * pad - 9) // stride + 1
    args = dict(x=r(*((V * B, t, co) if vmajor else (B, t, V, co))),
                w=r(9, co, co, scale=(9 * co) ** -0.5), b=r(co, scale=0.1))
    return args, r(*((V * B, t_out, co) if vmajor else (B, t_out, V, co)))


def conv_fns(op, vmajor, stride, need_da=True, padding=None) -> dict:
    """direction -> (kernel, plain version) of one op in one layout, each a
    function of (inputs, cotangent)."""
    from stgcn_tpu_torch.kernels import spatial_conv as sc
    from stgcn_tpu_torch.kernels import temporal_conv as tc

    if op == "spatial_conv":
        bw = dict(vmajor=vmajor, need_da=need_da)
        return {
            "forward": (
                lambda a, g: sc.spatial_conv_forward(**a, vmajor=vmajor),
                lambda a, g: sc.spatial_conv_forward_reference(
                    **a, vmajor=vmajor)),
            "backward": (
                lambda a, g: sc.spatial_conv_backward(
                    a["x"], g, a["w"], a["b"], a["a"], **bw),
                lambda a, g: sc.spatial_conv_backward_reference(
                    a["x"], g, a["w"], a["b"], a["a"], **bw))}
    fl = dict(stride=stride, vmajor=vmajor, padding=padding)
    return {
        "forward": (lambda a, g: tc.temporal_conv_forward(**a, **fl),
                    lambda a, g: tc.temporal_conv_forward_reference(**a, **fl)),
        "backward": (
            lambda a, g: tc.temporal_conv_backward(a["x"], g, a["w"], a["b"],
                                                   **fl),
            lambda a, g: tc.temporal_conv_backward_reference(
                a["x"], g, a["w"], a["b"], **fl))}


def library_fns(args, g, vmajor, stride) -> dict:
    """direction -> one PyTorch call computing the temporal conv (cuDNN):
    ``conv2d`` forward and ``aten.convolution_backward`` on NCHW views of
    the activations in channels_last, which need no copy."""
    import torch
    import torch.nn.functional as F

    def nchw(t):        # (N, T, V, C) or (R, T, C) -> channels_last NCHW
        return (t.unsqueeze(2) if vmajor else t).permute(0, 3, 1, 2)

    x, gv = nchw(args["x"]), nchw(g)
    w = args["w"].permute(2, 1, 0).unsqueeze(-1).contiguous(
        memory_format=torch.channels_last)          # (C_out, C_in, 9, 1)
    pad = (w.shape[2] - 1) // 2
    return {
        "forward": lambda: F.conv2d(x, w, args["b"], stride=(stride, 1),
                                    padding=(pad, 0)),
        "backward": lambda: torch.ops.aten.convolution_backward(
            gv, x, w, [w.shape[0]], [stride, 1], [pad, 0], [1, 1], False,
            [0, 0], 1, [True, True, True])}


def op_path_fns(gen, ci, co, t, dev) -> dict:
    """direction -> the op path's own graph conv at one block's shape
    (``ops/spatial_conv.py`` ``spatial_conv``: two einsums on cuBLAS, bf16
    compute, float32 weights, as ``block_impl="ops"`` runs it): the
    forward, and the autograd backward of one forward kept for it.  Two
    calls, not one, so it is the yardstick ``op_ms`` and not
    ``library_ms``."""
    import torch

    from stgcn_tpu_torch.ops.spatial_conv import spatial_conv

    def r(*shape, scale=1.0):
        return torch.randn(*shape, generator=gen, device=dev) * scale

    x = r(B, t, V, ci).to(torch.bfloat16).requires_grad_()
    params = {"w": r(ci, 2, co, scale=ci ** -0.5).requires_grad_(),
              "b": r(2, co, scale=0.1).requires_grad_()}
    a = (torch.rand(2, V, V, generator=gen, device=dev) * 0.3
         ).requires_grad_()
    g = r(B, t, V, co).to(torch.bfloat16)

    def forward():
        return spatial_conv(params, a, x, compute_dtype=torch.bfloat16)

    out = forward()
    inputs = (x, params["w"], params["b"], a)
    return {"forward": forward,
            "backward": lambda: torch.autograd.grad(out, inputs, g,
                                                    retain_graph=True)}


def conv_kernel_phase(dev, gen, odd_gen) -> dict:
    """Each conv op's forward and backward kernel against its plain version
    at the shapes of DEFAULT_PLAN's ten blocks, in both layouts, float32
    and bfloat16, plus a fixed graph (no dA) and, bf16, the odd width
    (drawn from ``odd_gen``); returns the largest bf16 errors per (op,
    direction)."""
    import torch

    cases = []
    for ci, co, stride, t in sorted(set(plan_block_shapes())):
        cases += [("spatial_conv", ci, co, 1, t, True),
                  ("temporal_conv", co, co, stride, t, True)]
    cases.append(("spatial_conv", 64, 64, 1, T, False))     # fixed graph
    odd = [("temporal_conv", ODD_C, ODD_C, s, ODD_T, True) for s in (1, 2)]
    worst: dict = {}

    def run(op, ci, co, stride, t, need_da, dt, layout, vmajor, rng,
            padding=None):
        args, g = random_conv(rng, op, ci, co, stride, t, vmajor, dev,
                              padding)
        args = {k: v.to(dt) for k, v in args.items()}
        g = g.to(dt)
        oracle = {k: v.float() for k, v in args.items()}
        case = dict(layout=layout, c_in=ci, c_out=co, stride=stride, t_in=t)
        if op == "spatial_conv":
            case["need_da"] = need_da
        if padding is not None:
            case["padding"] = padding
        for direction, (kernel, plain) in conv_fns(
                op, vmajor, stride, need_da, padding).items():
            got = kernel(args, g)
            torch.cuda.synchronize()
            res = check_op(op, direction, got, plain(oracle, g.float()), dt,
                           phase="conv_kernel",
                           allclose=direction == "forward", **case)
            if dt == torch.bfloat16:
                cur = worst.setdefault((op, direction), dict.fromkeys(
                    ("max_abs_err", "max_rel_err"), 0.0))
                for k in cur:
                    cur[k] = max(cur[k], res[k])
        if dt == torch.bfloat16:
            if op == "temporal_conv":
                tight_conv(args, g, vmajor, stride, case, padding)
            else:
                tight_spatial_conv(args, g, vmajor, need_da, case)

    for dt in (torch.bfloat16, torch.float32):
        for layout, vmajor in LAYOUTS.items():
            for op, ci, co, stride, t, need_da in cases + (
                    odd if dt == torch.bfloat16 else []):
                run(op, ci, co, stride, t, need_da, dt, layout, vmajor,
                    odd_gen if t == ODD_T else gen)
    # the spatial conv's odd width draws from a generator of its own, so
    # the cases above keep their inputs
    spatial_odd = torch.Generator(device=dev).manual_seed(SEED + 3)
    for layout, vmajor in LAYOUTS.items():
        run("spatial_conv", ODD_C, ODD_C, 1, ODD_T, True, torch.bfloat16,
            layout, vmajor, spatial_odd)
    # the temporal conv at C=36 (weights without 16-byte strides, so no
    # TMA), from a generator of its own
    odd8 = torch.Generator(device=dev).manual_seed(SEED + 7)
    for layout, vmajor in LAYOUTS.items():
        for stride in (1, 2):
            run("temporal_conv", ODD_C8, ODD_C8, stride, ODD_T, True,
                torch.bfloat16, layout, vmajor, odd8)
    # the spatial conv at C=36 (rows without 16-byte strides), from a
    # generator of its own
    spatial_odd8 = torch.Generator(device=dev).manual_seed(SEED + 13)
    for layout, vmajor in LAYOUTS.items():
        run("spatial_conv", ODD_C8, ODD_C8, 1, ODD_T, True, torch.bfloat16,
            layout, vmajor, spatial_odd8)
    # padding=0, the time halo's valid conv: a rank's 152 frames of a
    # T=304 clip on a time axis of 2 and its neighbours' 4 + 4, at the
    # widths and strides of blocks 1 and 5 (and the odd width), from a
    # generator of its own
    valid = torch.Generator(device=dev).manual_seed(SEED + 15)
    for dt in (torch.bfloat16, torch.float32):
        for layout, vmajor in LAYOUTS.items():
            for c, stride, t in ((64, 1, T // 2 + 8), (128, 2, T // 2 + 8),
                                 (ODD_C, 2, ODD_T)):
                run("temporal_conv", c, c, stride, t, True, dt, layout,
                    vmajor, valid, padding=0)
    return worst


def tight_spatial_conv(args, g, vmajor, need_da, case) -> None:
    """``spatial_conv``'s bf16 tensor-core kernels tightly against the
    plain version on the same bf16 inputs (all but SPATIAL_TIGHT_SHARE of
    the values within one ulp); the backward twice, bitwise."""
    import torch

    from stgcn_tpu_torch.kernels import spatial_conv as sc

    # float32 weights (bf16 values): gradients come back unrounded
    w32, b32, a32 = (args[k].float() for k in ("w", "b", "a"))
    fl = dict(vmajor=vmajor, need_da=need_da)
    z = sc.spatial_conv_forward(**args, vmajor=vmajor)
    twice = [sc.spatial_conv_backward(args["x"], g, w32, b32, a32, **fl)
             for _ in range(2)]
    torch.cuda.synchronize()
    check_tight("spatial_conv", "forward", z,
                sc.spatial_conv_forward_reference(**args, vmajor=vmajor),
                "conv_kernel", share=SPATIAL_TIGHT_SHARE, **case)
    check_tight("spatial_conv", "backward", twice[0],
                sc.spatial_conv_backward_reference(args["x"], g, w32, b32,
                                                   a32, **fl),
                "conv_kernel", share=SPATIAL_TIGHT_SHARE, **case)
    check_repeat("spatial_conv", *twice, "conv_kernel", **case)


def tight_conv(args, g, vmajor, stride, case, padding=None) -> None:
    """``temporal_conv``'s bf16 tensor-core kernels tightly against the
    plain version on the same bf16 inputs; the backward twice, bitwise."""
    import torch

    from stgcn_tpu_torch.kernels import temporal_conv as tc

    fl = dict(stride=stride, vmajor=vmajor, padding=padding)
    w32 = args["w"].float()         # bf16 values: gradients unrounded
    u = tc.temporal_conv_forward(**args, **fl)
    twice = [tc.temporal_conv_backward(args["x"], g, w32, args["b"], **fl)
             for _ in range(2)]
    torch.cuda.synchronize()
    check_tight("temporal_conv", "forward", u,
                tc.temporal_conv_forward_reference(**args, **fl),
                "conv_kernel", **case)
    check_tight("temporal_conv", "backward", twice[0],
                tc.temporal_conv_backward_reference(args["x"], g, w32,
                                                    args["b"], **fl),
                "conv_kernel", **case)
    check_repeat("temporal_conv", *twice, "conv_kernel", **case)


def randomize_state(state: dict, gen) -> dict:
    """BN running statistics away from their fresh values (see
    randomize_batchnorm), for eval checks of parameter dictionaries."""
    import torch

    for block in state["blocks"]:
        for bn in block.values():
            c = bn["mean"].shape[0]
            bn["mean"] = torch.randn(c, generator=gen) * 0.3
            bn["var"] = torch.rand(c, generator=gen) * 1.5 + 0.5
    return state


def route_train_phase(dev, gen) -> dict:
    """Each route's train step on the main path, then its checks: launch
    counts, finite values, moving BN statistics, the float32 gradient
    against the float32 and float64 op paths, a falling loss and the
    argmax agreement of its bf16 eval forward with the float32 op path.
    Returns the main paths' launch counts per route."""
    import torch

    from stgcn_tpu_torch.models.convert import (
        params_from_jax,
        params_to_numpy,
    )
    from stgcn_tpu_torch.models.stgcn import STGCN
    from stgcn_tpu_torch.training.loop import make_train_step
    from stgcn_tpu_torch.training.metrics import cross_entropy
    from stgcn_tpu_torch.training.optimizers import adam
    from stgcn_tpu_torch.training.train_state import (
        create_train_state,
        train_state_from,
    )
    from stgcn_tpu_torch.tree import tree_map

    x = torch.randn(B, T, V, 2, generator=gen, device=dev)
    y = torch.randint(0, 6, (B,), generator=gen, device=dev)
    counters = conv_counters()

    # the f32 and f64 op paths' gradients on one small batch, same weights
    cfg32 = bench_config(compute_dtype=None, dropout_rate=0.0)
    xs = torch.randn(4, 64, V, 2, generator=gen, device=dev)
    ys = torch.randint(0, 6, (4,), generator=gen, device=dev)
    init = [params_to_numpy(t) for t in STGCN(cfg32).init_params(SEED)]

    def grads_of(cfg, dt):
        m = STGCN(dataclasses.replace(cfg, dtype=dt)).to(dev)
        ts1 = train_state_from(*params_from_jax(*init, dtype=dt), adam(),
                               SEED, dev)
        logits, _ = m.apply(ts1.params, ts1.model_state, xs.to(dt),
                            train=True)
        return torch.autograd.grad(cross_entropy(logits, ys), ts1.leaves())

    def grad_diff(a, b):
        return max((p.double() - q.double()).abs().max().item()
                   for p, q in zip(a, b))

    ops32, ops64 = grads_of(cfg32, torch.float32), grads_of(cfg32,
                                                            torch.float64)
    ops_vs_f64 = grad_diff(ops32, ops64)
    grad_scale = max(g.abs().max().item() for g in ops32)

    # eval: random weights, BN statistics moved, B-sequence batches with
    # and without a time mask; the f32 op path's answers are the oracle
    host = torch.Generator().manual_seed(SEED)
    eval_params, eval_state = STGCN(cfg32).init_params(SEED)
    eval_state = randomize_state(eval_state, host)
    eval_params, eval_state = (tree_map(lambda t: t.to(dev), tr)
                               for tr in (eval_params, eval_state))
    batches = []
    for _ in range(EVAL_BATCHES):
        xb = torch.randn(B, T, V, 2, generator=gen, device=dev)
        lengths = torch.randint(T // 8, T + 1, (B, 1), generator=gen,
                                device=dev)
        batches.append((xb, torch.arange(T, device=dev)[None] < lengths))
    m_ops = STGCN(cfg32).to(dev)

    def answers(model):
        with torch.no_grad():
            out = {}
            for masked in (False, True):
                logits = [model.apply(eval_params, eval_state, xb,
                                      time_mask=mask if masked else None)[0]
                          for xb, mask in batches]
                if not all(bool(torch.isfinite(lg).all())
                           and lg.shape == (B, 6) for lg in logits):
                    raise AssertionError("eval logits are not finite or "
                                         "have the wrong shape")
                out[masked] = torch.cat([lg.argmax(-1) for lg in logits])
            return out

    oracle = answers(m_ops)
    launches = {}
    for route, kw in ROUTES.items():
        cfg = bench_config(**kw)
        model = STGCN(cfg, seed=SEED)
        ts = create_train_state(model, adam(1e-3), seed=SEED)
        state0 = [{k: v["mean"].clone() for k, v in b.items()}
                  for b in ts.model_state["blocks"]]
        step = make_train_step(model)

        # ---- the main path: counts set to 0 just before, read after -----
        for fn in counters.values():
            fn.launches = 0
        start = time.perf_counter()
        losses = [float(step(ts, x, y)["loss"]) for _ in range(ROUTE_STEPS)]
        torch.cuda.synchronize()
        seconds = time.perf_counter() - start
        counts = {name: fn.launches for name, fn in counters.items()}
        launches[route] = counts

        finite = all(np.isfinite(losses)) and all(
            bool(torch.isfinite(p).all()) for p in ts.leaves())
        moved = all(not torch.equal(b[k]["mean"], s0[k])
                    for b, s0 in zip(ts.model_state["blocks"], state0)
                    for k in ("bn1", "bn2"))
        per_step = len(cfg.plan)
        ok = finite and moved and all(n == per_step * ROUTE_STEPS
                                      for n in counts.values())
        emit("route_train", route=route, config=kw, steps=ROUTE_STEPS,
             losses=losses, seconds=seconds, launches=counts,
             launches_per_step={k: v / ROUTE_STEPS
                                for k, v in counts.items()},
             finite=finite, bn_statistics_moved=moved, batch=B, frames=T,
             dtype="bfloat16", ok=ok)
        if not ok:
            raise AssertionError(f"route {route}'s train step did not run "
                                 f"{per_step} launches of each conv op a "
                                 "step, or gave non-finite values, or left "
                                 "the BN statistics where they were")
        del ts

        grads = grads_of(dataclasses.replace(cfg32, **kw), torch.float32)
        grad_err = grad_diff(grads, ops32)
        kernel_vs_f64 = grad_diff(grads, ops64)
        m_fall = STGCN(dataclasses.replace(cfg, dropout_rate=0.0), seed=SEED)
        ts_fall = create_train_state(m_fall, adam(1e-3), seed=SEED)
        step_fall = make_train_step(m_fall)
        fall = [float(step_fall(ts_fall, x, y)["loss"])
                for _ in range(FALL_STEPS)]
        del ts_fall
        got = answers(m_fall)
        agreement = {("masked" if k else "unmasked"): (
            got[k] == oracle[k]).float().mean().item() for k in got}
        ok = (grad_err <= GRAD_REL * grad_scale
              and kernel_vs_f64 <= GRAD_VS_F64 * ops_vs_f64
              and fall[-1] < fall[0]
              and min(agreement.values()) >= ARGMAX_AGREEMENT)
        emit("route_train", route=route,
             f32_route_vs_ops_grad_max_abs_err=grad_err,
             f32_ops_grad_max_abs=grad_scale,
             f32_route_vs_f64_ops_grad_max_abs_err=kernel_vs_f64,
             f32_ops_vs_f64_ops_grad_max_abs_err=ops_vs_f64,
             repeated_batch_losses=fall,
             eval_argmax_agreement_vs_f32_ops=agreement,
             eval_sequences=EVAL_BATCHES * B,
             tolerance=(f"grad max_abs_err <= {GRAD_REL} * max|ops "
                        f"gradient| and route vs f64 <= {GRAD_VS_F64} * f32 "
                        f"ops vs f64; last loss < first; agreement >= "
                        f"{ARGMAX_AGREEMENT}"), ok=ok)
        if not ok:
            raise AssertionError(f"route {route}: the float32 gradient "
                                 "disagrees with the op path's, or the loss "
                                 "did not fall, or its eval answers disagree")
    return launches


def route_time_phase(dev, gen, peak_flops, peak_bytes) -> dict:
    """CUDA-event ms of each route's train step and of the op path's, then
    of each conv op's kernel, plain version and library call (cuDNN, the
    temporal op only) per block shape, direction and layout, beside its
    bound, and of the op path's own graph conv beside the spatial op
    (``op_ms``); the spatial backward's device ms by kernel
    (``kernels_ms``: t, dx, dw, reduce, other).  Returns the per-step sums
    per (op, layout, direction)."""
    import torch

    from stgcn_tpu_torch.models.stgcn import STGCN
    from stgcn_tpu_torch.training.loop import make_train_step
    from stgcn_tpu_torch.training.optimizers import adam
    from stgcn_tpu_torch.training.train_state import create_train_state

    x = torch.randn(B, T, V, 2, generator=gen, device=dev)
    y = torch.randint(0, 6, (B,), generator=gen, device=dev)
    step_ms = {}
    for name, kw in (("route_A", ROUTES["A"]), ("route_B", ROUTES["B"]),
                     ("op_path", {})):
        model = STGCN(bench_config(**kw), seed=SEED)
        ts = create_train_state(model, adam(1e-3), seed=SEED)
        step = make_train_step(model)
        step_ms[name] = cuda_time_ms(lambda: step(ts, x, y), reps=3)
        del ts
    shapes = plan_block_shapes()
    totals: dict = {}
    parts: dict = {}   # layout -> the spatial backward's ms a step by kernel
    # the op path's graph conv draws from a generator of its own, so the
    # kernels' inputs stay those of earlier runs
    op_gen = torch.Generator(device=dev).manual_seed(SEED + 5)
    for ci, co, stride, t in dict.fromkeys(shapes):        # plan order
        blocks = shapes.count((ci, co, stride, t))
        row = {}
        op_ms = {d: cuda_time_ms(fn) for d, fn in op_path_fns(
            op_gen, ci, co, t, dev).items()}
        for layout, vmajor in LAYOUTS.items():
            for op in CONV_OPS:
                args, g = random_conv(gen, op, ci, co, stride, t, vmajor, dev)
                args = {k: v.to(torch.bfloat16) for k, v in args.items()}
                g = g.to(torch.bfloat16)
                cost = (spatial_cost(B, t, ci, co, affine=False)
                        if op == "spatial_conv"
                        else temporal_cost(B, t, co, stride, affine=False))
                lib = (library_fns(args, g, vmajor, stride)
                       if op == "temporal_conv" else None)
                fns = conv_fns(op, vmajor, stride)
                for i, (direction, (kernel, plain)) in enumerate(fns.items()):
                    entry = dict(
                        ms=cuda_time_ms(lambda: kernel(args, g)),
                        plain_ms=cuda_time_ms(lambda: plain(args, g)),
                        library_ms=(cuda_time_ms(lib[direction]) if lib
                                    else None),
                        op_ms=(op_ms[direction] if op == "spatial_conv"
                               else None),
                        **bound_ms(cost[i], peak_flops, peak_bytes))
                    if op == "spatial_conv" and direction == "backward":
                        entry["kernels_ms"] = spatial_parts_ms(
                            kernel_ms_by_name(lambda: kernel(args, g)))
                        lay = parts.setdefault(layout, dict.fromkeys(
                            entry["kernels_ms"], 0.0))
                        for key, ms in entry["kernels_ms"].items():
                            lay[key] += blocks * ms
                    row[f"{op}.{layout}.{direction}"] = entry
                    tot = totals.setdefault((op, layout, direction), dict(
                        ms=0.0, plain_ms=0.0, library_ms=0.0, op_ms=0.0,
                        bound_ms=0.0, ops_ms=0.0, bytes_ms=0.0))
                    for key in tot:
                        tot[key] += blocks * (entry[key] or 0.0)
        emit("route_time", c_in=ci, c_out=co, stride=stride, t_in=t,
             blocks=blocks, **row)
    emit("route_time", **{f"{k}_step_ms": v for k, v in step_ms.items()},
         **{f"{k}_sequences_per_s": B / v * 1e3 for k, v in step_ms.items()},
         kernel_ms_per_step={".".join(k): v["ms"] for k, v in totals.items()},
         plain_ms_per_step={".".join(k): v["plain_ms"]
                            for k, v in totals.items()},
         library_ms_per_step={".".join(k): v["library_ms"]
                              for k, v in totals.items()
                              if k[0] == "temporal_conv"},
         op_ms_per_step={".".join(k): v["op_ms"] for k, v in totals.items()
                         if k[0] == "spatial_conv"},
         bound_ms_per_step={".".join(k): v["bound_ms"]
                            for k, v in totals.items()},
         spatial_backward_kernels_ms_per_step=parts,
         batch=B, frames=T, dtype="bfloat16")
    return totals


def conv_kernel_entry(name, source, replaces, launches, errors,
                      totals) -> dict:
    """The kernels-line entry of one conv op.  Its times are per train
    step, forward plus backward over the ten blocks, summed over both
    layouts (route A's step runs the V-major kernels, route B's the
    (N, T, V, C) ones); each layout and direction is beside it."""
    parts = {}
    for layout in LAYOUTS:
        for direction in ("forward", "backward"):
            tot = totals[(name, layout, direction)]
            parts[f"{layout}.{direction}"] = {
                "ms": tot["ms"], "plain_ms": tot["plain_ms"],
                "library_ms": (tot["library_ms"] if name == "temporal_conv"
                               else None),
                # the op path's two einsums (route_time's op_ms)
                "op_ms": tot["op_ms"] if name == "spatial_conv" else None,
                "bound_ms": tot["bound_ms"],
                "bound_by": bound_kind(tot["ops_ms"], tot["bytes_ms"])}
    every = list(totals[(name, lay, d)] for lay in LAYOUTS
                 for d in ("forward", "backward"))
    return {
        "name": name, "route": "cuda", "source": source,
        "replaces": replaces,
        "launches": sum(counts[f"{name}.{d}"] for counts in launches.values()
                        for d in ("forward", "backward")),
        "launches_by_route": {r: {d: c[f"{name}.{d}"]
                                  for d in ("forward", "backward")}
                              for r, c in launches.items()},
        "max_abs_err": max(errors[(name, d)]["max_abs_err"]
                           for d in ("forward", "backward")),
        "max_rel_err": max(errors[(name, d)]["max_rel_err"]
                           for d in ("forward", "backward")),
        "ms": sum(t["ms"] for t in every),
        "plain_ms": sum(t["plain_ms"] for t in every),
        "bound_ms": sum(t["bound_ms"] for t in every),
        "bound_by": bound_kind(sum(t["ops_ms"] for t in every),
                               sum(t["bytes_ms"] for t in every)),
        # cuDNN's conv computes the temporal op; no single PyTorch call
        # computes the K-partition graph conv (a 1x1 conv, then K
        # adjacency products) or its gradient
        "library_ms": (sum(t["library_ms"] for t in every)
                       if name == "temporal_conv" else None),
        **parts,
    }


# ---- the all-fused loop: block_impl="fused" at full depth -------------------
# blocks 8-9 of DEFAULT_PLAN: C_in = 256 and, in mask mode, a trained graph,
# which the JAX package sends to spatial_block_vm_save
SAVE_BLOCKS = (8, 9)
FUSED_STEPS = 3      # full-width steps of the fused loop on the main path
CHECKPOINT_REQUEST = 40      # sequences of the from_checkpoint request


def fused_counters() -> dict:
    from stgcn_tpu_torch.kernels import spatial_block as sb
    from stgcn_tpu_torch.kernels import temporal_block as tb

    return {"spatial_block.forward": sb.spatial_block_forward,
            "spatial_block.backward": sb.spatial_block_backward,
            "spatial_block_save.forward": sb.spatial_block_save_forward,
            "spatial_block_save.backward": sb.spatial_block_save_backward,
            "temporal_block.forward": tb.temporal_block_forward,
            "temporal_block.backward": tb.temporal_block_backward}


def save_shape() -> tuple[int, int, int, int]:
    """``(c_in, c_out, stride, t_in)`` of blocks 8-9."""
    shapes = plan_block_shapes()
    assert len({shapes[i] for i in SAVE_BLOCKS}) == 1
    return shapes[SAVE_BLOCKS[0]]


def save_cost(n, t, c_in, c_out, k=2, itemsize=2):
    """``spatial_cost`` of the save op: the forward also writes y and the
    backward reads it instead of recomputing it (two stage-1 products and
    two aggregations, as stgcn_tpu/kernels/block_fused.py:857-859
    counts)."""
    (f_ops, f_bytes), (_, b_bytes) = spatial_cost(n, t, c_in, c_out, k,
                                                  itemsize)
    m = n * t
    y_b = k * m * V * c_out * itemsize
    b_ops = 2 * (2 * m * V * c_in * k * c_out) + 2 * (2 * m * k * V * V
                                                     * c_out)
    return (f_ops, f_bytes + y_b), (b_ops, b_bytes + y_b)


def save_kernel_phase(dev, gen) -> dict:
    """``spatial_block_save``'s forward and backward kernels against their
    plain versions at blocks 8-9's shape, relu1 on and off, float32
    tightly and bfloat16 against a float32 oracle (and, bf16, tightly
    against the plain version on the same inputs, the backward twice),
    plus the odd widths (C=40 and 36) in bf16; its six gradients held
    bitwise against ``spatial_block``'s (the recompute kernel) on the same
    inputs.
    Returns the largest bf16 errors per direction."""
    import torch

    from stgcn_tpu_torch.kernels import spatial_block as sb

    worst: dict = {}

    def run(ci, co, t, dt, relu1, rng):
        kw = as_dtype(random_spatial(rng, B, t, ci, co, dev), dt)
        oracle = {k: v.float() for k, v in kw.items()}
        g = torch.randn(V, B, t, co, generator=rng, device=dev).to(dt)
        rest = (kw["s1"], kw["t1"], kw["w"], kw["a"])
        z, y = sb.spatial_block_save_forward(**kw, relu1=relu1)
        grads = sb.spatial_block_save_backward(kw["x"], g, y, *rest,
                                               relu1=relu1)
        recompute = sb.spatial_block_backward(
            kw["x"], g, *(kw[k] for k in ("s1", "t1", "w", "b", "a")),
            relu1=relu1)
        torch.cuda.synchronize()
        want_fwd = sb.spatial_block_save_forward_reference(
            **oracle, relu1=relu1)
        # the backward alone: both read the kernel forward's y
        want_bwd = sb.spatial_block_save_backward_reference(
            oracle["x"], g.float(), y.float(), *(
                oracle[k] for k in ("s1", "t1", "w", "a")), relu1=relu1)
        case = dict(c_in=ci, c_out=co, t_in=t, relu1=relu1)
        res = {"forward": check_op(
            "spatial_block_save", "forward", (z, y), want_fwd, dt,
            phase="save_kernel", allclose=True, **case),
               "backward": check_op(
            "spatial_block_save", "backward", grads, want_bwd, dt,
            phase="save_kernel", **case)}
        same = [bool(torch.equal(a, b)) for a, b in zip(grads,
                                                        recompute)]
        emit("save_kernel", op="spatial_block_save",
             vs="spatial_block (recompute)",
             dtype=str(dt).removeprefix("torch."), **case,
             gradients=["dx", "ds1", "dt1", "dw", "db", "da"],
             bitwise_equal=same, ok=all(same))
        if not all(same):
            raise AssertionError("spatial_block_save's gradients differ "
                                 "from spatial_block's")
        if dt == torch.bfloat16:
            for direction, r in res.items():
                cur = worst.setdefault(("spatial_block_save", direction),
                                       dict.fromkeys(("max_abs_err",
                                                      "max_rel_err"),
                                                     0.0))
                for k in cur:
                    cur[k] = max(cur[k], r[k])
            tight_save(kw, g, relu1, case)

    ci, co, _, t = save_shape()
    for dt in (torch.bfloat16, torch.float32):
        for relu1 in (True, False):
            run(ci, co, t, dt, relu1, gen)
    # the odd width draws from a generator of its own, so the cases above
    # keep their inputs
    spatial_odd = torch.Generator(device=dev).manual_seed(SEED + 4)
    run(ODD_C, ODD_C, ODD_T, torch.bfloat16, True, spatial_odd)
    # C=36 (rows without 16-byte strides), from a generator of its own
    spatial_odd8 = torch.Generator(device=dev).manual_seed(SEED + 14)
    run(ODD_C8, ODD_C8, ODD_T, torch.bfloat16, True, spatial_odd8)
    return worst


def tight_save(kw, g, relu1, case) -> None:
    """``spatial_block_save``'s bf16 tensor-core kernels tightly against
    the plain version on the same bf16 inputs (z and the saved y; the
    backward on the kernel forward's y), all but SPATIAL_TIGHT_SHARE of
    the values within one ulp; the backward twice, bitwise."""
    import torch

    from stgcn_tpu_torch.kernels import spatial_block as sb

    z, y = sb.spatial_block_save_forward(**kw, relu1=relu1)
    # float32 weights (bf16 values): gradients come back unrounded
    rest = tuple(kw[k].float() for k in ("s1", "t1", "w", "a"))
    twice = [sb.spatial_block_save_backward(kw["x"], g, y, *rest,
                                            relu1=relu1) for _ in range(2)]
    torch.cuda.synchronize()
    check_tight("spatial_block_save", "forward", (z, y),
                sb.spatial_block_save_forward_reference(**kw, relu1=relu1),
                "save_kernel", share=SPATIAL_TIGHT_SHARE, **case)
    check_tight("spatial_block_save", "backward", twice[0],
                sb.spatial_block_save_backward_reference(
                    kw["x"], g, y, *rest, relu1=relu1),
                "save_kernel", share=SPATIAL_TIGHT_SHARE, **case)
    check_repeat("spatial_block_save", *twice, "save_kernel", **case)


def eval_oracle(dev, gen, cfg32):
    """Random weights with BN statistics moved, ``EVAL_BATCHES`` batches
    of B sequences with time masks, and the float32 op path's argmax
    (unmasked, masked) on them: the oracle of the eval checks."""
    import torch

    from stgcn_tpu_torch.models.stgcn import STGCN
    from stgcn_tpu_torch.tree import tree_map

    host = torch.Generator().manual_seed(SEED)
    params, state = STGCN(cfg32).init_params(SEED)
    state = randomize_state(state, host)
    params, state = (tree_map(lambda t: t.to(dev), tr)
                     for tr in (params, state))
    batches = []
    for _ in range(EVAL_BATCHES):
        xb = torch.randn(B, T, V, 2, generator=gen, device=dev)
        lengths = torch.randint(T // 8, T + 1, (B, 1), generator=gen,
                                device=dev)
        batches.append((xb, torch.arange(T, device=dev)[None] < lengths))
    m_ops = STGCN(cfg32).to(dev)
    with torch.no_grad():
        oracle = {masked: [m_ops.apply(params, state, xb,
                                       time_mask=mask if masked else None)[0]
                           .argmax(-1) for xb, mask in batches]
                  for masked in (False, True)}
    return params, state, batches, oracle


def fused_train_phase(dev, gen) -> dict:
    """The fused loop's main path (bench.py's step with every block fused),
    then its checks; returns its launch counts and its train state, model
    and batch for the checkpoint phase."""
    import torch

    from stgcn_tpu_torch.kernels.block_eval import block_eval
    from stgcn_tpu_torch.models.convert import (
        params_from_jax,
        params_to_numpy,
    )
    from stgcn_tpu_torch.models.stgcn import STGCN
    from stgcn_tpu_torch.training.loop import make_eval_step, make_train_step
    from stgcn_tpu_torch.training.metrics import cross_entropy
    from stgcn_tpu_torch.training.optimizers import adam
    from stgcn_tpu_torch.training.train_state import (
        create_train_state,
        train_state_from,
    )

    cfg = bench_config(block_impl="fused")
    model = STGCN(cfg, seed=SEED)
    ts = create_train_state(model, adam(1e-3), seed=SEED)
    state0 = [{k: v["mean"].clone() for k, v in b.items()}
              for b in ts.model_state["blocks"]]
    x = torch.randn(B, T, V, 2, generator=gen, device=dev)
    y = torch.randint(0, cfg.num_classes, (B,), generator=gen, device=dev)
    step = make_train_step(model)
    counters = fused_counters()

    # ---- the main path: counts set to 0 just before, read just after ----
    for fn in counters.values():
        fn.launches = 0
    start = time.perf_counter()
    losses = [float(step(ts, x, y)["loss"]) for _ in range(FUSED_STEPS)]
    torch.cuda.synchronize()
    seconds = time.perf_counter() - start
    launches = {name: fn.launches for name, fn in counters.items()}

    n_blocks, n_save = len(cfg.plan), len(SAVE_BLOCKS)
    want = {"spatial_block": n_blocks - n_save, "spatial_block_save": n_save,
            "temporal_block": n_blocks}
    per_step = {k: v / FUSED_STEPS for k, v in launches.items()}
    finite = all(np.isfinite(losses)) and all(
        bool(torch.isfinite(p).all()) for p in ts.leaves())
    moved = all(not torch.equal(b[k]["mean"], s0[k])
                for b, s0 in zip(ts.model_state["blocks"], state0)
                for k in ("bn1", "bn2"))
    ok = finite and moved and all(per_step[k] == want[k.split(".")[0]]
                                  for k in per_step)
    emit("fused_train", steps=FUSED_STEPS, losses=losses, seconds=seconds,
         launches=launches, launches_per_step=per_step,
         expected_per_step=want, finite=finite, bn_statistics_moved=moved,
         batch=B, frames=T, dtype="bfloat16", adjacency_mode="mask", ok=ok)
    if not ok:
        raise AssertionError("the fused step did not run the expected "
                             "launches a step, or gave non-finite values, or "
                             "left the BN statistics where they were")

    # ---- a fixed graph: no save launches ---------------------------------
    m_fixed = STGCN(bench_config(block_impl="fused", adjacency_mode="fixed"),
                    seed=SEED)
    ts_fixed = create_train_state(m_fixed, adam(1e-3), seed=SEED)
    step_fixed = make_train_step(m_fixed)
    for fn in counters.values():
        fn.launches = 0
    loss_fixed = float(step_fixed(ts_fixed, x, y)["loss"])
    fixed = {name: fn.launches for name, fn in counters.items()}
    ok = (np.isfinite(loss_fixed)
          and fixed["spatial_block_save.forward"] == 0
          and fixed["spatial_block_save.backward"] == 0
          and fixed["spatial_block.forward"] == n_blocks
          and fixed["spatial_block.backward"] == n_blocks)
    emit("fused_train", adjacency_mode="fixed", loss=loss_fixed,
         launches_per_step=fixed, ok=ok)
    if not ok:
        raise AssertionError("the fixed-graph fused step ran the save op")
    del ts_fixed

    # ---- float32 gradient against the float32 and float64 op paths -------
    cfg32 = dataclasses.replace(cfg, compute_dtype=None, dropout_rate=0.0)
    xs = torch.randn(4, 64, V, 2, generator=gen, device=dev)
    ys = torch.randint(0, cfg.num_classes, (4,), generator=gen, device=dev)
    init = [params_to_numpy(t) for t in STGCN(cfg32).init_params(SEED)]
    grads = {}
    for impl in ("fused", "ops", "ops64"):
        dt = torch.float64 if impl == "ops64" else torch.float32
        m = STGCN(dataclasses.replace(
            cfg32, block_impl=impl.removesuffix("64"), dtype=dt)).to(dev)
        ts1 = train_state_from(*params_from_jax(*init, dtype=dt), adam(),
                               SEED, dev)
        logits, _ = m.apply(ts1.params, ts1.model_state, xs.to(dt),
                            train=True)
        grads[impl] = torch.autograd.grad(cross_entropy(logits, ys),
                                          ts1.leaves())

    def grad_diff(a, b):
        return max((p.double() - q.double()).abs().max().item()
                   for p, q in zip(grads[a], grads[b]))

    grad_err = grad_diff("fused", "ops")
    grad_scale = max(g.abs().max().item() for g in grads["ops"])
    kernel_vs_f64, ops_vs_f64 = (grad_diff("fused", "ops64"),
                                 grad_diff("ops", "ops64"))

    # ---- the loss falls on a repeated batch, dropout off ----------------
    m_fall = STGCN(dataclasses.replace(cfg, dropout_rate=0.0), seed=SEED)
    ts_fall = create_train_state(m_fall, adam(1e-3), seed=SEED)
    step_fall = make_train_step(m_fall)
    fall = [float(step_fall(ts_fall, x, y)["loss"])
            for _ in range(FALL_STEPS)]
    del ts_fall
    ok = (grad_err <= GRAD_REL * grad_scale
          and kernel_vs_f64 <= GRAD_VS_F64 * ops_vs_f64
          and fall[-1] < fall[0])
    emit("fused_train", f32_fused_vs_ops_grad_max_abs_err=grad_err,
         f32_ops_grad_max_abs=grad_scale,
         f32_fused_vs_f64_ops_grad_max_abs_err=kernel_vs_f64,
         f32_ops_vs_f64_ops_grad_max_abs_err=ops_vs_f64,
         tolerance=(f"max_abs_err <= {GRAD_REL} * max|ops gradient|, and "
                    f"fused vs f64 <= {GRAD_VS_F64} * f32 ops vs f64"),
         repeated_batch_losses=fall, ok=ok)
    if not ok:
        raise AssertionError("the float32 fused path's gradient disagrees "
                             "with the op path's, or the loss did not fall")

    # ---- eval through make_eval_step: fused and hybrid -------------------
    params, state, batches, oracle = eval_oracle(dev, gen, cfg32)
    for impl, kw in (("fused", {}), ("hybrid", dict(
            fused_blocks=FUSED_BLOCKS))):
        m = STGCN(bench_config(block_impl=impl, **kw)).to(dev)
        ts_eval = train_state_from(params, state, adam(), SEED, dev)
        eval_step = make_eval_step(m)
        agreement, per_batch = {}, []
        # the labels are the float32 op path's answers, so "correct" counts
        # the batches' argmax agreement
        correct = 0
        for (xb, _), want_b in zip(batches, oracle[False]):
            before = block_eval.launches
            sums = eval_step(ts_eval, xb, want_b)
            per_batch.append(block_eval.launches - before)
            correct += int(sums["correct"])
        agreement["unmasked"] = correct / (EVAL_BATCHES * B)
        if impl == "fused":
            with torch.no_grad():
                got = torch.cat([m.apply(ts_eval.params, ts_eval.model_state,
                                         xb, time_mask=mask)[0].argmax(-1)
                                 for xb, mask in batches])
            agreement["masked"] = (got == torch.cat(oracle[True])).float(
            ).mean().item()
        want_launches = (len(cfg.plan) if impl == "fused"
                         else len(FUSED_BLOCKS))
        ok = (all(n == want_launches for n in per_batch)
              and min(agreement.values()) >= ARGMAX_AGREEMENT)
        emit("fused_train", eval_step=impl,
             block_eval_launches_per_batch=per_batch,
             eval_argmax_agreement_vs_f32_ops=agreement,
             eval_sequences=EVAL_BATCHES * B, dtype="bfloat16",
             tolerance=f"agreement >= {ARGMAX_AGREEMENT}", ok=ok)
        if not ok:
            raise AssertionError(f"the {impl} eval step did not run "
                                 f"{want_launches} block_eval launches a "
                                 "batch, or its answers disagree")
        del ts_eval
    return {"launches": launches, "model": model, "ts": ts, "x": x, "y": y,
            "cfg": cfg}


def checkpoint_phase(fused) -> None:
    """Save the fused train state and restore it into a fresh one: eval
    logits bitwise equal, one more step from each the same loss and
    parameters, and ``Predictor.from_checkpoint`` answering a request with
    the probabilities of a ``Predictor`` over the saved weights."""
    import os
    import tempfile

    import torch

    from stgcn_tpu_torch.models.convert import state_dict_from_params
    from stgcn_tpu_torch.models.stgcn import STGCN
    from stgcn_tpu_torch.serving import Predictor
    from stgcn_tpu_torch.training.checkpoint import (
        checkpoint_metadata,
        latest_checkpoint,
        restore_checkpoint,
        save_checkpoint,
    )
    from stgcn_tpu_torch.training.loop import make_train_step
    from stgcn_tpu_torch.training.optimizers import adam
    from stgcn_tpu_torch.training.train_state import create_train_state

    model, ts, x, y, cfg = (fused[k] for k in ("model", "ts", "x", "y",
                                               "cfg"))
    with torch.no_grad():
        before, _ = model.apply(ts.params, ts.model_state, x)
    rng = np.random.default_rng(SEED)
    request = [rng.normal(0, 1, (int(t), V, 2)).astype(np.float32)
               for t in rng.integers(T // 8, T + 1, CHECKPOINT_REQUEST)]
    serving = dict(buckets=(T // 2, T), max_batch=B)
    direct = STGCN(cfg)
    direct.load_state_dict(state_dict_from_params(
        ts.params, ts.model_state, residual=cfg.residual,
        adjacency=model.adjacency))
    want = Predictor(direct, **serving).predict(request).probs
    with tempfile.TemporaryDirectory() as tmp:
        base = os.path.join(tmp, f"ckpt_{ts.step}")
        start = time.perf_counter()
        path = save_checkpoint(base, ts, {"step": ts.step})
        save_s = time.perf_counter() - start
        mbytes = os.path.getsize(path) / 1e6
        fresh = create_train_state(model, adam(1e-3), seed=SEED + 1)
        start = time.perf_counter()
        restore_checkpoint(latest_checkpoint(tmp), fresh)
        restore_s = time.perf_counter() - start
        meta = checkpoint_metadata(base)
        got = Predictor.from_checkpoint(base, cfg, **serving).predict(
            request).probs
    with torch.no_grad():
        after, _ = model.apply(fresh.params, fresh.model_state, x)
    logits_equal = bool(torch.equal(before, after))
    probs_equal = bool(np.array_equal(got, want))
    step = make_train_step(model)
    loss_a, loss_b = (float(step(s, x, y)["loss"]) for s in (ts, fresh))
    params_equal = all(torch.equal(a, b)
                       for a, b in zip(ts.leaves(), fresh.leaves()))
    ok = (logits_equal and probs_equal and loss_a == loss_b
          and params_equal and meta == {"step": FUSED_STEPS}
          and fresh.seed == SEED)
    emit("checkpoint", step=FUSED_STEPS, npz_mbytes=mbytes,
         save_seconds=save_s, restore_seconds=restore_s,
         eval_logits_bitwise_equal=logits_equal,
         resumed_losses=[loss_a, loss_b],
         resumed_parameters_bitwise_equal=params_equal,
         from_checkpoint_request=len(request),
         from_checkpoint_probs_equal=probs_equal, ok=ok)
    if not ok:
        raise AssertionError("the restored train state or predictor differs "
                             "from the saved one")


def fused_time_phase(dev, gen, peak_flops, peak_bytes, hybrid_totals,
                     hybrid_conv_library) -> dict:
    """CUDA-event ms of the fused step beside the op path, the hybrid and
    routes A and B; of the save op per direction at blocks 8-9 beside its
    plain version, the recompute op and its bound (each backward's device
    ms by kernel beside it); of the fused step's
    kernels (``hybrid_totals``, train_time's sums over blocks 0-6, plus
    blocks 7-9 timed here) with cuDNN's conv beside temporal_block
    (``hybrid_conv_library`` for blocks 0-6); and of the fused eval forward
    through ``make_eval_step``.  Returns the save op's per-step sums per
    direction."""
    import torch

    from stgcn_tpu_torch.kernels import spatial_block as sb
    from stgcn_tpu_torch.kernels import temporal_block as tb
    from stgcn_tpu_torch.models.stgcn import STGCN
    from stgcn_tpu_torch.training.loop import make_eval_step, make_train_step
    from stgcn_tpu_torch.training.optimizers import adam
    from stgcn_tpu_torch.training.train_state import create_train_state

    x = torch.randn(B, T, V, 2, generator=gen, device=dev)
    y = torch.randint(0, 6, (B,), generator=gen, device=dev)
    step_ms = {}
    for name, kw in (("fused", dict(block_impl="fused")),
                     ("op_path", {}),
                     ("hybrid", dict(block_impl="hybrid",
                                     fused_blocks=FUSED_BLOCKS)),
                     ("route_A", ROUTES["A"]), ("route_B", ROUTES["B"])):
        model = STGCN(bench_config(**kw), seed=SEED)
        ts = create_train_state(model, adam(1e-3), seed=SEED)
        step = make_train_step(model)
        step_ms[name] = cuda_time_ms(lambda: step(ts, x, y))
        if name == "fused":
            eval_step = make_eval_step(model)
            eval_ms = cuda_time_ms(lambda: eval_step(ts, x, y))
        del ts

    ci, co, _, t = save_shape()
    kw = as_dtype(random_spatial(gen, B, t, ci, co, dev), torch.bfloat16)
    g = torch.randn(V, B, t, co, generator=gen, device=dev).to(
        torch.bfloat16)
    _, ysaved = sb.spatial_block_save_forward(**kw, relu1=True)
    rest = (kw["s1"], kw["t1"], kw["w"], kw["a"])
    full = tuple(kw[k] for k in ("s1", "t1", "w", "b", "a"))
    fns = {
        "forward": (
            lambda: sb.spatial_block_save_forward(**kw, relu1=True),
            lambda: sb.spatial_block_save_forward_reference(**kw,
                                                            relu1=True),
            lambda: sb.spatial_block_forward(**kw, relu1=True)),
        "backward": (
            lambda: sb.spatial_block_save_backward(kw["x"], g, ysaved, *rest,
                                                   relu1=True),
            lambda: sb.spatial_block_save_backward_reference(
                kw["x"], g, ysaved, *rest, relu1=True),
            lambda: sb.spatial_block_backward(kw["x"], g, *full,
                                              relu1=True))}
    costs = save_cost(B, t, ci, co)
    totals, row = {}, {}
    blocks = len(SAVE_BLOCKS)
    for i, (direction, (kernel, plain, recompute)) in enumerate(fns.items()):
        entry = dict(ms=cuda_time_ms(kernel), plain_ms=cuda_time_ms(plain),
                     recompute_ms=cuda_time_ms(recompute),
                     **bound_ms(costs[i], peak_flops, peak_bytes))
        entry["bound_by"] = bound_kind(entry["ops_ms"], entry["bytes_ms"])
        if direction == "backward":   # device ms by kernel, both ops
            entry["kernels_ms"] = spatial_parts_ms(kernel_ms_by_name(kernel))
            entry["recompute_kernels_ms"] = spatial_parts_ms(
                kernel_ms_by_name(recompute))
        row[direction] = entry
        totals[("spatial_block_save", direction)] = {
            k: blocks * entry[k] for k in ("ms", "plain_ms", "recompute_ms",
                                           "bound_ms", "ops_ms",
                                           "bytes_ms")}
    emit("fused_time", blocks=list(SAVE_BLOCKS), c_in=ci, c_out=co, t_in=t,
         saved_y_mbytes=2 * B * t * V * co * 2 / 1e6,
         **{f"spatial_block_save.{d}": e for d, e in row.items()})

    # the fused step's ops beyond the hybrid's blocks 0-6; cuDNN's conv
    # beside temporal_block from a generator of its own
    bf = torch.bfloat16
    per_step = {k: v["ms"] for k, v in hybrid_totals.items()}
    per_step.update({k: v["ms"] for k, v in totals.items()})
    lib_gen = torch.Generator(device=dev).manual_seed(SEED + 9)
    conv_lib = dict(hybrid_conv_library)
    for i, (ci, co, stride, t) in enumerate(plan_block_shapes()):
        if i in FUSED_BLOCKS:
            continue
        if i not in SAVE_BLOCKS:
            sp = as_dtype(random_spatial(gen, B, t, ci, co, dev), bf)
            gz = torch.randn(V, B, t, co, generator=gen, device=dev).to(bf)
            sp_rest = tuple(sp[k] for k in ("s1", "t1", "w", "b", "a"))
            per_step[("spatial_block", "forward")] += cuda_time_ms(
                lambda: sb.spatial_block_forward(**sp, relu1=True))
            per_step[("spatial_block", "backward")] += cuda_time_ms(
                lambda: sb.spatial_block_backward(sp["x"], gz, *sp_rest,
                                                  relu1=True))
        tp = as_dtype(random_temporal(gen, B, t, co, dev), bf)
        gu = torch.randn(V, B, (t - 1) // stride + 1, co, generator=gen,
                         device=dev).to(bf)
        tp_rest = tuple(tp[k] for k in ("s2", "t2", "wt", "bt"))
        per_step[("temporal_block", "forward")] += cuda_time_ms(
            lambda: tb.temporal_block_forward(**tp, stride=stride,
                                              relu2=True))
        per_step[("temporal_block", "backward")] += cuda_time_ms(
            lambda: tb.temporal_block_backward(tp["z"], gu, *tp_rest,
                                               stride=stride, relu2=True))
        for direction, ms in temporal_conv_library_ms(lib_gen, co, stride, t,
                                                      dev).items():
            conv_lib[direction] += ms
    kernel_ms = sum(per_step.values())
    emit("fused_time", **{f"{k}_step_ms": v for k, v in step_ms.items()},
         **{f"{k}_sequences_per_s": B / v * 1e3 for k, v in step_ms.items()},
         fused_eval_step_ms=eval_ms,
         save_ms_per_step={d: totals[("spatial_block_save", d)]["ms"]
                           for d in fns},
         recompute_ms_per_step={
             d: totals[("spatial_block_save", d)]["recompute_ms"]
             for d in fns},
         fused_kernel_ms_per_step={".".join(k): v
                                   for k, v in per_step.items()},
         fused_kernel_ms_sum=kernel_ms,
         fused_rest_ms=step_ms["fused"] - kernel_ms,
         conv_library_ms_per_step={f"temporal_block.{d}": v
                                   for d, v in conv_lib.items()},
         batch=B, frames=T, dtype="bfloat16")
    return totals


# ---- the training entry point ---------------------------------------------
# The CLI's flags for bench.py's step with every block fused, as a user
# passes them: spatial-configuration partitioning (K=3, distances from the
# training set), residual, dropout 0.5, a trained graph (mask mode, so blocks
# 8-9 run the save op), bf16, B=64 at a fixed T=304.
CLI_FLAGS = ["--model.partitioning", "2", "--model.residual", "true",
             "--model.dropout_rate", "0.5",
             "--model.use_edge_importance", "true",
             "--model.block_impl", "fused", "--parallel.precision",
             "bfloat16", "--data.batch_size", str(B),
             "--data.collate_mode", "fixed", "--data.fixed_len", str(T),
             "--data.use_native_loader", "false", "--train.lr", "1e-3",
             "--train.checkpoint_every_epochs", "1"]
# the README's quick-start shape on the hybrid: bucketed batch lengths
CLI_HYBRID = ["--model.block_impl", "hybrid", "--model.fused_blocks",
              ",".join(map(str, FUSED_BLOCKS)), "--data.collate_mode",
              "bucket"]
CLI_EPOCHS = 2
CLI_HYBRID_EPOCHS = 2    # the second without the first's first calls
# the captured steps that ran eagerly before: the checked fused step, and
# route A with remat (its recompute launches each conv forward again)
CLI_CHECKED = ["--train.check_invariants", "true"]
CLI_REMAT = ["--model.block_impl", "ops", "--model.layout", "vntc",
             "--parallel.remat", "true"]
CLI_ONE_EPOCH = ["--train.epochs", "1"]


def run_cli(argv: list[str], counters: dict | None = None
            ) -> tuple[dict, dict, dict]:
    """``cli.train.main(argv)`` in this process with every launch count
    (``counters``: the fused kernels' and ``block_eval``'s by default) set
    to 0 just before it; returns the counts read just after, what it
    printed (splits, epochs: the ``[epoch]`` dicts, resume line, test, any
    ``[graph] ... runs eagerly`` line) and its train steps: the Trainer's
    step (checked or not) wrapped to record each batch's (rows, padded
    frames) and CUDA events around it, and the step and train state it
    ran."""
    import ast
    import contextlib
    import io

    import torch

    from stgcn_tpu_torch.cli.train import main as train_main
    from stgcn_tpu_torch.kernels.block_eval import block_eval
    from stgcn_tpu_torch.training import checks, loop

    if counters is None:
        counters = {**fused_counters(), "block_eval": block_eval}
    out = io.StringIO()
    steps: dict = {"batches": [], "losses": []}
    makers = {loop: loop.make_train_step,
              checks: checks.make_checked_train_step}

    def timed(make_step):
        return lambda model, **kw: timed_step(make_step(model, **kw))

    def timed_step(step):
        def wrapped(ts, x, y, *args, **kwargs):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            result = step(ts, x, y, *args, **kwargs)
            end.record()
            steps["batches"].append((x.shape[0], x.shape[1], start, end))
            steps["losses"].append(result["loss"].clone())
            steps.update(step=step, ts=ts)
            return result

        return wrapped

    for fn in counters.values():
        fn.launches = 0
    torch.cuda.reset_peak_memory_stats()
    loop.make_train_step = timed(makers[loop])
    checks.make_checked_train_step = timed(makers[checks])
    try:
        with contextlib.redirect_stdout(out):
            rc = train_main(argv)
    except BaseException:
        print(out.getvalue()[-6000:], file=sys.stderr)
        raise
    finally:
        loop.make_train_step = makers[loop]
        checks.make_checked_train_step = makers[checks]
    torch.cuda.synchronize()
    steps["peak_mib"] = torch.cuda.max_memory_allocated() / 2 ** 20
    launches = {name: fn.launches for name, fn in counters.items()}
    text = out.getvalue()
    splits = re.search(r"\[data\] splits: train=(\d+) val=(\d+) test=(\d+)",
                       text)
    test = re.search(r"\[test\] loss=(\S+) acc=(\S+) n=(\d+)", text)
    resumed = re.search(r"\[ckpt\] resumed from epoch (\d+)", text)
    loader = re.search(r"^\[data\] (using native C\+\+ batch loader|"
                       r"numpy batches.*)$", text, re.MULTILINE)
    printed = {
        "loader": loader.group(1) if loader else None,
        "rc": rc,
        "splits": [int(v) for v in splits.groups()] if splits else None,
        "epochs": [ast.literal_eval(line[len("[epoch] "):])
                   for line in text.splitlines()
                   if line.startswith("[epoch] ")],
        "resumed_from": int(resumed.group(1)) if resumed else None,
        "test": ([float(test.group(1)), float(test.group(2)),
                  int(test.group(3))] if test else None),
        "eager_lines": re.findall(r"^\[graph\] .* runs eagerly.*$", text,
                                  re.MULTILINE),
    }
    if rc != 0 or not splits or not test:
        print(text[-6000:], file=sys.stderr)
    return launches, printed, steps


def epoch_work(batches, epoch_s) -> dict:
    """One epoch's train steps measured by the work they did: ``work_steps``
    is the rows x padded frames of its batches over B x T (a batch of 39
    sequences is 39/64 of a step, one of T=512 is 512/304), the device's
    ms of its steps from their CUDA events, and the Trainer's epoch time
    over that work; the host's share is the epoch time no step's events
    cover."""
    work = sum(rows * frames for rows, frames, _, _ in batches) / (B * T)
    device_ms = sum(start.elapsed_time(end) for _, _, start, end in batches)
    return dict(batches=len(batches),
                shapes=[[rows, frames] for rows, frames, _, _ in batches],
                work_steps=work, epoch_s=epoch_s,
                trainer_ms_per_work_step=epoch_s * 1e3 / work,
                device_ms=device_ms,
                device_ms_per_work_step=device_ms / work,
                host_share=1 - device_ms / (epoch_s * 1e3))


def cli_train_phase(smi: str, dev, tmp: str) -> dict:
    """The training CLI end to end (module docstring, phase 16); fails on a
    non-zero return, a non-finite loss, a launch count off its expected
    value per step and batch, a missing checkpoint or one without the JAX
    metadata, or a resume that does not continue the step count.  Each
    epoch's steps are measured by their work (``epoch_work``), beside a
    step of the CLI's own configuration (K=3, a trained graph, fused)
    timed here at B=64, T=304 after its first run.  The dataset, the
    checkpoints and the logs go under ``tmp``; returns the paths and each
    run's figures, for the tools phase."""
    import math
    import os

    import torch

    from stgcn_tpu_torch.data import generate_dataset
    from stgcn_tpu_torch.training.checkpoint import checkpoint_metadata

    blocks, saves = 10, 2
    data_dir = os.path.join(tmp, "data")
    start = time.perf_counter()
    meta = generate_dataset(data_dir)
    generate_s = time.perf_counter() - start
    ckpt_dir = os.path.join(tmp, "ckpt")
    data = ["--data.metadata_file", meta, "--data.dataset_dir", data_dir]
    common = data + ["--train.checkpoint_dir", ckpt_dir,
                     "--train.log_dir", os.path.join(tmp, "logs")]
    runs = {
        "fused": CLI_FLAGS + common + ["--train.epochs",
                                       str(CLI_EPOCHS)],
        "fused_resumed": CLI_FLAGS + common + [
            "--train.epochs", str(CLI_EPOCHS + 1), "--train.resume",
            "true"],
        "hybrid_bucket": CLI_FLAGS + CLI_HYBRID + data + [
            "--train.epochs", str(CLI_HYBRID_EPOCHS)],
        "fused_checked": CLI_FLAGS + CLI_CHECKED + data + CLI_ONE_EPOCH,
        "route_A_remat": CLI_FLAGS + CLI_REMAT + data + CLI_ONE_EPOCH,
    }
    results, cli_step_ms = {}, None
    for name, argv in runs.items():
        start = time.perf_counter()
        remat = name == "route_A_remat"
        launches, printed, steps = run_cli(
            argv, conv_counters() if remat else None)
        seconds = time.perf_counter() - start
        n_train, n_val, n_test = printed["splits"] or (0, 0, 0)
        batches_per_epoch = math.ceil(n_train / B)
        eval_batches = math.ceil(n_val / B)
        epochs = printed["epochs"]
        hybrid = name == "hybrid_bucket"
        fused = len(FUSED_BLOCKS) if hybrid else blocks
        per_step = ({"spatial_block": fused, "spatial_block_save": 0,
                     "temporal_block": fused} if hybrid else
                    {"spatial_block": blocks - saves,
                     "spatial_block_save": saves,
                     "temporal_block": blocks})
        want = {f"{op}.{d}": n * batches_per_epoch * len(epochs)
                for op, n in per_step.items()
                for d in ("forward", "backward")}
        want["block_eval"] = fused * (
            eval_batches * len(epochs) + math.ceil(n_test / B))
        if remat:
            # 20 forward and 10 backward launches of each conv op a train
            # step, 10 forwards an eval batch (the eval forward's V-major
            # route), no fused kernel
            evals = eval_batches * len(epochs) + math.ceil(n_test / B)
            train_steps = batches_per_epoch * len(epochs)
            want = {f"{op}.{d}": n for op in CONV_OPS for d, n in (
                ("forward", 2 * blocks * train_steps + blocks * evals),
                ("backward", blocks * train_steps))}
        losses = [[e["train_loss"], e.get("val_loss")] for e in epochs]
        finite = bool(epochs) and all(
            v is not None and math.isfinite(v) for pair in losses
            for v in pair)
        ckpts = sorted(int(f[5:-4]) for f in os.listdir(ckpt_dir)
                       if f.endswith(".npz"))
        metas = {s: checkpoint_metadata(os.path.join(ckpt_dir,
                                                     f"ckpt_{s}"))
                 for s in ckpts}
        if name == "fused":
            ckpt_ok = metas == {
                batches_per_epoch * e: {
                    "epoch": e, "step": batches_per_epoch * e,
                    "final": e == CLI_EPOCHS}
                for e in range(1, CLI_EPOCHS + 1)}
            epochs_ok = [e["epoch"] for e in epochs] == list(
                range(CLI_EPOCHS))
        elif name == "fused_resumed":
            last = batches_per_epoch * (CLI_EPOCHS + 1)
            ckpt_ok = metas.get(last) == {
                "epoch": CLI_EPOCHS + 1, "step": last, "final": True}
            epochs_ok = (printed["resumed_from"] == CLI_EPOCHS
                         and [e["epoch"] for e in epochs] == [
                             CLI_EPOCHS])
        else:
            ckpt_ok = True      # no checkpoint directory
            epochs_ok = [e["epoch"] for e in epochs] == list(
                range(CLI_HYBRID_EPOCHS if hybrid else 1))
        batches = steps["batches"]
        split_ok = bool(epochs) and len(batches) == (
            batches_per_epoch * len(epochs))
        per_epoch = ([epoch_work(batches[i * batches_per_epoch:
                                         (i + 1) * batches_per_epoch],
                                 e["epoch_time_s"])
                      for i, e in enumerate(epochs)] if split_ok else [])
        if name == "fused" and split_ok:
            # a step of the CLI's own configuration at B x T, on the
            # state the run trained, from a generator of its own
            cli_gen = torch.Generator(device=dev).manual_seed(SEED + 10)
            x = torch.randn(B, T, V, 2, generator=cli_gen, device=dev)
            y = torch.randint(0, 6, (B,), generator=cli_gen, device=dev)
            cli_step_ms = cuda_time_ms(
                lambda: steps["step"](steps["ts"], x, y), reps=5)
        for e in per_epoch:     # the fused runs share its config
            e["host_share_vs_cli_step"] = (
                1 - e["work_steps"] * cli_step_ms / (e["epoch_s"] * 1e3)
                if cli_step_ms and name.startswith("fused") else None)
        # the captured step (phase 21): the Trainer's epoch loss is the
        # mean of its steps' own losses, which differ, not the last
        # step's output read again
        step_losses = [float(v) for v in steps["losses"]]
        graph = dict(
            captured=steps["step"].captured,
            graphs=steps["step"].cache_size, peak_mib=steps["peak_mib"],
            step_losses=step_losses,
            epoch_means=[float(np.mean(step_losses[
                i * batches_per_epoch:(i + 1) * batches_per_epoch]))
                for i in range(len(epochs))] if split_ok else [])
        losses_ok = split_ok and all(
            len(set(step_losses[i * batches_per_epoch:
                                (i + 1) * batches_per_epoch])) > 1
            and math.isclose(m, e["train_loss"], rel_tol=1e-6)
            for i, (m, e) in enumerate(zip(graph["epoch_means"], epochs)))
        ok = (printed["rc"] == 0 and finite and ckpt_ok and epochs_ok
              and split_ok and launches == want
              and printed["test"] is not None
              and math.isfinite(printed["test"][0])
              and graph["captured"] and losses_ok
              and not printed["eager_lines"])
        results[name] = dict(
            seconds=seconds, splits=printed["splits"],
            batches_per_epoch=batches_per_epoch,
            epochs=[e["epoch"] for e in epochs], losses=losses,
            per_epoch=per_epoch, test=printed["test"],
            launches=launches, expected_launches=want,
            checkpoints={str(k): v for k, v in metas.items()},
            graph=graph, step_losses_ok=losses_ok,
            eager_lines=printed["eager_lines"], ok=ok)
        emit("cli_train", run=name, argv=argv, **results[name])
        del steps
        if not ok:
            raise AssertionError(
                f"the training CLI's {name} run failed: rc "
                f"{printed['rc']}, finite {finite}, checkpoints "
                f"{ckpt_ok}, epochs {epochs_ok}, steps {split_ok}, "
                f"launches {launches} against {want}, captured "
                f"{graph['captured']}, step losses {losses_ok}, eager "
                f"lines {printed['eager_lines']}")

    def column(run, key):
        return [e[key] for e in results[run]["per_epoch"]]

    emit("cli_train", dataset_seconds=generate_s, cli_step_ms=cli_step_ms,
         **{f"{run}_{key}": column(run, key) for run in results
            for key in ("trainer_ms_per_work_step",
                        "device_ms_per_work_step", "host_share",
                        "host_share_vs_cli_step")},
         nvidia_smi=smi, batch=B, frames=T, dtype="bfloat16")
    return dict(meta=meta, data_dir=data_dir, ckpt_dir=ckpt_dir,
                log_dir=os.path.join(tmp, "logs"), results=results,
                cli_step_ms=cli_step_ms)


# ---- the user tools ---------------------------------------------------------
PREPROCESS_VIDEOS = 2    # videos an action in the JSON keypoint tree
PREPROCESS_FRAMES = 40   # frames a video, about one in eight person-less
NATIVE_EPOCHS = 2        # epochs of the CLI run on the native loader
CM_SHARE = 0.01          # fused and op-path confusion matrices: at most 1%
                         # of the sequences classified apart
PT_TOL = 1e-6            # the pt file's probabilities against the
                         # checkpoint's, float32, same weights
PT2_BATCHES = (B, 17)    # batch sizes of the dynamic-batch pt2 program


def cli_want(printed: dict, fused: int, saves: int) -> dict:
    """Launch counts a CLI run with ``fused`` fused blocks, ``saves`` of
    them on the save op, should read: each way per train step, and one
    ``block_eval`` per fused block per validation or test batch."""
    import math

    n_train, n_val, n_test = printed["splits"] or (0, 0, 0)
    steps = math.ceil(n_train / B) * len(printed["epochs"])
    per_step = {"spatial_block": fused - saves, "spatial_block_save": saves,
                "temporal_block": fused}
    want = {f"{op}.{d}": n * steps for op, n in per_step.items()
            for d in ("forward", "backward")}
    want["block_eval"] = fused * (math.ceil(n_val / B) * len(
        printed["epochs"]) + math.ceil(n_test / B))
    return want


def run_main(fn, argv: list[str]) -> tuple[int, str]:
    """``fn(argv)`` in this process; returns its code and what it
    printed."""
    import contextlib
    import io

    out = io.StringIO()
    try:
        with contextlib.redirect_stdout(out):
            rc = fn(argv)
    except BaseException:
        print(out.getvalue()[-6000:], file=sys.stderr)
        raise
    return rc, out.getvalue()


def keypoint_tree(root: str, rng) -> dict:
    """An OpenPose JSON tree under ``root/keypoints`` (and empty ``.avi``
    files under ``root/videos``): every action, PREPROCESS_VIDEOS videos of
    PREPROCESS_FRAMES frames, about one frame in eight without a person.
    Returns each video's stem -> (action, kept frames, skipped indices)."""
    import json
    import os

    from stgcn_tpu_torch.data.openpose import ACTIONS

    expected = {}
    for action in ACTIONS:
        kdir = os.path.join(root, "keypoints", action)
        vdir = os.path.join(root, "videos", action)
        os.makedirs(kdir)
        os.makedirs(vdir)
        for v in range(PREPROCESS_VIDEOS):
            stem = f"person{v + 1:02d}_{action}_d{v + 1}_uncomp"
            open(os.path.join(vdir, stem + ".avi"), "wb").close()
            kept, skipped = [], []
            for f in range(PREPROCESS_FRAMES):
                people = []
                if rng.random() < 0.125:
                    skipped.append(f)
                else:
                    kp = rng.uniform(0, 640, (25, 3)).astype(np.float32)
                    kept.append(kp)
                    people = [{"pose_keypoints_2d": kp.ravel().tolist()}]
                with open(os.path.join(kdir, f"{stem}_{f:012d}_keypoints"
                                             ".json"), "w") as fh:
                    json.dump({"version": 1.3, "people": people}, fh)
            expected[stem] = (action, np.stack(kept), skipped)
    return expected


def tools_phase(smi: str, dev, tmp: str, cli: dict, eval_forward_ms: float
                ) -> None:
    """The user tools on the training CLI's dataset, checkpoints and logs
    (module docstring, phase 17); fails on any check."""
    import contextlib
    import io
    import math
    import os

    import torch

    from stgcn_tpu_torch.cli import evaluate, export, preprocess, report
    from stgcn_tpu_torch.cli.train import build_datasets, resolve_distances
    from stgcn_tpu_torch.data import batches, native_batches, native_loader
    from stgcn_tpu_torch.data.datasets import read_metadata
    from stgcn_tpu_torch.kernels.block_eval import block_eval
    from stgcn_tpu_torch.serving import Predictor
    from stgcn_tpu_torch.training.checkpoint import latest_checkpoint
    from stgcn_tpu_torch.training.config import (
        model_config_from,
        parse_config,
    )

    data_flags = ["--data.metadata_file", cli["meta"],
                  "--data.dataset_dir", cli["data_dir"]]
    flags = CLI_FLAGS + data_flags
    cfg = parse_config(flags)

    # ---- the native loader: built here, bitwise the numpy batches --------
    lib = native_loader.library_path()
    lib.unlink(missing_ok=True)
    start = time.perf_counter()
    native_loader.build()
    build_s = time.perf_counter() - start
    train_ds = build_datasets(cfg)[0]
    equal, seconds = {}, {}
    for mode in ("fixed", "bucket"):
        kw = dict(shuffle=True, seed=SEED, sort_by_length=True, mode=mode,
                  fixed_len=T)
        start = time.perf_counter()
        ref = list(batches(train_ds, B, **kw))
        numpy_s = time.perf_counter() - start
        start = time.perf_counter()
        got = list(native_batches(train_ds, B, **kw))
        native_s = time.perf_counter() - start
        equal[mode] = len(ref) == len(got) and all(
            a.shape == b.shape and a.dtype == b.dtype
            and np.array_equal(a.view(np.uint8), b.view(np.uint8))
            for ra, rb in zip(ref, got) for a, b in zip(ra, rb))
        seconds[mode] = {"numpy_s": numpy_s, "native_s": native_s}
    launches, printed, steps = run_cli(
        flags + ["--data.use_native_loader", "true", "--train.epochs",
                 str(NATIVE_EPOCHS)])
    want = cli_want(printed, 10, 2)
    per_epoch_steps = math.ceil(printed["splits"][0] / B)
    batches_run = steps["batches"]
    per_epoch = [epoch_work(batches_run[i * per_epoch_steps:
                                        (i + 1) * per_epoch_steps],
                            e["epoch_time_s"])
                 for i, e in enumerate(printed["epochs"])]
    numpy_epochs = cli["results"]["fused"]["per_epoch"]
    ok = (all(equal.values()) and lib.exists() and printed["rc"] == 0
          and printed["loader"] == "using native C++ batch loader"
          and launches == want
          and len(batches_run) == per_epoch_steps * NATIVE_EPOCHS
          and all(math.isfinite(e["train_loss"]) for e in printed["epochs"]))
    emit("tools", tool="native_loader",
         library=str(lib.relative_to(native_loader.REPO_ROOT)),
         build_seconds=build_s, bitwise_equal_to_numpy=equal,
         train_split=len(train_ds), pass_seconds=seconds,
         cli_loader_line=printed["loader"], launches=launches,
         expected_launches=want,
         trainer_ms_per_work_step=[e["trainer_ms_per_work_step"]
                                   for e in per_epoch],
         host_share=[e["host_share"] for e in per_epoch],
         numpy_trainer_ms_per_work_step=[e["trainer_ms_per_work_step"]
                                         for e in numpy_epochs],
         numpy_host_share=[e["host_share"] for e in numpy_epochs],
         nvidia_smi=smi, ok=ok)
    if not ok:
        raise AssertionError("the native loader did not build, did not "
                             "match the numpy batches or did not run the "
                             "CLI's epochs")
    del steps

    # ---- cli.evaluate on the fused checkpoint: fused and op path ---------
    ckpt = latest_checkpoint(cli["ckpt_dir"])
    evals = {}
    for impl in ("fused", "ops"):
        cm_path = os.path.join(tmp, f"confusion_{impl}.npy")
        block_eval.launches = 0
        rc, text = run_main(evaluate.main, flags + [
            "--checkpoint", ckpt, "--model.block_impl", impl,
            "--save-confusion", cm_path])
        line = re.search(r"\[eval\] split=test loss=(\S+) acc=(\S+) "
                         r"n=(\d+)", text)
        evals[impl] = dict(
            rc=rc, launches=block_eval.launches,
            loss=float(line.group(1)) if line else None,
            acc=float(line.group(2)) if line else None,
            n=int(line.group(3)) if line else 0,
            confusion=(np.load(cm_path).tolist()
                       if os.path.exists(cm_path) else None))
    n = evals["fused"]["n"]
    cms = [np.asarray(evals[k]["confusion"]) for k in ("fused", "ops")]
    apart = (int(np.abs(cms[0] - cms[1]).sum()) // 2
             if all(c.shape == (6, 6) for c in cms) else None)
    ok = (all(e["rc"] == 0 and e["loss"] is not None
              and math.isfinite(e["loss"]) for e in evals.values())
          and n > 0 and evals["ops"]["n"] == n
          and evals["fused"]["launches"] == 10 * math.ceil(n / B)
          and evals["ops"]["launches"] == 0
          and apart is not None and apart <= CM_SHARE * n
          and all(int(c.sum()) == n for c in cms))
    emit("tools", tool="evaluate", checkpoint=os.path.basename(ckpt),
         runs=evals, confusion_entries_apart=apart,
         tolerance=f"fused vs ops confusion: |diff|/2 <= {CM_SHARE} * n",
         ok=ok)
    if not ok:
        raise AssertionError("cli.evaluate failed, missed its block_eval "
                             "launches, or the fused confusion matrix "
                             "disagrees with the op path's")

    # ---- cli.export: pt against the checkpoint, pt2 against block_eval ---
    with contextlib.redirect_stdout(io.StringIO()):    # its [data] line
        distances = resolve_distances(cfg)
    cfg32 = model_config_from(parse_config(flags + ["--parallel.precision",
                                                    "default"]))
    test_ds = build_datasets(cfg)[2]
    xs = [x for x, _, _ in batches(test_ds, B, mode="fixed", fixed_len=T)]
    x64, x17 = xs[0], xs[1][:PT2_BATCHES[1]]
    pt_path = os.path.join(tmp, "model.pt")
    rc_pt, _ = run_main(export.main, flags + ["--checkpoint", ckpt, "--out",
                                              pt_path])
    p_file = Predictor.from_state_dict(torch.load(pt_path), cfg32,
                                       distances=distances, max_batch=B)
    p_ckpt = Predictor.from_checkpoint(ckpt, cfg32, distances=distances,
                                       max_batch=B)
    pt_err = float(np.abs(p_file.predict_batch(x64)
                          - p_ckpt.predict_batch(x64)).max())
    del p_file, p_ckpt
    pt2_path = os.path.join(tmp, "model.pt2")
    rc_pt2, text = run_main(export.main, flags + [
        "--checkpoint", ckpt, "--out", pt2_path, "--format", "pt2",
        "--dynamic-batch", "--seq-len", str(T)])
    program = torch.export.load(pt2_path).module()
    fused = Predictor.from_checkpoint(ckpt, model_config_from(cfg),
                                      distances=distances, max_batch=B)
    agree = total = 0
    with torch.no_grad():
        for xb in (x64, x17):
            probs = program(torch.from_numpy(xb).to(dev))
            if probs.shape != (len(xb), 6) or not bool(
                    torch.isfinite(probs).all()):
                raise AssertionError("the pt2 program's output has the "
                                     "wrong shape or is not finite")
            ref = fused.predict_batch(xb).argmax(-1)
            agree += int((probs.argmax(-1).cpu().numpy() == ref).sum())
            total += len(xb)
        x_dev = torch.from_numpy(x64).to(dev)
        pt2_ms = cuda_time_ms(lambda: program(x_dev), reps=5)
    agreement = agree / total
    ok = (rc_pt == 0 and rc_pt2 == 0 and pt_err <= PT_TOL
          and agreement >= ARGMAX_AGREEMENT)
    emit("tools", tool="export", pt_vs_checkpoint_max_abs_prob_diff=pt_err,
         pt2_batches=list(PT2_BATCHES), pt2_bytes=os.path.getsize(pt2_path),
         pt2_argmax_agreement_vs_fused=agreement, pt2_sequences=total,
         pt2_forward_ms=pt2_ms, eval_forward_ms=eval_forward_ms,
         pt2_line=text.strip().splitlines()[-1], batch=B, frames=T,
         dtype="bfloat16", nvidia_smi=smi,
         tolerance=(f"pt: max |prob diff| <= {PT_TOL} (float32); pt2: "
                    f"argmax agreement >= {ARGMAX_AGREEMENT}"), ok=ok)
    if not ok:
        raise AssertionError("cli.export's pt or pt2 file does not answer "
                             "as the checkpoint does")
    del program, fused

    # ---- cli.preprocess on a JSON keypoint tree; report's CSV reader -----
    tree = os.path.join(tmp, "openpose")
    expected = keypoint_tree(tree, np.random.default_rng(SEED))
    kp_dir = os.path.join(tree, "keypoints")
    out_dir = os.path.join(tree, "npy")
    dist_path = os.path.join(tree, "distances.npy")
    codes = {}
    for cmd, argv in (
            ("openpose", ["--keypoints", kp_dir, "--out", out_dir]),
            ("distances", ["--data", out_dir, "--out", dist_path]),
            ("check", ["--videos", os.path.join(tree, "videos"),
                       "--keypoints", kp_dir]),
            ("reprocess", ["--keypoints", kp_dir, "--max-missing", "2"])):
        codes[cmd], text = run_main(preprocess.main, [cmd, *argv])
        if cmd == "reprocess":
            redo = sorted(text.split())
    meta = read_metadata(os.path.join(out_dir, "metadata.csv"))
    rows_ok = len(meta["filename"]) == len(expected)
    for stem, (action, frames, _) in expected.items():
        subject, _, scenario, _ = stem.split("_")
        name = f"{subject}_{action}_{scenario}.npy"
        rows_ok &= name in meta["filename"] and np.array_equal(
            np.load(os.path.join(out_dir, name)), frames)

    def longest_run(skipped):
        best = run = 0
        for i, f in enumerate(skipped):
            run = run + 1 if i and skipped[i - 1] == f - 1 else 1
            best = max(best, run)
        return best

    want_redo = sorted(stem for stem, (_, _, sk) in expected.items()
                       if longest_run(sk) >= 2)
    dist = np.load(dist_path)
    curves = {}
    for tag in ("train_loss", "val_loss", "step_loss"):
        steps_, values = report.read_metric_csv(
            os.path.join(cli["log_dir"], f"{tag}.csv"))
        curves[tag] = dict(rows=len(steps_),
                           finite=bool(np.isfinite(values).all()),
                           smoothed_rows=len(report.moving_average(values)))
    epochs_logged = CLI_EPOCHS + 1      # two epochs, then the resumed third
    ok = (all(rc == 0 for rc in codes.values()) and rows_ok
          and dist.shape == (V,) and bool(np.isfinite(dist).all())
          and (redo == want_redo or (not want_redo
                                     and redo == "nothing to reprocess"
                                     .split()))
          and curves["train_loss"]["rows"] == epochs_logged
          and curves["val_loss"]["rows"] == epochs_logged
          and all(c["finite"] and c["rows"] == c["smoothed_rows"] > 0
                  for c in curves.values()))
    emit("tools", tool="preprocess_report", videos=len(expected),
         frames_per_video=PREPROCESS_FRAMES, codes=codes,
         metadata_rows=len(meta["filename"]), npy_equal=rows_ok,
         mean_distance=float(dist.mean()), reprocess=redo,
         expected_reprocess=want_redo, report_curves=curves, ok=ok)
    if not ok:
        raise AssertionError("cli.preprocess or report's CSV reader gave "
                             "other files or values than the inputs")


# ---- the model routes off the main path -------------------------------------
# (name, config over bench.py's, the config it is held against)
REMAT_CASES = (("route_A_remat", dict(layout="vntc", remat=True),
                dict(layout="vntc")),
               ("route_B_selective", dict(spatial_impl="pallas",
                                          temporal_impl="pallas",
                                          remat="selective"),
                dict(spatial_impl="pallas", temporal_impl="pallas")))
TEMPORAL_OPTIONS = ("conv_vt", "shift_sum", "block")
REMAT_GRAD_REL = 1e-6    # remat against none where not bitwise (reason)
IMPL_GRAD_REL = 2e-2     # a bf16 temporal impl's gradient against the f32
                         # conv oracle's, of the largest: reported only,
                         # since the bf16 conv path itself lies 5.0% of the
                         # largest from it at this width (H100 80GB HBM3,
                         # 700.00 W); each bf16 impl is held to GRAD_VS_F64
                         # times the bf16 conv path's distance instead


def route_options_phase(smi: str, dev) -> None:
    """remat, bits8 dropout and the temporal impls at full width (module
    docstring, phase 18), from a generator of their own; fails on any
    check."""
    import math

    import torch

    from stgcn_tpu_torch.models.stgcn import STGCN
    from stgcn_tpu_torch.training.loop import forward_backward, make_train_step
    from stgcn_tpu_torch.training.optimizers import adam
    from stgcn_tpu_torch.training.train_state import create_train_state

    gen = torch.Generator(device=dev).manual_seed(SEED + 20)
    x = torch.randn(B, T, V, 2, generator=gen, device=dev)
    y = torch.randint(0, 6, (B,), generator=gen, device=dev)
    conv = conv_counters()
    fused = fused_counters()

    def one_step(cfg, counters):
        """One step's gradients, launch counts and the peak memory it
        allocated above what it started with, from the weights and dropout
        generator of seed SEED; ``run`` takes a step of the same state."""
        model = STGCN(cfg, seed=SEED)
        ts = create_train_state(model, adam(1e-3), seed=SEED)
        for fn in counters.values():
            fn.launches = 0
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        loss, _, _ = forward_backward(model, ts, x, y)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - base
        counts = {k: fn.launches for k, fn in counters.items()}
        grads = [p.grad.detach().clone() for p in ts.leaves()]
        step = make_train_step(model)
        return dict(loss=loss.item(), grads=grads, launches=counts,
                    peak_mib=peak / 2 ** 20, run=lambda: step(ts, x, y))

    def in_turns(*cases):
        """Each case's step ms, timed in turns (in order, then reversed)
        after two warm steps of each (a captured step's warm-up and
        capture): the card's clocks after the host-bound tools phase and
        its allocator favour no case.  Drops the states."""
        for case in cases:
            case["run"]()
            case["run"]()
        for case in cases:
            case["step_ms"] = 0.0
        for case in cases + cases[::-1]:
            case["step_ms"] += cuda_time_ms(case["run"], reps=3,
                                            warmup=0) / 2
        for case in cases:
            del case["run"]

    def grad_diff(a, b):
        return max((p.double() - q.double()).abs().max().item()
                   for p, q in zip(a, b))

    for name, kw, base_kw in REMAT_CASES:
        got = one_step(bench_config(**kw), conv)
        ref = one_step(bench_config(**base_kw), conv)
        in_turns(ref, got)
        bitwise = all(torch.equal(p, q)
                      for p, q in zip(got["grads"], ref["grads"]))
        scale = max(g.abs().max().item() for g in ref["grads"])
        err = grad_diff(got["grads"], ref["grads"])
        n = len(bench_config().plan)
        want = {"spatial_conv.forward": 2 * n, "temporal_conv.forward": 2 * n,
                "spatial_conv.backward": n, "temporal_conv.backward": n}
        ok = ((bitwise or err <= REMAT_GRAD_REL * scale)
              and got["launches"] == want
              and ref["launches"] == {k: n for k in want}
              and math.isfinite(got["loss"]) and got["loss"] == ref["loss"])
        emit("route_options", case=name, config=kw, loss=got["loss"],
             grads_bitwise_equal=bitwise, grad_max_abs_err=err,
             grad_max_abs=scale, launches=got["launches"],
             launches_without=ref["launches"], step_ms=got["step_ms"],
             step_ms_without=ref["step_ms"], peak_mib=got["peak_mib"],
             peak_mib_without=ref["peak_mib"], batch=B, frames=T,
             dtype="bfloat16", nvidia_smi=smi,
             tolerance=(f"grads bitwise, else max_abs_err <= "
                        f"{REMAT_GRAD_REL} * max|grad|"), ok=ok)
        if not ok:
            raise AssertionError(f"{name}: the gradients, the loss or the "
                                 "launch counts differ from the step "
                                 "without remat")

    # ---- bits8 dropout on the fused step ----------------------------------
    cfg = bench_config(block_impl="fused", dropout_impl="bits8")
    got = one_step(cfg, fused)
    exact = one_step(bench_config(block_impl="fused"), fused)
    in_turns(exact, got)
    exact_ms = exact["step_ms"]
    model = STGCN(cfg, seed=SEED)
    ts = create_train_state(model, adam(1e-3), seed=SEED)
    step = make_train_step(model)
    fall = [float(step(ts, x, y)["loss"]) for _ in range(FALL_STEPS)]
    del step
    n, saves = len(cfg.plan), len(SAVE_BLOCKS)
    want = {f"{op}.{d}": k for op, k in (
        ("spatial_block", n - saves), ("spatial_block_save", saves),
        ("temporal_block", n)) for d in ("forward", "backward")}
    finite = math.isfinite(got["loss"]) and all(
        bool(torch.isfinite(p).all()) for p in ts.leaves())
    ok = finite and got["launches"] == want and fall[-1] < fall[0]
    emit("route_options", case="fused_bits8", launches=got["launches"],
         expected_launches=want, finite=finite, repeated_batch_losses=fall,
         step_ms=got["step_ms"], step_ms_exact_dropout=exact_ms,
         peak_mib=got["peak_mib"], batch=B, frames=T, dtype="bfloat16",
         nvidia_smi=smi, ok=ok)
    if not ok:
        raise AssertionError("the bits8 fused step missed its launches, "
                             "gave non-finite values or its loss did not "
                             "fall")
    del ts, model

    # ---- the op path's temporal impls against the f32 conv oracle ---------
    # without dropout, so that the paths' gradients compare; float32 holds
    # each impl's math (GRAD_REL, as the routes' float32 gradients), bf16
    # is the step users run, no further from the float32 oracle than
    # GRAD_VS_F64 times the bf16 conv path is
    def plain(impl, dt):
        return bench_config(temporal_impl=impl, dropout_rate=0.0,
                            compute_dtype=dt)

    oracle = one_step(plain("conv", None), {})
    scale = max(g.abs().max().item() for g in oracle["grads"])
    yardstick = one_step(plain("conv", torch.bfloat16), {})
    conv_bf16_err = grad_diff(yardstick["grads"], oracle["grads"])
    runs = {impl: (one_step(plain(impl, None), {}),
                   one_step(plain(impl, torch.bfloat16), {}))
            for impl in TEMPORAL_OPTIONS}
    in_turns(oracle, yardstick, *(c for pair in runs.values() for c in pair))
    for impl, (f32, bf16) in runs.items():
        f32_err = grad_diff(f32["grads"], oracle["grads"])
        bf16_err = grad_diff(bf16["grads"], oracle["grads"])
        ok = (math.isfinite(bf16["loss"]) and math.isfinite(f32["loss"])
              and f32_err <= GRAD_REL * scale
              and bf16_err <= GRAD_VS_F64 * conv_bf16_err)
        emit("route_options", case=f"temporal_{impl}",
             f32_vs_f32_conv_grad_max_abs_err=f32_err,
             bf16_vs_f32_conv_grad_max_abs_err=bf16_err,
             bf16_conv_vs_f32_conv_grad_max_abs_err=conv_bf16_err,
             f32_conv_grad_max_abs=scale,
             bf16_within_share=bf16_err <= IMPL_GRAD_REL * scale,
             bf16_loss=bf16["loss"], f32_loss=f32["loss"],
             f32_conv_loss=oracle["loss"], step_ms=bf16["step_ms"],
             bf16_conv_step_ms=yardstick["step_ms"],
             f32_step_ms=f32["step_ms"], f32_conv_step_ms=oracle["step_ms"],
             dropout=0.0, batch=B, frames=T, nvidia_smi=smi,
             tolerance=(f"f32 grad max_abs_err <= {GRAD_REL} * max|f32 conv "
                        f"grad|; bf16 <= {GRAD_VS_F64} * the bf16 conv "
                        f"path's (against {IMPL_GRAD_REL} * max: "
                        f"bf16_within_share)"), ok=ok)
        if not ok:
            raise AssertionError(f"temporal_impl={impl}: the gradient is "
                                 "off the float32 conv oracle's, or in bf16 "
                                 "further than the bf16 conv path's")

# ---- 21. graph: the compiled step -------------------------------------------
# (name, config over bench.py's, launches a step of each op: n each way, or
# (forward, backward) where a recompute launches the forwards again)
GRAPH_CASES = (("fused", dict(block_impl="fused"),
                {"spatial_block": 8, "spatial_block_save": 2,
                 "temporal_block": 10}),
               ("route_A", ROUTES["A"],
                {"spatial_conv": 10, "temporal_conv": 10}),
               ("route_B", ROUTES["B"],
                {"spatial_conv": 10, "temporal_conv": 10}),
               ("hybrid", dict(block_impl="hybrid", fused_blocks=FUSED_BLOCKS),
                {"spatial_block": 7, "spatial_block_save": 0,
                 "temporal_block": 7}),
               ("ops", {}, {}),
               ("route_A_remat", REMAT_CASES[0][1],
                {"spatial_conv": (20, 10), "temporal_conv": (20, 10)}),
               ("route_B_selective", REMAT_CASES[1][1],
                {"spatial_conv": (20, 10), "temporal_conv": (20, 10)}),
               ("fused_checked", dict(block_impl="fused"),
                {"spatial_block": 8, "spatial_block_save": 2,
                 "temporal_block": 10}))
# a remat case's config without remat: held against it, its pool beside
# the case's and its captured step timed beside the case's
GRAPH_WITHOUT = {name: base for name, _, base in REMAT_CASES}
# cases of make_checked_train_step, timed beside the unchecked step
GRAPH_CHECKED = ("fused_checked",)
CHECKED_STEP_REL = 0.10  # the checked step's ms over the unchecked's, less 1
GRAPH_REPLAYS = 3        # replays held against as many eager steps
GRAPH_SERVE_ROUNDS = 2   # rounds of captured, eager, eager, captured
PRE_ROLL = 32            # launches that open each trace, not counted
# traces of one call at most, until one counts the launches expected: a
# trace can lose a kernel's record (a driver's run read one eager step's
# trace short once, its counters and the replay's trace exact); a trace
# that counts more than expected fails at once
TRACE_TRIES = 3
PRE_ROLL_KERNEL = "spin_kernel"  # torch.cuda._sleep's
# kernels a profiler trace counts, each launched once by one op call of a
# direction: the spatial ops' forward and t kernels, the temporal ops' dWt
# kernel (their backward) and tap GEMM (their forward, and their
# backward's dx), block_eval's spatial kernel
TRACE_KERNELS = {"spatial.forward": "spatial_wg_fwd_kernel",
                 "spatial.backward": "spatial_wg_t_kernel",
                 "temporal.dwt": "tap_dwt_kernel",
                 "temporal.gemm": "tap_gemm_kernel",
                 "block_eval": "block_eval_spatial_kernel"}


def trace_call(fn) -> tuple[dict, float]:
    """One call of ``fn`` under ``torch.profiler``: the launches of each of
    TRACE_KERNELS by kernel name, and the device's busy ms (every kernel,
    copy and set, summed), after PRE_ROLL spin kernels that neither
    counts."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        # a pre-roll: a trace can miss the first kernels after it starts
        # (one of an eager step's first forward kernels went missing once)
        for _ in range(PRE_ROLL):
            torch.cuda._sleep(1000)
        torch.cuda.synchronize()
        time.sleep(0.05)
        fn()
        torch.cuda.synchronize()
    counts, busy = dict.fromkeys(TRACE_KERNELS, 0), 0.0
    for ev in prof.key_averages():
        total = (getattr(ev, "device_time_total", None)
                 or getattr(ev, "cuda_time_total", 0))
        if not total or PRE_ROLL_KERNEL in ev.key:
            continue
        busy += total / 1e3
        for fam, name in TRACE_KERNELS.items():
            if name in ev.key:
                counts[fam] += ev.count
    return counts, busy


def trace_launches(fn, want: dict) -> tuple[dict, float, list]:
    """``trace_call(fn)`` again, at most TRACE_TRIES times, until a trace
    counts ``want`` or counts more of a kernel than it: the last trace's
    counts and busy ms, and every trace's counts."""
    tries = []
    for _ in range(TRACE_TRIES):
        counts, busy = trace_call(fn)
        tries.append(counts)
        if counts == want or any(counts[k] > want[k] for k in want):
            break
    return counts, busy, tries


def traced_from_counters(launches: dict) -> dict:
    """What TRACE_KERNELS should count for these wrapper launches."""
    def n(*keys):
        return sum(launches.get(k, 0) for k in keys)

    spatial = ("spatial_block", "spatial_block_save", "spatial_conv")
    temporal = ("temporal_block", "temporal_conv")
    return {"spatial.forward": n(*(f"{s}.forward" for s in spatial)),
            "spatial.backward": n(*(f"{s}.backward" for s in spatial)),
            "temporal.dwt": n(*(f"{t}.backward" for t in temporal)),
            "temporal.gemm": n(*(f"{t}.{d}" for t in temporal
                                 for d in ("forward", "backward"))),
            "block_eval": launches.get("block_eval", 0)}


def memory_checkpoint(before: str) -> None:
    """Between phases: collect Python's cyclic garbage (a graph held in a
    cycle keeps its memory pool reserved until then) and the allocator's
    cached blocks, and report the device memory before and after."""
    import gc

    import torch

    from stgcn_tpu_torch.training import graphs

    def reading():
        private = sum(seg["total_size"] - seg["allocated_size"]
                      for seg in torch.cuda.memory_snapshot()
                      if seg.get("segment_pool_id", (0, 0)) != (0, 0))
        return {"reserved_mib": torch.cuda.memory_reserved() / 2 ** 20,
                "allocated_mib": torch.cuda.memory_allocated() / 2 ** 20,
                "graph_pools_free_mib": private / 2 ** 20,
                "graphs_alive": sum(len(c.graphs)
                                    for c in graphs._CAPTURES.values())}

    found = reading()
    gc.collect()
    torch.cuda.empty_cache()
    emit("memory", before=before, found=found, after_collect=reading())


def pool_mib(pool) -> tuple[float, float]:
    """Reserved and allocated MiB of the segments of a CUDA-graph memory
    pool (``torch.cuda.memory_snapshot``)."""
    import torch

    reserved = allocated = 0
    for seg in torch.cuda.memory_snapshot():
        if tuple(seg.get("segment_pool_id", ())) == tuple(pool):
            reserved += seg["total_size"]
            allocated += seg["allocated_size"]
    return reserved / 2 ** 20, allocated / 2 ** 20


def peak_mib(fn) -> float:
    """MiB ``fn`` allocated at its peak above what was allocated before."""
    import torch

    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    fn()
    torch.cuda.synchronize()
    return (torch.cuda.max_memory_allocated() - base) / 2 ** 20


def issue_ms(fn, reps: int = 3) -> float:
    """The host's ms to issue one call of ``fn`` (from an idle device, no
    synchronisation inside the timed span)."""
    import torch

    total = 0.0
    for _ in range(reps):
        torch.cuda.synchronize()
        start = time.perf_counter()
        fn()
        total += time.perf_counter() - start
    torch.cuda.synchronize()
    return total * 1e3 / reps


def max_distance(got: list, want: list) -> float:
    """The largest elementwise distance between two lists of tensors, NaN
    where any distance is (Python's ``max`` would skip a NaN after the
    first element)."""
    found = [(a.double() - b.double()).abs().max().item()
             if a.numel() else 0.0 for a, b in zip(got, want)]
    return float("nan") if any(d != d for d in found) else max(found)


def graph_state_tensors(ts) -> list:
    """What the comparison reads of a train state: parameters, BN
    statistics, Adam's moments, the gradients of the last step."""
    return ts.tensors() + [p.grad for p in ts.leaves()]


def per_direction(want: dict) -> dict:
    """GRAPH_CASES' launches of each op as ``{"op.forward": n, ...}``."""
    out = {}
    for op, n in want.items():
        forward, backward = n if isinstance(n, tuple) else (n, n)
        for d, k in (("forward", forward), ("backward", backward)):
            if k:
                out[f"{op}.{d}"] = k
    return out


def checked_trips(step, ts, x, y) -> tuple[dict, bool]:
    """fused_checked's bad batches, each a replay of the captured checked
    step: a label of 6 and a NaN in ``x`` must raise ``InvariantError``
    naming the check, with no device-side assert, and leave the state
    (parameters, moments, BN statistics, the optimizer's scalars,
    ``step`` and the count) bitwise as it was.  The NaN trips a
    non-finite check: on the fused kernels the gradient's, since their
    ReLU (``fmaxf``) takes a NaN to 0 and the loss stays finite, where
    the op path's ``torch.relu`` carries it into the loss."""
    import torch

    from stgcn_tpu_torch.training.checks import InvariantError

    y_bad = y.clone()
    y_bad[0] = 6
    x_bad = x.clone()
    x_bad[1, 2, 3, 0] = float("nan")
    found, ok = {}, True
    for case, args, check in (("label_6", (x, y_bad), "label out of range"),
                              ("nan_x", (x_bad, y), "non-finite ")):
        before = [t.clone() for t in ts.tensors()]
        counts = (ts.step, ts.optimizer.count)
        try:
            step(ts, *args)
            raised = None
        except InvariantError as err:
            raised = str(err)
        torch.cuda.synchronize()
        unchanged = (all(torch.equal(a, b) for a, b in
                         zip(before, ts.tensors()))
                     and (ts.step, ts.optimizer.count) == counts)
        found[case] = dict(raised=raised, replayed=step.captured,
                           state_unchanged=unchanged)
        ok = ok and (raised is not None and check in raised
                     and step.captured and unchanged)
    return found, ok


def graph_phase(smi: str, dev, cases=None, serving: bool = True) -> dict:
    """The captured steps (module docstring, phase 21), of GRAPH_CASES
    named in ``cases`` (all by default) and, with ``serving``, the
    ``Predictor``; fails on any check.  Returns each case's figures."""
    import gc

    import torch

    from stgcn_tpu_torch.kernels.block_eval import block_eval
    from stgcn_tpu_torch.models.stgcn import STGCN
    from stgcn_tpu_torch.serving import Predictor
    from stgcn_tpu_torch.training.checks import make_checked_train_step
    from stgcn_tpu_torch.training.graphs import capture_pool
    from stgcn_tpu_torch.training.loop import make_train_step
    from stgcn_tpu_torch.training.optimizers import adam
    from stgcn_tpu_torch.training.train_state import create_train_state

    counters = {**fused_counters(), **conv_counters()}
    results = {}
    for i, (name, kw, want) in enumerate(GRAPH_CASES):
        if cases is not None and name not in cases:
            continue
        cfg = bench_config(**kw)
        gen = torch.Generator(device=dev).manual_seed(SEED + 30 + i)
        x = torch.randn(B, T, V, 2, generator=gen, device=dev)
        y = torch.randint(0, 6, (B,), generator=gen, device=dev)
        model = STGCN(cfg, seed=SEED)
        make = (make_checked_train_step if name in GRAPH_CHECKED
                else make_train_step)
        states = {k: create_train_state(model, adam(1e-3), seed=SEED)
                  for k in ("captured", "eager", "eager_again")}
        steps = {"captured": make(model),
                 "eager": make(model, capture=False),
                 "eager_again": make(model, capture=False)}
        without = GRAPH_WITHOUT.get(name)
        if without is not None:
            # the captured step without remat, from the same weights
            base_model = STGCN(bench_config(**without), seed=SEED)
            states["without"] = create_train_state(base_model, adam(1e-3),
                                                   seed=SEED)
            steps["without"] = make_train_step(base_model)
        # the same steps from the same state, seed and batch; cuDNN's
        # deterministic algorithms, so that eager repeats itself
        torch.backends.cudnn.deterministic = True
        losses = {k: [] for k in steps}
        launches, eager_launches = [], []

        def step_all():
            for k, step in steps.items():
                reset(counters)
                out = step(states[k], x, y)
                losses[k].append(out["loss"].clone())
                if k == "captured":
                    launches.append(read(counters))
                elif k == "eager":
                    eager_launches.append(read(counters))

        for _ in range(1 + GRAPH_REPLAYS):   # a warm-up, then replays
            step_all()
        trips, trips_ok = {}, True
        if name in GRAPH_CHECKED:
            trips, trips_ok = checked_trips(steps["captured"],
                                            states["captured"], x, y)
            step_all()      # the next good replay against the eager step
        torch.backends.cudnn.deterministic = False
        step = steps["captured"]
        captured, graphs = step.captured, step.cache_size
        got = graph_state_tensors(states["captured"]) + losses["captured"]
        ref = graph_state_tensors(states["eager"]) + losses["eager"]
        again = graph_state_tensors(states["eager_again"]) + \
            losses["eager_again"]
        eager_dist = max_distance(again, ref)
        graph_dist = max_distance(got, ref)
        bitwise = all(torch.equal(a, b) for a, b in zip(got, ref))
        per_step = {k: n for k, n in launches[-1].items() if n}
        expected = per_direction(want)
        eager_per_step = [{k: n for k, n in c.items() if n}
                          for c in eager_launches]
        remat, remat_ok = {}, True
        if without is not None:
            # remat against none: the state, gradients and losses bitwise,
            # else the gradients within REMAT_GRAD_REL of the largest
            base = graph_state_tensors(states["without"]) + \
                losses["without"]
            grads = [p.grad for p in states["captured"].leaves()]
            base_grads = [p.grad for p in states["without"].leaves()]
            scale = max(g.abs().max().item() for g in base_grads)
            remat = dict(bitwise_equal_without=all(
                torch.equal(a, b) for a, b in zip(got, base)),
                max_dist_vs_without=max_distance(got, base),
                grad_max_abs_err_vs_without=max_distance(grads, base_grads),
                grad_max_abs=scale, tolerance=(
                    f"bitwise, else grad max_abs_err <= {REMAT_GRAD_REL} "
                    "* max|grad|"))
            remat_ok = (remat["bitwise_equal_without"] or
                        remat["grad_max_abs_err_vs_without"]
                        <= REMAT_GRAD_REL * scale)
            del steps["without"], base, grads, base_grads
        # timing: a step captured with cuDNN's default algorithms (the one
        # above holds its deterministic ones), two warm calls of each
        step = steps["captured"] = make(model)
        gc.collect()    # the graphs above gone, the pool released
        memory = {}
        if without is not None:
            # the pool of the captured step without remat, alone
            probe = make_train_step(base_model)
            for _ in range(2):
                probe(states["without"], x, y)
            memory["pool_reserved_mib_without"], \
                memory["pool_allocated_mib_without"] = \
                pool_mib(capture_pool(dev))
            del probe
            gc.collect()
        runs = {k: (lambda k=k: steps[k](states[k], x, y))
                for k in ("captured", "eager")}
        for k in runs:
            runs[k]()
        # the capture's cost, jit's compile time: host seconds of the call
        # that captures and replays, beside a replay's
        torch.cuda.synchronize()
        start = time.perf_counter()
        runs["captured"]()
        torch.cuda.synchronize()
        capture_s = time.perf_counter() - start
        runs["eager"]()
        # memory: the graph's pool, alone
        memory["pool_reserved_mib"], memory["pool_allocated_mib"] = \
            pool_mib(capture_pool(dev))
        if without is not None:
            memory["pool_ratio_vs_without"] = (
                memory["pool_reserved_mib"]
                / memory["pool_reserved_mib_without"])
            steps["without"] = make_train_step(base_model)
            runs["without"] = lambda: steps["without"](states["without"],
                                                       x, y)
        if name in GRAPH_CHECKED:
            # the unchecked captured step of the same config
            states["unchecked"] = create_train_state(model, adam(1e-3),
                                                     seed=SEED)
            steps["unchecked"] = make_train_step(model)
            runs["unchecked"] = lambda: steps["unchecked"](
                states["unchecked"], x, y)
        for k in ("without", "unchecked"):
            if k in runs:
                runs[k]()
                runs[k]()
        # one replay and one eager step traced: launches by kernel name
        want_trace = traced_from_counters(expected)
        replay_trace, replay_busy, replay_tries = trace_launches(
            runs["captured"], want_trace)
        eager_trace, eager_busy, eager_tries = trace_launches(
            runs["eager"], want_trace)
        times = {k: [] for k in runs}
        order = list(runs)
        for k in order + order[::-1]:
            times[k].append(cuda_time_ms(runs[k], reps=3, warmup=0))
        step_ms = {k: float(np.mean(v)) for k, v in times.items()}
        issued = {k: issue_ms(runs[k]) for k in ("captured", "eager")}
        # the host's ms of the replay alone, without the step's host work
        graph = next(e.graph for e in step._entries.values())
        issued["replay_only"] = issue_ms(graph.replay)
        busy = {"captured": replay_busy, "eager": eager_busy}
        idle = {k: 1 - busy[k] / step_ms[k] for k in busy}
        memory["eager_peak_mib"] = peak_mib(runs["eager"])
        checked_ok = True
        if name in GRAPH_CHECKED:
            trips["ms_over_unchecked"] = (step_ms["captured"]
                                          / step_ms["unchecked"])
            checked_ok = trips["ms_over_unchecked"] <= 1 + CHECKED_STEP_REL
        ok = (captured and graphs == 1
              and (bitwise if eager_dist == 0 else graph_dist <= eager_dist)
              and all(launches[i] == launches[0] for i in range(1, len(
                  launches)))
              and per_step == expected
              and all(c == expected for c in eager_per_step)
              and replay_trace == want_trace
              and eager_trace == want_trace and remat_ok and trips_ok
              and checked_ok
              and (without is None or memory["pool_ratio_vs_without"] < 1))
        results[name] = dict(step_ms=step_ms, issue_ms=issued,
                             idle_share=idle, memory=memory)
        emit("graph", case=name, captured=captured, graphs=graphs,
             bitwise_equal=bitwise,
             max_dist_vs_eager=graph_dist, eager_vs_eager=eager_dist,
             losses=[float(v) for v in losses["captured"]],
             eager_losses=[float(v) for v in losses["eager"]],
             launches_per_call=launches, expected_per_step=expected,
             eager_launches_per_step=eager_per_step,
             replay_trace=replay_trace, eager_trace=eager_trace,
             expected_trace=want_trace, replay_traces=replay_tries,
             eager_traces=eager_tries, step_ms=step_ms,
             step_ms_turns=times, issue_ms=issued, device_busy_ms=busy,
             idle_share=idle, memory=memory, capture_s=capture_s,
             remat=remat, checks=trips, batch=B, frames=T,
             dtype="bfloat16",
             dropout=cfg.dropout_rate, nvidia_smi=smi, ok=ok)
        del states, steps, model, runs, step, graph
        if without is not None:
            del base_model
        gc.collect()
        torch.cuda.empty_cache()
        if not ok:
            raise AssertionError(
                f"the captured {name} step: captured {captured}, graphs "
                f"{graphs}, bitwise {bitwise} ({graph_dist} against "
                f"eager-vs-eager {eager_dist}), launches a call "
                f"{launches}, a replay {per_step} against {expected}, "
                f"eager steps {eager_per_step}, traces replay "
                f"{replay_tries} eager {eager_tries} against "
                f"{want_trace}, remat against none {remat}, "
                f"checks {trips}, memory {memory}")

    if not serving:
        return results

    # ---- serving: one graph a bucket, bitwise the eager forward ----------
    serve = STGCN(bench_config(dropout_rate=0.0)).to(dev)
    randomize_batchnorm(serve, torch.Generator().manual_seed(SEED + 35))
    buckets = (T // 2, T)
    captured = Predictor(serve, buckets=buckets, max_batch=B)
    eager = Predictor(serve, buckets=buckets, max_batch=B, capture=False)
    captured.warmup()
    eager.warmup()
    rng = np.random.default_rng(SEED + 36)
    batches = [rng.standard_normal((B, t, V, 2)).astype(np.float32)
               for t in buckets for _ in range(4)]
    before = block_eval.launches
    probs = [captured.predict_batch(b) for b in batches]
    serve_launches = block_eval.launches - before
    want_probs = [eager.predict_batch(b) for b in batches]
    bitwise = all(np.array_equal(a, b) for a, b in zip(probs, want_probs))
    stream = list(captured.predict_stream(batches))
    stream_ok = all(np.array_equal(a, b) for a, b in zip(stream, probs))
    rounds = {"captured": {"serial": [], "pipelined": []},
              "eager": {"serial": [], "pipelined": []}}
    preds = {"captured": captured, "eager": eager}
    for _ in range(GRAPH_SERVE_ROUNDS):
        for k in ("captured", "eager", "eager", "captured"):
            start = time.perf_counter()
            for b in batches:
                preds[k].predict_batch(b)
            rounds[k]["serial"].append(
                len(batches) * B / (time.perf_counter() - start))
            start = time.perf_counter()
            for _ in preds[k].predict_stream(batches):
                pass
            rounds[k]["pipelined"].append(
                len(batches) * B / (time.perf_counter() - start))
    ok = (captured._step.captured and captured._step.cache_size ==
          len(buckets) and not eager._step.captured and bitwise and stream_ok
          and serve_launches == len(batches) * len(serve.config.plan))
    emit("graph", case="serving", captured=captured._step.captured,
         graphs=captured._step.cache_size, buckets=list(buckets),
         bitwise_equal=bitwise, stream_equal=stream_ok,
         block_eval_launches=serve_launches,
         seq_per_s={k: {m: float(np.mean(v)) for m, v in r.items()}
                    for k, r in rounds.items()},
         seq_per_s_rounds=rounds, batch=B, dtype="bfloat16",
         nvidia_smi=smi, ok=ok)
    if not ok:
        raise AssertionError("the captured Predictor did not capture a "
                             "graph a bucket, or answered otherwise than "
                             "the eager forward")
    results["serving"] = {k: {m: float(np.mean(v)) for m, v in r.items()}
                          for k, r in rounds.items()}
    del captured, eager, serve
    torch.cuda.empty_cache()
    return results


# ---- 22. bench_tools: the measurement tools -------------------------------
# bench.py's keys, the one JSON line of bench_torch.py too
BENCH_KEYS = ("metric", "value", "unit", "vs_baseline",
              "b128_sequences_per_s", "b128_vs_baseline",
              "eval_forward_ms_fused", "serving_serial_seq_per_s",
              "serving_pipelined_seq_per_s")
# bench_torch's fused step against phase 21's captured fused step, the
# same step timed over 20 steps on the host's clock against 3 by CUDA
# events: the step is device-bound (idle under 2%, PERF.md section 5), so
# within 10%
BENCH_STEP_REL = 0.10
STRATEGY_TIMEOUT_S = 300
# each --parallel-cards tool; above the tool's own RANK_TIMEOUT_S, after
# which it kills its ranks itself
TOOL_TIMEOUT_S = 420


def scripts_on_path() -> Path:
    """The repo root and its scripts/ on ``sys.path``; returns the
    root."""
    root = Path(__file__).resolve().parent
    for p in (root, root / "scripts"):
        if str(p) not in sys.path:
            sys.path.insert(0, str(p))
    return root


def call_main(main, argv: list[str]) -> tuple[int, str, str]:
    """A tool's ``main(argv)`` in this process: its exit code, stdout and
    stderr."""
    import contextlib
    import io

    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = main(argv)
    return rc, out.getvalue(), err.getvalue()


def json_lines(text: str) -> list[dict]:
    return [json.loads(line) for line in text.splitlines()
            if line.startswith("{")]


def finite(*values) -> bool:
    return all(isinstance(v, (int, float)) and np.isfinite(v) and v > 0
               for v in values)


def bench_tools_phase(smi: str, graph_results: dict, tmp: str) -> None:
    """Phase 22 (module docstring); fails on any check."""
    bench_torch_check(smi, graph_results["fused"]["step_ms"]["captured"])
    memory_checkpoint("torch_serving_bench")
    serving_bench_check(smi, tmp)
    memory_checkpoint("torch_scaling_bench")
    scaling_bench_check(smi)
    memory_checkpoint("torch_strategy_table")
    strategy_row_check(smi, tmp)


def bench_torch_check(smi: str, graph_ms: float) -> None:
    """``bench_torch.main`` in this process, the kernels' counts read
    around it."""
    from stgcn_tpu_torch.kernels.block_eval import block_eval

    scripts_on_path()
    import bench_torch

    counters = {**fused_counters(), "block_eval": block_eval}
    reset(counters)
    start = time.perf_counter()
    rc, out, err = call_main(bench_torch.main, [])
    seconds = time.perf_counter() - start
    launches = read(counters)
    line = json_lines(out)[-1]
    ms = {k: float(v) for k, v in re.findall(r" (\w+_ms)=([\d.]+)", err)}
    # every train case takes 2 + STEPS steps (a warm-up and a capture
    # first), the fused B=64 captured and eager and the B=128; every
    # forward launches 10 block_eval: the device-resident one's 2 warm +
    # 20 timed calls, the Predictor's 2 warm-up calls, its untimed round
    # and its timed rounds, each serial and pipelined
    steps = 3 * (2 + bench_torch.STEPS)
    forwards = (2 + bench_torch.FORWARD_REPS + 2 + 2 * (
        1 + bench_torch.SERVE_ROUNDS) * bench_torch.SERVE_BATCHES)
    want = {"spatial_block.forward": 8 * steps,
            "spatial_block.backward": 8 * steps,
            "spatial_block_save.forward": 2 * steps,
            "spatial_block_save.backward": 2 * steps,
            "temporal_block.forward": 10 * steps,
            "temporal_block.backward": 10 * steps,
            "block_eval": 10 * forwards}
    ok = (rc == 0 and tuple(line) == BENCH_KEYS
          and line["metric"] == "train_throughput_stgcn10_b64_t304_bf16"
          and finite(*(line[k] for k in BENCH_KEYS[1:] if k != "unit"))
          and "captured=True" in err
          and abs(ms["step_ms"] - graph_ms) <= BENCH_STEP_REL * graph_ms
          and launches == want)
    emit("bench_tools", tool="bench_torch.py", rc=rc, line=line,
         stderr=err.strip().splitlines()[-1], step_ms=ms,
         graph_captured_fused_step_ms=graph_ms,
         step_vs_graph=ms["step_ms"] / graph_ms, launches=launches,
         expected_launches=want, seconds=seconds, nvidia_smi=smi, ok=ok)
    if not ok:
        raise AssertionError(
            f"bench_torch.py: rc {rc}, keys {list(line)}, step "
            f"{ms.get('step_ms')} ms against phase graph's {graph_ms}, "
            f"launches {launches} against {want}:\n{err[-2000:]}")


def serving_bench_check(smi: str, tmp: str) -> None:
    """``scripts/torch_serving_bench.py`` at batches 1 and 64."""
    scripts_on_path()
    import torch_serving_bench

    serving_out = str(Path(tmp) / "SERVING_torch.json")
    rc, out, err = call_main(torch_serving_bench.main,
                             ["--batches", "1,64", "--out", serving_out])
    doc = json.loads(Path(serving_out).read_text())
    rows = doc["results"]
    ok = (rc == 0 and [r["batch"] for r in rows] == [1, 64]
          and all(finite(r["p50_ms"], r["p95_ms"], r["sequences_per_s"])
                  for r in rows)
          and finite(doc["interleaved"]["serial_seq_per_s_median"],
                     doc["interleaved"]["pipelined_seq_per_s_median"])
          and [r["forward"] for r in doc["device_resident"]] ==
          ["op_path", "fused"]
          and all(finite(r["device_resident_p50_ms"])
                  for r in doc["device_resident"])
          and doc["card"] == smi)
    emit("bench_tools", tool="scripts/torch_serving_bench.py", rc=rc,
         results=rows, interleaved={k: v for k, v in doc[
             "interleaved"].items() if not k.endswith("_rounds")},
         device_resident=doc["device_resident"], nvidia_smi=smi, ok=ok)
    if not ok:
        raise AssertionError(f"torch_serving_bench.py: rc {rc}:\n"
                             f"{out[-2000:]}{err[-2000:]}")


def scaling_bench_check(smi: str) -> None:
    """``scripts/torch_scaling_bench.py --cuda`` at B=64."""
    scripts_on_path()
    import torch_scaling_bench

    rc, out, err = call_main(torch_scaling_bench.main,
                             ["--cuda", "--batches", str(B)])
    rows = json_lines(out)
    ok = (rc == 0 and [r["block_impl"] for r in rows] == ["ops", "fused"]
          and all(r["captured"] and r["batch"] == B
                  and finite(r["step_ms"], r["edges_per_s"],
                             r["train_tflops_per_s"]) for r in rows))
    emit("bench_tools", tool="scripts/torch_scaling_bench.py --cuda",
         rc=rc, rows=rows, nvidia_smi=smi, ok=ok)
    if not ok:
        raise AssertionError(f"torch_scaling_bench.py --cuda: rc {rc}:\n"
                             f"{out[-2000:]}{err[-2000:]}")


def strategy_row_check(smi: str, tmp: str) -> None:
    """``scripts/torch_strategy_table.py``'s fused distance row for two
    epochs, as a process of its own."""
    root = scripts_on_path()
    table_out = Path(tmp) / "STRATEGY_TABLE_torch.json"
    start = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, str(root / "scripts" / "torch_strategy_table.py"),
         "--only", "distance", "--epochs", "2", "--block-impl", "fused",
         "--out", str(table_out)], cwd=root, capture_output=True, text=True,
        timeout=STRATEGY_TIMEOUT_S)
    row = (json.loads(table_out.read_text())["results"][0]
           if table_out.exists() else {})
    ok = (proc.returncode == 0 and row.get("rc") == 0
          and row.get("losses_finite") and row.get("test_acc") is not None
          and row.get("block_impl") == "fused")
    emit("bench_tools", tool="scripts/torch_strategy_table.py", rc=(
        proc.returncode), row={k: v for k, v in row.items() if k != "tail"},
         seconds=time.perf_counter() - start, nvidia_smi=smi, ok=ok)
    if not ok:
        raise AssertionError(f"torch_strategy_table.py: rc "
                             f"{proc.returncode}:\n{proc.stdout[-2000:]}"
                             f"{proc.stderr[-2000:]}")


def cards_tools(smi: str, n: int) -> None:
    """Under ``--parallel-cards``: ``torch_scaling_bench.py --cards n``
    (strong and weak data=1, 2, 4) and ``--collectives --production`` on
    data=n, each a process of its own that starts its ranks."""
    root = scripts_on_path()
    script = str(root / "scripts" / "torch_scaling_bench.py")
    for argv in (["--cards", str(n)],
                 ["--collectives", "--production", "--mesh", f"{n},1,1"]):
        start = time.perf_counter()
        proc = subprocess.run([sys.executable, script, *argv], cwd=root,
                              capture_output=True, text=True,
                              timeout=TOOL_TIMEOUT_S)
        rows = json_lines(proc.stdout)
        if argv[0] == "--cards":
            sizes = [d for d in (1, 2, 4) if d <= n]
            ok = ([(r["mode"], r["ranks"]) for r in rows] ==
                  [(f"cards_{m}", d) for d in sizes
                   for m in ("strong", "weak")]
                  and all(r["captured"] and finite(r["step_ms"])
                          for r in rows))
        else:
            grads = rows[0]["by_what"].get("all-reduce/gradients", {}) \
                if rows else {}
            ok = (len(rows) == 1 and grads.get("bytes_per_device_per_step")
                  == 4 * rows[0]["param_count"])
        emit("bench_tools", tool="scripts/torch_scaling_bench.py "
             + " ".join(argv), rc=proc.returncode, rows=rows,
             seconds=time.perf_counter() - start, nvidia_smi=smi,
             ok=ok and proc.returncode == 0)
        if not ok or proc.returncode:
            raise AssertionError(
                f"torch_scaling_bench.py {' '.join(argv)}: rc "
                f"{proc.returncode}:\n{proc.stdout[-2000:]}"
                f"{proc.stderr[-3000:]}")


# ---- 20. parallel: the mesh paths of stgcn_tpu_torch.parallel ------------
PARALLEL_STEPS = 10   # steps of the one-rank Trainer(mesh) run
# one rank: the sharded code sums as the unsharded does, so its float32
# gradients agree within 1e-6 of the largest (bitwise where the order of
# every sum is the same; the line says which)
PARALLEL_ONE_REL = 1e-6
# two ranks: other summation orders in float32 (the BN moments and the
# gradients of two halves, the conv kernels on halves of the batch).  On
# an H100 the data=2 gradient lies 3.9e-4 of the largest from the
# one-process float32 step's, which itself lies 3.8e-4 from the float64
# op path (BN statistics 1.8e-7): so each two-rank gradient is held, as
# the fused_train phase holds its kernels (GRAD_VS_F64), against the
# float64 op path, no further from it than PARALLEL_VS_F64 times the
# one-process float32 step of the same path; its distance from that step
# is reported beside PARALLEL_TWO_REL.  Absolute limits beside the ratio,
# so that a broken float64 reference cannot carry both sides: the
# one-process float32 step within PARALLEL_ONE_VS_F64_MAX of the largest
# float64 gradient (it reads 2.5-3.8e-4), each two-rank gradient within
# PARALLEL_TWO_MAX of the largest of the one-process step's and of the
# float64 path's
PARALLEL_TWO_REL = 1e-4
PARALLEL_VS_F64 = 3.0
PARALLEL_ONE_VS_F64_MAX = 1e-3
PARALLEL_TWO_MAX = 2e-3
PARALLEL_BN_REL = 1e-5
PARALLEL_TIMEOUT_S = 240       # each spawn of two ranks
SERVE_SEQUENCES = 96           # the Predictor(mesh) request


def reset(counters: dict) -> None:
    for fn in counters.values():
        fn.launches = 0


def read(counters: dict) -> dict:
    return {name: fn.launches for name, fn in counters.items()}


def rel_err(got: list, want: list) -> float:
    """max |got - want| over max |want|, over lists of tensors."""
    err = max((a.double() - b.double().to(a.device)).abs().max().item()
              for a, b in zip(got, want))
    scale = max(b.abs().max().item() for b in want)
    return err / scale


def parallel_batch(cfg):
    """The phase's B=64, T=304 batch, from numpy (the same in every
    process)."""
    rng = np.random.default_rng(SEED + 20)
    x = rng.standard_normal((B, T, V, 2)).astype(np.float32)
    y = rng.integers(0, cfg.num_classes, B).astype(np.int64)
    return x, y


def unsharded_grads(cfg, dev) -> dict:
    """One unsharded step's gradients (and new BN statistics) at the
    phase's batch, in ``cfg.dtype``, from the float32 weights of seed SEED
    (cast to ``cfg.dtype``): the references of both cases."""
    import torch

    from stgcn_tpu_torch.models.stgcn import STGCN
    from stgcn_tpu_torch.training.loop import forward_backward
    from stgcn_tpu_torch.training.optimizers import adam
    from stgcn_tpu_torch.training.train_state import train_state_from
    from stgcn_tpu_torch.tree import tree_items, tree_leaves, tree_map

    model = STGCN(cfg).to(dev)
    params, state = STGCN(dataclasses.replace(
        cfg, dtype=torch.float32)).init_params(SEED)
    ts = train_state_from(tree_map(lambda t: t.to(cfg.dtype), params),
                          state, adam(1e-3), SEED, dev)
    x, y = parallel_batch(cfg)
    loss, _, new_ms = forward_backward(
        model, ts, torch.from_numpy(x).to(dev, cfg.dtype),
        torch.from_numpy(y).to(dev))
    return {"loss": float(loss.detach()), "names": list(tree_items(ts.params)),
            "grads": [p.grad.detach().cpu() for p in ts.leaves()],
            "state": [t.detach().cpu() for t in tree_leaves(new_ms)]}


def parallel_one_rank(smi: str, dev) -> dict:
    """Case (a): a one-rank NCCL mesh in this process, every collective
    issued: ``Trainer(mesh=...)`` on bench.py's fused step, the float32
    gradient against the unsharded step's, the sharded fused eval step and
    ``Predictor(mesh=...)`` against ``Predictor``."""
    import torch
    import torch.distributed as dist

    from stgcn_tpu_torch.kernels.block_eval import block_eval
    from stgcn_tpu_torch.models.stgcn import STGCN
    from stgcn_tpu_torch.parallel.fused_dp import make_fused_dp_grads
    from stgcn_tpu_torch.parallel.mesh import make_mesh
    from stgcn_tpu_torch.parallel.train import (
        create_sharded_train_state,
        make_sharded_eval_step,
        shard_batch,
    )
    from stgcn_tpu_torch.serving import Predictor
    from stgcn_tpu_torch.training.loop import Trainer, make_train_step
    from stgcn_tpu_torch.training.optimizers import adam
    from stgcn_tpu_torch.training.train_state import create_train_state

    mesh = make_mesh(1, 1, 1)          # a one-process NCCL world on the card
    counters = fused_counters()
    cfg = bench_config(block_impl="fused")
    x, y = parallel_batch(cfg)

    # ---- the main path: Trainer(mesh) on bench.py's fused step ----------
    model = STGCN(cfg)
    trainer = Trainer(model, adam(1e-3), mesh=mesh, seed=SEED)
    ts = trainer.init_state()
    batch = trainer._put_batch(x, y)
    reset(counters)
    torch.cuda.synchronize()
    start = time.perf_counter()
    losses = [float(trainer.train_step(ts, *batch)["loss"])
              for _ in range(PARALLEL_STEPS)]
    torch.cuda.synchronize()
    seconds = time.perf_counter() - start
    launches = read(counters)
    # the unsharded fused step beside it, timed in turns after a warm step
    # of each (a step timed first after another phase reads slow)
    plain_model = STGCN(cfg)
    plain_ts = create_train_state(plain_model, adam(1e-3), seed=SEED)
    plain_step = make_train_step(plain_model)
    turns = {"unsharded": lambda: plain_step(plain_ts, *batch),
             "mesh": lambda: trainer.train_step(ts, *batch)}
    times = {k: [] for k in turns}
    for k in ("unsharded", "mesh", "mesh", "unsharded"):
        times[k].append(cuda_time_ms(turns[k], reps=5))
    step_ms = float(np.mean(times["mesh"]))
    unsharded_ms = float(np.mean(times["unsharded"]))
    del plain_ts
    per_step = {k: v / PARALLEL_STEPS for k, v in launches.items()}
    n_save = len(SAVE_BLOCKS)
    want = {"spatial_block": len(cfg.plan) - n_save,
            "spatial_block_save": n_save, "temporal_block": len(cfg.plan)}
    fell = (np.mean(losses[-3:]) < np.mean(losses[:3])
            and all(np.isfinite(losses)))
    ok = fell and all(per_step[k] == want[k.split(".")[0]] for k in per_step)
    emit("parallel", case="one_rank_trainer", mesh=[1, 1, 1],
         backend=mesh.backend, steps=PARALLEL_STEPS, losses=losses,
         seconds=seconds, launches_per_step=per_step,
         expected_per_step=want, step_ms=step_ms,
         unsharded_step_ms=unsharded_ms, step_ms_turns=times, batch=B,
         frames=T, dtype="bfloat16", dropout=cfg.dropout_rate,
         nvidia_smi=smi, ok=ok)
    if not ok:
        raise AssertionError("Trainer(mesh) did not run 8/2/10 launches a "
                             "step, or its loss did not fall")

    # ---- the float32 gradient against the unsharded fused step ----------
    cfg32 = dataclasses.replace(cfg, compute_dtype=None, dropout_rate=0.0)
    ref = unsharded_grads(cfg32, dev)
    m32 = STGCN(cfg32)
    ts32, _ = create_sharded_train_state(m32, adam(1e-3), mesh, seed=SEED)
    loss, _, new_ms = make_fused_dp_grads(m32, mesh)(
        ts32.params, ts32.model_state, None, *shard_batch(x, y, mesh))
    got = [p.grad for p in ts32.leaves()]
    err = rel_err(got, ref["grads"])
    bitwise = all(torch.equal(a.cpu(), b) for a, b in zip(got, ref["grads"]))
    ok = err <= PARALLEL_ONE_REL
    emit("parallel", case="one_rank_f32_grads", backend=mesh.backend,
         grad_rel_err=err, bitwise_equal=bitwise,
         loss=float(loss), unsharded_loss=ref["loss"],
         tolerance=f"max_abs_err <= {PARALLEL_ONE_REL} * max|gradient|",
         ok=ok)
    if not ok:
        raise AssertionError("the one-rank sharded fused gradient disagrees "
                             "with the unsharded step's")
    del ts32, got

    # ---- the sharded fused eval step: 10 block_eval launches a batch ----
    eval_step = make_sharded_eval_step(model, mesh)
    before = block_eval.launches
    sums = eval_step(ts, *batch)
    eval_launches = block_eval.launches - before
    ok = eval_launches == len(cfg.plan) and int(sums["count"]) == B
    emit("parallel", case="one_rank_eval", backend=mesh.backend,
         block_eval_launches=eval_launches, count=int(sums["count"]), ok=ok)
    if not ok:
        raise AssertionError("the sharded fused eval step did not run "
                             f"{len(cfg.plan)} block_eval launches")

    # ---- Predictor(mesh) bitwise against Predictor ----------------------
    serve = STGCN(bench_config(dropout_rate=0.0)).to(dev)
    rng = np.random.default_rng(SEED + 21)
    seqs = [rng.standard_normal((int(n), V, 2)).astype(np.float32)
            for n in rng.integers(60, 300, SERVE_SEQUENCES)]
    plain = Predictor(serve).predict(seqs).probs
    sharded = Predictor(serve, mesh=mesh).predict(seqs).probs
    ok = bool(np.array_equal(plain, sharded))
    emit("parallel", case="one_rank_predictor", backend=mesh.backend,
         sequences=SERVE_SEQUENCES, bitwise_equal=ok, ok=ok)
    if not ok:
        raise AssertionError("Predictor(mesh) answered otherwise than "
                             "Predictor")
    del trainer, ts, model, serve
    graph_mesh_case(smi, dev, mesh, x, y)
    graph_mesh_remat_case(smi, dev, mesh, x, y)
    dist.destroy_process_group()
    torch.cuda.empty_cache()
    return {"launches_per_step": per_step, "step_ms": step_ms,
            "eval_launches": eval_launches}


def graph_mesh_case(smi: str, dev, mesh, x, y) -> None:
    """Phase 21's mesh case, on phase 20's one-rank NCCL mesh:
    ``Trainer(mesh)``'s fused step captured, its BN and gradient
    all-reduces inside the graph, against the captured unsharded fused
    step from the same weights and batch (bf16, dropout 0: the mesh seeds
    its masks with the rank's data index), a warm-up and GRAPH_REPLAYS
    replays each; gradients, parameters, moments and BN statistics
    bitwise equal.  Then each step's ms, captured and eager, in turns."""
    import torch

    from stgcn_tpu_torch.kernels import bn_moments as bm
    from stgcn_tpu_torch.models.stgcn import STGCN
    from stgcn_tpu_torch.parallel.train import make_sharded_train_step
    from stgcn_tpu_torch.training.loop import Trainer, make_train_step
    from stgcn_tpu_torch.training.optimizers import adam
    from stgcn_tpu_torch.training.train_state import create_train_state

    cfg = bench_config(block_impl="fused", dropout_rate=0.0)
    runs, states, steps = {}, {}, {}
    for capture in (None, False):
        kind = "captured" if capture is None else "eager"
        model = STGCN(cfg)
        trainer = Trainer(model, adam(1e-3), mesh=mesh, seed=SEED)
        states[f"mesh_{kind}"] = trainer.init_state()
        steps[f"mesh_{kind}"] = (trainer.train_step if capture is None else
                                 make_sharded_train_step(model, mesh,
                                                         capture=False))
        plain = STGCN(cfg)
        states[f"unsharded_{kind}"] = create_train_state(plain, adam(1e-3),
                                                         seed=SEED)
        steps[f"unsharded_{kind}"] = make_train_step(plain, capture=capture)
    batches = {k: (trainer._put_batch(x, y) if k.startswith("mesh") else
                   (torch.from_numpy(x).to(dev), torch.from_numpy(y).to(dev)))
               for k in steps}
    for k in steps:
        runs[k] = (lambda k=k: steps[k](states[k], *batches[k]))
    for _ in range(1 + GRAPH_REPLAYS):
        runs["mesh_captured"]()
        runs["unsharded_captured"]()
    got = graph_state_tensors(states["mesh_captured"])
    want = graph_state_tensors(states["unsharded_captured"])
    bitwise = all(torch.equal(a, b) for a, b in zip(got, want))
    dist_ = max_distance(got, want)
    captured = (steps["mesh_captured"].captured
                and steps["unsharded_captured"].captured)
    # the collectives a replay counts (its capture's) against an eager
    # step's (parallel/collectives.COUNTS)
    from stgcn_tpu_torch.parallel import collectives

    counted = {}
    for k in ("mesh_eager", "mesh_captured"):
        collectives.reset_counts()
        runs[k]()
        counted[k] = {"/".join(key): list(v) for key, v in
                      collectives.read_counts().items()}
    counts_equal = counted["mesh_eager"] == counted["mesh_captured"] != {}
    for k in runs:
        runs[k]()
        runs[k]()
    order = list(runs)
    times = {k: [] for k in runs}
    for k in order + order[::-1]:
        times[k].append(cuda_time_ms(runs[k], reps=3, warmup=0))
    step_ms = {k: float(np.mean(v)) for k, v in times.items()}
    issued = {k: issue_ms(runs[k]) for k in runs}
    ok = captured and bitwise and counts_equal
    emit("graph", case="one_rank_mesh", mesh=[1, 1, 1],
         backend=mesh.backend, captured=captured,
         graphs=steps["mesh_captured"].cache_size, bitwise_equal=bitwise,
         collectives_a_step=counted, collectives_equal=counts_equal,
         max_dist=dist_, step_ms=step_ms, step_ms_turns=times,
         issue_ms=issued, batch=B, frames=T, dtype="bfloat16", dropout=0.0,
         nvidia_smi=smi, ok=ok)
    del states, steps, runs
    torch.cuda.empty_cache()
    if not ok:
        raise AssertionError("the captured one-rank mesh step is not "
                             "captured, not bitwise the captured "
                             "unsharded step, or counts other collectives "
                             f"than the eager step: {counted}")


def graph_mesh_remat_case(smi: str, dev, mesh, x, y) -> None:
    """Phase 21's mesh remat case, on phase 20's one-rank NCCL mesh: route
    B with ``remat="selective"`` (the op chain the mesh runs), its
    recompute inside the captured mesh step.  Without dropout (the mesh
    seeds its masks with the rank's data index), a warm-up and
    GRAPH_REPLAYS replays bitwise the captured unsharded remat step's
    (gradients, parameters, moments, BN statistics, losses); with dropout
    0.5 the captured mesh remat step bitwise the captured mesh step
    without remat.  20/10 conv launches a replay; the step ms of the
    captured mesh remat step, the eager one and the captured unsharded
    one in turns."""
    import torch

    from stgcn_tpu_torch.models.stgcn import STGCN
    from stgcn_tpu_torch.parallel.train import (
        create_sharded_train_state,
        make_sharded_train_step,
        shard_batch,
    )
    from stgcn_tpu_torch.training.loop import make_train_step
    from stgcn_tpu_torch.training.optimizers import adam
    from stgcn_tpu_torch.training.train_state import create_train_state

    name, kw, base_kw = REMAT_CASES[1]
    counters = conv_counters()
    batch = shard_batch(x, y, mesh)

    models = {}

    def mesh_step(cfg):
        model = models[cfg] = STGCN(cfg)
        ts, _ = create_sharded_train_state(model, adam(1e-3), mesh,
                                           seed=SEED)
        return make_sharded_train_step(model, mesh), ts

    def plain_step(cfg):
        model = STGCN(cfg).to(dev)
        return make_train_step(model), create_train_state(model, adam(1e-3),
                                                          seed=SEED)

    no_drop = bench_config(dropout_rate=0.0, **kw)
    runs = {"mesh_remat": mesh_step(no_drop),
            "unsharded_remat": plain_step(no_drop),
            "mesh_remat_dropout": mesh_step(bench_config(**kw)),
            "mesh_dropout": mesh_step(bench_config(**base_kw))}
    torch.backends.cudnn.deterministic = True
    losses = {k: [] for k in runs}
    launches = []
    for _ in range(1 + GRAPH_REPLAYS):
        for k, (step, ts) in runs.items():
            reset(counters)
            losses[k].append(step(ts, *batch)["loss"].clone())
            if k == "mesh_remat":
                launches.append(read(counters))
    torch.backends.cudnn.deterministic = False

    def compare(a, b):
        got = graph_state_tensors(runs[a][1]) + losses[a]
        want = graph_state_tensors(runs[b][1]) + losses[b]
        return (all(torch.equal(u, v) for u, v in zip(got, want)),
                max_distance(got, want))

    bitwise, dist_ = compare("mesh_remat", "unsharded_remat")
    dropout_bitwise, dropout_dist = compare("mesh_remat_dropout",
                                            "mesh_dropout")
    captured = all(step.captured and step.cache_size == 1
                   for step, _ in runs.values())
    expected = per_direction({"spatial_conv": (20, 10),
                              "temporal_conv": (20, 10)})
    per_step = {k: n for k, n in launches[-1].items() if n}
    # time: the captured mesh remat step, its eager step and the captured
    # unsharded remat step, in turns after two warm calls of the new one
    runs["mesh_remat_eager"] = (make_sharded_train_step(
        models[no_drop], mesh, capture=False), runs["mesh_remat"][1])
    order = ["mesh_remat", "mesh_remat_eager", "unsharded_remat"]
    calls = {k: (lambda k=k: runs[k][0](runs[k][1], *batch)) for k in order}
    times = {k: [] for k in order}
    for k in order + order[::-1]:
        times[k].append(cuda_time_ms(calls[k], reps=3))
    step_ms = {k: float(np.mean(v)) for k, v in times.items()}
    ok = (captured and bitwise and dropout_bitwise and per_step == expected
          and all(n == launches[0] for n in launches))
    emit("graph", case="one_rank_mesh_remat", config=kw, mesh=[1, 1, 1],
         backend=mesh.backend, captured=captured, bitwise_equal=bitwise,
         max_dist=dist_, vs="the captured unsharded remat step, dropout 0",
         dropout_bitwise_equal_without_remat=dropout_bitwise,
         dropout_max_dist=dropout_dist, launches_per_call=launches,
         expected_per_step=expected, step_ms=step_ms, step_ms_turns=times,
         losses=[float(v) for v in losses["mesh_remat_dropout"]],
         batch=B, frames=T, dtype="bfloat16", nvidia_smi=smi, ok=ok)
    del runs, calls, models
    torch.cuda.empty_cache()
    if not ok:
        raise AssertionError(
            "the one-rank mesh remat step is not captured, not bitwise the "
            "captured unsharded remat step or the mesh step without remat, "
            f"or launched {per_step} against {expected}")


def spawn_ranks(suite: str, backend: str, tmp: str, world: int = 2,
                cards: bool = False,
                timeout_s: float = PARALLEL_TIMEOUT_S) -> tuple[list, list]:
    """Run ``python chip_smoke.py --parallel-rank SUITE BACKEND RANK WORLD
    TMP CARDS`` for every rank: all on card 0, or with ``cards`` rank r on
    card r; returns their exit codes and outputs (killed at
    ``timeout_s``)."""
    procs = [subprocess.Popen(
        [sys.executable, str(Path(__file__).resolve()), "--parallel-rank",
         suite, backend, str(r), str(world), tmp, str(int(cards))],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(world)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout_s)[0])
    except subprocess.TimeoutExpired:
        outs = outs + [""] * (world - len(outs))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return [p.returncode for p in procs], outs


def parallel_refs(dev, timed: bool, n: int = 1) -> dict:
    """The one-process references of the spawned cases at the phase's
    batch: float32 gradients of the fused step, the op path and route B,
    the float64 op path's, and with ``timed`` each bf16 step's ms (and
    the fused step's at one rank's share of the batch, ``B / n``)."""
    import torch

    from stgcn_tpu_torch.models.stgcn import STGCN
    from stgcn_tpu_torch.training.loop import make_train_step
    from stgcn_tpu_torch.training.optimizers import adam
    from stgcn_tpu_torch.training.train_state import create_train_state

    cfg32 = bench_config(block_impl="fused", compute_dtype=None,
                         dropout_rate=0.0)
    ops32 = dataclasses.replace(cfg32, block_impl="ops")
    kinds = {"fused": cfg32, "ops": ops32,
             "route_b": dataclasses.replace(ops32, spatial_impl="pallas",
                                            temporal_impl="pallas")}
    refs = {k: unsharded_grads(c, dev) for k, c in kinds.items()}
    refs["f64"] = unsharded_grads(dataclasses.replace(
        ops32, dtype=torch.float64), dev)
    refs["step_ms"] = {}
    if timed:
        x, y = (torch.from_numpy(a).to(dev)
                for a in parallel_batch(cfg32))
        for k, c in kinds.items():
            cfg = dataclasses.replace(c, compute_dtype=torch.bfloat16)
            model = STGCN(cfg)
            ts = create_train_state(model, adam(1e-3), seed=SEED)
            step = make_train_step(model)
            refs["step_ms"][k] = cuda_time_ms(lambda: step(ts, x, y),
                                              reps=5)
            if k == "fused":
                refs["step_ms"]["fused_rank_batch"] = cuda_time_ms(
                    lambda: step(ts, x[:B // n], y[:B // n]), reps=5)
            del ts
    torch.cuda.empty_cache()
    return refs


def parallel_two_ranks(smi: str, dev, one_rank: dict) -> dict:
    """Case (b): two ranks on the one card, spawned.  NCCL is tried first
    (it may refuse two ranks of one communicator on one device); where it
    does not run, the cases run on the gloo backend, named on each line.
    The data-parallel case must run; the time and model cases report
    ``ran: false`` with the backend's error where it cannot carry their
    collectives on CUDA tensors of two ranks on one device."""
    refs = parallel_refs(dev, timed=False)
    with tempfile.TemporaryDirectory() as tmp:
        rcs, outs = spawn_ranks("probe", "nccl", tmp, timeout_s=120)
        probe = {}
        if all(rc == 0 for rc in rcs):
            with open(Path(tmp) / "probe.json") as f:
                probe = json.load(f)
        nccl_ok = bool(probe.get("all_reduce")) and bool(probe.get("p2p"))
        emit("parallel", case="nccl_two_ranks_one_card", backend="nccl",
             ran=nccl_ok, exit_codes=rcs, result=probe,
             error=None if nccl_ok else "\n".join(o[-1500:] for o in outs))
        backend = "nccl" if nccl_ok else "gloo"
        results = run_cases(backend, tmp, world=2, cards=False)
    return report_cases("parallel", results, refs, backend, smi, 2,
                        one_rank["step_ms"])


def run_cases(backend: str, tmp: str, world: int, cards: bool) -> dict:
    """The cases of :data:`PARALLEL_CASES` on ``world`` spawned ranks:
    their results by name, a case whose ranks died marked not run with
    their last output."""
    import torch

    rcs, outs = spawn_ranks("cases", backend, tmp, world, cards)
    results = {}
    path = Path(tmp) / "cases.pt"
    if path.exists():
        results = torch.load(path)
    if any(rc != 0 for rc in rcs):
        # a rank died in a case: that case did not run, with the
        # process's own last words as its error
        started = [line.split()[1] for line in outs[0].splitlines()
                   if line.startswith("CASE ")]
        if started and started[-1] not in results:
            results[started[-1]] = {
                "ran": False, "exit_codes": rcs,
                "error": "\n".join(o[-1500:] for o in outs)}
    return results


def report_cases(phase: str, results: dict, refs: dict, backend: str,
                 smi: str, n: int, one_rank_step_ms) -> dict:
    """One line a case, held against the one-process references; raises
    if a data-parallel case did not run or a case that ran disagrees."""
    summary, failed = {"backend": backend}, []
    for kind, _ in PARALLEL_CASES:
        ref_key = CASE_REFS[kind]
        name = case_name(kind, n)
        res = results.get(name, {"ran": False, "error": "no result"})
        line = {k: v for k, v in res.items()
                if k not in ("grads", "state")}
        passed = False
        if res.get("ran"):
            ref, f64 = refs[ref_key], refs["f64"]
            line["grad_rel_err"] = rel_err(res["grads"], ref["grads"])
            line["within_two_rel"] = line["grad_rel_err"] <= PARALLEL_TWO_REL
            line["grad_rel_err_vs_f64"] = rel_err(res["grads"], f64["grads"])
            line["one_process_rel_err_vs_f64"] = rel_err(ref["grads"],
                                                        f64["grads"])
            line["worst_leaves"] = worst_leaves(res["grads"], ref["grads"],
                                                ref["names"])
            line["loss"], line["unsharded_loss"] = res["loss"], ref["loss"]
            line["one_process_step_ms"] = refs["step_ms"].get(ref_key)
            passed = (line["grad_rel_err_vs_f64"] <= PARALLEL_VS_F64
                      * line["one_process_rel_err_vs_f64"]
                      and line["one_process_rel_err_vs_f64"]
                      <= PARALLEL_ONE_VS_F64_MAX
                      and line["grad_rel_err"] <= PARALLEL_TWO_MAX
                      and line["grad_rel_err_vs_f64"] <= PARALLEL_TWO_MAX)
            if "state" in res:
                line["bn_state_rel_err"] = rel_err(res["state"],
                                                   ref["state"])
                passed = passed and (line["bn_state_rel_err"]
                                     <= PARALLEL_BN_REL)
            want = case_launches(kind, n)
            passed = passed and res.get("bf16_fell", True) and all(
                n_ == want[k] for r in res.get("launches_per_rank", [])
                for k, n_ in r.items() if k in want)
            if kind == "data":
                line["one_rank_step_ms"] = one_rank_step_ms
                line["one_process_step_ms_at_rank_batch"] = refs[
                    "step_ms"].get("fused_rank_batch")
        line.update(case=name, backend=backend, passed=passed,
                    tolerance=(f"gradients no further from the float64 op "
                               f"path than {PARALLEL_VS_F64}x the one-process "
                               f"float32 step's, that step within "
                               f"{PARALLEL_ONE_VS_F64_MAX} and the gradients "
                               f"within {PARALLEL_TWO_MAX} of the largest of "
                               f"both (their distance from the one-process "
                               f"step beside {PARALLEL_TWO_REL}), "
                               f"BN statistics within {PARALLEL_BN_REL}; "
                               f"launches a rank "
                               f"{case_launches(kind, n)}"),
                    nvidia_smi=smi)
        emit(phase, **line)
        summary[name] = line
        if (kind.startswith("data") or res.get("ran")) and not passed:
            failed.append(name)
    if failed:
        raise AssertionError(f"cases {failed} did not run or disagree with "
                             "the one-process step (the data-parallel cases "
                             "must run)")
    return summary


def worst_leaves(got: list, want: list, names: list, k: int = 3) -> list:
    """The ``k`` leaves farthest from ``want``, with their error and their
    own largest value."""
    errs = [((a.double() - b.double()).abs().max().item(),
             b.abs().max().item(), name) for name, a, b in zip(
                names, got, want)]
    return [{"leaf": name, "max_abs_err": e, "leaf_max": m}
            for e, m, name in sorted(errs, reverse=True)[:k]]


def parallel_rank_main(suite: str, backend: str, rank: int, world: int,
                       tmp: str, cards: bool) -> int:
    """One spawned rank (``--parallel-rank``): on card 0, or with
    ``cards`` on card ``rank``."""
    import torch
    import torch.distributed as dist

    from stgcn_tpu_torch.kernels import _build
    from stgcn_tpu_torch.parallel.launcher import initialize_distributed

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _build.load_library()
    local = rank if cards else 0
    initialize_distributed("file://" + str(Path(tmp) / f"rdv-{suite}"),
                           world, rank, backend=backend, local_rank=local)
    dev = torch.device("cuda", local)
    if suite == "probe":
        out = {}
        t = torch.full((4,), float(rank + 1), device=dev)
        dist.all_reduce(t)
        torch.cuda.synchronize()
        out["all_reduce"] = bool((t == 3.0).all())
        peer = 1 - rank
        recv = torch.zeros(4, device=dev)
        works = dist.batch_isend_irecv([
            dist.P2POp(dist.isend, t, peer), dist.P2POp(dist.irecv, recv,
                                                        peer)])
        for w in works:
            w.wait()
        torch.cuda.synchronize()
        out["p2p"] = bool((recv == 3.0).all())
        if rank == 0:
            with open(Path(tmp) / "probe.json", "w") as f:
                json.dump(out, f)
        dist.barrier()
        return 0
    if suite == "trace":
        return trace_rank(dev, tmp)
    results = {}
    for kind, fn in PARALLEL_CASES:
        name = case_name(kind, world)
        # saved after every case: a backend may abort the process (gloo
        # does, on point-to-point of CUDA tensors), and the parent then
        # names the case that was running from this line
        print(f"CASE {name}", flush=True)
        try:
            results[name] = {"ran": True, **fn(dev, world)}
        except Exception as e:  # noqa: BLE001 - reported on the case's line
            results[name] = {"ran": False,
                             "error": f"{type(e).__name__}: {e}"[:1500]}
        if rank == 0:
            torch.save(results, Path(tmp) / "cases.pt")
    return 0


def _gathered_grads(ts, mesh) -> list:
    from stgcn_tpu_torch.parallel.mesh import gather_params
    from stgcn_tpu_torch.tree import tree_leaves, tree_map

    g = gather_params(tree_map(lambda p: p.grad, ts.params), mesh)
    return [t.detach().cpu() for t in tree_leaves(g)]


def _all_launches(counters) -> list:
    """Every rank's launch counts, in rank order (gathered through an
    object collective)."""
    import torch.distributed as dist

    mine = read(counters)
    out = [None] * dist.get_world_size()
    dist.all_gather_object(out, mine)
    return out


def _rank_data(dev, n: int) -> dict:
    """data=n on the fused kernels at bench.py's width: the float32
    gradients and BN statistics of one step; bf16 steps for the falling
    loss, the step ms (captured on NCCL, and eager beside it) and the
    gradient all-reduce's ms."""
    import torch

    from stgcn_tpu_torch.models.stgcn import STGCN
    from stgcn_tpu_torch.parallel.collectives import all_reduce_
    from stgcn_tpu_torch.parallel.fused_dp import make_fused_dp_grads
    from stgcn_tpu_torch.parallel.mesh import make_mesh
    from stgcn_tpu_torch.parallel.train import (
        create_sharded_train_state,
        make_sharded_train_step,
        shard_batch,
    )
    from stgcn_tpu_torch.training.optimizers import adam
    from stgcn_tpu_torch.tree import tree_leaves

    mesh = make_mesh(n, 1, 1, device=dev)
    counters = fused_counters()
    cfg32 = bench_config(block_impl="fused", compute_dtype=None,
                         dropout_rate=0.0)
    x, y = parallel_batch(cfg32)
    m32 = STGCN(cfg32)
    ts, _ = create_sharded_train_state(m32, adam(1e-3), mesh, seed=SEED)
    batch = shard_batch(x, y, mesh)
    reset(counters)
    loss, _, new_ms = make_fused_dp_grads(m32, mesh)(
        ts.params, ts.model_state, None, *batch)
    torch.cuda.synchronize()
    launches = _all_launches(counters)
    out = {"loss": float(loss), "launches_per_rank": launches,
           "sequences_per_rank": batch[0].shape[0],
           "grads": [p.grad.detach().cpu() for p in ts.leaves()],
           "state": [t.detach().cpu() for t in tree_leaves(new_ms)]}
    del ts

    cfg = bench_config(block_impl="fused")
    model = STGCN(cfg)
    ts, _ = create_sharded_train_state(model, adam(1e-3), mesh, seed=SEED)
    step = make_sharded_train_step(model, mesh)
    losses = [float(step(ts, *batch)["loss"]) for _ in range(PARALLEL_STEPS)]
    out["bf16_losses"] = losses
    out["bf16_fell"] = bool(np.isfinite(losses).all()
                            and np.mean(losses[-3:]) < np.mean(losses[:3]))
    out["step_ms"] = cuda_time_ms(lambda: step(ts, *batch), reps=5)
    # the same step eager (captured on NCCL by default; gloo runs eagerly)
    out["captured"] = step.captured
    eager = make_sharded_train_step(model, mesh, capture=False)
    out["eager_step_ms"] = cuda_time_ms(lambda: eager(ts, *batch), reps=5)
    grads = [torch.zeros_like(p) for p in ts.leaves()]
    out["grad_all_reduce_ms"] = cuda_time_ms(
        lambda: all_reduce_(grads, mesh.group("data")), reps=5)
    out["grad_bytes"] = sum(g.numel() * g.element_size() for g in grads)
    return out


def _rank_model(dev, n: int) -> dict:
    """model=n on the op path (channel tensor parallelism): float32
    gradients, and the bf16 step's ms."""
    import torch

    from stgcn_tpu_torch.models.stgcn import STGCN
    from stgcn_tpu_torch.parallel.mesh import make_mesh
    from stgcn_tpu_torch.parallel.train import (
        create_sharded_train_state,
        make_sharded_grads,
        shard_batch,
    )
    from stgcn_tpu_torch.training.optimizers import adam

    mesh = make_mesh(1, 1, n, device=dev)
    cfg = bench_config(compute_dtype=None, dropout_rate=0.0)
    x, y = parallel_batch(cfg)
    model = STGCN(cfg)
    ts, _ = create_sharded_train_state(model, adam(1e-3), mesh, seed=SEED)
    loss, _, _ = make_sharded_grads(model, mesh)(
        ts, *shard_batch(x, y, mesh))
    torch.cuda.synchronize()
    return {"loss": float(loss), "grads": _gathered_grads(ts, mesh),
            "step_ms": _bf16_step_ms(cfg, mesh)}


def _route_b(dev, shape: tuple, timed: bool) -> dict:
    """Route B on a ``(data, time, model)`` mesh: ``spatial_conv`` on each
    rank's slice and ``temporal_conv`` on each rank's frames (on a time
    mesh inside the halo, at ``padding=0`` on its T/n frames and its
    neighbours' 4 + 4; on a model mesh on its C_in slice, its partial
    sums all-reduced): float32 gradients and launches, and with ``timed``
    the bf16 step's ms."""
    import torch

    from stgcn_tpu_torch.models.stgcn import STGCN
    from stgcn_tpu_torch.parallel.mesh import make_mesh
    from stgcn_tpu_torch.parallel.train import (
        create_sharded_train_state,
        make_sharded_grads,
        shard_batch,
    )
    from stgcn_tpu_torch.training.optimizers import adam

    mesh = make_mesh(*shape, device=dev)
    cfg = bench_config(compute_dtype=None, dropout_rate=0.0,
                       spatial_impl="pallas", temporal_impl="pallas")
    x, y = parallel_batch(cfg)
    model = STGCN(cfg)
    ts, _ = create_sharded_train_state(model, adam(1e-3), mesh, seed=SEED)
    counters = conv_counters()
    reset(counters)
    loss, _, _ = make_sharded_grads(model, mesh)(
        ts, *shard_batch(x, y, mesh))
    torch.cuda.synchronize()
    out = {"loss": float(loss), "launches_per_rank": _all_launches(counters),
           "frames_per_rank": T // shape[1],
           "sequences_per_rank": B // shape[0],
           "grads": _gathered_grads(ts, mesh)}
    if timed:
        out["step_ms"] = _bf16_step_ms(cfg, mesh)
    return out


def _rank_data_route_b(dev, n: int) -> dict:
    """data=n on route B: both conv kernels on each rank's B/n sequences."""
    return _route_b(dev, (n, 1, 1), timed=False)


def _rank_model_route_b(dev, n: int) -> dict:
    """model=n on route B: the spatial kernel column parallel, the temporal
    kernel row parallel at the reference padding."""
    return _route_b(dev, (1, 1, n), timed=False)


def _rank_time(dev, n: int) -> dict:
    """time=n on route B: the halo runs the ``temporal_conv`` kernel at
    ``padding=0`` on each rank's frames; timed."""
    return _route_b(dev, (1, n, 1), timed=True)


def _bf16_step_ms(cfg32, mesh) -> float:
    """The bf16 (dropout 0.5) sharded step's ms of ``cfg32``'s path on
    ``mesh``, CUDA events over 3 steps after a warm one."""
    import torch

    from stgcn_tpu_torch.models.stgcn import STGCN
    from stgcn_tpu_torch.parallel.train import (
        create_sharded_train_state,
        make_sharded_train_step,
        shard_batch,
    )
    from stgcn_tpu_torch.training.optimizers import adam

    cfg = dataclasses.replace(cfg32, compute_dtype=torch.bfloat16,
                              dropout_rate=0.5)
    model = STGCN(cfg)
    ts, _ = create_sharded_train_state(model, adam(1e-3), mesh, seed=SEED)
    batch = shard_batch(*parallel_batch(cfg), mesh)
    step = make_sharded_train_step(model, mesh)
    return cuda_time_ms(lambda: step(ts, *batch), reps=3)


# the spawned cases, in the order they run: those that need only
# all-reduce and all-gather first, point-to-point last
PARALLEL_CASES = (("data", _rank_data), ("data_route_b", _rank_data_route_b),
                  ("model", _rank_model),
                  ("model_route_b", _rank_model_route_b),
                  ("time", _rank_time))
# each case's one-process reference (parallel_refs)
CASE_REFS = {"data": "fused", "data_route_b": "route_b", "model": "ops",
             "model_route_b": "route_b", "time": "route_b"}


def case_launches(kind: str, n: int) -> dict:
    """The kernel launches each rank's step runs, by case kind: the fused
    step's 8/2/10; route B's spatial conv once a block, its temporal conv
    once a block, and on a time mesh three times a block where the halo
    overlaps (the interior and two edge strips) and once where the shard
    is too short (``parallel/halo.overlap_split``); none on the op
    path."""
    from stgcn_tpu_torch.parallel.halo import overlap_split

    if kind == "data":
        counts = (("spatial_block", 8), ("spatial_block_save", 2),
                  ("temporal_block", 10))
    elif kind in ("data_route_b", "model_route_b"):
        counts = (("spatial_conv", 10), ("temporal_conv", 10))
    elif kind == "time":
        temporal, t = 0, T // n
        for _, c_out, stride, _ in plan_block_shapes():
            temporal += 3 if overlap_split(t, stride, 9) else 1
            t //= stride
        counts = (("spatial_conv", 10), ("temporal_conv", temporal))
    else:
        return {}
    return {f"{op}.{d}": c for op, c in counts
            for d in ("forward", "backward")}


def case_name(kind: str, n: int) -> str:
    return {"data": f"data{n}_fused", "data_route_b": f"data{n}_route_b",
            "model": f"model{n}_ops", "model_route_b": f"model{n}_route_b",
            "time": f"time{n}_route_b"}[kind]


def parallel_cards_main() -> int:
    """``python3 chip_smoke.py --parallel-cards``: the spawned cases with
    one rank a card on NCCL, over every card of the machine (up to 4):
    data=n on the fused kernels and on route B, model=n on the op path
    and on route B, time=n on route B, each held against the one-process
    references of phase 20, the fused, model and time cases timed beside
    the one-process bf16 step.  Needs two cards or more."""
    import torch

    from stgcn_tpu_torch.kernels import _build

    n = min(torch.cuda.device_count(), 4)
    if n < 2:
        print("--parallel-cards needs two CUDA devices or more",
              file=sys.stderr)
        return 1
    start = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(smi, flush=True)
    _build.build()
    _build.load_library()
    dev = torch.device("cuda", 0)
    refs = parallel_refs(dev, timed=True, n=n)
    with tempfile.TemporaryDirectory() as tmp:
        results = run_cases("nccl", tmp, world=n, cards=True)
    report_cases("parallel_cards", results, refs, "nccl", smi, n,
                 refs["step_ms"]["fused"])
    del refs
    memory_checkpoint("bench_tools")
    cards_tools(smi, n)
    emit("run", run_seconds=time.perf_counter() - start, cards=n)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


# ---- --bn-moments: the BatchNorm statistics op -------------------------------
# ((N, T, V) rows, C) of the cells' BatchNorms at B=64: KTH's first unit
# (C_in 2) and the widths 64 / 128 / 256 at T 304 / 152 / 76, NTU's C_in 3
# at T 300
BN_SHAPES = (((64, 304, 25), 2), ((64, 304, 25), 64), ((64, 152, 25), 128),
             ((64, 76, 25), 256), ((64, 300, 25), 3))
# small cases off the cells: a vector width (40) and one with a channel
# tail (36), channel chunks of 257 vector units and of 2050 single
# elements, fewer rows than a CTA's pass, float64 (the op path's oracle
# dtype)
BN_ODD = (((4, 37, 25), 40), ((4, 37, 25), 36), ((2, 8, 25), 2056),
          ((2, 8, 25), 2050), ((5,), 64), ((4, 37, 25), 64))
# the kernels' float32 sums of up to 5e5 rows against the float64 plain
# version: within 1e-5 of the largest |moment| (PyTorch's own float32
# reduction is reported beside them)
BN_MOMENT_REL = 1e-5
# the backward against the plain version on the same input: both round
# g_mean / n + (g_sq / n) * 2x, summed in float32 (float64 for float64),
# to x's dtype, the kernel perhaps with a fused multiply-add; so within
# one ulp of x's dtype plus the sum's own rounding, 4 eps of the terms'
# magnitude (the quotients, the product and the sum each round once),
# elementwise.  Against float64 autograd within one ulp of the
# largest |dx| (bf16 2^-7; float32 and float64 far inside)
BN_GRAD_REL = {"bfloat16": 2.0 ** -7, "float32": 1e-6, "float64": 1e-12}
BN_TIME_REPS = 20


def beyond_rounding(got, want, terms) -> int:
    """Elements of ``got`` further from ``want`` than one ulp of its dtype
    plus four eps of the accumulation at the magnitude ``terms``."""
    import torch

    bits = {torch.bfloat16: 8, torch.float32: 24, torch.float64: 53}
    acc = torch.promote_types(want.dtype, torch.float32)
    _, exp = torch.frexp(want.double())
    tol = (torch.pow(2.0, (exp - bits[want.dtype]).double())
           + 2.0 ** (3 - bits[acc]) * terms)
    return int(((got.double() - want.double()).abs() > tol).sum().item())


def graph_time_ms(fn, reps: int = BN_TIME_REPS) -> float:
    """Device ms of a call of ``fn``: ``reps`` calls captured in one CUDA
    graph and replayed, so the host's time to issue a call is left out
    (a captured step replays the op's kernels the same way)."""
    import torch

    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    return cuda_time_ms(graph.replay, reps=3, warmup=1) / reps


def bn_moments_case(gen, shape, c, dt, dev, timed: bool) -> dict:
    """The op's two kernels on one input against the plain versions and
    against float64; each kernel twice, bitwise; with ``timed`` the
    kernels' and the plain version's CUDA-event ms beside the bound."""
    import torch

    from stgcn_tpu_torch.kernels import bn_moments as bm

    x = (torch.randn((*shape, c), generator=gen, device=dev) * 1.5
         + 0.4).to(dt)
    if shape == (5,):     # a contiguous view off the 16-byte boundary
        x = torch.cat([x.new_zeros(1), x.flatten()])[1:].view(x.shape)
    g = [torch.randn(c, generator=gen, device=dev) for _ in range(2)]
    want = bm.bn_moments_forward_reference(x.double())
    got = bm.bn_moments_forward(x)
    again = bm.bn_moments_forward(x)
    plain = bm.bn_moments_forward_reference(x)
    case = {"rows": list(shape), "c": c,
            "dtype": str(dt).removeprefix("torch."),
            "vector_width": bm.vector_width(x)}
    out = dict(case)
    scale = [w.abs().max().item() for w in want]
    out["moment_rel_err"] = max((a.double() - w).abs().max().item() / s
                                for a, w, s in zip(got, want, scale))
    out["plain_moment_rel_err"] = max(
        (a.double() - w).abs().max().item() / s
        for a, w, s in zip(plain, want, scale))
    xd = x.double().requires_grad_()
    (want_dx,) = torch.autograd.grad(
        bm.bn_moments_forward_reference(xd), [xd], [t.double() for t in g])
    dx = bm.bn_moments_backward(x, *g)
    dx_again = bm.bn_moments_backward(x, *g)
    plain_dx = bm.bn_moments_backward_reference(x, *g)
    n = x.numel() // c
    terms = (g[0].double() / n).abs() + (g[1].double() / n).abs() * 2 * (
        x.double().abs())
    out["dx_beyond_rounding"] = beyond_rounding(dx, plain_dx, terms)
    out["dx_rel_err_vs_f64"] = ((dx.double() - want_dx).abs().max().item()
                                / want_dx.abs().max().item())
    out["bitwise_repeat"] = (all(torch.equal(a, b)
                                 for a, b in zip(got, again))
                             and torch.equal(dx, dx_again))
    out["ok"] = bool(out["moment_rel_err"] <= BN_MOMENT_REL
                     and out["dx_beyond_rounding"] == 0
                     and out["dx_rel_err_vs_f64"]
                     <= BN_GRAD_REL[case["dtype"]]
                     and out["bitwise_repeat"])
    if timed:
        nbytes = x.numel() * x.element_size()
        out["fwd_ms"] = graph_time_ms(lambda: bm.bn_moments_forward(x))
        out["bwd_ms"] = graph_time_ms(lambda: bm.bn_moments_backward(x, *g))
        out["fwd_bound_ms"] = nbytes / PEAKS["H100 SXM"][1] * 1e3
        out["bwd_bound_ms"] = 2 * nbytes / PEAKS["H100 SXM"][1] * 1e3
        xg = x.detach().requires_grad_()

        def plain_both():
            m = bm.bn_moments_forward_reference(xg)
            torch.autograd.grad(m, [xg], g)

        out["plain_fwd_ms"] = graph_time_ms(
            lambda: bm.bn_moments_forward_reference(x))
        out["plain_fwd_bwd_ms"] = cuda_time_ms(plain_both, reps=BN_TIME_REPS)
    return out


def plain_moments_profile(dev) -> dict:
    """The plain formula's forward and autograd backward at KTH's widest
    activation (64x304x25x64 bf16), eagerly under ``torch.profiler``:
    each device operation's ms under the op that launched it and up to
    two of that op's parents (an autograd node by its name)."""
    import torch

    from stgcn_tpu_torch.kernels import bn_moments as bm

    gen = torch.Generator(device=dev).manual_seed(SEED + 40)
    x = torch.randn((B, T, V, 64), generator=gen, device=dev).to(
        torch.bfloat16).requires_grad_()
    g = [torch.randn(64, generator=gen, device=dev) for _ in range(2)]
    for _ in range(2):
        torch.autograd.grad(bm.bn_moments_forward_reference(x), [x], g)
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        torch.autograd.grad(bm.bn_moments_forward_reference(x), [x], g)
        torch.cuda.synchronize()
    by_op: dict = {}
    for e in prof.events():
        chain, up = [e.name], e.cpu_parent
        while up is not None and len(chain) < 3:
            chain.insert(0, up.name.removeprefix(
                "autograd::engine::evaluate_function: "))
            up = up.cpu_parent
        for k in e.kernels:
            key = f"{' > '.join(chain)} -> {k.name[:60]}"
            by_op[key] = by_op.get(key, 0.0) + k.duration / 1e3
    return dict(sorted(by_op.items(), key=lambda kv: -kv[1]))


def replay_launches(dev, cfg, c_in: int, classes: int, counters: dict,
                    steps: int = 3) -> dict:
    """Each counted op's ``[forward, backward]`` launches a replay of the
    captured fused train step at B=64, T=304 (after the warm-up and the
    capture; ``counters`` maps a name to the two wrappers), and the same
    steps from fresh objects a second time: the loss, parameters and BN
    statistics bitwise equal."""
    import torch

    from stgcn_tpu_torch.models.stgcn import STGCN
    from stgcn_tpu_torch.training.loop import make_train_step
    from stgcn_tpu_torch.training.optimizers import adam
    from stgcn_tpu_torch.training.train_state import train_state_from
    from stgcn_tpu_torch.tree import tree_leaves

    model = STGCN(cfg).to(dev)
    params, state = model.init_params(SEED)
    gen = torch.Generator(device=dev).manual_seed(SEED + 41)
    batches = [(torch.randn((B, T, V, c_in), generator=gen, device=dev),
                torch.randint(0, classes, (B,), generator=gen, device=dev))
               for _ in range(2 + steps)]

    def run():
        ts = train_state_from(params, state, adam(1e-3), SEED, dev)
        step = make_train_step(model)
        for x, y in batches[:2]:
            step(ts, x, y)
        torch.cuda.synchronize()
        before = {n: (f.launches, g.launches)
                  for n, (f, g) in counters.items()}
        losses = [step(ts, x, y)["loss"].clone() for x, y in batches[2:]]
        torch.cuda.synchronize()
        counts = {n: [(f.launches - before[n][0]) / steps,
                      (g.launches - before[n][1]) / steps]
                  for n, (f, g) in counters.items()}
        tensors = [t.detach().clone() for t in tree_leaves(ts.params)
                   + tree_leaves(ts.model_state)]
        return losses, tensors, counts, step.cache_size

    first, second = run(), run()
    return {"units": len(cfg.plan), "replays": steps,
            "launches_a_replay": first[2], "graphs": first[3],
            "bitwise_two_runs": (
                all(torch.equal(a, b) for a, b in zip(first[0], second[0]))
                and all(torch.equal(a, b) for a, b in zip(first[1],
                                                          second[1])))}


def bn_step_launches(dev, cfg, c_in: int, classes: int) -> dict:
    """The BatchNorm statistics op's launches a replay of the captured
    fused train step (:func:`replay_launches`)."""
    from stgcn_tpu_torch.kernels import bn_moments as bm

    out = replay_launches(dev, cfg, c_in, classes, {
        "bn_moments": (bm.bn_moments_forward, bm.bn_moments_backward)})
    fwd, bwd = out.pop("launches_a_replay")["bn_moments"]
    out.update(fwd_a_replay=fwd, bwd_a_replay=bwd)
    units = out["units"]
    # unit 0's first BatchNorm reads the batch, which takes no gradient
    out["ok"] = bool(fwd == 2 * units and bwd == 2 * units - 1
                     and out["graphs"] == 1 and out["bitwise_two_runs"])
    return out


def serving_launches(dev, counters: dict) -> dict:
    """A serving request at the KTH width: each counted op's launches
    (``counters`` maps a name to its wrappers), all 0 for ``ok``."""
    import torch

    from stgcn_tpu_torch.models.stgcn import STGCN
    from stgcn_tpu_torch.serving import Predictor

    model = STGCN(bench_config(block_impl="fused"), seed=SEED)
    pred = Predictor(model.to(dev), buckets=(152, T), max_batch=B)
    pred.warmup()
    rng = np.random.default_rng(SEED + 42)
    seqs = [rng.normal(0, 1, (int(t), V, 2)).astype(np.float32)
            for t in rng.integers(40, T + 1, 100)]
    before = {n: [f.launches for f in fs] for n, fs in counters.items()}
    pred.predict(seqs)
    torch.cuda.synchronize()
    counts = {n: [f.launches - b for f, b in zip(fs, before[n])]
              for n, fs in counters.items()}
    return {"clips": len(seqs), "launches": counts,
            "ok": all(c == [0, 0] for c in counts.values())}


def bn_serving_launches(dev) -> dict:
    """A serving request at the KTH width: no BatchNorm statistics."""
    from stgcn_tpu_torch.kernels import bn_moments as bm

    out = serving_launches(dev, {"bn_moments": (bm.bn_moments_forward,
                                                bm.bn_moments_backward)})
    out["launches"] = out["launches"]["bn_moments"]
    return out


def bn_moments_phase(dev) -> None:
    """The op's kernels at the cells' shapes (bf16 and float32, timed) and
    at the small odd cases (float64 among them); raises on a failure."""
    import torch

    gen = torch.Generator(device=dev).manual_seed(SEED + 43)
    failed = []
    for cases, timed in ((BN_SHAPES, True), (BN_ODD, False)):
        for shape, c in cases:
            for dt in ((torch.bfloat16, torch.float32) if timed else
                       (torch.bfloat16, torch.float32, torch.float64)):
                line = bn_moments_case(gen, shape, c, dt, dev, timed)
                emit("bn_moments", **line)
                if not line["ok"]:
                    failed.append(line)
    if failed:
        raise AssertionError(f"bn_moments: {len(failed)} cases failed, "
                             f"first {failed[0]}")


def bn_moments_main() -> int:
    """``python3 chip_smoke.py --bn-moments``: the BatchNorm statistics
    op alone: its kernels at the cells' shapes against float64 and the
    plain versions, each twice bitwise, timed beside the bound; the plain
    formula's device operations by aten op; its launches a replay of the
    captured KTH and NTU train steps (20 + 19, 18 + 17), two runs of each
    bitwise; none in a serving request."""
    import torch

    from stgcn_tpu_torch.kernels import _build
    from stgcn_tpu_torch.models.stgcn import PLAN_9

    start = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    emit("device", nvidia_smi=smi, torch=torch.__version__,
         cuda=torch.version.cuda)
    lib_path, build_s = _build.build()
    _build.load_library()
    emit("build", library=lib_path.name, seconds=build_s)
    bn_moments_phase(dev)
    emit("bn_plain_profile", ms_by_op=plain_moments_profile(dev))
    ok = True
    for name, cfg, c_in, classes in (
            ("kth", bench_config(block_impl="fused"), 2, 6),
            ("ntu", bench_config(block_impl="fused", plan=PLAN_9, c_in=3,
                                 num_classes=60), 3, 60)):
        line = bn_step_launches(dev, cfg, c_in, classes)
        emit("bn_step", cell=name, **line)
        ok &= line["ok"]
    line = bn_serving_launches(dev)
    emit("bn_serve", **line)
    ok &= line["ok"]
    emit("run", run_seconds=time.perf_counter() - start, ok=bool(ok))
    return 0 if ok else 1


# ---- --unit-tail: the units' tail op -----------------------------------------
# (V, N, T, C) of the ST-GCN cells' unit outputs at B=64: the widths 64 /
# 128 / 256 at KTH's T 304 / 152 / 76 and NTU's 300 / 150 / 75
TAIL_SHAPES = tuple((V, B, (t - 1) // s + 1, c) for t in (T, 300)
                    for s, c in ((1, 64), (2, 128), (4, 256)))
# small cases off the cells: the odd width, an element count that is no
# multiple of 8 (the last mask byte partial), and views two bytes off the
# 16-byte boundary (the scalar loads)
TAIL_ODD = (((V, 4, ODD_T, ODD_C), False), ((V, 3, ODD_T, 3), False),
            ((V, 2, ODD_T, ODD_C), True))
# dropout's (impl, rate): the cells' 0.5, a rate whose reciprocal float32
# cannot hold (0.3), both draws, and no draw
TAIL_MODES = (("exact", 0.5), ("exact", 0.3), ("bits8", 0.5),
              ("bits8", 0.3), ("exact", 0.0))


def pack_bits(bit):
    """A bool mask packed 8 to a byte along the flat index, bit j of byte
    b for element 8b + j: the kernels' mask layout."""
    import torch

    flat = bit.flatten().to(torch.uint8)
    flat = torch.cat([flat, flat.new_zeros(-flat.numel() % 8)])
    weights = torch.tensor([1 << j for j in range(8)], dtype=torch.uint8,
                           device=bit.device)
    return (flat.view(-1, 8) * weights).sum(dim=1, dtype=torch.uint8)


def off_boundary(t):
    """``t`` as a contiguous view two bytes off its storage's start."""
    import torch

    pad = torch.cat([t.new_zeros(1), t.flatten()])
    return pad[1:].view(t.shape)


def unit_tail_case(gen, shape, dt, dev, short_on: bool, impl: str,
                   rate: float, offset: bool) -> dict:
    """The op on one input against PyTorch's chain on CUDA (the plain
    version) and its autograd on the same draw: the output, the packed
    mask and the gradients of u and short bitwise equal; each kernel run
    twice, bitwise."""
    import torch

    from stgcn_tpu_torch.kernels import unit_tail as ut
    from stgcn_tpu_torch.ops.common import dropout_draw

    u = torch.randn(shape, generator=gen, device=dev).to(dt)
    short = (torch.randn(shape, generator=gen, device=dev).to(dt)
             if short_on else None)
    draw = (dropout_draw(shape, rate, generator=gen, device=dev, impl=impl)
            if rate > 0 else (None, None, None))
    dout = torch.randn(shape, generator=gen, device=dev).to(dt)
    if offset:
        u, dout = off_boundary(u), off_boundary(dout)
        short = None if short is None else off_boundary(short)
        draw = (off_boundary(draw[0]), *draw[1:]) if rate > 0 else draw
    ins = [u.detach().requires_grad_()]
    if short is not None:
        ins.append(short.detach().requires_grad_())
    want, want_bit = ut.unit_tail_forward_reference(
        ins[0], ins[1] if short_on else None, *draw)
    want_grads = torch.autograd.grad(want, ins, dout)
    got_ins = [t.detach().requires_grad_() for t in ins]
    got = ut.unit_tail(got_ins[0], got_ins[1] if short_on else None, *draw)
    got_grads = torch.autograd.grad(got, got_ins, dout)
    out, bits = ut.unit_tail_forward(u, short, *draw)
    out2, bits2 = ut.unit_tail_forward(u, short, *draw)
    du = ut.unit_tail_backward(bits, dout, draw[2])
    du2 = ut.unit_tail_backward(bits2, dout, draw[2])
    line = {"shape": list(shape), "dtype": str(dt).removeprefix("torch."),
            "short": short_on, "impl": impl if rate > 0 else None,
            "rate": rate, "off_boundary": offset,
            "out_differ": int((got.detach() != want.detach()).sum()),
            "mask_differ": int((bits != pack_bits(want_bit)).sum()),
            "grad_differ": [int((g != w).sum())
                            for g, w in zip(got_grads, want_grads)],
            "kept_share": float(want_bit.float().mean()),
            "bitwise_repeat": (torch.equal(out, out2)
                               and torch.equal(bits, bits2)
                               and torch.equal(du, du2))}
    line["ok"] = bool(line["out_differ"] == 0 and line["mask_differ"] == 0
                      and not any(line["grad_differ"])
                      and line["bitwise_repeat"]
                      and torch.equal(du, got_grads[0]))
    return line


def unit_tail_time(gen, shape, dev, impl: str) -> dict:
    """Device ms of the op's two kernels at a cell's shape (bf16, the
    shortcut, rate 0.5) through a CUDA graph beside their byte bounds, and
    of PyTorch's chain forward and backward on the same draw."""
    import torch

    from stgcn_tpu_torch.kernels import unit_tail as ut
    from stgcn_tpu_torch.ops.common import dropout_draw

    _, _, peak_bytes = card_peaks(torch.cuda.get_device_name())
    u, short, dout = (torch.randn(shape, generator=gen, device=dev).to(
        torch.bfloat16) for _ in range(3))
    draw = dropout_draw(shape, 0.5, generator=gen, device=dev, impl=impl)
    _, bits = ut.unit_tail_forward(u, short, *draw)
    n = u.numel()
    fwd_bytes = n * (2 + 2 + draw[0].element_size() + 2) + bits.numel()
    bwd_bytes = n * (2 + 2) + bits.numel()
    ins = [u.detach().requires_grad_(), short.detach().requires_grad_()]

    def chain():
        out, _ = ut.unit_tail_forward_reference(*ins, *draw)
        torch.autograd.grad(out, ins, dout)

    return {"shape": list(shape), "impl": impl,
            "fwd_ms": graph_time_ms(
                lambda: ut.unit_tail_forward(u, short, *draw)),
            "bwd_ms": graph_time_ms(
                lambda: ut.unit_tail_backward(bits, dout, draw[2])),
            "fwd_bound_ms": fwd_bytes / peak_bytes * 1e3,
            "bwd_bound_ms": bwd_bytes / peak_bytes * 1e3,
            "chain_fwd_bwd_ms": cuda_time_ms(chain, reps=BN_TIME_REPS)}


def unit_tail_phase(dev) -> None:
    """The op's kernels against the chain at the cells' shapes (bf16, both
    draws at both rates, with and without the shortcut; float32 at KTH's
    first width) and at the small odd cases (both dtypes), then timed at
    the cells' shapes; raises on a failure."""
    import torch

    gen = torch.Generator(device=dev).manual_seed(SEED + 60)
    failed = []
    cases = [(shape, torch.bfloat16, False) for shape in TAIL_SHAPES]
    cases.append((TAIL_SHAPES[0], torch.float32, False))
    cases += [(shape, dt, off) for shape, off in TAIL_ODD
              for dt in (torch.bfloat16, torch.float32)]
    for shape, dt, off in cases:
        for short_on in (True, False):
            for impl, rate in TAIL_MODES:
                line = unit_tail_case(gen, shape, dt, dev, short_on, impl,
                                      rate, off)
                emit("unit_tail", **line)
                if not line["ok"]:
                    failed.append(line)
        torch.cuda.empty_cache()
    for shape in TAIL_SHAPES:
        for impl in ("exact", "bits8"):
            emit("unit_tail_time", **unit_tail_time(gen, shape, dev, impl))
    if failed:
        raise AssertionError(f"unit_tail: {len(failed)} cases failed, "
                             f"first {failed[0]}")


def unit_tail_main() -> int:
    """``python3 chip_smoke.py --unit-tail``: the units' tail op alone:
    its kernels bitwise against PyTorch's chain and its autograd on the
    same draw at the cells' shapes and small odd ones, timed beside the
    bound; its launches a replay of the captured KTH and NTU train steps
    (10 + 10, 9 + 9), two runs of each bitwise; none in a serving request
    or a 2s-AGCN step."""
    import torch

    from stgcn_tpu_torch.kernels import _build
    from stgcn_tpu_torch.kernels import unit_tail as ut
    from stgcn_tpu_torch.models.stgcn import PLAN_9

    start = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    emit("device", nvidia_smi=smi, torch=torch.__version__,
         cuda=torch.version.cuda)
    lib_path, build_s = _build.build()
    _build.load_library()
    emit("build", library=lib_path.name, seconds=build_s)
    unit_tail_phase(dev)
    counters = {"unit_tail": (ut.unit_tail_forward, ut.unit_tail_backward)}
    ok = True
    for name, cfg, c_in, classes in (
            ("kth", bench_config(block_impl="fused"), 2, 6),
            ("ntu", bench_config(block_impl="fused", plan=PLAN_9, c_in=3,
                                 num_classes=60), 3, 60)):
        line = replay_launches(dev, cfg, c_in, classes, counters)
        units = line["units"]
        line["ok"] = bool(line["launches_a_replay"]["unit_tail"]
                          == [units, units] and line["graphs"] == 1
                          and line["bitwise_two_runs"])
        emit("unit_tail_step", cell=name, **line)
        ok &= line["ok"]
    line = serving_launches(dev, counters)
    emit("unit_tail_serve", **line)
    ok &= line["ok"]
    line = agcn_step(dev)
    emit("unit_tail_agcn_step", **line)
    ok &= line["ok"]
    emit("run", run_seconds=time.perf_counter() - start, ok=bool(ok))
    return 0 if ok else 1


# ---- --trace: the phase marks of the captured train step -------------------

TRACE_STEPS = 3
PHASE_MARK = re.compile(r"\bstgcn_phase_mark<stgcn_phase::(\w+)>")
# the tail op's kernels (csrc/unit_tail.cu), one each way a unit
UNIT_TAIL_KERNEL = re.compile(r"\bunit_tail_(fwd|bwd)_kernel\b")
# the benchmark's pattern files, read as data
BENCH_METRICS = Path(__file__).resolve().parent / "stgcn_bench" / "metrics"


def trace_kernels(path) -> list:
    """``(name, start, end, stream)`` of every kernel of a Chrome trace
    that ``torch.profiler`` wrote, in start order (microseconds)."""
    events = json.loads(Path(path).read_text()).get("traceEvents", [])
    found = [(e["name"], float(e["ts"]),
              float(e["ts"]) + float(e.get("dur", 0.0)), e.get("tid"))
             for e in events
             if e.get("ph") == "X" and e.get("cat") == "kernel"]
    return sorted(found, key=lambda k: k[1])


def metric_patterns(metric: str) -> tuple[list, list]:
    """The ``match`` and ``after`` expressions of a benchmark metric's
    pattern files (``stgcn_bench/metrics/<metric>.d/*.txt``)."""
    match, after = [], []
    for f in sorted((BENCH_METRICS / f"{metric}.d").glob("*.txt")):
        for line in f.read_text().splitlines():
            kind, _, rx = line.strip().partition(" ")
            if kind in ("match", "after"):
                (match if kind == "match" else after).append(
                    re.compile(rx.strip()))
    return match, after


def pattern_claimed(kernels: list, metric: str) -> list:
    """The kernels a metric's patterns claim, as the benchmark reads
    them: a ``match`` anywhere, an ``after`` right behind a claimed
    kernel on its stream."""
    match, after = metric_patterns(metric)
    last_on, out = {}, []
    for k in kernels:
        hit = any(p.search(k[0]) for p in match) or (
            last_on.get(k[3], False) and any(p.search(k[0]) for p in after))
        last_on[k[3]] = hit
        if hit:
            out.append(k)
    return out


def kernels_ms(kernels: list) -> float:
    return sum(e - s for _, s, e, _ in kernels) / 1e3


def expected_marks(n_units: int, mesh: bool) -> list:
    """The marks of one fused train step: the input, each unit's five
    phases forward, the head, each unit's five backward, last unit first
    (unit 0's input has no gradient, so its entry marks nothing there),
    then the gradient exchange on a mesh and the optimizer."""
    fwd = ["bn_stats", "spatial", "bn_stats", "temporal", "tail"]
    bwd = ["tail", "temporal", "bn_stats", "spatial", "bn_stats"]
    return (["input"] + fwd * n_units + ["head"] + bwd * n_units
            + (["grad_sync"] if mesh else []) + ["optimizer"])


def trace_check(dev, mesh=None) -> dict:
    """Three steps of the captured fused step (the KTH cell's width, B=64
    a card, T=304, dropout 0.5) from one state, twice: with tracing off
    (the plain graph) and under ``torch.profiler`` (the marked graph,
    captured beside the plain one).  Loss, parameters and BN
    statistics must be bitwise equal; the marked replays' marks must come
    in the declared order; the phases' kernel ms must sum to the
    replays' non-NCCL kernel ms; every kernel that a roofline pattern of
    ``stgcn_bench`` claims must lie in its own phase (spatial or
    temporal).  Reports the per-phase ms, the markers' device us a step
    and each call's host ms (the second holds both captures)."""
    import torch

    from stgcn_tpu_torch.kernels import bn_moments as bm
    from stgcn_tpu_torch.kernels import unit_tail as ut
    from stgcn_tpu_torch.models.stgcn import STGCN
    from stgcn_tpu_torch.parallel.train import make_sharded_train_step
    from stgcn_tpu_torch.training.loop import make_train_step
    from stgcn_tpu_torch.training.optimizers import adam
    from stgcn_tpu_torch.training.train_state import train_state_from
    from stgcn_tpu_torch.tree import tree_leaves

    cfg = bench_config(block_impl="fused")
    model = STGCN(cfg).to(dev)
    params, state = model.init_params(SEED)
    gen = torch.Generator(device=dev).manual_seed(SEED + 30)
    batches = [(torch.randn((B, T, V, 2), generator=gen, device=dev),
                torch.randint(0, 6, (B,), generator=gen, device=dev))
               for _ in range(2 + TRACE_STEPS)]

    def run(traced: bool):
        ts = train_state_from(params, state, adam(1e-3), SEED, dev)
        step = (make_train_step(model) if mesh is None
                else make_sharded_train_step(model, mesh))
        setup_ms = []
        for x, y in batches[:2]:        # the warm-up, the captures
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            step(ts, x, y)
            torch.cuda.synchronize()
            setup_ms.append((time.perf_counter() - t0) * 1e3)
        losses, call_ms = [], []
        bn_before = (bm.bn_moments_forward.launches,
                     bm.bn_moments_backward.launches)
        tail_before = (ut.unit_tail_forward.launches,
                       ut.unit_tail_backward.launches)
        acts = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
        prof = torch.profiler.profile(activities=acts) if traced else None
        if prof is not None:
            prof.__enter__()
        try:
            for x, y in batches[2:]:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = step(ts, x, y)
                torch.cuda.synchronize()
                call_ms.append((time.perf_counter() - t0) * 1e3)
                losses.append(out["loss"].clone())
        finally:
            if prof is not None:
                prof.__exit__(None, None, None)
        got = {"losses": [float(v) for v in losses],
               "tensors": [t.detach().cpu() for t in
                           tree_leaves(ts.params)
                           + tree_leaves(ts.model_state)],
               "graphs": step.cache_size, "marked": step.marked_graphs,
               "setup_ms": setup_ms, "call_ms": call_ms,
               "bn_moments_a_step": [
                   (bm.bn_moments_forward.launches - bn_before[0])
                   / TRACE_STEPS,
                   (bm.bn_moments_backward.launches - bn_before[1])
                   / TRACE_STEPS],
               "unit_tail_a_step": [
                   (ut.unit_tail_forward.launches - tail_before[0])
                   / TRACE_STEPS,
                   (ut.unit_tail_backward.launches - tail_before[1])
                   / TRACE_STEPS]}
        if prof is not None:
            with tempfile.NamedTemporaryFile(suffix=".json") as f:
                prof.export_chrome_trace(f.name)
                got["kernels"] = trace_kernels(f.name)
        del step, ts
        torch.cuda.synchronize()
        return got

    plain, marked = run(False), run(True)
    bitwise = (plain["losses"] == marked["losses"] and all(
        torch.equal(a, b) for a, b in zip(plain["tensors"],
                                          marked["tensors"])))
    kernels = marked["kernels"]
    nccl = {id(k) for k in pattern_claimed(kernels, "nccl_ms.train")}
    marks, kinds, phase_of, phases, current = [], [], {}, {}, None
    for k in kernels:       # a kernel is in the latest mark's phase
        m = PHASE_MARK.search(k[0])
        if m:
            current = m.group(1)
            marks.append(k)
            kinds.append(current)
            phases.setdefault(current, [])
        elif current is not None and id(k) not in nccl:
            phases[current].append(k)
        phase_of[id(k)] = current
    want = expected_marks(len(cfg.plan), mesh is not None) * TRACE_STEPS
    first = kernels.index(marks[0]) if marks else len(kernels)
    work = [k for k in kernels[first:] if not PHASE_MARK.search(k[0])
            and id(k) not in nccl]
    by_phase = {name: kernels_ms(found) / TRACE_STEPS
                for name, found in phases.items()}
    misplaced = {}
    for metric, home in (("roofline.spatial.train", "spatial"),
                         ("roofline.temporal.train", "temporal")):
        claimed = pattern_claimed(kernels, metric)
        wrong = sorted({f"{phase_of[id(k)]}: {k[0][:80]}" for k in claimed
                        if phase_of[id(k)] != home})
        misplaced[metric] = {"claimed": len(claimed), "outside": wrong[:8]}
    # the tail op's kernels, which no metric's patterns claim, in the tail
    tail_op = [k for k in kernels if UNIT_TAIL_KERNEL.search(k[0])]
    tail_op_outside = sorted({f"{phase_of[id(k)]}: {k[0][:80]}"
                              for k in tail_op
                              if phase_of[id(k)] != "tail"})
    unclaimed = {id(k) for k in kernels} - {
        id(k) for metric in ("roofline.spatial.train",
                             "roofline.temporal.train", "nccl_ms.train")
        for k in pattern_claimed(kernels, metric)}
    rest = {name: kernels_ms([k for k in found if id(k) in unclaimed])
            / TRACE_STEPS for name, found in phases.items()}
    marker_us = sum(k[2] - k[1] for k in marks) / TRACE_STEPS
    by_kernel = {}      # the largest kernels of the phases outside the ops
    for name in ("bn_stats", "tail"):
        sums: dict = {}
        for k in phases.get(name, []):
            short = k[0][:72]
            sums[short] = sums.get(short, 0.0) + (k[2] - k[1]) / 1e3
        top = sorted(sums.items(), key=lambda kv: -kv[1])[:10]
        by_kernel[name] = {n: v / TRACE_STEPS for n, v in top}
    out = {
        "bitwise": bitwise, "losses": marked["losses"],
        "plain_graphs": [plain["graphs"], plain["marked"]],
        "traced_graphs": [marked["graphs"], marked["marked"]],
        "marks_a_step": len(marks) / TRACE_STEPS,
        "marks_in_order": kinds == want,
        "phase_ms": by_phase,
        "phase_rest_ms": rest,
        "phase_top_kernels_ms": by_kernel,
        "phases_ms_sum": sum(by_phase.values()),
        "replay_kernel_ms": kernels_ms(work) / TRACE_STEPS,
        "kernels_before_first_mark": first,
        "marker_us_a_step": marker_us,
        "roofline_kernels": misplaced,
        "warm_up_and_capture_ms": plain["setup_ms"],
        "plain_call_ms": plain["call_ms"],
        "traced_call_ms": marked["call_ms"],
        # the BatchNorm statistics op: forward and backward launches a
        # replay, plain and marked (unit 0's first BN takes no gradient)
        "bn_moments_a_step": [plain["bn_moments_a_step"],
                              marked["bn_moments_a_step"]],
        # the tail op: launches a replay, plain and marked; its kernels a
        # step and those outside the tail phase
        "unit_tail_a_step": [plain["unit_tail_a_step"],
                             marked["unit_tail_a_step"]],
        "unit_tail_kernels_a_step": len(tail_op) / TRACE_STEPS,
        "unit_tail_outside_tail": tail_op_outside[:8],
    }
    units = len(cfg.plan)
    out["ok"] = bool(
        bitwise and out["marks_in_order"]
        and plain["graphs"] == marked["graphs"] == 1
        and plain["marked"] == marked["marked"] == 1
        and abs(out["phases_ms_sum"] - out["replay_kernel_ms"])
        <= 1e-6 * out["replay_kernel_ms"]
        and all(m["claimed"] and not m["outside"]
                for m in misplaced.values())
        and all(n == [2 * units, 2 * units - 1]
                for n in out["bn_moments_a_step"])
        and all(n == [units, units] for n in out["unit_tail_a_step"])
        and out["unit_tail_kernels_a_step"] == 2 * units
        and not tail_op_outside)
    if not out["marks_in_order"]:
        out["kinds_head"] = kinds[:12]
        out["want_head"] = want[:12]
    return out


def trace_main(cards: bool) -> int:
    """``python3 chip_smoke.py --trace [--parallel-cards]``: the phase
    marks' check (:func:`trace_check`) on one card, or with
    ``--parallel-cards`` data parallel over the machine's cards (up to 4)
    on NCCL, one rank a card (the ranks' results on rank 0's line)."""
    import torch

    from stgcn_tpu_torch.kernels import _build

    start = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(smi, flush=True)
    _build.build()
    _build.load_library()
    if not cards:
        result = trace_check(torch.device("cuda", 0))
    else:
        n = min(torch.cuda.device_count(), 4)
        if n < 2:
            print("--trace --parallel-cards needs two CUDA devices or more",
                  file=sys.stderr)
            return 1
        with tempfile.TemporaryDirectory() as tmp:
            codes, outs = spawn_ranks("trace", "nccl", tmp, world=n,
                                      cards=True)
            path = Path(tmp) / "trace.json"
            if any(codes) or not path.exists():
                for r, (c, o) in enumerate(zip(codes, outs)):
                    print(f"rank {r} exit {c}:\n{o[-4000:]}", flush=True)
                return 1
            result = json.loads(path.read_text())
    emit("trace", cards=cards, **result)
    emit("run", run_seconds=time.perf_counter() - start)
    return 0 if result["ok"] else 1


def trace_rank(dev, tmp: str) -> int:
    """One rank of ``--trace --parallel-cards``: the check on the data
    mesh over every rank; rank 0 writes every rank's result."""
    import torch.distributed as dist

    from stgcn_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh(data=dist.get_world_size(), device=dev)
    mine = trace_check(dev, mesh)
    every = [None] * dist.get_world_size()
    dist.all_gather_object(every, mine)
    if dist.get_rank() == 0:
        first = dict(every[0])
        first["ranks"] = [{k: r[k] for k in ("ok", "bitwise",
                                            "marks_in_order",
                                            "marks_a_step")}
                          for r in every]
        first["ok"] = all(r["ok"] for r in every)
        (Path(tmp) / "trace.json").write_text(json.dumps(first))
    dist.barrier()
    return 0


def parallel_phase(smi: str, dev) -> dict:
    """Phase 20: case (a) in this process, then case (b) on two spawned
    ranks."""
    one = parallel_one_rank(smi, dev)
    two = parallel_two_ranks(smi, dev, one)
    return {"one_rank": one, "two_ranks": two}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke.py needs a CUDA device", file=sys.stderr)
        return 1
    signal.signal(signal.SIGALRM, _deadline)
    signal.alarm(DEADLINE_S)

    from stgcn_tpu_torch.graph.adjacency import Strategy
    from stgcn_tpu_torch.kernels import _build
    from stgcn_tpu_torch.kernels.block_eval import (
        block_eval,
        block_eval_reference,
        plan_mma,
        plan_tiles,
    )
    from stgcn_tpu_torch.kernels.spatial_block import spatial_block_forward
    from stgcn_tpu_torch.kernels.temporal_block import temporal_block_forward
    from stgcn_tpu_torch.models.fused import (
        fused_block_args,
        fused_eval_forward,
    )
    from stgcn_tpu_torch.models.stgcn import DEFAULT_PLAN, STGCN, STGCNConfig
    from stgcn_tpu_torch.serving import Predictor

    run_start = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")

    # ---- 1. device ---------------------------------------------------------
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(smi, flush=True)
    part, peak_flops, peak_bytes = card_peaks(name)
    emit("device", name=name, count=torch.cuda.device_count(),
         nvidia_smi=smi, peaks_from=part, torch=torch.__version__,
         cuda=torch.version.cuda)

    # ---- 2. build ----------------------------------------------------------
    lib_path, build_s = _build.build()
    _build.load_library()
    emit("build", library=str(lib_path.relative_to(_build.REPO_ROOT)),
         seconds=build_s)
    sass_phase(lib_path)

    # ---- 3. kernel against its plain version -------------------------------
    # the six block shapes of DEFAULT_PLAN, with the frames the main path
    # gives each: (c_in, c_out, stride, shortcut, t_in)
    shapes = [(2, 64, 1, "proj", T), (64, 64, 1, "id", T),
              (64, 128, 2, "proj", T), (128, 128, 1, "id", T // 2),
              (128, 256, 2, "proj", T // 2), (256, 256, 1, "id", T // 4)]
    cases = [(ci, co, s, sc, t, "pre", dt) for dt in (torch.bfloat16,
                                                      torch.float32)
             for ci, co, s, sc, t in shapes]
    cases += [(64, 128, 2, "none", T, "post", torch.bfloat16),
              (64, 128, 2, "none", T, "post", torch.float32)]
    gen = torch.Generator(device=dev).manual_seed(SEED)
    # the odd-width cases draw apart, so every other check sees the inputs
    # it saw before they were added
    odd_gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    kernel_max_err = 0.0
    masked_cases = [(128, 128, 1, "id", T // 2, "pre", torch.bfloat16),
                    (128, 256, 2, "proj", T // 2, "pre", torch.float32)]
    odd_cases = [(ODD_C, ODD_C, 1, "id", ODD_T, "pre", torch.bfloat16),
                 (ODD_C, ODD_C, 2, "proj", ODD_T, "pre", torch.bfloat16),
                 (ODD_C8, ODD_C8, 1, "id", ODD_T, "pre", torch.bfloat16),
                 (ODD_C8, ODD_C8, 2, "proj", ODD_T, "pre", torch.bfloat16)]
    odd8 = torch.Generator(device=dev).manual_seed(SEED + 11)
    for i, (ci, co, s, sc, t, order, dt) in enumerate(
            cases + masked_cases + odd_cases):
        masked = len(cases) <= i < len(cases) + len(masked_cases)
        rng = odd8 if ci == ODD_C8 else odd_gen if t == ODD_T else gen
        kw = random_block_args(rng, ci, co, sc == "proj", dev)
        x = torch.randn(V, B, t, ci, generator=rng, device=dev).to(dt)
        lengths = torch.randint(1, t + 1, (B,), generator=rng, device=dev)
        flags = dict(stride=s, order=order, shortcut=sc, relu1=order == "pre",
                     lengths=lengths if masked else None)
        out = block_eval(x, **kw, **flags)
        torch.cuda.synchronize()
        oracle = block_eval_reference(x.float(), **kw, **flags)
        err = (out.float() - oracle).abs().max().item()
        scale = oracle.abs().max().item()
        if dt == torch.float32:
            ok = torch.allclose(out, oracle, rtol=F32_RTOL, atol=F32_ATOL)
            tol = f"allclose rtol={F32_RTOL} atol={F32_ATOL}"
        else:
            ok = err <= BF16_REL * scale
            tol = f"max_abs_err <= {BF16_REL} * max|oracle|"
        plan = (plan_mma(V, t, ci, co, 2, s, 9) if dt == torch.bfloat16
                else dict(zip(("tt", "vg"), plan_tiles(V, ci, co, s, 9))))
        emit("kernel", c_in=ci, c_out=co, stride=s, t_in=t, shortcut=sc,
             order=order, dtype=str(dt).removeprefix("torch."),
             masked=masked, plan=plan, max_abs_err=err,
             max_abs_oracle=scale, tolerance=tol, ok=ok)
        if not ok:
            raise AssertionError(f"block_eval disagrees with its plain "
                                 f"version: {ci}->{co} s{s} {sc} {dt}")
        if dt == torch.bfloat16:
            kernel_max_err = max(kernel_max_err, err)
            case = dict(c_in=ci, c_out=co, stride=s, t_in=t, shortcut=sc,
                        order=order, masked=masked)
            check_tight("block_eval", "forward", out,
                        block_eval_reference(x, **kw, **flags), "kernel",
                        share=BLOCK_EVAL_TIGHT_SHARE, **case)
            check_repeat("block_eval", (out,), (block_eval(x, **kw, **flags),),
                         "kernel", direction="forward", **case)

    # ---- 4. serve: the port's main path ------------------------------------
    cfg = STGCNConfig(plan=DEFAULT_PLAN, strategy=Strategy.DISTANCE, d=1,
                      residual=True, compute_dtype=torch.bfloat16)
    model = STGCN(cfg, seed=SEED)
    randomize_batchnorm(model, torch.Generator().manual_seed(SEED))
    model32 = copy.deepcopy(model)
    model32.config = dataclasses.replace(cfg, compute_dtype=None)
    buckets = (152, T)
    pred = Predictor(model, buckets=buckets, max_batch=B)
    oracle_pred = Predictor(model32, buckets=buckets, max_batch=B,
                            use_fused=False)
    pred.warmup()
    rng = np.random.default_rng(SEED)
    requests = []
    for n in (64, 131, 200):
        lens = rng.integers(40, T + 1, n)
        requests.append([rng.normal(0, 1, (int(t), V, 2)).astype(np.float32)
                         for t in lens])

    block_eval.launches = 0
    answers, batches = [], 0
    serve_start = time.perf_counter()
    for seqs in requests:
        before = block_eval.launches
        answers.append(pred.predict(seqs))
        per_bucket: dict[int, int] = {}
        for seq in seqs:
            bk = next(b for b in buckets if seq.shape[0] <= b)
            per_bucket[bk] = per_bucket.get(bk, 0) + 1
        n_batches = sum(-(-c // B) for c in per_bucket.values())
        batches += n_batches
        if block_eval.launches - before != 10 * n_batches:
            raise AssertionError(
                f"expected {10 * n_batches} block_eval launches for "
                f"{n_batches} batches, saw {block_eval.launches - before}")
    serve_s = time.perf_counter() - serve_start
    main_path_launches = block_eval.launches

    agree = total = 0
    max_prob_diff = 0.0
    for seqs, ans in zip(requests, answers):
        if ans.probs.shape != (len(seqs), 6) or not np.isfinite(
                ans.probs).all():
            raise AssertionError("serving output has the wrong shape or is "
                                 "not finite")
        ref = oracle_pred.predict(seqs)
        agree += int((ref.labels == ans.labels).sum())
        total += len(seqs)
        max_prob_diff = max(max_prob_diff,
                            float(np.abs(ref.probs - ans.probs).max()))
    agreement = agree / total
    # the float32 kernel chain against the float32 op path, on a small input
    xs = torch.randn(4, 64, V, 2, generator=gen, device=dev)
    with torch.inference_mode():
        fused32 = fused_eval_forward(model32, *model32.params_and_state(),
                                     xs)
        ops32 = model32(xs)
    forward_err = (fused32 - ops32).abs().max().item()
    forward_scale = ops32.abs().max().item()
    ok = (agreement >= ARGMAX_AGREEMENT
          and forward_err <= FORWARD_REL * max(forward_scale, 1.0))
    emit("serve", requests=[len(s) for s in requests], batches=batches,
         launches=main_path_launches, launches_per_batch=(
             main_path_launches / batches), seconds=serve_s,
         argmax_agreement_vs_f32_ops=agreement,
         max_abs_prob_diff_vs_f32_ops=max_prob_diff,
         f32_fused_vs_ops_max_abs_err=forward_err,
         f32_ops_max_abs_logit=forward_scale, ok=ok)
    if not ok:
        raise AssertionError("serving answers disagree with the float32 "
                             "op path")

    # ---- 5. time ----------------------------------------------------------
    x = torch.randn(B, T, V, 2, generator=gen, device=dev).to(torch.bfloat16)
    h = x.permute(2, 0, 1, 3).contiguous()
    totals = dict(ms=0.0, plain_ms=0.0, split_ms=0.0, bound_ms=0.0, ops=0,
                  bytes=0)
    bound_by = {}
    c_prev = cfg.c_in
    with torch.inference_mode():
        for i, blk in enumerate(model.conv):
            bp, bs = blk.params_and_state()
            kw = fused_block_args(bp, bs, model.adjacency, residual=True,
                                  stride=blk.stride)
            c_out = cfg.plan[i][0]
            ms = cuda_time_ms(lambda: block_eval(h, **kw))
            plain_ms = cuda_time_ms(lambda: block_eval_reference(h, **kw))
            # the port's two train kernels at the same shapes, without the
            # shortcut: spatial_block, then temporal_block (its affine and
            # ReLU are the pre order's)
            sw = {k: kw[k].to(h.dtype) for k in ("w", "b", "a", "wt")}

            def split():
                z = spatial_block_forward(h, kw["s1"], kw["t1"], sw["w"],
                                          sw["b"], sw["a"],
                                          relu1=kw["relu1"])
                return temporal_block_forward(z, kw["s2"], kw["t2"],
                                              sw["wt"], kw["bt"],
                                              stride=blk.stride, relu2=True)

            split_ms = cuda_time_ms(split)
            ops, nbytes = block_cost(B, h.shape[2], c_prev, c_out, blk.stride)
            t_ops, t_bytes = ops / peak_flops * 1e3, nbytes / peak_bytes * 1e3
            bound = max(t_ops, t_bytes)
            by = "operations" if t_ops >= t_bytes else "bytes"
            bound_by[by] = bound_by.get(by, 0) + 1
            emit("time", block=i, c_in=c_prev, c_out=c_out, stride=blk.stride,
                 t_in=h.shape[2], ms=ms, plain_ms=plain_ms, split_ms=split_ms,
                 bound_ms=bound, bound_by=by, gflop=ops / 1e9,
                 mbytes=nbytes / 1e6, tflops=ops / ms / 1e9)
            for key, val in (("ms", ms), ("plain_ms", plain_ms),
                             ("split_ms", split_ms), ("bound_ms", bound),
                             ("ops", ops), ("bytes", nbytes)):
                totals[key] += val
            h = block_eval(h, **kw)
            c_prev = c_out
        weights = model.params_and_state()
        fwd_ms = cuda_time_ms(lambda: fused_eval_forward(model, *weights, x))
        ops_ms = cuda_time_ms(lambda: model(x))
    batches_np = [rng.normal(0, 1, (B, T, V, 2)).astype(np.float32)
                  for _ in range(4)]
    pred.predict_batch(batches_np[0])
    start = time.perf_counter()
    for xb in batches_np:
        pred.predict_batch(xb)
    serial = len(batches_np) * B / (time.perf_counter() - start)
    start = time.perf_counter()
    for _ in pred.predict_stream(batches_np):
        pass
    pipelined = len(batches_np) * B / (time.perf_counter() - start)
    emit("time", eval_forward_ms=fwd_ms, op_path_forward_ms=ops_ms,
         kernel_ms_per_forward=totals["ms"],
         rest_ms_per_forward=fwd_ms - totals["ms"],
         plain_ms_per_forward=totals["plain_ms"],
         split_ms_per_forward=totals["split_ms"],
         split=("spatial_block forward then temporal_block forward, "
                "V-major, inference_mode, without the shortcut"),
         bound_ms_per_forward=totals["bound_ms"],
         gflop_per_forward=totals["ops"] / 1e9,
         gbytes_per_forward=totals["bytes"] / 1e9,
         serving_serial_seq_per_s=serial,
         serving_pipelined_seq_per_s=pipelined, batch=B, frames=T,
         dtype="bfloat16", nvidia_smi=smi,
         run_seconds=time.perf_counter() - run_start)
    # their captured graphs would hold the graph memory pool, and with it
    # the largest later graph's memory, for the rest of the run
    del pred, oracle_pred

    memory_checkpoint("train_kernel")
    # ---- 6. train_kernel ----------------------------------------------------
    train_errors = train_kernel_phase(dev, gen, odd_gen)
    bn_moments_phase(dev)
    unit_tail_phase(dev)

    memory_checkpoint("train")
    # ---- 7. train, 8. train_time: the train path ---------------------------
    train = train_phase(dev, gen, peak_flops, peak_bytes)

    memory_checkpoint("conv_kernel")
    # ---- 9. conv_kernel, 10. route_train, 11. route_time: the two routes ----
    conv_errors = conv_kernel_phase(dev, gen, odd_gen)
    route_launches = route_train_phase(dev, gen)
    route_totals = route_time_phase(dev, gen, peak_flops, peak_bytes)

    memory_checkpoint("save_kernel")
    # ---- 12. save_kernel, 13. fused_train, 14. checkpoint, 15. fused_time:
    # the all-fused loop ------------------------------------------------------
    save_errors = save_kernel_phase(dev, gen)
    fused = fused_train_phase(dev, gen)
    checkpoint_phase(fused)
    fused_launches = fused["launches"]
    del fused
    save_totals = fused_time_phase(dev, gen, peak_flops, peak_bytes,
                                   train["totals"], train["conv_library"])

    memory_checkpoint("cli_train")
    # ---- 16. cli_train, 17. tools: the entry points, on one dataset ---------
    with tempfile.TemporaryDirectory() as tmp:
        cli = cli_train_phase(smi, dev, tmp)
        tools_phase(smi, dev, tmp, cli, fwd_ms)

    memory_checkpoint("route_options")
    # ---- 18. route_options: remat, bits8, the temporal impls ---------------
    route_options_phase(smi, dev)

    memory_checkpoint("graph")
    # ---- 21. graph: the captured steps against the eager ones -------------
    graph_results = graph_phase(smi, dev)

    memory_checkpoint("bench_tools")
    # ---- 22. bench_tools: the measurement tools ---------------------------
    with tempfile.TemporaryDirectory() as tmp:
        bench_tools_phase(smi, graph_results, tmp)

    memory_checkpoint("parallel")
    # ---- 20. parallel: the mesh paths (and phase 21's mesh case) -----------
    parallel_phase(smi, dev)

    # ---- 19. kernels --------------------------------------------------------
    kernels = [{
        "name": "block_eval",
        "route": "cuda",
        "source": "stgcn_tpu_torch/kernels/csrc/block_eval.cu",
        "replaces": ("stgcn_tpu/kernels/block_fused.py:61 _mega_kernel "
                     "(fused_block_vm); stgcn_tpu/kernels/block_packed.py:596"
                     " _mega_packed_kernel (fused_block_packed_eval)"),
        "launches": main_path_launches,
        "max_abs_err": kernel_max_err,
        "ms": totals["ms"],
        "plain_ms": totals["plain_ms"],
        "split_ms": totals["split_ms"],
        "bound_ms": totals["bound_ms"],
        "bound_by": max(bound_by, key=bound_by.get),
        "library_ms": None,
    }, train_kernel_entry(
        "spatial_block", "stgcn_tpu_torch/kernels/csrc/spatial_block.cu",
        "stgcn_tpu/kernels/block_fused.py:596 spatial_block_vm "
        "(_spatial_fwd_kernel :411, _spatial_bwd_kernel :433); "
        "stgcn_tpu/kernels/block_packed.py:188 spatial_block_packed "
        "(_sp_fwd_kernel :81, _sp_bwd_kernel :102)",
        train["launches"], train_errors, train["totals"]),
        train_kernel_entry(
        "temporal_block", "stgcn_tpu_torch/kernels/csrc/temporal_block.cu",
        "stgcn_tpu/kernels/block_fused.py:1013 temporal_block_vm "
        "(_temporal_fwd_kernel :890, _temporal_bwd_kernel :929); "
        "stgcn_tpu/kernels/block_packed.py:464 temporal_block_packed "
        "(_tp_fwd_kernel :365, _tp_bwd_kernel :393)",
        train["launches"], train_errors, train["totals"]),
        conv_kernel_entry(
        "spatial_conv", "stgcn_tpu_torch/kernels/csrc/spatial_block.cu",
        "stgcn_tpu/kernels/spatial_conv.py:110 spatial_conv_fused "
        "(_fwd_kernel :59, _bwd_kernel :187); "
        "stgcn_tpu/kernels/spatial_conv.py:462 spatial_conv_fused_vm "
        "(_fwd_kernel_vm :344, _bwd_kernel_vm :369)",
        route_launches, conv_errors, route_totals),
        conv_kernel_entry(
        "temporal_conv", "stgcn_tpu_torch/kernels/csrc/temporal_block.cu",
        "stgcn_tpu/kernels/temporal_conv.py:354 temporal_conv_fused "
        "(_fwd_kernel :116, _make_dx_kernel :193, _make_dw_kernel :271); "
        "stgcn_tpu/kernels/temporal_conv_vm.py:327 temporal_conv_fused_vm "
        "(_shiftsum_kernel :69, _make_dw_kernel :233)",
        route_launches, conv_errors, route_totals),
        train_kernel_entry(
        "spatial_block_save",
        "stgcn_tpu_torch/kernels/csrc/spatial_block.cu",
        "stgcn_tpu/kernels/block_fused.py:737 spatial_block_vm_save "
        "(_spatial_fwd_kernel_save :495, _spatial_bwd_kernel_saved :523)",
        fused_launches, save_errors, save_totals)]
    emit("run", run_seconds=time.perf_counter() - run_start,
         deadline_s=DEADLINE_S)
    print(smi, flush=True)      # the card again, near the end of the output
    print(json.dumps({"kernels": kernels}), flush=True)
    signal.alarm(0)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


# ---- --agcn: 2s-AGCN's adaptive graph and per-sample aggregation -------------
# (NM, T, C_in, C_out) of the train-agcn-ntu-b64 cell's units (64 clips x 2
# bodies): C_in 3 at T 300, the widths 64 / 128 / 256 at T 300 / 150 / 75
# and the two widening units; then C_in 3 and an odd width (40, T 37) off
# the cell
AGCN_SHAPES = ((128, 300, 3, 64), (128, 300, 64, 64), (128, 300, 64, 128),
               (128, 150, 128, 128), (128, 150, 128, 256),
               (128, 75, 256, 256))
AGCN_ODD = ((4, ODD_T, 3, 64), (6, ODD_T, ODD_C, ODD_C))
AGCN_K = 3
# launches of a replay of the captured AGCN step: each op once a unit, each
# way (the tail op twice: before the GCN's ReLU and the unit's);
# bn_moments 26 forward (data_bn, BN_g and BN_t of ten units, three down
# and two res BatchNorms) and 25 backward (data_bn's input takes no
# gradient)
AGCN_STEP_LAUNCHES = {"adaptive_graph": (10, 10), "sample_aggregate": (10, 10),
                      "temporal_block": (10, 10), "affine_relu": (20, 20),
                      "bn_moments": (26, 25), "unit_tail": (0, 0)}


def agcn_case(gen, nm, t, c_in, c_out, dev, timed: bool) -> list:
    """The two ops' kernels against their plain versions on the same bf16
    inputs (check_tight's rule; the float32 outputs C, dW, db and dA within
    TIGHT_GRAD_REL of the largest), and where ``c_in == c_out`` the tail
    op's kernels in its three ways (scaled, identity and no shortcut),
    the forward against float64, and with
    ``timed`` each way's device ms beside its bound.  Returns the failed
    checks' messages."""
    import torch

    from stgcn_tpu_torch.kernels import adaptive_graph as ag

    k, ce = AGCN_K, c_out // 4
    case = dict(nm=nm, t=t, c_in=c_in, c_out=c_out)
    x = torch.randn((V, nm, t, c_in), generator=gen, device=dev).to(
        torch.bfloat16)
    w = torch.randn((c_in, 2 * k * ce), generator=gen, device=dev) \
        * c_in ** -0.5
    b = 0.1 * torch.randn((2 * k * ce,), generator=gen, device=dev)
    failed = []

    def tight(name, direction, got, want):
        try:
            check_tight(name, direction, got, want, "agcn_kernel",
                        share=SPATIAL_TIGHT_SHARE, **case)
        except AssertionError as err:
            failed.append(str(err))

    c, e = ag.adaptive_graph_forward(x, w, b, k)
    tight("adaptive_graph", "forward", (e, c),
          ag.adaptive_graph_forward_reference(x, w, b, k)[::-1])
    c64, _ = ag.adaptive_graph_forward_reference(x.double(), w.double(),
                                                 b.double(), k)
    err64 = float((c.double() - c64).abs().max())
    dc = torch.randn(c.shape, generator=gen, device=dev)
    got = ag.adaptive_graph_backward(x, w, e, c, dc, k)
    tight("adaptive_graph", "backward", got,
          ag.adaptive_graph_backward_reference(x, w, e, c, dc, k))
    again = ag.adaptive_graph_backward(x, w, e, c, dc, k)
    a = (c + 0.1 * torch.rand(c.shape, generator=gen, device=dev)).float()
    z = ag.sample_aggregate_forward(x, a)
    tight("sample_aggregate", "forward", z,
          ag.sample_aggregate_forward_reference(x, a))
    dz = torch.randn(z.shape, generator=gen, device=dev).to(torch.bfloat16)
    got_a = ag.sample_aggregate_backward(x, a, dz)
    tight("sample_aggregate", "backward", got_a,
          ag.sample_aggregate_backward_reference(x, a, dz))
    if c_in == c_out:
        # the tail op on the unit's shape, in each of the ways the model
        # calls it: a scaled shortcut (BN(down(x)) or BN(res(x))), the
        # identity shortcut x, and none (unit 0's TCN tail)
        from stgcn_tpu_torch.kernels import affine_relu as ar

        gx = torch.randn(x.shape, generator=gen, device=dev).to(x.dtype)
        sa, t_, sb = (torch.randn((c_in,), generator=gen, device=dev)
                      for _ in range(3))
        dout = torch.randn(x.shape, generator=gen, device=dev).to(x.dtype)
        for variant, bb, sbb in (("scaled", x, sb), ("identity", x, None),
                                 ("none", None, None)):
            out = ar.affine_relu_forward(gx, sa, t_, bb, sbb)
            tight(f"affine_relu[{variant}]", "forward", out,
                  ar.affine_relu_forward_reference(gx, sa, t_, bb, sbb))
            tight(f"affine_relu[{variant}]", "backward",
                  tuple(d for d in ar.affine_relu_backward(
                      gx, sa, out, dout, bb, sbb) if d is not None),
                  tuple(d for d in ar.affine_relu_backward_reference(
                      gx, sa, out, dout, bb, sbb) if d is not None))
        out = ar.affine_relu_forward(gx, sa, t_, x, sb)
        if timed:
            tail_ms = {
                "fwd": graph_time_ms(lambda: ar.affine_relu_forward(
                    gx, sa, t_, x, sb)),
                "bwd": graph_time_ms(lambda: ar.affine_relu_backward(
                    gx, sa, out, dout, x, sb))}
    bitwise = all(torch.equal(p, q) for p, q in zip(got, again))
    line = dict(case, c_vs_float64=err64, backward_bitwise=bitwise)
    if not bitwise:
        failed.append(f"adaptive_graph backward not bitwise at {case}")
    if timed:
        _, peak_flops, peak_bytes = card_peaks(torch.cuda.get_device_name())
        n2, agg = 2 * k * ce, 2 * nm * t * k * V * V * c_in
        embed, gram = 2 * nm * t * V * c_in * n2, 2 * nm * k * V * V * ce * t
        # as stgcn_bench/costs/agcn.py counts them (weights left out):
        # x in and C out forward, x and dC in and dx out backward; x and A
        # in, z (K wide) out, and the same with dz and dA backward
        x_b, a_b = nm * t * V * c_in * 2, nm * k * V * V * 4
        bounds = {
            "adaptive_fwd": max((embed + gram) / peak_flops,
                                (x_b + a_b) / peak_bytes),
            "adaptive_bwd": max(2 * (embed + gram) / peak_flops,
                                (2 * x_b + a_b) / peak_bytes),
            "aggregate_fwd": max(agg / peak_flops,
                                 ((1 + k) * x_b + a_b) / peak_bytes),
            "aggregate_bwd": max(2 * agg / peak_flops,
                                 ((2 + k) * x_b + 2 * a_b) / peak_bytes)}
        line["ms"] = {
            "adaptive_fwd": graph_time_ms(
                lambda: ag.adaptive_graph_forward(x, w, b, k)),
            "adaptive_bwd": graph_time_ms(
                lambda: ag.adaptive_graph_backward(x, w, e, c, dc, k)),
            "aggregate_fwd": graph_time_ms(
                lambda: ag.sample_aggregate_forward(x, a)),
            "aggregate_bwd": graph_time_ms(
                lambda: ag.sample_aggregate_backward(x, a, dz))}
        line["bound_ms"] = {n: v * 1e3 for n, v in bounds.items()}
        if c_in == c_out:
            # three activations in and one out forward, four in two out
            # backward
            line["affine_relu_ms"] = tail_ms
            line["affine_relu_bound_ms"] = {
                "fwd": 3 * x_b / peak_bytes * 1e3,
                "bwd": 6 * x_b / peak_bytes * 1e3}
        line["plain_ms"] = {
            "adaptive_fwd": graph_time_ms(
                lambda: ag.adaptive_graph_forward_reference(x, w, b, k)),
            "aggregate_fwd": graph_time_ms(
                lambda: ag.sample_aggregate_forward_reference(x, a))}
    emit("agcn_case", **line)
    return failed


def agcn_step(dev, steps: int = 3) -> dict:
    """The captured AGCN train step at the cell's shape (64 clips x 2
    bodies x 300 frames, bf16 kernels, Nesterov SGD with weight decay):
    each counted op's launches a replay, the step's device ms, peak memory
    and the losses."""
    import torch

    from stgcn_tpu_torch.kernels import adaptive_graph as ag
    from stgcn_tpu_torch.kernels import affine_relu as ar
    from stgcn_tpu_torch.kernels import bn_moments as bm
    from stgcn_tpu_torch.kernels import temporal_block as tb
    from stgcn_tpu_torch.kernels import unit_tail as ut
    from stgcn_tpu_torch.models.agcn import AGCN, AGCNConfig
    from stgcn_tpu_torch.training.loop import make_train_step
    from stgcn_tpu_torch.training.optimizers import OptimizerSpec
    from stgcn_tpu_torch.training.train_state import train_state_from

    counters = {"adaptive_graph": (ag.adaptive_graph_forward,
                                   ag.adaptive_graph_backward),
                "sample_aggregate": (ag.sample_aggregate_forward,
                                     ag.sample_aggregate_backward),
                "temporal_block": (tb.temporal_block_forward,
                                   tb.temporal_block_backward),
                "affine_relu": (ar.affine_relu_forward,
                                ar.affine_relu_backward),
                "bn_moments": (bm.bn_moments_forward,
                               bm.bn_moments_backward),
                "unit_tail": (ut.unit_tail_forward, ut.unit_tail_backward)}
    model = AGCN(AGCNConfig(block_impl="kernels",
                            compute_dtype=torch.bfloat16)).to(dev)
    params, state = model.init_params(SEED)
    spec = OptimizerSpec("momentum", 0.1, momentum=0.9, weight_decay=1e-4,
                         nesterov=True)
    ts = train_state_from(params, state, spec, SEED, dev)
    step = make_train_step(model)
    gen = torch.Generator(device=dev).manual_seed(SEED + 51)
    batches = [(torch.randn((B, 2, 300, V, 3), generator=gen, device=dev),
                torch.randint(0, 60, (B,), generator=gen, device=dev))
               for _ in range(2 + steps)]
    torch.cuda.reset_peak_memory_stats(dev)
    losses = [float(step(ts, x, y)["loss"]) for x, y in batches[:2]]
    torch.cuda.synchronize()
    before = {n: (f.launches, g.launches) for n, (f, g) in counters.items()}
    losses += [float(step(ts, x, y)["loss"]) for x, y in batches[2:]]
    torch.cuda.synchronize()
    launches = {n: [(f.launches - before[n][0]) / steps,
                    (g.launches - before[n][1]) / steps]
                for n, (f, g) in counters.items()}
    x, y = batches[-1]
    ms = cuda_time_ms(lambda: step(ts, x, y), reps=10, warmup=1)
    out = {"launches_a_replay": launches, "step_ms": ms,
           "clips_per_s": B / ms * 1e3, "losses": losses,
           "peak_gib": torch.cuda.max_memory_allocated(dev) / 2 ** 30,
           "graphs": step.cache_size}
    out["ok"] = bool(all(tuple(v) == AGCN_STEP_LAUNCHES[n]
                         for n, v in launches.items())
                     and all(np.isfinite(v) for v in losses))
    return out


def agcn_main() -> int:
    """``python3 chip_smoke.py --agcn``: 2s-AGCN's adaptive graph and
    per-sample aggregation kernels against their plain versions at every
    unit shape of the train-agcn-ntu-b64 cell and two small odd cases,
    timed beside their bounds; then the captured train step's launches a
    replay, step time and peak memory."""
    import torch

    from stgcn_tpu_torch.kernels import _build

    start = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    emit("device", nvidia_smi=smi, torch=torch.__version__,
         cuda=torch.version.cuda)
    lib_path, build_s = _build.build()
    _build.load_library()
    emit("build", library=lib_path.name, seconds=build_s)
    gen = torch.Generator(device=dev).manual_seed(SEED + 50)
    failed = []
    for cases, timed in ((AGCN_ODD, False), (AGCN_SHAPES, True)):
        for shape in cases:
            failed += agcn_case(gen, *shape, dev, timed)
            torch.cuda.empty_cache()
    line = agcn_step(dev)
    emit("agcn_step", **line)
    ok = line["ok"] and not failed
    emit("run", run_seconds=time.perf_counter() - start, ok=bool(ok),
         failed=failed[:5])
    return 0 if ok else 1


if __name__ == "__main__":
    if sys.argv[1:2] == ["--parallel-rank"]:
        sys.exit(parallel_rank_main(sys.argv[2], sys.argv[3],
                                    int(sys.argv[4]), int(sys.argv[5]),
                                    sys.argv[6], sys.argv[7] == "1"))
    if sys.argv[1:2] == ["--trace"]:
        sys.exit(trace_main("--parallel-cards" in sys.argv[2:]))
    if sys.argv[1:2] == ["--bn-moments"]:
        sys.exit(bn_moments_main())
    if sys.argv[1:2] == ["--unit-tail"]:
        sys.exit(unit_tail_main())
    if sys.argv[1:2] == ["--agcn"]:
        sys.exit(agcn_main())
    if sys.argv[1:2] == ["--parallel-cards"]:
        sys.exit(parallel_cards_main())
    sys.exit(main())
