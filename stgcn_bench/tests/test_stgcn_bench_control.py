"""The control of each check fails it: the reference computed in 8-bit
floats (e4m3 values, e5m2 gradients), put in the program's place, reads
outside a limit of the cell, here at a size a test run holds (on the card
at the cells' own sizes: ``stgcn_bench/calibrate.py``)."""

import pytest
import torch

from stgcn_bench import calibrate, check, training
from stgcn_bench.reference import stgcn as ref
from stgcn_bench.tests.small import run, small_cell


@pytest.mark.parametrize("workload", ["train-kth-b64", "train-ntu-b64"])
def test_training_control_fails(workload):
    cell = small_cell(workload)
    out = run(cell)
    planted = dict(calibrate.train_planted(
        cell, 2 ** 31 + 11, out["check_inputs"], torch.device("cpu")))
    limits = cell.limits
    compared = [n for n in training.COMPARED if n in limits]
    for kind in ("control", "fault_half_batch"):
        readings = planted[kind]
        assert any(readings[n] > limits[n] for n in compared), \
            (kind, readings)


def test_serving_control_fails():
    """At the configuration's own widths and depth, on 128 clips of 10-80
    frames (buckets 40 and 80)."""
    from stgcn_bench import harness, weights
    from stgcn_bench.drivers import serve_closed

    torch.set_num_threads(4)
    cell = harness.load_cell("serve-kth-clips")
    cell.traffic.update(buckets=[40, 80], max_batch=16)
    gen = torch.Generator().manual_seed(2 ** 31 + 11)
    params, state = harness.make_weights(cell.config, gen, trained=True)
    pool = weights.skeleton_clips(128, 80, 25, 2, gen).numpy()
    lengths = [10 + (70 * i) // 127 for i in range(128)]
    requests = [(list(range(s, s + 32)), lengths[s:s + 32])
                for s in range(0, 128, 32)]
    args = (cell, params, state, None, pool, requests, torch.device("cpu"))
    want = serve_closed.reference_probs(*args)
    control = serve_closed.reference_probs(*args,
                                           rounding=ref.fp8_rounding)
    assert check.prob_gap(control, want) > cell.limits["prob_gap"]
