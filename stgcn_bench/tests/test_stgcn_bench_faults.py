"""A run whose timed path is broken underneath comes out not correct: the
rest of the run as the benchmark drives it (its chip look skipped), on
the CPU at a small size, once for each fault a cell can have.  The same
runs unbroken come out correct (float32, where the program and the
reference agree to rounding)."""

import sys

import numpy as np
import pytest
import torch

from stgcn_bench.tests import dp_rank
from stgcn_bench.tests.conftest import REPO
from stgcn_bench.tests.small import correct, run, small_cell

TRAIN = ["train-kth-b64", "train-ntu-b64"]


def _frozen(model):
    """A train step that leaves its state as it found it."""
    from stgcn_tpu_torch.training.loop import make_train_step
    from stgcn_tpu_torch.tree import tree_leaves

    real = make_train_step(model)

    def step(ts, x, y):
        kept = [p.detach().clone() for p in tree_leaves(ts.params)]
        out = real(ts, x, y)
        with torch.no_grad():
            for p, k in zip(tree_leaves(ts.params), kept):
                p.copy_(k)
        return out
    return step


def _stats_frozen(model):
    """A train step that leaves the BatchNorm running statistics as it
    found them."""
    from stgcn_tpu_torch.training.loop import make_train_step
    from stgcn_tpu_torch.tree import tree_leaves

    real = make_train_step(model)

    def step(ts, x, y):
        kept = [s.detach().clone() for s in tree_leaves(ts.model_state)]
        out = real(ts, x, y)
        with torch.no_grad():
            for s, k in zip(tree_leaves(ts.model_state), kept):
                s.copy_(k)
        return out
    return step


def _half_batch(model):
    """A train step over the first half of each batch only."""
    from stgcn_tpu_torch.training.loop import make_train_step

    real = make_train_step(model)

    def step(ts, x, y):
        half = x.shape[0] // 2
        return real(ts, x[:half], y[:half])
    return step


class _Altered:
    """A predictor whose answers are changed where they are made: one
    clip's probabilities reversed, or half of every request unanswered."""

    def __init__(self, predictor, how):
        self.predictor, self.how = predictor, how

    def warmup(self):
        self.predictor.warmup()

    def predict(self, clips):
        out = self.predictor.predict(clips)
        if self.how == "answer":
            out.probs[0] = out.probs[0][::-1].copy()
        else:
            out.probs[len(clips) // 2:] = 0.0
        return out


@pytest.mark.parametrize("workload", TRAIN)
def test_sound_training_run_is_correct(workload):
    assert correct(run(small_cell(workload, f32=True)))


@pytest.mark.parametrize("workload", TRAIN)
@pytest.mark.parametrize("fault", [_frozen, _stats_frozen, _half_batch])
def test_broken_training_run_is_not_correct(workload, fault):
    out = run(small_cell(workload, f32=True), make_step=fault)
    assert not correct(out)


def test_sound_serving_run_is_correct():
    assert correct(run(small_cell("serve-kth-clips", f32=True)))


@pytest.mark.parametrize("how", ["answer", "half_batch"])
def test_broken_serving_run_is_not_correct(how):
    out = run(small_cell("serve-kth-clips", f32=True),
              wrap_predictor=lambda p: _Altered(p, how))
    assert not correct(out)


def _ranks(fault):
    def argv(env, cell, seed, seconds, trace, rank, rendezvous):
        return [sys.executable, str(REPO / "stgcn_bench" / "tests" /
                                    "dp_rank.py"), cell.name,
                str(rendezvous), str(rank), str(seed), str(seconds),
                *([fault] if fault else [])]
    return argv


@pytest.mark.parametrize("fault", [None, "no_exchange", "local_bn"])
def test_data_parallel_run_on_four_ranks(fault, monkeypatch):
    """Four gloo ranks on the CPU; without the gradients' all-reduce, or
    with each rank's BatchNorm over its own rows, the run is not
    correct."""
    if fault:
        from stgcn_tpu_torch.models import fused
        from stgcn_tpu_torch.parallel import fused_dp

        monkeypatch.setattr(fused_dp, "all_reduce_", fused_dp.all_reduce_)
        monkeypatch.setattr(fused, "fused_train_forward",
                            fused.fused_train_forward)
        dp_rank.FAULTS[fault]()
    out = run(small_cell("train-ntu-b256-dp4", f32=True), seconds=0.5,
              rank=0, rank_argv=_ranks(fault))
    assert out["attempted"] > 0 and np.isfinite(out["e2e"]["setup_s"])
    assert correct(out) is (fault is None)
