"""The frozen cost copies equal what the program and its card check count
today, on both configurations."""

import importlib.util

import pytest
import torch

from stgcn_bench import harness, shapes
from stgcn_bench.costs import kernels as costs
from stgcn_bench.costs.flops import ModelFlops
from stgcn_bench.tests.conftest import REPO

CONFIGS = ["train-kth-b64", "train-ntu-b64"]


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke_costs",
                                                  REPO / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("workload", CONFIGS)
@pytest.mark.parametrize("batch,frames,train", [(64, 304, True),
                                                (64, 300, True),
                                                (7, 40, False)])
def test_model_flops_is_the_programs(workload, batch, frames, train):
    from stgcn_tpu_torch.models.stgcn import STGCN
    from stgcn_tpu_torch.utils.profiling import ModelFlops as Theirs

    cell = harness.load_cell(workload)
    cfg = cell.config
    dist = torch.linspace(0.1, 0.9, 25).numpy()
    model = STGCN(harness.program_config(cfg), distances=dist)
    theirs = Theirs.of(model, batch, frames, train=train)
    g = cfg["stgcn_config"]
    mine = ModelFlops.of([tuple(p) for p in g["plan"]], c_in=g["c_in"],
                         gamma=g["gamma"], classes=g["num_classes"], v=25,
                         k=shapes.partitions(cfg),
                         nnz=int((model.adjacency != 0).sum()), batch=batch,
                         t=frames, train=train)
    assert (mine.fwd_flops, mine.edges_processed, mine.frames) == \
        (theirs.fwd_flops, theirs.edges_processed, theirs.frames)


@pytest.mark.parametrize("k", [2, 3])
def test_kernel_costs_are_the_card_checks(k):
    cs = _chip_smoke()
    assert costs.PEAKS == cs.PEAKS
    for name in ("NVIDIA H100 80GB HBM3", "NVIDIA H100 PCIe"):
        assert costs.card_peaks(name) == cs.card_peaks(name)
    for c_in, c_out, stride, t in [(2, 64, 1, 304), (64, 128, 2, 304),
                                   (128, 256, 2, 150), (256, 256, 1, 75)]:
        assert costs.block_cost(64, t, c_in, c_out, stride, k) == \
            cs.block_cost(64, t, c_in, c_out, stride, k)
        assert costs.spatial_cost(64, t, c_in, c_out, k) == \
            cs.spatial_cost(64, t, c_in, c_out, k)
        assert costs.save_cost(64, t, c_in, c_out, k) == \
            cs.save_cost(64, t, c_in, c_out, k)
        assert costs.temporal_cost(64, t, c_out, stride) == \
            cs.temporal_cost(64, t, c_out, stride)
        cost = costs.spatial_cost(64, t, c_in, c_out, k)[1]
        assert costs.bound_ms(cost, 989e12, 3.35e12) == \
            cs.bound_ms(cost, 989e12, 3.35e12)


def test_served_batches_follow_the_predictor():
    """A request's batches: its clips by bucket, max_batch at a time, a
    partial batch padded as the Predictor pads it."""
    traffic = {"buckets": [152, 304], "max_batch": 64, "batch_pad": "max"}
    lengths = [40] * 70 + [200] * 10
    assert sorted(shapes.served_batches(traffic, [(None, lengths)])) == \
        [(64, 152), (64, 152), (64, 304)]
    traffic["batch_pad"] = "pow2"
    assert sorted(shapes.served_batches(traffic, [(None, lengths)])) == \
        [(8, 152), (16, 304), (64, 152)]
