"""The 2s-AGCN training cell (``drivers/train_agcn.py``): at a small size
on the CPU, a sound run comes out correct, and runs whose timed path is
broken come out not correct: the adaptive graph ``C_k`` left out (what a
program that dropped the mechanism would give), half of each batch, the
state or the statistics left unchanged.  And the files the benchmark had
before this cell came are byte for byte as they were: the cell came in as
new files and new entries of ``BENCHMARK.json`` only."""

import hashlib

import pytest
import torch

from stgcn_bench.tests.conftest import REPO
from stgcn_bench.tests.small import correct, run
from stgcn_bench import harness

WORKLOAD = "train-agcn-ntu-b64"

# git's blob hash of every file of stgcn_bench/ before the AGCN cell
BEFORE = {
    "stgcn_bench/__init__.py": "e69de29bb2d1d6434b8b29ae775ad8c2e48c5391",
    "stgcn_bench/calibrate.py": "707f895b285053d1ad36c5d0db8b5203a582de2c",
    "stgcn_bench/check.py": "bace68c0a201ea3d4c8f74b492ab646f360b7afd",
    "stgcn_bench/configs/stgcn10-kth.json": "6dcc41f6c992052f514fee57a3a273d2410eebc6",
    "stgcn_bench/configs/stgcn9-ntu.json": "fdfa257dfbc81acc6e0969d6a5d79ae2b7baaa18",
    "stgcn_bench/costs/__init__.py": "e69de29bb2d1d6434b8b29ae775ad8c2e48c5391",
    "stgcn_bench/costs/flops.py": "ab4e2f2053580751bab0714c13abb424aeac2d55",
    "stgcn_bench/costs/kernels.py": "da9fd35ac7622c2e38d10c71fa5d4940cfc04fe6",
    "stgcn_bench/drivers/__init__.py": "e69de29bb2d1d6434b8b29ae775ad8c2e48c5391",
    "stgcn_bench/drivers/serve_closed.py": "0463839e7dbcfa6b8275116167f37139a966118b",
    "stgcn_bench/drivers/train_dp.py": "f7eaaa4c4beb6f9be02c2875528254d63ace0c8c",
    "stgcn_bench/drivers/train_steps.py": "884e8853f9c9c1c8f1a2a545e482c1065cee56f2",
    "stgcn_bench/harness.py": "f407ab3e57a76c4ab49d12d4e52421103c53b7ca",
    "stgcn_bench/limits/serve-kth-clips.json": "91cbbbfa3ceceb5ef4f147f67ebd63b3102850bd",
    "stgcn_bench/limits/train-kth-b64.json": "7c3378ff55aeae2cdc90558a85995b14f7478d17",
    "stgcn_bench/limits/train-ntu-b256-dp4.json": "a338483cb50fb980287862a520cf443b29fa4fda",
    "stgcn_bench/limits/train-ntu-b64.json": "a7f4187d1755af394c320c423bbe5e50ce02df68",
    "stgcn_bench/metrics/__init__.py": "e69de29bb2d1d6434b8b29ae775ad8c2e48c5391",
    "stgcn_bench/metrics/_kernels.py": "e0b29b47f506197ca2e0e8598717036f76e06955",
    "stgcn_bench/metrics/_phases.py": "d899f256a61dde2f6943174149e03715441b2f4c",
    "stgcn_bench/metrics/bn_stats_ms.train.py": "0cda4e0baf4b8a0a4494d63378d6738fc0e6efdf",
    "stgcn_bench/metrics/collate_ms.serve.py": "973ea6fd240c68adeae3f893845fa2c22c32d864",
    "stgcn_bench/metrics/device_idle.serve.py": "986622a7d078521159cab6257da67fad715c2e9c",
    "stgcn_bench/metrics/device_idle.train.py": "f638e8c1a13e816850002b75a2bcca86acf0b422",
    "stgcn_bench/metrics/grad_sync_ms.train.py": "98b17a8f27be71dd386db368c2b49411bde8e215",
    "stgcn_bench/metrics/host_gap_ms.serve.py": "63bc89a9f931bf100877b5eda1e91e336c28045e",
    "stgcn_bench/metrics/issue_ms.train.py": "207d497c2f3baef566a3b1cf52a5206431d20b4c",
    "stgcn_bench/metrics/mfu.serve.py": "86a400b2a8e1530dc8355b123dd6ca6ca0ce0fdf",
    "stgcn_bench/metrics/mfu.train.py": "64bfda373fff642d9913bf7bf60a487374129f7c",
    "stgcn_bench/metrics/nccl_ms.train.d/nccl.txt": "04a0105b83fea5a924657df1e57ce25ae75f2dd7",
    "stgcn_bench/metrics/nccl_ms.train.py": "151fcb78059b8e8aa0c8764bc34a149651b6bc59",
    "stgcn_bench/metrics/optimizer_ms.train.py": "21fe9a0f25800d507b5eb197f3af28e74cec54f6",
    "stgcn_bench/metrics/rest_ms.train.py": "91ddb78245be6bcf5784867e31a131b62bd30b4e",
    "stgcn_bench/metrics/roofline.block_eval.serve.d/block_eval.txt": "3baa8bfd4ac673d3dcbf7d9bc62c97d9d65a61e7",
    "stgcn_bench/metrics/roofline.block_eval.serve.py": "6fd935c0e9d93fce2985544cd211eceafd3c2c8a",
    "stgcn_bench/metrics/roofline.spatial.train.d/spatial_block.txt": "ed25c307da8ae68f01c6a577b0d17afacebd3c61",
    "stgcn_bench/metrics/roofline.spatial.train.py": "1fa711270a2b363e0c00f08931154dea1d945344",
    "stgcn_bench/metrics/roofline.temporal.train.d/temporal_block.txt": "7e8080c042b7d95721ac2f53088a60ad526419b1",
    "stgcn_bench/metrics/roofline.temporal.train.py": "274b77a78ec77b71ad6387404a434a63cb0d76e5",
    "stgcn_bench/metrics/tail_ms.train.py": "231dde84910cd1b5679de93fdf0409614bf6295e",
    "stgcn_bench/reference/__init__.py": "e69de29bb2d1d6434b8b29ae775ad8c2e48c5391",
    "stgcn_bench/reference/stgcn.py": "34298887e19b9709d736bc333602ca1139e467f1",
    "stgcn_bench/run.py": "d81eef5c31deb7d9aa9f4719cc268ec148abbfa5",
    "stgcn_bench/shapes.py": "3988ca5a0028c18cd1194e805a41b04fff22fc7d",
    "stgcn_bench/tests/conftest.py": "7153b88301f0a4394670cc2fadc1c118b043ef9e",
    "stgcn_bench/tests/cpu_run.py": "ceb300b8c2d90d3486db5d0118c7a4ec397cdf40",
    "stgcn_bench/tests/dp_rank.py": "bd6f6b793e87dcfbcaac844031554773b6170c76",
    "stgcn_bench/tests/small.py": "22643f67a905b08f416c9841c348c444473311c1",
    "stgcn_bench/tests/test_stgcn_bench_card.py": "ff74fa31dcba26221639ba93c38bb654b45075d8",
    "stgcn_bench/tests/test_stgcn_bench_control.py": "aebac7bfb834346856a988ab2f719baf9c93b720",
    "stgcn_bench/tests/test_stgcn_bench_costs.py": "d31ddcd0eb31656d81e36389a42e89c64500dbee",
    "stgcn_bench/tests/test_stgcn_bench_data_driven.py": "afdbe70e6cdefd2fcb60067312abbed1584fcfcd",
    "stgcn_bench/tests/test_stgcn_bench_faults.py": "3dfac1434b21feab2ba46823de633d06e1c350ed",
    "stgcn_bench/tests/test_stgcn_bench_isolation.py": "00389378b1e99dd177011035751378b5e78daaa0",
    "stgcn_bench/tests/test_stgcn_bench_reference.py": "3e15edd391e6e8d769b47028f9ac8cb0048ab4dd",
    "stgcn_bench/trace.py": "d9598ad03caf6366424291fece7612e4293414c7",
    "stgcn_bench/traffic/serve-clips-64-256.json": "41a6476e3a7172cc443833401def98a34f0c5dca",
    "stgcn_bench/traffic/train-b64-t300.json": "217cfac836a75c730449eaebfe3b417c1f247d52",
    "stgcn_bench/traffic/train-b64-t304.json": "7b32e2c2f99e854140a349fbece2b6614a6f4421",
    "stgcn_bench/traffic/train-dp4-b256-t300.json": "eac228d26c09aa55340bca093d2cb070ee38477b",
    "stgcn_bench/training.py": "d7e4d730a1bc6e73bcc686e543774c865822b0e1",
    "stgcn_bench/weights.py": "43048962f835a0a5bca2aa88fd300059c5daca65",
}


def small_agcn(f32: bool = True):
    cell = harness.load_cell(WORKLOAD)
    g = cell.config["agcn_config"]
    g["plan"] = [[8, 1], [16, 2], [16, 1]]
    if f32:
        g["compute_dtype"] = "float32"
    cell.traffic.update(batch=4, frames=16, ring=4)
    return cell


def _step_of(fault):
    def make(model):
        from stgcn_tpu_torch.training.loop import make_train_step
        from stgcn_tpu_torch.tree import tree_leaves

        real = make_train_step(model)

        def step(ts, x, y):
            if fault == "half_batch":
                half = x.shape[0] // 2
                return real(ts, x[:half], y[:half])
            tree = ts.params if fault == "frozen" else ts.model_state
            kept = [t.detach().clone() for t in tree_leaves(tree)]
            out = real(ts, x, y)
            with torch.no_grad():
                for t, k in zip(tree_leaves(tree), kept):
                    t.copy_(k)
            return out
        return step
    return make


def test_sound_run_is_correct():
    out = run(small_agcn())
    assert out["attempted"] > 0 and correct(out)


def test_sound_bf16_run_is_correct():
    assert correct(run(small_agcn(f32=False)))


@pytest.mark.parametrize("fault", ["half_batch", "frozen", "stats_frozen"])
def test_broken_run_is_not_correct(fault):
    assert not correct(run(small_agcn(), make_step=_step_of(fault)))


def test_program_without_the_adaptive_graph_is_not_correct(monkeypatch):
    from stgcn_tpu_torch.models import agcn

    def constant(x, w, b, k):
        v, nm = x.shape[0], x.shape[1]
        return torch.zeros((nm, k, v, v), dtype=torch.float32) + 0 * w.sum()

    monkeypatch.setattr(agcn, "adaptive_graph", constant)
    assert not correct(run(small_agcn()))


def test_planted_faults_read_beyond_the_limits():
    """The calibration's faults in the reference (no C_k, half the batch)
    against the reference, under the cell's limits."""
    from stgcn_bench import calibrate_agcn

    cell = small_agcn()
    out = run(cell)
    readings = dict(calibrate_agcn.planted(cell, out["check_inputs"]))
    for kind in ("fault_no_adaptive", "fault_half_batch"):
        assert any(readings[kind][name] > lim for name, lim in
                   cell.limits.items() if name in readings[kind]), kind


@pytest.mark.parametrize("name,kernel,after,bound", [
    ("roofline.adaptive.train", "agcn_gram_kernel(GramArgs)",
     "void at::native::reduce_kernel<512, 1>(R)", "adaptive_bound_ms"),
    ("roofline.temporal.agcn.train",
     "void (anonymous namespace)::tap_gemm_kernel<128>(TapArgs)",
     "void reduce_partials<float>(P)", "temporal_bound_ms")])
def test_kernel_readers_share_of_their_bound(name, kernel, after, bound):
    """Each AGCN roofline reader claims its own kernels (and the
    reduction behind them) and reads the cell's bound over their device
    time; without them, or outside a train cell, it reads nothing."""
    from stgcn_bench import trace as tracing
    from stgcn_bench.costs import agcn, kernels

    cell = harness.load_cell(WORKLOAD)
    ops = [(kernel, 0, 400, 7, "kernel"), (after, 400, 500, 7, "kernel"),
           ("other_kernel", 500, 600, 7, "kernel"),
           (after, 600, 650, 7, "kernel")]
    tr = tracing.Trace(ops, [], [], (0, 1000))
    ctx = {"trace": tr, "steps": 2, "batch": 64, "frames": 300,
           "bodies": 2, "cell": cell, "chips": 1,
           "device_name": "NVIDIA H100 80GB HBM3"}
    r = harness.metric_reader(cell, name)
    assert [k[0] for k in r.claims(ctx)] == [kernel, after]
    _, pf, pb = kernels.card_peaks("NVIDIA H100 80GB HBM3")
    want = getattr(agcn, bound)(cell.config, 64, 300, 2, pf, pb)
    assert r.read(ctx) == pytest.approx(100 * 2 * want / 0.5)
    bare = tracing.Trace(ops[2:3], [], [], (0, 1000))
    assert r.read(dict(ctx, trace=bare)) is None
    assert r.read({"trace": tr}) is None


def git_blob(data: bytes) -> str:
    return hashlib.sha1(b"blob %d\0" % len(data) + data).hexdigest()


def test_files_the_benchmark_had_are_unchanged():
    for rel, blob in BEFORE.items():
        assert git_blob((REPO / rel).read_bytes()) == blob, rel
