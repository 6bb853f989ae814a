"""The program's tracing (``stgcn_tpu_torch/utils/profiling.py``): phase
marks in the train step, spans in the ``Predictor``, the captured step's
marked graphs, and the benchmark's readers of them.

On the CPU a mark appends its kind to ``profiling.MARK_LOG``; the marker
kernels themselves run on the card (``chip_smoke.py --trace``)."""

from __future__ import annotations

import contextlib
import ctypes
import json
import re
import tempfile
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist

from stgcn_bench import harness
from stgcn_bench import trace as tracing
from stgcn_tpu_torch.graph.adjacency import Strategy
from stgcn_tpu_torch.kernels import _build
from stgcn_tpu_torch.kernels import phase_mark as pm
from stgcn_tpu_torch.models import stgcn as tm
from stgcn_tpu_torch.serving import Predictor
from stgcn_tpu_torch.training import graphs
from stgcn_tpu_torch.training import optimizers as opt
from stgcn_tpu_torch.training.loop import make_train_step
from stgcn_tpu_torch.training.train_state import train_state_from
from stgcn_tpu_torch.utils import profiling

PLAN = ((8, 1), (16, 2), (16, 1))
N, T = 4, 16
CPU = torch.device("cpu")
REPO = Path(__file__).resolve().parents[1]
METRICS = REPO / "stgcn_bench" / "metrics"
TRAIN_READERS = ("bn_stats_ms.train", "tail_ms.train", "optimizer_ms.train",
                 "grad_sync_ms.train")
FWD = {True: ["bn_stats", "spatial", "bn_stats", "temporal", "tail"],
       False: ["bn_stats", "spatial", "temporal", "bn_stats", "tail"]}
BWD = {True: ["tail", "temporal", "bn_stats", "spatial", "bn_stats"],
       False: ["tail", "bn_stats", "temporal", "spatial", "bn_stats"]}


@pytest.fixture(autouse=True)
def few_threads_and_a_clean_log():
    threads = torch.get_num_threads()
    torch.set_num_threads(min(threads, 2))
    profiling.MARK_LOG.clear()
    yield
    profiling.MARK_LOG.clear()
    torch.set_num_threads(threads)


def marker(kind: str) -> str:
    """The marker kernel's demangled name, as a profiler trace gives it."""
    return f"void stgcn_phase_mark<stgcn_phase::{kind}>()"


def profiled():
    return torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU])


def config(block_impl="fused", residual=True, **kw):
    return tm.STGCNConfig(plan=PLAN, strategy=Strategy.DISTANCE, d=1,
                          residual=residual, block_impl=block_impl,
                          dropout_rate=0.5, **kw)


def train_state(model, seed=0):
    params, state = model.init_params(seed)
    return train_state_from(params, state, opt.adam(1e-3), seed, CPU)


def batch(seed=0, n=N):
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 1, (n, T, 25, 2)).astype(np.float32)
    return torch.from_numpy(x), torch.from_numpy(rng.integers(0, 6, n))


def expected(residual: bool, units: int, mesh: bool = False) -> list:
    """A train step's marks: forward unit by unit, the head, backward last
    unit first (unit 0's input has no gradient: no mark there)."""
    return (["input"] + FWD[residual] * units + ["head"]
            + BWD[residual] * units + (["grad_sync"] if mesh else [])
            + ["optimizer"])


# ---- the marks of a train step ---------------------------------------------

class TestMarks:
    @pytest.mark.parametrize("residual", [True, False])
    @pytest.mark.parametrize("block_impl", ["fused", "ops", "hybrid"])
    def test_order_of_one_step(self, block_impl, residual):
        model = tm.STGCN(config(block_impl, residual, fused_from=1))
        ts = train_state(model)
        step = make_train_step(model)
        with profiled():
            step(ts, *batch())
        assert list(profiling.MARK_LOG) == expected(residual, len(PLAN))

    def test_vntc_route_brackets_each_unit(self):
        model = tm.STGCN(config("ops", layout="vntc"))
        with profiled():
            make_train_step(model)(train_state(model), *batch())
        assert list(profiling.MARK_LOG) == (
            ["input"] + ["bn_stats"] * len(PLAN) + ["head"]
            + ["tail"] * len(PLAN) + ["optimizer"])

    def test_nothing_without_a_profiler(self, monkeypatch):
        made = []
        real = torch.profiler.record_function

        def counting(*args, **kw):
            made.append(args)
            return real(*args, **kw)

        monkeypatch.setattr(torch.profiler, "record_function", counting)
        monkeypatch.setattr(profiling, "phase_mark",
                            lambda *a: made.append(a))
        model = tm.STGCN(config())
        ts = train_state(model)
        step = make_train_step(model)
        step(ts, *batch())
        pred = Predictor(model, buckets=(8, 16), max_batch=4, device="cpu")
        pred.predict([np.zeros((t, 25, 2), np.float32) for t in (5, 12, 16)])
        assert not profiling.tracing()
        assert list(profiling.MARK_LOG) == [] and made == []
        assert profiling.span("serve.collate") is profiling.span("x")

    @pytest.mark.parametrize("block_impl", ["fused", "ops"])
    def test_marked_step_is_bitwise_the_unmarked(self, block_impl):
        model = tm.STGCN(config(block_impl))
        runs = []
        for traced in (False, True):
            ts = train_state(model)
            step = make_train_step(model)
            losses = []
            for i in range(2):
                with profiled() if traced else contextlib.nullcontext():
                    losses.append(step(ts, *batch(i))["loss"].clone())
            runs.append((losses, [t.clone() for t in ts.tensors()],
                         [p.grad.clone() for p in ts.leaves()]))
        (l0, s0, g0), (l1, s1, g1) = runs
        assert profiling.MARK_LOG
        assert all(torch.equal(a, b) for a, b in zip(l0, l1))
        assert all(torch.equal(a, b) for a, b in zip(s0, s1))
        assert all(torch.equal(a, b) for a, b in zip(g0, g1))

    def test_unknown_kind_raises(self):
        with pytest.raises(ValueError):
            profiling._mark("backward", CPU)


@pytest.fixture()
def one_rank_gloo():
    """A one-rank gloo world of this process, taken down after."""
    from stgcn_tpu_torch.parallel.mesh import make_mesh

    if dist.is_initialized():
        pytest.skip("a torch.distributed world is already up here")
    mesh = make_mesh(data=1, device="cpu")
    yield mesh
    dist.destroy_process_group()


@pytest.mark.parametrize("block_impl", ["fused", "ops"])
def test_sharded_step_marks_grad_sync(one_rank_gloo, block_impl):
    from stgcn_tpu_torch.parallel.train import (
        create_sharded_train_state,
        make_sharded_train_step,
    )

    model = tm.STGCN(config(block_impl))
    ts, _ = create_sharded_train_state(model, opt.adam(1e-3), one_rank_gloo)
    step = make_sharded_train_step(model, one_rank_gloo)
    with profiled():
        step(ts, *batch())
    assert list(profiling.MARK_LOG) == expected(True, len(PLAN), mesh=True)


# ---- the captured step's graphs --------------------------------------------

class _FakeGraph:
    def __init__(self, replay):
        self.replay = replay


class _FakeCaptured(graphs.CapturedStep):
    """A captured step whose capture records which graph it made, and
    whether marks were on, and whose replay records which graph it ran (no
    CUDA here): the choice of graph alone."""

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.made, self.ran = [], []

    def _captures_on(self, device):
        return True

    def _eager(self, state, entry, warm_up, device):
        self.ran.append(("eager", profiling._marking()))
        return super()._eager(state, entry, False, device)

    def _capture(self, state, entry, device, marked):
        self.made.append((marked, profiling._marking()))
        entry.graphs[marked] = graphs._Graph(
            graph=_FakeGraph(lambda: self.ran.append(("replay", marked))),
            outputs=None, grads=[], launches=[], collectives={})


@pytest.mark.parametrize("traced_from_the_start", [False, True])
@pytest.mark.parametrize("marks", [True, False])
def test_the_marked_graph_is_captured_beside_the_plain(
        marks, traced_from_the_start):
    """The first capture makes the plain graph with marks off and, for a
    step with marks, the marked one with marks on, profiler or not; a
    call replays the marked one only while tracing; nothing else is ever
    captured."""
    step = _FakeCaptured(lambda state, x, generator=None: x + 1,
                         state_tensors=lambda s: [], marks=marks)
    x = torch.zeros(3)
    with profiled() if traced_from_the_start else contextlib.nullcontext():
        for _ in range(3):                  # warm-up, capture, replay
            step(None, x)
    made = [(False, False)] + ([(True, True)] if marks else [])
    assert step.made == made
    assert step.ran == [("eager", traced_from_the_start),
                        ("replay", traced_from_the_start and marks),
                        ("replay", traced_from_the_start and marks)]
    step.ran.clear()
    step(None, x)
    with profiled():
        step(None, x)
    step(None, x)
    assert step.made == made
    assert step.ran == [("replay", False), ("replay", marks),
                        ("replay", False)]
    assert step.cache_size == 1 and step.marked_graphs == int(marks)


# ---- spans in the Predictor ------------------------------------------------

def test_predict_spans_nest_inside_the_call():
    model = tm.STGCN(config())
    pred = Predictor(model, buckets=(8, 16), max_batch=4, device="cpu")
    rng = np.random.default_rng(3)
    seqs = [rng.normal(0, 1, (t, 25, 2)).astype(np.float32)
            for t in (3, 5, 8, 9, 12, 16, 16, 7, 11)]
    with profiled() as prof:
        with torch.profiler.record_function("request"):
            pred.predict(seqs)
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "trace.json"
        prof.export_chrome_trace(str(path))
        spans = tracing.parse(path).spans
    (_, lo, hi), = [s for s in spans if s[0] == "request"]
    names = [n for n, *_ in spans]
    chunks = 3              # 9 clips: 4 of the 8 bucket, 5 of 16 (4 + 1)
    assert names.count("serve.bucket") == 1
    # each chunk's assembly and copy, and the look that finds no more
    assert names.count("serve.collate") == 2 * chunks + 1
    assert names.count("serve.forward") == chunks
    assert names.count("serve.sync") == chunks
    assert names.count("serve.gather") == chunks + 1
    assert not {"window", "step", "predict"} & set(names)
    for name, s, e in spans:
        if name.startswith("serve."):
            assert lo <= s <= e <= hi


# ---- the marker kernel -----------------------------------------------------

def test_marker_names_match_no_metric_pattern():
    found = [p for d in METRICS.glob("*.d")
             for p in sum(tracing.patterns(d), [])]
    assert found
    for kind in pm.KINDS:
        name = marker(kind)
        assert not any(p.search(name) for p in found), name


def test_marker_source_declares_the_kinds_in_order():
    src = (_build.CSRC / "phase_mark.cu").read_text()
    cases = re.findall(r"case (\d+): return launch<stgcn_phase::(\w+)>", src)
    assert [(int(i), k) for i, k in cases] == list(enumerate(pm.KINDS))
    sig = re.search(r'extern "C" int phase_mark_launch\((.*?)\)', src).group(1)
    kinds = [ctypes.c_void_p if "*" in p else ctypes.c_int
             for p in sig.split(",")]
    assert kinds == _build.ENTRY_POINTS["phase_mark_launch"]


def test_marker_launch_path(monkeypatch):
    calls = []

    class FakeLib:
        def phase_mark_launch(self, kind, stream):
            calls.append((kind, stream))
            return 0 if kind != 7 else 1

        def block_eval_error_string(self, err):
            return b"invalid value"

    class FakeStream:
        cuda_stream = 4321

    monkeypatch.setattr(_build, "load_library", lambda: FakeLib())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev=None: FakeStream())
    monkeypatch.setattr(torch.cuda, "device",
                        lambda dev: contextlib.nullcontext())
    cuda = torch.device("cuda", 0)
    pm.phase_mark("tail", cuda)
    with profiled():
        profiling.mark("head", cuda)
    profiling.mark("input", cuda)            # not tracing: nothing
    assert calls == [(4, 4321), (5, 4321)]
    with pytest.raises(RuntimeError, match="optimizer"):
        pm.phase_mark("optimizer", cuda)


# ---- the benchmark's readers -----------------------------------------------

def _k(name, start, dur, stream=7):
    return (name, float(start), float(start + dur), stream, "kernel")


def _mark(kind, start):
    return _k(marker(kind), start, 1)


def synthetic_trace(mesh=False) -> tuple[tracing.Trace, dict]:
    """Two steps of marks and kernels, and what each phase holds a
    step."""
    ops, want, t = [], {}, 0.0
    ops.append(_k("void at::native::fill_kernel", t, 3))    # before any mark
    t += 10
    for _ in range(2):
        for kind, kernels in (
                ("input", [("copy_kernel", 4)]),
                ("bn_stats", [("reduce_kernel<MeanOps>", 20),
                              ("pow_kernel", 6)]),
                ("spatial", [("spatial_wg_fwd_kernel<64>", 30),
                             ("reduce_partials", 2)]),
                ("temporal", [("tap_gemm_kernel<128>", 25)]),
                ("tail", [("relu_kernel", 5), ("dropout_kernel", 7)]),
                ("head", [("mean_kernel", 3)]),
                ("grad_sync", [("ncclDevKernel_AllReduce_Sum_f32", 50),
                               ("cat_kernel", 2)] if mesh else []),
                ("optimizer", [("adam_kernel", 9)])):
            if kind == "grad_sync" and not mesh:
                continue
            ops.append(_mark(kind, t))
            t += 2
            for name, dur in kernels:
                ops.append(_k(name, t, dur,
                              stream=9 if "nccl" in name else 7))
                if "nccl" not in name:
                    want[kind] = want.get(kind, 0.0) + dur / 1e3 / 2
                t += dur + 1
    return tracing.Trace(ops, [("window", 0.0, t + 10)], [],
                         (0.0, t + 10)), want


def reader(name):
    cell = harness.load_cell("train-ntu-b256-dp4" if "grad_sync" in name
                             else "train-kth-b64", REPO)
    return harness.metric_reader(cell, name)


class TestReaders:
    @pytest.mark.parametrize("mesh", [False, True])
    @pytest.mark.parametrize("name", ["bn_stats", "tail", "optimizer"])
    def test_phase_ms_follows_the_partition(self, name, mesh):
        tr, want = synthetic_trace(mesh)
        got = reader(f"{name}_ms.train").read({"trace": tr, "steps": 2})
        assert got == pytest.approx(want[name])

    def test_grad_sync_runs_to_the_next_mark(self):
        tr, _ = synthetic_trace(mesh=True)
        got = reader("grad_sync_ms.train").read({"trace": tr, "steps": 2})
        # its mark, 2 us, the all-reduce 50 + 1, the cat 2 + 1
        assert got == pytest.approx(56 / 1e3)
        tr, _ = synthetic_trace(mesh=False)
        assert reader("grad_sync_ms.train").read(
            {"trace": tr, "steps": 2}) is None

    @pytest.mark.parametrize("name", TRAIN_READERS)
    def test_none_without_marks(self, name):
        tr, _ = synthetic_trace(mesh=True)
        bare = tracing.Trace([o for o in tr.ops if "phase_mark" not in o[0]],
                             tr.spans, [], tr.window)
        r = reader(name)
        assert r.read({"trace": bare, "steps": 2}) is None
        assert r.read({"trace": None, "steps": 2}) is None
        assert r.read({"trace": tr}) is None            # not a train cell

    def test_only_markers_are_claimed(self):
        tr, _ = synthetic_trace(mesh=True)
        ctx = {"trace": tr, "steps": 2}
        bench = json.loads((REPO / "BENCHMARK.json").read_text())
        claimers = [m["name"] for m in bench["per_layer"]
                    if hasattr(reader(m["name"]), "claims")]
        assert claimers == ["roofline.spatial.train",
                            "roofline.temporal.train",
                            "roofline.block_eval.serve", "nccl_ms.train",
                            "bn_stats_ms.train", "roofline.adaptive.train",
                            "roofline.temporal.agcn.train"]
        got = reader("bn_stats_ms.train").claims(ctx)
        assert got and all("stgcn_phase_mark<" in k[0] for k in got)
        assert len(got) == sum("stgcn_phase_mark<" in o[0] for o in tr.ops)
        for name in TRAIN_READERS[1:]:
            assert not hasattr(reader(name), "claims")

    def test_rest_keeps_every_phase_and_drops_the_marks(self):
        from stgcn_bench import run

        tr, want = synthetic_trace(mesh=False)
        cell = harness.load_cell("train-kth-b64", REPO)
        out = {"trace": tr, "ctx": {"steps": 2, "window_s": tr.window_s,
                                    "batch": 64, "frames": 304,
                                    "issue_ms": 1.0}}
        metrics, unclaimed = run.per_layer(cell, out, "NVIDIA H100 80GB HBM3")
        rest = metrics["rest_ms.train"]["value"]
        roofline = (30 + 2 + 25) / 1e3          # the spatial and taps kernels
        before_marks = 3 / 1e3 / 2
        assert rest == pytest.approx(sum(want.values()) - roofline
                                     + before_marks)
        assert not any("phase_mark" in n for n in unclaimed)
        assert metrics["bn_stats_ms.train"]["value"] == pytest.approx(
            want["bn_stats"])

    def test_collate_is_the_mean_a_request(self):
        r = harness.metric_reader(harness.load_cell("serve-kth-clips", REPO),
                                  "collate_ms.serve")
        spans = [("window", 0, 1000),
                 ("predict", 10, 110), ("serve.collate", 12, 20),
                 ("serve.forward", 20, 30), ("serve.collate", 40, 44),
                 ("predict", 200, 300), ("serve.collate", 210, 230)]
        tr = tracing.Trace([], sorted(spans, key=lambda s: s[1]), [],
                           (0, 1000))
        ctx = {"trace": tr, "requests": [None, None]}
        assert r.read(ctx) == pytest.approx((12 + 20) / 2 / 1e3)
        assert r.read({"trace": tr}) is None
        bare = tracing.Trace([], [s for s in tr.spans
                                  if s[0] != "serve.collate"], [], (0, 1000))
        assert r.read({"trace": bare, "requests": [None]}) is None


def test_benchmark_lists_the_new_metrics_where_they_read():
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    by_name = {m["name"]: m for m in bench["per_layer"]}
    train = ["train-kth-b64", "train-ntu-b64", "train-ntu-b256-dp4",
             "train-agcn-ntu-b64"]
    for name, wl in (("bn_stats_ms.train", train), ("tail_ms.train", train),
                     ("optimizer_ms.train", train),
                     ("grad_sync_ms.train", ["train-ntu-b256-dp4"]),
                     ("collate_ms.serve",
                      ["serve-kth-clips", "serve-kth-single"])):
        m = by_name[name]
        assert m["workloads"] == wl and m["source"] == "program_span"
        assert (METRICS / f"{name}.py").exists()
    names = [m["name"] for m in bench["per_layer"]]
    first = names.index("bn_stats_ms.train")
    assert names[first:first + 5] == [
        "bn_stats_ms.train", "tail_ms.train", "optimizer_ms.train",
        "grad_sync_ms.train", "collate_ms.serve"]
    # the adaptive graph's phase, its kernels' roofline, the AGCN step's
    # share of the peak and its temporal kernels' roofline: the AGCN cell
    # alone, appended after them
    assert names[first + 5:] == ["adaptive_ms.train",
                                 "roofline.adaptive.train", "mfu.agcn.train",
                                 "roofline.temporal.agcn.train"]
    for name in names[first + 5:]:
        assert by_name[name]["workloads"] == ["train-agcn-ntu-b64"]
        assert (METRICS / f"{name}.py").exists()
