"""The port's measurement tools on the CPU at small sizes, held against the
JAX package's tools where the two share a definition.

* ``bench_torch.py`` at B=2, T=16: one JSON line whose keys are
  ``bench.py``'s, in its order, read from its source with ``ast`` (its
  functions import JAX; it is not imported here), and whose metric is
  ``bench.py``'s name at those sizes (the name itself at B=64, T=304).
* ``scripts/torch_serving_bench.py``: its latency rows at batch 1 and 2,
  its interleaved and device-resident rows, with the JAX tool's fields.
* ``scripts/torch_scaling_bench.py --cpu-mesh`` on 1 and 2 gloo ranks: the
  JAX tool's fields; ``edges_per_s`` and ``train_tflops_per_s`` equal to
  ``stgcn_tpu.utils.profiling.ModelFlops``'s at the same plan, batch,
  frames and step time.
* ``--collectives`` on a data=2 gloo mesh at the toy plan: the gradient
  all-reduce moves 4 bytes a parameter, and the BatchNorm all-reduces have
  the count and bytes of the closed form in
  :func:`test_collectives_on_a_data_mesh`.
* ``scripts/torch_strategy_table.py`` and ``_diag.py``: ``CONFIGS`` and
  ``GRID`` equal the JAX tools' lists (``ast``: the JAX scripts import only
  the standard library, but are not imported); one real one-epoch CLI row
  on the fused path at 16 frames (on a 5-subject relational dataset; the
  table's own dataset at 128 frames runs in ``chip_smoke.py``'s
  bench_tools phase), its parsed fields against its own log read apart.
"""

import ast
import json
import math
import re
import sys
from pathlib import Path

import numpy as np
import pytest

from stgcn_tpu.graph.adjacency import Strategy as JaxStrategy
from stgcn_tpu.models.stgcn import STGCN as JaxSTGCN
from stgcn_tpu.models.stgcn import STGCNConfig as JaxConfig
from stgcn_tpu.utils.profiling import ModelFlops as JaxModelFlops
from stgcn_tpu_torch.data import generate_dataset
from stgcn_tpu_torch.graph.adjacency import Strategy
from stgcn_tpu_torch.models.stgcn import STGCN, STGCNConfig
from stgcn_tpu_torch.tree import tree_leaves

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "scripts"))

import bench_torch  # noqa: E402
import torch_scaling_bench  # noqa: E402
import torch_serving_bench  # noqa: E402
import torch_strategy_diag  # noqa: E402
import torch_strategy_table  # noqa: E402

SMALL = ["--device", "cpu", "--frames", "16"]


def functions(path: Path) -> dict:
    tree = ast.parse(path.read_text())
    return {f.name: f for f in tree.body if isinstance(f, ast.FunctionDef)}


def assigned_dicts(fn: ast.FunctionDef, name: str) -> list[list[str]]:
    """The keys of each dict literal assigned to ``name`` in ``fn``."""
    return [[k.value for k in node.value.keys]
            for node in ast.walk(fn) if isinstance(node, ast.Assign)
            and isinstance(node.value, ast.Dict)
            and any(isinstance(t, ast.Name) and t.id == name
                    for t in node.targets)]


def subscript_keys(fn: ast.FunctionDef, name: str) -> list[str]:
    """The keys ``fn`` stores into ``name[...]``, in order; a key held in
    a variable is the first branch of the conditional that sets it (in
    ``bench.py``, the fused forward's key on the TPU)."""
    names = {}
    for node in ast.walk(fn):
        if (isinstance(node, ast.Assign) and isinstance(node.value, ast.IfExp)
                and isinstance(node.value.body, ast.Constant)
                and isinstance(node.targets[0], ast.Name)):
            names[node.targets[0].id] = node.value.body.value
    keys = []
    for node in ast.walk(fn):
        if not isinstance(node, ast.Assign):
            continue
        t = node.targets[0]
        if (isinstance(t, ast.Subscript) and isinstance(t.value, ast.Name)
                and t.value.id == name):
            keys.append(t.slice.value if isinstance(t.slice, ast.Constant)
                        else names[t.slice.id])
    return keys


def bench_py_line() -> tuple[list[str], ast.JoinedStr]:
    """``bench.py``'s JSON keys in the order it writes them, and its
    metric's f-string."""
    fns = functions(ROOT / "bench.py")
    keys = assigned_dicts(fns["main"], "out")[0]
    keys += subscript_keys(fns["main"], "out")
    keys += subscript_keys(fns["bench_serving"], "out")
    metric = next(node.value.values[0] for node in ast.walk(fns["main"])
                  if isinstance(node, ast.Assign)
                  and isinstance(node.value, ast.Dict)
                  for k in node.value.keys if k.value == "metric")
    return keys, metric


def format_joined(node: ast.JoinedStr, **values) -> str:
    return "".join(v.value if isinstance(v, ast.Constant)
                   else values[v.value.id] for v in node.values)


def test_bench_torch_prints_bench_py_line(capsys):
    keys, metric = bench_py_line()
    assert keys[:4] == ["metric", "value", "unit", "vs_baseline"]
    for precision in ("bf16", "f32"):
        assert bench_torch.metric_name(64, 304, precision) == \
            format_joined(metric, precision=precision)
    assert bench_torch.main(["--device", "cpu", "--batch", "2", "--frames",
                             "16", "--steps", "1"]) == 0
    out, err = capsys.readouterr()
    lines = out.strip().splitlines()
    assert len(lines) == 1
    line = json.loads(lines[0])
    assert list(line) == keys
    assert line["metric"] == "train_throughput_stgcn10_b2_t16_bf16"
    assert line["unit"] == "sequences/s"
    for k in keys[1:]:
        if k != "unit":
            assert math.isfinite(line[k]) and line[k] > 0, (k, line[k])
    stderr = err.strip().splitlines()[-1]
    for field in ("eager_step_ms=", "frames_per_s=", "card=None",
                  "captured=False", "tf32_cudnn="):
        assert field in stderr, stderr
    ms = {k: float(v) for k, v in re.findall(r" (\w+_ms)=([\d.e+-]+)",
                                             stderr)}
    # the rates from the step times: B=2 over the fused and the op-path
    # step, B=4 over the B=128 row's
    assert line["value"] == pytest.approx(2e3 / ms["step_ms"])
    base = 2e3 / ms["ops_step_ms"]
    assert line["vs_baseline"] == pytest.approx(line["value"] / base)
    assert line["b128_vs_baseline"] == pytest.approx(
        4e3 / ms["b128_step_ms"] / base)


def test_serving_bench_rows(tmp_path, capsys, monkeypatch):
    fns = functions(ROOT / "scripts" / "serving_bench.py")
    result_keys, device_keys = assigned_dicts(fns["main"], "row")
    interleaved_keys = assigned_dicts(fns["main"], "interleaved")[0]
    for name, value in (("CALLS", 3), ("ROUNDS", 2), ("N_BATCHES", 2),
                        ("DEVICE_REPS", 2)):
        monkeypatch.setattr(torch_serving_bench, name, value)
    out = tmp_path / "serving.json"
    assert torch_serving_bench.main(
        SMALL + ["--batches", "1,2", "--stream-batch", "2",
                 "--out", str(out)]) == 0
    doc = json.loads(out.read_text())
    assert [r["batch"] for r in doc["results"]] == [1, 2]
    for row in doc["results"]:
        assert list(row) == result_keys
        assert 0 < row["p50_ms"] <= row["p95_ms"]
    assert list(doc["interleaved"]) == interleaved_keys
    assert len(doc["interleaved"]["serial_rounds"]) == 2
    assert [r["forward"] for r in doc["device_resident"]] == \
        ["op_path", "fused"]
    for row in doc["device_resident"]:
        assert list(row) == device_keys
    assert doc["card"] is None and doc["device"] == "cpu"
    printed = [json.loads(v) for v in capsys.readouterr().out.splitlines()
               if v.startswith("{")]
    assert printed == (doc["results"] + [doc["interleaved"]]
                       + doc["device_resident"])


def jax_toy_flops(batch: int, t: int) -> JaxModelFlops:
    model = JaxSTGCN(JaxConfig(plan=torch_scaling_bench.TOY_PLAN,
                               strategy=JaxStrategy.DISTANCE, d=1,
                               dropout_rate=0.1, residual=True))
    return JaxModelFlops.of(model, batch, t)


def test_scaling_cpu_mesh(capsys):
    assert torch_scaling_bench.main(
        ["--cpu-mesh", "--ranks", "1,2", "--steps", "1", "--frames", "16",
         "--batch", "8"]) == 0
    rows = [json.loads(v) for v in capsys.readouterr().out.splitlines()]
    jax_fields = {"mode", "devices", "batch", "t", "step_ms", "edges_per_s",
                  "step_time_vs_1dev"}
    assert [r["devices"] for r in rows] == [1, 2]
    mf = jax_toy_flops(8, 16)
    for row in rows:
        assert jax_fields <= set(row), row
        assert row["mode"] == "cpu_mesh" and row["backend"] == "gloo"
        assert (row["batch"], row["t"]) == (8, 16)
        step_s = row["step_ms"] / 1e3
        assert row["edges_per_step"] == mf.edges_processed
        assert row["edges_per_s"] == pytest.approx(mf.edges_per_s(step_s),
                                                   rel=1e-12)
        assert row["train_tflops_per_s"] == pytest.approx(
            mf.tflops_per_s(step_s), rel=1e-12)
    assert rows[0]["step_time_vs_1dev"] == 1.0
    assert rows[1]["step_time_vs_1dev"] == pytest.approx(
        rows[1]["step_ms"] / rows[0]["step_ms"])


def test_collectives_on_a_data_mesh(capsys):
    assert torch_scaling_bench.main(
        ["--collectives", "--mesh", "2,1,1", "--device", "cpu"]) == 0
    (row,) = [json.loads(v) for v in capsys.readouterr().out.splitlines()]
    jax_fields = {"mode", "plan_blocks", "mesh", "shard_joints", "batch",
                  "t", "ops", "total_bytes_per_device_per_step"}
    assert jax_fields <= set(row)
    assert row["mode"] == "collective_bytes" and row["mesh"] == [2, 1, 1]
    plan = torch_scaling_bench.TOY_PLAN
    model = STGCN(STGCNConfig(plan=plan, strategy=Strategy.DISTANCE, d=1,
                              residual=True))
    n_params = sum(p.numel() for p in tree_leaves(model.init_params(0)[0]))
    assert row["param_count"] == n_params
    by_what = row["by_what"]
    assert set(by_what) == {"all-reduce/gradients", "all-reduce/batchnorm",
                            "all-reduce/metrics"}
    # the gradients: one flat float32 buffer over data (parallel/train.py
    # make_sharded_grads, all_reduce_)
    assert by_what["all-reduce/gradients"] == {
        "count": 1, "bytes_per_device_per_step": 4 * n_params}
    # the BatchNorms: each block's bn1 and bn2 (ops/block.py) all-reduce
    # their float32 (mean, mean of squares) of C channels over data once
    # in the forward (ops/batchnorm.batch_moments) and once in the backward
    # (the adjoint, collectives._AllReduceSum), but for the first block's
    # bn1, whose input is the batch: nothing flows back through it.
    # count = 2 * (2 * blocks) - 1; bytes = 2 * sum(2 * 4 * C) - 2 * 4 * C_in
    widths, c_prev = [], 2
    for c_out, _ in plan:
        widths += [c_prev, c_out]   # bn1 over the block's input, bn2
        c_prev = c_out
    assert by_what["all-reduce/batchnorm"] == {
        "count": 2 * 2 * len(plan) - 1,
        "bytes_per_device_per_step": 2 * sum(8 * c for c in widths) - 8 * 2}
    # the loss and the accuracy
    assert by_what["all-reduce/metrics"] == {
        "count": 1, "bytes_per_device_per_step": 8}
    assert row["ops"] == {"all-reduce": {
        "count": 2 * 2 * len(plan) + 1,
        "bytes_per_device_per_step": row["total_bytes_per_device_per_step"]}}
    assert row["total_bytes_by_rank"] == [
        row["total_bytes_per_device_per_step"]] * 2


def jax_list(path: Path, name: str):
    tree = ast.parse(path.read_text())
    node = next(n for n in tree.body if isinstance(n, ast.Assign)
                and n.targets[0].id == name)
    return ast.literal_eval(node.value)


def test_configs_and_grid_are_the_jax_tools():
    assert torch_strategy_table.CONFIGS == [
        tuple(c) for c in jax_list(ROOT / "scripts" / "strategy_table.py",
                                   "CONFIGS")]
    assert torch_strategy_diag.GRID == [
        tuple(g) for g in jax_list(ROOT / "scripts" / "strategy_diag.py",
                                   "GRID")]
    jax_base = functions(ROOT / "scripts" / "strategy_table.py")["run_one"]
    cmd = next(n.value for n in ast.walk(jax_base)
               if isinstance(n, ast.Assign) and n.targets[0].id == "cmd")
    flags = [e.value for e in cmd.left.elts if isinstance(e, ast.Constant)]
    ours = torch_strategy_table.base_args("cuda", 40)
    assert [f for f in ours if f.startswith("--")] == \
        [f for f in flags if f.startswith("--")]


def test_one_cli_row_on_the_fused_path(tmp_path, monkeypatch):
    # the relational task at 5 subjects (a fifth of the CLI's synthetic
    # dataset, whose training takes ~20 s here), 16 frames; two torch
    # threads, as the tier-1 suite runs six workers at once
    monkeypatch.setenv("OMP_NUM_THREADS", "2")
    data = tmp_path / "data"
    meta = generate_dataset(str(data), num_subjects=5, t_range=(16, 40),
                            style="relational")
    row = torch_strategy_table.run_one(
        "distance", dict(torch_strategy_table.CONFIGS)["distance"], "cpu",
        1, "fused", overrides=("--data.metadata_file", meta,
                               "--data.dataset_dir", str(data),
                               "--data.fixed_len", "16",
                               "--data.batch_size", "64"),
        log_dir=str(tmp_path / "logs"))
    assert row["rc"] == 0, row.get("tail")
    assert row["block_impl"] == "fused" and row["losses_finite"]
    log = (tmp_path / "logs" / "distance_fused.log").read_text()
    # the same fields read apart: the [test] line and the last [epoch] dict
    test = next(v for v in log.splitlines() if v.startswith("[test] loss"))
    fields = dict(f.split("=") for f in test.split()[1:])
    assert row["test_acc"] == float(fields["acc"])
    assert row["test_loss"] == float(fields["loss"])
    assert row["test_n"] == int(fields["n"]) > 0
    epoch = ast.literal_eval(next(
        v for v in reversed(log.splitlines()) if v.startswith("[epoch]")
    ).removeprefix("[epoch] "))
    assert row["final_train_acc"] == epoch["train_acc"]
    assert row["final_val_acc"] == epoch["val_acc"]
    assert row["train_losses"] == [epoch["train_loss"]]
    assert '"block_impl": "fused"' in log
    # a diverged loss is read as such
    assert not torch_strategy_table.parse(
        "[epoch] {'train_loss': nan, 'train_acc': 0.2}")["losses_finite"]
    assert np.isclose(torch_strategy_table.parse(log)["test_acc"],
                      row["test_acc"])
