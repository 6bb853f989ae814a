"""A configuration, a traffic mix and a per-layer metric each come in as
new files and new entries of ``BENCHMARK.json``, with no edit to a file
the benchmark has: a copy of the benchmark gains one of each, and its new
cell runs (on the CPU) and reports the new metric."""

import json
import os
import shutil
import subprocess
import sys

from stgcn_bench.tests.conftest import REPO


def test_new_config_traffic_and_metric_are_files(tmp_path):
    shutil.copy(REPO / "BENCHMARK.json", tmp_path)
    bench_dir = tmp_path / "stgcn_bench"
    shutil.copytree(REPO / "stgcn_bench", bench_dir,
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = {p: p.read_bytes() for p in bench_dir.rglob("*")
              if p.is_file()}

    config = json.loads((bench_dir / "configs" / "stgcn10-kth.json")
                        .read_text())
    config["name"] = "stgcn2-tiny"
    config["stgcn_config"]["plan"] = [[8, 1], [16, 2]]
    (bench_dir / "configs" / "stgcn2-tiny.json").write_text(
        json.dumps(config))
    (bench_dir / "traffic" / "train-b4-t16.json").write_text(json.dumps(
        {"kind": "train_steps", "batch": 4, "frames": 16, "ring": 4,
         "check_steps": 3, "inflight": 2}))
    (bench_dir / "limits" / "train-tiny.json").write_text(json.dumps(
        {"loss_gap": 1.0, "grad_gap": 10.0, "change_gap": 10.0}))
    (bench_dir / "metrics" / "steps_seen.train.py").write_text(
        "def read(ctx):\n    return float(ctx['steps'])\n")

    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    bench["configs"].append({
        "name": "stgcn2-tiny", "source": "https://arxiv.org/abs/1801.07455",
        "file": "stgcn_bench/configs/stgcn2-tiny.json",
        "reduced": ["stgcn_config"], "why": "a test's configuration"})
    bench["workloads"].append({
        "name": "train-tiny", "config": "stgcn2-tiny",
        "traffic": "train-b4-t16", "chips": 1, "why": "a test's cell"})
    bench["end_to_end"][1]["workloads"].append("train-tiny")
    bench["per_layer"].append({
        "name": "steps_seen.train", "unit": "steps", "better": "higher",
        "source": "program_counter", "layer": "captured step",
        "moves": "train_seq_per_s", "workloads": ["train-tiny"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run(
        [sys.executable, str(bench_dir / "tests" / "cpu_run.py"),
         "train-tiny", "--trace"], capture_output=True, text=True,
        cwd=tmp_path, env=env, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    result = json.loads(out.stdout.strip().splitlines()[-2])
    assert result["metrics"]["steps_seen.train"]["value"] == \
        result["attempted"] > 0
    assert result["correct"] is True
    for p, data in before.items():
        if "__pycache__" not in p.parts:
            assert p.read_bytes() == data, p
