"""On the card: each one-card cell as the benchmark runs it, with a short
window, is correct and reports its metrics.  Skips without a card."""

import json
import subprocess
import sys

import pytest

from stgcn_bench import harness
from stgcn_bench.tests.conftest import REPO


@pytest.mark.card
@pytest.mark.parametrize("workload,trace", [
    ("train-kth-b64", 0), ("serve-kth-clips", 1), ("train-ntu-b64", 0)])
def test_cell_on_the_card(card, workload, trace):
    out = subprocess.run(
        [sys.executable, "stgcn_bench/run.py", "--workload", workload,
         "--seed", "3000000007", "--seconds", "2", "--trace", str(trace)],
        capture_output=True, text=True, cwd=REPO, timeout=900)
    assert out.returncode == 0, out.stderr[-3000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] is True, result["checked"]
    cell = harness.load_cell(workload, REPO)
    want = {m["name"] for m in (cell.per_layer if trace
                                else cell.end_to_end)}
    assert set(result["metrics"]) <= want and result["metrics"]
