"""Small cells for the CPU tests: a cell of ``BENCHMARK.json`` cut to a
few narrow units, a few clips and frames, run through its driver on the
CPU (the chip look of ``run.py`` skipped)."""

from __future__ import annotations

import time

import torch

from stgcn_bench import harness

PLAN = [[8, 1], [16, 2], [16, 1]]


def small_cell(workload: str, root=None, f32: bool = False):
    cell = harness.load_cell(workload, root)
    g = cell.config["stgcn_config"]
    g["plan"] = PLAN
    if f32:
        g["compute_dtype"] = "float32"
    tr = cell.traffic
    if tr["kind"].startswith("train"):
        tr.update(batch=4 * tr.get("data", 1), frames=16, ring=4)
    else:
        tr.update(clips=[4, 12], frames=[10, 40], buckets=[20, 40],
                  max_batch=8, pool=64, cycle=8, max_requests=64)
    return cell


def run(cell, seed: int = 2 ** 31 + 11, seconds: float = 0.3,
        trace: bool = False, **env):
    torch.set_num_threads(2)
    env = {"device": torch.device("cpu"), "start": time.time(), **env}
    return harness.driver(cell).run(cell, seed, seconds, trace, env)


def correct(out) -> bool:
    ok, _ = harness.checked_block(out["numbers"])
    return ok and out["failed"] == 0
