"""The benchmark's frame: a cell's files by name, the program's objects
built from them, the guards and the result line.

Everything a cell needs is found by name from ``BENCHMARK.json``: its
configuration file (``configs``), its traffic mix
(``traffic/<traffic>.json``, whose ``kind`` names the driver,
``drivers/<kind>.py``), the limits of its correctness check
(``limits/<workload>.json``) and the readers of its per-layer metrics
(``metrics/<metric>.py``).  A new cell, configuration, mix or metric is a
new file and a new entry, never an edit.
"""

from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import os
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
# top-level modules that no run may hold: JAX and the JAX package
FORBIDDEN = ("jax", "jaxlib", "flax", "stgcn_tpu")


def process_start() -> float:
    """The wall-clock time this process started (``/proc``), or now where
    that cannot be read."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/stat") as f:
            boot = next(int(line.split()[1]) for line in f
                        if line.startswith("btime"))
        return boot + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, StopIteration, IndexError):
        return time.time()


@dataclasses.dataclass
class Cell:
    """One workload of ``BENCHMARK.json`` with everything its files say."""

    name: str
    root: Path                  # the checkout (holds BENCHMARK.json)
    chips: int
    config: dict                # configs/<config>.json
    traffic: dict               # traffic/<traffic>.json
    limits: dict                # limits/<workload>.json
    end_to_end: list            # BENCHMARK.json entries this cell reports
    per_layer: list

    @property
    def bench_dir(self) -> Path:
        return self.root / "stgcn_bench"


def _reports(entry: dict, workload: str, reported: set | None) -> bool:
    """Whether a metric entry belongs to the workload: listed, or without
    a list and moving (or being) a metric the workload reports."""
    if "workloads" in entry:
        return workload in entry["workloads"]
    return reported is None or entry.get("moves", entry["name"]) in reported


def load_cell(workload: str, root: Path | None = None) -> Cell:
    root = Path(root or HERE.parent)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    entry = next((w for w in bench["workloads"] if w["name"] == workload),
                 None)
    if entry is None:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json")
    cfg_entry = next(c for c in bench["configs"]
                     if c["name"] == entry["config"])
    config = json.loads((root / cfg_entry["file"]).read_text())
    traffic = json.loads((root / "stgcn_bench" / "traffic"
                          / f"{entry['traffic']}.json").read_text())
    limits = json.loads((root / "stgcn_bench" / "limits"
                         / f"{workload}.json").read_text())
    e2e = [m for m in bench["end_to_end"] if _reports(m, workload, None)]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if _reports(m, workload, names)]
    return Cell(workload, root, int(entry["chips"]), config, traffic,
                limits, e2e, per_layer)


def driver(cell: Cell):
    """The module of the cell's traffic kind, ``drivers/<kind>.py``."""
    return _load(cell.bench_dir / "drivers" / f"{cell.traffic['kind']}.py",
                 f"stgcn_bench.drivers.{cell.traffic['kind']}")


def metric_reader(cell: Cell, name: str):
    """The reader of a per-layer metric, ``metrics/<name>.py``."""
    return _load(cell.bench_dir / "metrics" / f"{name}.py",
                 "stgcn_bench.metrics." + name.replace(".", "_"))


def _load(path: Path, module_name: str):
    if module_name in sys.modules:
        return sys.modules[module_name]
    spec = importlib.util.spec_from_file_location(module_name, path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[module_name] = module
    spec.loader.exec_module(module)
    return module


# ---- the program's objects from a configuration --------------------------

def program_config(config: dict, **override):
    """The program's ``STGCNConfig`` of a configuration file."""
    import torch

    from stgcn_tpu_torch.graph.adjacency import Strategy
    from stgcn_tpu_torch.models.stgcn import STGCNConfig

    f = dict(config["stgcn_config"], **override)
    f["plan"] = tuple(tuple(p) for p in f["plan"])
    f["strategy"] = Strategy[f["strategy"].upper()]
    f["compute_dtype"] = getattr(torch, f["compute_dtype"])
    return STGCNConfig(**f)


def program_optimizer(config: dict):
    """The program's optimizer of a configuration file's ``optimizer``."""
    from stgcn_tpu_torch.training.optimizers import OptimizerSpec

    o = config["optimizer"]
    if o["name"] == "adam":
        return OptimizerSpec("adam", o["lr"], o["b1"], o["b2"], o["eps"])
    return OptimizerSpec("momentum", o["lr"], momentum=o["momentum"])


def set_tf32(config: dict) -> None:
    """The configuration's TF32 switches."""
    import torch

    torch.backends.cuda.matmul.allow_tf32 = bool(config["tf32"]["matmul"])
    torch.backends.cudnn.allow_tf32 = bool(config["tf32"]["cudnn"])


def reference_adjacency(config: dict, distances, device):
    """The normalized adjacency as the reference builds it."""
    import torch

    from stgcn_bench.reference import stgcn as ref

    g = config["stgcn_config"]
    a = ref.normalized_adjacency(config["graph"]["edges"],
                                 config["graph"]["num_joints"],
                                 g["strategy"], g["d"], distances)
    return torch.from_numpy(a).to(device)


def make_weights(config: dict, generator, *, trained: bool):
    from stgcn_bench import shapes, weights

    g = config["stgcn_config"]
    return weights.make_params(
        [tuple(p) for p in g["plan"]], c_in=g["c_in"],
        k=shapes.partitions(config),
        v=config["graph"]["num_joints"], gamma=g["gamma"],
        classes=g["num_classes"], generator=generator, trained=trained,
        head_gain=config.get("served_head_gain", 1.0) if trained else 1.0)


def dropout_key(seed: int, step: int, shard: tuple = ()) -> int:
    """A step's dropout seed as the configuration states it: the first
    word of numpy's ``SeedSequence([seed, step, *shard])``."""
    import numpy as np

    return int(np.random.SeedSequence([seed, step, *shard]
                                      ).generate_state(1)[0])


def keep_masks(config: dict, seed: int, step: int, batch: int, frames: int,
               device, shards: int = 1) -> list:
    """The units' dropout keep masks of one step, ``(N, C, T, V)`` booleans
    for the reference: for each shard of the batch, a generator on the
    device seeded with :func:`dropout_key` draws one float32 uniform an
    element of each unit's ``(V, N, T, C)`` output, in unit order, and keeps
    those below ``1 - rate``."""
    import torch

    g = config["stgcn_config"]
    rate = g["dropout_rate"]
    if rate <= 0:
        return None
    v = config["graph"]["num_joints"]
    per = batch // shards
    masks = [[] for _ in g["plan"]]
    for r in range(shards):
        gen = torch.Generator(device=device)
        gen.manual_seed(dropout_key(seed, step, (r,) if shards > 1 else ()))
        t = frames
        for i, (c, stride) in enumerate(g["plan"]):
            t = (t - 1) // stride + 1
            u = torch.rand((v, per, t, c), generator=gen, device=device)
            masks[i].append((u < 1.0 - rate).permute(1, 3, 2, 0))
            del u
    return [torch.cat(m) for m in masks]


# ---- guards and the result line -------------------------------------------

def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({name for name in sys.modules
                   if name.split(".")[0] in FORBIDDEN})


def guard_modules() -> None:
    found = forbidden_modules()
    if found:
        print("forbidden modules loaded: " + ", ".join(found),
              file=sys.stderr, flush=True)
        raise SystemExit(3)


def stage(env: dict, name: str) -> None:
    """Mark the end of a set-up stage: seconds since the process began."""
    env.setdefault("stages", []).append((name, time.time() - env["start"]))


def host_counters() -> dict:
    """The host's load as this process and the machine count it: the
    process's CPU seconds and context switches it did not ask for, the
    machine's CPU time by kind (``/proc/stat``, in clock ticks) and its
    CPU pressure (``/proc/pressure/cpu``, microseconds that some task
    waited for a core), where the system has them."""
    import resource

    ru = resource.getrusage(resource.RUSAGE_SELF)
    out = {"wall": time.perf_counter(), "cpu_s": ru.ru_utime + ru.ru_stime,
           "nivcsw": ru.ru_nivcsw}
    try:
        with open("/proc/stat") as f:
            ticks = [int(v) for v in f.readline().split()[1:]]
        out["ticks"] = sum(ticks[:8])
        out["idle_ticks"] = ticks[3] + ticks[4]
        out["steal_ticks"] = ticks[7] if len(ticks) > 7 else 0
    except (OSError, ValueError, IndexError):
        pass
    try:
        with open("/proc/pressure/cpu") as f:
            some = f.readline().split()
        out["pressure_us"] = int(dict(kv.split("=") for kv in some[1:])
                                 ["total"])
    except (OSError, ValueError, KeyError, IndexError):
        pass
    return out


def host_line(before: dict, after: dict) -> str:
    """What :func:`host_counters` moved by between two readings."""
    wall = after["wall"] - before["wall"]
    parts = [f"wall {wall:.3f} s",
             f"process CPU {after['cpu_s'] - before['cpu_s']:.3f} s",
             f"involuntary switches {after['nivcsw'] - before['nivcsw']}"]
    if "ticks" in before and "ticks" in after:
        total = max(after["ticks"] - before["ticks"], 1)
        busy = total - (after["idle_ticks"] - before["idle_ticks"])
        steal = after["steal_ticks"] - before["steal_ticks"]
        parts += [f"machine busy {100.0 * busy / total:.1f}%",
                  f"steal {100.0 * steal / total:.2f}%"]
    if "pressure_us" in before and "pressure_us" in after:
        waited = (after["pressure_us"] - before["pressure_us"]) / 1e6
        parts.append(f"CPU pressure {100.0 * waited / wall:.1f}% of the wall")
    return "host during the window: " + ", ".join(parts)


def card_line() -> str:
    """The card's name and power limit as ``nvidia-smi`` gives them."""
    import subprocess

    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "nvidia-smi unavailable"


def checked_block(numbers: list) -> tuple[bool, dict]:
    """``(all within limits, {name: {value, limit}})`` of ``(name, value,
    limit)`` triples; a value that is not finite is outside."""
    import math

    ok = all(math.isfinite(v) and v <= lim for _, v, lim in numbers)
    return ok, {n: {"value": v, "limit": lim} for n, v, lim in numbers}


def emit(result: dict, numbers: list) -> None:
    """Each compared number beside its limit as the last lines on standard
    error, then the result as the last line of standard output, its
    ``checked`` key last."""
    for name, value, limit in numbers:
        print(f"check {name} {value!r} limit {limit!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
