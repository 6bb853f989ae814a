"""The traced run's record: ``torch.profiler`` over the measured window,
read back from its Chrome trace into device operations and host spans.

The benchmark marks its own spans with ``record_function``: ``window``
around the measured window, ``step`` around each train step's call and
``predict`` around each request.  Times are microseconds on the
profiler's clock, which the host spans and the device operations share.
"""

from __future__ import annotations

import bisect
import contextlib
import dataclasses
import json
import os
import re
import tempfile
from pathlib import Path

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


@dataclasses.dataclass
class Trace:
    """Device operations ``(name, start, end, stream, cat)`` in start
    order, host spans ``(name, start, end)`` of the benchmark, host
    operations ``(name, start, end)``, and the window's ``(start, end)``."""

    ops: list
    spans: list
    host_ops: list
    window: tuple

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e6

    def kernels(self) -> list:
        return [o for o in self.ops if o[4] == "kernel"]

    def busy_s(self, ops=None) -> float:
        """Seconds of the window in which some operation ran."""
        lo, hi = self.window
        ivs = sorted((max(s, lo), min(e, hi)) for _, s, e, *_ in
                     (self.ops if ops is None else ops) if e > lo and s < hi)
        return union_length(ivs) / 1e6

    def spans_named(self, name: str) -> list:
        return [s for s in self.spans if s[0] == name]


def union_length(ivs) -> float:
    """Length of the union of sorted ``(start, end)`` intervals."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in ivs:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


@contextlib.contextmanager
def profiled(enabled: bool):
    """Yields a holder whose ``trace`` is the :class:`Trace` of the block
    once it has ended (None when ``enabled`` is false)."""
    holder = type("Holder", (), {"trace": None})()
    if not enabled:
        yield holder
        return
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        yield holder
    fd, path = tempfile.mkstemp(suffix=".json", prefix="stgcn_bench_trace_")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        holder.trace = parse(Path(path))
    finally:
        os.unlink(path)


def parse(path: Path) -> Trace:
    events = json.loads(path.read_text()).get("traceEvents", [])
    ops, spans, host = [], [], []
    for ev in events:
        if ev.get("ph") != "X":
            continue
        cat, ts, dur = ev.get("cat", ""), float(ev["ts"]), \
            float(ev.get("dur", 0.0))
        if cat in DEVICE_CATS:
            ops.append((ev["name"], ts, ts + dur, ev.get("tid"), cat))
        elif cat == "user_annotation":
            spans.append((ev["name"], ts, ts + dur))
        elif cat in ("cpu_op", "cuda_runtime", "cuda_driver"):
            host.append((ev["name"], ts, ts + dur))
    ops.sort(key=lambda o: o[1])
    spans.sort(key=lambda s: s[1])
    host.sort(key=lambda s: s[1])
    window = next(((s, e) for n, s, e in spans if n == "window"), None)
    if window is None:
        window = (ops[0][1], ops[-1][2]) if ops else (0.0, 0.0)
    return Trace(ops, spans, host, window)


# ---- kernels by name -------------------------------------------------------

def patterns(directory: Path) -> tuple[list, list]:
    """``(match, after)`` regular expressions of every ``*.txt`` in a
    metric's ``.d`` directory: a line ``match <re>`` claims the kernels
    whose names it finds; ``after <re>`` those it finds that run right
    after a claimed kernel on the same stream (the reductions a kernel
    launches behind itself, whose names do not say whose they are)."""
    match, after = [], []
    for f in sorted(Path(directory).glob("*.txt")):
        for line in f.read_text().splitlines():
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            kind, _, rx = line.partition(" ")
            (match if kind == "match" else after).append(re.compile(
                rx.strip()))
    return match, after


def claimed(kernels: list, match: list, after: list) -> list:
    """The kernels that the patterns claim, in start order."""
    last_on: dict = {}
    out = []
    for k in kernels:
        name, stream = k[0], k[3]
        hit = any(p.search(name) for p in match) or (
            last_on.get(stream, False) and any(p.search(name) for p in after))
        last_on[stream] = hit
        if hit:
            out.append(k)
    return out


def device_ms(ops: list) -> float:
    return sum(e - s for _, s, e, *_ in ops) / 1e3


# ---- what the next reader of the ledger sees -------------------------------

def breakdown(trace: Trace, top: int = 10) -> dict:
    """The device operations that took most time, and the window's idle
    gaps by the host operation running as each began (the benchmark's span
    where none is), each list of ``[name, seconds]``."""
    by_name: dict = {}
    lo, hi = trace.window
    for name, s, e, *_ in trace.ops:
        if e > lo and s < hi:
            by_name[name] = by_name.get(name, 0.0) + (e - s) / 1e6
    index = [(seq, [s for _, s, _ in seq])
             for seq in (trace.host_ops, trace.spans)]
    gaps: dict = {}
    cur_end = lo
    for _, s, e, *_ in trace.ops:
        if s >= hi:
            break
        if s > cur_end:
            what = _host_at(index, cur_end)
            gaps[what] = gaps.get(what, 0.0) + (s - cur_end) / 1e6
        cur_end = max(cur_end, e)
    if cur_end < hi:
        what = _host_at(index, cur_end)
        gaps[what] = gaps.get(what, 0.0) + (hi - cur_end) / 1e6

    def best(d):
        return [[short(n), v] for n, v in
                sorted(d.items(), key=lambda kv: -kv[1])[:top]]

    return {"device_ops": best(by_name), "idle_gaps": best(gaps)}


def _host_at(index: list, t: float) -> str:
    """The innermost host operation running at ``t`` (the latest to start
    of those not yet ended), else the benchmark's span, else ``host``;
    ``index`` holds ``(events, their start times)`` of each kind."""
    for seq, starts in index:
        i = bisect.bisect_right(starts, t)
        for name, s, e in reversed(seq[max(0, i - 256):i]):
            if e >= t and name != "window":
                return name
    return "host"


def short(name: str, limit: int = 96) -> str:
    return name if len(name) <= limit else name[:limit - 3] + "..."
