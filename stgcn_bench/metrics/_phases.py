"""What the phase readers share: the program's phase marks on the device
timeline, and the kernels of each phase.

While a profiler records, the program's train step marks where each of
its phases begins with an empty kernel, ``stgcn_phase_mark<stgcn_phase::
KIND>`` (captured into the step's graph, forward and backward; the kinds
are ``input``, ``bn_stats``, ``spatial``, ``temporal``, ``tail``,
``head``, ``grad_sync`` and ``optimizer``).  A kernel belongs to the phase
of the latest mark that started before it; NCCL's kernels (the patterns
of ``nccl_ms.train.d``) run on streams of their own and belong to none.
"""

from __future__ import annotations

import re

from stgcn_bench import trace as tracing
from stgcn_bench.metrics import _kernels

MARK = re.compile(r"\bstgcn_phase_mark<stgcn_phase::(\w+)>")


def kind(kernel) -> str | None:
    """The phase a marker kernel starts, or None for any other kernel."""
    m = MARK.search(kernel[0])
    return m.group(1) if m else None


def markers(ctx: dict) -> list:
    """The window's marker kernels, in start order."""
    return [k for k in _kernels.window_kernels(ctx) if kind(k)]


def phases(ctx: dict) -> dict:
    """``{kind: [kernels]}``: the window's kernels other than markers and
    NCCL's, each in the phase of the latest mark that started before it
    (those before the first mark in none); a kind with a mark and no
    kernel maps to an empty list."""
    if "phases" not in ctx:
        nccl, _ = tracing.patterns(_kernels.HERE / "nccl_ms.train.d")
        out: dict = {}
        current = None
        for k in _kernels.window_kernels(ctx):
            name = kind(k)
            if name is not None:
                current = out.setdefault(name, [])
            elif current is not None and not any(p.search(k[0])
                                                 for p in nccl):
                current.append(k)
        ctx["phases"] = out
    return ctx["phases"]


def phase_ms(ctx: dict, name: str):
    """Device ms a step in the kernels of phase ``name``, or None where
    the window holds no mark of it."""
    if "steps" not in ctx:
        return None
    found = phases(ctx).get(name)
    if found is None:
        return None
    return tracing.device_ms(found) / ctx["steps"]
