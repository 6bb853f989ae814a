"""What the kernel readers share: the window's kernels, and those that a
metric's pattern files (``<metric>.d/*.txt``) claim."""

from __future__ import annotations

from pathlib import Path

from stgcn_bench import trace as tracing

HERE = Path(__file__).resolve().parent


def window_kernels(ctx: dict) -> list:
    tr = ctx.get("trace")
    if tr is None:
        return []
    lo, hi = tr.window
    return [k for k in tr.kernels() if k[1] >= lo and k[2] <= hi]


def claimed(ctx: dict, metric: str) -> list:
    match, after = tracing.patterns(HERE / f"{metric}.d")
    return tracing.claimed(window_kernels(ctx), match, after)


def roofline(ctx: dict, metric: str, bound_ms: float):
    """``100 * bound / measured`` over the claimed kernels, or None where
    the window ran none of them."""
    ms = tracing.device_ms(claimed(ctx, metric))
    return 100.0 * bound_ms / ms if ms > 0 else None


def idle_share(ctx: dict):
    tr = ctx.get("trace")
    if tr is None or tr.window_s <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s() / tr.window_s)
