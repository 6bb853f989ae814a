"""Per request, the milliseconds of its ``predict`` span in which the
device runs nothing, the mean over the window's requests: the host's own
share of a request's latency (bucketing, padding, collation, copies,
waiting on results)."""

from stgcn_bench import trace as tracing


def read(ctx):
    tr = ctx.get("trace")
    if tr is None:
        return None
    spans = tr.spans_named("predict")
    if not spans:
        return None
    ops = [(s, e) for _, s, e, *_ in tr.ops]
    gaps, j = [], 0
    for _, lo, hi in spans:
        # no operation lasts a second: those starting earlier have ended
        while j < len(ops) and ops[j][0] < lo - 1e6:
            j += 1
        inside = []
        for s, e in ops[j:]:
            if s >= hi:
                break
            if e > lo:
                inside.append((max(s, lo), min(e, hi)))
        gaps.append((hi - lo) - tracing.union_length(sorted(inside)))
    return sum(gaps) / len(gaps) / 1e3
