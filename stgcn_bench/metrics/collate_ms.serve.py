"""Per request, the host milliseconds in the program's ``serve.collate``
spans (wrap-padding, stacking and batch padding a chunk, then its host
cast, pinning and copy) inside the benchmark's ``predict`` span, the mean
over the window's requests."""


def read(ctx):
    tr = ctx.get("trace")
    if tr is None or "requests" not in ctx:
        return None
    requests = tr.spans_named("predict")
    collate = [(s, e) for _, s, e in tr.spans_named("serve.collate")]
    if not requests or not collate:
        return None
    total, j = 0.0, 0
    for _, lo, hi in requests:
        while j < len(collate) and collate[j][0] < lo:
            j += 1
        k = j
        while k < len(collate) and collate[k][0] < hi:
            s, e = collate[k]
            total += min(e, hi) - s
            k += 1
    return total / len(requests) / 1e3
