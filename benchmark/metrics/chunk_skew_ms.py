"""The batch placement of `parallel/mesh.py` over several cards: per
request, the time from the first card's first kernel to the last card's
first kernel on the profiler's device timeline, the mean over the traced
requests.  Nothing to read on one card."""

LAYER = "parallel/mesh.py (batch placement over cards)"
UNIT = "ms"
MOVES = "carve_ms_min"
SOURCE = "device_trace"


def read(run):
    skews = []
    for a, b in run.trace.requests:
        first = {}
        for o in run.trace.ops:
            if o.kind == "kernel" and a <= o.start < b:
                first.setdefault(o.device, o.start)
        if len(first) > 1:
            skews.append(max(first.values()) - min(first.values()))
    if not skews:
        return None
    return sum(skews) / len(skews) / 1e3
