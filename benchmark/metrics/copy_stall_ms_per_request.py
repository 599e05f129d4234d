"""The copies of `api.py`, `models/carver.py` and `parallel/mesh.py` as
the program's own spans mark them (`carve.copy_in`, `carve.copy_out.image`,
`carve.copy_out.vmap`, `batch.join`; `dct_carver_tpu_torch/utils/
profiling.py::span`): per request, the time inside the traced window in
which a card runs no kernel, memset or copy while the host is inside one of
those spans, the mean over the cards.  Spans that overlap count once.  A
program without the spans leaves nothing to read."""

from benchlib.trace import _clipped, busy_union

LAYER = "api.py -> models/carver.py, and the stack copies of parallel/mesh.py"
UNIT = "ms"
MOVES = "mpix_s"
SOURCE = "program_span"
SPANS = ("carve.copy_in", "carve.copy_out.image", "carve.copy_out.vmap",
         "batch.join")


def read(run):
    w0, w1 = run.trace.window
    copies = [(max(h.start, w0), min(h.end, w1)) for h in run.trace.host
              if h.name in SPANS and h.end > w0 and h.start < w1]
    if not copies or not run.devices:
        return None
    stall = 0.0
    for d in run.devices:
        busy = _clipped(run.trace, d)
        # idle inside the copies: what the copies add to the busy union
        stall += busy_union(busy + copies) - busy_union(busy)
    return stall / len(run.devices) / 1e3 / run.requests
