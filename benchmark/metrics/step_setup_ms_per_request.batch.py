"""The set-up of the seam loop of `ops/carve.py` as the program's own spans
mark it (`dct_carver_tpu_torch/utils/profiling.py::span`): new step buffers
on a cache miss (`carve.steps.build`), a step made for one carve alone
(`carve.steps.uncached`), the eager first seam of a graphed step
(`carve.seam.eager`) and the graph captures (`carve.capture`).  The host
time inside the union of those spans in the traced window, per request.
The batch route runs its chunks' set-ups one after the other on the host,
so this is the set-up the later cards wait behind.  A program without the
spans leaves nothing to read."""

from benchlib.trace import busy_union

LAYER = "ops/carve.py seam loop (SeamSteps, graph replays)"
UNIT = "ms"
MOVES = "carve_ms_min"
SOURCE = "program_span"
SPANS = ("carve.steps.build", "carve.steps.uncached", "carve.seam.eager",
         "carve.capture")


def read(run):
    w0, w1 = run.trace.window
    spans = [(max(h.start, w0), min(h.end, w1)) for h in run.trace.host
             if h.name in SPANS and h.end > w0 and h.start < w1]
    if not spans:
        return None
    return busy_union(spans) / 1e3 / run.requests
