"""The set-up of a carve's seam loop, read as `metrics/
step_setup_ms_per_request.batch.py` reads it (the host time inside the
union of the `carve.steps.build`, `carve.steps.uncached`,
`carve.seam.eager` and `carve.capture` spans in the traced window, per
request), in the cells where it moves `mpix_s`: the spatial route, which
builds its step, runs its first seam eagerly and captures its two graphs
at every carve.  A program without the spans leaves nothing to read."""

from benchlib.spec import load_module

_TWIN = load_module("metrics", "step_setup_ms_per_request.batch")
LAYER = _TWIN.LAYER
UNIT = _TWIN.UNIT
MOVES = "mpix_s"
SOURCE = _TWIN.SOURCE
SPANS = _TWIN.SPANS
read = _TWIN.read
