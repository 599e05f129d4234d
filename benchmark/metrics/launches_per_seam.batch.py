"""`launches_per_seam`, read as `metrics/launches_per_seam.py` reads it, in
the cells where it moves `carve_ms_min` and not `mpix_s`: the four-card
batch, whose `mpix_s` swings too widely between processes to hold to a
bound."""

from benchlib.spec import load_module

_BASE = load_module("metrics", "launches_per_seam")
LAYER = _BASE.LAYER
UNIT = _BASE.UNIT
MOVES = "carve_ms_min"
SOURCE = _BASE.SOURCE
read = _BASE.read
