"""`apply_roofline`, read as `metrics/apply_roofline.py` reads it, in the
cells where it moves `carve_ms_min` and not `mpix_s`: the four-card batch,
whose `mpix_s` swings too widely between processes to hold to a bound."""

from benchlib.spec import load_module

_BASE = load_module("metrics", "apply_roofline")
LAYER = _BASE.LAYER
UNIT = _BASE.UNIT
MOVES = "carve_ms_min"
SOURCE = _BASE.SOURCE
PATTERNS = _BASE.PATTERNS
RECORDS = _BASE.RECORDS
read = _BASE.read
