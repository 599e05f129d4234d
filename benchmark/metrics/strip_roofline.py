"""`csrc/strip.cu`: the least time of the traced requests' energy
updates (the DCT chains of only the windows each removal changed) over
the strip kernel's device time."""

from benchlib.reading import roofline_pct

LAYER = "csrc/strip.cu"
UNIT = "%"
MOVES = "mpix_s"
SOURCE = "device_trace"
PATTERNS = (r"\bstrip_kernel\b",)
RECORDS = {"strip": 1}


def read(run):
    return roofline_pct(run, "strip", PATTERNS)
