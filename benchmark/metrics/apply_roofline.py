"""`csrc/apply.cu`: the least time of the traced requests' seam removals
(only the elements right of each row's seam, read once and written once,
in the luma, original-column and energy planes) over the apply kernel's
device time."""

from benchlib.reading import roofline_pct

LAYER = "csrc/apply.cu"
UNIT = "%"
MOVES = "mpix_s"
SOURCE = "device_trace"
PATTERNS = (r"\bapply_kernel\b",)
RECORDS = {"apply": 1}


def read(run):
    return roofline_pct(run, "apply", PATTERNS)
