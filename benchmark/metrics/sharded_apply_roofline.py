"""`csrc/sharded_apply.cu`: the least time of the traced requests' seam
removals (only the elements right of each row's seam, read once and
written once, in the luma, original-column and energy planes: the count
of `metrics/apply_roofline.py`) over the device time of the spatial
route's fused removal (`sharded_apply_kernel`).  Nothing to read where it
did not run."""

from benchlib.reading import roofline_pct

LAYER = "csrc/sharded_apply.cu"
UNIT = "%"
MOVES = "mpix_s"
SOURCE = "device_trace"
PATTERNS = (r"\bsharded_apply_kernel\b",)
RECORDS = {"sharded_apply": 1}


def read(run):
    return roofline_pct(run, "apply", PATTERNS)
