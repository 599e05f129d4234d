"""`csrc/spatial_dp.cu`: the least time of the traced requests' seam
searches (each seam's live energy read once and the seam written once,
`benchlib/work.py`'s find-seam count, whatever implements it) over the
device time of the spatial route's search: the block DP in either form
(`block_dp_parts_kernel`, `block_dp_kernel`) and the segment walk
(`seg_walk_kernel`).  The same least work as `find_seam_roofline`, so the
two compare across routes.  Nothing to read where the spatial kernels
did not run."""

from benchlib.reading import roofline_pct

LAYER = "csrc/spatial_dp.cu"
UNIT = "%"
MOVES = "mpix_s"
SOURCE = "device_trace"
PATTERNS = (r"\bblock_dp_parts_kernel\b", r"\bblock_dp_kernel\b",
            r"\bseg_walk_kernel\b")
RECORDS = {"block_dp": 1, "block_dp_parts": 1, "seg_walk": 1}


def read(run):
    return roofline_pct(run, "find_seam", PATTERNS)
