"""`csrc/find_seam_tiled.cu`, `csrc/find_seam.cu`: the least time of the
traced requests' seam searches (each seam's live energy read once and the
seam written once) over the device time of the find-seam kernels (the
tiled forward and finish, or find_seam.cu's one kernel)."""

from benchlib.reading import roofline_pct

LAYER = "csrc/find_seam_tiled.cu, find_seam.cu"
UNIT = "%"
MOVES = "mpix_s"
SOURCE = "device_trace"
PATTERNS = (r"\btile_rows_kernel\b", r"\bfinish_kernel\b",
            r"\bfind_seam_kernel\b")
# kernels a credited launch: the tiled find-seam credits three a call, its
# frontier's memset (no kernel), its forward and its finish
RECORDS = {"find_seam": 1, "find_seams": 1, "find_seam_tiled": 2 / 3}


def read(run):
    return roofline_pct(run, "find_seam", PATTERNS)
