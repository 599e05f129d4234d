"""`csrc/energy.cu`: the least time of the traced requests' full energy
maps (their DCT chains at the unfused float32 peak, or the luma read and
energy written at the memory's peak) over the energy kernel's device
time."""

from benchlib.reading import roofline_pct

LAYER = "csrc/energy.cu"
UNIT = "%"
MOVES = "mpix_s"
SOURCE = "device_trace"
PATTERNS = (r"\benergy_kernel\b",)
RECORDS = {"energy": 1}


def read(run):
    return roofline_pct(run, "energy", PATTERNS)
