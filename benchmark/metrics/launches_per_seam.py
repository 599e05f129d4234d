"""The seam loop of `ops/carve.py` (`SeamSteps`, one CUDA graph replay a
seam): the kernel launches that the program's counters credit over the
traced requests (`dct_carver_tpu_torch.kernels.launch_counts()`, replays
credited with what their capture launched) per seam carved, every image's
seams counted.  A count: it repeats exactly."""

LAYER = "ops/carve.py seam loop (SeamSteps, graph replays)"
UNIT = "launches"
MOVES = "mpix_s"
SOURCE = "program_counter"


def read(run):
    total = sum(run.launches.values())
    if not run.seams or not total:
        return None
    return total / run.seams
