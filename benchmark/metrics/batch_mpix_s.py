"""`mpix_s` where it swings too widely between processes to hold to a
bound end to end (the four-card batch, whose pageable host copies set its
pace): the megapixel-seams of the traced requests, counted as `mpix_s`
counts them, over the time from the first one's start to the last one's
end.  The requests run under the profiler here."""

from benchlib.stats import mpix_s

LAYER = "api.py -> models/carver.py, and the stack copies of parallel/mesh.py"
UNIT = "Mpix/s"
MOVES = "carve_ms_min"
SOURCE = "host_clock"


def read(run):
    if not run.log or run.work_mpix <= 0:
        return None
    return mpix_s(run.log, [run.work_mpix / len(run.log)] * len(run.log))
