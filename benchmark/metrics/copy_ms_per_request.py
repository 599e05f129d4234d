"""The copies of `api.py` and `models/carver.py` (the image to the card,
the results back) and of `parallel/mesh.py` (the stack's chunks to their
cards and the join on the first): the device time of the host-device and
card-to-card memcpy events in the traced requests, per request, summed
over the cards."""

import re

LAYER = "api.py -> models/carver.py, and the stack copies of parallel/mesh.py"
UNIT = "ms"
MOVES = "mpix_s"
SOURCE = "device_trace"
COPIES = re.compile(r"^Memcpy (HtoD|DtoH|PtoP)")


def read(run):
    w0, w1 = run.trace.window
    us = sum(o.end - o.start for o in run.trace.ops
             if o.kind == "memcpy" and COPIES.match(o.name)
             and o.start >= w0 and o.end <= w1)
    if not us:
        return None
    return us / 1e3 / run.requests
