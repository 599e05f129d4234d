"""The device: the share of the traced window (the first traced request's
start to the last one's end) in which no kernel, memset or copy ran on a
card, the mean over the cards the requests ran on."""

from benchlib.trace import busy_per_device

LAYER = "device"
UNIT = "%"
MOVES = "mpix_s"
SOURCE = "device_trace"


def read(run):
    w0, w1 = run.trace.window
    busy = busy_per_device(run.trace, run.devices)
    if not busy or w1 <= w0:
        return None
    mean = sum(busy.values()) / len(busy)
    return 100.0 * (1.0 - mean / (w1 - w0))
