"""The end-to-end arithmetic over a closed loop's request log."""

from __future__ import annotations

import numpy as np

__all__ = ["window", "mpix_s", "percentile_ms"]


def window(log: list) -> tuple[float, float]:
    """(start, end) of the measured window: from the first request's start
    to the end of the last request in the log (each a (start, end) pair
    in seconds, the log holding every request that started inside the
    window's time)."""
    if not log:
        raise ValueError("no request completed in the window")
    return log[0][0], log[-1][1]


def mpix_s(log: list, work_mpix: list) -> float:
    """All the work over all the time: the megapixel-seams of every
    request (`work_mpix`, one number a request) over the window."""
    t0, t1 = window(log)
    return float(sum(work_mpix)) / (t1 - t0)


def percentile_ms(log: list, q: float) -> float:
    """The q-th percentile (linear between order statistics) of every
    request's wall time, in ms."""
    return float(np.percentile([1e3 * (b - a) for a, b in log], q))

