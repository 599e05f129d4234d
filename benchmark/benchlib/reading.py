"""What a per-layer metric's reader (`metrics/<name>.py::read`) is given:
the traced requests, reduced."""

from __future__ import annotations

import dataclasses

from . import trace as tr
from .work import least_seconds

__all__ = ["TracedRun", "roofline_pct"]


@dataclasses.dataclass
class TracedRun:
    trace: tr.Trace
    devices: list    # the cards the requests ran on
    launches: dict   # the launch counters' change over the traced requests
    requests: int    # requests traced
    seams: int       # seams carved by them: images x seams, every pass
    work: dict       # kind -> (bytes, ops) of their least work; a kind
    #                  the run could not count is missing
    log: list = dataclasses.field(default_factory=list)  # (start, end) s
    work_mpix: float = 0.0  # megapixel-seams of the traced requests


def roofline_pct(run: TracedRun, kind: str, patterns) -> float | None:
    """The least time of the traced requests' `kind` work over the device
    time of the kernels matching `patterns`, in %; None where either is
    missing."""
    if kind not in run.work:
        return None
    us, count = tr.kernel_us(run.trace, patterns)
    if not count or us <= 0:
        return None
    return 100.0 * least_seconds(*run.work[kind]) / (us / 1e6)
