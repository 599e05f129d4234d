"""Progress + metrics — the liblqr progress-hook bridge re-imagined
(`src/render.c:100-120`: lqr_progress_new → gimp_progress_*), plus the
structured per-stage metrics the reference lacks (SURVEY §5).

A copy of `dct_carver_tpu/utils/progress.py`, which holds no JAX.
"""

from __future__ import annotations

import json
import sys
import time
from dataclasses import dataclass, field

__all__ = ["Progress", "StderrProgress", "Metrics"]


class Progress:
    """liblqr progress protocol: init(message) / update(fraction) / end()."""

    def init(self, message: str) -> None:  # pragma: no cover - interface
        pass

    def update(self, fraction: float) -> None:  # pragma: no cover
        pass

    def end(self) -> None:  # pragma: no cover
        pass


class StderrProgress(Progress):
    def __init__(self, stream=None):
        self._stream = stream or sys.stderr
        self._msg = ""

    def init(self, message: str) -> None:
        self._msg = message
        print(f"{message}", file=self._stream, flush=True)

    def update(self, fraction: float) -> None:
        print(f"\r{self._msg} {fraction * 100:5.1f}%", end="",
              file=self._stream, flush=True)

    def end(self) -> None:
        print(file=self._stream, flush=True)


@dataclass
class Metrics:
    """Structured per-run metrics (Mpix/s, seams/s, per-stage wall time)."""

    pixels: int = 0
    seams: int = 0
    stages: dict = field(default_factory=dict)
    _t0: dict = field(default_factory=dict)

    def start(self, stage: str) -> None:
        self._t0[stage] = time.perf_counter()

    def stop(self, stage: str) -> None:
        dt = time.perf_counter() - self._t0.pop(stage)
        self.stages[stage] = self.stages.get(stage, 0.0) + dt

    def summary(self) -> dict:
        total = sum(self.stages.values())
        out = {
            "total_s": round(total, 4),
            "stages_s": {k: round(v, 4) for k, v in self.stages.items()},
        }
        if total > 0:
            if self.pixels:
                out["mpix_per_s"] = round(
                    self.pixels * max(self.seams, 1) / total / 1e6, 2
                )
            if self.seams:
                out["seams_per_s"] = round(self.seams / total, 2)
        return out

    def emit(self, stream=None) -> None:
        print(json.dumps(self.summary()), file=stream or sys.stderr)
