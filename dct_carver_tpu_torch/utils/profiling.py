"""Profiling / tracing (SURVEY §5: the reference has none; we add
`torch.profiler` traces and named spans at the carve's layer boundaries).

Counterpart of `dct_carver_tpu/utils/profiling.py`: `trace` writes a Chrome
trace (open it in Perfetto or `chrome://tracing`) where the JAX package
writes a `jax.profiler` one.

`span(name)` marks one layer boundary of a carve (`carve.pass`,
`carve.copy_in`, `carve.seams`, ...; the table is in `PERF.md`).  It
records a `torch.profiler.record_function` range only while a profiler
session runs on the calling thread (`trace`, an operator's own
`torch.profiler.profile`, the benchmark's traced runs), so its range shares
the profiler's clock with the card's kernels and copies.  Otherwise it is
one flag check that returns a shared no-op context: no allocation, no
clock read, no lock.  No span sits inside code that a CUDA graph captures
or inside a per-seam loop.
"""

from __future__ import annotations

import contextlib
import os
import socket
import time

import torch

__all__ = ["trace", "span", "profile_carve"]

_OFF = contextlib.nullcontext()  # every span while no profiler runs
_profiler_enabled = torch._C._autograd._profiler_enabled


def span(name: str):
    """A context that records the range `name` while a `torch.profiler`
    session runs on this thread, else the shared no-op context."""
    if not _profiler_enabled():
        return _OFF
    from torch.profiler import record_function

    return record_function(name)


@contextlib.contextmanager
def trace(log_dir: str):
    """Trace the block with torch.profiler, over the CPU and, when a card is
    visible, the card, and write the Chrome trace
    `<host>.<pid>.<ms>.pt.trace.json` under `log_dir`.  Yields the
    profiler (`key_averages()` sums its events by name)."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(
        log_dir, f"{socket.gethostname()}.{os.getpid()}."
                 f"{time.time_ns() // 1_000_000}.pt.trace.json"))


def profile_carve(luma, n_seams: int, blocksize: int = 8, *, log_dir: str,
                  device=None):
    """Trace one full carve of a (H, W) luma plane (edges 0, textures 1)
    on `device` (default: the first CUDA card) for kernel-level
    inspection; returns its CarveState."""
    from ..models.carver import resolve_device
    from ..ops.carve import carve_n_seams

    dev = resolve_device(device)
    x = torch.as_tensor(luma, device=dev)
    with trace(log_dir):
        state = carve_n_seams(x, n_seams, blocksize, 0.0, 1.0)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
    return state
