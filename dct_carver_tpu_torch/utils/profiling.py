"""Profiling / tracing (SURVEY §5: the reference has none; we add
`torch.profiler` traces plus lightweight wall-clock stage timing).

Counterpart of `dct_carver_tpu/utils/profiling.py`: `trace` writes a Chrome
trace (open it in Perfetto or `chrome://tracing`) where the JAX package
writes a `jax.profiler` one.
"""

from __future__ import annotations

import contextlib
import os
import socket
import time

import torch

__all__ = ["trace", "device_timer", "profile_carve"]


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


@contextlib.contextmanager
def device_timer(name: str, results: dict | None = None):
    """Wall-clock a device computation: at exit, wait for the card when
    CUDA is initialised, then add the seconds to `results[name]`."""
    t0 = time.perf_counter()
    yield
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    if results is not None:
        results[name] = results.get(name, 0.0) + dt


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
