"""Reduce a `torch.profiler` trace of the measured requests to device
intervals, busy and idle time, the breakdown, and the check that the
trace holds every launch the program credits.

Times are microseconds on the profiler's clock, which the host spans and
the device's operations share."""

from __future__ import annotations

import bisect
import dataclasses
import re
from collections import Counter

__all__ = ["DeviceOp", "HostSpan", "Trace", "collect", "busy_union",
           "busy_per_device", "idle_gaps", "breakdown", "count_check",
           "kernel_us", "REQUEST", "HARNESS_SPANS"]

# the spans run.py puts around its own calls; REQUEST holds one request
REQUEST = "bench.request"
HARNESS_SPANS = ("bench.pick", "bench.call", "bench.keep", REQUEST)
LABELLED_GAPS = 2000  # the longest gaps labelled by the host's work


@dataclasses.dataclass(frozen=True)
class DeviceOp:
    name: str
    start: float
    end: float
    device: int
    kind: str  # "kernel", "memcpy" or "memset"


@dataclasses.dataclass(frozen=True)
class HostSpan:
    name: str
    start: float
    end: float


@dataclasses.dataclass
class Trace:
    ops: list        # DeviceOp, sorted by start
    host: list       # HostSpan, sorted by start
    requests: list   # (start, end) of each REQUEST span, in order

    @property
    def window(self) -> tuple[float, float]:
        return self.requests[0][0], self.requests[-1][1]


def _kind(name: str) -> str:
    if name.startswith("Memcpy"):
        return "memcpy"
    if name.startswith("Memset"):
        return "memset"
    return "kernel"


def collect(prof) -> Trace:
    """The device operations and host spans of a finished profile."""
    from torch.autograd import DeviceType

    ops, host = [], []
    for e in prof.events():
        tr = e.time_range
        if e.device_type == DeviceType.CUDA:
            # a host range also gets a device span over what it launched,
            # which is no device work
            if e.name in HARNESS_SPANS or getattr(e, "is_user_annotation",
                                                  False):
                continue
            ops.append(DeviceOp(e.name, float(tr.start), float(tr.end),
                                int(e.device_index), _kind(e.name)))
        else:
            host.append(HostSpan(e.name, float(tr.start), float(tr.end)))
    ops.sort(key=lambda o: o.start)
    host.sort(key=lambda h: h.start)
    requests = [(h.start, h.end) for h in host if h.name == REQUEST]
    return Trace(ops, host, requests)


def busy_union(spans) -> float:
    """Microseconds covered by at least one of the (start, end) spans:
    operations that overlap (a graph's branches) count once."""
    total, end = 0.0, float("-inf")
    for a, b in sorted(spans):
        if b > end:
            total += b - max(a, end)
            end = b
    return total


def _clipped(trace: Trace, device: int):
    w0, w1 = trace.window
    return [(max(o.start, w0), min(o.end, w1)) for o in trace.ops
            if o.device == device and o.end > w0 and o.start < w1]


def busy_per_device(trace: Trace, devices: list) -> dict:
    """{device: busy microseconds inside the window}."""
    return {d: busy_union(_clipped(trace, d)) for d in devices}


def _gaps(spans, w0: float, w1: float) -> list:
    """(start, length) of each stretch of [w0, w1] that no span covers."""
    out, end = [], w0
    for a, b in sorted(spans):
        if a > end:
            out.append((end, a - end))
        end = max(end, b)
    if w1 > end:
        out.append((end, w1 - end))
    return out


def _label(trace: Trace, starts: list, t: float) -> str:
    """What the host was doing at t: the harness span and the innermost
    host event open then."""
    i = bisect.bisect_right(starts, t) - 1
    inner, outer = None, "between requests"
    for j in range(i, max(-1, i - 4000), -1):
        h = trace.host[j]
        if h.end > t:
            if inner is None and h.name not in HARNESS_SPANS:
                inner = h.name
            if h.name in HARNESS_SPANS and h.name != REQUEST:
                outer = h.name
                break
    return outer if inner is None else f"{outer} > {inner}"


def idle_gaps(trace: Trace, devices: list, top: int = 10) -> list:
    """[[label, seconds]]: the device's idle time inside the window, by
    what the host was doing when each gap began, averaged over the
    devices; the `top` labels with the most."""
    w0, w1 = trace.window
    starts = [h.start for h in trace.host]
    by = Counter()
    for d in devices:
        gaps = sorted(_gaps(_clipped(trace, d), w0, w1), key=lambda g: -g[1])
        for k, (t, us) in enumerate(gaps):
            label = (_label(trace, starts, t) if k < LABELLED_GAPS
                     else "shorter gaps")
            by[label] += us / 1e6 / len(devices)
    return [[label, s] for label, s in by.most_common(top)]


def _short(name: str) -> str:
    return name.split("(", 1)[0].strip()


def breakdown(trace: Trace, devices: list, top: int = 10) -> dict:
    """The device operations with the most time (seconds summed over the
    devices' operations) and the idle gaps by the host's work."""
    by = Counter()
    for o in trace.ops:
        by[_short(o.name)] += (o.end - o.start) / 1e6
    return {"device_ops": [[n, s] for n, s in by.most_common(top)],
            "idle_gaps": idle_gaps(trace, devices, top)}


def kernel_us(trace: Trace, patterns) -> tuple[float, int]:
    """(device microseconds, count) of the kernels whose names match any of
    the regular expressions `patterns`, inside the window."""
    res = [re.compile(p) for p in patterns]
    w0, w1 = trace.window
    us, n = 0.0, 0
    for o in trace.ops:
        if (o.kind == "kernel" and o.start >= w0 and o.end <= w1
                and any(r.search(o.name) for r in res)):
            us += o.end - o.start
            n += 1
    return us, n


def count_check(trace: Trace, launches: dict, metrics: dict) -> tuple:
    """(ok, seen, credited): whether the trace holds at least as many of
    the program's kernels as the launch counters credit.  Each metric
    module may name its kernels (`PATTERNS`) and the counters that count
    them (`RECORDS`: {counter: kernels a credited launch}; a memset that a
    counter credits is no kernel, and the trace holds none).  A trace that
    holds fewer has lost events: it is taken again, never read as a short
    time."""
    patterns, records = [], {}
    for mod in metrics.values():
        patterns += list(getattr(mod, "PATTERNS", ()))
        records.update(getattr(mod, "RECORDS", {}))
    credited = round(sum(launches.get(r, 0) * f for r, f in records.items()))
    seen = kernel_us(trace, patterns)[1] if patterns else 0
    return seen >= credited, seen, credited
