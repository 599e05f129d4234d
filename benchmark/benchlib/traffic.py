"""The one general generator that every traffic file (`traffic/<name>.json`)
feeds: the request geometry, the pool of inputs, the closed loop, and the
sample of requests that the comparison checks.

A traffic file's keys:

* `entry`: the entry point its requests call (`entries/<entry>.py`);
* `remove`: what each request removes: `width` / `height` as counts, or
  `width_share` / `height_share` as shares of the configuration's size;
* `batch`: images a request (default 1);
* `pool`: distinct inputs the requests cycle, so no two in a row match;
* `sample`: requests whose outputs are checked, drawn from the seed;
* `sample_images`: images of each sampled request checked, a card
  (default: every image of the request);
* `trace_requests`: requests of a traced run.

One client sends the next request when the last one has returned (a
closed loop); a request is a host array in and a host array out."""

from __future__ import annotations

import dataclasses
import random
import time

import numpy as np

from .images import photos

__all__ = ["Pass", "removal", "passes", "work_mpix", "make_pool",
           "sample_images", "Reservoir", "closed_loop"]


@dataclasses.dataclass(frozen=True)
class Pass:
    """One carve pass: `seams` vertical seams out of a (B, H, W) plane
    stack (the height pass in the transposed frame)."""
    B: int
    H: int
    W: int
    seams: int


def removal(config: dict, traffic: dict) -> tuple[int, int]:
    """(columns, rows) that each request removes."""
    rm = traffic["remove"]
    out = []
    for axis, size in (("width", config["width"]),
                       ("height", config["height"])):
        n = rm.get(axis, round(rm.get(f"{axis}_share", 0.0) * size))
        if not 0 <= n < size:
            raise ValueError(f"cannot remove {n} of {size} ({axis})")
        out.append(int(n))
    return out[0], out[1]


def passes(config: dict, traffic: dict) -> list:
    """The width pass, then the height pass, of each request (liblqr's
    order); a pass that removes nothing is left out."""
    B = int(traffic.get("batch", 1))
    H, W = config["height"], config["width"]
    nw, nh = removal(config, traffic)
    out = []
    if nw:
        out.append(Pass(B, H, W, nw))
    if nh:
        out.append(Pass(B, W - nw, H, nh))
    return out


def work_mpix(config: dict, traffic: dict) -> float:
    """A request's work: each pass's B * H * W * seams, in megapixels, H
    and W of the plane the pass starts from."""
    return sum(p.B * p.H * p.W * p.seams for p in passes(config, traffic)) / 1e6


def make_pool(seed: int, config: dict, traffic: dict, device) -> list:
    """`pool` distinct requests' inputs, each a (batch, H, W, C) u8 host
    array."""
    B = int(traffic.get("batch", 1))
    P = int(traffic["pool"])
    imgs = photos(seed, P * B, config["height"], config["width"],
                  config["channels"], device=device)
    return [imgs[i * B:(i + 1) * B] for i in range(P)]


def sample_images(seed: int, B: int, cards: int, per_card: int | None):
    """The images of a request that the comparison checks: `per_card` from
    each card's chunk (the chunks as the batch route cuts a stack), drawn
    from the seed; every image when `per_card` is None."""
    if per_card is None:
        return list(range(B))
    rng = random.Random(int(seed) * 2 + 1)
    picks = []
    for chunk in np.array_split(np.arange(B), cards):
        if len(chunk):
            picks += rng.sample(sorted(chunk.tolist()),
                                min(per_card, len(chunk)))
    return sorted(picks)


class Reservoir:
    """A uniform sample of `size` of the requests offered, drawn from the
    seed whatever their number (reservoir sampling)."""

    def __init__(self, size: int, seed: int):
        self.size = size
        self.rng = random.Random(int(seed))
        self.seen = 0

    def slot(self) -> int | None:
        """The slot the next request takes, or None to leave it out."""
        k = self.seen
        self.seen += 1
        if k < self.size:
            return k
        j = self.rng.randrange(k + 1)
        return j if j < self.size else None


def closed_loop(call, pool: list, stop, keep, span) -> tuple[list, int, str]:
    """Send requests one after the other until `stop(k, now)` says so before
    request k.  Request k carries pool[k % len(pool)]; `keep(k, out)` sees
    each result.  `span(name)`: a context manager around each request's
    parts (the profiler's ranges in a traced run).  Returns (log of
    (start, end) seconds, failed requests, the failure's text)."""
    log, k = [], 0
    while True:
        t0 = time.perf_counter()
        if stop(k, t0):
            return log, 0, ""
        try:
            with span("bench.request"):
                with span("bench.pick"):
                    images = pool[k % len(pool)]
                with span("bench.call"):
                    out = call(images)
                with span("bench.keep"):
                    keep(k, out)
        except Exception:  # a failed request ends the run, reported
            import traceback

            return log, 1, traceback.format_exc()
        log.append((t0, time.perf_counter()))
        k += 1
