"""Capture a carve's seam step as CUDA graphs, replay them, and credit the
counters the captured launches would have moved.

The counterpart of JAX tracing the whole N-seam carve into one jitted
program (`dct_carver_tpu/ops/carve.py`, `jax.jit` over `lax.fori_loop`):
here the seam step runs over static buffers, two sets that swap every
seam, so one graph a direction between the sets covers every seam, and
the host issues one replay a seam instead of a launch a kernel.  Both seam
loops use it: the single-image and batch routes (`ops/carve.py::
SeamSteps`) and the spatial route (`parallel/spatial.py::_SeamSteps`), on
one controller, one card or several (one graph then holds every card's
work and the copies between the cards), and, over NCCL, on each process
of a process mesh, whose exchanges the graph then holds as nodes.

A capture runs the step once on a side stream without executing it; the
kernel wrappers count their launches as they are captured.  Those counts
are taken back after the capture and added again at every replay, so the
launch counters (and the spatial route's exchange count) read as they
would after the same seams run eagerly.  A capture or replay that fails
raises: nothing carries on eagerly.
"""

from __future__ import annotations

import contextlib
import sys
import time

import torch

from .profiling import span

__all__ = ["StepGraphs", "CAPTURES"]

# every capture of this process: graphs captured and their host seconds,
# read around a carve as the kernels' launch counts are
CAPTURES = {"graphs": 0, "seconds": 0.0}

# the other cards' pools of steps that are gone, each with an event a card
# after its last replay: a MemPool frees its memory when it is deleted, and
# a step's object may go while its replays still run (a carve that does
# not wait for the cards), so the pools are kept until the events complete
_RETIRED: list = []

_HINT = ("Every op of the step, a plugged energy's bands_fn "
                "included, must run on the card without waiting for it, as "
                "JAX needs the step to trace under jit")


class StepGraphs:
    """The CUDA graphs of one seam step, one a source buffer set.

    `devices`: the cards the step runs on, one card or several of this
    process (None: a step that runs eagerly and is never captured); the
    first is the card the graphs are captured and replayed on.  `what`:
    the step's name in error messages.  `counters`: (object, attribute)
    pairs of integer counters that the step moves (each kernel's
    `launches`, a mesh's `exchanges`); a replay adds to each what its
    capture added.

    Over several cards one graph a source holds the work of all of them,
    the counterpart of JAX's one program over the devices of a mesh: the
    capture forks a side stream on every other card from the capturing
    one, makes it that card's current stream, so that the step's ops and
    copies there are captured too, routes the card's allocations into a
    pool of this object's (`torch.cuda.MemPool`: the graph holds their
    addresses, as the capture card's own graph pool does), and joins every
    side stream back before the capture ends.  A replay runs after the
    work already queued on every card's current stream, and every card's
    current stream runs after the replay."""

    def __init__(self, devices, what: str, counters):
        self.devices = [torch.device(d) for d in devices or ()]
        self.device = self.devices[0] if self.devices else None
        self.what = what
        self.counters = list(counters)
        # source set -> (graph, [(object, attribute, delta)])
        self.graphs: dict[int, tuple] = {}
        self.capture_seconds = 0.0
        # the other cards' pools (made at the first capture, kept while the
        # graphs live) and each card's event for the order around a replay
        self.pools: list = []
        self.events: list = []

    @property
    def captured(self) -> bool:
        return bool(self.graphs)

    def __del__(self):
        if not self.pools or sys.is_finalizing():
            return
        _release_retired()
        done = []
        for d in self.devices:
            ev = torch.cuda.Event()
            ev.record(torch.cuda.current_stream(d))
            done.append(ev)
        _RETIRED.append((done, self.pools, self.graphs))

    def capture(self, step, sources) -> None:
        """Capture `step(src)` once for each `src` of `sources`, in one
        memory pool a card, on side streams that start after the work
        queued on each card's current stream.  Nothing waits for a card.
        The counters are left as they were before the capture."""
        with span("carve.capture"):
            t = time.perf_counter()
            _release_retired()
            dev, others = self.device, self.devices[1:]
            pool = torch.cuda.graph_pool_handle()
            if len(self.pools) != len(others):
                self.pools = []
                for d in others:
                    with torch.cuda.device(d):
                        self.pools.append(torch.cuda.MemPool())
            graphs = {}  # kept only when every source captured
            for src in sources:
                before = [getattr(o, a) for o, a in self.counters]
                graph = torch.cuda.CUDAGraph()
                sides = [torch.cuda.Stream(d) for d in self.devices]
                for side, d in zip(sides, self.devices):
                    side.wait_stream(torch.cuda.current_stream(d))
                try:
                    with torch.cuda.device(dev), torch.cuda.stream(sides[0]):
                        graph.capture_begin(pool=pool)
                        try:
                            with self._on_others(sides):
                                step(src)
                        except BaseException:
                            with contextlib.suppress(RuntimeError):
                                graph.capture_end()
                            raise
                        graph.capture_end()
                except Exception as e:
                    raise RuntimeError(f"{self.what}: its CUDA graph capture "
                                       f"failed: {e}.  {_HINT}") from e
                finally:
                    deltas = []
                    for (o, a), n in zip(self.counters, before):
                        if getattr(o, a) != n:
                            deltas.append((o, a, getattr(o, a) - n))
                        setattr(o, a, n)
                for side, d in zip(sides, self.devices):
                    torch.cuda.current_stream(d).wait_stream(side)
                graphs[src] = (graph, deltas)
            self.graphs.update(graphs)
            CAPTURES["graphs"] += len(graphs)
            seconds = time.perf_counter() - t
            self.capture_seconds += seconds
            CAPTURES["seconds"] += seconds

    @contextlib.contextmanager
    def _on_others(self, sides):
        """Inside a capture on sides[0]: every other card's side stream
        forked from it, current on its card, with the card's allocations in
        its pool; joined back to sides[0] at the end."""
        if len(sides) == 1:
            yield
            return
        with contextlib.ExitStack() as stack:
            for side, d, pool in zip(sides[1:], self.devices[1:],
                                     self.pools):
                side.wait_stream(sides[0])
                stack.enter_context(torch.cuda.use_mem_pool(pool, d))
                stack.enter_context(torch.cuda.stream(side))
            stack.enter_context(torch.cuda.device(self.device))
            yield
            for side in sides[1:]:
                sides[0].wait_stream(side)

    def replay(self, src: int) -> None:
        """Replay the graph that reads set `src`, and credit its counts."""
        graph, deltas = self.graphs[src]
        if len(self.devices) > 1:
            self._order_before()
        try:
            graph.replay()
        except RuntimeError as e:
            raise RuntimeError(f"{self.what}: CUDA graph replay failed: "
                               f"{e}") from e
        if len(self.devices) > 1:
            self._order_after()
        for o, a, n in deltas:
            setattr(o, a, getattr(o, a) + n)

    def _order_before(self) -> None:
        """The replay, queued on the first card's current stream, after the
        work queued on every other card's."""
        if not self.events:
            self.events = [torch.cuda.Event() for _ in self.devices]
        main = torch.cuda.current_stream(self.device)
        for ev, d in zip(self.events[1:], self.devices[1:]):
            ev.record(torch.cuda.current_stream(d))
            main.wait_event(ev)

    def _order_after(self) -> None:
        """Every other card's current stream after the replay."""
        ev = self.events[0]
        ev.record(torch.cuda.current_stream(self.device))
        for d in self.devices[1:]:
            torch.cuda.current_stream(d).wait_event(ev)


def _release_retired() -> None:
    """Delete the retired pools whose replays have all run; waits for
    nothing."""
    _RETIRED[:] = [r for r in _RETIRED if not all(e.query() for e in r[0])]
