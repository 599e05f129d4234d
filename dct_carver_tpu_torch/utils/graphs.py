"""Capture a carve's seam step as CUDA graphs, replay them, and credit the
counters the captured launches would have moved.

The counterpart of JAX tracing the whole N-seam carve into one jitted
program (`dct_carver_tpu/ops/carve.py`, `jax.jit` over `lax.fori_loop`):
here the seam step runs over static buffers, two sets that swap every
seam, so one graph a direction between the sets covers every seam, and
the host issues one replay a seam instead of a launch a kernel.  Both seam
loops use it: the single-image and batch routes (`ops/carve.py::
SeamSteps`) and the spatial route (`parallel/spatial.py::_SeamSteps`), on
one controller and, over NCCL, on each process of a process mesh, whose
exchanges the graph then holds as nodes.

A capture runs the step once on a side stream without executing it; the
kernel wrappers count their launches as they are captured.  Those counts
are taken back after the capture and added again at every replay, so the
launch counters (and the spatial route's exchange count) read as they
would after the same seams run eagerly.  A capture or replay that fails
raises: nothing carries on eagerly.
"""

from __future__ import annotations

import contextlib
import time

import torch

__all__ = ["StepGraphs", "CAPTURES"]

# every capture of this process: graphs captured and their host seconds,
# read around a carve as the kernels' launch counts are
CAPTURES = {"graphs": 0, "seconds": 0.0}

_HINT = ("Every op of the step, a plugged energy's bands_fn "
                "included, must run on the card without waiting for it, as "
                "JAX needs the step to trace under jit")


class StepGraphs:
    """The CUDA graphs of one seam step, one a source buffer set.

    `device`: the card the step runs on.  `what`: the step's name in error
    messages.  `counters`: (object, attribute) pairs of integer counters
    that the step moves (each kernel's `launches`, a mesh's `exchanges`);
    a replay adds to each what its capture added."""

    def __init__(self, device: torch.device, what: str, counters):
        self.device = device
        self.what = what
        self.counters = list(counters)
        # source set -> (graph, [(object, attribute, delta)])
        self.graphs: dict[int, tuple] = {}
        self.capture_seconds = 0.0

    @property
    def captured(self) -> bool:
        return bool(self.graphs)

    def capture(self, step, sources) -> None:
        """Capture `step(src)` once for each `src` of `sources`, in one
        memory pool, on a side stream.  The counters are left as they were
        before the capture."""
        t = time.perf_counter()
        dev = self.device
        torch.cuda.synchronize(dev)
        pool = torch.cuda.graph_pool_handle()
        graphs = {}  # kept only when every source captured
        for src in sources:
            before = [getattr(o, a) for o, a in self.counters]
            graph = torch.cuda.CUDAGraph()
            side = torch.cuda.Stream(dev)
            side.wait_stream(torch.cuda.current_stream(dev))
            try:
                with torch.cuda.device(dev), torch.cuda.stream(side):
                    graph.capture_begin(pool=pool)
                    try:
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
            torch.cuda.current_stream(dev).wait_stream(side)
            graphs[src] = (graph, deltas)
        self.graphs.update(graphs)
        CAPTURES["graphs"] += len(graphs)
        seconds = time.perf_counter() - t
        self.capture_seconds += seconds
        CAPTURES["seconds"] += seconds

    def replay(self, src: int) -> None:
        """Replay the graph that reads set `src`, and credit its counts."""
        graph, deltas = self.graphs[src]
        try:
            graph.replay()
        except RuntimeError as e:
            raise RuntimeError(f"{self.what}: CUDA graph replay failed: "
                               f"{e}") from e
        for o, a, n in deltas:
            setattr(o, a, getattr(o, a) + n)
