#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (`dct_carver_tpu_torch`) once on one NVIDIA card.

    python3 chip_smoke.py

Phase 0 builds the CUDA kernels from `dct_carver_tpu_torch/csrc/`, one
nvcc a source, all at once.  Phase 1 holds each kernel against its plain
PyTorch version on the card, bit for bit, at the main path's shapes
(1080x1920, and 2160x3840 at n=16), and times both; phase 1b runs whole
4-seam carves at 4320x7680 and 4096x4096 (the shapes of the TPU's streamed
and folded DP routes) against the plain path; phase 1c holds the tiled
find-seam (column tiles, K rows a block) against the plain find-seam at
rows wider than one thread block (32769 and 40000 columns) and at its own
geometry (1080p, 4K, 8K repeated, windows and seams at tile edges, H = 1,
2 and 999, per-image windows, several tiles a warp), holds and times its
finish (blocks of FINISH_ROWS rows; 1080p, 4K, 3456x2160, 16 and 32
images, its `blocked_finishes` count), holds its split forward (helper
warps beside each tile's DP warp) at the benchmark's planes, short and
odd-width planes, 512x40000 and stacks of 8-32 images, with its
`split_forwards` count, times the forward's ns a DP row in both schedules
in turns (alone and in graphed seam steps), sweeps the tiled kernel's
geometry and schedules, the split schedule against one warp a tile over
stacks and long rows, and both find-seam kernels over widths and batch
sizes (the tables the tiled constants, `split_forward`'s threshold and
`seam_route`'s thresholds come from),
carves a 512x40000 RGB image through `api.carve` with the
launch counters read around it against the plain path, and holds the
apply at 65536 rows.  Every find-seam launch count is checked against the
kernel `seam_route` picks for the shape, and find_seam.cu is held and
timed through its C entry whatever the route says.  Phase 2 runs the main path
through the public API: a 64-seam removal from a 1080x1920 RGB image, twice
(the first carve of the shape runs its first seam eagerly and captures the
seam step's CUDA graphs, the second replays them every seam), with the
launch counters and the graph replays read around each, compared element
for element with the plain path on the card, the graphed carve's luma,
vmap and energy with the eager kernel carve's and the plain path's, and
the carve on the card with the CPU on a small image; then a bidirectional
4K resize at n=16.  Phase 2d, run last, drives the interactive
retargeter and the browser UI on phase 2's image: a 384-seam `InteractiveRetargeter`, first
and warm, with the launch counters and the graph replays read around it,
its vmap and slides against phase 2's carves and against `api.carve` on
the card (removal and insertion), its vmap unchanged by later carves of
its step key, a vertical and a grad_norm retargeter (their strip gather
and scatter counted) against `api.carve`, the server on 127.0.0.1 in a
thread with every endpoint against the in-process result, a
`debug_mode(disable_jit=True)` carve (no replay, the kernels launching)
against the graphed one, a NaN check raising on the card, and
`profile_carve`'s trace; it times the precompute, `at_width` and the
`/resize.png` round trip.  Phase 3 runs the batch route (BASELINE
config 4's images): the batched kernels against their plain versions on 8
1024x1024 planes, a 128-seam `api.carve(parallel="batch")` of 8 RGB images
with the launch counters read around it, compared with the plain path and
with the single-image route, and a timed, profiled `carve_batch` of 256
such images (graph replays counted, the graphed carve against the eager
kernel carve and, for 4 seams on 8 of its images, the plain path), then
the energy and strip kernels timed at that shape.  Phase 4 runs the plugged energies: 4a holds the strip gather,
strip scatter and band-energy kernels against their plain versions (1080p
and B=8 1024x1024; the band energy at every blocksize on bands gathered
with delta_x = 1, 2 and 4 from the 1080p plane and stacks of 8 and 256
1024x1024 images, and on full-row bands) and gather -> band energy ->
scatter against strip.cu, and times the band energy at every blocksize on
those planes beside its bound and the launch floor;
4b carves 64 seams from the 1080p RGB image with each builtin gradient
energy and a radius-2 custom one, with the launch counters and graph
replays read around it, against the plain path (grad_norm's graphed carve
also against the eager kernel carve), and times the strip gather and
scatter inside the graphed carve; 4c carves 8 1024x1024 images with
grad_norm on the batch route against the single-image route; 4d drives the CLI in-process
(carve with checkpoints and progress, a resume from the 32-seam checkpoint,
energy, batch).  Phase 5 runs the spatial route (BASELINE config 5) with
four column shards on the one card: 5a holds the block DP over its
column tiles (the parts form at the 8K shard shape, short last blocks,
widths ending inside a tile and inside a halo, a frontier that makes cells
reach the ends of their cones, the one-CTA fallback past 96 rows; the
message form at the small-shard carve's shapes)
and its `tiled_blocks` count, times both forms alone and inside a graph
replay, the tiled schedule against one CTA a shard, the segment walk (at
both carves' segment shapes, windows clamped at either end, unaligned
rows, K = 200; timed also with the L2 flushed),
the sharded apply (also at 65536 rows, and timed with the L2 flushed
between calls) and the strip kernels with a shard offset against their
plain versions; 5b carves 64 seams from a 4320x7680 luma through
`spatial_carve_n_seams` (the seam step as CUDA graph replays) with the
launch counters, `tiled_blocks` and the replays read around it, against
the single-device carve and, for 4 seams, the plain spatial path, a
chunked carve against the unchunked one, launches and exchanges a seam under replay, the two routes
timed in turns, the capture time and a profile, and drives a small-shard
carve through `api.carve` (the message form); 5c runs `api.carve` and the
CLI on the spatial route against the single-image route, enlargement, a
resumed sharded checkpoint and `energy="grad_norm"`, each counting its
graph replays.  Phase 6 runs the spatial route over several processes
(`parallel/multihost.py`): this script, started again as
`--multiproc-worker`, once a process (NCCL, one card each, over two to four
cards; two processes sharing one card over gloo), carves the 8K luma on 4
global shards with the launch counters and graph replays read around each
process's carve (over NCCL every seam after the first a replay of the
process's own graphs, its exchanges inside; over gloo eager), again under
`debug_mode` (eager), each process's columns held against the
single-device carve, counts exchanges a seam, times the two carves in
turns, checkpoints each process's shards and resumes them, on the
processes and on one controller, probes the job, times one shift and one
psum alone, and runs `dryrun_multichip(4)`.  Phase 7 runs several cards
of one controller, each part that the visible cards allow (one line says
which was skipped): 7a carves the 8K luma through `spatial_carve_n_seams`
over 4 cards x 1 shard and 2 cards x 2 shards, every seam after the first
a replay of one graph over the cards, against the single-device carve
(graphed, under `debug_mode`, in checkpointed chunks and resumed), counts
launches, replays and exchanges a seam, drives `api.carve(parallel=
"spatial")` both ways against the single-image route, and times the
graphed and eager carves in turns, each replay on every card between CUDA
events, and a profile; 7b carves config 4's whole batch (1024 1-Mpix
images) by the default placement over every visible card, against each
card's chunk carved on one card alone, lists any host wait inside it with
torch's sync debug mode, times it in turns beside one card's share carved
alone, and reads each card's busy share and the join between CUDA events.
`python3 chip_smoke.py --multi-card` runs phase 7 alone;
`--tiled-forward` builds the kernels and runs phase 1c's split-forward
checks, its timing in turns and its sweeps alone; `--first-carve ROOT`
times one process's first and second carves with the package found under
ROOT, so that two commits compare in turns on one card.

Every kernel's line gives its time, its plain version's, the least time
the card could take for the same work (`bound_ms`, the benchmark's own
`benchmark/benchlib/work.py::least_seconds`: the bytes at the memory's
peak or the float32 operations at the unfused peak, whichever is longer)
and, where one PyTorch call computes the same function, that call's time
(`library_ms`).
`ms` and `library_ms` time back-to-back calls between CUDA events, so for
the shortest kernels they time the host's launches; `device_ms` and
`library_device_ms` are the same calls' device time per call under
torch.profiler.

The last stdout line is {"ok": true, "device": {...}}; before it come the
kernels' JSON line and the card's name and power limit.  Any failed phase
exits non-zero and prints no result.  Imports nothing of JAX.
"""

import contextlib
import functools
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
# the benchmark's library (benchmark/benchlib): the card's peaks, the least
# work of a kernel's function and the busy time of a trace, as the
# benchmark's metrics read them
sys.path.append(str(ROOT / "benchmark"))
SEED = 20261016
H, W = 1080, 1920          # the headline shape (BASELINE config 1)
H4, W4 = 2160, 3840        # BASELINE config 3
SEAMS = 64
WHOLE_SEAMS = 4            # phase 1b: whole carves at the shapes that the
# TPU sends down its streamed and folded DP routes
WHOLE_SHAPES = ((4320, 7680, "streamed"), (4096, 4096, "folded"))
NB, HB, WB = 8, 1024, 1024  # phase 3: BASELINE config 4's image size
SEAMS_B = 128              # config 4's seam count
# the timed batch, cut from config 4's 1024 images to bound the smoke's time
NB_TIMED = 256
PLAIN_SEAMS_B = 4          # phase 3c: seams of the plain comparison
TIES = ("leftmost", "rightmost")
ENERGIES = ("grad_xabs", "grad_sumabs", "grad_norm")  # phase 4: the builtins
PLAIN_SEAMS_E = 16         # phase 4b: seams of the plain comparison carves
# of the energies other than grad_norm (the plain DP is ~0.17 s a seam)
SEAMS_BE = 32              # phase 4c/4d: seams of the plugged-energy batch
H8, W8 = 4320, 7680        # phase 5: BASELINE config 5's 8K panorama
W_BIDIR = 3456             # phase 1c: the 4K resize's height pass, a
# 3456 x 2160 plane
SHARDS = 4                 # column shards, all on the one card
K8 = 96                    # the route's rows per exchange (FRONTIER_BLOCK)
SEAMS_8K = 64
PLAIN_SEAMS_8K = 4         # the plain spatial path is ~0.3 s a seam at 8K
SEAMS_5C = 16              # phase 5c: 1080p carves on the spatial route
TIMED_PAIRS_8K = 3         # phase 5b: spatial and single-device 8K carves
CAPTURE_SAMPLES = 30      # phase 2: first carves timed for their capture
RT_SEAMS = 384             # phase 2d: the retargeter's range, 20 % of W
RT_SIDE = 64               # phase 2d: the vertical and grad_norm ranges
RT_REPS = 20               # phase 2d: timed slides a width
UI_REPS = 5                # phase 2d: timed /resize.png round trips (a
# random-noise PNG takes Pillow ~0.35 s to encode)
MP_SEAMS = 16              # phase 6: the multi-process 8K carve's seams,
MP_CHUNK = 6               # its checkpointed chunks (resumed at seam 12),
MP_TIMED = 16              # and the seams of its marginal timing (16 vs 32)
MP_SHARDS = 4              # global shards of the multi-process mesh
MP_SECONDS = 300           # a worker's limit
MP_FLOOR_REPS = 200        # exchanges of one tiny slice, timed alone
MC_SEAMS = 16              # phase 7a: the multi-card 8K carves' seams, the
MC_CHUNK = 6               # checkpointed chunks (resumed at seam 12), and
MC_TURNS = 2               # the timed turns (marginal of 16 and 32 seams)
# phase 7a's layouts on one controller: (name, cards, shards a card)
MC_LAYOUTS = (("4 x 1", 4, 1), ("2 x 2", 2, 2))
NB_CARDS = 1024            # phase 7b: config 4's whole batch over the cards
BATCH_TURNS = 2            # its timed turns beside one card's share
CHUNKED_SEAMS_8K = 16      # phase 5b: the chunked 8K carve and the counts
# under replay
# phase 1c: rows wider than one thread block (MAX_WIDTH) and planes taller
# than the grid's y dimension
TILED_ROWS = 300           # rows of the tiled find-seam's bitwise cases
REPEATS_8K = 20            # the tiled find-seam's 8K case, each tie: its
# frontier between warps is where a race would show
W_WIDE = 40000             # a panorama wider than one block covers
H_WIDE = 512               # rows of the wide api.carve
H_TALL = 65536             # rows past the grid's 65535
# the width sweep of the two find-seam kernels: B = 1 at these widths with
# SWEEP_ROWS rows (H8 at W8), and stacks of (B, W) with HB rows
SWEEP_WIDTHS = (64, 128, 256, 512, 1024, 1920, 3840, 4096, 4097, 5760, 7680,
                16384, 32768, 40000)
SWEEP_ROWS = 1080
SWEEP_BATCHES = ((8, WB), (16, WB), (32, WB), (64, WB), (128, WB), (256, WB),
                 (32, W), (64, W), (32, 4096), (64, 4096))
# the tiled kernel's geometry sweep: (columns a lane, owned columns, K),
# each extended row one warp wide, times the forward's schedules (warp-tiles
# a CTA, split): one warp a tile, 1 or 4 tiles a CTA, and the split
# schedule, at these shapes (the benchmark's three single-image planes
# first)
GEOMETRIES = ((4, 64, 32), (4, 96, 16), (8, 128, 64), (8, 192, 32))
GEOMETRY_SCHEDULES = ((1, False), (4, False), (1, True))
GEOMETRY_SHAPES = ((1, H, W), (1, H4, W4), (1, W_BIDIR, H4), (1, H8, W8),
                   (1, H_WIDE, W_WIDE), (NB, HB, WB))
# the split schedule's sweep against the one-warp schedule (forward device
# ms): stacks of (B, W) with HB rows, and single long rows (B, H, W)
SPLIT_BATCHES = tuple((b, w) for b in (1, 8, 16, 32)
                      for w in (WB, W, 4096))
SPLIT_LONG = ((1, H_WIDE, W_WIDE), (1, H_WIDE, 32768), (1, H8, W8),
              (2, H_WIDE, W_WIDE), (1, H_WIDE, 528 * 64),
              (1, H_WIDE, 529 * 64), (1, H, W - 3), (8, HB, WB - 3))
FORWARD_TURNS = 2          # (old, new, new, old) rounds of the ns a row
# device_ms calls whose four traces all came back empty, and where the
# last reading came from: "profiler", or "cuda_events" after such a call
PROFILER_EMPTY = [0]
DEVICE_SOURCE_LAST = ["profiler"]


def log(msg: str) -> None:
    print(msg, flush=True)


def bound(nbytes: float, ops: float) -> tuple[float, str]:
    """The least time in ms the card could take for `nbytes` read or
    written and `ops` float32 operations, as the benchmark's rooflines
    take it (`benchmark/benchlib/work.py::least_seconds`), and which side
    sets it: "bytes" or "operations"."""
    from benchlib.work import least_seconds

    by = ("bytes" if least_seconds(nbytes, 0) >= least_seconds(0, ops)
          else "operations")
    return least_seconds(nbytes, ops) * 1e3, by


def batch_chunks(B: int) -> list:
    """The image counts of the batch route's chunks by its default
    placement, one a visible card, as `carve_batch` cuts a batch of B."""
    import torch

    return [len(c) for c in torch.tensor_split(
        torch.arange(B), torch.cuda.device_count()) if len(c)]


def batch_launches(B: int, W: int, calls: int, **per_chunk) -> dict:
    """The launches of `calls` seams of a (B, H, W) batch by the default
    placement: each chunk's find-seam launches (`dp_launches`), and
    `per_chunk`'s count of each other kernel once a chunk."""
    chunks = batch_chunks(B)
    total = {k: n * len(chunks) for k, n in per_chunk.items()}
    for b in chunks:
        for k, n in dp_launches(b, W, calls, plane=False).items():
            total[k] = total.get(k, 0) + n
    return total


def dp_launches(B: int, W: int, calls: int, plane: bool = True) -> dict:
    """The find-seam launches that `calls` seam searches of a (B, H, W)
    stack (H > 1; a plane when `plane`) make: all on the kernel that
    `seam_route` picks, three a call on the tiled one (the frontier's
    memset, the forward, the finish) and one on find_seam.cu's record, none
    on the others."""
    from dct_carver_tpu_torch.kernels.dp_kernel import seam_route

    want = {"find_seam": 0, "find_seams": 0, "find_seam_tiled": 0}
    if seam_route(B, W) == "tiled":
        want["find_seam_tiled"] = 3 * calls
    else:
        want["find_seam" if plane else "find_seams"] = calls
    return want


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


class Checks:
    """Bitwise comparisons of a kernel with its plain version; the largest
    absolute difference per kernel, and every failure."""

    def __init__(self):
        self.max_err: dict[str, float] = {}
        self.failures: list[str] = []

    def equal(self, kernel: str, case: str, got, want) -> None:
        import torch

        if got.shape != want.shape or got.dtype != want.dtype:
            self.failures.append(f"{kernel} {case}: {tuple(got.shape)} "
                                 f"{got.dtype} vs {tuple(want.shape)} "
                                 f"{want.dtype}")
            return
        # equal cells count 0, so the +inf of masked DP cells is no error
        diff = torch.where(got == want, 0.0,
                           (got.double() - want.double()).abs())
        diff = torch.nan_to_num(diff, nan=float("inf"), posinf=float("inf"))
        err = float(diff.max()) if diff.numel() else 0.0
        same = bool(torch.equal(got, want))
        self.max_err[kernel] = max(self.max_err.get(kernel, 0.0), err)
        log(f"  {kernel:9s} {case:44s} {'bitwise' if same else 'DIFFERS'}"
            f"  max_abs_err={err!r}")
        if not same:
            self.failures.append(f"{kernel} {case}: max_abs_err={err!r}")

    def require(self, ok: bool, what: str) -> None:
        log(f"  {'ok  ' if ok else 'FAIL'} {what}")
        if not ok:
            self.failures.append(what)


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds of fn() on the card over `reps` calls, after one
    warm-up call, between CUDA events."""
    import torch

    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(fn, reps: int, only: str | None = None) -> float:
    """Mean device milliseconds per call of fn() over `reps` calls after
    one warm-up call, under torch.profiler: the device time of the kernels
    the calls launched (with `only`, of those whose name holds it), the
    host's time between launches left out.  When four traces in a row
    record no device time (PERF.md §7: the profiler sometimes stops
    recording for the rest of a process), the calls are timed between
    CUDA events instead, the host's gaps included, and with `only` nothing
    is: None, logged as not measured.  DEVICE_SOURCE_LAST says which the
    reading is; the kernels' line carries it beside each device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(4):  # a trace that comes back empty is taken again
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        us = sum(e.self_device_time_total for e in prof.key_averages()
                 if e.self_device_time_total > 0
                 and not e.key.startswith("aten::")
                 and (only is None or only in e.key))
        if us > 0:
            DEVICE_SOURCE_LAST[0] = "profiler"
            return us / reps / 1e3
    PROFILER_EMPTY[0] += 1
    DEVICE_SOURCE_LAST[0] = "cuda_events"
    if only is not None:
        log(f"  torch.profiler recorded no device time in 4 traces: "
            f"{only!r} alone not measured")
        return None
    ms = cuda_ms(fn, reps)
    log(f"  torch.profiler recorded no device time in 4 traces: "
        f"{ms!r} ms a call between CUDA events instead")
    return ms


def device_reading(fn, reps: int) -> tuple[float, str]:
    """device_ms(fn, reps) and where it came from ("profiler" or
    "cuda_events")."""
    ms = device_ms(fn, reps)
    return ms, DEVICE_SOURCE_LAST[0]


def time_kernel(times: dict, name: str, kernel, plain, reps: int,
                plain_reps: int) -> None:
    """times[name] = (kernel ms, plain ms) between CUDA events, and the
    kernel's device ms per call into DEVICE."""
    times[name] = (cuda_ms(kernel, reps), cuda_ms(plain, plain_reps))
    DEVICE[name], DEVICE_SOURCE[name] = device_reading(kernel, reps)


def time_library(name: str, fn, reps: int = 50) -> None:
    """The library call's ms between CUDA events and its device ms."""
    LIBRARY[name] = cuda_ms(fn, reps)
    LIBRARY_DEVICE[name], LIBRARY_DEVICE_SOURCE[name] = device_reading(
        fn, reps)


def device_profile(fn, top: int = 8, host: bool = True,
                   gaps: str | None = None):
    """Run fn() once warm under torch.profiler: (wall seconds, device
    microseconds summed over kernels, the `top` kernels by device time as
    (name, us, count)).  The rows of torch's own ops ("aten::...") repeat
    the device time of the kernels they launched, so they are left out.
    `host`: trace the host's ops too (their recording slows the host);
    else the device alone.  `gaps`: log where the device idled in the
    trace, under this name (`log_gaps`)."""
    import torch
    from benchlib.trace import busy_union
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    activities = [ProfilerActivity.CUDA]
    if host:
        activities.append(ProfilerActivity.CPU)
    with profile(activities=activities) as prof:
        t = time.perf_counter()
        with torch.profiler.record_function(WINDOW):
            fn()
            torch.cuda.synchronize()
        wall = time.perf_counter() - t
    rows = [(e.key, e.self_device_time_total, e.count)
            for e in prof.key_averages()
            if e.self_device_time_total > 0 and not e.key.startswith("aten::")
            and e.key != WINDOW]
    rows.sort(key=lambda r: -r[1])
    if gaps is not None:
        log_gaps(prof, gaps, wall)
    busy = busy_union((e.time_range.start, e.time_range.end)
                      for e in prof.events()
                      if e.device_type == DeviceType.CUDA
                      and e.name != WINDOW)
    return wall, sum(r[1] for r in rows), rows[:top], busy


# the host's range around a profiled call (`device_profile`); the profiler
# also gives it a device span over the kernels it launched, which is no
# device work and is left out of every device sum
WINDOW = "timed window"


def log_gaps(prof, what: str, wall: float, top: int = 5) -> None:
    """Where the device idled in a profile: the time between the first
    device interval and the last that no kernel, memset or copy covers,
    the gaps by the kernels on either side, and the longest gaps."""
    from collections import Counter

    from torch.autograd import DeviceType

    spans = sorted((e.time_range.start, e.time_range.end, e.name)
                   for e in prof.events()
                   if e.device_type == DeviceType.CUDA and e.name != WINDOW)
    if not spans:
        return
    found, end, before = [], spans[0][1], spans[0][2]
    for a, b, name in spans[1:]:
        if a > end:
            found.append((a - end, before[:40], name[:40]))
        if b > end:
            end, before = b, name
    by_pair = Counter()
    for us, a, b in found:
        by_pair[(a, b)] += us
    span_us = end - spans[0][0]
    idle = sum(g[0] for g in found)
    window = [e.time_range for e in prof.events()
              if e.name == WINDOW and e.device_type == DeviceType.CPU]
    edges = "" if not window else (
        f": {(spans[0][0] - window[0].start) / 1e3!r} ms from the window's "
        f"start to the first device interval, "
        f"{(window[0].end - end) / 1e3!r} ms from the last to its end")
    log(f"  {what}: device span {span_us / 1e3!r} ms of the {wall * 1e3!r} "
        f"ms wall, {idle / 1e3!r} ms idle inside it in {len(found)} gaps "
        f"(outside it: {wall * 1e3 - span_us / 1e3!r} ms{edges})")
    for (a, b), us in by_pair.most_common(top):
        log(f"    idle {us / 1e3:9.4f} ms between {a} -> {b}")
    for us, a, b in sorted(found, reverse=True)[:top]:
        log(f"    gap {us:9.2f} us: {a} -> {b}")


def event_busy(run, device) -> dict:
    """One unprofiled run of run(), a carve whose seams are graph replays,
    with CUDA events before and after every replay and around the whole
    call: the host wall, the device span between the first and the last
    event, the replays' device time, and the idle time between replays
    (the device waiting for the host's next replay).  The share of the
    wall the device was busy is (span - idle between replays) / wall: the
    eager work before the first replay counts as busy, so it bounds the
    share from above by that work's own gaps."""
    import torch

    from dct_carver_tpu_torch.utils import graphs

    marks = []
    replay = graphs.StepGraphs.replay

    def timed(self, src):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        replay(self, src)
        b.record()
        marks.append((a, b))

    first = torch.cuda.Event(enable_timing=True)
    last = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize(device)
    graphs.StepGraphs.replay = timed
    try:
        with torch.cuda.device(device):
            t = time.perf_counter()
            first.record()
            run()
            last.record()
            torch.cuda.synchronize(device)
            wall = time.perf_counter() - t
    finally:
        graphs.StepGraphs.replay = replay
    span = first.elapsed_time(last)
    in_replays = sum(a.elapsed_time(b) for a, b in marks)
    between = sum(b.elapsed_time(a2) for (_, b), (a2, _) in
                  zip(marks, marks[1:]))
    return {"wall_ms": wall * 1e3, "span_ms": span, "replays": len(marks),
            "replay_ms": in_replays, "idle_between_replays_ms": between,
            "before_first_replay_ms": first.elapsed_time(marks[0][0])
            if marks else span,
            "busy_pct": 100 * (span - between) / (wall * 1e3)}


def log_event_busy(what: str, run, device, card: str,
                   repeats: int = 3) -> None:
    for _ in range(repeats):
        e = event_busy(run, device)
        log(f"  {what}, unprofiled with CUDA events: wall {e['wall_ms']!r} "
            f"ms, device span {e['span_ms']!r} ms, {e['replays']} replays "
            f"{e['replay_ms']!r} ms, idle between replays "
            f"{e['idle_between_replays_ms']!r} ms, before the first replay "
            f"{e['before_first_replay_ms']!r} ms; busy {e['busy_pct']!r} % "
            f"of the wall ({card})")


def capture_costs(luma, samples: int, card: str) -> None:
    """Host time of the capture in the first carve of a shape, `samples`
    times over, each after clear_step_cache(): its wall and process CPU
    time (all threads; a wait that spins counts as CPU), split into any
    wait for the device inside it ("sync": none since the capture stopped
    waiting), capture_begin, the step's host work under capture (both
    directions) and capture_end (which instantiates the graph), with
    Python's garbage-collection pauses beside them."""
    import gc

    import torch

    from dct_carver_tpu_torch.ops import carve as ops
    from dct_carver_tpu_torch.utils import graphs

    parts, inside = {}, [False]

    def timing(obj, name, key):
        fn = getattr(obj, name)

        def timed(*args, **kwargs):
            if not inside[0]:
                return fn(*args, **kwargs)
            t = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                parts[key] = parts.get(key, 0.0) + time.perf_counter() - t
        return fn, timed

    gc_t = [0.0, None]

    def on_gc(phase, info):
        if phase == "start":
            gc_t[1] = time.perf_counter()
        elif gc_t[1] is not None:
            gc_t[0] += time.perf_counter() - gc_t[1]
            gc_t[1] = None

    capture = graphs.StepGraphs.capture

    def cap(self, step, sources):
        c = time.process_time()
        t = time.perf_counter()
        inside[0] = True
        try:
            return capture(self, step, sources)
        finally:
            inside[0] = False
            parts["capture"] = time.perf_counter() - t
            parts["capture_cpu"] = time.process_time() - c

    patched = [(torch.cuda, "synchronize", "sync"),
               (torch.cuda.CUDAGraph, "capture_begin", "begin"),
               (ops.SeamSteps, "_step", "step"),
               (torch.cuda.CUDAGraph, "capture_end", "end")]
    saved = [timing(*p) for p in patched]
    rows = []
    gc.callbacks.append(on_gc)
    graphs.StepGraphs.capture = cap
    for (o, n, _), (_, timed) in zip(patched, saved):
        setattr(o, n, timed)
    try:
        for _ in range(samples):
            ops.clear_step_cache()
            torch.cuda.synchronize()
            parts.clear()
            gc_t[0] = 0.0
            t = time.perf_counter()
            ops.carve_n_seams(luma, SEAMS, 8, 0.0, 1.0)
            torch.cuda.synchronize()
            rows.append({"carve": time.perf_counter() - t, "gc": gc_t[0],
                         **parts})
    finally:
        graphs.StepGraphs.capture = capture
        for (o, n, _), (fn, _) in zip(patched, saved):
            setattr(o, n, fn)
        gc.callbacks.remove(on_gc)
    caps = sorted(r["capture"] * 1e3 for r in rows)
    log(f"  capture of the headline step, {samples} first carves each "
        f"after clear_step_cache(): capture ms min {caps[0]!r}, median "
        f"{caps[len(caps) // 2]!r}, max {caps[-1]!r}; "
        f"{sum(c > 50 for c in caps)} over 50 ms ({card})")
    for r in sorted(rows, key=lambda r: -r["capture"])[:3] + [
            sorted(rows, key=lambda r: r["capture"])[len(rows) // 2]]:
        log("    capture parts: " + ", ".join(
            f"{k} {v * 1e3:.3f} ms" for k, v in r.items()))


def other_card(chk, card: str) -> None:
    """A carve on the second card while the first is current: the single
    image route (the first carve's eager seam and capture, then a carve
    that replays every seam) and carve_batch split over both cards, each
    against the plain path on its card."""
    import torch

    from dct_carver_tpu_torch.ops.carve import carve_n_seams, clear_step_cache
    from dct_carver_tpu_torch.ops.energy import to_luma
    from dct_carver_tpu_torch.parallel.mesh import carve_batch

    if torch.cuda.device_count() < 2:
        log("  one card: the carve on a card other than the current one "
            "needs a second card and is not run")
        return
    rng = np.random.default_rng(SEED + 1)
    dev = torch.device("cuda", 1)
    torch.cuda.set_device(0)
    clear_step_cache()
    for run in ("first", "warm"):
        img = torch.from_numpy(rng.integers(0, 256, (H, W, 3),
                                            dtype=np.uint8)).to(dev)
        x = to_luma(img)
        got = carve_n_seams(x, SEAMS, 8, 0.0, 1.0)
        chk.require(torch.cuda.current_device() == 0,
                    "the first card stays current")
        hold_graphed(chk, f"{run} carve on cuda:1 while cuda:0 is current",
                     got, eager_kernel_carve(x, SEAMS, 8, 0.0, 1.0),
                     carve_n_seams(x, SEAMS, 8, 0.0, 1.0, use_pallas=False))
    imgs = rng.integers(0, 256, (4, 256, 512, 3), dtype=np.uint8)
    got, vm = carve_batch(imgs, 16, devices=["cuda:0", "cuda:1"])
    want, wvm = carve_batch(imgs, 16, devices=["cuda:0", "cuda:1"],
                            use_pallas=False)
    chk.equal("carve", "carve_batch over cuda:0 and cuda:1, images", got,
              want)
    chk.equal("carve", "carve_batch over cuda:0 and cuda:1, vmaps", vm, wvm)
    torch.cuda.synchronize(dev)
    log(f"  carves on cuda:1 with cuda:0 current checked ({card})")


def eager_kernel_carve(luma, n_seams: int, blocksize: int, edges, textures,
                       energy_fn=None):
    """The kernel path's carve as it ran before the seam step was graphed:
    a Python int width and label, each stage through its public wrapper,
    one launch each.  Returns (luma, vmap, energy) after `n_seams`."""
    import torch

    from dct_carver_tpu_torch.kernels.apply_kernel import apply_seam
    from dct_carver_tpu_torch.kernels.dp_kernel import find_seam, find_seams
    from dct_carver_tpu_torch.kernels.strip_kernel import strip_update
    from dct_carver_tpu_torch.ops import carve as ops
    from dct_carver_tpu_torch.ops.strip import strip_fits

    W = luma.shape[-1]
    state = ops.make_state(luma.clone())
    energy = ops.full_energy_map(state.luma, blocksize, edges, textures,
                                 energy_fn=energy_fn)
    strip = strip_fits(W, blocksize, 1, energy_fn)
    lum, origcol, vmap, width = state.luma, state.origcol, state.vmap, W
    for k in range(1, n_seams + 1):
        find = find_seams if energy.ndim == 3 else find_seam
        seam = find(energy, width)
        orig = origcol.gather(-1, seam[..., None].to(torch.int64))
        vmap.scatter_(-1, orig.to(torch.int64), k)
        lum, origcol, energy = apply_seam(lum, origcol, energy, seam, width)
        width -= 1
        if not strip:
            energy = ops.full_energy_map(lum, blocksize, edges, textures,
                                         energy_fn=energy_fn)
        elif energy_fn is not None:
            ops.update_energy(lum, energy, seam, ops.step_params(
                blocksize, edges, textures, energy_fn=energy_fn))
        else:
            strip_update(lum, energy, seam, blocksize, edges, textures)
    return lum, vmap, energy


def hold_graphed(chk: Checks, case: str, graphed, eager, plain=None) -> None:
    """The graphed carve's (luma, vmap, energy) against the eager kernel
    carve's and, where given, the plain path's, element for element (the
    energy on the live columns against the plain path, whose dead columns
    are not compacted the same way)."""
    live = graphed.width
    for part, g, e in zip(("luma", "vmap", "energy"),
                          (graphed.luma, graphed.vmap, graphed.energy),
                          eager):
        chk.equal("carve", f"{case} graphed == eager kernels, {part}", g, e)
    if plain is not None:
        chk.equal("carve", f"{case} graphed == plain, vmap", graphed.vmap,
                  plain.vmap)
        chk.equal("carve", f"{case} graphed == plain, luma", graphed.luma,
                  plain.luma)
        chk.equal("carve", f"{case} graphed == plain, live energy",
                  graphed.energy[..., :live].contiguous(),
                  plain.energy[..., :live].contiguous())


def kernel_floor(card: str) -> dict:
    """The floor of a kernel's device time on this card: strip_gather on
    the smallest band it takes (one row, n = 2: 18 threads), back to back
    and as nodes of a replayed graph, each measured as the kernels' own
    device times are (`device_ms`).  Its launch counts are put back."""
    import torch

    from dct_carver_tpu_torch import kernels
    from dct_carver_tpu_torch.kernels.strip_kernel import strip_gather

    counts = kernels.launch_counts()
    luma = torch.zeros((1, 8), dtype=torch.float32, device="cuda")
    seam = torch.zeros((1,), dtype=torch.int32, device="cuda")

    def tiny():
        return strip_gather(luma, seam, 2)

    tiny()
    nodes = 64
    graph = torch.cuda.CUDAGraph()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        graph.capture_begin()
        try:
            for _ in range(nodes):
                tiny()
        finally:
            graph.capture_end()
    torch.cuda.current_stream().wait_stream(side)
    b2b, b2b_src = device_reading(tiny, 200)
    graphed, graphed_src = device_reading(graph.replay, 20)
    floor = {"back_to_back": b2b, "in_graph": graphed / nodes,
             "source": sorted({b2b_src, graphed_src})}
    for k in kernels.KERNELS:
        k.launches = counts[k.name]
    log(f"  kernel floor (strip_gather of one 2 x 9 band): back to back "
        f"{floor['back_to_back']!r} ms, in a graph {floor['in_graph']!r} ms "
        f"a node ({card})")
    return floor


def phase_1b(dev, chk: Checks, card: str, rng) -> None:
    """Whole carves at the single-image shapes that the TPU sends down its
    streamed (4320x7680) and folded (4096x4096) DP routes: the kernel path
    equals the plain path on the card."""
    import torch

    from dct_carver_tpu_torch.ops.carve import carve_n_seams

    log(f"phase 1b: whole {WHOLE_SEAMS}-seam carves at n=8, kernel path vs "
        "plain path on the card")
    for h, w, route in WHOLE_SHAPES:
        luma = torch.from_numpy(rng.random((h, w), dtype=np.float32)).to(dev)
        torch.cuda.synchronize()
        t = time.perf_counter()
        k = carve_n_seams(luma, WHOLE_SEAMS, 8, 0.0, 1.0)
        torch.cuda.synchronize()
        sec = time.perf_counter() - t
        p = carve_n_seams(luma, WHOLE_SEAMS, 8, 0.0, 1.0, use_pallas=False)
        live = w - WHOLE_SEAMS
        chk.require(k.width == p.width == live, f"{h}x{w} logical width")
        case = f"{h}x{w} ({route} DP on the TPU)"
        chk.equal("carve", f"{case} vmap", k.vmap, p.vmap)
        chk.equal("carve", f"{case} luma", k.luma, p.luma)
        chk.equal("carve", f"{case} energy, live columns",
                  k.energy[:, :live].contiguous(),
                  p.energy[:, :live].contiguous())
        log(f"  {case}: kernel path {sec!r} s, first call included ({card})")
        del luma, k, p


def phase_1c(dev, chk: Checks, card: str, rng, times: dict) -> dict:
    """The tiled find-seam (column tiles, in the forward's schedule that
    `split_forward` picks) against the plain find-seam: rows wider than
    one thread block (both ties, column windows, seams along either
    border, a stack with per-image windows), then at the tiled kernel's
    own geometry (1080p, 4K and 8K planes, 8K repeated, a window cutting a
    tile, seams along a tile edge, H not a multiple of K, H = 1 and 2, a B
    = 8 stack with per-image windows, several tiles a warp); its finish
    (`finish_1c`), its split forward and the two schedules' times
    (`split_1c`, `forward_turns`); the sweeps (`sweeps_1c`) that its
    constants and `seam_route`'s thresholds come from; a whole `api.carve`
    of a wide RGB image against the plain path with the launch counters
    read around it; the apply at H_TALL rows.  Returns the launch counts
    of the wide carve."""
    import torch

    from dct_carver_tpu_torch import api, kernels
    from dct_carver_tpu_torch.kernels.apply_kernel import apply_seam
    from dct_carver_tpu_torch.kernels.dp_kernel import (
        MAX_WIDTH, TILE_C, TILE_K, TILE_W, TILE_WARPS,
        _find_seams_tiled, find_seam, find_seams)

    def on_dev(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    def tiled(e, width, lo=0, tie="leftmost", **kw):
        return _find_seams_tiled(e, width, lo, tie, **kw)

    log(f"phase 1c: the tiled find-seam ({TILE_W} owned columns a tile, "
        f"K = {TILE_K}, {TILE_C} columns a lane; one warp a tile, "
        f"{TILE_WARPS} tiles a CTA, or split, a CTA a tile, as split_forward "
        f"picks) vs the plain find-seam at widths past "
        f"{MAX_WIDTH}")
    for w in (MAX_WIDTH + 1, W_WIDE):
        e_r = on_dev(rng.random((TILED_ROWS, w), dtype=np.float32))
        e_q = on_dev((rng.integers(0, 3, (TILED_ROWS, w)) / 2)
                     .astype(np.float32))
        for e_name, e in (("random", e_r), ("quantized", e_q)):
            for lo, width in ((0, w), (1000, w - 5000)):
                for tie in TIES:
                    chk.equal("find_seam_tiled",
                              f"{TILED_ROWS}x{w} {e_name} [{lo}, "
                              f"{lo + width}) {tie}",
                              find_seams(e[None], width, lo, tie=tie),
                              find_seams(e[None], width, lo, tie=tie,
                                         use_pallas=False))
        chk.equal("find_seam_tiled", f"{TILED_ROWS}x{w} find_seam width=W-3",
                  find_seam(e_r, w - 3), find_seam(e_r, w - 3,
                                                   use_pallas=False))
        for col in (0, w - 1):
            e_b = torch.ones((TILED_ROWS, w), device=dev)
            e_b[:, col] = 0
            for tie in TIES:
                got = find_seam(e_b, w, tie=tie)
                chk.equal("find_seam_tiled",
                          f"{TILED_ROWS}x{w} seam along column {col} {tie}",
                          got, find_seam(e_b, w, tie=tie, use_pallas=False))
                chk.require(bool((got == col).all()),
                            f"{TILED_ROWS}x{w} {tie}: the seam runs along "
                            f"column {col}")
        # more tiles than warps: 97 warps of ceil(w / TILE_W) / 97 tiles
        for tie in TIES:
            chk.equal("find_seam_tiled", f"{TILED_ROWS}x{w} quantized, 97 "
                      f"warps (several tiles a warp) {tie}",
                      tiled(e_q[None], w, 0, tie, max_warps=97),
                      find_seams(e_q[None], w, tie=tie, use_pallas=False))
    e2 = on_dev((rng.integers(0, 3, (2, TILED_ROWS - 43, W_WIDE)) / 2)
                .astype(np.float32))
    widths = on_dev(np.array([W_WIDE, MAX_WIDTH - 1700], np.int32))
    los = on_dev(np.array([0, 7001], np.int32))
    for tie in TIES:
        chk.equal("find_seam_tiled", f"B=2 x {TILED_ROWS - 43}x{W_WIDE} "
                  f"per-image windows {tie}",
                  find_seams(e2, widths, los, tie=tie),
                  find_seams(e2, widths, los, tie=tie, use_pallas=False))
    del e_r, e_q, e_b, e2

    log("phase 1c: the tiled find-seam at its own geometry")
    for h, w in ((H, W), (H4, W4), (H8, W8)):
        e = on_dev(rng.random((h, w), dtype=np.float32))
        for tie in TIES:
            want = find_seam(e, w, tie=tie, use_pallas=False)
            reps = REPEATS_8K if w == W8 else 1
            same = sum(bool(torch.equal(tiled(e[None], w, 0, tie)[0], want))
                       for _ in range(reps))
            chk.equal("find_seam_tiled", f"{h}x{w} random {tie}"
                      + (f" (1 of {reps})" if reps > 1 else ""),
                      tiled(e[None], w, 0, tie)[0], want)
            if reps > 1:
                chk.require(same == reps, f"{h}x{w} {tie}: {same} of {reps} "
                            "repeated tiled runs bitwise")
        del e
    e_q = on_dev((rng.integers(0, 3, (H, W)) / 2).astype(np.float32))
    lo = 3 * TILE_W + 5
    for tie in TIES:  # [lo, lo + width) starts and ends inside a tile
        chk.equal("find_seam_tiled", f"{H}x{W} quantized [{lo}, "
                  f"{W - 131}) {tie}", tiled(e_q[None], W - 131 - lo, lo,
                                             tie)[0],
                  find_seams(e_q[None], W - 131 - lo, lo, tie=tie,
                             use_pallas=False)[0])
    for col in (TILE_W - 1, TILE_W, 5 * TILE_W):
        e_b = torch.ones((H, W), device=dev)
        e_b[:, col] = 0
        for tie in TIES:
            got = tiled(e_b[None], W, 0, tie)[0]
            chk.equal("find_seam_tiled", f"{H}x{W} seam along tile-edge "
                      f"column {col} {tie}", got,
                      find_seam(e_b, W, tie=tie, use_pallas=False))
            chk.require(bool((got == col).all()),
                        f"{H}x{W} {tie}: the seam runs along column {col}")
    for h in (1, 2, 999):  # one row (the finish alone), one DP row, H % K
        e = on_dev((rng.integers(0, 3, (h, 5000)) / 2).astype(np.float32))
        for tie in TIES:
            chk.equal("find_seam_tiled", f"{h}x5000 quantized {tie}",
                      tiled(e[None], 4990, 3, tie)[0],
                      find_seams(e[None], 4990, 3, tie=tie,
                                 use_pallas=False)[0])
    e8 = on_dev((rng.integers(0, 3, (NB, TILED_ROWS, 5001)) / 2)
                .astype(np.float32))
    w8 = on_dev(np.array([5001, 4000, 1, 2, 333, 5000, 64, 2500], np.int32))
    l8 = on_dev(np.array([0, 1001, 5000, 0, 4600, 1, 700, 2501], np.int32))
    for tie in TIES:
        want = find_seams(e8, w8, l8, tie=tie, use_pallas=False)
        chk.equal("find_seam_tiled", f"B={NB} x {TILED_ROWS}x5001 per-image "
                  f"windows {tie}", tiled(e8, w8, l8, tie), want)
        chk.equal("find_seam_tiled", f"B={NB} x {TILED_ROWS}x5001 per-image "
                  f"windows, 5 warps (several tiles a warp) {tie}",
                  tiled(e8, w8, l8, tie, max_warps=5), want)
    del e_q, e_b, e8

    finish_1c(dev, chk, card, rng)
    split_1c(dev, chk, card, rng)
    forward_turns(dev, chk, card, rng)

    # row 3's times at the wide carve's shape
    e_w = on_dev(rng.random((H_WIDE, W_WIDE), dtype=np.float32))
    time_kernel(times, "find_seam_tiled", lambda: find_seam(e_w, W_WIDE),
                lambda: find_seam(e_w, W_WIDE, use_pallas=False), 20, 2)
    BOUNDS["find_seam_tiled"] = (4 * H_WIDE * W_WIDE + 4 * H_WIDE,
                                 3 * H_WIDE * W_WIDE)
    parts = {part: device_ms(lambda: find_seam(e_w, W_WIDE), 20, only=part)
             for part in ("tile_rows", "finish")}
    log(f"  find_seam_tiled {H_WIDE}x{W_WIDE}: kernel "
        f"{times['find_seam_tiled'][0]!r} ms (device "
        f"{DEVICE['find_seam_tiled']!r}: forward {parts['tile_rows']!r}, "
        f"finish {parts['finish']!r}), plain "
        f"{times['find_seam_tiled'][1]!r} ms ({card})")
    del e_w

    sweeps_1c(dev, card, rng)

    log(f"phase 1c: api.carve({H_WIDE}x{W_WIDE}x3, -{WHOLE_SEAMS}) on the "
        "card")
    img = rng.integers(0, 256, (H_WIDE, W_WIDE, 3), dtype=np.uint8)
    kw = dict(blocksize=8, output_seams=True, output_energy=True,
              device="cuda")
    api.carve(img[:64, :MAX_WIDTH + 64], -2, **kw)  # warm-up
    torch.cuda.synchronize()
    kernels.reset_launches()
    t = time.perf_counter()
    res = api.carve(img, -WHOLE_SEAMS, **kw)
    torch.cuda.synchronize()
    sec = time.perf_counter() - t
    launches = kernels.launch_counts()
    log(f"  wide api.carve: {sec!r} s, host copies included ({card})")
    log(f"  launches on the wide carve: {launches}")
    want = {**dp_launches(1, W_WIDE, WHOLE_SEAMS), "apply": WHOLE_SEAMS,
            "strip": WHOLE_SEAMS}
    for name, n in want.items():
        chk.require(launches[name] == n,
                    f"wide carve: {name} launched {n} times")
    chk.require(launches["energy"] >= 1, "wide carve: energy launched")
    plain = api.carve(img, -WHOLE_SEAMS, use_pallas=False, **kw)
    for field in ("image", "visibility_map", "energy_image"):
        a, b = getattr(res, field), getattr(plain, field)
        chk.require(a.shape == b.shape and np.array_equal(a, b),
                    f"wide api.carve {field} == plain path on the card")
    chk.require(res.image.shape == (H_WIDE, W_WIDE - WHOLE_SEAMS, 3),
                "wide carve output shape")
    del img, res, plain

    log(f"phase 1c: apply at {H_TALL} rows (rows by grid stride)")
    x = on_dev(rng.random((H_TALL, 64), dtype=np.float32))
    oc = on_dev(rng.integers(0, 99, (H_TALL, 64)).astype(np.int32))
    e = on_dev(rng.random((H_TALL, 64), dtype=np.float32))
    seam = on_dev(((np.cumsum(rng.integers(-1, 2, H_TALL)) + 30) % 60)
                  .astype(np.int32))
    for part, g, w_ in zip(("luma", "origcol", "energy"),
                           apply_seam(x, oc, e, seam, 62),
                           apply_seam(x, oc, e, seam, 62, use_pallas=False)):
        chk.equal("apply", f"{H_TALL}x64 {part}", g, w_)
    return launches


def finish_1c(dev, chk: Checks, card: str, rng) -> None:
    """Phase 1c's tiled finish (blocks of FINISH_ROWS parent rows, their
    jumps composed in parallel, then walked and filled): bitwise against
    the plain find-seam at the benchmark's planes (1080x1920, 2160x3840,
    3456x2160: H - 1 no multiple of FINISH_ROWS), at one block, one block
    and a row and exactly two, with per-image windows, on a 16-image stack
    (several compose items a CTA) and a 32-image one (past
    FINISH_COMPOSE_COLUMNS: the row walk); `blocked_finishes` against the
    calls that compose (`composes_blocks`); then the finish's and the
    forward's device ms at those planes."""
    import torch

    from dct_carver_tpu_torch.kernels.dp_kernel import (
        FINISH_ROWS, ROUTE_MAX_BATCH, TILED_KERNEL, _find_seams_tiled,
        composes_blocks, find_seams)

    def on_dev(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    calls = {"all": 0, "blocked": 0}

    def hold(case, e, width, lo, tie):
        calls["all"] += 1
        calls["blocked"] += composes_blocks(*e.shape)
        chk.equal("find_seam_tiled", f"finish {case} {tie}",
                  _find_seams_tiled(e, width, lo, tie),
                  find_seams(e, width, lo, tie=tie, use_pallas=False))

    log(f"phase 1c: the tiled finish, blocks of {FINISH_ROWS} rows")
    before = TILED_KERNEL.blocked_finishes
    planes = ((H, W), (H4, W4), (W_BIDIR, H4))
    for h, w in planes:
        e_r = on_dev(rng.random((1, h, w), dtype=np.float32))
        e_q = on_dev((rng.integers(0, 3, (1, h, w)) / 2).astype(np.float32))
        for tie in TIES:
            hold(f"{h}x{w} random", e_r, w, 0, tie)
            hold(f"{h}x{w} quantized [7, {w - 20})", e_q, w - 27, 7, tie)
        del e_r, e_q
    for h in (FINISH_ROWS + 1, FINISH_ROWS + 2, 2 * FINISH_ROWS + 1):
        e = on_dev((rng.integers(0, 3, (1, h, W)) / 2).astype(np.float32))
        for tie in TIES:
            hold(f"{h}x{W} quantized", e, W, 0, tie)
    for col in (0, W - 1):
        e_b = torch.ones((1, H, W), device=dev)
        e_b[..., col] = 0
        for tie in TIES:
            hold(f"{H}x{W} seam along column {col}", e_b, W, 0, tie)
    # 16 images: more compose items than CTAs; the most images the tiled
    # route takes: the row walk
    for nb in (ROUTE_MAX_BATCH // 2, ROUTE_MAX_BATCH):
        es = on_dev((rng.integers(0, 3, (nb, H, W)) / 2).astype(np.float32))
        ws = rng.integers(1, W + 1, nb).astype(np.int32)
        widths = on_dev(ws)
        los = on_dev((rng.random(nb) * (W + 1 - ws)).astype(np.int32))
        for tie in TIES:
            hold(f"B={nb} x {H}x{W} per-image windows", es, widths, los, tie)
            hold(f"B={nb} x {H}x{W}", es, W, 0, tie)
        del es
    del e_b, e
    got = TILED_KERNEL.blocked_finishes - before
    chk.require(got == calls["blocked"],
                f"blocked_finishes counted {got} of {calls['all']} tiled "
                f"calls, {calls['blocked']} of them composed")
    for b, h, w in ((1, H, W), (1, H4, W4), (1, W_BIDIR, H4),
                    (ROUTE_MAX_BATCH // 2, H, W), (ROUTE_MAX_BATCH, H, W)):
        e = on_dev(rng.random((b, h, w), dtype=np.float32))
        parts = {part: device_ms(lambda: _find_seams_tiled(e, w, 0,
                                                           "leftmost"),
                                 20, only=part)
                 for part in ("finish", "tile_rows")}
        log(f"  finish B={b} {h}x{w}: finish {parts['finish']!r} ms, "
            f"forward {parts['tile_rows']!r} ms a call ({card})")
        del e


def split_1c(dev, chk: Checks, card: str, rng) -> None:
    """Phase 1c's split forward (a CTA a tile: the DP warp and two helper
    warps): bitwise against the plain find-seam at the benchmark's
    planes (1080x1920, 2160x3840, 3456x2160), H = 2, 33, 65 and 1080,
    windows that cut a tile, seams along tile edges and both borders, both
    ties, rows of no multiple of 4 columns (4-byte copies), 512 x 40000,
    stacks of 8, 16 and 32 images with per-image windows (the split
    schedule forced where `split_forward` would not take it), several
    tiles a CTA, and every geometry of the sweep;
    `split_forwards` against the calls that took the split schedule."""
    import torch

    from dct_carver_tpu_torch.kernels.dp_kernel import (
        TILE_W, TILED_KERNEL, _find_seams_tiled, find_seams)

    def on_dev(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    def quantized(shape):
        return on_dev((rng.integers(0, 3, shape) / 2).astype(np.float32))

    calls = [0]
    wants = {}

    def hold(case, e, width, lo, tie, **kw):
        kw.setdefault("split", True)
        calls[0] += e.shape[1] > 1 and kw["split"]
        key = (case.split(", C=")[0], tie)  # one input, several geometries
        if key not in wants:
            wants[key] = find_seams(e, width, lo, tie=tie, use_pallas=False)
        got = _find_seams_tiled(e, width, lo, tie, **kw)
        chk.equal("find_seam_tiled", f"split {case} {tie}", got, wants[key])
        return got

    log("phase 1c: the split forward (two helper warps a tile) vs the plain "
        "find-seam")
    before = TILED_KERNEL.split_forwards
    lo = 3 * TILE_W + 5
    for h, w in ((H, W), (H4, W4), (W_BIDIR, H4)):
        e_r = on_dev(rng.random((1, h, w), dtype=np.float32))
        e_q = quantized((1, h, w))
        for tie in TIES:
            hold(f"{h}x{w} random", e_r, w, 0, tie)
            hold(f"{h}x{w} quantized [{lo}, {w - 131})", e_q, w - 131 - lo,
                 lo, tie)
        del e_r, e_q
    for h in (2, 33, 65, H):
        e = quantized((1, h, W))
        for tie in TIES:
            hold(f"{h}x{W} quantized", e, W, 0, tie)
    for col in (0, TILE_W - 1, TILE_W, 5 * TILE_W, W - 1):
        e_b = torch.ones((1, H, W), device=dev)
        e_b[..., col] = 0
        for tie in TIES:
            got = hold(f"{H}x{W} seam along column {col}", e_b, W, 0, tie)
            chk.require(bool((got == col).all()),
                        f"split {H}x{W} {tie}: the seam runs along column "
                        f"{col}")
    for w in (W - 3, 5001):  # 4-byte copies of the energy
        e = quantized((1, H, w))
        for tie in TIES:
            hold(f"{H}x{w} quantized", e, w, 0, tie)
            hold(f"{H}x{w} quantized [5, {w - 10})", e, w - 15, 5, tie)
    e_w = quantized((1, H_WIDE, W_WIDE))
    for tie in TIES:
        hold(f"{H_WIDE}x{W_WIDE} quantized", e_w, W_WIDE, 0, tie)
        hold(f"{H_WIDE}x{W_WIDE} quantized [1000, {W_WIDE - 4000})", e_w,
             W_WIDE - 5000, 1000, tie)
    del e_w
    for nb in (8, 16, 32):
        es = quantized((nb, H, W))
        ws = rng.integers(1, W + 1, nb).astype(np.int32)
        widths = on_dev(ws)
        los = on_dev((rng.random(nb) * (W + 1 - ws)).astype(np.int32))
        for tie in TIES:
            hold(f"B={nb} x {H}x{W} per-image windows", es, widths, los, tie)
            if nb == 8:
                hold(f"B={nb} x {H}x{W} per-image windows", es, widths, los,
                     tie, max_warps=5)  # several tiles a CTA
        del es
    e_q = quantized((1, H, W))
    for c, wt, k in GEOMETRIES:
        for tie in TIES:
            hold(f"{H}x{W} quantized' [{lo}, {W - 131}), C={c} Wt={wt} "
                 f"K={k}", e_q, W - 131 - lo, lo, tie, tile=wt, K=k, chunk=c)
    del e_q
    got = TILED_KERNEL.split_forwards - before
    chk.require(got == calls[0], f"split_forwards counted {got} of "
                f"{calls[0]} split calls")


def forward_turns(dev, chk: Checks, card: str, rng) -> None:
    """The tiled forward's ns a DP row, one warp a tile against the split
    schedule, in turns (old, new, new, old), FORWARD_TURNS rounds: alone at
    the benchmark's planes (`tile_rows` device ms a call over H - 1 rows),
    then inside graphed seam steps (64-seam `carve_n_seams` of a 1080p and
    a 4K luma, the profiled carve replaying every seam; the schedule set by
    SPLIT_MAX_TILES, the step cache cleared between), with
    `split_forwards` against the seams carved."""
    import statistics

    import torch

    from dct_carver_tpu_torch.kernels import dp_kernel
    from dct_carver_tpu_torch.ops.carve import carve_n_seams, clear_step_cache

    def on_dev(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    order = (False, True, True, False) * FORWARD_TURNS

    def report(what, ns):
        log(f"  forward {what}: ns a DP row, one warp {ns[False]!r}, split "
            f"{ns[True]!r}; medians {statistics.median(ns[False])!r} / "
            f"{statistics.median(ns[True])!r} ({card})")

    log("phase 1c: the forward's ns a DP row, one warp a tile vs split, in "
        "turns")
    for h, w in ((H, W), (H4, W4), (W_BIDIR, H4)):
        e = on_dev(rng.random((1, h, w), dtype=np.float32))
        ns = {False: [], True: []}
        for split in order:
            ms = device_ms(lambda: dp_kernel._find_seams_tiled(
                e, w, 0, "leftmost", split=split), 20, only="tile_rows")
            if ms is not None:
                ns[split].append(ms * 1e6 / (h - 1))
        if ns[False] and ns[True]:
            report(f"alone {h}x{w}", ns)
        del e
    limit = dp_kernel.SPLIT_MAX_TILES
    for h, w in ((H, W), (H4, W4)):
        luma = on_dev(rng.random((h, w), dtype=np.float32))
        ns = {False: [], True: []}
        for split in order:
            # no stack takes the split schedule below 0 tiles
            dp_kernel.SPLIT_MAX_TILES = limit if split else -1
            clear_step_cache()
            before = dp_kernel.TILED_KERNEL.split_forwards
            try:  # a warm carve that captures, then one that replays
                _, _, top, _ = device_profile(lambda: carve_n_seams(
                    luma, SEAMS, 8, 0.0, 1.0), top=64, host=False)
            finally:
                dp_kernel.SPLIT_MAX_TILES = limit
            counted = dp_kernel.TILED_KERNEL.split_forwards - before
            chk.require(counted == (2 * SEAMS if split else 0),
                        f"graphed {h}x{w} carves, split={split}: "
                        f"split_forwards {counted}")
            us = sum(t for name, t, _ in top if "tile_rows" in name)
            ns[split].append(us * 1e3 / (SEAMS * (h - 1)))
        report(f"in graphed seam steps {h}x{w}", ns)
        del luma
    clear_step_cache()


def sweeps_1c(dev, card: str, rng) -> None:
    """Phase 1c's sweeps: the tiled kernel's geometry and forward schedule
    (device ms summed over GEOMETRY_SHAPES, and over the benchmark's three
    planes alone; the constants TILE_* are the least), the split schedule
    against one warp a tile over stacks and long rows (SPLIT_MAX_TILES),
    and the width sweep of find_seam.cu against the tiled kernel
    (`seam_route`'s thresholds)."""
    import torch

    from dct_carver_tpu_torch.kernels.dp_kernel import (
        BATCH_KERNEL, KERNEL, MAX_WIDTH, TILE_C, TILE_K, TILE_W, TILE_WARPS,
        _find_seams_one_cta, _find_seams_tiled, seam_route, split_forward)

    def on_dev(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    def tiled(e, width, lo=0, tie="leftmost", **kw):
        return _find_seams_tiled(e, width, lo, tie, **kw)

    log("phase 1c: geometry sweep of the tiled kernel, device ms under "
        "torch.profiler (columns a lane C, owned columns Wt, rows a block K, "
        "warp-tiles a CTA, split schedule)")
    totals, planes = {}, {}
    for i, (b, h, w) in enumerate(GEOMETRY_SHAPES):
        e = on_dev(rng.random((b, h, w), dtype=np.float32))
        for c, wt, k in GEOMETRIES:
            for warps, split in GEOMETRY_SCHEDULES:
                ms = device_ms(lambda: tiled(e, w, tile=wt, K=k, chunk=c,
                                             warps=warps, split=split), 5)
                key = (c, wt, k, warps, split)
                totals[key] = totals.get(key, 0.0) + ms
                if i < 3:
                    planes[key] = planes.get(key, 0.0) + ms
                log(f"  geometry B={b} {h}x{w} C={c} Wt={wt} K={k} "
                    f"warps={warps} split={split}: {ms!r} ms ({card})")
        del e
    for what, sums in (("the shapes", totals),
                       ("the benchmark's planes", planes)):
        log(f"  geometry sums over {what}: "
            + ", ".join(f"{k}: {v!r}" for k, v in sorted(
                sums.items(), key=lambda kv: kv[1]))
            + f"; least {min(sums, key=sums.get)}, the default is "
            f"{(TILE_C, TILE_W, TILE_K, TILE_WARPS)}, split where "
            f"split_forward says ({card})")

    log("phase 1c: split sweep, the forward's device ms under "
        "torch.profiler, one warp a tile against the split schedule")
    table = []
    shapes = [(b, HB, w) for b, w in SPLIT_BATCHES] + list(SPLIT_LONG)
    for b, h, w in shapes:
        e = on_dev(rng.random((b, h, w), dtype=np.float32))
        reps = 5 if b * w >= 65536 else 10
        one = device_ms(lambda: tiled(e, w, split=False), reps,
                        only="tile_rows")
        two = device_ms(lambda: tiled(e, w, split=True), reps,
                        only="tile_rows")
        tiles = b * -(-w // TILE_W)
        chosen = split_forward(b, w)
        faster = None if one is None or two is None else two < one
        table.append([b, h, w, tiles, one, two, chosen])
        log(f"  split B={b} {h}x{w} tiles={tiles}: one warp {one!r} ms, "
            f"split {two!r} ms; faster: split={faster}, split_forward: "
            f"{chosen}{'' if faster in (None, chosen) else ' (DIFFERS)'} "
            f"({card})")
        del e
    log("  split table (B, H, W, tiles, one-warp ms, split ms, split "
        "chosen): " + json.dumps(table))

    log("phase 1c: width sweep, find_seam.cu (its C entry, whatever the "
        "route) against the tiled kernel, device ms under torch.profiler")
    table = []
    shapes = [(1, H8 if w == W8 else SWEEP_ROWS, w) for w in SWEEP_WIDTHS]
    shapes += [(b, HB, w) for b, w in SWEEP_BATCHES]
    for b, h, w in shapes:
        e = on_dev(rng.random((b, h, w), dtype=np.float32))
        reps = 5 if b * w >= 65536 else 10
        one = (device_ms(lambda: _find_seams_one_cta(
            KERNEL if b == 1 else BATCH_KERNEL, e, w, 0, "leftmost"), reps)
            if w <= MAX_WIDTH else None)
        til = device_ms(lambda: tiled(e, w), reps)
        fwd = device_ms(lambda: tiled(e, w), reps, only="tile_rows")
        route = seam_route(b, w)
        row = {"B": b, "H": h, "W": w, "find_seam_ms": one,
               "tiled_ms": til, "tiled_forward_ms": fwd,
               "find_seam_us_a_row": None if one is None
               else one * 1e3 / h, "tiled_us_a_row": til * 1e3 / h,
               "ratio": None if one is None else one / til, "route": route}
        table.append(row)
        faster = "tiled" if one is None or til < one else "find_seam"
        log(f"  sweep B={b} {h}x{w}: find_seam.cu {one!r} ms, tiled {til!r} "
            f"ms (forward {fwd!r}, split {split_forward(b, w)}), us a row "
            f"{row['find_seam_us_a_row']!r} / {row['tiled_us_a_row']!r}, "
            f"find_seam/tiled {row['ratio']!r}; faster: {faster}, "
            f"seam_route: {route}"
            f"{'' if faster == route else ' (DIFFERS)'} ({card})")
        del e
    log("  sweep table (B, H, W, find_seam.cu ms, tiled ms, ratio, route): "
        + json.dumps([[r["B"], r["H"], r["W"], r["find_seam_ms"],
                       r["tiled_ms"], r["ratio"], r["route"]]
                      for r in table]))


def phase_3(dev, chk: Checks, card: str, rng, times: dict) -> list:
    """The batch route; returns the launch counts of its api.carve run and
    of one carve_batch of NB_TIMED images."""
    import torch
    from benchlib.work import dct_ops

    from dct_carver_tpu_torch import api, kernels
    from dct_carver_tpu_torch.kernels.apply_kernel import apply_seam
    from dct_carver_tpu_torch.kernels.dp_kernel import (
        BATCH_KERNEL, _find_seams_one_cta, find_seams, seam_route)
    from dct_carver_tpu_torch.kernels.energy_kernel import dct_energy
    from dct_carver_tpu_torch.kernels.strip_kernel import strip_update
    from dct_carver_tpu_torch.ops.carve import carve_n_seams, clear_step_cache
    from dct_carver_tpu_torch.ops.energy import to_luma
    from dct_carver_tpu_torch.parallel.mesh import carve_batch
    from dct_carver_tpu_torch.utils.graphs import CAPTURES

    edges, textures = 0.3, 0.7

    def on_dev(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    def seams_pair(case, e, widths, lo, tie="leftmost"):
        """find_seam.cu's batched launch (its C entry, whatever the route)
        and the routed find_seams against the plain version; returns the
        routed seams."""
        want = find_seams(e, widths, lo, tie=tie, use_pallas=False)
        chk.equal("find_seams", case, _find_seams_one_cta(
            BATCH_KERNEL, e, widths, lo, tie), want)
        got = find_seams(e, widths, lo, tie=tie)
        if seam_route(e.shape[0], e.shape[2]) == "tiled":
            chk.equal("find_seam_tiled", f"{case} (routed)", got, want)
        return got

    log(f"phase 3: the batch route; kernels vs plain versions on B={NB} "
        f"{HB}x{WB} planes")
    lumas = on_dev(rng.random((NB, HB, WB), dtype=np.float32))
    for n in (8, 16):
        chk.equal("energy", f"B={NB} {HB}x{WB} n={n}",
                  dct_energy(lumas, n, edges, textures),
                  dct_energy(lumas, n, edges, textures, use_pallas=False))
    E = dct_energy(lumas, 8, edges, textures)
    E_q = on_dev((rng.integers(0, 4, (NB, HB, WB)) / 4).astype(np.float32))
    # windows W, W-37, 517 and 17 wide; lo + width <= W
    widths = on_dev(np.resize([WB, WB - 37, WB // 2 + 5, 17], NB)
                    .astype(np.int32))
    los = {"lo=0": on_dev(np.zeros(NB, np.int32)),
           "lo>0": on_dev(np.resize([0, 37, WB // 2 - 12, WB - 24], NB)
                          .astype(np.int32))}
    for lo_name, lo in los.items():
        for e_name, e in (("random", E), ("quantized", E_q)):
            for tie in TIES:
                seams_pair(f"B={NB} {e_name}, widths W/W-37/{WB // 2 + 5}/17,"
                           f" {lo_name}, {tie}", e, widths, lo, tie)
    seams_pair(f"B={NB} one shared width W-5", E, WB - 5, 0)
    # per-image windows on planes narrower than a backtrack window, and
    # windows that force the seam along column 0 or the window's last column
    for h, w in ((HB, 100), (257, 130)):
        e_n = on_dev((rng.integers(0, 3, (NB, h, w)) / 2).astype(np.float32))
        wn = on_dev(np.resize([w, w - 7, 1, 2, 33, w - 1, 5, 64], NB)
                    .astype(np.int32))
        ln = on_dev(np.resize([0, 7, w - 1, 0, 50, 1, w - 5, 3], NB)
                    .astype(np.int32))
        for tie in TIES:
            seams_pair(f"B={NB} {h}x{w} per-image windows {tie}", e_n, wn, ln,
                       tie)
    e_b = torch.ones((NB, 300, WB), device=dev)
    e_b[:, :, 0] = 0
    e_b[:, :, WB - 1] = 0
    wb = on_dev(np.resize([WB, WB - 1], NB).astype(np.int32))
    for tie in TIES:
        got = seams_pair(f"B={NB} border seams {tie}", e_b, wb, 0, tie)
        want = torch.where((wb == WB) & (tie == "rightmost"), WB - 1, 0)
        chk.require(bool((got == want[:, None]).all()),
                    f"B={NB} border seams {tie}: along column 0 or W-1")
    del e_b

    seam = find_seams(E, WB)
    origcol = torch.arange(WB, dtype=torch.int32, device=dev).expand(
        NB, HB, WB).contiguous()
    got = apply_seam(lumas, origcol, E, seam, WB)
    want = apply_seam(lumas, origcol, E, seam, WB, use_pallas=False)
    for part, g, w_ in zip(("luma", "origcol", "energy"), got, want):
        chk.equal("apply", f"B={NB} after one batched seam, {part}", g, w_)
    l1, _, e1 = want
    for n in (2, 4, 16):
        chk.equal("strip", f"B={NB} after one batched seam n={n}",
                  strip_update(l1, e1.clone(), seam, n, edges, textures),
                  strip_update(l1, e1.clone(), seam, n, edges, textures,
                               use_pallas=False))
    k = strip_update(l1, e1.clone(), seam, 8, edges, textures)
    p = strip_update(l1, e1.clone(), seam, 8, edges, textures,
                     use_pallas=False)
    chk.equal("strip", f"B={NB} after one batched seam n=8", k, p)
    full = dct_energy(l1, 8, edges, textures, use_pallas=False)
    chk.equal("strip", f"B={NB} == full recompute (live columns)",
              k[..., :WB - 1].contiguous(), full[..., :WB - 1].contiguous())
    time_kernel(times, "find_seams", lambda: _find_seams_one_cta(
        BATCH_KERNEL, E, WB, 0, "leftmost"),
        lambda: find_seams(E, WB, use_pallas=False), 20, 2)
    log(f"  find_seams kernel {times['find_seams'][0]!r} ms, plain "
        f"{times['find_seams'][1]!r} ms (B={NB} x {HB}x{WB}; {card})")
    BOUNDS["find_seams"] = (NB * (4 * HB * WB + 4 * HB), 3 * NB * HB * WB)
    del lumas, E, E_q, got, want, l1, e1, k, p, full

    log(f"phase 3b: api.carve(({NB}, {HB}, {WB}, 3), -{SEAMS_B}, "
        "parallel='batch') on the card")
    imgs = rng.integers(0, 256, (NB, HB, WB, 3), dtype=np.uint8)
    kw = dict(blocksize=8, output_seams=True, output_energy=True,
              device=dev.type)
    api.carve(imgs[:2, :64, :256], -4, parallel="batch", **kw)  # warm-up
    torch.cuda.synchronize()
    kernels.reset_launches()
    res = api.carve(imgs, -SEAMS_B, parallel="batch", **kw)
    torch.cuda.synchronize()
    launches = kernels.launch_counts()
    log(f"  launches on the batch route: {launches}")
    # one launch a kernel, seam and card of the default placement
    chunks = len(batch_chunks(NB))
    want = batch_launches(NB, WB, SEAMS_B, apply=SEAMS_B, strip=SEAMS_B)
    for name, n in want.items():
        chk.require(launches[name] == n,
                    f"{name} kernel launched {n} times for {NB} images over "
                    f"{chunks} card(s)")
    chk.require(launches["energy"] == 1 + chunks,
                f"energy kernel launched {1 + chunks} times (the export once, "
                f"the first map once a card), not once an image")
    t = time.perf_counter()
    # the plain reference on one card: its ops are host-bound, and the
    # placement changes no result
    plain = api.carve(imgs, -SEAMS_B, parallel="batch", use_pallas=False,
                      devices=[dev], **kw)
    log(f"  plain path on the card: {time.perf_counter() - t!r} s ({card})")
    for field in ("image", "visibility_map", "energy_image"):
        a, b = getattr(res, field), getattr(plain, field)
        chk.require(a.shape == b.shape and np.array_equal(a, b),
                    f"batch api.carve {field} == plain path on the card")
    vm = res.visibility_map
    chk.require(res.image.shape == (NB, HB, WB - SEAMS_B, 3)
                and vm.shape == (NB, HB, WB)
                and res.energy_image.shape == (NB, HB, WB)
                and res.energy_image.dtype == np.uint8,
                "batch output shapes and types")
    chk.require(np.array_equal(np.sort(vm, axis=2)[..., WB - SEAMS_B:],
                               np.broadcast_to(np.arange(1, SEAMS_B + 1),
                                               (NB, HB, SEAMS_B))),
                "every image: one removed pixel per row per seam")
    for b in (0, NB - 1):
        one = api.carve(imgs[b], -SEAMS_B, **kw)
        chk.require(all(np.array_equal(getattr(one, f), getattr(res, f)[b])
                        for f in ("image", "visibility_map", "energy_image")),
                    f"image {b} of the batch == its single-image api.carve")
    del imgs, res, plain, vm

    log(f"phase 3c: carve_batch of {NB_TIMED} {HB}x{WB} RGB images, "
        f"{SEAMS_B} seams, n=8, reconstruct=True")
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    big = torch.randint(0, 256, (NB_TIMED, HB, WB, 3), dtype=torch.uint8,
                        device=dev, generator=gen)

    def run():
        return carve_batch(big, SEAMS_B, devices=[dev])

    # the smaller carves' cached steps would count in the peak memory; this
    # batch's sets pass CACHE_MAX_BYTES, so each carve captures its own
    clear_step_cache()
    run()
    torch.cuda.synchronize()
    kernels.reset_launches()
    captures = dict(CAPTURES)
    with count_replays() as replays:
        run()
        torch.cuda.synchronize()
    big_launches = kernels.launch_counts()
    log(f"  launches on carve_batch of {NB_TIMED}: {big_launches}")
    chk.require(replays[0] == SEAMS_B - 1,
                f"carve_batch B={NB_TIMED}: {replays[0]} graph replays for "
                f"{SEAMS_B} seams (the first seam eager)")
    log(f"  carve_batch B={NB_TIMED}: {replays[0]} replays, "
        f"{CAPTURES['graphs'] - captures['graphs']} graphs captured in "
        f"{(CAPTURES['seconds'] - captures['seconds']) * 1e3!r} ms ({card})")
    want = {**dp_launches(NB_TIMED, WB, SEAMS_B, plane=False),
            "apply": SEAMS_B, "strip": SEAMS_B}
    for name, n in want.items():
        chk.require(big_launches[name] == n,
                    f"carve_batch B={NB_TIMED}: {name} launched {n} times")
    secs = []
    for _ in range(2):
        torch.cuda.reset_peak_memory_stats(dev)
        torch.cuda.synchronize()
        t = time.perf_counter()
        out, vmaps = run()
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t)
    peak = torch.cuda.max_memory_allocated(dev)
    chk.require(out.shape == (NB_TIMED, HB, WB - SEAMS_B, 3)
                and vmaps.shape == (NB_TIMED, HB, WB)
                and bool(((vmaps > 0).sum(dim=2) == SEAMS_B).all()),
                f"carve_batch output shapes, {SEAMS_B} removed pixels a row")
    px = NB_TIMED * HB * WB * SEAMS_B
    log(f"  carve_batch B={NB_TIMED}: {secs!r} s, best "
        f"{px / min(secs) / 1e6!r} Mpix/s; peak device memory {peak} bytes "
        f"({peak / NB_TIMED / 2**20!r} MiB an image; {card})")
    del out, vmaps
    # the graphed batch carve against the eager kernel carve, and its first
    # seams against the plain path on the first images (each image is
    # carved alone: the plain path's memory grows with the batch)
    lumas = to_luma(big, stack=True)
    graphed = carve_n_seams(lumas, SEAMS_B, 8, 0.0, 1.0)
    hold_graphed(chk, f"carve_batch B={NB_TIMED} {SEAMS_B} seams", graphed,
                 eager_kernel_carve(lumas, SEAMS_B, 8, 0.0, 1.0))
    del graphed
    few = carve_n_seams(lumas, PLAIN_SEAMS_B, 8, 0.0, 1.0)
    plain = carve_n_seams(lumas[:NB].contiguous(), PLAIN_SEAMS_B, 8, 0.0,
                          1.0, use_pallas=False)
    for part in ("luma", "vmap", "energy"):
        chk.equal("carve", f"carve_batch B={NB_TIMED} {PLAIN_SEAMS_B} seams,"
                  f" images 0-{NB - 1} graphed == plain, {part}",
                  getattr(few, part)[:NB].contiguous(), getattr(plain, part))
    del few, plain
    # the energy and the strip at the batch shape, rows of their own
    e_b = dct_energy(lumas, 8, edges, textures)
    seam_b = find_seams(e_b, WB)
    rows, sw = NB_TIMED * HB, 20
    BATCH.update({
        "energy": (device_reading(
            lambda: dct_energy(lumas, 8, edges, textures), 3),
                   bound(8 * rows * WB, dct_ops(8, rows * WB, rows * WB))),
        "strip": (device_reading(lambda: strip_update(
            lumas, e_b, seam_b, 8, edges, textures), 10),
                  bound(4 * (rows * (sw + 7) + rows * sw + rows),
                        dct_ops(8, rows * sw, rows * (sw + 7)))),
    })
    for name, ((d_ms, src), (b_ms, b_by)) in BATCH.items():
        log(f"  {name} at B={NB_TIMED} x {HB}x{WB} n=8: device {d_ms!r} ms "
            f"({src}), bound {b_ms!r} ms ({b_by}) ({card})")
    del lumas, e_b, seam_b

    wall, kernel_us, top, busy_us = device_profile(run, top=10)
    log(f"  profiled carve_batch: wall {wall * 1e3!r} ms, device busy "
        f"{busy_us / 1e3!r} ms ({100 * busy_us / 1e6 / wall!r} % of wall; "
        f"kernel time summed {kernel_us / 1e3!r} ms; {card})")
    for name, us, count in top:
        log(f"    {us / 1e3:10.4f} ms  {count:5d} x  {name[:90]}")

    return [launches, big_launches]


def phase_2d(dev, chk: Checks, card: str, rng, img, res, plain) -> list:
    """The interactive retargeter and the browser UI on the card, on phase
    2's image, its kernel carve `res` and its plain carve `plain`; returns
    the launch counts of the main-path runs (the 384-seam precompute, the
    vertical one and the grad_norm one)."""
    import io
    import json as _json
    import os
    import statistics
    import tempfile
    import threading
    import urllib.error
    import urllib.request

    import torch
    from PIL import Image

    from dct_carver_tpu_torch import api, kernels
    from dct_carver_tpu_torch.models.carver import Carver
    from dct_carver_tpu_torch.models.retarget import InteractiveRetargeter
    from dct_carver_tpu_torch.ops.carve import carve_n_seams, clear_step_cache
    from dct_carver_tpu_torch.ops.energy import to_luma
    from dct_carver_tpu_torch.ui import server
    from dct_carver_tpu_torch.utils.debug import debug_mode
    from dct_carver_tpu_torch.utils.image import seam_overlay
    from dct_carver_tpu_torch.utils.profiling import profile_carve

    def same(a, b, what):
        chk.require(a.shape == b.shape and a.dtype == b.dtype
                    and np.array_equal(a, b), what)

    def precompute(what, n, want, replays_want, **kw):
        """A retargeter over `img` with `n` seams, its launches and graph
        replays counted from 0 and checked; (retargeter, launches, s)."""
        kernels.reset_launches()
        with count_replays() as replays:
            torch.cuda.synchronize()
            t = time.perf_counter()
            rt = InteractiveRetargeter(img, n, device="cuda", **kw)
            torch.cuda.synchronize()
            sec = time.perf_counter() - t
        got = kernels.launch_counts()
        sub = {k: got[k] for k in want}
        chk.require(sub == want, f"{what}: launches {sub}")
        chk.require(replays[0] == replays_want,
                    f"{what}: {replays[0]} graph replays (want "
                    f"{replays_want})")
        return rt, got, sec

    def dct_launches(width, n):
        return {**dp_launches(1, width, n), "energy": 1, "apply": n,
                "strip": n, "strip_gather": 0, "strip_scatter": 0,
                "band_energy": 0}

    log(f"phase 2d: InteractiveRetargeter({H}x{W}x3, {RT_SEAMS}) on the "
        "card, its slides against api.carve, and the browser UI")
    t_phase = time.perf_counter()
    clear_step_cache()
    rt, launches, first_s = precompute(
        f"{RT_SEAMS}-seam precompute (first)", RT_SEAMS,
        dct_launches(W, RT_SEAMS), RT_SEAMS - 1)
    rt, _, warm_s = precompute(
        f"{RT_SEAMS}-seam precompute (warm)", RT_SEAMS,
        dct_launches(W, RT_SEAMS), RT_SEAMS)
    runs = [launches]
    vm = rt.visibility_map
    same(np.where(vm <= SEAMS, vm, 0), plain.visibility_map,
         f"retargeter vmap masked to <= {SEAMS} == phase 2's plain vmap")
    same(rt.at_width(W - SEAMS), plain.image,
         f"at_width(W - {SEAMS}) == phase 2's plain image")
    same(rt.at_width(W - SEAMS), res.image,
         f"at_width(W - {SEAMS}) == phase 2's kernel image")
    same(rt.at_width(W), img, "at_width(W) == the image")
    for s in (-1, -RT_SEAMS // 2, -RT_SEAMS, 1, SEAMS, RT_SEAMS):
        same(rt.at_width(W + s), api.carve(img, s, device="cuda").image,
             f"at_width(W {s:+d}) == api.carve({s:+d}) on the card")

    # the retargeter keeps its vmap for its whole life: a later carve of
    # the same step key (one more image) must not write into it
    before = rt.visibility_map
    other = rng.integers(0, 256, (H, W, 3), dtype=np.uint8)
    api.carve(other, -RT_SEAMS, device="cuda")
    carve_n_seams(to_luma(torch.from_numpy(other).to(dev)), RT_SEAMS, 8, 0.0,
                  1.0)
    torch.cuda.synchronize()
    same(rt.visibility_map, before,
         "retargeter vmap unchanged by two later carves of its step key")

    for what, kw, width, ss, want in (
            ("vertical", dict(vertical=True), H, (-RT_SIDE, RT_SIDE // 2),
             dct_launches(H, RT_SIDE)),
            ("grad_norm", dict(energy="grad_norm"), W,
             (-RT_SIDE, 3 * RT_SIDE // 4),
             {**dp_launches(1, W, RT_SIDE), "apply": RT_SIDE,
              "strip_gather": RT_SIDE, "strip_scatter": RT_SIDE,
              "energy": 0, "strip": 0, "band_energy": 0})):
        clear_step_cache()
        other_rt, launches, sec = precompute(
            f"{what} {RT_SIDE}-seam precompute", RT_SIDE, want, RT_SIDE - 1,
            **kw)
        runs.append(launches)
        carve_kw = ({"vertically": True} if kw.get("vertical")
                    else {"energy": "grad_norm"})
        for s in ss:
            same(other_rt.at_width(width + s),
                 api.carve(img, s, device="cuda", **carve_kw).image,
                 f"{what} retargeter at_width({width} {s:+d}) == "
                 "api.carve on the card")
        log(f"  {what} {RT_SIDE}-seam precompute: {sec * 1e3!r} ms, the "
            f"capture included ({card})")

    # timing: the precompute, the slides and the UI's round trip
    def median_ms(fn, reps):
        fn()
        walls = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t = time.perf_counter()
            fn()
            walls.append((time.perf_counter() - t) * 1e3)
        return statistics.median(walls), min(walls), max(walls)

    slide = {s: median_ms(lambda s=s: rt.at_width(W + s), RT_REPS)
             for s in (-RT_SEAMS // 2, RT_SEAMS // 2)}
    log(f"  {RT_SEAMS}-seam precompute of {H}x{W}x3 n=8: first "
        f"{first_s * 1e3!r} ms (capture included), warm {warm_s * 1e3!r} ms "
        f"({card})")
    for s, (med, lo, hi) in slide.items():
        log(f"  at_width(W {s:+d}), host result included: median {med!r} ms "
            f"of {RT_REPS} (min {lo!r}, max {hi!r}) ({card})")

    # the UI over a socket, every endpoint against the in-process result
    def png(data):
        return np.asarray(Image.open(io.BytesIO(data)))

    def request(base, path, body=None):
        data = None if body is None else _json.dumps(body).encode()
        req = urllib.request.Request(
            base + path, data=data, method="GET" if body is None else "POST")
        try:
            with urllib.request.urlopen(req, timeout=300) as r:
                return r.status, r.read()
        except urllib.error.HTTPError as e:
            return e.code, e.read()

    old_state_dir = os.environ.get("DCT_CARVER_STATE_DIR")
    with tempfile.TemporaryDirectory(prefix="dct_carver_smoke_") as tmp:
        os.environ["DCT_CARVER_STATE_DIR"] = os.path.join(tmp, "state")
        app = server.CarverApp(img, device="cuda")
        srv = server.make_server(app, "127.0.0.1", 0)
        thread = threading.Thread(target=srv.serve_forever, daemon=True)
        thread.start()
        base = "http://%s:%d" % srv.server_address
        try:
            status, body = request(base, "/api/meta")
            chk.require(status == 200 and _json.loads(body) == app.meta(),
                        "UI /api/meta == CarverApp.meta()")
            status, body = request(base, "/image.png")
            same(png(body), img, "UI /image.png == the image")
            status, body = request(base, "/preview.png?blocksize=8&"
                                         "slider=1.0")
            same(png(body), Carver(img, blocksize=8, device="cuda")
                 .energy_preview(), "UI /preview.png == Carver.energy_"
                                    "preview on the card")
            status, _ = request(base, "/resize.png?delta=-3")
            chk.require(status == 409, "UI /resize.png before a precompute:"
                                       f" {status} (want 409)")
            status, body = request(base, "/api/precompute", {
                "max_seams": RT_SEAMS, "blocksize": 8, "slider": 1.0,
                "vertical": False})
            chk.require(status == 200 and _json.loads(body)["max_seams"]
                        == RT_SEAMS, "UI /api/precompute")
            for delta, s in ((-RT_SEAMS // 2, -RT_SEAMS // 2), (0, 0),
                             (RT_SEAMS, RT_SEAMS), (-10**6, -RT_SEAMS),
                             (10**6, RT_SEAMS)):
                status, body = request(base, f"/resize.png?delta={delta}")
                same(png(body), rt.at_width(W + s),
                     f"UI /resize.png?delta={delta} == at_width(W {s:+d})")
            status, body = request(base, "/api/carve", {
                "seams_number": -SEAMS, "blocksize": 8, "slider": 1.0,
                "output_energy": True, "output_seams": True})
            urls = _json.loads(body)["urls"] if status == 200 else {}
            chk.require(set(urls) == {"result", "energy", "seams"},
                        f"UI /api/carve: {status} {sorted(urls)}")
            for name, want in (("result", res.image),
                               ("energy", res.energy_image),
                               ("seams", seam_overlay(img,
                                                      res.visibility_map))):
                status, body = request(base, f"/out/{name}.png")
                same(png(body), want, f"UI /out/{name}.png == phase 2's "
                                      "kernel carve")
            status, _ = request(base, "/nope")
            chk.require(status == 404, f"UI /nope: {status} (want 404)")
            trips = {d: median_ms(lambda d=d: request(
                base, f"/resize.png?delta={d}"), UI_REPS)
                for d in (-RT_SEAMS // 2, RT_SEAMS // 2)}
            enc = median_ms(lambda: server._png_bytes(rt.at_width(
                W - RT_SEAMS // 2)), UI_REPS)
        finally:
            srv.shutdown()
            srv.server_close()
            thread.join(timeout=60)
            if old_state_dir is None:
                os.environ.pop("DCT_CARVER_STATE_DIR", None)
            else:
                os.environ["DCT_CARVER_STATE_DIR"] = old_state_dir
    chk.require(not thread.is_alive(), "UI server thread stopped")
    for d, (med, lo, hi) in trips.items():
        log(f"  UI /resize.png?delta={d:+d} round trip: median {med!r} ms of "
            f"{UI_REPS} (min {lo!r}, max {hi!r}) ({card})")
    log(f"  of which at_width(W - {RT_SEAMS // 2}) + PNG encode on the host:"
        f" median {enc[0]!r} ms ({card})")

    # debug modes: every seam step eager (no replay), the kernels still
    # launching; NaN checks on the card
    x = to_luma(torch.from_numpy(img).to(dev))
    graphed = carve_n_seams(x, SEAMS, 8, 0.0, 1.0)
    kernels.reset_launches()
    with count_replays() as replays, debug_mode(nan_checks=False,
                                                disable_jit=True):
        eager = carve_n_seams(x, SEAMS, 8, 0.0, 1.0)
        torch.cuda.synchronize()
    got = kernels.launch_counts()
    chk.require(replays[0] == 0 and got["apply"] == SEAMS
                and got["strip"] == SEAMS,
                f"debug_mode(disable_jit=True) carve: {replays[0]} replays, "
                f"apply {got['apply']}, strip {got['strip']} launches")
    hold_graphed(chk, f"debug_mode(disable_jit=True) {SEAMS} seams", graphed,
                 (eager.luma, eager.vmap, eager.energy))
    with debug_mode():
        checked = carve_n_seams(x, 8, 8, 0.0, 1.0)
        z = torch.zeros(4, device=dev)
        try:
            z / z
            raised = False
        except FloatingPointError:
            raised = True
    chk.require(raised, "debug_mode(): x / x on the card raises")
    chk.equal("carve", "debug_mode() 8 seams (checked every seam) vmap",
              checked.vmap, carve_n_seams(x, 8, 8, 0.0, 1.0).vmap)

    for _ in range(4):  # a trace that comes back empty is taken again
        with tempfile.TemporaryDirectory(prefix="dct_carver_trace_") as tmp:
            traced = profile_carve(x.cpu().numpy(), 16, 8, log_dir=tmp)
            files = os.listdir(tmp)
            kernels_traced = 0
            if len(files) == 1:
                with open(os.path.join(tmp, files[0])) as f:
                    kernels_traced = sum(e.get("cat") == "kernel" for e in
                                         _json.load(f)["traceEvents"])
        if kernels_traced:
            break
    chk.require(len(files) == 1 and kernels_traced > 0,
                f"profile_carve wrote {files} with {kernels_traced} kernel "
                "events")
    chk.equal("carve", "profile_carve 16 seams vmap", traced.vmap,
              carve_n_seams(x, 16, 8, 0.0, 1.0).vmap)
    log(f"  phase 2d took {time.perf_counter() - t_phase!r} s")
    return runs


# the band kernel's (#13) readings at every blocksize on the band_lumas
# planes ({"<plane> n=<n>": {...}}, phase 4a)
BAND: dict = {}


def band_lumas(dev) -> list:
    """(name, luma) of the band kernel's planes, made on the card from
    SEED, the same in every process: the 1080p plane and stacks of NB and
    NB_TIMED HBxWB images."""
    import torch

    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 13)
    return [(name, torch.rand(shape, device=dev, generator=gen))
            for name, shape in ((f"{H}x{W}", (H, W)),
                                (f"B={NB} {HB}x{WB}", (NB, HB, WB)),
                                (f"B={NB_TIMED} {HB}x{WB}",
                                 (NB_TIMED, HB, WB)))]


def walk_seams(luma, delta_x: int):
    """One seam a row of each image of `luma` (..., H, W), from the middle
    column, moving at most delta_x columns a row: (..., H) int32 on its
    device."""
    import torch

    rng = np.random.default_rng(SEED + delta_x)
    W_ = luma.shape[-1]
    steps = rng.integers(-delta_x, delta_x + 1, tuple(luma.shape[:-1]))
    seam = np.clip(W_ // 2 + np.cumsum(steps, axis=-1), 0, W_ - 1)
    return torch.from_numpy(seam.astype(np.int32)).to(luma.device)


def band_bound(n: int, rows: int, C: int) -> tuple[float, str]:
    """The bound of band_energy on (rows, n, C) bands: each band float read
    and each output written once, and the chains with shared vertical
    chains (dct_ops)."""
    from benchlib.work import dct_ops

    cout = C - n + 1
    return bound(4 * rows * (n * C + cout), dct_ops(n, rows * cout, rows * C))


def band_times(lumas, edges, textures) -> dict:
    """band_energy at every blocksize on the `lumas` planes (bands
    gathered for delta_x = 1), and strip.cu (strip_update) at n=8 on the
    same planes and seams: device ms a call, its source, back-to-back ms
    between CUDA events, and the bound."""
    import torch
    from benchlib.work import dct_ops

    from dct_carver_tpu_torch.kernels.strip_kernel import (
        band_energy, strip_gather, strip_update)

    out = {}
    for name, luma in lumas:
        seam = walk_seams(luma, 1)
        reps = 200 if luma.numel() < 2**25 else 10
        calls = {}
        for n in (2, 4, 8, 16):
            bands = strip_gather(luma, seam, n)
            C = bands.shape[-1]
            calls[f"{name} n={n}"] = (
                functools.partial(band_energy, bands, n, edges, textures),
                band_bound(n, bands.numel() // (n * C), C))
        energy = torch.zeros_like(luma)
        rows = luma.numel() // luma.shape[-1]
        calls[f"{name} strip n=8"] = (  # as phase 3c's bound
            functools.partial(strip_update, luma, energy, seam, 8, edges,
                              textures),
            bound(4 * rows * (27 + 20 + 1), dct_ops(8, rows * 20, rows * 27)))
        for key, (fn, (b_ms, b_by)) in calls.items():
            d_ms, src = device_reading(fn, reps)
            out[key] = {"device_ms": d_ms, "device_ms_source": src,
                        "ms": cuda_ms(fn, reps), "bound_ms": b_ms,
                        "bound_by": b_by}
        del calls, energy
        torch.cuda.empty_cache()
    return out


def phase_4a(dev, chk: Checks, card: str, rng, times: dict) -> None:
    """The plugged-energy strip kernels against their plain versions, and
    gather -> band_energy -> scatter against strip.cu; band_energy at every
    blocksize and delta_x on the band_lumas planes and on full-row bands,
    and its times there (band_times, into BAND and BATCH)."""
    import torch
    from benchlib.work import dct_ops

    from dct_carver_tpu_torch.kernels.apply_kernel import apply_seam
    from dct_carver_tpu_torch.kernels.dp_kernel import find_seam, find_seams
    from dct_carver_tpu_torch.kernels.energy_kernel import dct_energy
    from dct_carver_tpu_torch.kernels.strip_kernel import (
        band_energy, strip_gather, strip_scatter, strip_update)
    from dct_carver_tpu_torch.ops.dct import rows_to_bands
    from dct_carver_tpu_torch.ops.energy_fn import GRAD_NORM
    from dct_carver_tpu_torch.ops.strip import _strip_extent

    # the floor, taken beside the strip kernels' own times so that both
    # find the card in the same state (right after the build it read above
    # the 1080p gather's own time)
    FLOOR.update(kernel_floor(card))
    edges, textures = 0.3, 0.7

    def on_dev(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    def after_one_seam(x, e):
        """(compacted luma, compacted energy, seam) after one seam."""
        w = x.shape[-1]
        seam = (find_seams if x.ndim == 3 else find_seam)(e, w)
        l1, _, e1 = apply_seam(x, torch.zeros_like(x, dtype=torch.int32), e,
                               seam, w)
        return l1, e1, seam

    log("phase 4a: plugged-energy strip kernels vs plain versions on the "
        f"card ({H}x{W}, B={NB} {HB}x{WB})")
    planes = (f"{H}x{W}", on_dev(rng.random((H, W), dtype=np.float32))), \
        (f"B={NB} {HB}x{WB}", on_dev(rng.random((NB, HB, WB),
                                                dtype=np.float32)))
    main_shapes = None
    for name, x in planes:
        l1, e1, seam = after_one_seam(x, GRAD_NORM.energy_map(x))
        if main_shapes is None:
            main_shapes = (l1, e1, seam)
        for n in (2, 4):
            chk.equal("strip_gather", f"{name} n={n}",
                      strip_gather(l1, seam, n),
                      strip_gather(l1, seam, n, use_pallas=False))
            strip_w = _strip_extent(n)[1]
            strip = torch.rand((*seam.shape, strip_w), device=dev)
            chk.equal("strip_scatter", f"{name} n={n}",
                      strip_scatter(e1.clone(), strip, seam, n),
                      strip_scatter(e1.clone(), strip, seam, n,
                                    use_pallas=False))
        for n in (8, 16):
            l1, e1, seam = after_one_seam(x, dct_energy(x, n, edges,
                                                        textures))
            composed = strip_scatter(
                e1.clone(), band_energy(strip_gather(l1, seam, n), n, edges,
                                        textures), seam, n)
            chk.equal("band_energy",
                      f"{name} n={n} gather+band+scatter == strip.cu",
                      composed,
                      strip_update(l1, e1.clone(), seam, n, edges, textures))

    # band_energy on gathered bands at every blocksize and delta_x on the
    # 1080p plane and both stacks (at n = 16 and delta_x = 4 a 99-column
    # band row is two tiles of 42 outputs), and on full-row bands (C = W)
    lumas = band_lumas(dev)
    for name, luma in lumas:
        for dx in (1, 2, 4):
            seam = walk_seams(luma, dx)
            for n in (2, 4, 8, 16):
                bands = strip_gather(luma, seam, n, delta_x=dx)
                chk.equal("band_energy",
                          f"{name} n={n} delta_x={dx} (C={bands.shape[-1]})",
                          band_energy(bands, n, edges, textures),
                          band_energy(bands, n, edges, textures,
                                      use_pallas=False))
                del bands
    # full-row bands of the whole plane (one lane an output) and of its
    # first 8 rows (n lanes an output: teams of up to 1024 threads, several
    # tiles a row, at n = 16 30 tiles of 64 outputs)
    x = lumas[0][1]
    for n in (2, 4, 8, 16):
        bands = rows_to_bands(x, n)[..., :W].contiguous()
        for rows in (H, 8):
            chk.equal("band_energy",
                      f"{H}x{W} n={n} full-row bands of {rows} rows (C={W})",
                      band_energy(bands[:rows], n, edges, textures),
                      band_energy(bands[:rows], n, edges, textures,
                                  use_pallas=False))
    del bands
    torch.cuda.empty_cache()
    # its times at every blocksize on the 1080p plane and the 256-image
    # stack, each beside its bound and the floor
    BAND.update(band_times(lumas, edges, textures))
    del lumas, x
    torch.cuda.empty_cache()
    for key, r in BAND.items():
        log(f"  band {key:24s} device {r['device_ms']!r} ms "
            f"({r['device_ms_source']}), back to back {r['ms']!r} ms, bound "
            f"{r['bound_ms']!r} ms ({r['bound_by']}), floor "
            f"{FLOOR['back_to_back']!r} ms ({card})")
    stack8 = BAND[f"B={NB_TIMED} {HB}x{WB} n=8"]
    BATCH["band_energy"] = ((stack8["device_ms"], stack8["device_ms_source"]),
                            (stack8["bound_ms"], stack8["bound_by"]))

    # times at the main path's shapes: 1080p, grad_norm's n=2 (band_energy:
    # n=8, the DCT headline's blocksize, beside strip.cu)
    l1, e1, seam = main_shapes
    strip2 = GRAD_NORM.bands_fn(strip_gather(l1, seam, 2).reshape(
        -1, 2, _strip_extent(2)[1] + 1)).reshape(H, -1).contiguous()
    bands8 = strip_gather(l1, seam, 8)
    e_s = e1.clone()
    time_kernel(times, "strip_gather", lambda: strip_gather(l1, seam, 2),
                lambda: strip_gather(l1, seam, 2, use_pallas=False), 50, 20)
    time_kernel(times, "strip_scatter",
                lambda: strip_scatter(e_s, strip2, seam, 2),
                lambda: strip_scatter(e_s, strip2, seam, 2,
                                      use_pallas=False), 50, 20)
    time_kernel(times, "band_energy",
                lambda: band_energy(bands8, 8, edges, textures),
                lambda: band_energy(bands8, 8, edges, textures,
                                    use_pallas=False), 50, 10)
    for name in ("strip_gather", "strip_scatter", "band_energy"):
        k_ms, p_ms = times[name]
        shape = "n=8 bands" if name == "band_energy" else "n=2"
        log(f"  {name:13s} kernel {k_ms!r} ms, plain {p_ms!r} ms "
            f"({H}x{W} {shape}; {card})")
    sw2 = _strip_extent(2)[1]
    BOUNDS.update({
        "strip_gather": (4 * (H * (sw2 + 1) + H * 2 * (sw2 + 1) + H), 0),
        "strip_scatter": (4 * (2 * H * sw2 + H), 0),
        "band_energy": (4 * (H * 8 * 27 + H * 20), dct_ops(8, H * 20, H * 27)),
    })
    # the gather as one torch.take, the scatter as one scatter_
    band_idx = ((torch.arange(H, device=dev)[:, None, None]
                 + torch.arange(2, device=dev)[:, None]).clamp(max=H - 1) * W
                + (seam.long().sub(3).clamp(0, W - sw2)[:, None, None]
                   + torch.arange(sw2 + 1, device=dev)).clamp(max=W - 1))
    time_library("strip_gather", lambda: torch.take(l1, band_idx))
    scatter_idx = (seam.long().sub(3).clamp(0, W - sw2)[:, None]
                   + torch.arange(sw2, device=dev))
    time_library("strip_scatter",
                 lambda: e_s.scatter_(-1, scatter_idx, strip2))
    composed = cuda_ms(lambda: strip_scatter(
        e_s, band_energy(strip_gather(l1, seam, 8), 8, edges, textures),
        seam, 8), 50)
    fused = cuda_ms(lambda: strip_update(l1, e_s, seam, 8, edges, textures),
                    50)
    log(f"  n=8 strip as gather+band_energy+scatter {composed!r} ms, as "
        f"strip.cu {fused!r} ms ({H}x{W}; {card})")


def phase_4(dev, chk: Checks, card: str, rng, dct_rate: float) -> list:
    """Plugged energies through the public API, the batch route and the CLI;
    returns the launch counts of the main-path runs (4b's grad_norm carve,
    4c's batch carve)."""
    import os
    import tempfile

    import torch

    from dct_carver_tpu_torch import api, cli, kernels
    from dct_carver_tpu_torch.models.carver import Carver
    from dct_carver_tpu_torch.ops.carve import carve_n_seams, clear_step_cache
    from dct_carver_tpu_torch.ops.energy import to_luma
    from dct_carver_tpu_torch.ops.energy_fn import (builtin_energy,
                                                    custom_energy)
    from dct_carver_tpu_torch.utils import checkpoint
    from dct_carver_tpu_torch.utils.graphs import CAPTURES
    from dct_carver_tpu_torch.utils.image import load_image, save_image

    def on_dev(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    def require_launches(launches, want, what):
        got = {k: launches[k] for k in want}
        chk.require(got == want, f"{what}: launches {got}")

    def same(a, b, what):
        chk.require(a.shape == b.shape and np.array_equal(a, b), what)

    # a radius-2 window energy: the mean absolute deviation from the pixel
    absdev = custom_energy(
        2, lambda w: torch.sum(torch.abs(w - w[1, 1])), name="absdev")
    on_path = {**dp_launches(1, W, SEAMS), "apply": SEAMS,
               "strip_gather": SEAMS, "strip_scatter": SEAMS, "energy": 0,
               "strip": 0, "band_energy": 0}
    kw = dict(output_seams=True, output_energy=True, device=dev.type)

    log(f"phase 4b: api.carve({H}x{W}x3, -{SEAMS}, energy=...) on the card")
    img = rng.integers(0, 256, (H, W, 3), dtype=np.uint8)
    main_launches = []
    for energy in (*ENERGIES, absdev):
        label = getattr(energy, "name", energy)
        api.carve(img[:64, :256], -4, energy=energy, **kw)  # warm-up
        torch.cuda.synchronize()
        kernels.reset_launches()
        with count_replays() as replays:
            res = api.carve(img, -SEAMS, energy=energy, **kw)
            torch.cuda.synchronize()
        launches = kernels.launch_counts()
        require_launches(launches, on_path, f"{label} {SEAMS}-seam carve")
        chk.require(replays[0] == SEAMS - 1,
                    f"{label} {SEAMS}-seam carve: {replays[0]} graph replays "
                    "(the first seam eager)")
        if energy == "grad_norm":
            main_launches.append(launches)
        seams = SEAMS if energy == "grad_norm" else PLAIN_SEAMS_E
        if seams != SEAMS:
            res = api.carve(img, -seams, energy=energy, **kw)
        t = time.perf_counter()
        plain = api.carve(img, -seams, energy=energy, use_pallas=False, **kw)
        log(f"  {label}: plain path of {seams} seams {time.perf_counter() - t!r}"
            f" s ({card})")
        for field in ("image", "visibility_map", "energy_image"):
            same(getattr(res, field), getattr(plain, field),
                 f"{label} {seams}-seam api.carve {field} == plain path")

    luma = to_luma(on_dev(img))
    fn = builtin_energy("grad_norm")
    hold_graphed(chk, f"grad_norm {H}x{W} {SEAMS} seams",
                 carve_n_seams(luma, SEAMS, 8, 0.0, 1.0, energy_fn=fn),
                 eager_kernel_carve(luma, SEAMS, 8, 0.0, 1.0, energy_fn=fn),
                 carve_n_seams(luma, SEAMS, 8, 0.0, 1.0, energy_fn=fn,
                               use_pallas=False))
    live = W - PLAIN_SEAMS_E
    for energy in ENERGIES:
        fn = builtin_energy(energy)
        k = carve_n_seams(luma, PLAIN_SEAMS_E, 8, 0.0, 1.0, energy_fn=fn)
        p = carve_n_seams(luma, PLAIN_SEAMS_E, 8, 0.0, 1.0, energy_fn=fn,
                          use_pallas=False)
        f = carve_n_seams(luma, PLAIN_SEAMS_E, 8, 0.0, 1.0, energy_fn=fn,
                          strip_update=False)
        chk.equal("carve", f"{energy} live energy, kernels == plain",
                  k.energy[:, :live].contiguous(),
                  p.energy[:, :live].contiguous())
        chk.equal("carve", f"{energy} live energy, strip == full",
                  k.energy[:, :live].contiguous(),
                  f.energy[:, :live].contiguous())
        chk.equal("carve", f"{energy} vmap, strip == full", k.vmap, f.vmap)
    k = carve_n_seams(luma, PLAIN_SEAMS_E, 8, 0.0, 1.0, energy_fn=absdev)
    f = carve_n_seams(luma, PLAIN_SEAMS_E, 8, 0.0, 1.0, energy_fn=absdev,
                      strip_update=False)
    chk.equal("carve", "absdev vmap, strip == full", k.vmap, f.vmap)
    diff = (k.energy[:, :live] - f.energy[:, :live]).abs().max().item()
    log(f"  absdev live energy, strip vs full: max_abs_err={diff!r} "
        "(a window reduction; held by its vmaps)")

    def walls(fn, repeats: int) -> list:
        """Wall seconds of `repeats` carves of fresh images, the first with
        an empty step cache (its capture included)."""
        clear_step_cache()
        secs = []
        for _ in range(repeats):
            x = to_luma(on_dev(rng.integers(0, 256, (H, W, 3),
                                            dtype=np.uint8)))
            torch.cuda.synchronize()
            t = time.perf_counter()
            carve_n_seams(x, SEAMS, 8, 0.0, 1.0, energy_fn=fn)
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t)
        return secs

    for energy in ENERGIES:
        captures = CAPTURES["seconds"]
        secs = walls(builtin_energy(energy), 4)
        warm = [H * W * SEAMS / t / 1e6 for t in secs[1:]]
        log(f"  carve {H}x{W} {energy} {SEAMS} seams: kernel path, first "
            f"carve {secs[0] * 1e3!r} ms wall (capture "
            f"{(CAPTURES['seconds'] - captures) * 1e3!r} ms included), warm "
            f"{warm!r} Mpix/s; DCT n=8 headline {dct_rate!r} Mpix/s "
            f"({card})")

    # where the time of a plugged-energy carve goes, by kernel
    log_event_busy("grad_norm carve (warm)", lambda: carve_n_seams(
        luma, SEAMS, 8, 0.0, 1.0, energy_fn=builtin_energy("grad_norm")),
        dev, card)
    wall, kernel_us, rows, busy_us = device_profile(lambda: carve_n_seams(
        luma, SEAMS, 8, 0.0, 1.0, energy_fn=builtin_energy("grad_norm")),
        top=None, gaps="profiled grad_norm carve")
    log(f"  profiled grad_norm carve (warm: a replay every seam): wall "
        f"{wall * 1e3!r} ms, device busy {busy_us / 1e3!r} ms "
        f"({100 * busy_us / 1e6 / wall!r} % of wall; kernel time summed "
        f"{kernel_us / 1e3!r} ms; {card})")
    wall_d, _, _, busy_d = device_profile(lambda: carve_n_seams(
        luma, SEAMS, 8, 0.0, 1.0, energy_fn=builtin_energy("grad_norm")),
        host=False, gaps="grad_norm carve, device traced alone")
    log(f"  grad_norm carve with the device traced alone: wall "
        f"{wall_d * 1e3!r} ms, device busy {busy_d / 1e3!r} ms "
        f"({100 * busy_d / 1e6 / wall_d!r} % of wall; {card})")
    for name, us, count in rows[:12]:
        log(f"    {us / 1e3:10.4f} ms  {count:5d} x  {name[:90]}")
    # the strip gather and scatter as nodes of the replayed graphs
    for kernel in ("strip_gather", "strip_scatter"):
        hits = [(us, count) for name, us, count in rows
                if f"{kernel}_kernel" in name]
        chk.require(len(hits) == 1 and hits[0][1] == SEAMS,
                    f"the profiler times {kernel} in the graphed carve, "
                    f"{SEAMS} calls: {hits}")
        if hits:
            IN_GRAPH[kernel] = hits[0][0] / 1e3 / hits[0][1]
            log(f"  {kernel} in the graphed carve: {IN_GRAPH[kernel]!r} ms "
                f"a call; back to back {DEVICE[kernel]!r}; kernel floor "
                f"{FLOOR['back_to_back']!r} back to back, "
                f"{FLOOR['in_graph']!r} in a graph ({card})")

    log(f"phase 4c: api.carve(({NB}, {HB}, {WB}, 3), -{SEAMS_BE}, "
        "parallel='batch', energy='grad_norm')")
    imgs = rng.integers(0, 256, (NB, HB, WB, 3), dtype=np.uint8)
    api.carve(imgs[:2, :64, :256], -4, parallel="batch", energy="grad_norm",
              **kw)
    torch.cuda.synchronize()
    kernels.reset_launches()
    res = api.carve(imgs, -SEAMS_BE, parallel="batch", energy="grad_norm",
                    **kw)
    torch.cuda.synchronize()
    launches = kernels.launch_counts()
    main_launches.append(launches)
    require_launches(launches, {
        **batch_launches(NB, WB, SEAMS_BE, apply=SEAMS_BE,
                         strip_gather=SEAMS_BE, strip_scatter=SEAMS_BE),
        "energy": 0, "strip": 0},
        f"batch {SEAMS_BE}-seam carve of {NB} images over "
        f"{len(batch_chunks(NB))} card(s)")
    singles = []
    for b in range(NB):
        one = api.carve(imgs[b], -SEAMS_BE, energy="grad_norm", **kw)
        singles.append(one.image)
        for field in ("image", "visibility_map", "energy_image"):
            same(getattr(res, field)[b], getattr(one, field),
                 f"batch image {b} {field} == single-image route")

    log("phase 4d: the CLI in-process on the card")
    saved = []
    real_save = checkpoint.save_state
    old_state_dir = os.environ.get("DCT_CARVER_STATE_DIR")
    try:
        with tempfile.TemporaryDirectory(prefix="dct_carver_smoke_") as tmp:
            os.environ["DCT_CARVER_STATE_DIR"] = os.path.join(tmp, "state")
            inp, out, res_out = (os.path.join(tmp, f)
                                 for f in ("in.ppm", "out.ppm", "res.ppm"))
            ck, ck_half = (os.path.join(tmp, f)
                           for f in ("ck.npz", "ck_half.npz"))
            save_image(inp, img)

            def save_and_keep(path, state, config, done, total):
                # keep the half-way snapshot, as an interruption would
                real_save(path, state, config, done, total)
                saved.append(done)
                if done == SEAMS // 2:
                    real_save(ck_half, state, config, done, total)

            checkpoint.save_state = save_and_keep
            knobs = ["--seams", f"-{SEAMS}", "--energy", "grad_sumabs"]
            kernels.reset_launches()
            every = SEAMS // 4
            rc = cli.main(["carve", inp, out, *knobs, "--checkpoint", ck,
                           "--checkpoint-every", str(every), "--progress"])
            torch.cuda.synchronize()
            checkpoint.save_state = real_save
            launches = kernels.launch_counts()
            chk.require(rc == 0 and saved == [every * k for k in (1, 2, 3, 4)],
                        f"CLI carve with checkpoints: rc {rc}, saved {saved}")
            require_launches(launches, on_path, "CLI carve")
            want = api.carve(img, -SEAMS, energy="grad_sumabs",
                             device=dev.type).image
            same(load_image(out), want, "CLI carve == api.carve")
            kernels.reset_launches()
            rc = cli.main(["carve", inp, res_out, *knobs, "--resume",
                           ck_half])
            torch.cuda.synchronize()
            require_launches(kernels.launch_counts(),
                             {k: v // 2 for k, v in on_path.items()},
                             f"CLI resume from the {SEAMS // 2}-seam "
                             "checkpoint")
            chk.require(rc == 0, f"CLI resume rc {rc}")
            same(load_image(res_out), load_image(out),
                 "CLI resume == uninterrupted CLI carve")

            e_out = os.path.join(tmp, "energy.pgm")
            rc = cli.main(["energy", inp, e_out, "--energy", "grad_norm"])
            chk.require(rc == 0, f"CLI energy rc {rc}")
            same(load_image(e_out),
                 Carver(img, energy="grad_norm", device="cpu").energy_image(),
                 "CLI energy on the card == energy_image on the CPU")

            src, dst = os.path.join(tmp, "src"), os.path.join(tmp, "dst")
            os.makedirs(src)
            for b in range(4):
                save_image(os.path.join(src, f"im{b}.ppm"), imgs[b])
            kernels.reset_launches()
            rc = cli.main(["batch", src, dst, "--seams", str(SEAMS_BE),
                           "--energy", "grad_norm"])
            torch.cuda.synchronize()
            chk.require(rc == 0, f"CLI batch rc {rc}")
            require_launches(kernels.launch_counts(), batch_launches(
                4, WB, SEAMS_BE, strip_gather=SEAMS_BE,
                strip_scatter=SEAMS_BE),
                f"CLI batch of 4 images over {len(batch_chunks(4))} "
                f"card(s)")
            for b in range(4):
                same(load_image(os.path.join(dst, f"im{b}.ppm")), singles[b],
                     f"CLI batch image {b} == single-image api.carve")
    finally:
        checkpoint.save_state = real_save
        if old_state_dir is None:
            os.environ.pop("DCT_CARVER_STATE_DIR", None)
        else:
            os.environ["DCT_CARVER_STATE_DIR"] = old_state_dir
    return main_launches

# per kernel, at the shape of its timed call: (bytes, f32 operations) of the
# bound, its device time, and the time of one PyTorch call computing the
# same function (between events and on the device)
BOUNDS: dict[str, tuple[float, float]] = {}
DEVICE: dict[str, float] = {}
LIBRARY: dict[str, float] = {}
LIBRARY_DEVICE: dict[str, float] = {}
# where each of those device times came from (device_ms)
DEVICE_SOURCE: dict[str, str] = {}
LIBRARY_DEVICE_SOURCE: dict[str, str] = {}
# the energy and the strip at phase 3c's batch shape: ((device ms, its
# source), (bound ms, bound_by))
BATCH: dict[str, tuple[tuple[float, str], tuple[float, str]]] = {}
# device ms a call with the 50 MB L2 flushed between calls, where a kernel's
# inputs are cold in the carve
FLUSHED: dict[str, float] = {}
# device ms a call of a kernel inside the graphed carve (phase 4b's
# profiled grad_norm carve), and the floor of a kernel's device time (with
# "source": where its two readings came from)
IN_GRAPH: dict[str, float] = {}
FLOOR: dict = {}


def graph_ms(fn, launches: int, replays: int = 20):
    """fn() `launches` times captured as one CUDA graph: (ms a launch
    between CUDA events around `replays` replays, the gaps between the
    graph's kernels included; device ms a launch under torch.profiler, the
    kernels alone, None where it recorded nothing)."""
    import torch

    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(launches):
            fn()
    ms = cuda_ms(graph.replay, replays) / launches
    dev_ms = device_ms(graph.replay, replays)
    return ms, (dev_ms / launches if DEVICE_SOURCE_LAST[0] == "profiler"
                else None)


def block_dp_5a(dev, chk: Checks, card: str, rng, times: dict) -> None:
    """The block DP (#16, #17) against its plain version, bitwise, over
    the shapes its column tiles meet: the 8K shard shape (S = 4, Wl = 1920,
    Hh = 192) at Kb = 96 and short last blocks, widths ending inside a
    tile and inside a shard's right halo (dead columns past the width), an
    extended row that is no multiple of the tile, halo-heavy and unaligned
    rows, the message form at the small-shard carve's shapes, and
    tile_plan's one-CTA fallback; then
    `tiled_blocks`, and both forms timed alone and inside a graph replay,
    the tiled schedule against one CTA a shard."""
    import torch

    from dct_carver_tpu_torch import kernels
    from dct_carver_tpu_torch.kernels.build import load
    from dct_carver_tpu_torch.kernels.spatial_kernel import (
        BLOCK_KERNEL, PARTS_KERNEL, block_dp, block_dp_parts, tile_plan)

    S, Wl, K = SHARDS, W8 // SHARDS, K8
    Hh = 2 * K
    We = Wl + 2 * Hh

    def on_dev(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    def width(w):
        return torch.tensor([w], dtype=torch.int32, device=dev)

    def parts(S_, Wl_, Hh_, Kb):
        return [on_dev(rng.random(shape, dtype=np.float32)) for shape in (
            (S_, Wl_), (S_, Kb, Wl_), (S_, Kb + 1, Hh_), (S_, Kb + 1, Hh_))]

    E = on_dev(rng.random((S, 2 * K, Wl), dtype=np.float32))
    M = on_dev(rng.random((S, 2 * K + 1, We), dtype=np.float32))
    prev = M[:, 0, Hh:Hh + Wl]          # the frontier, a strided view
    # widths: the whole row; ending inside a tile of shard 3; inside shard
    # 1's 64-column tile 3 (and shard 0's right halo); inside shard 1's
    # right halo; 3 short of the row
    widths = (W8, W8 - 700, Wl + 30, 2 * Wl + 50, W8 - 3)
    for Kb, w in ([(K, w) for w in widths]
                  + [(K - 1, W8), (37, W8 - 3), (17, 2 * Wl + 50),
                     (3, Wl + 30), (3, W8)]):
        blk = E[:, K:K + Kb]
        lh = on_dev(rng.random((S, Kb + 1, Hh), dtype=np.float32))
        rh = on_dev(rng.random((S, Kb + 1, Hh), dtype=np.float32))
        want = block_dp_parts(prev, blk, lh, rh, 0, width(w),
                              use_pallas=False)
        got = block_dp_parts(prev, blk, lh, rh, 0, width(w),
                             out=M[:, 1:1 + Kb])
        chk.equal("block_dp_parts", f"S={S} Wl={Wl} Kb={Kb} width={w} plan "
                  f"{tile_plan(Kb, We)}", got, want)
    # a frontier far above the block's energy: many cells take their value
    # from the far end of their cone, so ghost zones short of Kb would show
    big = prev * 1e6
    for Kb in (K, K - 1):
        args = (big, E[:, K:K + Kb],
                *(on_dev(rng.random((S, Kb + 1, Hh), dtype=np.float32))
                  for _ in range(2)), 0, width(W8))
        chk.equal("block_dp_parts", f"S={S} Wl={Wl} Kb={Kb} frontier x 1e6",
                  block_dp_parts(*args), block_dp_parts(*args,
                                                        use_pallas=False))
    # tile_plan's fallback (one CTA a shard: blocks of more than 96 rows)
    # at the 8K shard shape; an extended row of 2284 columns, no multiple
    # of the tile
    for S3, Wl3, Hh3, Kb3 in ((S, Wl, Hh, 97), (S, Wl, Hh, 200),
                              (S, 1900, Hh, K)):
        args = parts(S3, Wl3, Hh3, Kb3)
        for w in (S3 * Wl3, Wl3 + 30):
            chk.equal("block_dp_parts", f"S={S3} Wl={Wl3} Hh={Hh3} Kb={Kb3} "
                      f"width={w} plan {tile_plan(Kb3, Wl3 + 2 * Hh3)}",
                      block_dp_parts(*args, 0, width(w)),
                      block_dp_parts(*args, 0, width(w), use_pallas=False))
    # halo-heavy shards (halos wider than the owned columns), and extended
    # rows that are no multiple of 4 (4-byte staging and stores)
    for S3, Wl3, Hh3, Kb3 in ((4, 48, Hh, K), (3, 50, Hh, 41), (2, 7, 64, 32)):
        args = parts(S3, Wl3, Hh3, Kb3)
        for w in (S3 * Wl3, S3 * Wl3 - 5):
            chk.equal("block_dp_parts", f"S={S3} Wl={Wl3} Hh={Hh3} Kb={Kb3} "
                      f"width={w}", block_dp_parts(*args, 0, width(w)),
                      block_dp_parts(*args, 0, width(w), use_pallas=False))
        msg3 = on_dev(rng.random((S3, Kb3 + 1, Wl3 + 2 * Hh3),
                                 dtype=np.float32))
        chk.equal("block_dp", f"S={S3} Wl={Wl3} Hh={Hh3} Kb={Kb3}",
                  block_dp(msg3, 0, width(S3 * Wl3 - 3), Hh3),
                  block_dp(msg3, 0, width(S3 * Wl3 - 3), Hh3,
                           use_pallas=False))

    # the message form on 8 shards of 32 columns: at K = 96 the shapes of
    # phase 5b's small-shard carve (256 rows: a six-hop halo, blocks of 96
    # and 64 rows written into its (S, H, We) M), at K = 32 a two-hop halo
    S2, Wl2, H2 = 8, 32, 256
    for K2, Kbs in ((K, (K, H2 % K, 17, 3)), (32, (32,))):
        We2 = Wl2 + 4 * K2
        M2 = torch.zeros((S2, H2, We2), device=dev)
        for Kb in Kbs:
            for w in (S2 * Wl2, S2 * Wl2 - 45, 3 * Wl2 + 5):
                msg = on_dev(rng.random((S2, Kb + 1, We2), dtype=np.float32))
                chk.equal("block_dp", f"S={S2} Wl={Wl2} K={K2} Kb={Kb} "
                          f"width={w} plan {tile_plan(Kb, We2)}",
                          block_dp(msg, 0, width(w), 2 * K2,
                                   out=M2[:, H2 - Kb:]),
                          block_dp(msg, 0, width(w), 2 * K2,
                                   use_pallas=False))
    del M2

    # tiled_blocks: a launch of more than one tile a shard counts once
    We2 = Wl2 + 4 * K
    msg = on_dev(rng.random((S2, K + 1, We2), dtype=np.float32))
    args = (prev, E[:, K:], on_dev(rng.random((S, K + 1, Hh),
                                              dtype=np.float32)),
            on_dev(rng.random((S, K + 1, Hh), dtype=np.float32)), 0,
            width(W8))
    one = parts(2, 7, 64, 32)  # 135 columns: one tile
    kernels.reset_launches()
    block_dp_parts(*args)
    block_dp(msg, 0, width(S2 * Wl2), Hh)
    block_dp_parts(*one, 0, width(14))
    got = (PARTS_KERNEL.tiled_blocks, BLOCK_KERNEL.tiled_blocks,
           PARTS_KERNEL.launches, BLOCK_KERNEL.launches)
    chk.require(got == (1, 1, 2, 1), f"tiled_blocks (parts, message) and "
                f"launches after 2 + 1 calls, one of a single tile: {got}")
    kernels.reset_launches()

    # times: alone and inside a graph replay (45 launches, a seam's
    # blocks), the tiled plan against one CTA a shard through the C entry
    out = M[:, 1:1 + K]
    time_kernel(times, "block_dp_parts",
                lambda: block_dp_parts(*args, out=out),
                lambda: block_dp_parts(*args, use_pallas=False), 50, 3)
    BOUNDS["block_dp_parts"] = (
        4 * (S * Wl + S * K * Wl + 2 * S * (K + 1) * Hh + S * K * We),
        3 * S * K * We)
    out2, w2 = torch.empty((S2, K, We2), device=dev), width(S2 * Wl2)
    time_kernel(times, "block_dp", lambda: block_dp(msg, 0, w2, Hh, out=out2),
                lambda: block_dp(msg, 0, w2, Hh, use_pallas=False), 50, 3)
    BOUNDS["block_dp"] = (4 * (S2 * (K + 1) * We2 + S2 * K * We2),
                          3 * S2 * K * We2)
    lib = load()
    want = block_dp_parts(*args, use_pallas=False)
    want2 = block_dp(msg, 0, w2, Hh, use_pallas=False)
    p_, e_, lh_, rh_ = args[:4]

    def stream():  # the capturing stream inside a graph's capture
        return torch.cuda.current_stream(dev).cuda_stream

    def parts_call(plan):
        return lambda: lib.dc_block_dp_parts(
            p_.data_ptr(), p_.stride(0), e_.data_ptr(), e_.stride(0),
            lh_.data_ptr(), rh_.data_ptr(), out.data_ptr(), out.stride(0), S,
            K, Wl, Hh, 0, args[5].data_ptr(), *plan, stream())

    def msg_call(plan):
        return lambda: lib.dc_block_dp(
            msg.data_ptr(), out2.data_ptr(), out2.stride(0), S2, K, Wl2, Hh,
            0, w2.data_ptr(), *plan, stream())

    for form, call, ref, dst, We_ in (("block_dp_parts", parts_call, want,
                                       out, We),
                                      ("block_dp", msg_call, want2, out2,
                                       We2)):
        plans = [tile_plan(K, We_), (0, We_, 0)]
        if form == "block_dp_parts":
            plans[1:1] = [(66, 32, 96)]  # tiles of 32 owned columns
            # a plan whose last tile spans more than a warp is refused
            err = call((32, 64, 96))()
            chk.require(err == 1, f"{form} plan (32, 64, 96) refused: "
                        f"cudaError_t {err}, cudaErrorInvalidValue is 1")
        for plan in plans:
            dst.fill_(-1.0)
            err = call(plan)()
            torch.cuda.synchronize()
            chk.require(err == 0, f"{form} plan {plan}: cudaError_t {err}")
            chk.equal(form, f"plan {plan} through the C entry", dst, ref)
            alone = cuda_ms(call(plan), 200), device_ms(call(plan), 200)
            in_graph = graph_ms(call(plan), 45)
            if plan == plans[0]:
                IN_GRAPH[form] = in_graph[1] or in_graph[0]
            log(f"  {form} plan {plan} (T, Wt, Hg): alone {alone[0]!r} ms "
                f"between events, device {alone[1]!r} ms; in a graph of 45 "
                f"{in_graph[0]!r} ms a launch between events, device "
                f"{in_graph[1]!r} ms; {(in_graph[1] or in_graph[0]) * 1e6 / K!r} ns a row ({card})")


def phase_5a(dev, chk: Checks, card: str, rng, times: dict) -> None:
    """The spatial route's kernels against their plain versions, bitwise,
    at the shapes of its main path, on the views the route hands them."""
    import torch
    from benchlib.work import dct_ops

    from dct_carver_tpu_torch.kernels.spatial_kernel import (seg_walk,
                                                             sharded_apply)
    from dct_carver_tpu_torch.kernels.strip_kernel import (
        strip_gather, strip_scatter, strip_update)
    from dct_carver_tpu_torch.ops.dct import window_offset
    from dct_carver_tpu_torch.ops.strip import (
        ShardOffset, _shard_origins, _strip_bounds, _strip_extent)
    from dct_carver_tpu_torch.parallel.shards import ShardMesh

    S, Wl, K = SHARDS, W8 // SHARDS, K8
    Hh = 2 * K
    We = Wl + 2 * Hh
    edges, textures = 0.3, 0.7

    def on_dev(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    def width(w):
        return torch.tensor([w], dtype=torch.int32, device=dev)

    log(f"phase 5a: spatial kernels vs plain versions on the card ({S} "
        f"shards of {H8}x{Wl}, K={K})")
    block_dp_5a(dev, chk, card, rng, times)
    S2, Wl2, H2 = 8, 32, 256
    We2 = Wl2 + 4 * K

    # the walk at phase 5b's small-shard shapes: the segments of rows
    # [191, 255), [95, 191) and [0, 95) of 8 shards' (256, 416) M, K = 96
    rows_s = on_dev((rng.integers(0, 3, (S2, H2, We2)) / 2)
                    .astype(np.float32))
    for r0, r1 in ((2 * K - 1, H2 - 1), (K - 1, 2 * K - 1), (0, K - 1)):
        for j in (0, Wl2 - 1, Wl2, 3 * Wl2 + 7, S2 * Wl2 - 1):
            for tie in TIES:
                entry = torch.tensor([j], dtype=torch.int32, device=dev)
                chk.equal("seg_walk", f"S={S2} Wl={Wl2} rows {r0}:{r1} "
                          f"entry={j} {tie}",
                          seg_walk(rows_s[:, r0:r1], entry, 0, K, Hh,
                                   tie=tie),
                          seg_walk(rows_s[:, r0:r1], entry, 0, K, Hh,
                                   tie=tie, use_pallas=False))
    del rows_s

    # the walk: entries at shard and window edges, quantized M for ties
    rows_buf = on_dev((rng.integers(0, 3, (S, 2 * K, We)) / 2)
                      .astype(np.float32))
    for Kb in (K, K - 1, 41):
        rows = rows_buf[:, 7:7 + Kb]
        for j in (0, 1, Wl - 1, Wl, 2 * Wl + 5, W8 // 2, W8 - 1):
            for tie in TIES:
                entry = torch.tensor([j], dtype=torch.int32, device=dev)
                chk.equal("seg_walk", f"Kb={Kb} entry={j} {tie}",
                          seg_walk(rows, entry, 0, K, Hh, tie=tie),
                          seg_walk(rows, entry, 0, K, Hh, tie=tie,
                                   use_pallas=False))
    # windows clamped at column 0 and at We - ww (halos narrower than K),
    # and extended rows that are no multiple of 4 (4-byte staging); then
    # K = 200: a 401-column window in 13 chunks through a ring of 8
    for K3, Hh3, Kbs in ((K, 8, (K, 50)), (K, 9, (K,)),
                         (200, 400, (200, 133))):
        We3 = Wl + 2 * Hh3
        buf = on_dev((rng.integers(0, 3, (S, max(Kbs) + 3, We3)) / 2)
                     .astype(np.float32))
        for Kb in Kbs:
            for j in (0, Wl, Wl + 1, Wl + 2, Wl + 3, 2 * Wl - 1, W8 // 2 + 5,
                      W8 - 1):
                for tie in TIES:
                    entry = torch.tensor([j], dtype=torch.int32, device=dev)
                    chk.equal("seg_walk", f"K={K3} Hh={Hh3} Kb={Kb} "
                              f"entry={j} {tie}",
                              seg_walk(buf[:, 3:3 + Kb], entry, 0, K3, Hh3,
                                       tie=tie),
                              seg_walk(buf[:, 3:3 + Kb], entry, 0, K3, Hh3,
                                       tie=tie, use_pallas=False))
    del buf
    rows = rows_buf[:, 7:7 + K]
    entry = torch.tensor([W8 // 2 + 3], dtype=torch.int32, device=dev)
    time_kernel(times, "seg_walk", lambda: seg_walk(rows, entry, 0, K, Hh),
                lambda: seg_walk(rows, entry, 0, K, Hh, use_pallas=False),
                50, 3)
    BOUNDS["seg_walk"] = (4 * (K * (2 * K + 1) + S * K + 1),
                          4 * K * (2 * K + 1))
    # in the carve the walk's rows have left the L2 (the seam's M is 159 MB):
    # the same call with 128 MB written before it
    flush = torch.empty(32 * 2**20, device=dev)

    def walk_after_flush():
        flush.fill_(0.0)
        seg_walk(rows, entry, 0, K, Hh)

    FLUSHED["seg_walk"] = device_ms(walk_after_flush, 20, only="seg_walk")
    log(f"  seg_walk ({S} shards, K={K}, Kb={K}): device "
        f"{DEVICE['seg_walk']!r} ms back to back, {FLUSHED['seg_walk']!r} ms "
        f"with the L2 flushed between calls; bound "
        f"{bound(*BOUNDS['seg_walk'])[0]!r} ms ({card})")
    del flush

    # the sharded apply at the 8K shard shape, the seam on shard boundaries
    luma = on_dev(rng.random((S, H8, Wl), dtype=np.float32))
    energy = on_dev(rng.random((S, H8, Wl), dtype=np.float32))
    origcol = on_dev(rng.integers(0, W8, (S, H8, Wl)).astype(np.int32))
    s = (np.cumsum(rng.integers(-1, 2, H8)) + W8 // 2) % (W8 - 2)
    s[:6] = [Wl - 1, Wl, 2 * Wl - 1, 2 * Wl, 3 * Wl, W8 - 2]
    seam = on_dev(s.astype(np.int32))
    edge = on_dev(rng.random(H8, dtype=np.float32))
    first = torch.cat([luma[..., :1], energy[..., :1],
                       origcol[..., :1].view(torch.float32)], dim=-1)
    incoming = torch.cat([first[1:], torch.zeros_like(first[:1])])
    for nw in (W8 - 1, W8 - 9):
        got = sharded_apply(luma, origcol, energy, seam, edge, incoming,
                            width(nw), 0)
        want = sharded_apply(luma, origcol, energy, seam, edge, incoming,
                             width(nw), 0, use_pallas=False)
        for part, g, w_ in zip(("luma", "origcol", "energy", "orig"), got,
                               want):
            chk.equal("sharded_apply", f"({S}, {H8}, {Wl}) new width {nw} "
                      f"{part}", g, w_)
    outs = tuple(torch.empty_like(t) for t in (luma, origcol, energy))
    nw = width(W8 - 1)
    time_kernel(times, "sharded_apply",
                lambda: sharded_apply(luma, origcol, energy, seam, edge,
                                      incoming, nw, 0, out=outs),
                lambda: sharded_apply(luma, origcol, energy, seam, edge,
                                      incoming, nw, 0, use_pallas=False),
                50, 5)
    BOUNDS["sharded_apply"] = (24 * S * H8 * Wl + 12 * S * H8 + 8 * H8
                               + 4 * S * H8, 0)
    # the compaction as one torch.gather over the three planes' bits
    planes = torch.stack([luma, energy, origcol.view(torch.float32)])
    cols = torch.arange(Wl, device=dev)
    col_g = Wl * torch.arange(S, device=dev)[:, None, None] + cols
    src = torch.where(col_g < seam[:, None], cols, (cols + 1) % Wl)
    index = src.expand(3, S, H8, Wl).contiguous()
    time_library("sharded_apply", lambda: torch.gather(planes, 3, index))
    # back to back, the 50 MB L2 may still hold lines of the call before;
    # with 128 MB written between calls it holds none of them
    flush = torch.empty(32 * 2**20, device=dev)

    def after_flush():
        flush.fill_(0.0)
        sharded_apply(luma, origcol, energy, seam, edge, incoming, nw, 0,
                      out=outs)

    FLUSHED["sharded_apply"] = flushed = device_ms(after_flush, 20,
                                                   only="sharded_apply")
    log(f"  sharded_apply ({S}, {H8}, {Wl}): device {DEVICE['sharded_apply']!r}"
        f" ms back to back, {flushed!r} ms with the L2 flushed between "
        f"calls; bound {bound(*BOUNDS['sharded_apply'])[0]!r} ms ({card})")
    del luma, energy, origcol, planes, index, outs, flush

    # rows by grid stride: a stack of shards taller than the grid's y
    St, Wt = 2, 32
    luma = on_dev(rng.random((St, H_TALL, Wt), dtype=np.float32))
    energy = on_dev(rng.random((St, H_TALL, Wt), dtype=np.float32))
    origcol = on_dev(rng.integers(0, St * Wt, (St, H_TALL, Wt))
                     .astype(np.int32))
    seam_t = on_dev(((np.cumsum(rng.integers(-1, 2, H_TALL)) + Wt)
                     % (St * Wt - 2)).astype(np.int32))
    edge_t = on_dev(rng.random(H_TALL, dtype=np.float32))
    first = torch.cat([luma[..., :1], energy[..., :1],
                       origcol[..., :1].view(torch.float32)], dim=-1)
    incoming = torch.cat([first[1:], torch.zeros_like(first[:1])])
    nw_t = width(St * Wt - 1)
    for part, g, w_ in zip(
            ("luma", "origcol", "energy", "orig"),
            sharded_apply(luma, origcol, energy, seam_t, edge_t, incoming,
                          nw_t, 0),
            sharded_apply(luma, origcol, energy, seam_t, edge_t, incoming,
                          nw_t, 0, use_pallas=False)):
        chk.equal("sharded_apply", f"({St}, {H_TALL}, {Wt}) {part}", g, w_)
    del luma, energy, origcol, incoming, first

    # the strips with a shard offset: 4 shards of the 8K plane
    mesh = ShardMesh([dev] * S, W8)
    plane = on_dev(rng.random((H8, W8), dtype=np.float32))
    e_full = on_dev(rng.random((H8, W8), dtype=np.float32))
    shard = ShardOffset(0, W8)
    offset = {}
    for n in (2, 8):
        ext = mesh.edge_clamped_halo(mesh.split(plane), n // 2 - 1,
                                     n // 2)[0]
        e_sh = mesh.split(e_full)[0]
        k = strip_update(ext, e_sh.clone(), seam, n, edges, textures,
                         shard=shard)
        chk.equal("strip", f"{S} shards of {H8}x{Wl} n={n}", k,
                  strip_update(ext, e_sh.clone(), seam, n, edges, textures,
                               shard=shard, use_pallas=False))
        chk.equal("strip", f"{S} shards n={n} == the unsharded strip",
                  mesh.join([k]),
                  strip_update(plane, e_full.clone(), seam, n, edges,
                               textures))
        chk.equal("strip_gather", f"{S} shards of {H8}x{Wl} n={n}",
                  strip_gather(ext, seam, n, shard=shard),
                  strip_gather(ext, seam, n, shard=shard, use_pallas=False))
        strip = torch.rand((S, H8, _strip_extent(n)[1]), device=dev)
        chk.equal("strip_scatter", f"{S} shards of {H8}x{Wl} n={n}",
                  strip_scatter(e_sh.clone(), strip, seam, n, shard=shard),
                  strip_scatter(e_sh.clone(), strip, seam, n, shard=shard,
                                use_pallas=False))
        # the offset forms' times, at the route's shapes: the DCT strip at
        # n=8, the plugged-energy gather and scatter at grad_norm's n=2
        sw = _strip_extent(n)[1]
        if n == 8:
            offset["strip"] = (
                lambda p, x=ext, e=e_sh: strip_update(
                    x, e, seam, 8, edges, textures, shard=shard,
                    use_pallas=p),
                4 * (H8 * (sw + n - 1) + H8 * sw + H8),
                dct_ops(n, H8 * sw, H8 * (sw + n - 1)), None)
        else:
            # the library calls: one torch.take of the bands and one
            # scatter_ into the shards with a spill column, indices
            # precomputed as ops/strip.py's plain versions compute them
            Wx = ext.shape[-1]
            co = window_offset(n, "carve")
            start = _strip_bounds(seam, n, W8)[0]
            x0 = _shard_origins(shard, S, Wl, dev)
            cols = ((start[:, None] + co + torch.arange(sw + n - 1,
                                                        device=dev))[None]
                    - (x0 + co)[:, None, None]).clamp(0, Wx - 1)
            rows = (torch.arange(H8, device=dev)[:, None] + co
                    + torch.arange(n, device=dev)).clamp(0, H8 - 1)
            flat = (torch.arange(S, device=dev)[:, None, None, None] * H8 * Wx
                    + rows[None, :, :, None] * Wx + cols[:, :, None, :])
            idx = (start[:, None] + torch.arange(sw, device=dev))[None] \
                - x0[:, None, None]
            idx = torch.where((idx >= 0) & (idx < Wl), idx, Wl)
            padded = torch.cat([e_sh, torch.zeros_like(e_sh[..., :1])], -1)
            chk.require(torch.equal(torch.take(ext, flat),
                                    strip_gather(ext, seam, n, shard=shard)),
                        f"offset n={n} torch.take == the strip gather")
            chk.require(torch.equal(
                padded.clone().scatter_(-1, idx, strip)[..., :Wl],
                strip_scatter(e_sh.clone(), strip, seam, n, shard=shard)),
                f"offset n={n} scatter_ == the strip scatter")
            offset["strip_gather"] = (
                lambda p, x=ext: strip_gather(x, seam, 2, shard=shard,
                                              use_pallas=p),
                4 * (H8 * (sw + n - 1) + S * H8 * n * (sw + n - 1) + H8), 0,
                lambda x=ext, f=flat: torch.take(x, f))
            offset["strip_scatter"] = (
                lambda p, e=e_sh, t=strip: strip_scatter(
                    e, t, seam, 2, shard=shard, use_pallas=p),
                4 * (S * H8 * sw + H8 * sw + H8), 0,
                lambda e=padded, i=idx, t=strip: e.scatter_(-1, i, t))
    for name, (fn, nbytes, ops, lib) in offset.items():
        k_ms, p_ms = cuda_ms(lambda: fn(True), 50), cuda_ms(lambda: fn(False),
                                                             5)
        d_ms = device_ms(lambda: fn(True), 50)
        b_ms, b_by = bound(nbytes, ops)
        lib_ms = (cuda_ms(lib, 50), device_ms(lib, 50)) if lib else None
        log(f"  {name} with a shard offset ({S} x {H8}x{Wl}): kernel {k_ms!r}"
            f" ms (device {d_ms!r}), plain {p_ms!r} ms, bound {b_ms!r} ms "
            f"({b_by}), library (ms, device ms) {lib_ms!r} ({card})")
    for name in ("block_dp_parts", "block_dp", "seg_walk", "sharded_apply"):
        k_ms, p_ms = times[name]
        log(f"  {name:14s} kernel {k_ms!r} ms, plain {p_ms!r} ms ({card})")


@contextlib.contextmanager
def count_replays():
    """Count the CUDA graph replays inside the block: yields a one-element
    list that holds the count."""
    import torch

    graph_cls = torch.cuda.CUDAGraph
    own = "replay" in graph_cls.__dict__
    replay = graph_cls.replay
    count = [0]

    def counted(self, *args, **kwargs):
        count[0] += 1
        return replay(self, *args, **kwargs)

    graph_cls.replay = counted
    try:
        yield count
    finally:
        if own:
            graph_cls.replay = replay
        else:
            del graph_cls.replay


def phase_5(dev, chk: Checks, card: str, rng) -> list:
    """The spatial route through its entry points; returns the launch
    counts of its main-path runs (5b's 8K carve, its small-shard carve,
    5c's grad_norm carve)."""
    import os
    import tempfile

    import torch

    from dct_carver_tpu_torch import api, cli, kernels
    from dct_carver_tpu_torch.kernels.spatial_kernel import (BLOCK_KERNEL,
                                                             PARTS_KERNEL)
    from dct_carver_tpu_torch.ops.carve import (carve_n_seams,
                                                reconstruct_enlarged)
    from dct_carver_tpu_torch.ops.energy import to_luma
    from dct_carver_tpu_torch.ops.energy_fn import GRAD_NORM
    from dct_carver_tpu_torch.parallel.mesh import make_mesh
    from dct_carver_tpu_torch.parallel.spatial import (
        collectives_per_seam, measure_collectives_per_seam,
        spatial_carve_n_seams, spatial_carve_seams, spatial_enlarge_n_seams,
        spatial_make_state)
    from dct_carver_tpu_torch.utils.image import load_image, save_image

    def on_dev(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    def same(a, b, what):
        chk.require(a.shape == b.shape and np.array_equal(a, b), what)

    mesh = make_mesh(devices=[dev] * SHARDS)
    nb = -(-H8 // K8)
    log(f"phase 5b: spatial_carve_n_seams({H8}x{W8}, {SEAMS_8K}) over "
        f"{SHARDS} shards on the card, n=8, K={K8}: the first seam eager, "
        "the rest CUDA graph replays")
    luma8 = on_dev(rng.random((H8, W8), dtype=np.float32))
    spatial_carve_n_seams(luma8[:2 * K8, :1024], 2, devices=mesh)  # warm-up
    torch.cuda.synchronize()
    kernels.reset_launches()
    with count_replays() as replays:
        res = spatial_carve_n_seams(luma8, SEAMS_8K, devices=mesh)
        torch.cuda.synchronize()
    launches = kernels.launch_counts()
    log(f"  launches on the spatial route: {launches}")
    chk.require(replays[0] == SEAMS_8K - 1,
                f"8K spatial carve: {replays[0]} graph replays for "
                f"{SEAMS_8K} seams")
    log(f"  graph capture of the 8K seam step (both directions): "
        f"{res.capture_seconds * 1e3!r} ms of host time, inside the carve's "
        f"wall time ({card})")
    want = {"block_dp_parts": nb * SEAMS_8K, "seg_walk": nb * SEAMS_8K,
            "sharded_apply": SEAMS_8K, "strip": SEAMS_8K, "energy": 1,
            "block_dp": 0, "find_seam": 0, "find_seams": 0,
            "find_seam_tiled": 0, "apply": 0}
    got = {k: launches[k] for k in want}
    chk.require(got == want, f"8K spatial launches {got}")
    # every block ran over column tiles (33 a shard), replays credited
    tiled = (PARTS_KERNEL.tiled_blocks, BLOCK_KERNEL.tiled_blocks)
    chk.require(tiled == (nb * SEAMS_8K, 0),
                f"8K spatial tiled_blocks (parts, message) {tiled}")
    log("  launches a seam: " + ", ".join(
        f"{k} {v / SEAMS_8K!r}" for k, v in launches.items() if v))
    single = carve_n_seams(luma8, SEAMS_8K, 8, 0.0, 1.0)
    chk.require(res.width == single.width == W8 - SEAMS_8K,
                "8K spatial logical width")
    chk.equal("carve", f"8K spatial {SEAMS_8K}-seam vmap == single-device",
              res.vmap, single.vmap)
    plain = spatial_carve_n_seams(luma8, PLAIN_SEAMS_8K, devices=mesh,
                                  use_pallas=False)
    short = spatial_carve_n_seams(luma8, PLAIN_SEAMS_8K, devices=mesh)
    chk.equal("carve", f"8K spatial {PLAIN_SEAMS_8K}-seam vmap == plain "
              "spatial path", short.vmap, plain.vmap)
    # chunks of an odd size share one capture: the vmap equals the first
    # seams of the unchunked carve
    with count_replays() as replays:
        chunked = spatial_carve_n_seams(luma8, CHUNKED_SEAMS_8K,
                                        devices=mesh, chunk=5)
    chk.equal("carve", f"8K spatial {CHUNKED_SEAMS_8K}-seam carve in chunks "
              "of 5 == unchunked", chunked.vmap,
              torch.where(res.vmap <= CHUNKED_SEAMS_8K, res.vmap, 0))
    chk.require(replays[0] == CHUNKED_SEAMS_8K - 1,
                f"chunked carve: {replays[0]} replays, one capture "
                f"({chunked.capture_seconds * 1e3!r} ms)")
    # launches and exchanges a seam under replay, on a mesh held here
    st, shard_mesh = spatial_make_state(luma8, devices=mesh)
    torch.cuda.synchronize()
    kernels.reset_launches()
    shard_mesh.exchanges = 0
    spatial_carve_seams(st, shard_mesh, 0, CHUNKED_SEAMS_8K)
    torch.cuda.synchronize()
    counted = kernels.launch_counts()
    per_seam = {k: counted[k] / CHUNKED_SEAMS_8K
                for k in ("block_dp_parts", "seg_walk", "sharded_apply",
                          "strip")}
    chk.require(per_seam == {"block_dp_parts": nb, "seg_walk": nb,
                             "sharded_apply": 1, "strip": 1},
                f"launches a seam under replay {per_seam}")
    chk.require(shard_mesh.exchanges
                == CHUNKED_SEAMS_8K * collectives_per_seam(H8, K8,
                                                           fused_apply=True),
                f"exchanges under replay {shard_mesh.exchanges} == "
                f"{CHUNKED_SEAMS_8K} x collectives_per_seam")
    del st, shard_mesh, chunked
    # the two routes in turns, so that their comparison carries its spread
    spatial = f"spatial ({SHARDS} shards)"
    secs = {spatial: [], "single-device": []}
    captures = []
    for r in range(TIMED_PAIRS_8K):
        order = list(secs)[::1 if r % 2 == 0 else -1]
        for route in order:
            torch.cuda.synchronize()
            t = time.perf_counter()
            if route == spatial:
                captures.append(spatial_carve_n_seams(
                    luma8, SEAMS_8K, devices=mesh).capture_seconds * 1e3)
            else:
                carve_n_seams(luma8, SEAMS_8K, 8, 0.0, 1.0)
            torch.cuda.synchronize()
            secs[route].append(time.perf_counter() - t)
    px = H8 * W8 * SEAMS_8K
    for route, ts in secs.items():
        med = sorted(ts)[len(ts) // 2]
        log(f"  8K {route} carve, in turns: {ts!r} s; "
            f"median {px / med / 1e6!r} Mpix/s, {med * 1e3 / SEAMS_8K!r} ms "
            f"a seam, spread {min(ts) * 1e3 / SEAMS_8K!r}-"
            f"{max(ts) * 1e3 / SEAMS_8K!r} ms a seam ({card})")
    log(f"  8K spatial captures in turns: {captures!r} ms ({card})")
    m = measure_collectives_per_seam(H8, W8, mesh, use_pallas=True)
    chk.require(m["total"] == m["designed"]
                == collectives_per_seam(H8, K8, fused_apply=True),
                f"exchanges a seam {m['total']} == collectives_per_seam "
                f"{m['designed']}")
    profiled = []
    wall, _, top, busy_us = device_profile(
        lambda: profiled.append(spatial_carve_n_seams(luma8, SEAMS_8K,
                                                      devices=mesh)), top=16)
    cap = profiled[-1].capture_seconds
    log(f"  profiled {SEAMS_8K}-seam 8K spatial carve: wall "
        f"{wall * 1e3!r} ms, device busy {busy_us / 1e3!r} ms "
        f"({100 * busy_us / 1e6 / wall!r} % of wall; "
        f"{100 * busy_us / 1e6 / (wall - cap)!r} % of the wall without the "
        f"capture's {cap * 1e3!r} ms; {busy_us / 1e3 / SEAMS_8K!r} device ms "
        f"a seam; {card})")
    for name, us, count in top:
        log(f"    {us / 1e3:10.4f} ms  {count:5d} x  {name[:90]}")
    # whether the profiler names the kernels that run inside the graph
    # replays: then the walk counts nb a seam over every seam, the first
    # (eager) one included
    walks = [(us, count) for name, us, count in top if "seg_walk" in name]
    seen = bool(walks) and walks[0][1] == nb * SEAMS_8K
    log(f"  the profiler {'names' if seen else 'does NOT name'} the kernels "
        f"inside graph replays (seg_walk rows: {walks})")
    if walks:
        log(f"  seg_walk in the carve: {walks[0][0] / 1e3 / walks[0][1]!r} "
            f"ms a call ({card})")
    if not seen:  # the carve's time between events instead
        ev_ms = cuda_ms(lambda: spatial_carve_n_seams(luma8, SEAMS_8K,
                                                      devices=mesh), 1)
        log(f"  {SEAMS_8K}-seam 8K spatial carve between CUDA events: "
            f"{ev_ms!r} ms ({card})")
    del luma8, res, single, plain, short

    log("phase 5b: api.carve(256x256x3, -8, parallel='spatial') over 8 "
        "shards of 32 columns (multi-hop halos: the message-form block DP)")
    img_s = rng.integers(0, 256, (256, 256, 3), dtype=np.uint8)
    kw = dict(output_seams=True, output_energy=True)
    api.carve(img_s[:64, :64], -2, parallel="spatial",
              devices=[mesh[0]] * 8, **kw)
    torch.cuda.synchronize()
    kernels.reset_launches()
    sp = api.carve(img_s, -8, parallel="spatial", devices=[mesh[0]] * 8,
                   **kw)
    torch.cuda.synchronize()
    small = kernels.launch_counts()
    got = {k: small[k] for k in ("block_dp", "block_dp_parts", "seg_walk",
                                 "sharded_apply")}
    chk.require(got == {"block_dp": 3 * 8, "block_dp_parts": 0,
                        "seg_walk": 3 * 8, "sharded_apply": 8},
                f"small-shard spatial launches {got}")
    chk.require(BLOCK_KERNEL.tiled_blocks == 3 * 8,
                f"small-shard tiled_blocks {BLOCK_KERNEL.tiled_blocks}: 3 or "
                f"4 tiles of the 416-column message rows, every block")
    one = api.carve(img_s, -8, device=dev.type, **kw)
    for field in ("image", "visibility_map", "energy_image"):
        same(getattr(sp, field), getattr(one, field),
             f"small-shard spatial api.carve {field} == single-image route")

    log(f"phase 5c: the spatial route's entry points at {H}x{W}, "
        f"{SEAMS_5C} seams, {SHARDS} shards")
    img = rng.integers(0, 256, (H, W, 3), dtype=np.uint8)
    with count_replays() as replays:
        a = api.carve(img, -SEAMS_5C, parallel="spatial", devices=mesh, **kw)
    chk.require(replays[0] == SEAMS_5C - 1,
                f"spatial api.carve: {replays[0]} graph replays")
    b = api.carve(img, -SEAMS_5C, device=dev.type, **kw)
    for field in ("image", "visibility_map", "energy_image"):
        same(getattr(a, field), getattr(b, field),
             f"spatial api.carve {field} == single-image route")
    img_t = on_dev(img)
    luma = to_luma(img_t)
    single = carve_n_seams(luma, SEAMS_5C, 8, 0.0, 1.0)
    e = spatial_enlarge_n_seams(luma, SEAMS_5C, img_t, devices=mesh)
    chk.equal("carve", "spatial enlargement == reconstruct_enlarged",
              e.image, reconstruct_enlarged(img_t, single.vmap, SEAMS_5C))
    torch.cuda.synchronize()
    kernels.reset_launches()
    with count_replays() as replays:
        g = spatial_carve_n_seams(luma, SEAMS_5C, devices=mesh,
                                  energy="grad_norm")
        torch.cuda.synchronize()
    plugged = kernels.launch_counts()
    chk.require(replays[0] == SEAMS_5C - 1,
                f"spatial grad_norm carve: {replays[0]} graph replays")
    got = {k: plugged[k] for k in ("strip_gather", "strip_scatter")}
    chk.require(got == {"strip_gather": SEAMS_5C, "strip_scatter": SEAMS_5C},
                f"spatial grad_norm carve: offset gather/scatter launches "
                f"{got}")
    chk.equal("carve", "spatial grad_norm vmap == single-device",
              g.vmap, carve_n_seams(luma, SEAMS_5C, 8, 0.0, 1.0,
                                    energy_fn=GRAD_NORM).vmap)
    old_state_dir = os.environ.get("DCT_CARVER_STATE_DIR")
    try:
        with tempfile.TemporaryDirectory(prefix="dct_carver_smoke_") as tmp:
            os.environ["DCT_CARVER_STATE_DIR"] = os.path.join(tmp, "state")
            ck = os.path.join(tmp, "ck")
            whole = spatial_carve_n_seams(luma, SEAMS_5C, devices=mesh,
                                          image=img_t)
            spatial_carve_n_seams(luma, SEAMS_5C, devices=mesh, image=img_t,
                                  chunk=SEAMS_5C // 2, checkpoint_dir=ck)
            chk.require(sorted(os.listdir(ck)) == [
                "meta.json", f"state-{SEAMS_5C // 2:08d}"],
                f"sharded checkpoint steps {sorted(os.listdir(ck))}")
            with count_replays() as replays:
                res = spatial_carve_n_seams(luma, SEAMS_5C, devices=mesh,
                                            image=img_t, resume_from=ck)
            chk.require(replays[0] == SEAMS_5C // 2 - 1,
                        f"resumed sharded carve: {replays[0]} graph replays")
            chk.equal("carve", "resumed sharded checkpoint vmap == "
                      "uninterrupted", res.vmap, whole.vmap)
            chk.equal("carve", "resumed sharded checkpoint image == "
                      "uninterrupted", res.image, whole.image)
            inp, out = (os.path.join(tmp, f) for f in ("in.ppm", "out.ppm"))
            save_image(inp, img)
            # the CLI's mesh is every visible card: over one card or
            # several of this controller, every seam after the first a
            # replay
            cards = torch.cuda.device_count()
            want = SEAMS_5C - 1
            with count_replays() as replays:
                rc = cli.main(["carve", inp, out, "--seams", f"-{SEAMS_5C}",
                               "--parallel", "spatial"])
            chk.require(rc == 0 and replays[0] == want,
                        f"CLI --parallel spatial over {cards} card(s): rc "
                        f"{rc}, {replays[0]} graph replays == {want}")
            same(load_image(out), b.image,
                 "CLI --parallel spatial == single-image api.carve")
    finally:
        if old_state_dir is None:
            os.environ.pop("DCT_CARVER_STATE_DIR", None)
        else:
            os.environ["DCT_CARVER_STATE_DIR"] = old_state_dir
    return [launches, small, plugged]


def mp_luma() -> np.ndarray:
    """Phase 6's 4320 x 7680 luma, the same in every process."""
    return np.random.default_rng(SEED + 6).random((H8, W8), dtype=np.float32)


def mp_layout(count: int) -> tuple[str, int, int]:
    """Phase 6's (backend, processes, shards a process) for `count` cards:
    NCCL with one card a process over several cards; on one card two
    processes over gloo (NCCL refuses two ranks on one card), each staging
    its exchanges through host memory."""
    if count >= 2:
        nproc = min(count, MP_SHARDS)
        return "nccl", nproc, max(1, MP_SHARDS // nproc)
    return "gloo", 2, MP_SHARDS // 2


def mp_graphed(backend: str) -> bool:
    """Whether phase 6's process mesh replays CUDA graphs: over NCCL, whose
    exchanges stay on the card; over gloo every step runs eagerly."""
    return backend == "nccl"


def multiproc_worker(rank: int, nproc: int, port: int, backend: str,
                     workdir: str) -> int:
    """One process of phase 6: joins the job, carves its shards of the 8K
    luma with the launch counters and graph replays read around the carve,
    and again with every step eager (`debug_mode`), counts its exchanges a
    seam, times both carves in turns, checkpoints in chunks and resumes,
    probes the job, and writes what it saw to result-{rank}.json under
    `workdir`."""
    import os

    import torch

    from dct_carver_tpu_torch import kernels
    from dct_carver_tpu_torch.parallel import multihost
    from dct_carver_tpu_torch.parallel.shards import shard_mesh
    from dct_carver_tpu_torch.parallel.spatial import (
        spatial_carve_n_seams, spatial_carve_seams, spatial_make_state)
    from dct_carver_tpu_torch.utils.debug import debug_mode

    multihost.initialize(f"localhost:{port}", nproc, rank, backend=backend)
    card = torch.device("cuda", torch.cuda.current_device())
    devices = [card] * mp_layout(torch.cuda.device_count())[2]
    luma = torch.from_numpy(mp_luma()).to(card)
    multihost.barrier("startup")
    log(f"rank {rank}: {backend}, shards on {card}")
    out = {"rank": rank, "card": str(card)}

    def carve(n, **kw):
        res = spatial_carve_n_seams(luma, n, devices=devices, processes=True,
                                    **kw)
        torch.cuda.synchronize()
        return res

    def eager():
        return debug_mode(nan_checks=False, disable_jit=True)

    def counted(name, n, ctx=contextlib.nullcontext, **kw):
        """carve(n) with the launch counters and graph replays read around
        it; saves its vmap as {name}-{rank}.npy."""
        kernels.reset_launches()
        with count_replays() as replays, ctx():
            res = carve(n, **kw)
        out[name] = {"launches": kernels.launch_counts(),
                     "replays": replays[0],
                     "capture_ms": res.capture_seconds * 1e3}
        np.save(os.path.join(workdir, f"{name}-{rank}.npy"),
                res.vmap.cpu().numpy())
        return res

    carve(2)  # warm-up: the kernels' first launches, the allocator
    res = counted("vmap", MP_SEAMS)
    out["columns"] = list(res.columns)
    out["width"] = res.width
    counted("vmap-eager", MP_SEAMS, eager)

    st, mesh = spatial_make_state(luma, devices=devices, processes=True)
    mesh.exchanges = 0
    with count_replays() as replays:
        spatial_carve_seams(st, mesh, 0, MP_SEAMS)
        torch.cuda.synchronize()
    out["exchanges"] = mesh.exchanges
    out["exchanges_replays"] = replays[0]
    del st, mesh

    # the graphed and the eager carve in turns, each timed at MP_TIMED and
    # 2 * MP_TIMED seams with its capture beside it (`mp_ms_a_seam`); over
    # gloo both are eager, so one turn
    turns = (("graphed", "eager", "eager", "graphed") if mp_graphed(backend)
             else ("eager",))
    timed = {mode: [] for mode in set(turns)}
    for mode in turns:
        walls = []
        with eager() if mode == "eager" else contextlib.nullcontext():
            for n in (MP_TIMED, 2 * MP_TIMED):
                multihost.barrier("timed")
                t = time.perf_counter()
                res = carve(n)
                walls.append((time.perf_counter() - t, res.capture_seconds))
        timed[mode].append(walls)
    out["timed"] = timed
    if mp_graphed(backend):
        # where a graphed seam's time goes, every process at once: CUDA
        # events around every replay, then the kernels by device time
        multihost.barrier("busy")
        out["busy"] = event_busy(lambda: carve(2 * MP_TIMED), card)
        multihost.barrier("profile")
        wall, dev_us, top, busy_us = device_profile(
            lambda: carve(2 * MP_TIMED), top=6, host=False)
        out["profile"] = {"wall_ms": wall * 1e3, "device_us": dev_us,
                          "busy_us": busy_us, "top": top}
    # the fabric's floor: a shift and a sum of a one-float shard, alone
    floor = shard_mesh(devices, len(devices) * nproc, processes=True)
    tiny = [torch.zeros((len(devices), 1), device=card)]
    for name, op in (("shift", floor.from_left), ("psum", floor.psum)):
        op(tiny)
        multihost.barrier("floor")
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(MP_FLOOR_REPS):
            op(tiny)
        torch.cuda.synchronize()
        out[f"{name}_us"] = (time.perf_counter() - t) / MP_FLOOR_REPS * 1e6

    ck = os.path.join(workdir, "ck")
    counted("chunked", MP_SEAMS, chunk=MP_CHUNK, checkpoint_dir=ck)
    step = (MP_SEAMS - 1) // MP_CHUNK * MP_CHUNK  # the last chunk saves
    # nothing
    with open(os.path.join(ck, f"state-{step:08d}",
                           f"process-{rank:05d}.json")) as f:
        out["manifest"] = json.load(f)
    counted("resumed", MP_SEAMS, resume_from=ck)
    out["health"] = multihost.process_health(timeout=30.0)
    multihost.barrier("done")
    with open(os.path.join(workdir, f"result-{rank}.json"), "w") as f:
        json.dump(out, f)
    log(f"rank {rank}: done")
    return 0


def mp_ms_a_seam(walls, captures) -> float:
    """ms a seam from one process's turn, [(wall s, capture s)] of its
    carves of MP_TIMED and 2 * MP_TIMED seams: the marginal, with each
    carve's slowest capture over the processes (`captures`) taken out, the
    capture every process's first replay waits for."""
    (t1, _), (t2, _) = walls
    c1, c2 = captures
    return ((t2 - c2) - (t1 - c1)) / MP_TIMED * 1e3


def phase_6(dev, chk: Checks, card: str) -> list:
    """The spatial route over several processes (`parallel/multihost.py`,
    a `ProcessMesh`): the 8K luma of phase 5b on 4 global shards, the
    processes spawned from this script, graphed over NCCL and eager over
    gloo, and under `debug_mode` eager on both; then the checkpoint they
    wrote, resumed on one controller, and `dryrun_multichip`.  Returns each
    process's launch counts of its carve."""
    import os
    import socket
    import tempfile

    import torch

    from dct_carver_tpu_torch.ops.carve import carve_n_seams
    from dct_carver_tpu_torch.parallel.dryrun import dryrun_multichip
    from dct_carver_tpu_torch.parallel.spatial import (
        collectives_per_seam, spatial_carve_n_seams)

    count = torch.cuda.device_count()
    backend, nproc, per_rank = mp_layout(count)
    graphed = mp_graphed(backend)
    log(f"phase 6: backend {backend}, {nproc} processes x {per_rank} shards "
        f"({count} card{'s' if count > 1 else ''}): spatial_carve_n_seams("
        f"{H8}x{W8}, {MP_SEAMS}), use_pallas=True, "
        + ("graph replays over NCCL, and eager under debug_mode" if graphed
           else "every step eager: the graphed process mesh needs two cards "
                "(NCCL; gloo stages its exchanges through the host)"))
    torch.cuda.empty_cache()
    with socket.socket() as sk:
        sk.bind(("localhost", 0))
        port = sk.getsockname()[1]
    nb = -(-H8 // K8)
    design = collectives_per_seam(H8, K8, fused_apply=True)
    luma = torch.from_numpy(mp_luma()).to(dev)
    single = carve_n_seams(luma, MP_SEAMS, 8, 0.0, 1.0)
    torch.cuda.synchronize()
    with tempfile.TemporaryDirectory(prefix="dct_carver_mp_") as tmp:
        t = time.perf_counter()
        logs = [open(os.path.join(tmp, f"log-{r}.txt"), "w")
                for r in range(nproc)]
        procs = [subprocess.Popen(
            [sys.executable, str(ROOT / "chip_smoke.py"),
             "--multiproc-worker", str(r), str(nproc), str(port), backend,
             tmp], cwd=ROOT, stdout=f, stderr=subprocess.STDOUT)
            for r, f in enumerate(logs)]
        try:
            # a failed worker leaves its peers waiting in a collective:
            # stop them all at the first failure or at the limit
            while (any(p.poll() is None for p in procs)
                   and not any(p.poll() for p in procs)
                   and time.perf_counter() - t < MP_SECONDS):
                time.sleep(0.2)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                p.wait()
            for f in logs:
                f.close()
        for r, p in enumerate(procs):
            with open(os.path.join(tmp, f"log-{r}.txt")) as f:
                for line in f.read().splitlines():
                    log(f"  [rank {r}] {line}")
            chk.require(p.returncode == 0,
                        f"multi-process worker {r} exited {p.returncode}")
        log(f"  {nproc} workers took {time.perf_counter() - t!r} s")
        results = []
        for r in range(nproc):
            path = os.path.join(tmp, f"result-{r}.json")
            if not os.path.exists(path):
                chk.require(False, f"rank {r} wrote its result")
                return []
            with open(path) as f:
                results.append(json.load(f))
        want = {"block_dp_parts": nb * MP_SEAMS, "seg_walk": nb * MP_SEAMS,
                "sharded_apply": MP_SEAMS, "strip": MP_SEAMS, "energy": 1,
                "block_dp": 0, "find_seam": 0, "find_seams": 0,
                "find_seam_tiled": 0, "apply": 0}
        # replays a carve of n seams from its first: every seam but the
        # first over NCCL, none over gloo
        def replays(n):
            return n - 1 if graphed else 0

        step = (MP_SEAMS - 1) // MP_CHUNK * MP_CHUNK  # the resumed seams'
        # checkpoint
        Wl = W8 // (nproc * per_rank)
        for res in results:
            r = res["rank"]
            lo, hi = res["columns"]
            chk.require((lo, hi) == (r * per_rank * Wl,
                                     (r + 1) * per_rank * Wl),
                        f"rank {r} holds columns [{lo}, {hi})")
            for name, what, n in (
                    ("vmap", "graphed" if graphed else "eager", MP_SEAMS),
                    ("vmap-eager", "debug_mode", MP_SEAMS),
                    ("chunked", f"in chunks of {MP_CHUNK}, checkpointed",
                     MP_SEAMS),
                    ("resumed", f"resumed at seam {step}", MP_SEAMS - step)):
                chk.equal("carve", f"rank {r}: multi-process {what} vmap "
                          "columns == single-device", torch.from_numpy(
                              np.load(os.path.join(tmp, f"{name}-{r}.npy")))
                          .to(dev), single.vmap[:, lo:hi])
                want_r = 0 if name == "vmap-eager" else replays(n)
                chk.require(res[name]["replays"] == want_r,
                            f"rank {r}: {what} carve of {n} seams: "
                            f"{res[name]['replays']} graph replays == "
                            f"{want_r}")
            chk.require(res["width"] == W8 - MP_SEAMS,
                        f"rank {r} width {res['width']}")
            for name in ("vmap", "vmap-eager", "chunked"):
                got = {k: res[name]["launches"][k] for k in want}
                chk.require(got == want, f"rank {r} {name} launches {got}")
            chk.require(res["exchanges"] == MP_SEAMS * design
                        and res["exchanges_replays"] == replays(MP_SEAMS),
                        f"rank {r}: {res['exchanges']} exchanges == "
                        f"{MP_SEAMS} x collectives_per_seam {design}, "
                        f"{res['exchanges_replays']} of the seams replayed")
            chk.require(res["manifest"] == {"process": r, "shards": [
                f"shard-{s:05d}.npz" for s in range(r * per_rank,
                                                    (r + 1) * per_rank)]},
                        f"rank {r} manifest {res['manifest']}")
            chk.require(res["health"]["healthy"]
                        and res["health"]["processes"] == nproc,
                        f"rank {r} probe {res['health']}")
        one = spatial_carve_n_seams(luma, MP_SEAMS, devices=[dev] * MP_SHARDS,
                                    resume_from=os.path.join(tmp, "ck"))
        chk.equal("carve", f"their checkpoint resumed on one controller, "
                  f"{MP_SHARDS} shards == single-device", one.vmap,
                  single.vmap)

    # the metrics of record: the ms a seam of each carve, graphed and
    # eager in turns, and one exchange timed alone
    for mode in [m for m in ("graphed", "eager") if m in results[0]["timed"]]:
        turns = list(zip(*(res["timed"][mode] for res in results)))
        slowest = [[max(w[j][1] for w in turn) for j in (0, 1)]
                   for turn in turns]
        ms = [[mp_ms_a_seam(w, c) for w, c in zip(res["timed"][mode],
                                                  slowest)]
              for res in results]
        log(f"  multi-process carve, {mode} ({backend}, {nproc} x {per_rank} "
            f"shards): {ms!r} ms a seam by rank and turn (marginal of "
            f"{MP_TIMED} and {2 * MP_TIMED} seams, the slowest capture "
            f"taken out; "
            f"(wall, capture) s {[res['timed'][mode] for res in results]!r})"
            f" ({card})")
    launches = results[0]["vmap"]["launches"]
    log(f"  a carve of {MP_SEAMS} seams by rank: capture ms "
        f"{[res['vmap']['capture_ms'] for res in results]!r}, replays "
        f"{[res['vmap']['replays'] for res in results]!r}, exchanges a seam "
        f"{[res['exchanges'] / MP_SEAMS for res in results]!r} "
        f"(collectives_per_seam {design}), launches a seam (replays "
        f"credited) {sum(launches.values()) / MP_SEAMS!r}: "
        f"{ {k: v / MP_SEAMS for k, v in launches.items() if v}!r}")
    for res in results if graphed else ():
        b, pr = res["busy"], res["profile"]
        n = 2 * MP_TIMED
        top = [(k[:48], us / n / 1e3, c) for k, us, c in pr["top"]]
        log(f"  rank {res['rank']}, a graphed carve of {n} seams: "
            f"{b['replays']} replays of {b['replay_ms'] / b['replays']!r} "
            f"device ms each by CUDA events, idle between replays "
            f"{b['idle_between_replays_ms']!r} ms in all, before the first "
            f"{b['before_first_replay_ms']!r} ms, wall {b['wall_ms']!r} ms "
            f"(capture included); profiled: kernels "
            f"{pr['device_us'] / n / 1e3!r} device ms a seam, busy "
            f"{pr['busy_us'] / 1e3!r} of {pr['wall_ms']!r} ms; top (name, "
            f"device ms a seam, count) {top!r} ({card})")
    log(f"  one exchange of a one-float shard alone, by rank: shift "
        f"{[r['shift_us'] for r in results]!r} us, psum "
        f"{[r['psum_us'] for r in results]!r} us ({backend}; {card})")
    del luma, single

    on = f"{count} cards" if count >= MP_SHARDS else f"{dev} x {MP_SHARDS}"
    log(f"phase 6: dryrun_multichip({MP_SHARDS}) on {on}")
    t = time.perf_counter()
    dryrun_multichip(MP_SHARDS, devices=None if count >= MP_SHARDS
                     else [dev] * MP_SHARDS)
    chk.require(True, f"dryrun_multichip({MP_SHARDS}) in "
                f"{time.perf_counter() - t!r} s")
    return [res["vmap"]["launches"] for res in results]


def sync_cards() -> None:
    """Wait for every visible card."""
    import torch

    for i in range(torch.cuda.device_count()):
        torch.cuda.synchronize(i)


@contextlib.contextmanager
def replay_events():
    """Time every CUDA graph replay inside the block between CUDA events on
    each of its cards' current streams: yields a list that gets, a replay,
    one (start, end) event pair a card (the first the card the graph was
    captured on)."""
    import torch

    from dct_carver_tpu_torch.utils import graphs

    replay = graphs.StepGraphs.replay
    marks = []

    def timed(self, src):
        streams = [torch.cuda.current_stream(d) for d in self.devices]
        starts = [torch.cuda.Event(enable_timing=True) for _ in streams]
        for e, s in zip(starts, streams):
            e.record(s)
        replay(self, src)
        ends = [torch.cuda.Event(enable_timing=True) for _ in streams]
        for e, s in zip(ends, streams):
            e.record(s)
        marks.append(list(zip(starts, ends)))

    graphs.StepGraphs.replay = timed
    try:
        yield marks
    finally:
        graphs.StepGraphs.replay = replay


def phase_7(chk: Checks, card: str, rng) -> list:
    """Several cards of one controller: the spatial route over each layout
    of MC_LAYOUTS that the visible cards hold (7a), then the batch route
    over every visible card (7b).  Returns the launch counts of 7a's
    graphed carves."""
    import torch

    count = torch.cuda.device_count()
    runs = []
    for name, cards, per_card in MC_LAYOUTS:
        if count < cards:
            log(f"phase 7a: {count} card(s) visible: the spatial route over "
                f"{name} (cards x shards a card) on one controller needs "
                f"{cards} cards; skipped")
            continue
        mesh = [torch.device("cuda", i) for i in range(cards)
                for _ in range(per_card)]
        runs.append(phase_7a(chk, card, rng, name, mesh))
    if count < 2:
        log(f"phase 7b: {count} card visible: the batch route over every "
            f"visible card needs two or more; skipped")
    else:
        phase_7b(chk, card, count)
    return runs


def phase_7a(chk: Checks, card: str, rng, name: str, mesh: list) -> dict:
    """The 8K luma over `mesh`, stacks on several cards of this process:
    every seam after the first a replay of one graph over all its cards.
    Returns the launch counts of its graphed 16-seam carve."""
    import os
    import tempfile

    import torch

    from dct_carver_tpu_torch import api, kernels
    from dct_carver_tpu_torch.ops.carve import carve_n_seams
    from dct_carver_tpu_torch.parallel.mesh import make_mesh
    from dct_carver_tpu_torch.parallel.spatial import (
        collectives_per_seam, measure_collectives_per_seam,
        spatial_carve_n_seams, spatial_carve_seams, spatial_make_state)
    from dct_carver_tpu_torch.utils.debug import debug_mode

    def eager():
        return debug_mode(nan_checks=False, disable_jit=True)

    def same(a, b, what):
        chk.require(a.shape == b.shape and np.array_equal(a, b), what)

    stacks = len({d.index for d in mesh})
    nb = -(-H8 // K8)
    home = mesh[0]
    log(f"phase 7a: spatial_carve_n_seams({H8}x{W8}, {MC_SEAMS}) over {name} "
        f"(cards x shards a card), one controller, n=8, K={K8}: the first "
        f"seam eager, then one graph over the {stacks} cards a seam")
    luma8 = torch.from_numpy(rng.random((H8, W8), dtype=np.float32)).to(home)
    single = carve_n_seams(luma8, 2 * MC_SEAMS, 8, 0.0, 1.0).vmap

    def first(k):
        return torch.where(single <= k, single, 0)

    spatial_carve_n_seams(luma8[:2 * K8, :1024], 2, devices=mesh)  # warm-up
    sync_cards()
    kernels.reset_launches()
    with count_replays() as replays:
        res = spatial_carve_n_seams(luma8, MC_SEAMS, devices=mesh)
        sync_cards()
    launches = kernels.launch_counts()
    log(f"  launches on the {name} spatial route: {launches}")
    chk.require(replays[0] == MC_SEAMS - 1,
                f"{name}: {replays[0]} graph replays for {MC_SEAMS} seams")
    want = {"block_dp_parts": stacks * nb * MC_SEAMS,
            "seg_walk": stacks * nb * MC_SEAMS,
            "sharded_apply": stacks * MC_SEAMS, "strip": stacks * MC_SEAMS,
            "energy": stacks, "block_dp": 0, "find_seam": 0,
            "find_seams": 0, "find_seam_tiled": 0, "apply": 0}
    got = {k: launches[k] for k in want}
    chk.require(got == want, f"{name} spatial launches {got} (one a stack "
                f"a block, {stacks} stacks)")
    chk.equal("carve", f"{name} {MC_SEAMS}-seam vmap == single-device",
              res.vmap, first(MC_SEAMS))
    with count_replays() as replays, eager():
        e = spatial_carve_n_seams(luma8, MC_SEAMS, devices=mesh)
    chk.require(replays[0] == 0, f"{name} under debug_mode: {replays[0]} "
                f"replays")
    chk.equal("carve", f"{name} debug_mode vmap == single-device", e.vmap,
              first(MC_SEAMS))
    with tempfile.TemporaryDirectory(prefix="dct_carver_smoke_") as tmp:
        ck = os.path.join(tmp, "ck")
        with count_replays() as replays:
            chunked = spatial_carve_n_seams(luma8, MC_SEAMS, devices=mesh,
                                            chunk=MC_CHUNK, checkpoint_dir=ck)
        chk.require(replays[0] == MC_SEAMS - 1,
                    f"{name} in chunks of {MC_CHUNK}: {replays[0]} replays")
        chk.equal("carve", f"{name} chunks of {MC_CHUNK} == single-device",
                  chunked.vmap, first(MC_SEAMS))
        done = (MC_SEAMS - 1) // MC_CHUNK * MC_CHUNK
        with count_replays() as replays:
            resumed = spatial_carve_n_seams(luma8, MC_SEAMS, devices=mesh,
                                            resume_from=ck)
        chk.require(replays[0] == MC_SEAMS - done - 1,
                    f"{name} resumed at seam {done}: {replays[0]} replays")
        chk.equal("carve", f"{name} resumed at seam {done} == single-device",
                  resumed.vmap, first(MC_SEAMS))
    st, smesh = spatial_make_state(luma8, devices=mesh)
    sync_cards()
    smesh.exchanges = 0
    spatial_carve_seams(st, smesh, 0, MC_SEAMS)
    designed = collectives_per_seam(H8, K8, fused_apply=True)
    chk.require(smesh.exchanges == MC_SEAMS * designed,
                f"{name} exchanges under replay {smesh.exchanges} == "
                f"{MC_SEAMS} x collectives_per_seam {designed}")
    m = measure_collectives_per_seam(H8, W8, mesh, use_pallas=True)
    chk.require(m["total"] == m["designed"] == designed,
                f"{name} exchanges a seam {m['total']} == "
                f"collectives_per_seam {m['designed']}")
    del st, smesh, e, chunked, resumed

    # api.carve on the spatial route, the default mesh where it is this one
    img = rng.integers(0, 256, (H8, W8, 3), dtype=np.uint8)
    devices = None if mesh == make_mesh() else mesh
    kw = dict(output_seams=True, parallel="spatial", devices=devices)
    with count_replays() as replays:
        a = api.carve(img, -MC_SEAMS, **kw)
    chk.require(replays[0] == MC_SEAMS - 1,
                f"{name} api.carve(parallel='spatial', devices="
                f"{'None' if devices is None else name}): {replays[0]} "
                f"replays")
    with count_replays() as replays, eager():
        d = api.carve(img, -MC_SEAMS, **kw)
    chk.require(replays[0] == 0, f"{name} api.carve under debug_mode: "
                f"{replays[0]} replays")
    b = api.carve(img, -MC_SEAMS, output_seams=True, device=str(home))
    for field in ("image", "visibility_map"):
        same(getattr(a, field), getattr(b, field),
             f"{name} spatial api.carve {field} == single-image route")
        same(getattr(d, field), getattr(b, field),
             f"{name} spatial api.carve under debug_mode {field} == "
             f"single-image route")
    del img, a, b, d

    # ms a seam: the marginal of 16 and 32 seams, each carve's capture taken
    # out, graphed and under debug_mode in turns
    def wall(seams, graphed):
        sync_cards()
        t = time.perf_counter()
        with contextlib.nullcontext() if graphed else eager():
            r = spatial_carve_n_seams(luma8, seams, devices=mesh)
        sync_cards()
        return time.perf_counter() - t - r.capture_seconds, r.capture_seconds

    per_seam = {"graphed": [], "eager (debug_mode)": []}
    captures = []
    for turn in range(MC_TURNS):
        for mode in list(per_seam)[::1 if turn % 2 == 0 else -1]:
            (w16, c16), (w32, c32) = (wall(s, mode == "graphed")
                                      for s in (MC_SEAMS, 2 * MC_SEAMS))
            per_seam[mode].append((w32 - w16) / MC_SEAMS * 1e3)
            if mode == "graphed":
                captures += [c16 * 1e3, c32 * 1e3]
    for mode, ms in per_seam.items():
        log(f"  {name} {mode}: {ms!r} ms a seam (marginal of {MC_SEAMS} and "
            f"{2 * MC_SEAMS} seams, captures out; {card})")
    log(f"  {name} capture ms a carve (two graphs over {stacks} cards): "
        f"{captures!r} ({card})")
    with replay_events() as marks:
        spatial_carve_n_seams(luma8, 2 * MC_SEAMS, devices=mesh)
        sync_cards()
    by_card = [[a.elapsed_time(b) for a, b in col] for col in zip(*marks)]
    for d, ms in zip(sorted({x.index for x in mesh},
                            key=[x.index for x in mesh].index), by_card):
        ms = sorted(ms)
        log(f"  {name} device ms a replay on cuda:{d} (CUDA events, "
            f"{len(ms)} replays): min {ms[0]!r}, median {ms[len(ms) // 2]!r}"
            f", max {ms[-1]!r} ({card})")
    wall_p, _, top, busy_us = device_profile(
        lambda: spatial_carve_n_seams(luma8, 2 * MC_SEAMS, devices=mesh),
        top=40)
    reps = 2 * MC_SEAMS - 1
    log(f"  profiled {2 * MC_SEAMS}-seam carve over {name}: wall "
        f"{wall_p * 1e3!r} ms, device busy (union over the cards) "
        f"{busy_us / 1e3!r} ms; rows over {reps} replays and the eager "
        f"first seam ({card}):")
    for row, (kname, us, n) in enumerate(top):
        if row < 16 or "emcpy" in kname or "opy" in kname:
            log(f"    {us / 1e3 / reps:10.5f} ms a replay  {n:6d} x  "
                f"{kname[:90]}")
    del luma8, single, res
    return launches


def phase_7b(chk: Checks, card: str, count: int) -> None:
    """Config 4's whole batch, NB_CARDS images, over every visible card by
    the default placement, against each card's chunk carved on one card
    alone, timed in turns with one card's share carved alone; each card's
    busy share and the join by CUDA events; torch's sync debug mode lists
    any host wait inside the carve."""
    import warnings
    from collections import Counter

    import torch

    from dct_carver_tpu_torch.parallel import mesh as pmesh
    from dct_carver_tpu_torch.utils.graphs import CAPTURES

    cards = [torch.device("cuda", i) for i in range(count)]
    per = NB_CARDS // count
    log(f"phase 7b: carve_batch of {NB_CARDS} x {HB}x{WB}x3, n=8, "
        f"{SEAMS_B} seams, reconstruct included, over the default placement "
        f"(every visible card: {count}, {per} images a card)")
    gen = torch.Generator(device=cards[0])
    gen.manual_seed(SEED + 7)
    imgs = torch.randint(0, 256, (NB_CARDS, HB, WB, 3), dtype=torch.uint8,
                         device=cards[0], generator=gen)
    caught_at = dict(CAPTURES)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out, vm = pmesh.carve_batch(imgs, SEAMS_B)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    sync_cards()
    sites = Counter(f"{Path(w.filename).name}:{w.lineno}" for w in caught
                    if "called a synchronizing" in str(w.message))
    graphs = CAPTURES["graphs"] - caught_at["graphs"]
    log(f"  host waits inside carve_batch over {count} cards (torch's sync "
        f"debug mode): {dict(sites)}; {graphs} graphs captured in "
        f"{(CAPTURES['seconds'] - caught_at['seconds']) * 1e3!r} ms")
    chk.require(out.shape == (NB_CARDS, HB, WB - SEAMS_B, 3)
                and vm.shape == (NB_CARDS, HB, WB)
                and out.device == vm.device == cards[0],
                f"{NB_CARDS}-image carve_batch joined on cuda:0")
    for k in range(count):
        part = slice(k * per, (k + 1) * per)
        o, v = pmesh.carve_batch(imgs[part], SEAMS_B, devices=[cards[0]])
        chk.equal("carve", f"batch over {count} cards, chunk {k}: vmaps == "
                  f"carved on cuda:0 alone", vm[part], v)
        chk.equal("carve", f"batch over {count} cards, chunk {k}: images == "
                  f"carved on cuda:0 alone", out[part], o)
        del o, v
    del out, vm
    walls = {f"{NB_CARDS} over {count} cards": [], f"{per} on cuda:0": []}
    for turn in range(BATCH_TURNS):
        for route in list(walls)[::1 if turn % 2 == 0 else -1]:
            x = imgs if route.startswith(str(NB_CARDS)) else imgs[:per]
            sync_cards()
            t = time.perf_counter()
            r = pmesh.carve_batch(x, SEAMS_B, devices=None if x is imgs
                                  else [cards[0]])
            sync_cards()
            walls[route].append(time.perf_counter() - t)
            del r
    for route, ts in walls.items():
        n = NB_CARDS if route.startswith(str(NB_CARDS)) else per
        rates = [n * HB * WB * SEAMS_B / t / 1e6 for t in ts]
        log(f"  carve_batch {route}: {[t * 1e3 for t in ts]!r} ms, "
            f"{rates!r} Mpix/s ({card})")
    # each card's chunk between CUDA events on its stream, against the
    # carve's span there from the call to the join
    chunk_fn = pmesh._carve_chunk
    marks = {}

    def timed_chunk(chunk, dev, *args, **kw):
        s = torch.cuda.current_stream(dev)
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record(s)
        got = chunk_fn(chunk, dev, *args, **kw)
        b.record(s)
        marks[dev.index] = (a, b)
        return got

    starts, ends = ({d.index: torch.cuda.Event(enable_timing=True)
                     for d in cards} for _ in range(2))
    sync_cards()
    for d in cards:
        starts[d.index].record(torch.cuda.current_stream(d))
    t = time.perf_counter()
    pmesh._carve_chunk = timed_chunk
    try:
        r = pmesh.carve_batch(imgs, SEAMS_B)
    finally:
        pmesh._carve_chunk = chunk_fn
    for d in cards:
        ends[d.index].record(torch.cuda.current_stream(d))
    sync_cards()
    wall = time.perf_counter() - t
    chunk_end = {}
    for d in cards:
        i = d.index
        a, b = marks[i]
        offset, span = starts[i].elapsed_time(a), a.elapsed_time(b)
        total = starts[i].elapsed_time(ends[i])
        chunk_end[i] = starts[i].elapsed_time(b)
        log(f"  cuda:{i}: its chunk starts {offset!r} ms into the carve and "
            f"runs {span!r} ms, busy {100 * span / total!r} % of the "
            f"carve's {total!r} ms span on the card ({card})")
    join = starts[0].elapsed_time(ends[0]) - max(chunk_end.values())
    log(f"  the join on cuda:0 after the last chunk: {join!r} ms; wall "
        f"{wall * 1e3!r} ms, {NB_CARDS * HB * WB * SEAMS_B / wall / 1e6!r} "
        f"Mpix/s ({card})")
    del r, imgs


def main() -> int:
    import torch
    from benchlib.work import dct_ops

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "false)", file=sys.stderr)
        return 2
    import dct_carver_tpu_torch
    if Path(dct_carver_tpu_torch.__file__).resolve().parents[1] != ROOT:
        print(f"chip_smoke: dct_carver_tpu_torch comes from "
              f"{dct_carver_tpu_torch.__file__}, not from {ROOT}",
              file=sys.stderr)
        return 2

    from dct_carver_tpu_torch import api, kernels
    from dct_carver_tpu_torch.kernels import build
    from dct_carver_tpu_torch.kernels.apply_kernel import apply_seam
    from dct_carver_tpu_torch.kernels.dp_kernel import (
        KERNEL, MAX_WIDTH, TILED_KERNEL, _find_seams_one_cta, find_seam,
        seam_route)
    from dct_carver_tpu_torch.kernels.energy_kernel import dct_energy
    from dct_carver_tpu_torch.kernels.strip_kernel import strip_update
    from dct_carver_tpu_torch.models.carver import Carver
    from dct_carver_tpu_torch.ops.carve import carve_n_seams, clear_step_cache
    from dct_carver_tpu_torch.ops.energy import to_luma
    from dct_carver_tpu_torch.utils.graphs import CAPTURES

    # ---------------------------------------------------------- phase 0 --
    card = card_line()
    dev = torch.device("cuda", 0)
    log(f"phase 0: {torch.cuda.get_device_name(0)} | nvidia-smi: {card} | "
        f"torch {torch.__version__} cuda {torch.version.cuda}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    build.load()
    info = build.build_info()
    log(f"  kernels built in {info.seconds:.1f} s "
        f"(load {time.perf_counter() - t0:.1f} s): {info.path}")
    for line in info.log.splitlines():
        if any(w in line for w in ("entry function", "registers", "spill")):
            log(f"  ptxas: {line.strip()}")

    rng = np.random.default_rng(SEED)
    chk = Checks()
    edges, textures = 0.3, 0.7

    def on_card(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    # ---------------------------------------------------------- phase 1 --
    log(f"phase 1: kernels vs plain versions on the card ({H}x{W}, "
        f"{H4}x{W4})")
    luma = on_card(rng.random((H, W), dtype=np.float32))
    luma_q = on_card((rng.integers(0, 3, (H, W)) / 2).astype(np.float32))
    luma4 = on_card(rng.random((H4, W4), dtype=np.float32))

    def one_cta(e, width, tie="leftmost"):
        """find_seam.cu through its C entry, whatever the route says."""
        return _find_seams_one_cta(KERNEL, e[None], width, 0, tie)[0]

    def seam_pair(name, e, width, tie):
        """find_seam.cu and the routed find_seam against the plain version;
        the routed result is the seam (kernel as seam_route picks it)."""
        want = find_seam(e, width, tie=tie, use_pallas=False)
        chk.equal("find_seam", f"{name} {tie}", one_cta(e, width, tie), want)
        routed = seam_route(1, e.shape[1])
        got = find_seam(e, width, tie=tie)
        if routed == "tiled":
            chk.equal("find_seam_tiled", f"{name} {tie} (routed)", got, want)
        return got

    def energy_pair(x, n, center="carve"):
        return (dct_energy(x, n, edges, textures, center=center),
                dct_energy(x, n, edges, textures, center=center,
                           use_pallas=False))

    for n in (2, 4, 8, 16):
        for center in ("carve", "preview"):
            chk.equal("energy", f"{H}x{W} n={n} {center}",
                      *energy_pair(luma, n, center))
    chk.equal("energy", f"{H}x{W} n=8 quantized luma",
              *energy_pair(luma_q, 8))
    chk.equal("energy", f"{H4}x{W4} n=16", *energy_pair(luma4, 16))
    ragged = luma[: H - 3, : W - 7].contiguous()  # no multiple of a block
    for n in (8, 16):
        chk.equal("energy", f"{H - 3}x{W - 7} n={n}", *energy_pair(ragged, n))

    E = dct_energy(luma, 8, edges, textures)
    E_q = on_card((rng.integers(0, 4, (H, W)) / 4).astype(np.float32))
    E4 = dct_energy(luma4, 16, edges, textures)
    E_r = dct_energy(ragged, 8, edges, textures)
    for name, e, width in (("1080p energy", E, W),
                           ("1080p energy width=W-37", E, W - 37),
                           ("1080p quantized energy", E_q, W),
                           (f"{H - 3}x{W - 7} energy", E_r, W - 7),
                           ("4K n=16 energy", E4, W4)):
        for tie in ("leftmost", "rightmost"):
            seam_pair(name, e, width, tie)
    # 8K: the frontier (2 * 7680 f32) is past the 48 KB default of shared
    # memory, so this takes find_seam.cu's opt-in launch
    E8 = on_card(rng.random((4320, 7680), dtype=np.float32))
    seam_pair("4320x7680 random energy", E8, 7680, "leftmost")
    del E8
    # the edges of the chunked rows and of the windowed backtrack (64-row
    # windows of 129 columns): planes narrower than a window, seams along
    # each border, rows not a multiple of 4 (4-byte staging), and widths
    # near MAX_WIDTH (a few rows: the widest chunk and one ring slot)
    edge_cases = []
    for h, w in ((H, 100), (H, 129), (H, 5), (H, 1), (301, 130)):
        edge_cases.append((f"{h}x{w} quantized",
                           on_card((rng.integers(0, 3, (h, w)) / 2)
                                   .astype(np.float32)), w))
    for col in ("0", "W-1"):
        border = np.ones((H, W), np.float32)
        border[:, 0 if col == "0" else W - 1] = 0
        edge_cases.append((f"1080p seam along column {col}", on_card(border),
                           W))
    narrow = np.ones((H, 100), np.float32)
    narrow[:, 99] = 0
    edge_cases.append(("1080x100 seam along column W-1", on_card(narrow),
                       100))
    for w in (MAX_WIDTH, MAX_WIDTH - 3, 29024, 16385):
        edge_cases.append((f"6x{w} random", on_card(rng.random(
            (6, w), dtype=np.float32)), w - 11))
    for name, e, width in edge_cases:
        for tie in TIES:
            got = seam_pair(name, e, width, tie)
            if "along" in name:
                col = 0 if name.endswith("column 0") else e.shape[1] - 1
                chk.require(bool((got == col).all()),
                            f"{name} {tie}: the seam runs along it")
    del edge_cases

    origcol = on_card(rng.integers(0, 4 * W, (H, W)).astype(np.int32))
    for mode in ("interior", "left", "right-edge", "shrunk"):
        width = W - 5 if mode == "shrunk" else W
        if mode == "interior":
            s = (np.cumsum(rng.integers(-1, 2, H)) + 100) % (width - 2) + 1
        elif mode == "left":
            s = np.minimum(np.arange(H), 2)
        elif mode == "right-edge":
            s = np.full(H, width - 1)
        else:
            s = np.full(H, width - 3)
        seam = on_card(s.astype(np.int32))
        got = apply_seam(luma, origcol, E, seam, width)
        want = apply_seam(luma, origcol, E, seam, width, use_pallas=False)
        for part, g, w_ in zip(("luma", "origcol", "energy"), got, want):
            chk.equal("apply", f"1080p {mode} {part}", g, w_)
    # the seam lies inside the live width, as the carve's DP gives it
    seam4 = find_seam(E4, W4 - 2)
    oc4 = torch.zeros_like(luma4, dtype=torch.int32)
    for part, g, w_ in zip(
            ("luma", "origcol", "energy"),
            apply_seam(luma4, oc4, E4, seam4, W4 - 2),
            apply_seam(luma4, oc4, E4, seam4, W4 - 2, use_pallas=False)):
        chk.equal("apply", f"4K width=W-2 {part}", g, w_)

    for name, x, n in (("1080p n=2", luma, 2), ("1080p n=4", luma, 4),
                       ("1080p n=8", luma, 8), ("4K n=16", luma4, 16),
                       (f"{H - 3}x{W - 7} n=16", ragged, 16)):
        e0 = dct_energy(x, n, edges, textures)
        seam = find_seam(e0, x.shape[1])
        l1, _, e1 = apply_seam(x, torch.zeros_like(x, dtype=torch.int32),
                               e0, seam, x.shape[1], use_pallas=False)
        k = strip_update(l1, e1.clone(), seam, n, edges, textures)
        p = strip_update(l1, e1.clone(), seam, n, edges, textures,
                         use_pallas=False)
        chk.equal("strip", f"{name} after one seam", k, p)
        live = x.shape[1] - 1
        full = dct_energy(l1, n, edges, textures, use_pallas=False)
        chk.equal("strip", f"{name} == full recompute (live columns)",
                  k[:, :live].contiguous(), full[:, :live].contiguous())

    # per-kernel times at the 1080p n=8 main-path shapes
    seam = find_seam(E, W)
    outs = tuple(torch.empty_like(t) for t in (luma, origcol, E))
    e_strip = E.clone()
    times = {}
    time_kernel(times, "energy", lambda: dct_energy(luma, 8, edges, textures),
                lambda: dct_energy(luma, 8, edges, textures,
                                   use_pallas=False), 20, 3)
    time_kernel(times, "find_seam", lambda: one_cta(E, W),
                lambda: find_seam(E, W, use_pallas=False), 20, 2)
    time_kernel(times, "apply",
                lambda: apply_seam(luma, origcol, E, seam, W, out=outs),
                lambda: apply_seam(luma, origcol, E, seam, W,
                                   use_pallas=False), 50, 20)
    time_kernel(times, "strip",
                lambda: strip_update(luma, e_strip, seam, 8, edges, textures),
                lambda: strip_update(luma, e_strip, seam, 8, edges, textures,
                                     use_pallas=False), 50, 20)
    for name, (k_ms, p_ms) in times.items():
        log(f"  {name:9s} kernel {k_ms!r} ms, plain {p_ms!r} ms "
            f"(1080x1920 n=8; {card})")
    sw8 = 20  # the n=8 strip's width (ops/strip.py::_strip_extent)
    BOUNDS.update({
        "energy": (8 * H * W, dct_ops(8, H * W, H * W)),
        "find_seam": (4 * H * W + 4 * H, 3 * H * W),
        "apply": (24 * H * W + 4 * H, 0),
        "strip": (4 * (H * (sw8 + 7) + H * sw8 + H),
                  dct_ops(8, H * sw8, H * (sw8 + 7))),
    })
    # apply as one torch.gather of the three planes' bits
    planes = torch.stack([luma, E, origcol.view(torch.float32)])
    cols = torch.arange(W, device=dev)
    index = torch.where(cols < seam[:, None], cols, (cols + 1) % W).expand(
        3, H, W).contiguous()
    time_library("apply", lambda: torch.gather(planes, 2, index))
    del planes, index

    phase_1b(dev, chk, card, rng)
    wide_launches = phase_1c(dev, chk, card, rng, times)

    # ---------------------------------------------------------- phase 2 --
    log(f"phase 2: api.carve({H}x{W}x3, -{SEAMS}, blocksize=8) on the card:"
        " the first seam of a shape's first carve eager, then one CUDA graph "
        "replay a seam")
    img = rng.integers(0, 256, (H, W, 3), dtype=np.uint8)
    kw = dict(blocksize=8, output_seams=True, output_energy=True,
              device="cuda")
    api.carve(img[:64, :256], -4, **kw)  # warm-up (allocator, streams)
    torch.cuda.synchronize()
    want = {**dp_launches(1, W, SEAMS), "apply": SEAMS, "strip": SEAMS}
    walls = []
    for run in ("first", "warm"):
        kernels.reset_launches()
        captures = dict(CAPTURES)
        with count_replays() as replays:
            t = time.perf_counter()
            res = api.carve(img, -SEAMS, **kw)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t)
        got = kernels.launch_counts()
        if run == "first":
            launches = got
            log(f"  launches on the main path: {launches}")
            log(f"  the step's graphs hold the tiled find-seam's cooperative "
                f"launch (cudaLaunchCooperativeKernel under stream capture; "
                f"torch {torch.__version__}, CUDA {torch.version.cuda}; "
                f"{card})")
            chk.require(launches["energy"] >= 1, "energy kernel launched")
        for name, n in want.items():
            chk.require(got[name] == n,
                        f"{run} carve: {name} kernel launched {n} times")
        chk.require(TILED_KERNEL.split_forwards == SEAMS,
                    f"{run} carve: split_forwards "
                    f"{TILED_KERNEL.split_forwards} of {SEAMS} tiled calls")
        need = SEAMS - 1 if run == "first" else SEAMS
        chk.require(replays[0] == need,
                    f"{run} headline api.carve: {replays[0]} graph replays "
                    f"for {SEAMS} seams (want {need})")
        log(f"  {run} headline api.carve: {walls[-1] * 1e3!r} ms wall, host "
            f"copies included; {replays[0]} replays; "
            f"{CAPTURES['graphs'] - captures['graphs']} graphs captured in "
            f"{(CAPTURES['seconds'] - captures['seconds']) * 1e3!r} ms "
            f"({card})")

    plain = api.carve(img, -SEAMS, use_pallas=False, **kw)
    for field in ("image", "visibility_map", "energy_image"):
        a, b = getattr(res, field), getattr(plain, field)
        chk.require(a.shape == b.shape and np.array_equal(a, b),
                    f"api.carve {field} == plain path on the card")
    vm = res.visibility_map
    chk.require(res.image.shape == (H, W - SEAMS, 3)
                and res.energy_image.shape == (H, W)
                and res.energy_image.dtype == np.uint8,
                "output shapes and types")
    chk.require(all(((vm == k).sum(axis=1) == 1).all()
                    for k in range(1, SEAMS + 1)),
                "one removed pixel per row per seam")
    small = img[:48, :96]
    a = api.carve(small, -12, **kw)
    b = api.carve(small, -12, blocksize=8, output_seams=True,
                  output_energy=True, device="cpu")
    chk.require(all(np.array_equal(getattr(a, f), getattr(b, f))
                    for f in ("image", "visibility_map", "energy_image")),
                "48x96 carve on the card == the same carve on the CPU")

    # the graphed carve against the eager kernel carve and the plain path
    x = to_luma(on_card(img))
    hold_graphed(chk, f"headline {H}x{W} n=8 {SEAMS} seams",
                 carve_n_seams(x, SEAMS, 8, 0.0, 1.0),
                 eager_kernel_carve(x, SEAMS, 8, 0.0, 1.0),
                 carve_n_seams(x, SEAMS, 8, 0.0, 1.0, use_pallas=False))

    def walls_s(use_pallas: bool, repeats: int) -> list:
        """Wall seconds of `repeats` carves of fresh images of one shape,
        the first with an empty step cache (its capture included)."""
        clear_step_cache()
        secs = []
        for _ in range(repeats):
            x = to_luma(on_card(rng.integers(0, 256, (H, W, 3),
                                             dtype=np.uint8)))
            torch.cuda.synchronize()
            t = time.perf_counter()
            carve_n_seams(x, SEAMS, 8, 0.0, 1.0, use_pallas=use_pallas)
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t)
        return secs

    px = H * W * SEAMS
    captures = dict(CAPTURES)
    k_secs = walls_s(True, 4)
    capture_ms = (CAPTURES["seconds"] - captures["seconds"]) * 1e3
    warm = [px / t / 1e6 for t in k_secs[1:]]
    k_rate = max(warm)
    p_rate = px / walls_s(False, 1)[0] / 1e6
    log(f"  headline carve {H}x{W} n=8 {SEAMS} seams: kernel path, first "
        f"carve {k_secs[0] * 1e3!r} ms wall (capture {capture_ms!r} ms "
        f"included), warm carves {[t * 1e3 for t in k_secs[1:]]!r} ms: "
        f"{warm!r} Mpix/s, spread {100 * (max(warm) / min(warm) - 1)!r} %; "
        f"plain path {p_rate!r} Mpix/s ({card})")

    capture_costs(to_luma(on_card(img)), CAPTURE_SAMPLES, card)

    # where the time of the headline carve goes, by kernel, under the profiler
    x = to_luma(on_card(img))
    log_event_busy("headline carve (warm)",
                   lambda: carve_n_seams(x, SEAMS, 8, 0.0, 1.0), dev, card)
    wall, kernel_us, top, busy_us = device_profile(
        lambda: carve_n_seams(x, SEAMS, 8, 0.0, 1.0), top=12,
        gaps="profiled headline carve")
    log(f"  profiled headline carve (warm: a replay every seam): wall "
        f"{wall * 1e3!r} ms, device busy {busy_us / 1e3!r} ms "
        f"({100 * busy_us / 1e6 / wall!r} % of wall; kernel time summed "
        f"{kernel_us / 1e3!r} ms; {card})")
    wall_d, _, _, busy_d = device_profile(
        lambda: carve_n_seams(x, SEAMS, 8, 0.0, 1.0), host=False,
        gaps="headline carve, device traced alone")
    log(f"  headline carve with the device traced alone: wall "
        f"{wall_d * 1e3!r} ms, device busy {busy_d / 1e3!r} ms "
        f"({100 * busy_d / 1e6 / wall_d!r} % of wall; {card})")
    for name, us, count in top:
        log(f"    {us / 1e3:10.4f} ms  {count:5d} x  {name[:90]}")

    log(f"phase 2b: bidirectional {H4}x{W4} resize, n=16")
    img4 = rng.integers(0, 256, (H4, W4, 3), dtype=np.uint8)
    few = 3
    ka = Carver(img4, blocksize=16, output_seams=True,
                device="cuda").resize(W4 - few, H4 - few)
    pa = Carver(img4, blocksize=16, output_seams=True, device="cuda",
                use_pallas=False).resize(W4 - few, H4 - few)
    chk.require(np.array_equal(ka.image, pa.image)
                and np.array_equal(ka.visibility_map, pa.visibility_map),
                f"4K bidirectional {few}+{few} seams == plain path")
    torch.cuda.synchronize()
    kernels.reset_launches()
    t = time.perf_counter()
    big = Carver(img4, blocksize=16, device="cuda").resize(
        W4 - SEAMS, H4 - SEAMS)
    torch.cuda.synchronize()
    sec = time.perf_counter() - t
    chk.require(big.image.shape == (H4 - SEAMS, W4 - SEAMS, 3),
                "4K bidirectional output shape")
    chk.require(TILED_KERNEL.split_forwards == 2 * SEAMS,
                f"4K bidirectional: split_forwards "
                f"{TILED_KERNEL.split_forwards} of {2 * SEAMS} tiled calls "
                f"(both passes)")
    px = H4 * W4 * SEAMS + (W4 - SEAMS) * H4 * SEAMS
    log(f"  4K bidirectional {SEAMS}+{SEAMS} seams: {sec!r} s, "
        f"{px / sec / 1e6!r} Mpix/s (kernel path, host round trip "
        f"included; {card})")

    del img4, ka, pa, big
    log("phase 2c: a carve on a card other than the current one")
    other_card(chk, card)
    batch_launches = phase_3(dev, chk, card, rng, times)
    phase_4a(dev, chk, card, rng, times)
    energy_launches = phase_4(dev, chk, card, rng, k_rate)
    phase_5a(dev, chk, card, rng, times)
    spatial_launches = phase_5(dev, chk, card, rng)
    multiproc_launches = phase_6(dev, chk, card)
    # its own generator: on one card its carves are skipped
    multicard_launches = phase_7(chk, card, np.random.default_rng(SEED + 7))
    # last: after one of its runs torch.profiler recorded no device time in
    # most later sessions (PERF.md §7), so nothing is profiled after it
    retarget_launches = phase_2d(dev, chk, card, rng, img, res, plain)

    if chk.failures:
        print("chip_smoke FAILED:\n  " + "\n  ".join(chk.failures),
              file=sys.stderr)
        return 1
    # each kernel's launches on the main paths, each run counted from 0:
    # the wide carve of phase 1c, the single-image carve of phase 2, the
    # retargeter's precomputes of phase 2d, the batch carves of phases 3b and 3c, the plugged-energy carves of phase 4b
    # (grad_norm) and 4c (batch), and the spatial carves of phase 5b (8K
    # over 4 shards, small shards) and 5c (grad_norm), each process's
    # carve of phase 6, and phase 7a's 8K carve over each layout of cards
    runs = (wide_launches, launches, *retarget_launches, *batch_launches,
            *energy_launches, *spatial_launches, *multiproc_launches,
            *multicard_launches)
    rows = []
    for k in kernels.KERNELS:
        bound_ms, bound_by = bound(*BOUNDS[k.name])
        rows.append({
            "name": k.name, "route": "cuda", "source": k.source,
            "replaces": k.replaces,
            "launches": sum(run[k.name] for run in runs),
            "max_abs_err": chk.max_err[k.name], "ms": times[k.name][0],
            "plain_ms": times[k.name][1], "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": LIBRARY.get(k.name),
            "device_ms": DEVICE[k.name],
            "device_ms_source": DEVICE_SOURCE[k.name],
            "library_device_ms": LIBRARY_DEVICE.get(k.name),
            "library_device_ms_source": LIBRARY_DEVICE_SOURCE.get(k.name)})
        if k.name in FLUSHED:
            rows[-1]["device_ms_l2_flushed"] = FLUSHED[k.name]
        if k.name in IN_GRAPH:  # inside the graphed carve, and the floor
            rows[-1].update(device_ms_in_graph=IN_GRAPH[k.name],
                            floor_device_ms=FLOOR["back_to_back"],
                            floor_device_ms_in_graph=FLOOR["in_graph"],
                            floor_device_ms_source=FLOOR["source"])
        if k.name == "band_energy":  # every blocksize, 1080p and B=256
            rows[-1].update(by_shape=BAND,
                            floor_device_ms=FLOOR["back_to_back"])
        if k.name in BATCH:  # the same kernel at phase 3c's batch shape
            (b_ms, b_src), (bb_ms, _) = BATCH[k.name]
            rows[-1].update(batch_device_ms=b_ms, batch_device_ms_source=b_src,
                            batch_bound_ms=bb_ms)
        log(f"  {k.name:14s} {times[k.name][0]!r} ms (device "
            f"{DEVICE[k.name]!r}), bound {bound_ms!r} ms ({bound_by}), "
            f"library {LIBRARY.get(k.name)!r} ms (device "
            f"{LIBRARY_DEVICE.get(k.name)!r}) ({card})")
    by_events = [sorted(k for k, v in src.items() if v != "profiler")
                 for src in (DEVICE_SOURCE, LIBRARY_DEVICE_SOURCE,
                             {k: v[0][1] for k, v in BATCH.items()})]
    log(f"  torch.profiler: {PROFILER_EMPTY[0]} device_ms calls recorded "
        f"no device time and fell back to CUDA events; kernel rows timed so: "
        f"{by_events[0]}, library rows: {by_events[1]}, batch rows: "
        f"{by_events[2]}")
    log(json.dumps({"kernels": rows}))
    log(card)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def multi_card() -> int:
    """--multi-card: build the kernels and run phase 7 alone (the spatial
    route over several cards of one controller, the batch route over every
    visible card); exits non-zero if a check failed."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from dct_carver_tpu_torch.kernels import build

    card = card_line()
    log(f"phase 0: {torch.cuda.device_count()} x "
        f"{torch.cuda.get_device_name(0)} | nvidia-smi: {card}")
    build.load()
    chk = Checks()
    phase_7(chk, card, np.random.default_rng(SEED + 7))
    if chk.failures:
        print("chip_smoke --multi-card FAILED:\n  "
              + "\n  ".join(chk.failures), file=sys.stderr)
        return 1
    log(card)
    return 0


def tiled_forward() -> int:
    """Phase 0's build, then phase 1c's tiled forward alone: the split
    schedule's bitwise cases and `split_forwards` count (`split_1c`), its
    ns a DP row against one warp a tile in turns (`forward_turns`) and the
    sweeps that set its constants (`sweeps_1c`), on card 0."""
    import torch

    from dct_carver_tpu_torch.kernels import build

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    card = card_line()
    dev = torch.device("cuda", 0)
    log(f"tiled forward: {torch.cuda.get_device_name(0)} | nvidia-smi: "
        f"{card} | torch {torch.__version__} cuda {torch.version.cuda}")
    build.load()
    info = build.build_info()
    log(f"  kernels built in {info.seconds:.1f} s: {info.path}")
    for line in info.log.splitlines():
        if any(w in line for w in ("entry function", "registers", "spill")):
            log(f"  ptxas: {line.strip()}")
    rng = np.random.default_rng(SEED)
    chk = Checks()
    split_1c(dev, chk, card, rng)
    forward_turns(dev, chk, card, rng)
    sweeps_1c(dev, card, rng)
    for f in chk.failures:
        log(f"FAILED: {f}")
    log(f"tiled forward: {len(chk.failures)} failures ({card})")
    return 1 if chk.failures else 0


# --first-carve: the carves of a one-shot process (a CLI call, a script that
# carves one image), each the first of its shape: the headline and a 4K
# image, then the same shape again
FIRST_SHAPES = ((H, W), (H4, W4))


def first_carve(root: str) -> int:
    """Time, on the host, the carves of one process with the
    dct_carver_tpu_torch found under `root` (this checkout, or another
    commit's unpacked in a directory .gitignore lists): for each of
    FIRST_SHAPES a first 64-seam `api.carve` of an RGB image (the seam
    step's one-time costs: for a checkout that graphs the step, its eager
    first seam and the capture) and a second one of a new image of the
    shape.  The kernels are built (or loaded) and the CUDA context made
    before the first carve, and timed apart.  Prints one JSON line."""
    import importlib

    root_path = Path(root).resolve()
    sys.path.insert(0, str(root_path))
    t = time.perf_counter()
    import torch
    pkg = importlib.import_module("dct_carver_tpu_torch")
    if Path(pkg.__file__).resolve().parents[1] != root_path:
        print(f"chip_smoke: dct_carver_tpu_torch comes from {pkg.__file__}, "
              f"not from {root_path}", file=sys.stderr)
        return 2
    from dct_carver_tpu_torch import api
    from dct_carver_tpu_torch.kernels import build

    out = {"root": str(root_path), "import_s": time.perf_counter() - t}
    t = time.perf_counter()
    torch.zeros(1, device="cuda")
    torch.cuda.synchronize()
    out["context_s"] = time.perf_counter() - t
    t = time.perf_counter()
    build.load()
    out["kernels_s"] = time.perf_counter() - t
    rng = np.random.default_rng(SEED)
    for h, w in FIRST_SHAPES:
        for run in ("first", "second"):
            img = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
            torch.cuda.synchronize()
            t = time.perf_counter()
            res = api.carve(img, -SEAMS, blocksize=8, device="cuda")
            out[f"{h}x{w} {run} ms"] = (time.perf_counter() - t) * 1e3
            try:
                from dct_carver_tpu_torch.utils.graphs import CAPTURES
            except ImportError:  # a checkout before the graphed step
                continue
            out[f"{h}x{w} {run} capture ms"] = CAPTURES["seconds"] * 1e3
            CAPTURES["seconds"] = 0.0
            if res.image.shape != (h, w - SEAMS, 3):
                print(f"chip_smoke: {h}x{w} carve gave {res.image.shape}",
                      file=sys.stderr)
                return 1
    out["card"] = card_line()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--first-carve"] and len(sys.argv) == 3:
        sys.exit(first_carve(sys.argv[2]))
    if sys.argv[1:2] == ["--multi-card"] and len(sys.argv) == 2:
        sys.exit(multi_card())
    if sys.argv[1:2] == ["--tiled-forward"] and len(sys.argv) == 2:
        sys.exit(tiled_forward())
    if sys.argv[1:2] == ["--multiproc-worker"] and len(sys.argv) == 7:
        # exit without the distributed shutdown, which can hang after a
        # peer failed; what matters is flushed first
        import os

        try:
            rc = multiproc_worker(int(sys.argv[2]), int(sys.argv[3]),
                                  int(sys.argv[4]), sys.argv[5], sys.argv[6])
        except BaseException:
            import traceback

            traceback.print_exc()
            rc = 1
        sys.stdout.flush()
        sys.stderr.flush()
        os._exit(rc)
    if len(sys.argv) > 1:
        print("usage: chip_smoke.py [--first-carve ROOT | --multi-card | "
              "--tiled-forward | --multiproc-worker RANK NPROC PORT BACKEND "
              "DIR]",
              file=sys.stderr)
        sys.exit(2)
    sys.exit(main())
