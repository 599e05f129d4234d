"""The port's spans (`utils/profiling.py::span`) on the CPU.

With no profiler running a span is the one shared no-op context and never
enters `torch.profiler.record_function`.  Under `utils/profiling.trace`
each route's spans nest by time as the carve's layers do: the request's
root, its passes or chunks, and in each the copy in, luma, energy, step
set-up, seam loop, reconstruct and copies out (on the spatial route the
sharding, step build, seam loop with the chunk's vmap record, and the
columns' assembly).  On a simulated card the step cache's build, the eager
first seam and the capture show once a key, and a step too large for the
cache shows as uncached at every carve; the spatial route's once a carve.
The number of spans does not grow with the seams, and the carve's results
are the same with the profiler on and off.
"""

from collections import Counter

import numpy as np
import pytest
import torch

from dct_carver_tpu_torch import api
from dct_carver_tpu_torch.models.carver import Carver
from dct_carver_tpu_torch.ops import carve as tcarve
from dct_carver_tpu_torch.utils import graphs as tgraphs
from dct_carver_tpu_torch.utils import profiling as tprof

from test_torch_graph_step import _Null, sim_card  # noqa: F401

EDGES, TEXTURES = 0.3, 0.7
H, W = 16, 40
STEP_GRAPHS = tgraphs.StepGraphs  # before any fixture stands in for it
PASS = ["carve.copy_in", "carve.luma", "carve.energy", "carve.steps.uncached",
        "carve.seams", "carve.reconstruct", "carve.copy_out.image",
        "carve.copy_out.vmap"]
CHUNK = ["carve.copy_in", "carve.luma", "carve.energy",
         "carve.steps.uncached", "carve.seams", "carve.reconstruct"]


def _image(seed, shape=(H, W, 3)):
    return np.random.default_rng(seed).integers(0, 256, shape, np.uint8)


ROUTES = {
    "width": lambda: api.carve(_image(1), -5, device="cpu",
                               output_seams=True),
    "both": lambda: Carver(_image(2), device="cpu", output_seams=True)
    .resize(W - 3, H - 2),
    "batch": lambda: api.carve(_image(3, (4, H, W, 3)), -3,
                               parallel="batch", devices=["cpu", "cpu"],
                               output_seams=True),
    "spatial": lambda: api.carve(_image(5, (H, 64, 3)), -5,
                                 parallel="spatial", devices=["cpu"] * 4,
                                 output_seams=True),
}
SPATIAL_PASS = ["carve.copy_in", "carve.luma", "carve.spatial.shard",
                "carve.energy", "carve.steps.build", "carve.seams",
                "carve.spatial.gather", "carve.copy_out.image",
                "carve.copy_out.vmap"]


def _traced(fn, log_dir):
    """(fn's result, [(name, start, end)] of the program's spans, by start
    and outer first) of one call under `utils/profiling.trace`."""
    with tprof.trace(str(log_dir)) as prof:
        out = fn()
    spans = [(e.name, e.time_range.start, e.time_range.end)
             for e in prof.events()
             if e.name.startswith(("carve.", "batch."))]
    return out, sorted(spans, key=lambda s: (s[1], -s[2]))


def _tree(spans):
    """(roots, {span index: child indices}), each in time order; raises
    where two spans overlap without one holding the other."""
    roots, kids, open_ = [], {i: [] for i in range(len(spans))}, []
    for i, (name, a, b) in enumerate(spans):
        while open_ and spans[open_[-1]][2] <= a:
            open_.pop()
        if open_:
            assert b <= spans[open_[-1]][2], (
                f"{name} overlaps {spans[open_[-1]][0]} without nesting")
        (kids[open_[-1]] if open_ else roots).append(i)
        open_.append(i)
    return roots, kids


def _names(spans, idx):
    return [spans[i][0] for i in idx]


class _StubGraph:
    """A torch.cuda.CUDAGraph stand-in that records nothing and replays
    nothing: the step runs once, eagerly, while it is "captured", so a
    carve's output under it is not read."""

    def capture_begin(self, pool=None):
        pass

    def capture_end(self):
        pass

    def replay(self):
        pass


@pytest.fixture
def sim_capture(sim_card, monkeypatch):  # noqa: F811
    """`sim_card` with the real `StepGraphs.capture` over stand-in graphs,
    so that the capture's own span runs."""
    monkeypatch.setattr(tgraphs, "StepGraphs", STEP_GRAPHS)
    monkeypatch.setattr(torch.cuda, "CUDAGraph", _StubGraph)
    monkeypatch.setattr(torch.cuda, "graph_pool_handle", lambda: None)
    monkeypatch.setattr(torch.cuda, "device", lambda d: _Null())
    return sim_card


@pytest.mark.parametrize("route", ["span"] + list(ROUTES))
def test_without_a_profiler_a_span_is_the_shared_no_op(monkeypatch, route):
    def entered(*args, **kwargs):
        raise AssertionError("record_function entered with no profiler")

    monkeypatch.setattr(torch.profiler, "record_function", entered)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", entered)
    assert tprof.span("carve.pass") is tprof.span("batch.join") is \
        tprof._OFF
    with tprof.span("carve.seams") as inside:
        assert inside is None
    if route != "span":
        ROUTES[route]()


@pytest.mark.parametrize("route", ["width", "both"])
def test_single_image_spans_nest_by_layer(tmp_path, route):
    _, spans = _traced(ROUTES[route], tmp_path)
    roots, kids = _tree(spans)
    assert _names(spans, roots) == ["carve.resize"]
    passes = kids[roots[0]]
    assert _names(spans, passes) == ["carve.pass"] * (1 if route == "width"
                                                      else 2)
    for p in passes:
        assert _names(spans, kids[p]) == PASS
        for c in kids[p]:  # the seam loop holds no span of its own here
            assert not kids[c]


def test_batch_spans_nest_by_chunk(tmp_path):
    _, spans = _traced(ROUTES["batch"], tmp_path)
    roots, kids = _tree(spans)
    assert _names(spans, roots) == ["carve.stack"]
    top = kids[roots[0]]
    assert _names(spans, top) == ["batch.chunk", "batch.chunk", "batch.join",
                                  "batch.join", "carve.copy_out.image",
                                  "carve.copy_out.vmap"]
    for chunk in top[:2]:
        assert _names(spans, kids[chunk]) == CHUNK


@pytest.fixture
def sim_spatial(sim_capture, monkeypatch):
    """`sim_capture` with the spatial route's step graphed on a stand-in
    card: its first seam eager, then a capture and replays of stand-in
    graphs (so the carve's output is not read)."""
    from dct_carver_tpu_torch.parallel import spatial as tsp

    monkeypatch.setattr(tsp, "_graph_cards",
                        lambda mesh, p: [torch.device("cpu")])
    return sim_capture


@pytest.mark.parametrize("card", [False, True], ids=["cpu", "sim_card"])
def test_spatial_spans_nest_under_the_pass(request, tmp_path, card):
    """The spatial route's set-up, seam loop and assembly nest in its pass;
    on a card the eager first seam and the capture sit in the seam loop,
    before the chunk's vmap record, and nothing sits inside them."""
    if card:
        request.getfixturevalue("sim_spatial")
    _, spans = _traced(ROUTES["spatial"], tmp_path)
    roots, kids = _tree(spans)
    assert _names(spans, roots) == ["carve.resize"]
    passes = kids[roots[0]]
    assert _names(spans, passes) == ["carve.pass"]
    inner = kids[passes[0]]
    assert _names(spans, inner) == SPATIAL_PASS
    seams = inner[SPATIAL_PASS.index("carve.seams")]
    assert _names(spans, kids[seams]) == (
        ["carve.seam.eager", "carve.capture"] if card else []) + [
        "carve.spatial.record"]
    for i in kids[seams]:
        assert not kids[i]


@pytest.mark.parametrize("fits", [True, False], ids=["cached", "too_large"])
def test_step_set_up_shows_once_a_key(sim_capture, monkeypatch, tmp_path,
                                      fits):
    """A key's first carve builds its step, runs its first seam eagerly and
    captures; the second replays and shows none of them.  A step too large
    for the cache is made, warmed and captured at every carve."""
    if not fits:
        monkeypatch.setattr(tcarve, "CACHE_MAX_BYTES", 0)
    luma = torch.rand(H, W)
    for k in range(2):
        _, spans = _traced(lambda: tcarve.carve_n_seams(
            luma, 4, 8, EDGES, TEXTURES), tmp_path)
        seen = Counter(name for name, _, _ in spans)
        first = k == 0 or not fits
        want = {"carve.energy": 1, "carve.seams": 1,
                "carve.steps.build": int(fits and first),
                "carve.steps.uncached": int(not fits),
                "carve.seam.eager": int(first), "carve.capture": int(first)}
        assert seen == {n: c for n, c in want.items() if c}
        roots, kids = _tree(spans)
        seams = next(i for i in roots if spans[i][0] == "carve.seams")
        assert _names(spans, kids[seams]) == (
            ["carve.seam.eager", "carve.capture"] if first else [])
        for i in kids[seams]:  # nothing inside the step, captured or not
            assert not kids[i]


@pytest.mark.parametrize("card", [False, True], ids=["cpu", "sim_card"])
def test_spans_do_not_grow_with_the_seams(request, monkeypatch, card):
    """Every span a carve enters, recorded as a running profiler would
    have it (the flag up, `record_function` logging its names)."""
    if card:
        request.getfixturevalue("sim_capture")
    entered = []

    class Recorded:
        def __init__(self, name):
            entered.append(name)

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

    monkeypatch.setattr(tprof, "_profiler_enabled", lambda: True)
    monkeypatch.setattr(torch.profiler, "record_function", Recorded)
    counts = []
    for seams in (5, 20):
        tcarve.clear_step_cache()  # each carve is its key's first
        entered.clear()
        api.carve(_image(4), -seams, device="cpu")
        counts.append(Counter(entered))
    assert counts[0] == counts[1] and counts[0]["carve.seams"] == 1
    assert counts[0]["carve.capture"] == int(card)


@pytest.mark.parametrize("card", [False, True], ids=["cpu", "sim_card"])
def test_spatial_spans_do_not_grow_with_the_seams(request, monkeypatch,
                                                   card):
    """The spatial route's spans a carve, as a running profiler would
    record them: the same at 5 and 20 seams, its step built, warmed and
    captured once a carve on a card."""
    if card:
        request.getfixturevalue("sim_spatial")
    entered = []
    monkeypatch.setattr(tprof, "_profiler_enabled", lambda: True)
    monkeypatch.setattr(torch.profiler, "record_function",
                        lambda name: entered.append(name) or tprof._OFF)
    counts = []
    for seams in (5, 20):
        entered.clear()
        api.carve(_image(6, (H, 64, 3)), -seams, parallel="spatial",
                  devices=["cpu"] * 4)
        counts.append(Counter(entered))
    assert counts[0] == counts[1]
    assert all(counts[0][n] == 1 for n in (
        "carve.steps.build", "carve.seams", "carve.spatial.record",
        "carve.spatial.gather"))
    assert counts[0]["carve.seam.eager"] == int(card)
    assert counts[0]["carve.capture"] == int(card)


@pytest.mark.parametrize("route", list(ROUTES))
def test_results_are_the_same_traced_or_not(tmp_path, route):
    traced, _ = _traced(ROUTES[route], tmp_path)
    plain = ROUTES[route]()
    np.testing.assert_array_equal(traced.image, plain.image)
    np.testing.assert_array_equal(traced.visibility_map,
                                  plain.visibility_map)
