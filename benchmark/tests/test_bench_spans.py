"""The readers of the program's spans on synthetic traces: the copies'
stall (`copy_stall_ms_per_request` and its `.batch` twin) and the seam
loop's set-up (`step_setup_ms_per_request.batch`), and `collect` keeping a
program span's host range while dropping its device-side annotation."""

from types import SimpleNamespace

import pytest

from benchlib import spec
from benchlib import trace as tr
from benchlib.reading import TracedRun


def _op(a, b, dev=0):
    return tr.DeviceOp("k", a, b, dev, "kernel")


def _run(ops, spans, requests=((0.0, 100.0),), devices=(0,)):
    host = [tr.HostSpan(n, a, b) for n, a, b in spans]
    host += [tr.HostSpan(tr.REQUEST, a, b) for a, b in requests]
    trace = tr.Trace(sorted(ops, key=lambda o: o.start),
                     sorted(host, key=lambda h: h.start), list(requests))
    return TracedRun(trace, list(devices), {}, len(requests), 1, {})


def _metric(name):
    return spec.load_module("metrics", name)


STALL = _metric("copy_stall_ms_per_request")
SETUP = _metric("step_setup_ms_per_request.batch")


def test_copy_stall_counts_only_idle_time_inside_copy_spans():
    # busy 0-20 and 50-100; idle 20-50, of which the copy covers 30-50;
    # the idle 20-30 lies in another span, and 50-60 of the copy is busy
    run = _run([_op(0, 20), _op(50, 100)],
               [("carve.copy_in", 30, 60), ("carve.luma", 20, 30)])
    assert STALL.read(run) == pytest.approx(20e-3)


def test_overlapping_copy_spans_count_once():
    # a join inside a copy-out, and a second copy-out over the same idle
    run = _run([_op(0, 10), _op(90, 100)],
               [("carve.copy_out.image", 20, 60), ("batch.join", 30, 50),
                ("carve.copy_out.vmap", 40, 80)])
    assert STALL.read(run) == pytest.approx(60e-3)


def test_copy_stall_is_the_mean_over_cards_per_request():
    # two requests; card 0 idle in its copies 40 us, card 1 0 us
    run = _run([_op(0, 10, 0), _op(30, 100, 0), _op(100, 200, 1),
                _op(0, 100, 1), _op(120, 200, 0)],
               [("carve.copy_in", 10, 30), ("carve.copy_out.image", 100,
                                             120)],
               requests=((0.0, 100.0), (100.0, 200.0)), devices=(0, 1))
    assert STALL.read(run) == pytest.approx(40e-3 / 2 / 2)


def test_copy_stall_is_clipped_to_the_window():
    run = _run([_op(0, 100)], [("carve.copy_in", -50, 10),
                               ("carve.copy_out.vmap", 95, 150)])
    assert STALL.read(run) == 0.0


@pytest.mark.parametrize("name", ["copy_stall_ms_per_request",
                                  "copy_stall_ms_per_request.batch",
                                  "step_setup_ms_per_request.batch"])
def test_a_window_without_the_spans_reads_none(name):
    # what a program without the spans gives: its own host events only
    run = _run([_op(0, 50)], [("aten::copy_", 10, 60),
                              ("cudaMemcpyAsync", 10, 60),
                              ("carve.copy_in", 150, 160)])
    assert _metric(name).read(run) is None


def test_the_batch_twin_reads_as_its_base():
    run = _run([_op(0, 20)], [("carve.copy_in", 10, 40)])
    twin = _metric("copy_stall_ms_per_request.batch")
    assert twin.read(run) == STALL.read(run) == pytest.approx(20e-3)
    assert (twin.LAYER, twin.UNIT, twin.SOURCE) == (
        STALL.LAYER, STALL.UNIT, STALL.SOURCE)
    assert (STALL.MOVES, twin.MOVES) == ("mpix_s", "carve_ms_min")


def test_step_setup_sums_the_union_of_its_four_spans():
    # the eager seam 10-30 and the capture 25-40 overlap: 30 us; the build
    # 50-55 and the uncached step 60-70 add 15; the seam loop's own span is
    # no set-up; two requests
    run = _run([_op(0, 200)],
               [("carve.seam.eager", 10, 30), ("carve.capture", 25, 40),
                ("carve.steps.build", 50, 55),
                ("carve.steps.uncached", 60, 70), ("carve.seams", 10, 90)],
               requests=((0.0, 100.0), (100.0, 200.0)))
    assert SETUP.read(run) == pytest.approx(45e-3 / 2)


def test_collect_keeps_the_span_and_drops_its_device_annotation():
    from torch.autograd import DeviceType

    def event(name, a, b, device_type, annotation=False):
        return SimpleNamespace(
            name=name, time_range=SimpleNamespace(start=a, end=b),
            device_type=device_type, device_index=0,
            is_user_annotation=annotation)

    prof = SimpleNamespace(events=lambda: [
        event(tr.REQUEST, 0, 100, DeviceType.CPU, True),
        event("carve.copy_in", 10, 30, DeviceType.CPU, True),
        # the device-side range of the span: over what it launched
        event("carve.copy_in", 12, 40, DeviceType.CUDA, True),
        event("Memcpy HtoD (Pageable -> Device)", 12, 40, DeviceType.CUDA),
    ])
    trace = tr.collect(prof)
    assert [o.name for o in trace.ops] == ["Memcpy HtoD (Pageable -> Device)"]
    assert [h.name for h in trace.host] == [tr.REQUEST, "carve.copy_in"]
    assert trace.requests == [(0.0, 100.0)]
