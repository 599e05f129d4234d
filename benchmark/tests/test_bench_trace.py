"""The trace reduction on synthetic traces: busy and idle time, the
breakdown, the metric readers, and the check that refuses a trace that
holds fewer kernels than the launches credited."""

import pytest

from benchlib import spec
from benchlib import trace as tr
from benchlib.reading import TracedRun


def _op(name, a, b, dev=0, kind="kernel"):
    return tr.DeviceOp(name, a, b, dev, kind)


def _trace(ops, requests=((0.0, 100.0),), host=()):
    spans = [tr.HostSpan(tr.REQUEST, a, b) for a, b in requests]
    return tr.Trace(sorted(ops, key=lambda o: o.start),
                    sorted(list(host) + spans, key=lambda h: h.start),
                    list(requests))


def _metric(name):
    return spec.load_module("metrics", name)


def test_busy_union_counts_overlaps_once():
    assert tr.busy_union([(0, 10), (5, 15), (20, 25)]) == 20
    t = _trace([_op("k", -5, 10), _op("k", 50, 120)])
    assert tr.busy_per_device(t, [0]) == {0: 60.0}  # clipped to the window


def test_idle_gaps_are_labelled_by_the_host():
    host = [tr.HostSpan("bench.call", 0, 100),
            tr.HostSpan("cudaMemcpyAsync", 10, 40)]
    t = _trace([_op("k", 0, 10), _op("k", 40, 100)], host=host)
    gaps = tr.idle_gaps(t, [0])
    assert gaps == [["bench.call > cudaMemcpyAsync", pytest.approx(30e-6)]]
    b = tr.breakdown(t, [0])
    assert b["device_ops"] == [["k", pytest.approx(70e-6)]]


def test_a_short_trace_is_refused_not_read():
    mods = {"strip_roofline": _metric("strip_roofline"),
            "find_seam_roofline": _metric("find_seam_roofline")}
    ops = [_op("void dct_carver::strip_kernel<8>(float*)", i, i + 1)
           for i in range(10)]
    ops += [_op("void dct_carver::tile_rows_kernel<4, true, false>", 20, 21),
            _op("void dct_carver::finish_kernel<false>", 21, 22),
            _op("memset32", 19, 20)]
    t = _trace(ops)
    # 10 strips and one tiled find-seam (3 launches: 2 kernels) credited
    assert tr.count_check(t, {"strip": 10, "find_seam_tiled": 3}, mods) == (
        True, 12, 12)
    # a trace that lost one strip kernel falls short of the credit
    assert tr.count_check(_trace(ops[1:]), {"strip": 10,
                                            "find_seam_tiled": 3},
                          mods) == (False, 11, 12)


def _run(ops, requests=((0.0, 100.0),), launches=None, seams=1, work=None,
         devices=(0,)):
    return TracedRun(_trace(ops, requests), list(devices), launches or {},
                     len(requests), seams, work or {})


def test_roofline_is_least_time_over_kernel_time():
    from benchlib import peaks

    # 3.35e6 bytes least: 1 us at the memory's peak; the kernel took 4 us
    run = _run([_op("dct_carver::apply_kernel", 10, 14),
                _op("void dct_carver::sharded_apply_kernel", 20, 30)],
               work={"apply": (peaks.HBM_BYTES_PER_S * 1e-6, 0)})
    assert _metric("apply_roofline").read(run) == pytest.approx(25.0)
    # no kernel of its own in the trace, or no count: nothing read
    assert _metric("strip_roofline").read(run) is None
    assert _metric("energy_roofline").read(run) is None


def test_copies_skew_idle_and_launches():
    ops = [_op("Memcpy HtoD (Pageable -> Device)", 0, 10, kind="memcpy"),
           _op("Memcpy DtoD (Device -> Device)", 10, 20, kind="memcpy"),
           _op("k", 20, 40, 0), _op("k", 30, 60, 1),
           _op("Memcpy PtoP (Device -> Device)", 60, 70, 1, "memcpy"),
           _op("k", 120, 130, 0), _op("k", 150, 160, 1)]
    run = _run(ops, requests=((0.0, 100.0), (100.0, 200.0)),
               launches={"apply": 6, "strip": 2}, seams=4, devices=(0, 1))
    # HtoD and PtoP count, a copy within a card does not; per request
    assert _metric("copy_ms_per_request").read(run) == pytest.approx(0.01)
    # first kernels: 20 vs 30, then 120 vs 150
    assert _metric("chunk_skew_ms").read(run) == pytest.approx(0.02)
    assert _metric("launches_per_seam").read(run) == 2.0
    # card 0 busy 0-40 and 120-130 (50 of 200), card 1 30-70, 150-160
    assert _metric("device_idle_pct").read(run) == pytest.approx(
        100 * (1 - 50 / 200))
    one = _run([_op("k", 0, 10)])
    assert _metric("chunk_skew_ms").read(one) is None


@pytest.mark.parametrize("name", [
    "copy_ms_per_request", "launches_per_seam", "energy_roofline",
    "find_seam_roofline", "apply_roofline", "strip_roofline",
    "device_idle_pct"])
def test_batch_twin_reads_as_its_metric(name):
    from benchlib import peaks

    ops = [_op("Memcpy HtoD (Pageable -> Device)", 0, 10, kind="memcpy"),
           _op("dct_carver::apply_kernel", 10, 14),
           _op("void dct_carver::strip_kernel<8>(float*)", 14, 20),
           _op("void dct_carver::energy_kernel<8>", 20, 22),
           _op("void dct_carver::find_seam_kernel<4, true, false>", 22, 30)]
    least = (peaks.HBM_BYTES_PER_S * 1e-6, 0)
    run = _run(ops, launches={"apply": 3}, seams=2, work={
        k: least for k in ("apply", "strip", "energy", "find_seam")})
    base, twin = _metric(name), _metric(f"{name}.batch")
    assert base.read(run) is not None
    assert twin.read(run) == base.read(run)
    assert (twin.LAYER, twin.UNIT, twin.SOURCE) == (
        base.LAYER, base.UNIT, base.SOURCE)
    assert (getattr(twin, "PATTERNS", ()), getattr(twin, "RECORDS", {})) == (
        getattr(base, "PATTERNS", ()), getattr(base, "RECORDS", {}))
    assert (base.MOVES, twin.MOVES) == ("mpix_s", "carve_ms_min")


def test_batch_mpix_s_is_the_traced_requests_work_over_their_time():
    run = _run([_op("k", 0, 10)])
    assert _metric("batch_mpix_s").read(run) is None  # no log: nothing
    run.log = [(10.0, 12.0), (12.5, 14.0)]
    run.work_mpix = 800.0
    assert _metric("batch_mpix_s").read(run) == pytest.approx(200.0)
