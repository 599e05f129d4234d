"""The end-to-end arithmetic on a synthetic request log, and the closed
loop's window: it ends at the end of the last request that started
inside the run's seconds."""

import pytest

from benchlib import stats
from benchlib import traffic as tf


def test_mpix_s_is_all_work_over_all_time():
    log = [(10.0, 10.5), (10.5, 11.0), (11.25, 12.0)]
    assert stats.window(log) == (10.0, 12.0)
    assert stats.mpix_s(log, [100.0, 100.0, 200.0]) == pytest.approx(200.0)


def test_p95_is_over_every_request():
    log = [(0.0, 0.001 * (i + 1)) for i in range(100)]  # 1 .. 100 ms
    assert stats.percentile_ms(log, 95) == pytest.approx(95.05)
    assert stats.percentile_ms(log, 50) == pytest.approx(50.5)
    assert stats.percentile_ms(log[::-1], 0) == pytest.approx(1.0)  # min


class Clock:
    """A fake clock: each request takes `step` seconds."""

    def __init__(self, step):
        self.now, self.step = 0.0, step

    def perf_counter(self):
        return self.now


def test_window_ends_at_the_last_request_started_in_time(monkeypatch):
    clock = Clock(0.4)
    monkeypatch.setattr(tf, "time", clock)

    def call(x):
        clock.now += clock.step
        return x, []

    kept = []
    deadline = 1.0
    log, failed, err = tf.closed_loop(
        call, [1, 2], lambda k, now: k > 0 and now >= deadline,
        lambda k, out: kept.append((k, out[0])), lambda name: _null())
    # requests start at 0, 0.4 and 0.8 (< 1.0) and the third ends at 1.2
    assert [pytest.approx(x) for x in log[-1]] == [0.8, 1.2]
    assert len(log) == 3 and failed == 0
    assert kept == [(0, 1), (1, 2), (2, 1)]  # the pool cycles
    assert stats.window(log) == (0.0, pytest.approx(1.2))


def test_a_failed_request_ends_the_run_and_is_counted():
    def call(x):
        raise RuntimeError("boom")

    log, failed, err = tf.closed_loop(call, [1], lambda k, now: k > 3,
                                      lambda k, out: None,
                                      lambda name: _null())
    assert log == [] and failed == 1 and "boom" in err


def test_reservoir_is_drawn_from_the_seed():
    def draw(seed, count):
        r = tf.Reservoir(4, seed)
        slots = [None] * 4
        for k in range(count):
            s = r.slot()
            if s is not None:
                slots[s] = k
        return slots

    assert draw(7, 3) == [0, 1, 2, None]
    assert draw(7, 1000) == draw(7, 1000)
    assert draw(7, 1000) != draw(8, 1000)
    assert all(0 <= k < 1000 for k in draw(2**31 + 11, 1000))


def test_sample_images_take_each_cards_chunk():
    picks = tf.sample_images(5, 1024, 4, 2)
    assert len(picks) == 8
    for c in range(4):
        assert sum(256 * c <= p < 256 * (c + 1) for p in picks) == 2
    assert tf.sample_images(5, 3, 1, None) == [0, 1, 2]


def test_removal_and_passes():
    cfg = {"height": 2160, "width": 3840}
    tr = {"remove": {"width_share": 0.1, "height_share": 0.1}}
    assert tf.removal(cfg, tr) == (384, 216)
    assert tf.passes(cfg, tr) == [tf.Pass(1, 2160, 3840, 384),
                                  tf.Pass(1, 3456, 2160, 216)]
    assert tf.work_mpix(cfg, tr) == pytest.approx(
        (2160 * 3840 * 384 + 3456 * 2160 * 216) / 1e6)


def _null():
    import contextlib

    return contextlib.nullcontext()
