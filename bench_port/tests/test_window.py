"""The window's arithmetic on a fake clock: whole passes until one ends
past the window, and the rate over all of them."""

from bench_port import harness
from bench_port.metrics import pairs_per_s


class FakeClock:
    def __init__(self, pass_seconds):
        self.now = 100.0
        self.pass_seconds = pass_seconds

    def __call__(self):
        return self.now


def test_window_runs_whole_passes_and_counts_all_of_them():
    clock = FakeClock(0.7)

    def one_pass(i):
        clock.now += clock.pass_seconds
        return {"i": i}

    passes, window_s = harness.run_window(one_pass, 2.0, clock)
    assert [p["i"] for p in passes] == [0, 1, 2]
    assert abs(window_s - 2.1) < 1e-9
    record = harness.Record(setup_s=1.0, load_s=0.5, window_s=window_s, pairs=3 * 1000,
                            passes=passes, window_peak_bytes=0)
    assert abs(pairs_per_s.read(record) - 3000 / 2.1) < 1e-9


def test_a_pass_longer_than_the_window_still_counts_once():
    clock = FakeClock(5.0)

    def one_pass(i):
        clock.now += clock.pass_seconds
        return i

    passes, window_s = harness.run_window(one_pass, 2.0, clock)
    assert passes == [0] and window_s == 5.0
