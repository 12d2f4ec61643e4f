"""The window's arithmetic on a fake clock."""

import pytest

from hifbench.window import closed_loop, p95


class Clock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


@pytest.mark.parametrize("costs,seconds,count,window", [
    ([0.4], 1.0, 3, 1.2),             # the third starts at 0.8 < 1.0
    ([0.5], 1.0, 2, 1.0),             # the second completes at 1.0
    ([0.3, 0.9], 1.0, 2, 1.2),        # whole requests: a long one runs on
    ([2.0], 1.0, 1, 2.0),
])
def test_whole_requests(costs, seconds, count, window):
    clk = Clock()

    def request(i):
        clk.t += costs[i % len(costs)]
        return i

    w = closed_loop(request, seconds, clock=clk)
    assert w.count == count and w.results == list(range(count))
    assert w.seconds == pytest.approx(window)
    assert w.latencies == pytest.approx([costs[i % len(costs)]
                                         for i in range(count)])


def test_p95_over_all_calls():
    assert p95(range(1, 101)) == 95
    assert p95([5.0] * 19 + [100.0]) == 5.0
    assert p95([5.0] * 18 + [100.0, 200.0]) == 100.0
    assert p95([7.0]) == 7.0


@pytest.mark.parametrize("costs,seconds,tail,window", [
    ([0.01] * 99 + [0.5], 1.48, 0.01, 1.49),
    ([0.01] * 94 + [0.5] * 6, 3.93, 0.5, 3.94),
])
def test_a_stall_moves_the_tail_and_the_rate(costs, seconds, tail, window):
    """Six stalled calls in a hundred reach the 95th percentile; one does
    not, but every stall lengthens the window, so the rate sees it."""
    clk = Clock()

    def request(i):
        clk.t += costs[i]
        return i

    w = closed_loop(request, seconds, clock=clk)
    assert w.count == 100
    assert w.seconds == pytest.approx(window)
    assert p95(w.latencies) == pytest.approx(tail)
