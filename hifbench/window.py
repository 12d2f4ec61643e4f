"""The measured window's arithmetic: closed loops with one client.

Each loop takes the clock it reads (a fake one in the tests).  A window is
taken over all the work and all the time in it; no number here is a median
of pieces."""

from __future__ import annotations

import dataclasses
import math
import time
from typing import Callable, List

__all__ = ["Window", "closed_loop", "p95"]


@dataclasses.dataclass
class Window:
    """What a loop saw: each request's latency (s), the window's length (s,
    from the first submit to the last completion) and the requests'
    results, in order."""

    latencies: List[float]
    seconds: float
    results: list

    @property
    def count(self) -> int:
        return len(self.latencies)


def p95(values) -> float:
    """The 95th percentile by nearest rank: the smallest value that at least
    95% of the values do not exceed."""
    v = sorted(values)
    return v[max(0, math.ceil(0.95 * len(v)) - 1)]


def closed_loop(request: Callable[[int], object], seconds: float,
                clock: Callable[[], float] = time.perf_counter) -> Window:
    """One client, back to back: ``request(i)`` returns once its result is
    complete; a request starts only while fewer than ``seconds`` have passed
    since the first started, and the window closes when the last one
    started completes (so it covers whole requests: whole GMRES systems).
    Every request's latency is from its submit to its completion."""
    lat, out = [], []
    t0 = clock()
    end = t0
    while end - t0 < seconds:
        s = clock()
        out.append(request(len(lat)))
        end = clock()
        lat.append(end - s)
    return Window(lat, end - t0, out)
