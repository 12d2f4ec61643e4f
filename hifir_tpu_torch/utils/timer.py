"""Wall-clock timing (the port's copy of ``hifir_tpu/utils/timer.py``; ref
``src/hif/utils/Timer.hpp:114``)."""

from __future__ import annotations

import time

__all__ = ["Timer"]


class Timer:
    """Simple start/finish wall-clock timer returning seconds."""

    def __init__(self) -> None:
        self._t0 = 0.0
        self._t1 = 0.0

    def start(self) -> "Timer":
        self._t0 = time.perf_counter()
        return self

    def finish(self) -> "Timer":
        self._t1 = time.perf_counter()
        return self

    def time(self) -> float:
        return self._t1 - self._t0

    def __enter__(self) -> "Timer":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.finish()
