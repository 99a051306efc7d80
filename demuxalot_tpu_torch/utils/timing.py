"""Wall-clock stopwatch for examples and host-side benchmarks (a copy of ``demuxalot_tpu.utils.timing``).

Device kernels are timed with CUDA events or ``torch.profiler``
(``utils.profiling``); this covers the host phases (BAM scanning, packing).
Fills the role of the reference's timing helper (demuxalot/utils.py:134-144)
with a reusable perf_counter-based design.
"""
from __future__ import annotations

import time


class Timer:
    """Context manager that measures and reports one labelled interval.

    >>> with Timer("counting"):
    ...     do_work()
    counting: 1.234 s

    The measured interval is kept on ``self.time_taken`` (seconds) so
    callers can collect it programmatically. The clock starts at
    construction time *and* is restarted on ``__enter__``, so the object
    may be re-entered to time several intervals.
    """

    def __init__(self, name: str = "timer", quiet: bool = False):
        self.name = name
        self.quiet = quiet
        self.time_taken: float = float("nan")
        self._t0 = time.perf_counter()

    def __enter__(self) -> "Timer":
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, _exc, _tb) -> None:
        self.time_taken = time.perf_counter() - self._t0
        if not self.quiet and exc_type is None:
            print(f"{self.name}: {self.time_taken:.3f} s")
