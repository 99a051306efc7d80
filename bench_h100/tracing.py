"""The benchmark's spans and its reading of the device trace.

:class:`Spans` times the benchmark's own calls into each layer on the host
clock. :func:`profile` runs a window of EM iterations under
``torch.profiler`` (CPU and CUDA activity), each iteration inside a
``record_function`` span of the benchmark, and reads the exported trace:
the device's kernels, copies and sets, the busy time (their union), the
window (the first device event's start to the last one's end), and the
idle gaps between busy stretches, each labelled by the benchmark's span
and the innermost host operation in progress where it began.
"""
from __future__ import annotations

import json
import os
import tempfile
import time
from bisect import bisect_right
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Callable, List, Tuple

DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATEGORIES = ("cpu_op", "cuda_runtime", "cuda_driver", "user_annotation")
ITERATION_SPAN = "bench.em_iteration"
BREAKDOWN_ENTRIES = 10


class Spans:
    """Host-clock seconds of named stretches of a run, added up by name."""

    def __init__(self):
        self.seconds: dict = {}

    @contextmanager
    def __call__(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.seconds[name] = self.seconds.get(name, 0.0) + time.perf_counter() - t0


@dataclass
class DeviceWindow:
    """What the trace of a window of iterations says (seconds; device events in start order)."""

    iterations: int
    events: List[Tuple[str, float, float]]  # (name, start, duration) of every kernel, copy and set
    n_kernels: int
    busy_s: float
    window_s: float
    gaps: List[Tuple[str, float]] = field(default_factory=list)  # (host span and operation, seconds), longest first

    def kernels(self, part: str) -> List[float]:
        """Durations of the device events whose name holds ``part``."""
        return [dur for name, _, dur in self.events if part in name]

    def top_operations(self) -> list:
        totals: dict = {}
        for name, _, dur in self.events:
            totals[name] = totals.get(name, 0.0) + dur
        return sorted(([short_name(n), s] for n, s in totals.items()), key=lambda e: -e[1])[:BREAKDOWN_ENTRIES]


def short_name(name: str) -> str:
    """A kernel's name without its return type, namespace, template arguments and parameters."""
    base = name.replace("(anonymous namespace)::", "")
    base = base[len("void "):] if base.startswith("void ") else base
    for mark in ("<", "("):
        base = base.split(mark, 1)[0]
    return base.strip() or name


def profile(pull: Callable[[], None], seconds: float, on_card: bool = True) -> DeviceWindow:
    """Trace ``pull()`` repeated for ``seconds`` of host time, then synchronised, and read the trace.

    ``on_card=False`` (the CPU rehearsal) traces the host alone.
    """
    import torch
    from torch.profiler import ProfilerActivity, record_function

    sync = torch.cuda.synchronize if on_card else (lambda: None)
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_card else [])
    sync()
    with torch.profiler.profile(activities=activities) as prof:
        iterations = 0
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            with record_function(ITERATION_SPAN):
                pull()
            iterations += 1
        sync()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as fh:
            trace = json.load(fh)
    finally:
        os.remove(path)
    return read_trace(trace["traceEvents"], iterations)


def read_trace(trace_events: list, iterations: int) -> DeviceWindow:
    """The device window of a Chrome trace's events (``ts`` and ``dur`` in µs)."""
    complete = [e for e in trace_events if e.get("ph") == "X" and "dur" in e]
    device = sorted(((e["name"], float(e["ts"]) * 1e-6, float(e["dur"]) * 1e-6)
                     for e in complete if e.get("cat") in DEVICE_CATEGORIES), key=lambda e: e[1])
    if not device:
        return DeviceWindow(iterations, [], 0, 0.0, 0.0)
    n_kernels = sum(1 for e in complete if e.get("cat") == "kernel")
    merged = []  # busy stretches [start, end]
    for _, start, dur in device:
        end = start + dur
        if merged and start <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], end)
        else:
            merged.append([start, end])
    busy = sum(end - start for start, end in merged)
    window = merged[-1][1] - merged[0][0]
    host = sorted(((float(e["ts"]) * 1e-6, float(e["ts"] + e["dur"]) * 1e-6, e["name"], e.get("cat"))
                   for e in complete if e.get("cat") in HOST_CATEGORIES), key=lambda e: e[0])
    starts = [h[0] for h in host]
    longest = sorted(((nxt[0] - cur[1], cur[1]) for cur, nxt in zip(merged, merged[1:])), reverse=True)
    gaps = [(_host_label(host, starts, at), length) for length, at in longest[:BREAKDOWN_ENTRIES]]
    return DeviceWindow(iterations, device, n_kernels, busy, window, gaps)


def _host_label(host: list, starts: list, at: float) -> str:
    """'<benchmark span> / <innermost host operation>' in progress on the host at ``at``."""
    span, operation, operation_start = "no span", "no operation", -1.0
    last = bisect_right(starts, at)
    for start, end, name, cat in host[max(0, last - 256):last]:  # an iteration's span and operations begin within
        if start <= at < end:
            if cat == "user_annotation" and name.startswith("bench."):
                span = name
            elif start >= operation_start:
                operation, operation_start = name, start
    return f"{span} / {operation}"
