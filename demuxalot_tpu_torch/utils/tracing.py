"""One recorder of the port's spans and counters, on the host clock and, while a profiler records, on its clock too.

Two grains of span:

* **stage spans** (:func:`span`), always recorded: one per entry-point call,
  per dataset or per library, a bounded handful per job, each costing a few
  µs against stages of milliseconds to seconds;
* **iteration spans** (:func:`step`), recorded only while a torch profiler
  records; otherwise each costs one check of the profiler's flag.

A span records its name, its parent (the innermost span open on the same
thread) and its start and end on ``time.perf_counter_ns``, into a table of
the newest :data:`TABLE_ROWS` records (:func:`records`), and adds its time
and count to its name's totals. A span opened inside an open span of the
same name is folded into it, so nothing is counted twice. While a torch
profiler records, a span also opens ``torch.profiler.record_function`` of
its name: under ``utils.profiling.device_trace`` every span lands in the
Chrome trace beside the kernels, on the profiler's clock.

Counters: :func:`count` adds to a named counter (``builds``: the libraries
compiled in this process), and :func:`timed_op` gives a kernel op's wrapper
``.host_ns`` and ``.host_calls``, its host time from entry to return and the
calls counted in it. The op's first call counts instead in a
``load.kernels`` span (it loads the library, and the CUDA driver the
op's kernels), and a call made while a profiler records is not counted (the
profiler's own cost would be). The ops' ``.launches`` are their own and
keep their meaning.

:func:`snapshot` returns the totals and counters as plain numbers and
:func:`reset` clears them. This module uses the standard library only;
torch is looked up, never imported, so that nothing here loads it.
"""
from __future__ import annotations

import contextlib
import functools
import sys
import threading
import time
from collections import deque
from typing import Optional

TABLE_ROWS = 65_536  # records kept, the newest; older ones leave the table and stay in the totals

_lock = threading.Lock()
_local = threading.local()
_table: deque = deque(maxlen=TABLE_ROWS)
_totals: dict = {}  # name -> [ns, count]
_counters: dict = {}
_ops: list = []  # the wrappers of timed_op
_IDLE = contextlib.nullcontext()


def profiling() -> bool:
    """Whether a torch profiler records in this process (False where torch is not loaded)."""
    global profiling
    torch = sys.modules.get("torch")
    if torch is None:
        return False
    # from now on the module's name is torch's own check: one C call on the hot path
    profiling = torch._C._autograd._profiler_enabled
    return profiling()


def _stack() -> list:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


def _add(name: str, parent: Optional[str], start_ns: int, end_ns: int) -> None:
    with _lock:
        _table.append((name, parent, start_ns, end_ns))
        total = _totals.setdefault(name, [0, 0])
        total[0] += end_ns - start_ns
        total[1] += 1


class Span:
    """A span of the host clock, recorded when it closes; ``seconds`` is its length once closed."""

    __slots__ = ("name", "parent", "start_ns", "end_ns", "_folded", "_annotation")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self) -> "Span":
        stack = _stack()
        self.parent = stack[-1] if stack else None
        self._folded = self.name in stack
        self._annotation = None
        if not self._folded:
            stack.append(self.name)
            if profiling():
                self._annotation = sys.modules["torch"].profiler.record_function(self.name)
                self._annotation.__enter__()
        self.start_ns = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> None:
        self.end_ns = time.perf_counter_ns()
        if self._folded:
            return
        if self._annotation is not None:
            self._annotation.__exit__(*exc)
        _stack().pop()
        _add(self.name, self.parent, self.start_ns, self.end_ns)

    @property
    def seconds(self) -> float:
        return (self.end_ns - self.start_ns) * 1e-9


def span(name: str) -> Span:
    """A stage span, always recorded."""
    return Span(name)


def step(name: str):
    """An iteration span: a :class:`Span` while a profiler records, else a context that does nothing."""
    return Span(name) if profiling() else _IDLE


def within(name: str):
    """Decorate a function so that each call runs inside a stage span ``name``."""
    def decorate(fn):
        @functools.wraps(fn)
        def spanned(*args, **kwargs):
            with Span(name):
                return fn(*args, **kwargs)
        return spanned
    return decorate


def record(name: str, start_ns: int) -> None:
    """Record a span that began at ``start_ns`` (``time.perf_counter_ns``) and ends now, under the open span."""
    stack = _stack()
    _add(name, stack[-1] if stack else None, start_ns, time.perf_counter_ns())


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name``."""
    with _lock:
        _counters[name] = _counters.get(name, 0) + n


def timed_op(fn):
    """``fn`` with ``.host_ns`` and ``.host_calls``: host ns from entry to return, over its calls after the first.

    Until a call returns, each runs inside a ``load.kernels`` span instead;
    calls that raise, and calls made while a profiler records, are not
    counted.
    """
    clock = time.perf_counter_ns

    @functools.wraps(fn)
    def op(*args, **kwargs):
        if op.loaded and not profiling():
            start = clock()
            result = fn(*args, **kwargs)
            op.host_ns += clock() - start
            op.host_calls += 1
            return result
        if op.loaded:
            return fn(*args, **kwargs)
        with Span("load.kernels"):
            result = fn(*args, **kwargs)
        op.loaded = True
        return result

    op.loaded, op.host_ns, op.host_calls = False, 0, 0
    _ops.append(op)
    return op


def records() -> list:
    """The table: ``(name, parent, start_ns, end_ns)`` of the newest spans, oldest first."""
    with _lock:
        return list(_table)


def snapshot() -> dict:
    """``{"spans": {name: {"seconds", "count"}}, "counters": {name: number}}``, plain numbers.

    The counters hold ``builds`` and, for each timed op, ``<op>.launches``,
    ``<op>.host_ns`` and ``<op>.host_calls``.
    """
    with _lock:
        spans = {name: {"seconds": ns * 1e-9, "count": n} for name, (ns, n) in _totals.items()}
        counters = {"builds": 0, **_counters}
    for op in _ops:
        counters[f"{op.__name__}.launches"] = getattr(op, "launches", 0)
        counters[f"{op.__name__}.host_ns"] = op.host_ns
        counters[f"{op.__name__}.host_calls"] = op.host_calls
    return {"spans": spans, "counters": counters}


def reset() -> None:
    """Clear the table, the totals, the counters and the ops' host counters (not their ``.launches``)."""
    with _lock:
        _table.clear()
        _totals.clear()
        _counters.clear()
    for op in _ops:
        op.host_ns = op.host_calls = 0
