"""One run of one cell: set-up, the measured window, the comparison with the reference, the metrics.

A cell is ``<config>.<traffic>`` as ``BENCHMARK.json`` names it. Its
pieces are files found by name: ``configs/<config>.json`` (the pool's
sizes), ``traffic/<traffic>.json`` (the likelihood, doublet prior and
damping of the EM), ``limits/<cell>.json`` (the limit of each number the
comparison reads) and ``metrics/<metric>.py`` (one reader per per-layer
metric). A cell, mix or metric is added by adding files and entries.

Set-up makes the pool from the seed, packs it, builds the program's EM
loop and runs its first three iterations, which the comparison follows
from the raw draws. The window pulls iterations back to back, a closed
loop with one client that runs ahead of the card up to the launch queue,
for ``seconds`` of host time, then waits for the card: ``em_iter_ms`` is
the window's time over the iterations it completed. A traced run profiles
a shorter window and times the host's issue of 100 iterations at a time
instead. Afterwards the device peak is read, the program is freed, and the
reference (float64, on the same device) checks the start and the window's
last iteration.
"""
from __future__ import annotations

import gc
import importlib.util
import json
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Optional

from .check import START_ITERATIONS, Trajectory, gaps, judge
from .generator import draw_config
from .tracing import DeviceWindow, Spans, profile

BENCH_DIR = Path(__file__).resolve().parent
REPO = BENCH_DIR.parent
TRACE_SECONDS = 2.0  # the profiled window's host seconds (at most the run's)
HOST_WINDOWS, HOST_CALLS = 5, 100  # em_host_us: windows of iterations issued with no synchronise
GIB = 1 << 30


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: Optional[dict]
    end_to_end: list  # metric names this cell reports with --trace 0
    per_layer: list  # (name, reader module) this cell reports with --trace 1


@dataclass
class Shapes:
    """The work of one EM iteration, counted by the reference from the draws."""

    n_calls: int  # collapsed (variant, barcode) calls: the per-call E-step's and the M-step's
    n_molecules: int  # molecule calls matched to a variant: the aggregate E-step's
    n_groups: int  # (barcode, SNP) groups of the aggregate E-step, 0 on the per-call path
    n_barcodes: int
    n_variants: int
    n_donors: int
    n_columns: int
    n_runs: int  # SNP runs of the variant axis
    neighbour_adds: int  # Σ over runs of L·(L−1): the normalisation's denominator adds per donor


@dataclass
class Readings:
    """What a per-layer reader reads."""

    spans: dict
    shapes: Shapes
    window: Optional[DeviceWindow] = None
    host_us: list = field(default_factory=list)


def _read_json(path: Path) -> dict:
    with open(path) as fh:
        return json.load(fh)


def _reader(name: str):
    path = BENCH_DIR / "metrics" / f"{name}.py"
    safe = "".join(ch if ch.isalnum() else "_" for ch in name)
    spec = importlib.util.spec_from_file_location(f"bench_h100.metrics.{safe}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def load_cell(name: str, benchmark: Optional[dict] = None) -> Cell:
    """The cell ``name`` of ``BENCHMARK.json`` (or of ``benchmark``), with its files read."""
    benchmark = benchmark or _read_json(REPO / "BENCHMARK.json")
    workload = next((w for w in benchmark["workloads"] if w["name"] == name), None)
    if workload is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    config = next(c for c in benchmark["configs"] if c["name"] == workload["config"])
    limits_path = BENCH_DIR / "limits" / f"{name}.json"

    def ours(metric: dict) -> bool:
        return "workloads" not in metric or name in metric["workloads"]

    return Cell(
        name=name, chips=workload["chips"], config=_read_json(REPO / config["file"]),
        traffic=_read_json(BENCH_DIR / "traffic" / f"{workload['traffic']}.json"),
        limits=_read_json(limits_path)["limits"] if limits_path.exists() else None,
        end_to_end=[m["name"] for m in benchmark["end_to_end"] if ours(m)],
        per_layer=[(m["name"], _reader(m["name"])) for m in benchmark["per_layer"] if ours(m)],
    )


def timed_window(pull, seconds: float, sync) -> tuple:
    """(iterations, seconds): ``pull()`` back to back for ``seconds`` of host time, then the card drained."""
    sync()
    t0 = time.perf_counter()
    iterations = 0
    while True:
        pull()
        iterations += 1
        if time.perf_counter() - t0 >= seconds:
            break
    sync()
    return iterations, time.perf_counter() - t0


def host_windows(pull, sync) -> list:
    """µs per iteration issued, over each of ``HOST_WINDOWS`` windows of ``HOST_CALLS`` iterations."""
    samples = []
    for _ in range(HOST_WINDOWS):
        sync()
        t0 = time.perf_counter()
        for _ in range(HOST_CALLS):
            pull()
        samples.append((time.perf_counter() - t0) * 1e6 / HOST_CALLS)
    sync()
    return samples


def shapes_of(reference) -> Shapes:
    return Shapes(
        n_calls=reference.n_calls, n_molecules=reference.n_molecules,
        n_groups=reference.n_groups if reference.aggregate else 0, n_barcodes=reference.n_barcodes,
        n_variants=reference.n_variants, n_donors=reference.n_donors, n_columns=reference.n_columns,
        n_runs=reference.n_runs, neighbour_adds=2 * reference.n_runs,
    )


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, started: float, device: str = "cuda") -> dict:
    """One run of ``cell``; returns the result line's object. ``started``: the process's start on the host clock.

    ``device="cpu"`` is the rehearsal: the program's plain path, no card.
    """
    import torch

    from . import program
    from .reference import Reference

    on_card = device == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    spans = Spans()
    spans.seconds["setup.process"] = time.perf_counter() - started  # the interpreter, its imports
    with spans("setup.generate"):
        draws = draw_config(cell.config, seed)
    with spans("setup.inputs"):
        genotypes, calls, handler = program.inputs(draws, cell.config)
    with spans("setup.pack"):
        packed = program.pack(calls, genotypes)
    with spans("setup.em_run"):
        loop = program.EMLoop(packed, genotypes, handler, cell.traffic, device)
    start = []
    with spans("setup.warm_up"):
        for _ in range(START_ITERATIONS):
            loop.pull()
            with spans("check.capture"):
                start.append(loop.snapshot())
        sync()
    setup_s = time.perf_counter() - started - spans.seconds["check.capture"]

    window, host_us = None, []
    if trace:
        window = profile(loop.pull, min(seconds, TRACE_SECONDS), on_card)
        host_us = host_windows(loop.pull, sync)
        iterations = window.iterations
    else:
        iterations, window_s = timed_window(loop.pull, seconds, sync)
    peak = torch.cuda.max_memory_allocated() if on_card else 0

    end = loop.snapshot()
    loop.pull()
    trajectory = Trajectory(start, end, loop.snapshot().addition)
    loop.close()
    del loop, packed, genotypes, calls, handler
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()

    with spans("check.reference"):
        reference = Reference(draws, cell.config, cell.traffic, device)
        checks, failed = judge(gaps(reference, trajectory), cell.limits)
    result = {"correct": not failed, "attempted": iterations, "failed": len(failed)}
    if trace:
        readings = Readings(spans.seconds, shapes_of(reference), window, host_us)
        metrics = {}
        for name, reader in cell.per_layer:
            value = reader.read(readings)
            if value is not None:
                metrics[name] = {"value": float(value), "unit": reader.UNIT}
    else:
        all_metrics = {
            "em_iter_ms": {"value": window_s / iterations * 1e3, "unit": "ms"},
            "device_peak_gib": {"value": peak / GIB, "unit": "GiB"},
            "setup_s": {"value": setup_s, "unit": "s"},
        }
        metrics = {name: all_metrics[name] for name in cell.end_to_end}
    result["metrics"] = metrics
    result["device"] = {
        "platform": "gpu" if on_card else "cpu",
        "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
        "count": cell.chips if on_card else 0,
        "memory_peak_bytes": peak,
    }
    if trace:
        result["device"].update(busy_s=window.busy_s, window_s=window.window_s)
        result["breakdown"] = {"device_ops": window.top_operations(), "idle_gaps": [list(g) for g in window.gaps]}
    result["spans"] = spans.seconds
    result["checks"] = checks
    return result
