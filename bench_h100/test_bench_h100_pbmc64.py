"""The 64-donor cells (``pbmc64_65k``) rehearsed on the CPU at a tiny size that keeps the pool's 64 donors.

``device="cpu"`` runs the program's plain path through the whole run of
each cell (set-up, window, reference, judgement against the cell's own
limits) at 2,080 columns, and the bfloat16 control in the program's place
fails those limits. Each cell declares the per-layer metrics of its path.
"""
import time

import pytest
import torch

from bench_h100 import harness
from bench_h100.calibrate import control_trajectory
from bench_h100.check import gaps, judge
from bench_h100.generator import draw_config
from bench_h100.harness import load_cell, run_cell
from bench_h100.reference import Reference

CELLS = ("pbmc64_65k.em_percall", "pbmc64_65k.em_aggregate")
TINY_64 = dict(n_barcodes=200, n_snps=512, calls_per_barcode=24)  # n_snps: a multiple of the stride
SEED = 2_160_484_123  # past 2**31: seeds of more than 32 signed bits
# the set-up and launch-path metrics that the 32-donor cells report; the 64-donor cells may list them too
HOST_METRICS = {"import_s", "load_s", "em_setup_s", "launch_host_us"}


def tiny_64(name: str):
    """The cell ``name`` with its pool's scale cut to :data:`TINY_64`; its 64 donors, mix, limits and metrics kept."""
    cell = load_cell(name)
    cell.config.update(TINY_64)
    return cell


@pytest.fixture
def program_state(monkeypatch):
    """Put back the program's class settings that a run sets."""
    from demuxalot_tpu_torch.models.demux import Demultiplexer

    monkeypatch.setattr(Demultiplexer, "device", Demultiplexer.device)
    monkeypatch.setattr(Demultiplexer, "aggregate_on_snps", Demultiplexer.aggregate_on_snps)


@pytest.mark.parametrize("trace", [False, True])
@pytest.mark.parametrize("name", CELLS)
def test_cell_is_correct_at_64_donors(name, trace, program_state, monkeypatch):
    monkeypatch.setattr(harness, "HOST_CALLS", 4)  # em_host_us's windows: a few plain iterations, not 100
    cell = tiny_64(name)
    assert cell.config["n_donors"] == 64 and cell.limits is not None
    result = run_cell(cell, SEED, 0.2, trace, time.perf_counter(), device="cpu")
    assert result["correct"], result["checks"]
    assert result["failed"] == 0 and result["attempted"] > 0
    assert set(result["checks"]) == set(cell.limits)
    per_layer = dict(cell.per_layer)
    if not trace:
        assert set(result["metrics"]) == set(cell.end_to_end) == {"em_iter_ms", "device_peak_gib", "setup_s"}
        return
    # no device was traced: the host's readers read, the device's and the program's counters' read nothing
    assert {"em_host_us", "pack_s"} <= set(result["metrics"]) <= set(per_layer)


@pytest.mark.parametrize("name", CELLS)
def test_control_fails_at_64_donors(name):
    """The reference one precision below the configuration's float32 (bfloat16), in the program's place."""
    cell = tiny_64(name)
    draws = draw_config(cell.config, 5)
    control = Reference(draws, cell.config, cell.traffic, "cpu", dtype=torch.bfloat16)
    checks, failed = judge(gaps(Reference(draws, cell.config, cell.traffic, "cpu"), control_trajectory(control, 3)),
                           cell.limits)
    assert failed, checks


@pytest.mark.parametrize("name, kernel", [("pbmc64_65k.em_percall", "estep"),
                                          ("pbmc64_65k.em_aggregate", "aggregate")])
def test_each_new_cell_reports_the_kernel_metrics_of_its_path(name, kernel):
    per_layer = {m for m, _ in load_cell(name).per_layer}
    path = {"em_host_us", "em_kernels_per_iter", "step_mfu", "mstep_ms", "mstep_roofline_pct", "device_idle_pct",
            "pack_s", f"{kernel}_ms", f"{kernel}_roofline_pct"}
    assert path <= per_layer <= path | HOST_METRICS
