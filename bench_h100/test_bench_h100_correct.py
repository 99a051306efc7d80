"""The comparison that decides ``correct``, driven through a whole run of each cell at a tiny size on the CPU.

The harness's look for a card is skipped (``device="cpu"`` runs the
program's plain path); everything else of a run runs: set-up, the window,
the reference, the judgement against the cell's own limits. A sound run
passes; the control (the reference in bfloat16 in the program's place) and
each fault a cell can have, planted in the program under the timed path,
fail.
"""
import time

import numpy as np
import pytest
import torch

from bench_h100 import reference as R
from bench_h100.calibrate import control_trajectory
from bench_h100.check import NUMBERS, gaps, judge
from bench_h100.generator import draw_config
from bench_h100.harness import run_cell
from bench_h100.tiny import CELLS, tiny_cell


@pytest.fixture
def program_state(monkeypatch):
    """Put back the program's class settings that a run sets."""
    from demuxalot_tpu_torch.models.demux import Demultiplexer

    monkeypatch.setattr(Demultiplexer, "device", Demultiplexer.device)
    monkeypatch.setattr(Demultiplexer, "aggregate_on_snps", Demultiplexer.aggregate_on_snps)


def _run(cell, seed=11, trace=False):
    return run_cell(cell, seed, 0.2, trace, time.perf_counter(), device="cpu")


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct(name, program_state):
    cell = tiny_cell(name)
    result = _run(cell)
    assert result["correct"], result["checks"]
    assert result["failed"] == 0 and result["attempted"] > 0
    assert list(result["checks"]) == [n for n in NUMBERS if n in cell.limits]
    assert list(result)[-1] == "checks"
    assert set(result["metrics"]) == set(cell.end_to_end)


@pytest.mark.parametrize("name", CELLS)
def test_control_fails(name):
    """The reference one precision below the configuration's float32 (bfloat16), in the program's place."""
    cell = tiny_cell(name)
    draws = draw_config(cell.config, 5)
    control = R.Reference(draws, cell.config, cell.traffic, "cpu", dtype=torch.bfloat16)
    numbers = gaps(R.Reference(draws, cell.config, cell.traffic, "cpu"), control_trajectory(control, 3))
    checks, failed = judge(numbers, cell.limits)
    assert failed, checks


def _stuck_state(monkeypatch):
    """Every step returns the state it was given: the loop yields its first iteration for ever."""
    from demuxalot_tpu_torch.models import demux

    iterations = demux._EMRun.device_iterations

    def stuck(self):
        first = next(iterations(self))
        while True:
            yield first

    monkeypatch.setattr(demux._EMRun, "device_iterations", stuck)


def _half_the_batch(monkeypatch):
    """The M-step leaves out the second half of the barcodes and scales the rest's weights to stand for all."""
    from demuxalot_tpu_torch.models import demux

    update = demux.mstep_update

    def half(posterior, *args, **kwargs):
        kept = posterior.clone()
        half_rows = posterior.shape[0] // 2
        kept[half_rows:] = 0
        kept[:half_rows] *= 2 ** 0.5  # the weight is squared: twice each kept barcode's share
        return update(kept, *args, **kwargs)

    monkeypatch.setattr(demux, "mstep_update", half)


def _altered_answer(monkeypatch):
    """One barcode's posterior row comes out shifted by one column where the E-step produces it."""
    from demuxalot_tpu_torch.models import demux

    posteriors = demux._Likelihood.posteriors

    def altered(self, *args, **kwargs):
        logits, probs = posteriors(self, *args, **kwargs)
        probs = probs.clone()
        probs[7] = torch.roll(probs[7], 1)
        return logits, probs

    monkeypatch.setattr(demux._Likelihood, "posteriors", altered)


@pytest.mark.parametrize("fault", [_stuck_state, _half_the_batch, _altered_answer])
@pytest.mark.parametrize("name", CELLS)
def test_fault_fails(name, fault, monkeypatch, program_state):
    fault(monkeypatch)
    result = _run(tiny_cell(name))
    assert not result["correct"], result["checks"]
    assert result["failed"] > 0


def test_traced_run_reports_per_layer_metrics_on_the_cpu(program_state):
    """The traced path runs through; with no device events only the host's metrics can read."""
    result = _run(tiny_cell("pbmc32_65k.em_percall"), trace=True)
    assert result["correct"], result["checks"]
    assert set(result["metrics"]) == {"em_host_us", "pack_s"}
    assert result["device"]["busy_s"] == 0.0
    assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}


def test_reference_collapses_and_joins():
    """Molecules of one (variant, barcode) become one call with the product of their q; unmatched calls drop."""
    cell = tiny_cell("pbmc32_65k.em_percall")
    draws = draw_config(cell.config, 3)
    draws.snp[1], draws.allele[1], draws.cb[1] = draws.snp[0], draws.allele[0], draws.cb[0]
    draws.allele[5] = 2  # a "G": no variant of the registry
    ref = R.Reference(draws, cell.config, cell.traffic, "cpu")
    first = (ref.vid == int(draws.snp[0]) * 2 + int(draws.allele[0])) & (ref.cb == int(draws.cb[0]))
    assert int(first.sum()) == 1
    same = (draws.snp == draws.snp[0]) & (draws.allele == draws.allele[0]) & (draws.cb == draws.cb[0])
    assert same.sum() >= 2
    np.testing.assert_allclose(float(ref.q[first]), np.prod(draws.q[same].astype(np.float64)), rtol=1e-12)
    assert ref.n_molecules == draws.n_calls - 1
