"""The readers of the program's own spans and counters: a fabricated snapshot, none, and the real recorder."""
import json
import sys
import time
import types

import pytest

from bench_h100.harness import REPO, Readings, Shapes, _reader, run_cell
from bench_h100.program_trace import RECORDER
from bench_h100.tiny import CELLS, tiny_cell
from bench_h100.tracing import read_trace

METRICS = ("import_s", "load_s", "em_setup_s", "launch_host_us")
SHAPES = Shapes(n_calls=1, n_molecules=1, n_groups=0, n_barcodes=1, n_variants=2, n_donors=1, n_columns=1,
                n_runs=1, neighbour_adds=2)
KERNEL = {"ph": "X", "cat": "kernel", "name": "estep_kernel", "ts": 0.0, "dur": 10.0}
SNAPSHOT = {
    "spans": {"import": {"seconds": 0.125, "count": 1}, "load.kernels": {"seconds": 0.5, "count": 3},
              "load.hostops": {"seconds": 0.25, "count": 1}, "em.setup": {"seconds": 0.75, "count": 1},
              "em.estep": {"seconds": 0.01, "count": 7}},
    "counters": {"builds": 0, "estep_logits.launches": 11, "estep_logits.host_ns": 300_000,
                 "estep_logits.host_calls": 6, "mstep_update.launches": 6, "mstep_update.host_ns": 100_000,
                 "mstep_update.host_calls": 4, "aggregated_logits.launches": 0, "aggregated_logits.host_ns": 0,
                 "aggregated_logits.host_calls": 0},
}


def _readings(events=(KERNEL,)) -> Readings:
    return Readings({}, SHAPES, read_trace(list(events), iterations=1), [])


def _read(readings) -> dict:
    return {name: _reader(name).read(readings) for name in METRICS}


@pytest.fixture
def recorder(monkeypatch):
    """The program's recorder, as the run would have loaded it, with a fabricated snapshot."""
    monkeypatch.setitem(sys.modules, RECORDER, types.SimpleNamespace(snapshot=lambda: SNAPSHOT))


def test_readers_read_a_fabricated_snapshot(recorder):
    read = _read(_readings())
    assert read["import_s"] == 0.125 and read["em_setup_s"] == 0.75
    assert read["load_s"] == pytest.approx(0.75)  # load.kernels + load.hostops
    assert read["launch_host_us"] == pytest.approx(40.0)  # 400,000 ns over 10 counted calls


def test_readers_read_none_where_the_program_has_no_recorder(monkeypatch):
    monkeypatch.delitem(sys.modules, RECORDER, raising=False)
    assert _read(_readings()) == dict.fromkeys(METRICS)


def test_readers_read_none_without_device_events(recorder):
    """The CPU rehearsal traces no device: the program's numbers are read beside a device trace only."""
    assert _read(_readings(events=())) == dict.fromkeys(METRICS)
    assert _read(Readings({}, SHAPES, None, [])) == dict.fromkeys(METRICS)


def test_missing_spans_and_uncounted_calls_read_none(monkeypatch):
    empty = {"spans": {}, "counters": {"builds": 0, "estep_logits.host_ns": 0, "estep_logits.host_calls": 0}}
    monkeypatch.setitem(sys.modules, RECORDER, types.SimpleNamespace(snapshot=lambda: empty))
    assert _read(_readings()) == dict.fromkeys(METRICS)
    hostops_only = {"spans": {"load.hostops": {"seconds": 0.25, "count": 1}}, "counters": {}}
    monkeypatch.setitem(sys.modules, RECORDER, types.SimpleNamespace(snapshot=lambda: hostops_only))
    assert _reader("load_s").read(_readings()) == 0.25


@pytest.mark.parametrize("metric", METRICS)
def test_each_reader_declares_its_entry(metric):
    entry = next(m for m in json.loads((REPO / "BENCHMARK.json").read_text())["per_layer"] if m["name"] == metric)
    reader = _reader(metric)
    assert (reader.UNIT, reader.LAYER, reader.SOURCE, reader.MOVES) == (
        entry["unit"], entry["layer"], entry["source"], entry["moves"])
    assert entry["workloads"] == list(CELLS)


def test_readers_read_the_real_recorder_after_a_run(monkeypatch):
    """A CPU run of a cell fills the program's recorder; beside a device trace every reader reads it."""
    from demuxalot_tpu_torch.models.demux import Demultiplexer
    from demuxalot_tpu_torch.utils import tracing

    monkeypatch.setattr(Demultiplexer, "device", Demultiplexer.device)
    monkeypatch.setattr(Demultiplexer, "aggregate_on_snps", Demultiplexer.aggregate_on_snps)
    result = run_cell(tiny_cell("pbmc32_65k.em_percall"), 3, 0.1, True, time.perf_counter(), device="cpu")
    assert result["correct"]
    assert sys.modules[RECORDER] is tracing
    read = _read(_readings())
    assert all(read[name] > 0 for name in METRICS), read
    spans = tracing.snapshot()["spans"]
    assert read["em_setup_s"] >= spans["em.setup"]["seconds"] > 0
