"""The port's recorder (``utils.tracing``): spans, parents, the bounded table, counters and the profiler's trace.

On the CPU, at a tiny synthetic pool: spans nest with one stack per
thread, the table keeps the newest records while the totals keep them all,
no ``record_function`` is opened while no profiler records, a learn and a
compact predict under ``utils.profiling.device_trace`` put their spans
into ``trace.json`` and give the bits of a run without it, the entry
points' stages are spans, and ``.host_ns`` counts every call of an op
after its first.
"""
import ast
import json
import sys
import threading
import time
from collections import deque
from pathlib import Path

import numpy as np
import pytest
import torch

from demuxalot_tpu_torch import BarcodeHandler, Demultiplexer, sim
from demuxalot_tpu_torch.models import demux
from demuxalot_tpu_torch.ops.likelihood_kernel import estep_logits, estep_operands
from demuxalot_tpu_torch.utils import device_trace, tracing

POOL = dict(n_barcodes=96, n_donors=4, n_snps=200, calls_per_barcode=16)


@pytest.fixture(autouse=True)
def recorder(monkeypatch):
    """An empty recorder and the plain path for each test."""
    monkeypatch.setattr(Demultiplexer, "device", "cpu")
    tracing.reset()
    yield
    tracing.reset()


@pytest.fixture(scope="module")
def pool():
    genotypes, calls, _truth, _names = sim.synthesize_compressed_calls(doublets_fraction=0.2, seed=4, **POOL)
    handler = BarcodeHandler([f"BC{b:03d}" for b in range(POOL["n_barcodes"])])
    return calls, genotypes, handler


def _learn_and_compact(pool):
    calls, genotypes, handler = pool
    learnt = Demultiplexer.learn_genotypes_core(calls, genotypes, handler, n_iterations=3, doublet_prior=0.25)
    compact = Demultiplexer.predict_posteriors_compact(calls, learnt.genotypes, handler, k=2)
    return learnt, compact


def _parents() -> dict:
    """{span name: the set of its parents' names} over the table."""
    parents: dict = {}
    for name, parent, _, _ in tracing.records():
        parents.setdefault(name, set()).add(parent)
    return parents


def test_the_recorder_imports_the_standard_library_only():
    tree = ast.parse(Path(tracing.__file__).read_text())
    imported = {alias.name.split(".")[0] for node in ast.walk(tree) if isinstance(node, ast.Import)
                for alias in node.names}
    imported |= {node.module.split(".")[0] for node in ast.walk(tree)
                 if isinstance(node, ast.ImportFrom) and node.level == 0 and node.module}
    assert imported - {"__future__"} <= set(sys.stdlib_module_names), imported


def test_spans_nest_with_a_parent_and_fold_a_repeated_name():
    with tracing.span("outer") as outer:
        with tracing.span("inner"):
            with tracing.span("outer"):  # folded into the open one: counted once
                pass
        with tracing.span("inner"):
            pass
    assert [(name, parent) for name, parent, _, _ in tracing.records()] == [
        ("inner", "outer"), ("inner", "outer"), ("outer", None)]
    spans = tracing.snapshot()["spans"]
    assert spans["outer"]["count"] == 1 and spans["inner"]["count"] == 2
    assert spans["outer"]["seconds"] == pytest.approx(outer.seconds)
    assert spans["outer"]["seconds"] >= spans["inner"]["seconds"] > 0
    start, end = [(s, e) for name, _, s, e in tracing.records() if name == "outer"][0]
    assert all(start <= s <= e <= end for name, _, s, e in tracing.records() if name == "inner")


def test_each_thread_has_its_own_stack():
    opened, release = threading.Event(), threading.Event()

    def worker():
        with tracing.span("worker"):
            opened.set()
            release.wait(10)

    with tracing.span("main"):
        thread = threading.Thread(target=worker)
        thread.start()
        opened.wait(10)
        with tracing.span("main.child"):
            pass
        release.set()
        thread.join(10)
    assert _parents() == {"worker": {None}, "main.child": {"main"}, "main": {None}}


def test_spans_from_many_threads_lose_no_count():
    """More threads than cores, switching often: every span reaches the table and the totals."""
    threads, spans = 16, 200
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def worker(i):
            for _ in range(spans):
                with tracing.span(f"t{i % 2}"):
                    tracing.count("spans")
        workers = [threading.Thread(target=worker, args=(i,)) for i in range(threads)]
        for w in workers:
            w.start()
        for w in workers:
            w.join(60)
        assert not any(w.is_alive() for w in workers)
    finally:
        sys.setswitchinterval(interval)
    snap = tracing.snapshot()
    assert snap["spans"]["t0"]["count"] + snap["spans"]["t1"]["count"] == threads * spans
    assert snap["counters"]["spans"] == threads * spans == len(tracing.records())
    assert {parent for _, parent, _, _ in tracing.records()} == {None}


def test_the_table_keeps_the_newest_records_and_the_totals_all(monkeypatch):
    monkeypatch.setattr(tracing, "_table", deque(maxlen=3))
    for i in range(5):
        with tracing.span(f"s{i}"):
            pass
    assert [name for name, *_ in tracing.records()] == ["s2", "s3", "s4"]
    assert sorted(tracing.snapshot()["spans"]) == [f"s{i}" for i in range(5)]
    assert tracing.TABLE_ROWS >= 4096


def test_record_and_count():
    started = time.perf_counter_ns()
    with tracing.span("outer"):
        tracing.record("import", started)
    tracing.count("builds")
    tracing.count("builds", 2)
    snap = tracing.snapshot()
    assert snap["spans"]["import"]["count"] == 1
    assert snap["spans"]["import"]["seconds"] > 0
    assert tracing.records()[0][:2] == ("import", "outer")
    assert snap["counters"]["builds"] == 3
    tracing.reset()
    assert tracing.snapshot()["spans"] == {} and tracing.snapshot()["counters"]["builds"] == 0


def test_iteration_spans_only_while_a_profiler_records():
    with tracing.step("em.estep"):
        pass
    assert "em.estep" not in tracing.snapshot()["spans"]
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        assert tracing.profiling()
        with tracing.step("em.estep"):
            pass
    assert not tracing.profiling()
    assert tracing.snapshot()["spans"]["em.estep"]["count"] == 1


def test_no_record_function_while_no_profiler_records(pool, monkeypatch):
    opened = []

    class Counting:
        def __init__(self, name):
            opened.append(name)

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

    monkeypatch.setattr(torch.profiler, "record_function", Counting)
    _learn_and_compact(pool)
    assert opened == []
    assert {"learn", "em.setup", "em.loop", "predict", "predict.forward"} <= set(tracing.snapshot()["spans"])
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        _learn_and_compact(pool)
    assert {"learn", "em.setup", "em.estep", "em.mstep", "predict.forward", "compact_topk"} <= set(opened)


def test_a_learn_and_a_compact_predict_under_device_trace(pool, tmp_path):
    """Every span is a user annotation of trace.json, and tracing changes no bit."""
    learnt, compact = _learn_and_compact(pool)
    with device_trace(str(tmp_path)):
        learnt_traced, compact_traced = _learn_and_compact(pool)
    events = json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
    annotations = {e["name"] for e in events if e.get("cat") == "user_annotation"}
    assert {"pack", "pack.join", "pack.collapse", "betas_for", "em.setup", "em.estep", "em.mstep", "em.loop",
            "registry_addition", "_with_betas", "predict.forward", "compact_topk", "materialize"} <= annotations
    np.testing.assert_array_equal(learnt.genotypes.get_betas(), learnt_traced.genotypes.get_betas())
    np.testing.assert_array_equal(learnt.state.probs.numpy(), learnt_traced.state.probs.numpy())
    np.testing.assert_array_equal(compact.top_logits, compact_traced.top_logits)
    np.testing.assert_array_equal(compact.top_index, compact_traced.top_index)
    np.testing.assert_array_equal(compact.logsumexp, compact_traced.logsumexp)


def test_the_entry_points_stages_are_spans(pool):
    _learn_and_compact(pool)
    parents = _parents()
    assert parents["learn"] == {None} and parents["predict"] == {None}
    for child in ("em.prior", "em.operands", "em.uploads"):
        assert parents[child] == {"em.setup"}, child
    assert parents["em.setup"] == {"learn"} and parents["em.loop"] == {"learn"}
    for child in ("pack.join", "pack.reindex", "pack.collapse"):
        assert parents[child] == {"pack"}, child
    assert parents["pack"] == {"em.prior", "predict.prior"} and parents["betas_for"] == {"em.prior", "predict.prior"}
    assert parents["registry_addition"] == {"materialize"} and parents["d2h.addition"] == {"registry_addition"}
    assert parents["_with_betas"] == {"materialize"}
    for child in ("predict.prior", "predict.operands", "predict.uploads", "predict.forward", "compact_topk"):
        assert parents[child] == {"predict"}, child
    assert "em.flush" not in parents and "predict.flush" not in parents  # only where STAGE_TIMINGS is a dict


def test_stage_timings_are_the_spans_seconds(pool, monkeypatch):
    calls, genotypes, handler = pool
    monkeypatch.setattr(demux, "STAGE_TIMINGS", {})
    Demultiplexer.learn_genotypes_core(calls, genotypes, handler, n_iterations=2)
    timings = demux.STAGE_TIMINGS
    spans = tracing.snapshot()["spans"]
    assert timings["device_loop_s"] == spans["em.loop"]["seconds"]
    assert timings["upload_flush_s"] == spans["em.flush"]["seconds"]
    assert timings["pack_s"] == spans["em.prior"]["seconds"]
    assert timings["layout_s"] == pytest.approx(spans["em.operands"]["seconds"] + spans["em.uploads"]["seconds"])
    assert timings["d2h_addition_s"] == spans["d2h.addition"]["seconds"]
    assert timings["materialize_s"] == spans["materialize"]["seconds"]


def _estep_inputs():
    generator = torch.Generator().manual_seed(0)
    n_variants, n_donors, n_barcodes, n_calls = 40, 3, 10, 60
    cb = torch.sort(torch.randint(0, n_barcodes, (n_calls,), generator=generator)).values.to(torch.int32)
    vid = torch.randint(0, n_variants, (n_calls,), generator=generator, dtype=torch.int32)
    q = torch.rand(n_calls, generator=generator) * 0.1
    row_ptr = torch.from_numpy(np.searchsorted(cb.numpy(), np.arange(n_barcodes + 1)).astype(np.int64))
    operands = estep_operands(n_donors, 0.25, row_ptr, cb, vid, q, n_variants)
    return torch.rand(n_variants, n_donors, generator=generator), operands


def test_host_ns_counts_every_call_after_the_first():
    genotype_prob, operands = _estep_inputs()
    first = not estep_logits.loaded
    before = estep_logits.host_calls
    launches = estep_logits.launches
    for _ in range(4):
        estep_logits(genotype_prob, operands)
    assert estep_logits.host_calls - before == 4 - first
    assert estep_logits.host_ns > 0 and estep_logits.launches == launches  # the plain path launches nothing
    counters = tracing.snapshot()["counters"]
    assert counters["estep_logits.host_calls"] == estep_logits.host_calls
    assert counters["estep_logits.host_ns"] == estep_logits.host_ns
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        estep_logits(genotype_prob, operands)
    assert estep_logits.host_calls - before == 4 - first  # a call under a profiler is not counted


def test_an_ops_first_call_is_the_load_kernels_span(monkeypatch):
    monkeypatch.setattr(tracing, "_ops", list(tracing._ops))
    calls = []

    @tracing.timed_op
    def op(x):
        calls.append(x)
        if x < 0:
            raise ValueError(x)
        return x

    with pytest.raises(ValueError):
        op(-1)  # a call that raises loads nothing: the next is still the first
    assert (op(1), op(2), op(3)) == (1, 2, 3)
    assert op.host_calls == 2 and op.host_ns > 0
    assert tracing.snapshot()["spans"]["load.kernels"]["count"] == 2
    assert tracing.snapshot()["counters"]["op.host_calls"] == 2
    tracing.reset()
    assert op.host_calls == 0 and op.host_ns == 0 and op.loaded
