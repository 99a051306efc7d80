"""Reading a device trace: busy time, the window, idle gaps with the host's span, and the readers on top."""
import pytest

from bench_h100.harness import Readings, Shapes, _reader
from bench_h100.tracing import read_trace, short_name

EVENTS = [
    {"ph": "X", "cat": "kernel", "name": "void (anonymous namespace)::estep_kernel<true, 4, false>(float const*)",
     "ts": 0.0, "dur": 10.0},
    {"ph": "X", "cat": "kernel", "name": "void (anonymous namespace)::mstep_kernel<2, 16, true>(Calls)",
     "ts": 12.0, "dur": 8.0},
    {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy DtoH", "ts": 20.0, "dur": 5.0},
    {"ph": "X", "cat": "user_annotation", "name": "bench.em_iteration", "ts": 9.0, "dur": 21.0},
    {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 9.5, "dur": 1.5},
    {"ph": "i", "cat": "kernel", "name": "instant", "ts": 3.0},
]
SHAPES = Shapes(n_calls=4_192_362, n_molecules=4_194_304, n_groups=0, n_barcodes=65_536, n_variants=131_072,
                n_donors=32, n_columns=528, n_runs=65_536, neighbour_adds=131_072)


def test_busy_window_and_gaps():
    w = read_trace(EVENTS, iterations=1)
    assert w.n_kernels == 2
    assert w.busy_s == pytest.approx(23e-6) and w.window_s == pytest.approx(25e-6)
    assert w.gaps == [("bench.em_iteration / cudaLaunchKernel", pytest.approx(2e-6))]
    assert [name for name, _ in w.top_operations()] == ["estep_kernel", "mstep_kernel", "Memcpy DtoH"]
    assert short_name("(anonymous namespace)::check_index_kernel(int const*, long, long)") == "check_index_kernel"


def test_readers_on_a_trace():
    r = Readings({"setup.pack": 0.25}, SHAPES, read_trace(EVENTS, iterations=1), [120.0, 130.0, 125.0])
    read = {name: _reader(name).read(r) for name in (
        "device_idle_pct", "em_kernels_per_iter", "estep_ms", "mstep_ms", "aggregate_ms", "em_host_us", "pack_s",
        "aggregate_roofline_pct")}
    assert read["device_idle_pct"] == pytest.approx(8.0)
    assert read["em_kernels_per_iter"] == 2
    assert read["estep_ms"] == pytest.approx(0.01) and read["mstep_ms"] == pytest.approx(0.008)
    assert read["aggregate_ms"] is None and read["aggregate_roofline_pct"] is None  # nothing to read: left out
    assert read["em_host_us"] == 125.0 and read["pack_s"] == 0.25


def test_no_trace_reads_nothing():
    r = Readings({}, SHAPES, read_trace([], iterations=3), [])
    for name in ("device_idle_pct", "em_kernels_per_iter", "estep_ms", "estep_roofline_pct", "mstep_roofline_pct",
                 "step_mfu", "em_host_us", "pack_s"):
        assert _reader(name).read(r) is None, name
