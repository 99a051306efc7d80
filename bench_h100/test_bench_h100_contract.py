"""BENCHMARK.json against the benchmark's contract, and what a run may load and read."""
import ast
import json
import re
import subprocess
import sys
from pathlib import Path

import pytest

from bench_h100.harness import BENCH_DIR, REPO, _reader

FORBIDDEN = {"jax", "jaxlib", "flax", "demuxalot_tpu"}
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def _benchmark() -> dict:
    return json.loads((REPO / "BENCHMARK.json").read_text())


def test_benchmark_file_keeps_to_the_contract():
    b = _benchmark()
    assert set(b) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert b["paths"] == ["bench_h100"] and b["command"] == ["python3", "bench_h100/run.py"]
    assert 1 <= b["run_seconds"] <= 51 and isinstance(b["run_seconds"], int)
    configs = {c["name"]: c for c in b["configs"]}
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"} and NAME.match(c["name"])
        assert c["file"].startswith("bench_h100/") and (REPO / c["file"]).is_file()
        assert json.loads((REPO / c["file"]).read_text())["reduced"] == c["reduced"] == []
        assert 1 <= len(c["why"]) <= 200 and 1 <= len(c["source"]) <= 200
    cells = [w["name"] for w in b["workloads"]]
    assert len(set(cells)) == len(cells)
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and NAME.match(w["name"])
        assert w["config"] in configs and w["chips"] == 1 and 1 <= len(w["why"]) <= 200
        assert w["name"] == f"{w['config']}.{w['traffic']}"
        assert (BENCH_DIR / "traffic" / f"{w['traffic']}.json").is_file()
        assert (BENCH_DIR / "limits" / f"{w['name']}.json").is_file()
    assert {c for c in configs} == {w["config"] for w in b["workloads"]}
    names = [m["name"] for m in b["end_to_end"] + b["per_layer"]]
    assert len(set(names)) == len(names) and "setup_s" in names
    for m in b["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    moves = {m["name"] for m in b["end_to_end"]}
    for m in b["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["moves"] in moves and UNIT.match(m["unit"]) and set(m.get("workloads", cells)) <= set(cells)
    assert len(json.dumps(b)) < 64 * 1024


@pytest.mark.parametrize("cell", [w["name"] for w in _benchmark()["workloads"]])
def test_each_cell_holds_the_logits_and_the_addition_to_limits_between_their_readings(cell):
    from bench_h100.check import NUMBERS

    limits = json.loads((BENCH_DIR / "limits" / f"{cell}.json").read_text())
    held = set(limits["limits"])
    assert held <= set(NUMBERS)
    assert {f"{at}_{what}_gap" for at in ("start", "end") for what in ("logits", "addition")} <= held
    for name in held:
        assert limits["lower"][name] < limits["limits"][name] < limits["upper"][name]


@pytest.mark.parametrize("metric", [m["name"] for m in _benchmark()["per_layer"]])
def test_each_reader_declares_what_benchmark_json_says(metric):
    entry = next(m for m in _benchmark()["per_layer"] if m["name"] == metric)
    reader = _reader(metric)
    assert (reader.UNIT, reader.LAYER, reader.SOURCE, reader.MOVES) == (
        entry["unit"], entry["layer"], entry["source"], entry["moves"])


def _top_imports(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {alias.name.split(".")[0] for alias in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", sorted(p.name for p in BENCH_DIR.rglob("*.py") if not p.name.startswith("test_")))
def test_sources_import_no_jax_and_only_program_py_imports_the_program(path):
    imports = _top_imports(next(BENCH_DIR.rglob(path)))
    assert not imports & FORBIDDEN
    if path not in ("program.py", "tiny.py"):
        assert "demuxalot_tpu_torch" not in imports


REHEARSAL = r"""
import json, os, sys, time
opened = []
sys.addaudithook(lambda event, args: opened.append(os.fsdecode(args[0]))
                 if event == "open" and args and isinstance(args[0], (str, bytes, os.PathLike)) else None)
sys.path.insert(0, sys.argv[1])
import bench_h100.run as run
from bench_h100.harness import run_cell
from bench_h100.tiny import tiny_cell
for name in ("pbmc32_65k.em_percall", "pbmc32_65k.em_aggregate"):
    for trace in (False, True):
        run_cell(tiny_cell(name), 3, 0.1, trace, time.perf_counter(), device="cpu")
print(json.dumps({"modules": sorted(sys.modules), "forbidden": run.forbidden_modules(), "opened": opened}))
"""


def test_a_run_loads_no_jax_and_reads_no_tpu_benchmark():
    """Every module a run loads, by its top-level name, and every file it opens."""
    out = subprocess.run([sys.executable, "-c", REHEARSAL, str(REPO)], capture_output=True, text=True,
                         timeout=600, check=True).stdout
    seen = json.loads(out.strip().splitlines()[-1])
    assert not {m.split(".")[0] for m in seen["modules"]} & FORBIDDEN
    assert seen["forbidden"] == []
    assert "demuxalot_tpu_torch" in seen["modules"]
    repo = str(REPO.resolve())
    for path in seen["opened"]:
        path = str(Path(path).resolve())
        if path.startswith(repo):
            rel = Path(path).relative_to(repo)
            assert rel.parts[0] != "benchmarks" and rel.name != "bench.py" and not rel.name.startswith("BENCH_"), rel


def test_run_without_a_card_prints_no_result():
    out = subprocess.run([sys.executable, str(BENCH_DIR / "run.py"), "--workload", "pbmc32_65k.em_percall",
                          "--seed", "1", "--seconds", "1", "--trace", "0"], capture_output=True, text=True,
                         timeout=300, cwd=REPO)
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    assert out.returncode != 0 and out.stdout.strip() == ""
