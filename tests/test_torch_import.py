"""The port imports without jax, pandas, joblib, triton or a CUDA toolchain, and builds nothing on import."""
import ast
import json
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

REPO_ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "pandas", "joblib", "triton", "demuxalot_tpu")

MODULES = [
    "demuxalot_tpu_torch",
    "demuxalot_tpu_torch.bamio",
    "demuxalot_tpu_torch.cli",
    "demuxalot_tpu_torch.convert",
    "demuxalot_tpu_torch.experiments",
    "demuxalot_tpu_torch.experiments.dma_pattern",
    "demuxalot_tpu_torch.experiments.estep_variants",
    "demuxalot_tpu_torch.experiments.folded_estep",
    "demuxalot_tpu_torch.experiments.gather_forms",
    "demuxalot_tpu_torch.experiments.gather_operand",
    "demuxalot_tpu_torch.experiments.group_estep",
    "demuxalot_tpu_torch.experiments.inkernel_gather",
    "demuxalot_tpu_torch.experiments.kernel_gather",
    "demuxalot_tpu_torch.experiments.split_estep",
    "demuxalot_tpu_torch.frontend",
    "demuxalot_tpu_torch.frontend.native_counter",
    "demuxalot_tpu_torch.models.demux",
    "demuxalot_tpu_torch.models.genotypes",
    "demuxalot_tpu_torch.models.snp_detection",
    "demuxalot_tpu_torch.native",
    "demuxalot_tpu_torch.native.hostops",
    "demuxalot_tpu_torch.native.scanner",
    "demuxalot_tpu_torch.ops._cuda",
    "demuxalot_tpu_torch.ops.aggregate_kernel",
    "demuxalot_tpu_torch.ops.likelihood",
    "demuxalot_tpu_torch.ops.likelihood_kernel",
    "demuxalot_tpu_torch.ops.mstep_kernel",
    "demuxalot_tpu_torch.ops.packing",
    "demuxalot_tpu_torch.parallel",
    "demuxalot_tpu_torch.parallel.mesh",
    "demuxalot_tpu_torch.parallel.sharded",
    "demuxalot_tpu_torch.sim",
    "demuxalot_tpu_torch.utils",
    "demuxalot_tpu_torch.utils.device",
    "demuxalot_tpu_torch.utils.lookup",
    "demuxalot_tpu_torch.utils.profiling",
    "demuxalot_tpu_torch.utils.summary",
    "demuxalot_tpu_torch.utils.timing",
    "demuxalot_tpu_torch.utils.tracing",
]


@pytest.fixture(scope="module")
def loaded_after_import():
    """{module: forbidden modules in sys.modules after importing it}, one fresh process."""
    code = (
        "import importlib, json, sys\n"
        "result = {}\n"
        f"for module in {MODULES!r}:\n"
        "    importlib.import_module(module)\n"
        f"    result[module] = [m for m in {FORBIDDEN!r} if m in sys.modules]\n"
        "print(json.dumps(result))\n"
    )
    env = {k: v for k, v in os.environ.items() if k not in ("CUDA_HOME", "CUDA_PATH")}
    env["PATH"] = os.path.dirname(sys.executable)  # no nvcc on the path
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO_ROOT, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr
    return json.loads(proc.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("module", MODULES)
def test_import_needs_no_jax_pandas_or_toolchain(module, loaded_after_import):
    assert loaded_after_import[module] == []


def test_cli_help_runs_with_jax_unimportable():
    """``python -m demuxalot_tpu_torch demux --help`` where ``import jax`` fails."""
    code = (
        "import runpy, sys\n"
        "sys.modules['jax'] = None  # any import of jax now raises ImportError\n"
        "sys.argv = ['demuxalot_tpu_torch', 'demux', '--help']\n"
        "runpy.run_module('demuxalot_tpu_torch', run_name='__main__', alter_sys=True)\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO_ROOT, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "--device" in proc.stdout and "--compact" in proc.stdout


JAX_PACKAGE_NAME = re.compile(r"\bdemuxalot_tpu\b")  # not demuxalot_tpu_torch
# a "replaces" entry of chip_smoke.py's kernels line cites the reference by file:line
CITATION = re.compile(r"demuxalot_tpu/[\w/]+\.py:\d+")
PORT_FILES = sorted(
    str(path.relative_to(REPO_ROOT)) for path in (REPO_ROOT / "demuxalot_tpu_torch").rglob("*.py")
) + ["chip_smoke.py"]


def _docstrings(tree) -> set:
    found = set()
    for node in ast.walk(tree):
        if isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef, ast.AsyncFunctionDef)) and node.body:
            first = node.body[0]
            if isinstance(first, ast.Expr) and isinstance(first.value, ast.Constant):
                found.add(id(first.value))
    return found


@pytest.mark.parametrize("path", PORT_FILES)
def test_code_names_nothing_inside_the_jax_package(path):
    """No import of jax or demuxalot_tpu, and no string that names a path inside demuxalot_tpu/.

    Docstrings and comments may cite the reference, and so may a string that
    is only a file:line citation.
    """
    tree = ast.parse((REPO_ROOT / path).read_text())
    docstrings = _docstrings(tree)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            imported = [alias.name for alias in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            imported = [node.module or ""]
        else:
            imported = []
        for name in imported:
            assert name.split(".")[0] not in ("jax", "demuxalot_tpu"), f"{path}:{node.lineno} imports {name}"
        if isinstance(node, ast.Constant) and isinstance(node.value, str) and id(node) not in docstrings:
            if JAX_PACKAGE_NAME.search(node.value) and not CITATION.fullmatch(node.value):
                raise AssertionError(f"{path}:{node.lineno} names the JAX package: {node.value[:80]!r}")


def test_native_libraries_build_from_the_port_alone(tmp_path):
    """A copy of the port with no demuxalot_tpu/ beside it builds and runs both C++ libraries."""
    shutil.copytree(REPO_ROOT / "demuxalot_tpu_torch", tmp_path / "demuxalot_tpu_torch",
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    code = (
        "import sys\n"
        "sys.modules['jax'] = sys.modules['demuxalot_tpu'] = None  # importing either raises\n"
        "import numpy as np\n"
        "from demuxalot_tpu_torch import native\n"
        "from demuxalot_tpu_torch.native import hostops\n"
        f"assert str(native.SOURCE_DIR).startswith({str(tmp_path)!r}), native.SOURCE_DIR\n"
        "native.load_library()\n"
        "assert hostops.native_library() is native.load_host_library()\n"
        "keys = np.random.RandomState(0).randint(0, 1000, 100_000).astype(np.int64)\n"
        "assert (hostops.stable_argsort(keys) == np.argsort(keys, kind='stable')).all()\n"
        "print(sorted(p.name for p in native.BUILD_DIR.iterdir()))\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr
    from demuxalot_tpu_torch import native

    # the build names hash the source bytes: the copy builds what the repository's port builds
    expected = sorted(native.library_path(native.SOURCE_DIR / f"{name}.cpp", extra).name
                      for name, extra in (("hostops", ("-pthread",)), ("scanner", ("-lz",))))
    assert json.loads(proc.stdout.strip().splitlines()[-1].replace("'", '"')) == expected
