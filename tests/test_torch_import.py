"""The port imports without jax, pandas, joblib, triton or a CUDA toolchain, and builds nothing on import."""
import json
import os
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
    "demuxalot_tpu_torch.frontend",
    "demuxalot_tpu_torch.frontend.native_counter",
    "demuxalot_tpu_torch.models.demux",
    "demuxalot_tpu_torch.models.genotypes",
    "demuxalot_tpu_torch.models.snp_detection",
    "demuxalot_tpu_torch.native",
    "demuxalot_tpu_torch.native.hostops",
    "demuxalot_tpu_torch.native.scanner",
    "demuxalot_tpu_torch.ops._cuda",
    "demuxalot_tpu_torch.ops.likelihood",
    "demuxalot_tpu_torch.ops.likelihood_kernel",
    "demuxalot_tpu_torch.ops.mstep_kernel",
    "demuxalot_tpu_torch.ops.packing",
    "demuxalot_tpu_torch.sim",
    "demuxalot_tpu_torch.utils",
    "demuxalot_tpu_torch.utils.device",
    "demuxalot_tpu_torch.utils.lookup",
    "demuxalot_tpu_torch.utils.profiling",
    "demuxalot_tpu_torch.utils.summary",
    "demuxalot_tpu_torch.utils.timing",
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
