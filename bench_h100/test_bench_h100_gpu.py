"""Each cell on the card through `bench_h100/run.py`, briefly: ``python -m pytest -m gpu bench_h100``."""
import json
import subprocess
import sys

import pytest

from bench_h100.harness import BENCH_DIR, REPO
from bench_h100.tiny import CELLS


@pytest.mark.gpu
@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("trace", [0, 1])
def test_cell_is_correct_on_the_card(name, trace):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    out = subprocess.run([sys.executable, str(BENCH_DIR / "run.py"), "--workload", name, "--seed", "977",
                          "--seconds", "1", "--trace", str(trace)], capture_output=True, text=True, timeout=900,
                         cwd=REPO)
    assert out.returncode == 0, out.stderr[-4000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"], result["checks"]
    assert result["device"]["platform"] == "gpu" and result["device"]["count"] == 1
    if trace:
        assert 0 < result["device"]["busy_s"] <= result["device"]["window_s"]
