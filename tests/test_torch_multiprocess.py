"""The port's sharded engine across two OS processes on the CPU (``gloo``).

After tests/test_multiprocess.py: two processes with two CPU shards each
join one 4-shard mesh through ``init_distributed(backend="gloo")`` on a
free port (tests/torch_sharded_worker.py, no jax). Their first E-step's
logits and their all-reduced first M-step addition must equal a
one-process 4-shard run's (rtol 1e-5, atol 1e-6), and so must what follows
from them. Every wait has a timeout, and a worker that dies ends the run
at once with its output.
"""
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from torch_sharded_worker import PROBLEM, free_port, run, run_processes

WORKER = Path(__file__).resolve().parent / "torch_sharded_worker.py"


@pytest.fixture(scope="module")
def two_processes(tmp_path_factory):
    out = tmp_path_factory.mktemp("mp") / "result.npz"
    port = free_port()
    run_processes([[sys.executable, str(WORKER), "--rank", str(rank), "--world", "2", "--port", str(port),
                  "--out", str(out), "--shards", "2", "--timeout", "60"] for rank in range(2)], timeout=240)
    return dict(np.load(out))


@pytest.fixture(scope="module")
def one_process():
    from demuxalot_tpu_torch.parallel import make_mesh

    return run(make_mesh([torch.device("cpu")] * 4), **PROBLEM)


@pytest.mark.parametrize("name", ["logits0", "addition1", "em_probs", "betas", "logits"])
def test_two_processes_equal_one(two_processes, one_process, name):
    np.testing.assert_allclose(two_processes[name], one_process[name], rtol=1e-5, atol=1e-6)


def test_two_processes_assign_alike(two_processes, one_process):
    assert two_processes["logits0"].shape == (PROBLEM["n_barcodes"], 21)
    np.testing.assert_array_equal(two_processes["em_probs"].argmax(1), one_process["em_probs"].argmax(1))
    np.testing.assert_array_equal(two_processes["top_index"][:, 0], one_process["top_index"][:, 0])
    # the first E-step computes each barcode from its own calls in order
    np.testing.assert_array_equal(two_processes["logits0"], one_process["logits0"])


def test_dead_worker_fails_fast():
    started = time.monotonic()
    with pytest.raises(RuntimeError, match="process 0 exited 3"):
        run_processes([[sys.executable, "-c", "raise SystemExit(3)"],
                     [sys.executable, "-c", "import time; time.sleep(60)"]], timeout=120)
    assert time.monotonic() - started < 30
