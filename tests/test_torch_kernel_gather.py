"""The port's row gather and gather-sum against the JAX row-gather canary and gather-rate bench (interpret mode).

``benchmarks/exp_kernel_gather.py``'s two TPU kernels are wrapped here in
``pl.pallas_call(..., interpret=True)`` as its ``try_take_kernel`` and
``main`` wrap them, with inputs from a seeded numpy generator
(``try_take_kernel`` draws from numpy's global state). On the CPU each
wrapper runs its plain PyTorch version: ``gather_rows`` is held bit-equal
to ``_take_kernel``, ``gather_sum`` to ``_bench_kernel`` over 4 steps at
1e-6 relative and to a float64 sum. The CUDA kernels against these plain
versions are in tests/test_torch_gpu.py.
"""
import json
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from demuxalot_tpu_torch.experiments import kernel_gather as KG
from torch_problems import t

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "benchmarks"))
import exp_kernel_gather as JKG  # noqa: E402

torch.set_num_threads(1)


def test_gather_rows_matches_take_kernel():
    rng = np.random.RandomState(0)
    table = rng.rand(JKG.N_ROWS, JKG.WIDTH).astype(np.float32)
    idx = rng.randint(0, JKG.N_ROWS, (1, 256)).astype(np.int32)
    take = pl.pallas_call(
        JKG._take_kernel,
        out_shape=jax.ShapeDtypeStruct((256, JKG.WIDTH), jnp.float32),
        in_specs=[pl.BlockSpec(memory_space=pltpu.VMEM), pl.BlockSpec(memory_space=pltpu.VMEM)],
        out_specs=pl.BlockSpec(memory_space=pltpu.VMEM),
        interpret=True,
    )
    theirs = np.asarray(take(jnp.asarray(idx), jnp.asarray(table)))
    ours = KG.gather_rows(t(table), t(idx[0]))
    np.testing.assert_array_equal(ours.numpy(), theirs)
    np.testing.assert_array_equal(ours.numpy(), table[idx[0]])


def test_gather_sum_matches_bench_kernel():
    n_steps = 4
    rng = np.random.RandomState(1)
    table = rng.rand(JKG.N_ROWS, JKG.WIDTH).astype(np.float32)
    idx = rng.randint(0, JKG.N_ROWS, JKG.TC * n_steps).astype(np.int32)
    bench = pl.pallas_call(
        JKG._bench_kernel,
        grid=(n_steps,),
        in_specs=[pl.BlockSpec(memory_space=pl.ANY), pl.BlockSpec(memory_space=pltpu.VMEM)],
        out_specs=pl.BlockSpec(memory_space=pltpu.VMEM),
        out_shape=jax.ShapeDtypeStruct((1, 1), jnp.float32),
        scratch_shapes=[pltpu.VMEM((1, JKG.TC), jnp.int32), pltpu.SemaphoreType.DMA],
        interpret=True,
    )
    theirs = float(np.asarray(bench(jnp.asarray(idx[None, :]), jnp.asarray(table)))[0, 0])
    ours = KG.gather_sum(t(table), t(idx), JKG.TC)
    assert ours.dtype == torch.float32 and ours.dim() == 0
    exact = table.astype(np.float64)[idx].sum()
    assert float(ours) == pytest.approx(theirs, rel=1e-6)
    assert float(ours) == pytest.approx(exact, rel=1e-6)


@pytest.mark.parametrize("n_idx, step", [(1, 4096), (10_000, 4096), (10_000, 1), (4096 * 3, 4096)])
def test_gather_sum_steps(n_idx, step):
    """Ragged last steps and single-index steps: the float64 sum at 1e-6 relative."""
    table, idx = KG.rate_inputs(1000, 7, n_idx, seed=n_idx, device="cpu")
    exact = float(table.double()[idx.long()].sum())
    assert float(KG.gather_sum(table, idx, step)) == pytest.approx(exact, rel=1e-6)


def test_wrappers_check_their_inputs():
    table, idx = KG.rate_inputs(50, 4, 100, device="cpu")
    with pytest.raises(ValueError, match="int32"):
        KG.gather_rows(table, idx.long())
    with pytest.raises(ValueError, match="step >= 1"):
        KG.gather_sum(table, idx, 0)
    with pytest.raises(ValueError, match="cpu or cuda"):
        KG.gather_rows(table.to("meta"), idx.to("meta"))
    with pytest.raises(ValueError, match="cpu or cuda"):
        KG.gather_sum(table.to("meta"), idx.to("meta"))


def test_rate_runner_on_the_cpu(capsys):
    """The rate entry point at a small size on the CPU (the plain versions), and without a card for cuda."""
    assert KG.main(["--device", "cpu", "--tables", "64x8,100x3", "--n-idx", "5000", "--repeats", "1"]) == 0
    results = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert [r["table"] for r in results] == [[64, 8], [100, 3]]
    for r in results:
        assert r["device"] == "cpu" and r["sum"] == pytest.approx(r["float64_sum"], rel=1e-5)
        assert len(r["gather_rows"]["ms"]) == 2 and r["gather_sum"]["ns_per_row"] > 0
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            KG.run_rate()
