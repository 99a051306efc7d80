"""The port's row gather and gather-sum against the JAX row-gather canary and gather-rate bench (interpret mode).

``benchmarks/exp_kernel_gather.py``'s two TPU kernels are wrapped here in
``pl.pallas_call(..., interpret=True)`` as its ``try_take_kernel`` and
``main`` wrap them, with inputs from a seeded numpy generator
(``try_take_kernel`` draws from numpy's global state). On the CPU each
wrapper runs its plain PyTorch version: ``gather_rows`` is held bit-equal
to ``_take_kernel``, ``gather_sum`` to ``_bench_kernel`` over 4 steps at
1e-6 relative and to a float64 sum. The CUDA kernels against these plain
versions are in tests/test_torch_gpu.py. ``gather_plan``, the host's plan
of the on-chip gather-sum, is held here to covering every row with one
slice and every (step, slice) partial with one block, and to the path its
rule picks at the rate runner's tables and the microbench's [8192, 32].
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


H100_SHARED_OPTIN = KG.H100_SHARED_OPTIN
FULL = KG.slice_rows(64, H100_SHARED_OPTIN)  # the most rows a slice holds at width 64 (828)
# (n_rows, width, step, n_idx): the rate runner's tables, the microbench's (gather_forms: 4,194,304 indices on
# [8192, 32] in steps of 8,192), width 7, single-index steps, a step no multiple of 32, a table of exactly 3
# slices of the most rows a block holds at width 64 (FULL) and one 5 rows short of it
PLANS = [*((r, w, KG.STEP, KG.N_IDX) for r, w in KG.RATE_TABLES), (8192, 32, 8192, 4_194_304), (1000, 7, 4096, 100_003),
         (1000, 7, 1, 5000), (8192, 64, 100, 10_001), (3 * FULL, 64, 4096, 50_000), (3 * FULL - 5, 64, 4096, 50_000)]
PATHS = {(8192, 64): "chip", (131_072, 32): "l2", (800_000, 32): "l2", (8192, 32): "chip", (1000, 7): "chip",
         (3 * FULL, 64): "chip", (3 * FULL - 5, 64): "chip"}


def _block_partials(plan: KG.GatherPlan, block: int) -> list:
    """The partials block ``block`` of the on-chip kernel writes (csrc/gather.cu's indexing): slice ``block // R``
    of steps r, r + R, ... (r = ``block % R``), each at ``step * S + slice``."""
    s, r = divmod(block, plan.replicas)
    return [t * plan.n_slices + s for t in range(r, plan.n_steps, plan.replicas)]


@pytest.mark.parametrize("n_rows, width, step, n_idx", PLANS)
def test_gather_plan_covers_rows_and_partials_once(n_rows, width, step, n_idx):
    """Every row in exactly one slice, each slice within a block's shared memory, every (step, slice) partial
    written by exactly one block, and the path the rule (S < W) picks."""
    plan = KG.gather_plan(n_rows, width, step, n_idx, H100_SHARED_OPTIN)
    assert plan.path == PATHS[n_rows, width]
    assert (plan.path == "chip") == (plan.n_slices < width)
    assert plan.n_steps == -(-n_idx // step)
    rows = np.zeros(n_rows, np.int64)
    for s in range(plan.n_slices):
        lo, hi = s * plan.rows_per_slice, min((s + 1) * plan.rows_per_slice, n_rows)
        assert hi > lo, "no slice is empty"
        rows[lo:hi] += 1
    assert (rows == 1).all()
    assert plan.rows_per_slice * width * 4 + KG.CHIP_EXTRA_BYTES <= H100_SHARED_OPTIN
    if plan.path == "l2":
        assert plan.index_passes == 1 and plan.n_partials == plan.n_steps and plan.shared_bytes == 0
        return
    assert plan.index_passes == plan.n_slices and plan.shared_bytes <= H100_SHARED_OPTIN
    assert plan.n_slices * plan.replicas <= 132 or plan.replicas == 1
    written = np.concatenate([_block_partials(plan, b) for b in range(plan.n_slices * plan.replicas)])
    np.testing.assert_array_equal(np.sort(written), np.arange(plan.n_partials))


def test_gather_plan_slices_whole_tables_evenly():
    """A table of exactly S full slices fills each; one 5 rows short keeps S, its slices ⌈rows / S⌉ and the last
    short."""
    exact = KG.gather_plan(3 * FULL, 64, 4096, 50_000, H100_SHARED_OPTIN)
    short = KG.gather_plan(3 * FULL - 5, 64, 4096, 50_000, H100_SHARED_OPTIN)
    assert (exact.n_slices, exact.rows_per_slice) == (3, FULL)
    assert (short.n_slices, short.rows_per_slice) == (3, FULL - 1)
    assert 0 < 3 * FULL - 5 - 2 * short.rows_per_slice < short.rows_per_slice
    assert KG.gather_plan(3 * FULL + 1, 64, 4096, 50_000, H100_SHARED_OPTIN).n_slices == 4
    # one row past what a block holds beside the kernel's sums and queues: no slice fits, so through L2
    wide = (H100_SHARED_OPTIN - KG.CHIP_EXTRA_BYTES) // 4 + 4
    assert KG.gather_plan(10, wide, 4096, 50_000, H100_SHARED_OPTIN).path == "l2"


def test_gather_sum_records_the_plain_path_on_the_cpu():
    table, idx = KG.rate_inputs(64, 8, 500, device="cpu")
    KG.gather_sum(table, idx, 100)
    assert KG.gather_sum.last_path == "plain"
