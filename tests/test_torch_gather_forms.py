"""The port's gather forms and cluster gather-sum against the JAX forms probe and ig_kernel (interpret mode).

``benchmarks/exp_gather_forms.py``'s forms are lambdas local to ``main``
(A and B at ``:66-86``, C, D and D2 at ``:88-125``, E and E2 at
``:127-155``), as is ``ig_kernel`` (``:183-210``): each is rebuilt here by
its lines and run through the file's own ``run_form(..., interpret=True)``
or a ``pl.pallas_call(..., interpret=True)`` with ``main``'s specs. The
forms' inputs are ``main``'s, drawn from ``np.random.default_rng(0)`` in its
order. On the CPU each wrapper runs its plain PyTorch version: every form
is held bit-equal to the TPU kernel, the gather-sum to ``ig_kernel`` over 2
steps at 1e-6 relative and to a float64 sum. The CUDA kernels against these
plain versions are in tests/test_torch_gpu.py.
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

from demuxalot_tpu_torch.experiments import gather_forms as GF
from torch_problems import t

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "benchmarks"))
import exp_gather_forms as JGF  # noqa: E402

torch.set_num_threads(1)


def _take(t_ref, i_ref, o_ref):  # forms A and B (:67-69, 79-81)
    o_ref[:] = jnp.take(t_ref[:], i_ref[0, :], axis=0)


def _tal(axis):  # forms C, D, D2 (:92-94, 104-106, 118-120) and E, E2 (:133-135, 147-149)
    def kernel(t_ref, i_ref, o_ref):
        o_ref[:] = jnp.take_along_axis(t_ref[:], i_ref[:], axis=axis)

    return kernel


def test_form_inputs_are_mains():
    """The port's draws equal main's (:59-155) from np.random.default_rng(0)."""
    rng = np.random.default_rng(0)
    table = rng.random((1024, 128), dtype=np.float32)
    idx1 = rng.integers(0, 1024, 256).astype(np.int32)
    idx_r = rng.integers(0, 1024, 1024).astype(np.int32)
    table2 = rng.random((8192, 128), dtype=np.float32)
    idx_r2 = rng.integers(0, 8192, 8192).astype(np.int32)
    table_l = rng.random((256, 128), dtype=np.float32)
    idx_l = rng.integers(0, 128, (256, 128)).astype(np.int32)
    table_l2 = rng.random((256, 512), dtype=np.float32)
    idx_l2 = rng.integers(0, 512, (256, 512)).astype(np.int32)
    ours = GF.form_inputs(np.random.default_rng(0))
    for form, (want_table, want_idx) in {
        "A": (table, idx1), "B": (table, idx_r), "C": (table, np.broadcast_to(idx1[:, None], (256, 128))),
        "D": (table, np.broadcast_to(idx_r[:, None], (1024, 128))),
        "D2": (table2, np.broadcast_to(idx_r2[:, None], (8192, 128))), "E": (table_l, idx_l),
        "E2": (table_l2, idx_l2),
    }.items():
        np.testing.assert_array_equal(ours[form][0], want_table)
        np.testing.assert_array_equal(ours[form][1], want_idx)
    # and the microbench's table and indices follow them (:166-167)
    after_forms = np.random.default_rng(0)
    GF.form_inputs(after_forms)
    table_b, idx_b = GF.microbench_inputs(after_forms, "cpu")
    assert tuple(table_b.shape) == (GF.RB, GF.WB) and tuple(idx_b.shape) == (GF.NIDX,)
    np.testing.assert_array_equal(table_b.numpy(), rng.random((GF.RB, GF.WB), dtype=np.float32))


@pytest.fixture(scope="module")
def forms():
    return GF.form_inputs(np.random.default_rng(0))


@pytest.mark.parametrize("form", GF.FORMS)
def test_form_matches_run_form(forms, form):
    table, idx, axis = forms[form]
    kernel = _take if axis is None else _tal(axis)
    theirs = JGF.run_form(form, kernel, idx.shape if axis is not None else (len(idx), table.shape[1]), table,
                          idx[None, :] if axis is None else idx, interpret=True)
    assert theirs is not None
    ours = GF.run_form(t(table), t(idx), axis)
    np.testing.assert_array_equal(ours.numpy(), theirs)


def test_probe_forms_on_the_cpu():
    result = GF.probe_forms("cpu")
    assert list(result) == list(GF.FORMS)
    assert all(r["ok"] for r in result.values())


@pytest.mark.parametrize("axis, shape, out_rows", [(0, (50, 7), 13), (1, (9, 33), 9), (0, (1, 1), 3)])
def test_take_along_axis_shapes(axis, shape, out_rows):
    """Widths that are no multiple of 4, and more rows out than in: numpy's take_along_axis."""
    rng = np.random.RandomState(sum(shape))
    table = rng.rand(*shape).astype(np.float32)
    idx_shape = (out_rows, shape[1]) if axis == 0 else (shape[0], 2 * shape[1] + 1)
    idx = rng.randint(0, shape[axis], idx_shape).astype(np.int32)
    np.testing.assert_array_equal(GF.take_along_axis(t(table), t(idx), axis).numpy(),
                                  np.take_along_axis(table, idx, axis=axis))


def test_cluster_gather_sum_matches_ig_kernel():
    """ig_kernel rebuilt by its lines (:183-210) at 2 steps of TCB = RB = 8,192 indices."""
    rb, wb, tcb, steps = GF.RB, GF.WB, GF.RB, 2
    rng = np.random.default_rng(5)
    table = rng.random((rb, wb), dtype=np.float32)
    idx = rng.integers(0, rb, tcb * steps).astype(np.int32)

    def ig_kernel(i_hbm, t_ref, o_ref, ibuf, isem):
        s = pl.program_id(0)
        cp = pltpu.make_async_copy(i_hbm.at[:, pl.ds(s * tcb, tcb)], ibuf, isem)
        cp.start()

        @pl.when(s == 0)
        def _():
            o_ref[:] = jnp.zeros_like(o_ref)

        cp.wait()
        idx2d = jax.lax.broadcast_in_dim(ibuf[0, :], (tcb, wb), (0,))
        rows = jnp.take_along_axis(t_ref[:], idx2d, axis=0)
        o_ref[0, 0] += jnp.sum(rows)

    fn = pl.pallas_call(
        ig_kernel,
        grid=(steps,),
        in_specs=[pl.BlockSpec(memory_space=pl.ANY), pl.BlockSpec(memory_space=pltpu.VMEM)],
        out_specs=pl.BlockSpec(memory_space=pltpu.VMEM),
        out_shape=jax.ShapeDtypeStruct((1, 1), jnp.float32),
        scratch_shapes=[pltpu.VMEM((1, tcb), jnp.int32), pltpu.SemaphoreType.DMA],
        interpret=True,
    )
    theirs = float(np.asarray(fn(jnp.asarray(idx[None, :]), jnp.asarray(table)))[0, 0])
    ours = GF.cluster_gather_sum(t(table), t(idx), tcb)
    assert ours.dtype == torch.float32 and ours.dim() == 0
    assert float(ours) == pytest.approx(theirs, rel=1e-6)
    assert float(ours) == pytest.approx(table.astype(np.float64)[idx].sum(), rel=1e-6)


@pytest.mark.parametrize("n_idx, step", [(1, 8192), (20_001, 8192), (5000, 1), (100, 7)])
def test_cluster_gather_sum_steps(n_idx, step):
    """Ragged last steps, single-index steps, every index in the first CTA's slice: float64 at 1e-6."""
    rng = np.random.RandomState(n_idx)
    table = rng.rand(1000, 7).astype(np.float32)
    idx = rng.randint(0, 1000 if step != 7 else 125, n_idx).astype(np.int32)
    exact = table.astype(np.float64)[idx].sum()
    assert float(GF.cluster_gather_sum(t(table), t(idx), step)) == pytest.approx(exact, rel=1e-6)


def test_wrappers_check_their_inputs():
    table, idx = torch.rand(50, 4), torch.randint(0, 50, (10, 4), dtype=torch.int32)
    with pytest.raises(ValueError, match="int32"):
        GF.take_along_axis(table, idx.long(), 0)
    with pytest.raises(ValueError, match="axis 0 or 1"):
        GF.take_along_axis(table, idx, 2)
    with pytest.raises(ValueError, match="must match"):
        GF.take_along_axis(table, idx[:, :3].contiguous(), 0)
    with pytest.raises(ValueError, match="step >= 1"):
        GF.cluster_gather_sum(table, idx[:, 0].contiguous(), 0)
    with pytest.raises(ValueError, match="cpu or cuda"):
        GF.take_along_axis(table.to("meta"), idx.to("meta"), 0)
    with pytest.raises(ValueError, match="cpu or cuda"):
        GF.cluster_gather_sum(table.to("meta"), idx[:, 0].contiguous().to("meta"))


def test_entry_point_on_the_cpu(capsys):
    """The probe and the microbench (its first 50,000 indices) on the CPU, and without a card for cuda."""
    assert GF.main(["--device", "cpu", "--n-idx", "50000", "--repeats", "1"]) == 0
    result = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert all(f["ok"] for f in result["forms"].values()) and list(result["forms"]) == list(GF.FORMS)
    bench = result["microbench"]
    assert bench["n_idx"] == 50_000 and bench["table"] == [GF.RB, GF.WB]
    for name in ("library", "gather_sum", "cluster_gather_sum"):
        assert bench[name]["sum"] == pytest.approx(bench["float64_sum"], rel=1e-6)
        assert len(bench[name]["ms"]) == 2 and bench[name]["ns_per_row"] > 0
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            GF.microbench()


H100_SHARED_OPTIN = 232_448  # the shared memory one H100 block may opt in to (227 KB)


def test_cluster_plan_fits_the_harness_table():
    """The harness's 1 MiB table: 128 KB a CTA, and a ring of 3 stages of 6,144 indices beside it."""
    plan = GF.cluster_plan(GF.RB, GF.WB, GF.STEP, GF.NIDX, H100_SHARED_OPTIN)
    assert plan.fits and plan.stages >= GF.MIN_STAGES
    assert plan.rows_per_cta == GF.RB // 8 and plan.stage_bytes == 4 * GF.STAGE
    assert (plan.stages, plan.shared_bytes) == (3, 217_360)
    assert plan.n_steps == GF.NIDX // GF.STEP and plan.n_partials == 8 * plan.n_steps
    assert plan.index_passes == 1
    # the partials, then a warp sum per (chunk, CTA, consumer warp)
    assert plan.scratch_floats == plan.n_partials + (GF.NIDX // GF.CHUNK + 1) * 8 * GF.CONSUMER_WARPS


@pytest.mark.parametrize("n_rows", [16_384, 131_072])
def test_cluster_plan_refuses_2_and_16_mib_tables(n_rows):
    """256 KB and 2 MiB a CTA leave no room for the smallest ring."""
    plan = GF.cluster_plan(n_rows, 32, GF.STEP, 100, H100_SHARED_OPTIN)
    assert not plan.fits and plan.stages == 0


@pytest.mark.parametrize("width", [1, 7, 32, 33, 128])
def test_cluster_plan_stays_within_the_opt_in_limit(width):
    """Every table that fits takes at most the opt-in shared memory; the largest one at this width shrinks by the
    smallest ring, queues and barriers only, and one row more does not fit."""
    largest = 0
    for n_rows in range(8, 8 * H100_SHARED_OPTIN // (4 * width) + 16, max(1, H100_SHARED_OPTIN // (64 * width))):
        plan = GF.cluster_plan(n_rows, width, GF.STEP, 1000, H100_SHARED_OPTIN)
        if plan.fits:
            assert plan.shared_bytes <= H100_SHARED_OPTIN and GF.MIN_STAGES <= plan.stages <= GF.MAX_STAGES
            largest = n_rows
    spare = H100_SHARED_OPTIN - GF.CLUSTER_FIXED_BYTES - GF.MIN_STAGES * GF.STAGE_BYTES
    rows = spare // (4 * width)
    assert GF.cluster_plan(8 * rows, width, GF.STEP, 1000, H100_SHARED_OPTIN).stages == GF.MIN_STAGES
    assert not GF.cluster_plan(8 * rows + 8, width, GF.STEP, 1000, H100_SHARED_OPTIN).fits
    assert largest <= 8 * rows


@pytest.mark.parametrize("step, n_idx", [(1, 5000), (7, 100), (8192, 10_001)])
def test_cluster_plan_takes_any_step(step, n_idx):
    """A step of 1 or 7 (no multiple of a stage or a chunk) is planned like the harness's."""
    plan = GF.cluster_plan(1000, 7, step, n_idx, H100_SHARED_OPTIN)
    assert plan.fits and plan.stages == GF.MAX_STAGES
    assert plan.n_steps == -(-n_idx // step) and plan.n_partials == 8 * plan.n_steps


@pytest.mark.parametrize("offset", [0, 1, 3])
@pytest.mark.parametrize("clusters", [1, 16, 600])
def test_cluster_layout_reads_each_index_about_once_per_cluster(offset, clusters):
    """The bulk copies read every index of the body once, plus at most one stage at each edge of a span."""
    n_idx, step = 4 * GF.STAGE * 7 + 1003, 3001
    layout = GF.cluster_layout((8192, 32), n_idx, step, clusters, offset)
    spans = min(clusters, -(-n_idx // step))
    body = (n_idx - (4 - offset) % 4) // 4 * 4  # the indices between the plain head and tail
    assert 4 * body <= layout["index_l2_bytes"] <= 4 * body + 2 * spans * GF.STAGE_BYTES
    assert layout["table_l2_bytes"] == spans * 8192 * 32 * 4
    assert layout["shared_read_bytes"] == 4 * n_idx * (8 + 32)
