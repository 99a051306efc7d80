"""The port's stream kernels against the JAX harness's two DMA-pattern kernels (interpret mode).

``benchmarks/exp_dma_pattern.py``'s ``stream_cols`` and ``stream_rows``
take no ``interpret`` argument and read the module's ``N_SLOTS`` and ``D``
when called, so each test patches the module's ``pl`` with a namespace
whose ``pallas_call`` runs in interpret mode and ``N_SLOTS`` with the
test's size (the file itself stays as it is). Inputs come from a seeded
numpy generator. On the CPU each wrapper runs its plain PyTorch version,
held to the TPU kernel and to the float64 sum at 1e-6 relative. The CUDA
kernel against these plain versions is in tests/test_torch_gpu.py.
"""
import functools
import json
import sys
import types
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from demuxalot_tpu_torch.experiments import dma_pattern as DP
from torch_problems import offset_view, t

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "benchmarks"))
import exp_dma_pattern as JDP  # noqa: E402

torch.set_num_threads(1)

RTOL = 1e-6


@pytest.fixture
def interpret(monkeypatch):
    """Run the harness's kernels in interpret mode at ``n_slots`` columns (rows)."""

    def patch(n_slots):
        namespace = types.SimpleNamespace(**{name: getattr(pl, name) for name in dir(pl) if not name.startswith("_")})
        namespace.pallas_call = functools.partial(pl.pallas_call, interpret=True)
        monkeypatch.setattr(JDP, "pl", namespace)
        monkeypatch.setattr(JDP, "N_SLOTS", n_slots)

    return patch


def _float64_corners(x, step, cols):
    n_steps = (x.shape[1] if cols else x.shape[0]) // step
    x = x.astype(np.float64)
    if cols:
        return sum(x[:, s * step: s * step + 128].sum() for s in range(n_steps))
    return sum(x[s * step: s * step + 8, :].sum() for s in range(n_steps))


@pytest.mark.parametrize("n_slots", [4096, 4096 + 700])  # 4,796: a ragged tail past the last whole step
@pytest.mark.parametrize("width", [512, 1024])
def test_stream_cols_matches_tpu_kernel(interpret, n_slots, width):
    interpret(n_slots)
    x = np.random.RandomState(width + n_slots).rand(JDP.D, n_slots).astype(np.float32)
    theirs = float(np.asarray(JDP.stream_cols(width)(jnp.asarray(x)))[0, 0])
    ours = DP.stream_cols(t(x), width)
    assert ours.dtype == torch.float32 and ours.dim() == 0
    assert float(ours) == pytest.approx(theirs, rel=RTOL)
    assert float(ours) == pytest.approx(_float64_corners(x, width, True), rel=RTOL)


@pytest.mark.parametrize("n_slots", [4096, 4096 + 700])
@pytest.mark.parametrize("rows", [512, 1024])
def test_stream_rows_matches_tpu_kernel(interpret, n_slots, rows):
    interpret(n_slots)
    x = np.random.RandomState(rows + n_slots + 1).rand(n_slots, JDP.D).astype(np.float32)
    theirs = float(np.asarray(JDP.stream_rows(rows)(jnp.asarray(x)))[0, 0])
    ours = DP.stream_rows(t(x), rows)
    assert ours.dtype == torch.float32 and ours.dim() == 0
    assert float(ours) == pytest.approx(theirs, rel=RTOL)
    assert float(ours) == pytest.approx(_float64_corners(x, rows, False), rel=RTOL)


@pytest.mark.parametrize("cols, step", [(True, 100), (True, 5000), (False, 3), (False, 5000)])
def test_streams_at_odd_steps(cols, step):
    """Steps narrower than the corner and one step as wide as all but the tail: the float64 sum."""
    x = DP.stream_inputs(5003, 7, seed=step, device="cpu", cols=cols)
    got = (DP.stream_cols if cols else DP.stream_rows)(x, step)
    corner = min(128 if cols else 8, step)
    n_steps = 5003 // step
    if cols:
        exact = sum(x[:, s * step: s * step + corner].double().sum() for s in range(n_steps))
    else:
        exact = sum(x[s * step: s * step + corner].double().sum() for s in range(n_steps))
    assert float(got) == pytest.approx(float(exact), rel=RTOL)


def test_stream_bound_counts_the_whole_steps():
    x = DP.stream_inputs(4096 + 700, 32, device="cpu", cols=True)
    bound = DP.stream_bound(x, 512, cols=True)
    assert bound.bytes_read == 4 * 9 * 512 * 32 and bound.bound_by() == "bytes"  # 9 whole steps of 4,796
    assert bound.operations() == 9 * 128 * 32
    full = DP.stream_bound(torch.empty(DP.N_SLOTS, DP.D), 32768, cols=False)
    assert full.bytes_read == 570_425_344  # the harness's 570.4 MB
    assert full.speed_of_light_s() * 1e3 == pytest.approx(0.17028, rel=1e-4)


def test_corner_bound_counts_the_corners_only():
    """The scalar's own bound reads each whole step's corner once; a stream's bound reads the whole steps."""
    x = DP.stream_inputs(4096 + 700, 32, device="cpu", cols=False)
    corner, stream = DP.corner_bound(x, 512, cols=False), DP.stream_bound(x, 512, cols=False)
    assert corner.bytes_read == 4 * 9 * 8 * 32 and corner.bound_by() == "bytes"  # 9 whole steps, 8 rows each
    assert corner.operations() == stream.operations() == 9 * 8 * 32
    assert stream.bytes_read == 64 * corner.bytes_read
    full = DP.corner_bound(torch.empty(DP.D, DP.N_SLOTS), 512, cols=True)
    assert full.bytes_read == 4 * 8704 * 128 * 32  # a quarter of the streamed bytes at width 512


def test_wrappers_check_their_inputs():
    x = torch.rand(4, 100)
    with pytest.raises(ValueError, match="step of 200"):
        DP.stream_cols(x, 200)
    with pytest.raises(ValueError, match="step of 0"):
        DP.stream_rows(x.T.contiguous(), 0)
    with pytest.raises(ValueError, match="contiguous"):
        DP.stream_rows(x.T, 10)
    with pytest.raises(ValueError, match="float32"):
        DP.stream_cols(x.double(), 10)
    with pytest.raises(ValueError, match="cpu or cuda"):
        DP.stream_cols(x.to("meta"), 10)


# (cols, n_slots, d, step, offset, route, boxes a step): the harness's 8 steps (32 KB boxes of 256 columns or
# rows, 2 a step at 512, 128 at 32,768) take TMA; D = 7 rows, N = 100,003 columns and x one float off a 16-byte
# boundary take cp.async; a step of 100 takes TMA where the rows are aligned (one box of 100) and cp.async on
# N = 100,003's
_PLAN_CASES = ([(True, DP.N_SLOTS, DP.D, w, 0, "tma", w // 256) for w in DP.WIDTHS]
               + [(False, DP.N_SLOTS, DP.D, r, 0, "tma", r // 256) for r in DP.ROWS]
               + [(False, 70_001, 7, 4096, 0, "cp.async", 4), (True, 100_003, 32, 100, 0, "cp.async", 1),
                  (True, 65_536, 32, 512, 1, "cp.async", 2), (False, 65_536, 32, 512, 1, "cp.async", 2),
                  (False, 100_003, 32, 100, 0, "tma", 1), (True, 4096, 7, 512, 0, "tma", 2)])


@pytest.mark.parametrize("cols, n_slots, d, step, offset, route, boxes", _PLAN_CASES)
def test_stream_plan_takes_tma_where_a_tensor_map_addresses_x(cols, n_slots, d, step, offset, route, boxes):
    shape = (d, n_slots) if cols else (n_slots, d)
    x = offset_view(torch.zeros(shape), offset) if offset else torch.empty(shape)  # empty: no page is touched
    plan = DP.stream_plan(x, step, cols)
    assert (plan.route, plan.boxes_per_step) == (route, boxes)
    assert plan.n_steps == n_slots // step
    if route == "tma":
        assert plan.reason is None and plan.stages == DP.TMA_STAGES
        assert plan.box == ((d, step // boxes) if cols else (step // boxes, d))
        assert plan.box_bytes == 4 * d * step // boxes <= 32_768 and max(plan.box) <= 256
        assert plan.corner_boxes == 1
    else:
        assert plan.reason and plan.stages == DP.CP_ASYNC_STAGES


def test_stream_plan_counts_each_box_that_holds_the_corner():
    """Narrow boxes: a step's 128-column corner spans 4 boxes of 32 columns at D = 256, one partial each."""
    plan = DP.stream_plan(torch.empty(256, 4096), 512, cols=True)
    assert plan.route == "tma" and plan.box == (256, 32) and plan.boxes_per_step == 16
    assert plan.corner_boxes == 4 and plan.n_steps == 8
    rows = DP.stream_plan(torch.empty(4096, 64), 4, cols=False)  # steps of 4 rows: the corner is the whole step
    assert rows.route == "tma" and rows.box == (4, 64) and (rows.boxes_per_step, rows.corner_boxes) == (1, 1)


def test_rate_runner_on_the_cpu(capsys):
    """The entry point at a small size on the CPU (the plain versions), and without a card for cuda."""
    assert DP.main(["--device", "cpu", "--n-slots", "5000", "--widths", "512,1024", "--rows", "512",
                    "--repeats", "1"]) == 0
    results = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert [(r["layout"], r.get("width", r.get("rows"))) for r in results] == [
        ("cols", 512), ("cols", 1024), ("rows", 512)]
    for r in results:
        assert r["device"] == "cpu" and r["sum"] == pytest.approx(r["float64_sum"], rel=RTOL)
        assert len(r["ms"]) == 2 and len(r["library_ms"]) == 2 and r["bound_by"] == "bytes"
        # the plan a card would take: 5,000 slots of 32 floats are TMA-addressable, boxes of 256 columns or rows
        step = r.get("width", r.get("rows"))
        assert r["ran"] == "plain" and r["route"] == "tma" and r["tma_refusal"] is None
        assert r["stages"] == DP.TMA_STAGES and r["boxes_per_step"] == step // 256 and r["box_bytes"] == 32_768
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            DP.run_stream()
