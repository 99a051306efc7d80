"""In-kernel gather forms: take_along_axis, the cluster-resident gather-sum, the forms probe and the microbench.

The counterpart of ``benchmarks/exp_gather_forms.py``, which probed which
dynamic-gather forms the TPU's kernel compiler lowers (``run_form``,
``:38``, with ``main``'s lambdas) and timed a gather from a table held in
on-chip memory (``ig_kernel``, ``:183-210``). Kernels: ``csrc/forms.cu``.

- Forms A and B (``:66-86``), ``jnp.take(table, idx, axis=0)`` with 1-D
  indices, are exactly ``kernel_gather.gather_rows`` (``csrc/gather.cu``),
  and run there.
- :func:`take_along_axis` (forms C, D, D2 at ``:88-125``, E and E2 at
  ``:127-155``): ``out[i, j] = table[idx[i, j], j]`` (axis 0) or
  ``table[i, idx[i, j]]`` (axis 1) with 2-D int32 indices, bit for bit.
- :func:`cluster_gather_sum` (``ig_kernel``): ``Σ_i Σ_w table[idx[i], w]``
  as an f32 scalar, per-step partials over steps of ``step`` indices (the
  TPU kernel's TCB), then the partials in a fixed order, from a table held
  in the distributed shared memory of a thread-block cluster (8 CTAs ×
  128 KB for the harness's 1 MiB table). A table the cluster cannot hold,
  or a cluster the card cannot place, raises; it never falls back to
  ``gather_sum``.

Form F, the one-hot matmul gather named in the JAX file's docstring
(``:18``), has no code there, so there is nothing to port.

Each wrapper launches its kernel for CUDA tensors and runs its plain
version for CPU tensors; anything else raises. ``.launches`` counts
launches. :func:`probe_forms` runs A–E2 on the inputs ``main`` draws, in
its order, from ``np.random.default_rng(0)``; :func:`microbench` times the
library gather ``index_select(table, 0, idx).sum()``,
``kernel_gather.gather_sum`` (the table in L2) and
:func:`cluster_gather_sum` (the table on chip) at the harness's shape.
``python -m demuxalot_tpu_torch.experiments.gather_forms [--device cpu]``
prints both as JSON.
"""
from __future__ import annotations

import json

import numpy as np
import torch

from ..ops import _cuda
from ..ops.likelihood_kernel import _check
from ..utils.profiling import GatherRoofline
from .kernel_gather import gather_rows, time_ms

# the microbench's shape (exp_gather_forms.py:165, 180): a [8192, 32] f32 table (1 MiB), 4,194,304
# indices, 8,192 per step
RB, WB, NIDX = 8192, 32, 4_194_304
STEP = RB
# 4M gathered rows summed in f32 land within 1e-6 of float64
SUM_RTOL = 1e-6
# the forms' shapes (:62, 103, 128, 143)
R, W, C = 1024, 128, 256
R2, S, L, L2 = 8192, 256, 128, 512
FORMS = ("A", "B", "C", "D", "D2", "E", "E2")


def _device_of(name: str, table: torch.Tensor) -> torch.device:
    device = table.device
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name} runs on cpu or cuda tensors, not {device}")
    return device


def take_along_axis_plain(table: torch.Tensor, idx: torch.Tensor, axis: int) -> torch.Tensor:
    """Plain PyTorch version of the kernel, on any device."""
    if axis == 0:
        return table[idx.long(), torch.arange(idx.shape[1], device=idx.device)]
    return table[torch.arange(idx.shape[0], device=idx.device)[:, None], idx.long()]


def _launch_shapes(table, idx, axis):
    """(rows, cols, rows_out, cols_out) where :func:`take_along_axis` launches on these inputs as they are, else
    None: the full checks' accept set for CUDA tensors, read from cheap attributes (no device objects)."""
    if not (isinstance(table, torch.Tensor) and isinstance(idx, torch.Tensor) and table.is_cuda and idx.is_cuda
            and table.dtype is torch.float32 and idx.dtype is torch.int32 and table.get_device() == idx.get_device()
            and table.is_contiguous() and idx.is_contiguous()):
        return None
    try:
        (rows, cols), (rows_out, cols_out) = table.shape, idx.shape
    except ValueError:  # not 2-D
        return None
    if (axis == 0 and cols_out == cols) or (axis == 1 and rows_out == rows):
        return rows, cols, rows_out, cols_out
    return None


def take_along_axis(table: torch.Tensor, idx: torch.Tensor, axis: int) -> torch.Tensor:
    """``np.take_along_axis(table, idx, axis)`` for f32 [R, W] and i32 [C, W] (axis 0) or [R, M] (axis 1).

    The CUDA kernel for CUDA tensors, bit for bit. The dimension not taken
    along must match (no broadcasting).
    """
    shapes = _launch_shapes(table, idx, axis)
    if shapes is None:  # the full checks: they raise, or run the plain version on the CPU
        device = _device_of("take_along_axis", table)
        _check("table", table, torch.float32, 2, device)
        _check("idx", idx, torch.int32, 2, device)
        if axis not in (0, 1):
            raise ValueError(f"take_along_axis takes axis 0 or 1, not {axis}")
        if idx.shape[1 - axis] != table.shape[1 - axis]:
            raise ValueError(f"idx {tuple(idx.shape)} must match table {tuple(table.shape)} off axis {axis}")
        if device.type == "cpu":
            return take_along_axis_plain(table, idx, axis)
        shapes = (*table.shape, *idx.shape)
    out = torch.empty_like(idx, dtype=torch.float32)
    rows, cols, rows_out, cols_out = shapes
    _take_along_axis(table, table.data_ptr(), rows, cols, idx.data_ptr(), rows_out, cols_out, axis, out.data_ptr())
    take_along_axis.launches += 1
    return out


take_along_axis.launches = 0
_take_along_axis = _cuda.Entry("demux_take_along_axis")


def cluster_gather_sum_plain(table: torch.Tensor, idx: torch.Tensor, step: int = STEP) -> torch.Tensor:
    """Plain PyTorch version of the kernel, on any device: per-step sums, then their sum."""
    rows = table[idx.long()]
    return torch.stack([rows[lo: lo + step].sum() for lo in range(0, rows.shape[0], step)]).sum()


_CLUSTER_ERRORS = {
    -1: "the table does not fit the shared memory of a cluster of 8 CTAs",
    -2: "the card cannot place a cluster of 8 CTAs with the table's shared memory",
}


def cluster_gather_sum(table: torch.Tensor, idx: torch.Tensor, step: int = STEP) -> torch.Tensor:
    """``Σ table[idx]`` as an f32 scalar tensor (0-dim) from a table held on chip; the CUDA kernel for CUDA tensors."""
    device = _device_of("cluster_gather_sum", table)
    _check("table", table, torch.float32, 2, device)
    _check("idx", idx, torch.int32, 1, device)
    if step < 1 or idx.shape[0] < 1:
        raise ValueError("cluster_gather_sum needs step >= 1 and at least one index")
    if device.type == "cpu":
        return cluster_gather_sum_plain(table, idx, step)
    n_rows, width = table.shape
    partial = torch.empty(-(-idx.shape[0] // step) * 8, dtype=torch.float32, device=device)
    total = torch.empty((), dtype=torch.float32, device=device)
    with torch.cuda.device(device):
        status = _cuda.library().demux_cluster_gather_sum(
            table.data_ptr(), n_rows, width, idx.data_ptr(), idx.shape[0], step, partial.data_ptr(),
            total.data_ptr(), torch.cuda.current_stream(device).cuda_stream)
    if status in _CLUSTER_ERRORS:
        raise RuntimeError(f"cluster_gather_sum on [{n_rows}, {width}]: {_CLUSTER_ERRORS[status]}")
    _cuda.check_launch("cluster_gather_sum", status)
    cluster_gather_sum.launches += 1
    return total


cluster_gather_sum.launches = 0


def form_inputs(rng: np.random.Generator) -> dict:
    """The forms' inputs, drawn from ``rng`` in ``main``'s order (exp_gather_forms.py:59-155)."""
    table = rng.random((R, W), dtype=np.float32)
    idx1 = rng.integers(0, R, C).astype(np.int32)
    idx_r = rng.integers(0, R, R).astype(np.int32)
    table2 = rng.random((R2, W), dtype=np.float32)
    idx_r2 = rng.integers(0, R2, R2).astype(np.int32)
    table_l = rng.random((S, L), dtype=np.float32)
    idx_l = rng.integers(0, L, (S, L)).astype(np.int32)
    table_l2 = rng.random((S, L2), dtype=np.float32)
    idx_l2 = rng.integers(0, L2, (S, L2)).astype(np.int32)
    broadcast = lambda i: np.broadcast_to(i[:, None], (len(i), W)).copy()  # noqa: E731
    return {  # form: (table, indices, axis; None for jnp.take with 1-D indices)
        "A": (table, idx1, None), "B": (table, idx_r, None), "C": (table, broadcast(idx1), 0),
        "D": (table, broadcast(idx_r), 0), "D2": (table2, broadcast(idx_r2), 0),
        "E": (table_l, idx_l, 1), "E2": (table_l2, idx_l2, 1),
    }


def run_form(table: torch.Tensor, idx: torch.Tensor, axis) -> torch.Tensor:
    """One form: ``gather_rows`` for A and B (``axis`` None), :func:`take_along_axis` for the others."""
    return gather_rows(table, idx) if axis is None else take_along_axis(table, idx, axis)


def probe_forms(device="cuda", rng=None) -> dict:
    """{form: {shape, ok, output}} of A–E2 on ``main``'s inputs; ``ok``: bit-equal to numpy's gather."""
    device = torch.device(device)
    inputs = form_inputs(np.random.default_rng(0) if rng is None else rng)
    results = {}
    for form, (table, idx, axis) in inputs.items():
        out = run_form(torch.from_numpy(table).to(device), torch.from_numpy(idx).to(device), axis).cpu().numpy()
        want = table[idx] if axis is None else np.take_along_axis(table, idx, axis=axis)
        results[form] = {"table": list(table.shape), "idx": list(idx.shape), "axis": axis,
                         "ok": bool(np.array_equal(out, want)), "output": out}
    return results


def microbench_inputs(rng: np.random.Generator, device) -> tuple:
    """(table f32 [RB, WB], idx i32 [NIDX]) drawn from ``rng`` as ``main`` draws them after the forms (:166-167)."""
    table = rng.random((RB, WB), dtype=np.float32)
    idx = rng.integers(0, RB, NIDX).astype(np.int32)
    return torch.from_numpy(table).to(device), torch.from_numpy(idx).to(device)


def microbench(device="cuda", repeats: int = 10, n_idx: int = NIDX) -> dict:
    """ms and ns per row of the library gather-sum, ``gather_sum`` and :func:`cluster_gather_sum` at the harness's
    shape.

    The inputs are ``main``'s: ``np.random.default_rng(0)`` after the forms'
    draws (the first ``n_idx`` indices where that is smaller). Each sum is
    held to the float64 sum at SUM_RTOL. Times are CUDA events on a card and
    the host clock on the CPU, in turns.
    """
    from .kernel_gather import gather_sum

    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("microbench: no CUDA device")
    rng = np.random.default_rng(0)
    form_inputs(rng)
    table, idx = microbench_inputs(rng, device)
    idx = idx[:n_idx]
    exact = float(table.double()[idx.long()].sum())
    # the library gather: PyTorch's, where the TPU harness timed XLA's (jnp.sum(t[i]), :170-171)
    runs = {"library": lambda: torch.index_select(table, 0, idx).sum(),
            "gather_sum": lambda: gather_sum(table, idx, STEP),
            "cluster_gather_sum": lambda: cluster_gather_sum(table, idx, STEP)}
    result = {"table": list(table.shape), "n_idx": int(idx.shape[0]), "step": STEP, "device": str(device),
              "float64_sum": exact}
    for name, run in runs.items():
        total = float(run())
        if abs(total - exact) > SUM_RTOL * abs(exact):
            raise RuntimeError(f"{name}: {total} vs float64 {exact}")
        result[name] = {"sum": total, "rel_err": abs(total - exact) / abs(exact), "ms": []}
    for name in list(runs) + list(runs)[::-1]:
        result[name]["ms"].append(time_ms(runs[name], device, repeats))
    bound = GatherRoofline(n_idx=int(idx.shape[0]), n_rows_touched=int(torch.unique(idx).numel()), width=WB,
                           rows_out=False)
    for name in runs:
        mean = sum(result[name]["ms"]) / len(result[name]["ms"])
        result[name].update(ms_mean=mean, ns_per_row=mean * 1e6 / int(idx.shape[0]))
    result.update(bound_ms=bound.speed_of_light_s() * 1e3, bound_by=bound.bound_by())
    return result


def main(argv=None) -> int:
    import argparse

    parser = argparse.ArgumentParser(description="In-kernel gather forms and the on-chip table bench (gather_forms)")
    parser.add_argument("--device", default="cuda", help="cuda (default; raises without a card) or cpu")
    parser.add_argument("--n-idx", type=int, default=NIDX, help="the microbench's indices (the first n of main's)")
    parser.add_argument("--repeats", type=int, default=10)
    args = parser.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass --device cpu for the plain versions")
    forms = {form: {k: v for k, v in r.items() if k != "output"} for form, r in probe_forms(device).items()}
    print(json.dumps({"forms": forms, "microbench": microbench(device, args.repeats, args.n_idx)}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
