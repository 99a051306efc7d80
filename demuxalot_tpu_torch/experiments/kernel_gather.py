"""Row gather and gather-sum: the hand-written CUDA kernels, their plain versions and the rate runner.

The counterpart of ``benchmarks/exp_kernel_gather.py``, whose two TPU
kernels asked whether a row gather lowers inside a kernel and how fast it
runs there. Kernels: ``csrc/gather.cu``.

- :func:`gather_rows` (``_take_kernel``, ``exp_kernel_gather.py:39``):
  ``out[i, :] = table[idx[i], :]``, bit for bit.
- :func:`gather_sum` (``_bench_kernel``, ``:63``): ``Σ_i Σ_w
  table[idx[i], w]`` as an f32 scalar, per-step partials over contiguous
  steps of ``step`` indices (the TPU kernel's ``TC``), then the partials in
  step order.

Each launches its kernel for CUDA tensors and runs its plain version for
CPU tensors; anything else raises. ``.launches`` counts launches.
:func:`run_rate` times both kernels on random tables that fit the H100's
50 MB L2 and one that does not; ``python -m
demuxalot_tpu_torch.experiments.kernel_gather [--device cpu]`` prints its
result as JSON.
"""
from __future__ import annotations

import json
import time

import torch

from ..ops import _cuda
from ..ops.likelihood_kernel import _check

# the TPU bench's shape (exp_kernel_gather.py:33-36): a 2 MB table, 256 steps of 4,096 indices
N_ROWS, WIDTH = 8192, 64
STEP = 4096
N_STEPS = 256
N_IDX = STEP * N_STEPS
# the rate runner's tables: the TPU file's; the bench shape's genotype table
# (131,072 variants x 32 donors, 16.8 MB, inside L2); the PMBC shape's
# (800,000 x 32, 102.4 MB, past L2)
RATE_TABLES = ((N_ROWS, WIDTH), (131_072, 32), (800_000, 32))
# 1M gathered rows summed in f32 land within 2.1e-7 of float64 (H100);
# one row of N dropped or added moves the sum by about 1/N, 9.5e-7 at N = 2^20
SUM_RTOL = 5e-7


def _check_gather(table: torch.Tensor, idx: torch.Tensor) -> None:
    _check("table", table, torch.float32, 2, table.device)
    _check("idx", idx, torch.int32, 1, table.device)


def gather_rows_plain(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the kernel, on any device."""
    return table[idx.long()]


def gather_rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``table[idx]``: f32 [N, W] from table f32 [R, W] and idx i32 [N]; the CUDA kernel for CUDA tensors."""
    _check_gather(table, idx)
    device = table.device
    if device.type == "cpu":
        return gather_rows_plain(table, idx)
    if device.type != "cuda":
        raise ValueError(f"gather_rows runs on cpu or cuda tensors, not {device}")
    n_rows, width = table.shape
    out = torch.empty((idx.shape[0], width), dtype=torch.float32, device=device)
    with torch.cuda.device(device):
        status = _cuda.library().demux_gather_rows(
            table.data_ptr(), n_rows, width, idx.data_ptr(), idx.shape[0], out.data_ptr(),
            torch.cuda.current_stream(device).cuda_stream)
    _cuda.check_launch("gather_rows", status)
    gather_rows.launches += 1
    return out


gather_rows.launches = 0


def gather_sum_plain(table: torch.Tensor, idx: torch.Tensor, step: int = STEP) -> torch.Tensor:
    """Plain PyTorch version of the kernel, on any device: per-step sums, then their sum."""
    rows = table[idx.long()]
    return torch.stack([rows[lo: lo + step].sum() for lo in range(0, rows.shape[0], step)]).sum()


def gather_sum(table: torch.Tensor, idx: torch.Tensor, step: int = STEP) -> torch.Tensor:
    """``Σ table[idx]`` as an f32 scalar tensor (0-dim); the CUDA kernel for CUDA tensors."""
    _check_gather(table, idx)
    if step < 1 or idx.shape[0] < 1:
        raise ValueError("gather_sum needs step >= 1 and at least one index")
    device = table.device
    if device.type == "cpu":
        return gather_sum_plain(table, idx, step)
    if device.type != "cuda":
        raise ValueError(f"gather_sum runs on cpu or cuda tensors, not {device}")
    n_rows, width = table.shape
    partial = torch.empty(-(-idx.shape[0] // step), dtype=torch.float32, device=device)
    total = torch.empty((), dtype=torch.float32, device=device)
    with torch.cuda.device(device):
        status = _cuda.library().demux_gather_sum(
            table.data_ptr(), n_rows, width, idx.data_ptr(), idx.shape[0], step, partial.data_ptr(),
            total.data_ptr(), torch.cuda.current_stream(device).cuda_stream)
    _cuda.check_launch("gather_sum", status)
    gather_sum.launches += 1
    return total


gather_sum.launches = 0


def time_ms(fn, device: torch.device, repeats: int = 10) -> float:
    """Mean ms of ``fn()`` after two warm-up calls: CUDA events on a card, the host clock on the CPU."""
    fn()
    fn()
    if device.type == "cuda":
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(repeats):
            fn()
        end.record()
        torch.cuda.synchronize(device)
        return start.elapsed_time(end) / repeats
    t0 = time.perf_counter()
    for _ in range(repeats):
        fn()
    return (time.perf_counter() - t0) * 1e3 / repeats


def rate_inputs(n_rows: int, width: int, n_idx: int = N_IDX, seed: int = 0, device="cuda"):
    """(table f32 [n_rows, width] uniform in [0, 1), idx i32 [n_idx] uniform), made on ``device`` from ``seed``."""
    device = torch.device(device)
    generator = torch.Generator(device=device).manual_seed(seed)
    table = torch.rand((n_rows, width), generator=generator, device=device)
    idx = torch.randint(0, n_rows, (n_idx,), generator=generator, device=device).to(torch.int32)
    return table, idx


def run_rate(device="cuda", tables=RATE_TABLES, n_idx: int = N_IDX, seed: int = 0, repeats: int = 20) -> list:
    """Per table: both kernels' ms and ns per row, the gathered bytes, and their checks against each other.

    The kernels run on ``device`` (the plain versions on the CPU); times are
    CUDA events on a card and the host clock on the CPU. ``gather_sum`` is
    held to the float64 sum of ``gather_rows``' rows at SUM_RTOL.
    """
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("run_rate: no CUDA device")
    results = []
    for n_rows, width in tables:
        table, idx = rate_inputs(n_rows, width, n_idx, seed, device)
        rows = gather_rows(table, idx)
        total = float(gather_sum(table, idx))
        exact = float(rows.double().sum())
        if abs(total - exact) > SUM_RTOL * abs(exact):
            raise RuntimeError(f"gather_sum {total} vs float64 sum of gather_rows {exact} on [{n_rows}, {width}]")
        samples = {"gather_rows": [], "gather_sum": []}
        for name in ("gather_rows", "gather_sum", "gather_sum", "gather_rows"):
            fn = (lambda: gather_rows(table, idx)) if name == "gather_rows" else (lambda: gather_sum(table, idx))
            samples[name].append(time_ms(fn, device, repeats))
        result = {"table": [n_rows, width], "table_bytes": n_rows * width * 4, "n_idx": n_idx,
                  "row_bytes": width * 4, "device": str(device), "sum": total, "float64_sum": exact}
        for name, ms in samples.items():
            mean = sum(ms) / len(ms)
            result[name] = {"ms": ms, "ms_mean": mean, "ns_per_row": mean * 1e6 / n_idx}
        results.append(result)
    return results


def main(argv=None) -> int:
    import argparse

    parser = argparse.ArgumentParser(description="Row gather and gather-sum rates (kernel_gather)")
    parser.add_argument("--device", default="cuda", help="cuda (default; raises without a card) or cpu")
    parser.add_argument("--n-idx", type=int, default=N_IDX)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--repeats", type=int, default=20)
    parser.add_argument("--tables", default=",".join(f"{r}x{w}" for r, w in RATE_TABLES),
                        help="comma-separated ROWSxWIDTH tables")
    args = parser.parse_args(argv)
    tables = [tuple(int(x) for x in spec.split("x")) for spec in args.tables.split(",")]
    print(json.dumps(run_rate(args.device, tables, args.n_idx, args.seed, args.repeats)), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
