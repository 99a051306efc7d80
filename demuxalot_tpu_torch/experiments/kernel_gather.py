"""Row gather and gather-sum: the hand-written CUDA kernels, their plain versions and the rate runner.

The counterpart of ``benchmarks/exp_kernel_gather.py``, whose two TPU
kernels asked whether a row gather lowers inside a kernel and how fast it
runs there. Kernels: ``csrc/gather.cu``.

- :func:`gather_rows` (``_take_kernel``, ``exp_kernel_gather.py:39``):
  ``out[i, :] = table[idx[i], :]``, bit for bit.
- :func:`gather_sum` (``_bench_kernel``, ``:63``): ``Σ_i Σ_w
  table[idx[i], w]`` as an f32 scalar, per-step partials over contiguous
  steps of ``step`` indices (the TPU kernel's ``TC``), then the partials in
  step order. Where the TPU kernel holds the whole table in VMEM, the
  card's kernel takes one of two paths by :func:`gather_plan`: on chip,
  the table cut into S slices of whole rows, each in one block's shared
  memory, where that costs fewer index passes than a row has floats
  (S < W); otherwise its rows through L2. Either way each index is tested
  against the table inside the kernel (a trap past it), and the call is
  two launches: the sum and the in-order sum of its partials. The partials
  and the result are the wrapper's own buffers, one pair per (indices,
  step, index passes S or 1, card): the returned tensor is overwritten by
  the next call with the same key (clone it to keep it), and a CUDA graph
  can capture the call. ``.last_path`` says which path ran (``"chip"``,
  ``"l2"``, or ``"plain"`` on the CPU).

Each launches its kernel for CUDA tensors and runs its plain version for
CPU tensors; anything else raises. ``.launches`` counts launches.
:func:`run_rate` times both kernels on random tables that fit the H100's
50 MB L2 and one that does not; ``python -m
demuxalot_tpu_torch.experiments.kernel_gather [--device cpu]`` prints its
result as JSON.
"""
from __future__ import annotations

import ctypes
import functools
import json
import time
from typing import NamedTuple

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
# the on-chip gather-sum's block (csrc/gather.cu): warps, steps summed per batch, indices a warp reads at once,
# and the shared memory beside its slice (each warp's f32 sum per step of a batch, each warp's queue of 16-bit
# row offsets)
CHIP_WARPS, CHIP_BATCH, CHIP_CHUNK = 32, 32, 256
CHIP_EXTRA_BYTES = 4 * CHIP_BATCH * CHIP_WARPS + 2 * CHIP_WARPS * CHIP_CHUNK
H100_SMS = 132
H100_SHARED_OPTIN = 232_448  # the shared memory one H100 block may opt in to (227 KB)
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


class GatherPlan(NamedTuple):
    """How :func:`gather_sum`'s kernel runs on a table (:func:`gather_plan`)."""

    path: str  # "chip": each slice of the table in a block's shared memory; "l2": rows read through L2
    n_slices: int  # S: slices of whole rows, each within one block's shared memory
    rows_per_slice: int  # rows of every slice but the last, which may be short
    replicas: int  # R: blocks per slice on chip (S x R fill the SMs); 1 on L2
    n_steps: int
    shared_bytes: int  # one block's shared memory on chip; 0 on L2

    @property
    def n_partials(self) -> int:
        """Partials the kernel writes: one per (step, slice) on chip, one per step on L2."""
        return self.n_steps * (self.n_slices if self.path == "chip" else 1)

    @property
    def index_passes(self) -> int:
        """Times the kernel reads each index: once per slice on chip, once on L2."""
        return self.n_slices if self.path == "chip" else 1


def slice_rows(width: int, shared_per_block: int) -> int:
    """The most rows of ``width`` floats one block's slice holds beside the kernel's sums and queues."""
    return (shared_per_block - CHIP_EXTRA_BYTES) // 16 * 16 // (4 * width)


@functools.lru_cache(maxsize=64)
def gather_plan(n_rows: int, width: int, step: int, n_idx: int, shared_per_block: int,
                n_sms: int = H100_SMS) -> GatherPlan:
    """The slices, blocks and path of a gather-sum of ``n_idx`` indices in steps of ``step`` over a table
    [n_rows, width], on a card whose blocks may hold ``shared_per_block`` bytes of shared memory.

    The rule is a count of bytes per index: on chip, S index passes of 4
    bytes each; through L2, one row of 4·W bytes. So the table goes on chip
    when S < W. Its slices are balanced, ⌈n_rows / S⌉ rows each, the last
    short where S does not divide the rows.
    """
    n_steps = -(-n_idx // step)
    rows_fit = slice_rows(width, shared_per_block)
    if rows_fit < 1:
        return GatherPlan("l2", 0, 0, 1, n_steps, 0)
    n_slices = -(-n_rows // rows_fit)
    rows = -(-n_rows // n_slices)
    if n_slices >= width:
        return GatherPlan("l2", n_slices, rows, 1, n_steps, 0)
    replicas = max(1, min(n_sms // n_slices, n_steps))
    shared = -(-rows * width // 4) * 16 + CHIP_EXTRA_BYTES
    return GatherPlan("chip", n_slices, rows, replicas, n_steps, shared)


_LIMITS = {}  # card index: (shared memory a block may opt in to, SM count)
_BUFFERS = {}  # (n_idx, step, index passes, card index): gather_sum's (partial, total)


def _card_limits(index: int) -> tuple:
    if index not in _LIMITS:
        out = (ctypes.c_int32 * 2)()
        _cuda.check_launch("demux_card_limits", _cuda.library().demux_card_limits(out, index))
        _LIMITS[index] = (out[0], out[1])
    return _LIMITS[index]


def plan_for(table: torch.Tensor, idx: torch.Tensor, step: int = STEP) -> GatherPlan:
    """The plan :func:`gather_sum` runs on these CUDA tensors, with their card's shared memory and SMs."""
    return gather_plan(*table.shape, step, idx.shape[0], *_card_limits(table.get_device()))


def kept_buffers(cache: dict, key: tuple, floats: int, device: torch.device) -> tuple:
    """(scratch f32 [floats], total f32 0-dim) kept in ``cache`` under ``key``, made once; the oldest pair goes
    past 8."""
    buffers = cache.get(key)
    if buffers is None:
        if len(cache) >= 8:
            del cache[next(iter(cache))]
        buffers = cache[key] = (torch.empty(floats, dtype=torch.float32, device=device),
                                torch.empty((), dtype=torch.float32, device=device))
    return buffers


def gather_sum(table: torch.Tensor, idx: torch.Tensor, step: int = STEP) -> torch.Tensor:
    """``Σ table[idx]`` as an f32 scalar tensor (0-dim); the CUDA kernel for CUDA tensors, into the wrapper's
    own result buffer (see the module's docstring)."""
    _check_gather(table, idx)
    if step < 1 or idx.shape[0] < 1:
        raise ValueError("gather_sum needs step >= 1 and at least one index")
    device = table.device
    if device.type == "cpu":
        gather_sum.last_path = "plain"
        return gather_sum_plain(table, idx, step)
    if device.type != "cuda":
        raise ValueError(f"gather_sum runs on cpu or cuda tensors, not {device}")
    (n_rows, width), n_idx = table.shape, idx.shape[0]
    plan = plan_for(table, idx, step)
    partial, total = kept_buffers(_BUFFERS, (n_idx, step, plan.index_passes, device.index), plan.n_partials, device)
    chip = plan.path == "chip"
    _gather_sum(table, table.data_ptr(), n_rows, width, idx.data_ptr(), n_idx, step,
                plan.rows_per_slice if chip else 0, plan.n_slices if chip else 0, plan.replicas, partial.data_ptr(),
                total.data_ptr())
    gather_sum.launches += 1
    gather_sum.last_path = plan.path
    return total


gather_sum.launches = 0
gather_sum.last_path = None
_gather_sum = _cuda.Entry("demux_gather_sum")


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
                  "row_bytes": width * 4, "device": str(device), "sum": total, "float64_sum": exact,
                  "gather_sum_path": gather_sum.last_path}
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
