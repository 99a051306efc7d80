"""Strided column slices against contiguous rows: the stream kernels, their plain versions and the rate runner.

The counterpart of ``benchmarks/exp_dma_pattern.py``, whose two TPU kernels
stream the same bytes through on-chip memory in two patterns to see what
the M-step's donor-major DMA pattern costs. Kernel: ``csrc/stream.cu``.

- :func:`stream_cols` (``stream_cols``' kernel, ``exp_dma_pattern.py:32``):
  x f32 [D, N] in steps of [D, width] column slices, 32 runs of width·4
  bytes strided by N·4; returns ``Σ_{s < N // width} Σ x[:, s·width :
  s·width + 128]`` as an f32 scalar.
- :func:`stream_rows` (``stream_rows``' kernel, ``:71``): x f32 [N, D] in
  steps of [rows, D] contiguous blocks; returns ``Σ_{s < N // rows} Σ
  x[s·rows : s·rows + 8, :]``.

Both stream every byte of every whole step (the tail past the last whole
step is left unread, as on the TPU) and sum only each step's corner, per
step, then the per-step partials in a fixed order. Each launches its kernel
for CUDA tensors and runs its plain version for CPU tensors; anything else
raises. ``.launches`` counts launches. :func:`run_stream` times the TPU
harness's four widths and four row counts at its shape (570.4 MB) against
the streamed bytes' bound (:func:`stream_bound`; :func:`corner_bound` is the
bound of the scalar alone, which a stream misses by design); ``python -m
demuxalot_tpu_torch.experiments.dma_pattern [--device cpu]`` prints its
result as JSON.
"""
from __future__ import annotations

import json

import torch

from ..ops import _cuda
from ..ops.likelihood_kernel import _check
from ..utils.profiling import StreamRoofline
from .kernel_gather import time_ms

# the TPU harness's shape (exp_dma_pattern.py:23-24, 129, 135)
D = 32
N_SLOTS = 4_456_448
WIDTHS = (512, 2048, 8192, 32768)
ROWS = (512, 2048, 8192, 32768)
CORNER_COLS = 128  # buf[:, :, :128] (:53)
CORNER_ROWS = 8  # buf[:, :8, :] (:92)
# a stream reading fewer bytes than its bound allows has skipped some
MAX_SHARE_OF_BOUND = 1.05
# f32 sums of up to 8,704 steps x 4,096 corner elements land within 1e-6 of float64
SUM_RTOL = 1e-6


def _steps(n: int, step: int) -> int:
    if step < 1 or n // step < 1:
        raise ValueError(f"a step of {step} needs 1 <= step <= {n}")
    return n // step


def stream_cols_plain(x: torch.Tensor, width: int) -> torch.Tensor:
    """Plain PyTorch version of the kernel, on any device: per-step corner sums, then their sum."""
    n_steps = _steps(x.shape[1], width)
    steps = x.narrow(1, 0, n_steps * width).unflatten(1, (n_steps, width))
    return steps[:, :, :CORNER_COLS].sum(dim=(0, 2)).sum()


def stream_rows_plain(x: torch.Tensor, rows: int) -> torch.Tensor:
    """Plain PyTorch version of the kernel, on any device: per-step corner sums, then their sum."""
    n_steps = _steps(x.shape[0], rows)
    steps = x.narrow(0, 0, n_steps * rows).unflatten(0, (n_steps, rows))
    return steps[:, :CORNER_ROWS, :].sum(dim=(1, 2)).sum()


def _launch(name: str, x: torch.Tensor, ld: int, step_offset: int, n_steps: int, h: int, w: int, ch: int,
            cw: int) -> torch.Tensor:
    device = x.device
    partial = torch.empty(n_steps * h, dtype=torch.float32, device=device)
    total = torch.empty((), dtype=torch.float32, device=device)
    with torch.cuda.device(device):
        status = _cuda.library().demux_stream_sum(
            x.data_ptr(), ld, step_offset, n_steps, h, w, ch, cw, partial.data_ptr(), total.data_ptr(),
            torch.cuda.current_stream(device).cuda_stream)
    _cuda.check_launch(name, status)
    return total


def _check_stream(name: str, x: torch.Tensor) -> None:
    _check("x", x, torch.float32, 2, x.device)
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name} runs on cpu or cuda tensors, not {x.device}")


def stream_cols(x: torch.Tensor, width: int) -> torch.Tensor:
    """The column-slice stream of x f32 [D, N] as an f32 scalar tensor (0-dim); the CUDA kernel for CUDA tensors."""
    _check_stream("stream_cols", x)
    n_steps = _steps(x.shape[1], width)
    if x.device.type == "cpu":
        return stream_cols_plain(x, width)
    d, n = x.shape
    if width >= 2 ** 31 or d >= 2 ** 31:
        raise ValueError("stream_cols needs D and width below 2^31")
    total = _launch("stream_cols", x, n, width, n_steps, d, width, d, min(CORNER_COLS, width))
    stream_cols.launches += 1
    return total


stream_cols.launches = 0


def stream_rows(x: torch.Tensor, rows: int) -> torch.Tensor:
    """The row-block stream of x f32 [N, D] as an f32 scalar tensor (0-dim); the CUDA kernel for CUDA tensors."""
    _check_stream("stream_rows", x)
    n_steps = _steps(x.shape[0], rows)
    if x.device.type == "cpu":
        return stream_rows_plain(x, rows)
    d = x.shape[1]
    # one step is one contiguous run of rows * D floats, its corner the first 8 rows
    if rows * d >= 2 ** 31 or CORNER_ROWS * d > 8192:
        raise ValueError("stream_rows needs rows * D below 2^31 and D <= 1024")
    total = _launch("stream_rows", x, rows * d, rows * d, n_steps, 1, rows * d, 1, min(CORNER_ROWS, rows) * d)
    stream_rows.launches += 1
    return total


stream_rows.launches = 0


def _corner(x: torch.Tensor, step: int, cols: bool) -> tuple:
    """(steps, floats in a step, floats in its corner) of one stream of ``x``."""
    d = x.shape[0] if cols else x.shape[1]
    n_steps = _steps(x.shape[1] if cols else x.shape[0], step)
    return n_steps, step * d, d * (min(CORNER_COLS, step) if cols else min(CORNER_ROWS, step))


def stream_bound(x: torch.Tensor, step: int, cols: bool) -> StreamRoofline:
    """The least time to stream every whole step, what the kernel exists to measure: the steps' bytes read."""
    n_steps, per_step, corner = _corner(x, step, cols)
    return StreamRoofline(bytes_read=4 * n_steps * per_step, bytes_written=4, n_operations=n_steps * corner)


def corner_bound(x: torch.Tensor, step: int, cols: bool) -> StreamRoofline:
    """The least time for the function's scalar alone: the corners' bytes read, one f32 written, their adds.

    A stream is slower than this by design: it reads every byte of each
    step, where the scalar needs only the corners.
    """
    n_steps, _per_step, corner = _corner(x, step, cols)
    return StreamRoofline(bytes_read=4 * n_steps * corner, bytes_written=4, n_operations=n_steps * corner)


def stream_inputs(n_slots: int = N_SLOTS, d: int = D, seed: int = 0, device="cuda", cols: bool = True):
    """x f32 [d, n_slots] (``cols``) or [n_slots, d], uniform in [0, 1), made on ``device`` from ``seed``."""
    device = torch.device(device)
    generator = torch.Generator(device=device).manual_seed(seed)
    return torch.rand((d, n_slots) if cols else (n_slots, d), generator=generator, device=device)


def run_stream(device="cuda", n_slots: int = N_SLOTS, widths=WIDTHS, rows=ROWS, seed: int = 0,
               repeats: int = 10) -> list:
    """Per layout and step: ms, GB/s, the streamed bytes' bound and the share of it, the sum against float64.

    ``corner_bound_ms`` beside them is the bound of the scalar alone
    (:func:`corner_bound`).

    The kernels run on ``device`` (the plain versions on the CPU); times are
    CUDA events on a card and the host clock on the CPU. Raises if a sum
    misses float64 by more than SUM_RTOL, or, on a card, if a stream reads
    faster than MAX_SHARE_OF_BOUND of its bytes' bound (bytes were skipped).
    """
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("run_stream: no CUDA device")
    results = []
    for cols, steps, fn in ((True, widths, stream_cols), (False, rows, stream_rows)):
        x = stream_inputs(n_slots, D, seed, device, cols)
        for step in steps:
            total = float(fn(x, step))
            exact = float((stream_cols_plain if cols else stream_rows_plain)(x.double(), step))
            if abs(total - exact) > SUM_RTOL * abs(exact):
                raise RuntimeError(f"{fn.__name__}({step}): {total} vs float64 {exact}")
            bound, corner = stream_bound(x, step, cols), corner_bound(x, step, cols)
            ms = [time_ms(lambda: fn(x, step), device, repeats) for _ in range(2)]
            mean = sum(ms) / len(ms)
            share = bound.speed_of_light_s() * 1e3 / mean
            if device.type == "cuda" and share > MAX_SHARE_OF_BOUND:
                raise RuntimeError(f"{fn.__name__}({step}) ran at {share:.3f} of its bytes' bound: bytes were skipped")
            results.append({
                "layout": "cols" if cols else "rows", "shape": list(x.shape),
                "width" if cols else "rows": step, "run_bytes": 4 * (step if cols else step * D),
                "bytes": bound.bytes_read, "device": str(device), "sum": total, "float64_sum": exact,
                "ms": ms, "ms_mean": mean, "gb_per_s": bound.bytes_read / mean / 1e6,
                "stream_bound_ms": bound.speed_of_light_s() * 1e3, "bound_by": bound.bound_by(),
                "stream_share_of_bound": share, "corner_bound_ms": corner.speed_of_light_s() * 1e3})
        del x
    return results


def main(argv=None) -> int:
    import argparse

    parser = argparse.ArgumentParser(description="Strided column slices against contiguous rows (dma_pattern)")
    parser.add_argument("--device", default="cuda", help="cuda (default; raises without a card) or cpu")
    parser.add_argument("--n-slots", type=int, default=N_SLOTS)
    parser.add_argument("--widths", default=",".join(map(str, WIDTHS)), help="comma-separated column widths")
    parser.add_argument("--rows", default=",".join(map(str, ROWS)), help="comma-separated row counts")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--repeats", type=int, default=10)
    args = parser.parse_args(argv)
    parse = lambda spec: tuple(int(v) for v in spec.split(","))  # noqa: E731
    print(json.dumps(run_stream(args.device, args.n_slots, parse(args.widths), parse(args.rows), args.seed,
                                args.repeats)), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
