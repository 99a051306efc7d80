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
raises. ``.launches`` counts launches. The kernel has two routes, which
:func:`stream_plan` picks before the launch from what Hopper's copy engine
can address: TMA box loads into an mbarrier ring fed by one producer thread
(the harness's shape at every step), or cp.async copies by every thread
(ragged shapes: D = 7, N not a multiple of 4, x off a 16-byte boundary);
``.last_plan`` is the plan of the last launch. :func:`run_stream` times the
TPU harness's four widths and four row counts at its shape (570.4 MB),
each in turns with ``torch.sum`` over the streamed bytes, against the
streamed bytes' bound (:func:`stream_bound`; :func:`corner_bound` is the
bound of the scalar alone, which a stream misses by design); ``python -m
demuxalot_tpu_torch.experiments.dma_pattern [--device cpu]`` prints its
result as JSON.
"""
from __future__ import annotations

import json
from typing import NamedTuple, Optional

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


class StreamPlan(NamedTuple):
    """How a stream launches (:func:`stream_plan`): its route and the boxes or pieces a step is cut into."""

    route: str  # "tma" (boxes through a tensor map) or "cp.async"
    reason: Optional[str]  # why TMA cannot address x (the cp.async route), else None
    n_steps: int
    box: tuple  # (rows, columns) of x in a TMA box, or of a cp.async piece
    boxes_per_step: int
    box_bytes: int
    stages: int  # ring stages in shared memory
    corner_boxes: int  # boxes (pieces) of a step that hold some of its corner, one partial each


# the TMA route: a box is at most 32 KB (a ring stage) and 256 floats a side (TMA's limit); 6 stages of 32 KB
TMA_BOX_FLOATS = 8192
TMA_MAX_BOX_SIDE = 256
TMA_STAGES = 6
# the cp.async route (csrc/stream.cu's kPieceFloats, kStages)
PIECE_FLOATS = 8192
CP_ASYNC_STAGES = 3
_ROUTES = {"cp.async": 0, "tma": 1}


def _tma_box(step: int, cross: int, cols: bool) -> Optional[int]:
    """The widest box side along the steps that divides ``step``: at most 256 floats, at most 32 KB with ``cross``
    floats across, a multiple of 4 floats (16 bytes) where it is the box's inner extent (cols). None if none."""
    for box in range(min(TMA_MAX_BOX_SIDE, TMA_BOX_FLOATS // cross, step), 0, -1):
        if step % box == 0 and (not cols or box % 4 == 0):
            return box
    return None


def _tma_refusal(x: torch.Tensor, step: int, cols: bool) -> Optional[str]:
    """Why a tensor map cannot address ``x``'s steps, or None where it can."""
    n_rows, n_cols = x.shape
    cross = n_rows if cols else n_cols
    if x.data_ptr() % 16:
        return "x does not start on a 16-byte boundary"
    if n_cols % 4:
        return f"rows of {n_cols} floats are not a multiple of 16 bytes"
    if cross > TMA_MAX_BOX_SIDE:
        return f"D = {cross} is past a box's {TMA_MAX_BOX_SIDE} floats"
    if _tma_box(step, cross, cols) is None:
        return f"no box of at most {TMA_MAX_BOX_SIDE} columns, a multiple of 4, divides a step of {step}"
    if (n_cols if cols else n_rows) >= 2 ** 31:
        return "a box coordinate past 2^31"
    return None


def stream_plan(x: torch.Tensor, step: int, cols: bool) -> StreamPlan:
    """The route a stream of ``x`` (f32 [D, N] for ``cols``, else [N, D]) in steps of ``step`` takes, decided
    before the launch from what TMA can address.

    TMA where x starts on a 16-byte boundary, its rows are a multiple of 16
    bytes (N % 4 == 0 for cols, D % 4 == 0 for rows), D <= 256 and a box of
    at most 256 floats a side (its inner extent a multiple of 16 bytes, at
    most 32 KB) divides the step: cols' boxes are [D, box] column slices,
    rows' [box, D] row blocks, in a ring of TMA_STAGES. Else the cp.async
    route, pieces of at most 8,192 floats in a ring of 3, with the reason.
    The C entry checks the same rules again and refuses a route the tensor
    cannot take; nothing retries another route.
    """
    n_rows, n_cols = x.shape
    cross = n_rows if cols else n_cols
    n_steps = _steps(n_cols if cols else n_rows, step)
    corner = min(CORNER_COLS, step) if cols else min(CORNER_ROWS, step)
    reason = _tma_refusal(x, step, cols)
    if reason is None:
        box = _tma_box(step, cross, cols)
        shape = (n_rows, box) if cols else (box, n_cols)
        return StreamPlan("tma", None, n_steps, shape, step // box, 4 * box * cross, TMA_STAGES, -(-corner // box))
    # cp.async: a step is [h, w] (cols: [D, width]; rows: one run of rows * D), pieces of whole runs of at most
    # 8,192 floats, as many rows as fit; the corner lies in the first piece of each row chunk
    h, w = (n_rows, step) if cols else (1, step * n_cols)
    pw = min(w, PIECE_FLOATS)
    ph = min(PIECE_FLOATS // pw, h)
    row_chunks = -(-h // ph)
    return StreamPlan("cp.async", reason, n_steps, (ph, pw), row_chunks * -(-w // pw), 4 * ph * pw, CP_ASYNC_STAGES,
                      row_chunks)


_stream_sum = _cuda.Entry("demux_stream_sum")


def _launch(x: torch.Tensor, step: int, cols: bool, plan: StreamPlan) -> torch.Tensor:
    n_partials = plan.n_steps * plan.corner_boxes  # one for each corner-holding box or piece of every step
    partial = torch.empty(n_partials, dtype=torch.float32, device=x.device)
    total = torch.empty((), dtype=torch.float32, device=x.device)
    corner = min(CORNER_COLS, step) if cols else min(CORNER_ROWS, step)
    box = plan.box[1] if cols else plan.box[0]
    _stream_sum(x, x.data_ptr(), x.shape[0], x.shape[1], int(cols), step, corner, _ROUTES[plan.route],
                box if plan.route == "tma" else 0, plan.stages, partial.data_ptr(), n_partials, total.data_ptr())
    return total


def _check_stream(name: str, x: torch.Tensor) -> None:
    _check("x", x, torch.float32, 2, x.device)
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name} runs on cpu or cuda tensors, not {x.device}")


def stream_cols(x: torch.Tensor, width: int) -> torch.Tensor:
    """The column-slice stream of x f32 [D, N] as an f32 scalar tensor (0-dim); the CUDA kernel for CUDA tensors.

    ``stream_cols.last_plan`` is the :class:`StreamPlan` of the last launch."""
    _check_stream("stream_cols", x)
    _steps(x.shape[1], width)
    if x.device.type == "cpu":
        return stream_cols_plain(x, width)
    if width >= 2 ** 31 or x.shape[0] >= 2 ** 31:
        raise ValueError("stream_cols needs D and width below 2^31")
    plan = stream_plan(x, width, cols=True)
    total = _launch(x, width, True, plan)
    stream_cols.last_plan = plan
    stream_cols.launches += 1
    return total


stream_cols.launches = 0
stream_cols.last_plan = None


def stream_rows(x: torch.Tensor, rows: int) -> torch.Tensor:
    """The row-block stream of x f32 [N, D] as an f32 scalar tensor (0-dim); the CUDA kernel for CUDA tensors.

    ``stream_rows.last_plan`` is the :class:`StreamPlan` of the last launch."""
    _check_stream("stream_rows", x)
    _steps(x.shape[0], rows)
    if x.device.type == "cpu":
        return stream_rows_plain(x, rows)
    # the cp.async route takes one step as one contiguous run of rows * D floats, its corner the first 8 rows
    if rows * x.shape[1] >= 2 ** 31 or CORNER_ROWS * x.shape[1] > PIECE_FLOATS:
        raise ValueError("stream_rows needs rows * D below 2^31 and D <= 1024")
    plan = stream_plan(x, rows, cols=False)
    total = _launch(x, rows, False, plan)
    stream_rows.last_plan = plan
    stream_rows.launches += 1
    return total


stream_rows.launches = 0
stream_rows.last_plan = None


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
    """Per layout and step: the plan, ms, GB/s, the streamed bytes' bound and the share of it, ``torch.sum`` over
    the streamed bytes, the sum against float64.

    Each step's route and ring come from :func:`stream_plan` (on the CPU,
    the route a card would take; ``ran`` says what ran). ``ms`` and
    ``library_ms`` (``torch.sum`` over the streamed bytes) are timed in
    turns: kernel, library, library, kernel. ``corner_bound_ms`` beside them
    is the bound of the scalar alone (:func:`corner_bound`).

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
            plan = stream_plan(x, step, cols)
            n_steps = (x.shape[1] if cols else x.shape[0]) // step
            streamed = x.narrow(1 if cols else 0, 0, n_steps * step)
            timed = {"kernel": [], "library": []}
            for which in ("kernel", "library", "library", "kernel"):
                run = (lambda: fn(x, step)) if which == "kernel" else (lambda: torch.sum(streamed))  # noqa: E731
                timed[which].append(time_ms(run, device, repeats))
            ms = timed["kernel"]
            mean = sum(ms) / len(ms)
            share = bound.speed_of_light_s() * 1e3 / mean
            if device.type == "cuda" and share > MAX_SHARE_OF_BOUND:
                raise RuntimeError(f"{fn.__name__}({step}) ran at {share:.3f} of its bytes' bound: bytes were skipped")
            results.append({
                "layout": "cols" if cols else "rows", "shape": list(x.shape),
                "width" if cols else "rows": step, "run_bytes": 4 * (step if cols else step * D),
                "bytes": bound.bytes_read, "device": str(device), "ran": "kernel" if device.type == "cuda" else "plain",
                "route": plan.route, "tma_refusal": plan.reason, "stages": plan.stages, "box": list(plan.box),
                "boxes_per_step": plan.boxes_per_step, "box_bytes": plan.box_bytes, "sum": total,
                "float64_sum": exact, "ms": ms, "ms_mean": mean, "gb_per_s": bound.bytes_read / mean / 1e6,
                "library_ms": timed["library"], "library_ms_mean": sum(timed["library"]) / 2,
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
