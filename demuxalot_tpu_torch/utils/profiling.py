"""Profiling helpers: device traces and kernel speed-of-light bounds on an H100.

The counterpart of ``demuxalot_tpu.utils.profiling``: :func:`device_trace`
records a ``torch.profiler`` trace, and :class:`Roofline` (E-step),
:class:`MStepRoofline`, :class:`GatherRoofline` (``experiments.
kernel_gather``, ``gather_forms``) and :class:`StreamRoofline`
(``experiments.dma_pattern``, ``gather_operand``'s tiny kernel) give the least time one NVIDIA H100 could take for a
kernel's work, the larger of its bytes over the HBM rate and its FP32
operations over the FP32 rate. Bytes count each input read once and each
output written once, whatever the kernel reads again; operations count
what these inputs need. The default rates are the published peaks of the
H100 SXM at its 700 W limit (3.35 TB/s of HBM, 67 TFLOP/s in FP32 outside
the tensor cores); a card set below 700 W runs slower.
"""
from __future__ import annotations

import os
from contextlib import contextmanager
from dataclasses import dataclass

H100_HBM_BYTES_PER_S = 3.35e12
H100_FP32_FLOPS_PER_S = 67e12


@contextmanager
def device_trace(log_dir: str):
    """Record a ``torch.profiler`` trace (CPU, and CUDA where a card exists).

    Yields the profiler, so ``key_averages()`` can be read after the block;
    on exit the trace is written to ``log_dir/trace.json`` (Chrome trace
    format: chrome://tracing or Perfetto). Example::

        with device_trace("traces/predict") as prof:
            Demultiplexer.predict_posteriors(...)
        print(prof.key_averages().table(sort_by="cuda_time_total"))
    """
    import torch

    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


class _Bound:
    """Speed of light from ``bytes_moved()`` and ``operations()``."""

    hbm_bytes_per_s: float
    f32_flops_per_s: float

    def bytes_moved(self) -> int:
        raise NotImplementedError

    def operations(self) -> int:
        raise NotImplementedError

    def estimate_seconds(self) -> dict:
        return {
            "hbm_bound_s": self.bytes_moved() / self.hbm_bytes_per_s,
            "fp32_bound_s": self.operations() / self.f32_flops_per_s,
        }

    def speed_of_light_s(self) -> float:
        return max(self.estimate_seconds().values())

    def bound_by(self) -> str:
        """"bytes" or "operations": which of the two sets the bound."""
        bounds = self.estimate_seconds()
        return "bytes" if bounds["hbm_bound_s"] >= bounds["fp32_bound_s"] else "operations"


@dataclass
class Roofline(_Bound):
    """Speed of light of the E-step likelihood kernel (``csrc/likelihood.cu``).

    Bytes: every call's variant id and ``q`` (4 + 4), the barcode row
    pointers (8 per barcode), the genotype table (4·V·D), the column
    schedule and penalties (counted as 12 per column) and the logits
    written once (4·B·PG). Operations per call: per pseudogenotype the mean
    of two donor terms (add, multiply), the running product (multiply) and
    a share of the log and the sum (counted as one); per donor the term
    ``G·(1−q) + max(q, 1e-4)`` (multiply, add, max).

    ``softmax``: the fused row softmax also writes the probs (4·B·PG bytes)
    and per (barcode, column) takes the max, the difference, the exponential,
    the sum and the division (5 operations). ``prior``: the prior logits are
    read (4·B·PG bytes) and added (1 operation per (barcode, column)).
    """

    n_calls: int
    n_donors: int
    n_pseudogenotypes: int
    n_barcodes: int = 0
    n_variants: int = 0
    softmax: bool = False
    prior: bool = False
    hbm_bytes_per_s: float = H100_HBM_BYTES_PER_S
    f32_flops_per_s: float = H100_FP32_FLOPS_PER_S

    def bytes_moved(self) -> int:
        n, d, pg, b, v = self.n_calls, self.n_donors, self.n_pseudogenotypes, self.n_barcodes, self.n_variants
        rows = 1 + self.softmax + self.prior  # [B, PG] arrays: logits, probs, prior
        return 8 * n + 8 * (b + 1) + 4 * v * d + 12 * pg + 4 * b * pg * rows

    def operations(self) -> int:
        per_cell = 5 * self.softmax + self.prior  # per (barcode, column)
        pg = self.n_pseudogenotypes
        return self.n_calls * (4 * pg + 3 * self.n_donors) + per_cell * self.n_barcodes * pg


@dataclass
class MStepRoofline(_Bound):
    """Speed of light of the M-step kernel (``csrc/mstep.cu``).

    Bytes: every call's barcode and ``q`` (4 + 4), the variant row pointers
    (8 per variant), the singlet posterior columns it reads (4·B·D) and
    the additions written once (4·V·D). Operations per (call, donor):
    ``post·(1−q)`` (multiply), the power (one multiply at power 2) and the
    sum (add).
    """

    n_calls: int
    n_donors: int
    n_barcodes: int
    n_variants: int
    hbm_bytes_per_s: float = H100_HBM_BYTES_PER_S
    f32_flops_per_s: float = H100_FP32_FLOPS_PER_S

    def bytes_moved(self) -> int:
        n, d, b, v = self.n_calls, self.n_donors, self.n_barcodes, self.n_variants
        return 8 * n + 8 * (v + 1) + 4 * b * d + 4 * v * d

    def operations(self) -> int:
        return 3 * self.n_calls * self.n_donors


@dataclass
class GatherRoofline(_Bound):
    """Speed of light of a row gather (``rows_out``) or a gather-sum (``csrc/gather.cu``).

    Bytes: the indices (4 per index), the table rows they touch (4·W per
    distinct row; each input byte counts once, however often it is
    gathered) and the output, the gathered rows (4·N·W) or one f32.
    Operations: none for the gather, one add per gathered element for the
    sum.
    """

    n_idx: int
    n_rows_touched: int
    width: int
    rows_out: bool
    hbm_bytes_per_s: float = H100_HBM_BYTES_PER_S
    f32_flops_per_s: float = H100_FP32_FLOPS_PER_S

    def bytes_moved(self) -> int:
        out = 4 * self.n_idx * self.width if self.rows_out else 4
        return 4 * self.n_idx + 4 * self.n_rows_touched * self.width + out

    def operations(self) -> int:
        return 0 if self.rows_out else self.n_idx * self.width


@dataclass
class StreamRoofline(_Bound):
    """Speed of light of a kernel that streams bytes and does little with them (``csrc/stream.cu``, ``tiny.cu``).

    Bytes: ``bytes_read`` (each input byte the function must read, once) and
    ``bytes_written``. Operations: ``n_operations`` (the streams add their
    corners' elements; the tiny kernel multiplies each element).
    """

    bytes_read: int
    bytes_written: int
    n_operations: int = 0
    hbm_bytes_per_s: float = H100_HBM_BYTES_PER_S
    f32_flops_per_s: float = H100_FP32_FLOPS_PER_S

    def bytes_moved(self) -> int:
        return self.bytes_read + self.bytes_written

    def operations(self) -> int:
        return self.n_operations
