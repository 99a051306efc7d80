"""Profiling helpers: device traces and kernel speed-of-light bounds on an H100.

The counterpart of ``demuxalot_tpu.utils.profiling``: :func:`device_trace`
records a ``torch.profiler`` trace, and :class:`Roofline` (E-step),
:class:`MStepRoofline`, :class:`GatherRoofline` (``experiments.
kernel_gather``, ``gather_forms``) and :class:`StreamRoofline`
(``experiments.dma_pattern``, ``gather_operand``'s tiny kernel) give the least time one NVIDIA H100 could take for a
kernel's work, the larger of its bytes over the HBM rate and its FP32
operations over the FP32 rate; :class:`VariantRoofline` (the E-step
variants, ``experiments.folded_estep``, ``split_estep``, ``group_estep``)
adds their logs over the MUFU rate and split's dense bf16 products over
the tensor cores' rate; :class:`AggregateRoofline` (the aggregate-on-SNPs
E-step, ``csrc/aggregate.cu``) takes its MUFU operations over that rate in
place of FP32 operations. Bytes count each input read once and each output
written once, whatever the kernel reads again; operations count what these
inputs need. The default rates are the published peaks of the H100 SXM at
its 700 W limit (3.35 TB/s of HBM and 67 TFLOP/s in FP32 outside the
tensor cores, 989 TFLOP/s dense bf16 on them: NVIDIA's H100 data sheet;
16 MUFU log2 results a clock per SM: the CUDA C++ Programming Guide's
throughput table for compute capability 9.0, at the data sheet's 132 SMs
and 1,980 MHz boost clock); a card set below 700 W runs slower.
"""
from __future__ import annotations

import os
from contextlib import contextmanager
from dataclasses import dataclass

H100_HBM_BYTES_PER_S = 3.35e12
H100_FP32_FLOPS_PER_S = 67e12
H100_BF16_DENSE_FLOPS_PER_S = 989e12
H100_MUFU_LOGS_PER_S = 16 * 132 * 1.98e9  # 4.18e12 log2 results a second


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
        return "bytes" if bounds["hbm_bound_s"] >= max(bounds.values()) else "operations"


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
    """Speed of light of the M-step kernels (``csrc/mstep.cu``).

    The addition: every call's barcode and ``q`` (4 + 4 bytes), the variant
    row pointers (8 per variant), the singlet posterior columns it reads
    (4·B·D) and the additions written once (4·V·D); per (call, donor)
    ``post·(1−q)`` (multiply), the power (one multiply at power 2) and the
    sum (add). With ``n_runs`` (``mstep_update``) also the SNP-run pointers
    (8 per run), the prior betas read and the genotype probabilities
    written (4·V·D each) and the mask (4·V) where ``masked``; per (variant,
    donor) the prior add, the division and three clamps (and the mask's
    multiply), plus ``neighbour_adds`` denominator adds per donor (Σ over
    runs of L·(L−1) for runs of L variants).
    """

    n_calls: int
    n_donors: int
    n_barcodes: int
    n_variants: int
    n_runs: int = 0
    masked: bool = False
    neighbour_adds: int = 0
    hbm_bytes_per_s: float = H100_HBM_BYTES_PER_S
    f32_flops_per_s: float = H100_FP32_FLOPS_PER_S

    def bytes_moved(self) -> int:
        n, d, b, v = self.n_calls, self.n_donors, self.n_barcodes, self.n_variants
        addition = 8 * n + 8 * (v + 1) + 4 * b * d + 4 * v * d
        if not self.n_runs:
            return addition
        return addition + 8 * (self.n_runs + 1) + 8 * v * d + 4 * v * self.masked

    def operations(self) -> int:
        addition = 3 * self.n_calls * self.n_donors
        if not self.n_runs:
            return addition
        vd = self.n_variants * self.n_donors
        return addition + (5 + self.masked) * vd + self.neighbour_adds * self.n_donors


@dataclass
class GatherRoofline(_Bound):
    """Speed of light of a row gather (``rows_out``) or a gather-sum (``csrc/gather.cu``).

    Bytes: the indices (4 per index), the table rows they touch (4·W per
    distinct row; each input byte counts once, however often it is
    gathered) and the output, the gathered rows (4·N·W) or one f32.
    Operations: none for the gather, one add per gathered element for the
    sum. The on-chip gather-sum reads each index once per slice of the
    table (``kernel_gather.GatherPlan.index_passes``) and loads each slice
    into every block that holds it: that is the layout's cost, reported
    beside the bound (chip_smoke.py phase 9d), not counted in it.
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


def logs_needed(counts, n_columns: int, per: int) -> int:
    """Logs an E-step variant needs: for each barcode of ``counts`` calls, one log per ``per`` calls (1: a
    log per term; 8: the product of 8 arguments, U >= 1e-4, stays a normal float), for each column."""
    return n_columns * sum(-(-int(c) // per) for c in counts)


@dataclass
class VariantRoofline(Roofline):
    """Speed of light of an E-step variant (``csrc/folded.cu``, ``split.cu``, ``group.cu``).

    The E-step's bytes and operations (:class:`Roofline`) over the folded
    calls U: ``u_bytes`` (U read once) in place of the calls' ids, ``q`` and
    the genotype table, and per call only the columns' work (U is folded
    already). Two terms more, as operations: ``log_count`` logs at the MUFU
    rate, as many as the function needs (:func:`logs_needed`: a log per term
    where each call's log is rounded to bf16 words, split with ``sc_words``
    >= 1 and group at 1 word; otherwise one per group or per 8 calls); and
    ``tensor_flop``, split's dense bf16 products (2·words·D·PG per call), at
    the tensor cores' rate.
    """

    u_bytes: int = 0
    log_count: int = 0
    tensor_flop: int = 0
    mufu_logs_per_s: float = H100_MUFU_LOGS_PER_S
    bf16_flops_per_s: float = H100_BF16_DENSE_FLOPS_PER_S

    def bytes_moved(self) -> int:
        rows = 1 + self.softmax + self.prior
        return self.u_bytes + 8 * (self.n_barcodes + 1) + 12 * self.n_pseudogenotypes + \
            4 * self.n_barcodes * self.n_pseudogenotypes * rows

    def operations(self) -> int:
        per_cell = 5 * self.softmax + self.prior
        return self.n_calls * 4 * self.n_pseudogenotypes + per_cell * self.n_barcodes * self.n_pseudogenotypes

    def estimate_seconds(self) -> dict:
        return {**super().estimate_seconds(), "mufu_bound_s": self.log_count / self.mufu_logs_per_s,
                "tensor_bound_s": self.tensor_flop / self.bf16_flops_per_s}


@dataclass
class AggregateRoofline(_Bound):
    """Speed of light of the aggregate-on-SNPs E-step (``csrc/aggregate.cu``).

    Bytes: every molecule call's variant id and ``q`` (4 + 4), the group
    and barcode pointers (8 each per group and barcode, + 8 each), the
    genotype table (4·V·D), the pair table (8 per column) and the logits
    written once (4·B·PG); ``softmax`` writes the probs too, ``prior`` reads
    the prior logits (4·B·PG each). Operations: the MUFU operations the
    function needs, at ``mufu_per_s``: a log per (call, column) for the call
    terms, an exp and a log per (group, column) for the two log-softmaxes
    (the second's normaliser is a constant), and two per group (its scale
    and its sum's reciprocal). The rate is the MUFU unit's alone: the FMA
    pipe can compute a log or exp by polynomial beside it, so a floor that
    splits the work between both units would be lower than this bound.
    """

    n_calls: int
    n_groups: int
    n_barcodes: int
    n_variants: int
    n_donors: int
    n_pseudogenotypes: int
    softmax: bool = False
    prior: bool = False
    hbm_bytes_per_s: float = H100_HBM_BYTES_PER_S
    mufu_per_s: float = H100_MUFU_LOGS_PER_S

    def bytes_moved(self) -> int:
        b, pg = self.n_barcodes, self.n_pseudogenotypes
        rows = 1 + self.softmax + self.prior  # [B, PG] arrays: logits, probs, prior
        return (8 * self.n_calls + 8 * (self.n_groups + 1) + 8 * (b + 1) + 4 * self.n_variants * self.n_donors
                + 8 * pg + 4 * b * pg * rows)

    def operations(self) -> int:
        pg = self.n_pseudogenotypes
        return self.n_calls * pg + 2 * self.n_groups * pg + 2 * self.n_groups

    def estimate_seconds(self) -> dict:
        return {"hbm_bound_s": self.bytes_moved() / self.hbm_bytes_per_s,
                "mufu_bound_s": self.operations() / self.mufu_per_s}
