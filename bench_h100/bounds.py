"""The least time one NVIDIA H100 could take for each kernel's work: the benchmark's yardstick.

Frozen copies of ``demuxalot_tpu_torch.utils.profiling.Roofline`` (the
E-step) and ``MStepRoofline`` (the M-step), and :class:`AggregateBound`, a
bound on the aggregate-on-SNPs E-step that holds whatever implements it.
Each bound is the larger of the bytes over the HBM rate and the FP32
operations over the FP32 rate, with a log or an exp counted as one
operation. Bytes count each input read once and each output written once;
operations count what these inputs need. The rates are the published peaks
of the H100 SXM at its 700 W limit (NVIDIA's H100 data sheet): 3.35 TB/s
of HBM and 67 TFLOP/s in FP32 outside the tensor cores.
"""
from __future__ import annotations

from dataclasses import dataclass

H100_HBM_BYTES_PER_S = 3.35e12
H100_FP32_FLOPS_PER_S = 67e12


class _Bound:
    """Speed of light from ``bytes_moved()`` and ``operations()``."""

    def bytes_moved(self) -> int:
        raise NotImplementedError

    def operations(self) -> int:
        raise NotImplementedError

    def speed_of_light_s(self) -> float:
        return max(self.bytes_moved() / H100_HBM_BYTES_PER_S, self.operations() / H100_FP32_FLOPS_PER_S)


@dataclass
class Roofline(_Bound):
    """The E-step likelihood kernel (``csrc/likelihood.cu``), the program's ``Roofline`` as of its copy.

    Bytes: every call's variant id and ``q`` (4 + 4), the barcode row
    pointers (8 per barcode), the genotype table (4·V·D), the column
    schedule and penalties (12 per column) and the logits written once
    (4·B·PG). Operations per call: per pseudogenotype the mean of two donor
    terms (add, multiply), the running product (multiply) and a share of
    the log and the sum (one); per donor the term ``G·(1−q) + max(q, 1e-4)``
    (multiply, add, max). ``softmax``: the probs written too (4·B·PG) and 5
    operations per (barcode, column); ``prior``: the prior logits read
    (4·B·PG) and added (1 per (barcode, column)).
    """

    n_calls: int
    n_donors: int
    n_pseudogenotypes: int
    n_barcodes: int = 0
    n_variants: int = 0
    softmax: bool = False
    prior: bool = False

    def bytes_moved(self) -> int:
        n, d, pg, b, v = self.n_calls, self.n_donors, self.n_pseudogenotypes, self.n_barcodes, self.n_variants
        rows = 1 + self.softmax + self.prior
        return 8 * n + 8 * (b + 1) + 4 * v * d + 12 * pg + 4 * b * pg * rows

    def operations(self) -> int:
        per_cell = 5 * self.softmax + self.prior
        pg = self.n_pseudogenotypes
        return self.n_calls * (4 * pg + 3 * self.n_donors) + per_cell * self.n_barcodes * pg


@dataclass
class MStepRoofline(_Bound):
    """The M-step kernels (``csrc/mstep.cu``), the program's ``MStepRoofline`` as of its copy.

    The addition: every call's barcode and ``q`` (4 + 4 bytes), the variant
    row pointers (8 per variant), the singlet posterior columns (4·B·D) and
    the additions written once (4·V·D); per (call, donor) a multiply, the
    power (one multiply at power 2) and the sum. With ``n_runs``
    (``mstep_update``) also the SNP-run pointers (8 per run), the prior
    betas read and the genotype probabilities written (4·V·D each) and the
    mask (4·V) where ``masked``; per (variant, donor) the prior add, the
    division and three clamps (and the mask's multiply), plus
    ``neighbour_adds`` denominator adds per donor (Σ over runs of L·(L−1)).
    """

    n_calls: int
    n_donors: int
    n_barcodes: int
    n_variants: int
    n_runs: int = 0
    masked: bool = False
    neighbour_adds: int = 0

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
class AggregateBound(_Bound):
    """The aggregate-on-SNPs E-step with its softmax (``csrc/aggregate.cu``), whatever computes it.

    Per (barcode, SNP) group g of n_g molecule calls and column (i, j):
    ``z = Σ_calls log(½(G_i + G_j) + q) / n_g**c``, two log-softmaxes with
    the bad-SNP floor between them, summed over the barcode's groups, then
    the row softmax. Bytes: every molecule call's variant id and ``q`` (4 +
    4), the group and barcode pointers (8 each, + 8 each), the genotype
    table (4·V·D), the pair table (8 per column) and the logits and probs
    written once (4·B·PG each).

    Operations are the fewest that any implementation needs, so no kernel
    can read above the bound: per (call, donor) one (a donor's term with
    ``q`` folded in, so a column's argument is one add); per (call, column)
    the argument's add, and one more to fold each call after a group's
    first into the group's running value (a product needs no log per call);
    per (group, column) four: the first log-softmax's sum, the floor's
    multiply-add, its log and the add into the barcode's row (a group of one
    call needs neither the log of its product nor the exp of its scaled
    term, and the second log-softmax's normaliser is a constant); per
    (barcode, column) the softmax's five (max, difference, exp, sum,
    division).
    """

    n_calls: int
    n_groups: int
    n_barcodes: int
    n_variants: int
    n_donors: int
    n_pseudogenotypes: int

    def bytes_moved(self) -> int:
        b, pg = self.n_barcodes, self.n_pseudogenotypes
        return (8 * self.n_calls + 8 * (self.n_groups + 1) + 8 * (b + 1) + 4 * self.n_variants * self.n_donors
                + 8 * pg + 8 * b * pg)

    def operations(self) -> int:
        pg = self.n_pseudogenotypes
        per_call = self.n_calls * self.n_donors + self.n_calls * pg + (self.n_calls - self.n_groups) * pg
        return per_call + 4 * self.n_groups * pg + 5 * self.n_barcodes * pg
