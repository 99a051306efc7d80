"""The aggregate-on-SNPs E-step with the row softmax fused: the hand-written CUDA kernel and its plain version.

The JAX package leaves this op to XLA (``demuxalot_tpu/ops/likelihood.py:258``
``snp_aggregated_logits``; reference demuxalot/demux.py:193-244), so it
replaces no Pallas kernel. Kernel: ``csrc/aggregate.cu``. For barcode b and
column g, a group being the molecule calls of one (barcode, SNP):

    x[grp, g] = (Σ_{calls c of grp} log(p[c, g] + q_c)) / max(n_grp, 1)**compensation
    p[c, g]   = ½·(G[vid_c, i_g] + G[vid_c, j_g])
    z         = log_softmax(logaddexp(log_softmax(x[grp, :]), log(p_bad_snp / PG)))
    logits[b] = Σ_{groups of b, in group order} z[grp, :]              (+ prior[b])
    probs[b]  = softmax(logits[b])                                      (softmax=True)

with no doublet penalty. On the H100 it is bound by the MUFU unit (a log
per call and column, an exp and a log per group and column). One launch,
its instantiation picked by :func:`aggregate_plan` from the row's width: at
narrow rows a team of lanes a group, several groups a warp; up to 544
columns a warp a group; wider rows split over the warps of a block; the
columns and the barcode's running row in registers, no ``[groups,
columns]`` buffer in device memory. See the source.

:func:`aggregate_operands` builds what it reads once per dataset, doublet
prior and device, and checks the indices on a card then. :func:`aggregated_logits`
launches the kernel for CUDA tensors and runs :func:`aggregated_logits_plain`
(``ops.likelihood.snp_aggregated_logits``, the prior, ``torch.softmax``) for
CPU tensors; anything else raises. ``aggregated_logits.launches`` counts
launches, and ``.host_ns`` and ``.host_calls`` its host time
(``utils.tracing.timed_op``).
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..utils import tracing
from . import _cuda
from . import likelihood as L
from .likelihood_kernel import _check

P_BAD_SNP = 0.01

# The kernel's instantiations (csrc/aggregate.cu: pick): lanes a group -> columns a lane in registers. 1-16: teams
# of lanes, several groups a warp; 32: a warp a group (0: the group's row in shared memory, any width); 0: the
# block's warps split the row, at most MAX_SPLIT_WARPS of them. Kept: those that were fastest at some width of
# chip_smoke.py's sweep on an H100 (PERF.md), and (32, 0) for rows past the split's.
TEAM_COLUMNS = {1: (4,), 2: (4,), 4: (4, 8), 8: (8,), 16: (8, 16), 32: (17, 0), 0: (9, 17)}
# aggregate_plan's pick up to 544 columns: (the widest row, lanes a group, columns a lane)
NARROW_PLANS = ((4, 1, 4), (8, 2, 4), (16, 4, 4), (32, 4, 8), (64, 8, 8), (128, 16, 8), (256, 16, 16), (544, 32, 17))
MAX_SPLIT_WARPS = 16
# (lanes a group, columns a lane) for every launch, one of instantiations(n_pg), or None for aggregate_plan's
# choice; set only by chip_smoke.py's sweep and the card tests
PLAN: Optional[tuple] = None


def instantiations(n_pg: int) -> list:
    """Every (lanes a group, columns a lane) of TEAM_COLUMNS whose kernel holds ``n_pg`` columns."""
    def holds(team, cols):
        if team == 0:
            return -(-n_pg // (32 * cols)) <= MAX_SPLIT_WARPS
        return cols == 0 or team * cols >= n_pg

    return [(team, cols) for team, options in TEAM_COLUMNS.items() for cols in options if holds(team, cols)]


def aggregate_plan(n_pg: int) -> tuple:
    """(lanes a group, columns a lane) of the kernel's instantiation for ``n_pg`` columns: ``NARROW_PLANS`` up to
    544 columns; past that the row split over a block's warps, at the columns a lane (of ``TEAM_COLUMNS[0]``) that
    leave the fewest lane-columns idle; past MAX_SPLIT_WARPS such warps the row in shared memory."""
    if n_pg < 1:
        raise ValueError(f"n_pg must be positive, got {n_pg}")
    for widest, lanes, cols in NARROW_PLANS:
        if n_pg <= widest:
            return lanes, cols
    fits = [(-(-n_pg // (32 * cols)) * cols, cols) for cols in TEAM_COLUMNS[0]
            if -(-n_pg // (32 * cols)) <= MAX_SPLIT_WARPS]
    return (0, min(fits)[1]) if fits else (32, 0)


class AggregateOperands(NamedTuple):
    """The (barcode, SNP) groups the aggregate E-step reads, built by :func:`aggregate_operands`.

    The kernel reads the pair table and the two CSRs (calls of every group,
    groups of every barcode); the plain version builds the same columns'
    mixing matrix from the pair table and reads the CSRs' run lengths.
    """

    pairs: torch.Tensor  # i32 [2, PG] every column's donor pair, (i, i) for a singlet
    vid: torch.Tensor  # i32 [N] variant of every molecule call, sorted by group
    q: torch.Tensor  # f32 [N] p_base_wrong of every molecule call
    group_ptr: torch.Tensor  # i64 [G + 1] first call of every group
    barcode_ptr: torch.Tensor  # i64 [B + 1] first group of every barcode
    n_variants: int  # genotype rows the ids were checked against
    n_donors: int  # genotype columns the pairs were checked against
    compensation: float
    p_bad_snp: float = P_BAD_SNP

    @property
    def n_barcodes(self) -> int:
        return self.barcode_ptr.shape[0] - 1

    @property
    def n_groups(self) -> int:
        return self.group_ptr.shape[0] - 1

    @property
    def n_columns(self) -> int:
        return self.pairs.shape[1]

    def tensors(self) -> list:
        return [self.pairs, self.vid, self.q, self.group_ptr, self.barcode_ptr]


class CheckedAggregateOperands(AggregateOperands):
    """Operands that :func:`aggregate_operands` built and checked; ``_replace`` returns unchecked ones, which a
    card launch refuses."""

    __slots__ = ()

    def _replace(self, **fields) -> AggregateOperands:
        return AggregateOperands(*self)._replace(**fields)


def aggregate_operands(pairs: np.ndarray, n_donors: int, vid: torch.Tensor, q: torch.Tensor,
                       group_ptr: torch.Tensor, barcode_ptr: torch.Tensor, n_variants: int, compensation: float,
                       p_bad_snp: float = P_BAD_SNP) -> CheckedAggregateOperands:
    """Checked operands on the calls' device; build them once per dataset, doublet prior and device.

    ``pairs`` int32 [2, PG]: each column's donor pair
    (``np.stack(ops.likelihood.pseudogenotype_pairs(D, prior))``, or
    :func:`ops.likelihood.column_pairs` of a mixing matrix). On the calls'
    device: ``vid``, ``q``, the molecule calls sorted by group; ``group_ptr``
    (i64 [G + 1]) the first call of every group; ``barcode_ptr`` (i64
    [B + 1]) the first group of every barcode, groups sorted by (barcode,
    SNP). On a card the CSRs, the ids (against ``n_variants`` genotype rows)
    and the pairs are checked once here: ``checks.cu``'s kernels trap on a
    bad one before any launch reads through it.
    """
    device = vid.device
    _check("vid", vid, torch.int32, 1, device)
    _check("q", q, torch.float32, 1, device)
    _check("group_ptr", group_ptr, torch.int64, 1, device)
    _check("barcode_ptr", barcode_ptr, torch.int64, 1, device)
    pairs = np.ascontiguousarray(pairs, dtype=np.int32)
    if pairs.ndim != 2 or pairs.shape[0] != 2 or pairs.shape[1] < 1:
        raise ValueError(f"pairs must be int32 [2, PG >= 1], got {pairs.shape}")
    if vid.shape != q.shape or group_ptr.shape[0] < 1 or barcode_ptr.shape[0] < 1:
        raise ValueError("vid and q must align; group_ptr and barcode_ptr need at least one entry")
    operands = CheckedAggregateOperands(
        pairs=torch.from_numpy(pairs).to(device), vid=vid, q=q, group_ptr=group_ptr, barcode_ptr=barcode_ptr,
        n_variants=int(n_variants), n_donors=int(n_donors), compensation=float(compensation), p_bad_snp=float(p_bad_snp),
    )
    if vid.shape[0] >= 2 ** 31 and int((group_ptr[barcode_ptr[1:]] - group_ptr[barcode_ptr[:-1]]).max()) >= 2 ** 31:
        raise ValueError("a barcode holds 2**31 calls or more: the kernel counts a barcode's calls in 32 bits")
    if device.type == "cuda":
        o = operands
        _check_on_card(vid, o.group_ptr.data_ptr(), o.n_groups, vid.shape[0], vid.data_ptr(), o.n_variants,
                       barcode_ptr.data_ptr(), o.n_barcodes, o.pairs.data_ptr(), pairs.shape[1], n_donors)
    return operands


def aggregated_logits_plain(genotype_prob: torch.Tensor, operands: AggregateOperands, *,
                            prior_logits: Optional[torch.Tensor] = None, softmax: bool = False):
    """Plain PyTorch version of the kernel, on any device."""
    o = operands
    pairs = o.pairs.cpu().numpy()
    mixing = torch.from_numpy(L.mixing_from_pairs(pairs[0], pairs[1], o.n_donors)).to(genotype_prob.device)
    logits = L.snp_aggregated_logits(
        genotype_prob, mixing, o.vid, o.q, o.group_ptr.cpu().numpy(), o.group_ptr.diff(), o.barcode_ptr.diff(),
        compensation=o.compensation, p_bad_snp=o.p_bad_snp,
    )
    if prior_logits is not None:
        logits = logits + prior_logits
    return (logits, torch.softmax(logits, dim=-1)) if softmax else logits


@tracing.timed_op
def aggregated_logits(genotype_prob: torch.Tensor, operands: AggregateOperands, *,
                      prior_logits: Optional[torch.Tensor] = None, softmax: bool = False):
    """Aggregated logits f32 [B, PG] from genotype_prob f32 [V, D], plus ``prior_logits`` [B, PG] where given.

    With ``softmax=True`` returns ``(logits, probs)``, probs the row softmax
    of the logits. The CUDA kernel for CUDA tensors (one launch either way),
    the plain version for CPU tensors.
    """
    if not isinstance(operands, AggregateOperands):
        raise TypeError("operands must be AggregateOperands (aggregate_operands)")
    device = genotype_prob.device
    _check("genotype_prob", genotype_prob, torch.float32, 2, device)
    o = operands
    for name, dtype, ndim in (("pairs", torch.int32, 2), ("vid", torch.int32, 1), ("q", torch.float32, 1),
                              ("group_ptr", torch.int64, 1), ("barcode_ptr", torch.int64, 1)):
        _check(name, getattr(o, name), dtype, ndim, device)
    n_donors, n_pg = o.n_donors, o.n_columns
    if tuple(genotype_prob.shape) != (o.n_variants, n_donors):
        raise ValueError(f"genotype_prob must be [{o.n_variants}, {n_donors}] as the operands were built, "
                         f"got {tuple(genotype_prob.shape)}")
    if prior_logits is not None:
        _check("prior_logits", prior_logits, torch.float32, 2, device)
        if prior_logits.shape != (o.n_barcodes, n_pg):
            raise ValueError(f"prior_logits must be [{o.n_barcodes}, {n_pg}], got {tuple(prior_logits.shape)}")
    if device.type == "cpu":
        return aggregated_logits_plain(genotype_prob, operands, prior_logits=prior_logits, softmax=softmax)
    if device.type != "cuda":
        raise ValueError(f"aggregated_logits runs on cpu or cuda tensors, not {device}")
    if not isinstance(o, CheckedAggregateOperands):
        raise ValueError("aggregated_logits: operands must come from aggregate_operands")
    logits = torch.empty((o.n_barcodes, n_pg), dtype=torch.float32, device=device)
    probs = torch.empty_like(logits) if softmax else None
    if o.n_barcodes > 0:
        escape = np.float32(o.p_bad_snp / n_pg)
        log_norm = math.log1p(n_pg * float(escape))  # log Σ_k (e^{y_k} + escape), Σ_k e^{y_k} = 1
        team, cols = PLAN or aggregate_plan(n_pg)
        _aggregate(genotype_prob, genotype_prob.data_ptr(), n_donors, o.vid.data_ptr(), o.q.data_ptr(),
                   o.group_ptr.data_ptr(), o.barcode_ptr.data_ptr(), o.n_barcodes, o.pairs.data_ptr(), n_pg,
                   team, cols, o.compensation, float(escape), log_norm,
                   prior_logits.data_ptr() if prior_logits is not None else None, logits.data_ptr(),
                   probs.data_ptr() if softmax else None)
        aggregated_logits.launches += 1
    return (logits, probs) if softmax else logits


aggregated_logits.launches = 0
_aggregate = _cuda.Entry("demux_aggregated_logits")
_check_on_card = _cuda.Entry("demux_aggregate_check")
