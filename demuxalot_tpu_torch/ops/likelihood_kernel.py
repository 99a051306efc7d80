"""E-step likelihood with the row softmax fused: the hand-written CUDA kernel and its plain version.

Replaces ``demuxalot_tpu/ops/pallas_likelihood.py:_likelihood_kernel`` (the
TPU E-step) with its ``softmax_out`` epilogue, and the gather/fold the JAX
package ran around it. Kernel: ``csrc/likelihood.cu``. Per barcode b and
pseudogenotype g it computes

    logits[b, g] = pen[g] + Σ_{calls c of b} log(U'[c, i_g] + U'[c, j_g])   (+ prior[b, g])
    U'[c, d]     = ½·(G[vid_c, d]·(1−q_c) + max(q_c, 1e-4))
    probs[b, :]  = softmax(logits[b, :])                                    (softmax=True)

over calls in barcode CSR form. On the H100 it is bound by instruction
issue and shared-memory loads: one warp per barcode, each lane a register
tile of donor pairs (:func:`estep_schedule`), 8 arguments multiplied per
log, and the row softmax from the warp's staged row of logits. See the
source for the details.

:func:`estep_operands` builds what it reads once per dataset, doublet prior
and device, and checks the indices on a card then (``csrc/checks.cu``'s
``demux_estep_check``), so a launch checks nothing on the device.
:func:`estep_logits` launches the kernel for CUDA tensors of operands it
built and runs :func:`estep_logits_plain` (``ops.likelihood.barcode_logits``,
the prior, ``torch.softmax``) for CPU tensors; anything else raises.
``estep_logits.launches`` counts launches, and ``.host_ns`` and
``.host_calls`` its host time (``utils.tracing.timed_op``).
"""
from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..utils import tracing
from . import _cuda
from . import likelihood as L

# the kernel's tile schedule (csrc/likelihood.cu): a warp's 32 lanes each hold
# a 4 x 4 tile of donor pairs (16 slots) and a 2 x 2 tile (4 slots); an entry
# is [quad p, quad q, duo r, duo s, 20 slot columns]
LANES = 32
QUAD_SLOTS = 16
SLOTS = QUAD_SLOTS + 4
ENTRY = 4 + SLOTS


@functools.lru_cache(maxsize=None)
def estep_schedule(n_donors: int, doublet_prior: float) -> np.ndarray:
    """The kernel's tile schedule: int32 [passes, 32, 24], read-only.

    Donors are cut into blocks of 4 (the staged row is padded to a multiple
    of 4). Pass k, lane l holds a 4 x 4 tile (quad: donor blocks p ≤ q) and
    a 2 x 2 tile (duo: blocks r ≤ s of 2 donors); slot (a, b) of a quad is
    the pair (4p + a, 4q + b), of a duo (2r + a, 2s + b), and its entry is
    that pair's column in :func:`ops.likelihood.pseudogenotype_pairs` order,
    or -1 where the pair is no column (i > j, a padding donor, a doublet at
    prior 0, an unused tile). An entry is [p, q, r, s, 16 quad columns, 4
    duo columns]. Off-diagonal blocks take quads; diagonal blocks take the
    quads left over in the last pass, then three duos each (two at prior
    0). One pass walks the barcode's calls once: at 32 donors with
    doublets, 28 + 4 quads and 12 duos fit one pass, 20 slots per lane for
    528 columns.
    """
    col_i, col_j = L.pseudogenotype_pairs(n_donors, doublet_prior)
    column = {(int(i), int(j)): g for g, (i, j) in enumerate(zip(col_i, col_j))}

    def quad_columns(p: int, q: int) -> list:
        return [column.get((4 * p + a, 4 * q + b), -1) for a in range(4) for b in range(4)]

    def duo_columns(r: int, s: int) -> list:
        return [column.get((2 * r + a, 2 * s + b), -1) for a in range(2) for b in range(2)]

    n_blocks = -(-n_donors // 4)
    doublets = doublet_prior != 0
    off_diagonal = [(p, q) for p in range(n_blocks) for q in range(p + 1, n_blocks)] if doublets else []
    passes = max(1, -(-len(off_diagonal) // LANES))
    while True:
        as_quads = min(n_blocks, passes * LANES - len(off_diagonal))
        quads = off_diagonal + [(p, p) for p in range(as_quads)]
        duos = []
        for p in range(as_quads, n_blocks):
            halves = [(2 * p, 2 * p), (2 * p + 1, 2 * p + 1)] + ([(2 * p, 2 * p + 1)] if doublets else [])
            duos += [(r, s) for r, s in halves if max(duo_columns(r, s)) >= 0]
        if len(duos) <= passes * LANES:
            break
        passes += 1
    table = np.zeros((passes * LANES, ENTRY), np.int32)
    table[:, 4:] = -1
    for k, (p, q) in enumerate(quads):
        table[k, 0:2] = p, q
        table[k, 4:4 + QUAD_SLOTS] = quad_columns(p, q)
    # every lane computes all 20 slots; duos go to the lanes with the fewest columns
    fewest = np.argsort((table[:, 4:] >= 0).sum(axis=1), kind="stable")
    for lane, (r, s) in zip(fewest, duos):
        table[lane, 2:4] = r, s
        table[lane, 4 + QUAD_SLOTS:] = duo_columns(r, s)
    table = table.reshape(passes, LANES, ENTRY)
    table.setflags(write=False)
    return table


class EStepOperands(NamedTuple):
    """What the E-step reads besides the genotype probabilities.

    The kernel reads the tile schedule and the barcode CSR; the plain
    version reads the same columns as a mixing matrix and the barcode of
    every call. Built once per dataset and doublet prior by
    :func:`estep_operands`.
    """

    penalties: torch.Tensor  # f32 [PG]
    schedule: torch.Tensor  # i32 [passes, 32, 24] tile schedule (kernel)
    mixing: torch.Tensor  # f32 [D, PG] the columns' donor pairs as a matrix (plain)
    row_ptr: torch.Tensor  # i64 [B + 1] barcode CSR over the calls (kernel)
    cb: torch.Tensor  # i32 [N] barcode of every call (plain)
    vid: torch.Tensor  # i32 [N], sorted by barcode
    q: torch.Tensor  # f32 [N]
    n_variants: int  # genotype rows the ids were checked against

    @property
    def n_barcodes(self) -> int:
        return self.row_ptr.shape[0] - 1


CheckedEStepOperands = _cuda.checked(EStepOperands)


def estep_operands(n_donors: int, doublet_prior: float, row_ptr, cb, vid, q,
                   n_variants: int) -> CheckedEStepOperands:
    """The doublet model for ``n_donors`` on the calls' device, with the calls, built once per dataset, doublet
    prior and device. On a card the barcode CSR, every ``vid`` (against ``n_variants`` genotype rows) and the
    schedule are checked here: ``checks.cu``'s kernels trap on a bad one before any launch reads through it."""
    col_i, col_j = L.pseudogenotype_pairs(n_donors, doublet_prior)
    device = row_ptr.device
    operands = CheckedEStepOperands(
        penalties=torch.from_numpy(L.doublet_penalties(n_donors, doublet_prior)).to(device),
        schedule=torch.from_numpy(estep_schedule(n_donors, doublet_prior).copy()).to(device),
        mixing=torch.from_numpy(L.mixing_from_pairs(col_i, col_j, n_donors)).to(device),
        row_ptr=row_ptr, cb=cb, vid=vid, q=q, n_variants=int(n_variants),
    )
    _check_operands(operands, device)
    if device.type == "cuda":
        o = operands
        _check_on_card(vid, row_ptr.data_ptr(), o.n_barcodes, vid.shape[0], vid.data_ptr(), o.n_variants,
                       o.schedule.data_ptr(), o.schedule.shape[0], ENTRY, n_donors, o.penalties.shape[0])
    return operands


def estep_logits_plain(genotype_prob: torch.Tensor, operands: EStepOperands, *,
                       prior_logits: Optional[torch.Tensor] = None, softmax: bool = False):
    """Plain PyTorch version of the kernel, on any device."""
    o = operands
    logits = L.barcode_logits(genotype_prob, o.mixing, o.penalties, o.vid, o.cb, o.q, o.n_barcodes)
    if prior_logits is not None:
        logits = logits + prior_logits
    return (logits, torch.softmax(logits, dim=-1)) if softmax else logits


def _check(name: str, tensor: torch.Tensor, dtype: torch.dtype, ndim: int, device) -> None:
    if not isinstance(tensor, torch.Tensor):
        raise TypeError(f"{name} must be a tensor")
    if tensor.dtype != dtype or tensor.dim() != ndim:
        raise ValueError(f"{name}: expected {dtype} with {ndim} dims, got {tensor.dtype} {tuple(tensor.shape)}")
    if tensor.device != device:
        raise ValueError(f"{name} is on {tensor.device}, expected {device}")
    if not tensor.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


_OPERAND_TYPES = {
    "penalties": (torch.float32, 1), "schedule": (torch.int32, 3), "mixing": (torch.float32, 2),
    "row_ptr": (torch.int64, 1), "cb": (torch.int32, 1), "vid": (torch.int32, 1), "q": (torch.float32, 1),
}


def _check_operands(o: EStepOperands, device) -> None:
    for name, (dtype, ndim) in _OPERAND_TYPES.items():
        _check(name, getattr(o, name), dtype, ndim, device)
    if o.mixing.shape[1] != o.penalties.shape[0]:
        raise ValueError("mixing must have one column per penalty")
    if o.schedule.shape[0] < 1 or o.schedule.shape[1:] != (LANES, ENTRY):
        raise ValueError(f"schedule must be [passes >= 1, {LANES}, {ENTRY}], got {tuple(o.schedule.shape)}")
    if not o.vid.shape == o.q.shape == o.cb.shape or o.n_barcodes < 0:
        raise ValueError("cb, vid and q must align, row_ptr needs at least one entry")


@tracing.timed_op
def estep_logits(genotype_prob: torch.Tensor, operands: EStepOperands, *,
                 prior_logits: Optional[torch.Tensor] = None, softmax: bool = False):
    """Barcode logits f32 [B, PG] from genotype_prob f32 [V, D], plus ``prior_logits`` [B, PG] where given.

    With ``softmax=True`` returns ``(logits, probs)``, probs the row softmax
    of the logits. The CUDA kernel for CUDA tensors (one launch either way),
    the plain version for CPU tensors.
    """
    device = genotype_prob.device
    _check("genotype_prob", genotype_prob, torch.float32, 2, device)
    o = operands
    _check_operands(o, device)
    n_pg = o.penalties.shape[0]
    n_barcodes = o.n_barcodes
    if tuple(genotype_prob.shape) != (o.n_variants, o.mixing.shape[0]):
        raise ValueError(f"genotype_prob must be [{o.n_variants}, {o.mixing.shape[0]}] as the operands were built, "
                         f"got {tuple(genotype_prob.shape)}")
    if prior_logits is not None:
        _check("prior_logits", prior_logits, torch.float32, 2, device)
        if prior_logits.shape != (n_barcodes, n_pg):
            raise ValueError(f"prior_logits must be [{n_barcodes}, {n_pg}], got {tuple(prior_logits.shape)}")
    if device.type == "cpu":
        return estep_logits_plain(genotype_prob, operands, prior_logits=prior_logits, softmax=softmax)
    if device.type != "cuda":
        raise ValueError(f"estep_logits runs on cpu or cuda tensors, not {device}")
    if not isinstance(o, CheckedEStepOperands):
        raise ValueError("estep_logits: operands must come from estep_operands")
    logits = torch.empty((n_barcodes, n_pg), dtype=torch.float32, device=device)
    probs = torch.empty_like(logits) if softmax else None
    if n_barcodes > 0:
        _estep(genotype_prob, genotype_prob.data_ptr(), genotype_prob.shape[1], o.row_ptr.data_ptr(),
               o.vid.data_ptr(), o.q.data_ptr(), n_barcodes, o.penalties.data_ptr(), o.schedule.data_ptr(),
               o.schedule.shape[0], n_pg, prior_logits.data_ptr() if prior_logits is not None else None,
               logits.data_ptr(), probs.data_ptr() if softmax else None)
        estep_logits.launches += 1
    return (logits, probs) if softmax else logits


estep_logits.launches = 0
_estep = _cuda.Entry("demux_estep_logits")
_check_on_card = _cuda.Entry("demux_estep_check")
