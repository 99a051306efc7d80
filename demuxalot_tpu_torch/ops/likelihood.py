"""Demultiplexing math in plain PyTorch: genotype probs, doublet model, logits.

The core computation is, per barcode b and pseudo-genotype g:

    logits[b, g] = penalty[g] + Σ_{calls c of b} log(p[v_c, g]·(1−q_c) + max(q_c, 1e-4))

with p[v, g] the per-variant genotype probability — for a doublet column
(g1, g2) the mean of the two donors. This module is the plain path: gather
genotype rows per call, expand the doublet axis with a [donors,
pseudogenotypes] matmul, take the log, and ``index_add_`` into barcode
rows. It runs the CPU engine and is what the hand-written kernels
(``likelihood_kernel``, ``mstep_kernel``) are checked against. Semantics
are those of ``demuxalot_tpu.ops.likelihood`` (reference:
demuxalot/demux.py:158-274).

Precision: the doublet matmul must run in full float32. TF32 (or a single
bf16 pass) shifts posteriors by about 2e-2, so :func:`barcode_logits` sets
``torch.backends.cuda.matmul.allow_tf32 = False`` (PyTorch's default)
before it multiplies on the card.
"""
from __future__ import annotations

import math
from typing import List, Tuple

import numpy as np
import torch

from .packing import MAX_WINDOWED_RUN

DEFAULT_CALL_CHUNK = 256 * 1024
# probs_from_betas' denominator floor (the fused M-step's epilogue uses it too)
DENOMINATOR_FLOOR = 1e-7


# ---------------------------------------------------------------------------
# Host-side model setup (tiny, numpy)
# ---------------------------------------------------------------------------

def doublet_penalties(n_genotypes: int, doublet_prior: float) -> np.ndarray:
    """Per-pseudogenotype logit corrections establishing the doublet prior.

    Chosen so the softmax prior mass on singlets is exactly
    ``1 - doublet_prior`` regardless of donor count
    (reference: demuxalot/demux.py:158-173).
    """
    assert 0 <= doublet_prior < 1
    if doublet_prior == 0:
        return np.zeros(n_genotypes, dtype="float32")

    doublet_logit_bonus = math.log(n_genotypes * doublet_prior)
    doublet_logit_bonus -= math.log(n_genotypes * max(n_genotypes - 1, 1) / 2 * (1 - doublet_prior))
    n_options = n_genotypes * (n_genotypes + 1) // 2  # singlets first, then doublets
    penalties = np.zeros(n_options, dtype="float32")
    penalties[n_genotypes:] = doublet_logit_bonus
    return penalties


def pseudogenotype_pairs(n_genotypes: int, doublet_prior: float) -> Tuple[np.ndarray, np.ndarray]:
    """Donor pair (col_i, col_j) int32 [n_pseudogenotypes] of every column.

    The one definition of the column order, which matches the reference
    enumeration (demuxalot/demux.py:175-191): singlets in donor order
    (``col_i == col_j``), then unordered pairs (i, j) with i < j when the
    doublet prior is nonzero. Column g is the mean of donors ``col_i[g]``
    and ``col_j[g]``; this is the form the E-step kernel reads.
    """
    assert doublet_prior >= 0
    col_i = list(range(n_genotypes))
    col_j = list(range(n_genotypes))
    if doublet_prior != 0:
        for i in range(n_genotypes):
            for j in range(i + 1, n_genotypes):
                col_i.append(i)
                col_j.append(j)
    return np.asarray(col_i, dtype=np.int32), np.asarray(col_j, dtype=np.int32)


def pseudogenotype_names(genotype_names: List[str], doublet_prior: float) -> List[str]:
    """Column names in :func:`pseudogenotype_pairs` order: donors, then 'A+B'."""
    col_i, col_j = pseudogenotype_pairs(len(genotype_names), doublet_prior)
    return [
        genotype_names[i] if i == j else f"{genotype_names[i]}+{genotype_names[j]}"
        for i, j in zip(col_i.tolist(), col_j.tolist())
    ]


def mixing_from_pairs(col_i: np.ndarray, col_j: np.ndarray, n_genotypes: int) -> np.ndarray:
    """Mixing matrix f32 [n_genotypes, n_pseudogenotypes] of the donor pairs.

    Column g is ½·e_i + ½·e_j, so a singlet column (i == j) is exactly e_i:
    the plain E-step's doublet expansion is ``genotype_prob @ mixing``.
    """
    mixing = np.zeros((n_genotypes, len(col_i)), dtype="float32")
    columns = np.arange(len(col_i))
    np.add.at(mixing, (col_i, columns), 0.5)
    np.add.at(mixing, (col_j, columns), 0.5)
    return mixing


def pseudogenotype_mixing(
    genotype_names: List[str], doublet_prior: float
) -> Tuple[np.ndarray, List[str]]:
    """Mixing matrix [n_donors, n_pseudogenotypes] and column names.

    The JAX package's form of the doublet model, built from
    :func:`pseudogenotype_pairs`: identity for singlets, 0.5/0.5 for
    unordered donor pairs.
    """
    col_i, col_j = pseudogenotype_pairs(len(genotype_names), doublet_prior)
    return (
        mixing_from_pairs(col_i, col_j, len(genotype_names)),
        pseudogenotype_names(genotype_names, doublet_prior),
    )


# ---------------------------------------------------------------------------
# Tensor ops
# ---------------------------------------------------------------------------

def probs_from_betas(
    betas: torch.Tensor,  # f32 [n_variants, n_donors]
    variant2snp: torch.Tensor,  # int [n_variants]
    n_snps: int,
    p_genotype_clip: float,
    max_per_snp: int = 0,
) -> torch.Tensor:
    """Per-donor variant probability: beta / Σ betas of the same SNP, clipped.

    ``max_per_snp > 0`` states that ``variant2snp`` is non-decreasing with
    at most that many variants per SNP (the layout
    :class:`ops.packing.VariantReindex` produces). The denominator is then a
    windowed sum of shifted rows, elementwise work with no scatter; the
    additions run in the same order as the JAX package's, so the two agree
    bit for bit. 0 = no ordering assumption: the variants are stably sorted
    by SNP and each SNP's run is summed in order (``torch.segment_reduce``),
    so two calls give the same bits on the card too (``index_add_`` would
    sum in atomic order there).

    (reference: demuxalot/demux.py:267-274)
    """
    if 0 < max_per_snp <= MAX_WINDOWED_RUN:
        n = betas.shape[0]
        denom = betas.clone()
        for d in range(1, min(max_per_snp, max(n, 1))):
            same = (variant2snp[d:] == variant2snp[:-d]).unsqueeze(1)
            denom[:-d] += torch.where(same, betas[d:], 0.0)
            denom[d:] += torch.where(same, betas[:-d], 0.0)
    else:
        order = torch.argsort(variant2snp, stable=True)
        per_snp = torch.segment_reduce(betas[order], "sum", unsafe=True,
                                       lengths=torch.bincount(variant2snp, minlength=n_snps))
        denom = per_snp[variant2snp]
    probs = betas / denom.clamp(min=DENOMINATOR_FLOOR)
    return probs.clamp(p_genotype_clip, 1 - p_genotype_clip)


def barcode_logits(
    genotype_prob: torch.Tensor,  # f32 [n_variants, n_donors]
    mixing: torch.Tensor,  # f32 [n_donors, n_pseudogenotypes]
    penalties: torch.Tensor,  # f32 [n_pseudogenotypes]
    variant_id: torch.Tensor,  # int [n_calls], sorted by barcode
    cb: torch.Tensor,  # int [n_calls], non-decreasing
    q: torch.Tensor,  # f32 [n_calls], padding rows have q == 1
    n_barcodes: int,
    call_chunk: int = DEFAULT_CALL_CHUNK,
) -> torch.Tensor:
    """Log-likelihood logits [n_barcodes, n_pseudogenotypes].

    Works through fixed-size call chunks to bound the [chunk,
    n_pseudogenotypes] intermediate: gather → ``@ mixing`` → log →
    ``index_add_`` into the barcode rows. Padding calls (q=1) contribute
    log(1) = 0 exactly.
    """
    if genotype_prob.is_cuda:
        torch.backends.cuda.matmul.allow_tf32 = False
    sums = genotype_prob.new_zeros((n_barcodes, mixing.shape[1]))
    for lo in range(0, variant_id.shape[0], call_chunk):
        vid_c = variant_id[lo: lo + call_chunk]
        q_c = q[lo: lo + call_chunk, None]
        p = genotype_prob[vid_c] @ mixing  # [chunk, pg]
        sums.index_add_(0, cb[lo: lo + call_chunk], torch.log(p * (1.0 - q_c) + q_c.clamp(min=1e-4)))
    return penalties + sums


def group_chunks(group_ptr: np.ndarray, call_chunk: int):
    """[g0, g1) ranges of consecutive groups holding at most ``call_chunk`` calls.

    ``group_ptr`` [n_groups + 1] gives each group's first call; a group
    larger than ``call_chunk`` makes a range of its own.
    """
    n_groups = len(group_ptr) - 1
    g0 = 0
    while g0 < n_groups:
        g1 = int(np.searchsorted(group_ptr, group_ptr[g0] + call_chunk, side="right")) - 1
        g1 = min(max(g1, g0 + 1), n_groups)
        yield g0, g1
        g0 = g1


def snp_aggregated_logits(
    genotype_prob: torch.Tensor,  # f32 [n_variants, n_donors]
    mixing: torch.Tensor,  # f32 [n_donors, n_pseudogenotypes]
    variant_id: torch.Tensor,  # int [n_calls] per molecule call, sorted by group
    q: torch.Tensor,  # f32 [n_calls] p_base_wrong per molecule call
    group_ptr: np.ndarray,  # int64 [n_groups + 1] first call of every group, on the host
    calls_per_group: torch.Tensor,  # int64 [n_groups] molecule calls of every group (>= 1)
    groups_per_barcode: torch.Tensor,  # int64 [n_barcodes] groups of every barcode, in group order
    compensation: float,
    p_bad_snp: float = 0.01,
    call_chunk: int = DEFAULT_CALL_CHUNK,
) -> torch.Tensor:
    """Logits [n_barcodes, n_pseudogenotypes] of the per-SNP aggregation path.

    Per (barcode, snp) group: sum the calls' ``log(p + q)``, damp by
    molecule-count**compensation, log-softmax, floor with a bad-SNP escape
    (``logaddexp`` with ``log(p_bad_snp / n_pg)``), log-softmax again, then
    sum the groups of each barcode (reference: demuxalot/demux.py:193-244).
    Groups are sorted by (barcode, snp) and calls by group, so both sums
    are segment sums over contiguous runs (``torch.segment_reduce``), taken
    in order with no atomics: the result is the same bit for bit on every
    run. An EM loop amplifies run-order noise here: with atomic sums two
    identical runs at the bench shape drifted apart past the posterior bar
    within five iterations. Calls are taken in chunks of whole groups, like
    :func:`barcode_logits`'s call chunks. Doublet penalties are NOT
    applied: the reference computes but never adds them on this path. The
    per-call term is not the E-step kernel's (``log(p·(1−q) + max(q,
    1e-4))``), so this path runs as torch ops.
    """
    if genotype_prob.is_cuda:
        torch.backends.cuda.matmul.allow_tf32 = False
    n_pg = mixing.shape[1]
    group_logits = genotype_prob.new_empty((calls_per_group.shape[0], n_pg))
    for g0, g1 in group_chunks(group_ptr, call_chunk):
        c0, c1 = int(group_ptr[g0]), int(group_ptr[g1])
        p = genotype_prob[variant_id[c0:c1]] @ mixing  # [chunk, pg]
        group_logits[g0:g1] = torch.segment_reduce(
            torch.log(p + q[c0:c1, None]), "sum", lengths=calls_per_group[g0:g1], unsafe=True)
    group_logits /= calls_per_group.to(group_logits.dtype).clamp(min=1.0)[:, None] ** compensation
    group_logits = torch.log_softmax(group_logits, dim=1)
    bad_snp = torch.tensor(math.log(p_bad_snp / n_pg), dtype=group_logits.dtype, device=group_logits.device)
    group_logits = torch.log_softmax(torch.logaddexp(group_logits, bad_snp, out=group_logits), dim=1)
    return torch.segment_reduce(group_logits, "sum", lengths=groups_per_barcode, unsafe=True)


def genotype_addition_from_posteriors(
    posterior: torch.Tensor,  # f32 [n_barcodes, n_pseudogenotypes]
    variant_id: torch.Tensor,  # int [n_calls], sorted by variant
    cb: torch.Tensor,  # int [n_calls]
    q: torch.Tensor,  # f32 [n_calls], padding rows have q == 1
    n_variants: int,
    n_genotypes: int,
    contribution_power: float,
    call_chunk: int = DEFAULT_CALL_CHUNK,
) -> torch.Tensor:
    """M-step sufficient statistics: posterior-weighted call counts per variant.

    Uses singlet posterior columns only; per call,
    ``(posterior[cb, g] · (1−q))**power`` is added to the call's variant row
    (reference: demuxalot/demux.py:113-118). Padding calls (q=1) contribute
    zero; the power is applied under a mask so it also holds for power ≤ 0.
    """
    singlet_posterior = posterior[:, :n_genotypes]
    out = posterior.new_zeros((n_variants, n_genotypes))
    for lo in range(0, variant_id.shape[0], call_chunk):
        q_c = q[lo: lo + call_chunk, None]
        w = singlet_posterior[cb[lo: lo + call_chunk]] * (1.0 - q_c)
        wp = w * w if contribution_power == 2.0 else w ** contribution_power
        out.index_add_(0, variant_id[lo: lo + call_chunk], torch.where(q_c >= 1.0, 0.0, wp))
    return out
