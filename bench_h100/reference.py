"""The plain reference: demuxalot's EM over the generator's draws, in plain PyTorch.

It works out again, from the raw draws and the configuration alone, every
stage the benchmark's window runs: the join of the calls to the variant
registry, the collapse of each (variant, barcode) to one call with the
product of its molecules' error probabilities, the prior betas, the
genotype normalisation (``probs_from_betas``), the E-step (per call, or
aggregated over each (barcode, SNP) group) with its softmax, and the
M-step's addition. Semantics are upstream demuxalot's (demuxalot/demux.py:
158-392). It imports nothing of the program: no kernel, no packing, no
weights or tables that the program made.

``dtype`` is float64 for the reference and bfloat16 for the control (the
same arithmetic one precision below the configuration's float32). Work runs
in blocks of calls on ``device`` so that the largest cell fits beside
nothing else on one card.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from .generator import Draws, genotype_betas

CHUNK = 1 << 19  # calls a block
DENOMINATOR_FLOOR = 1e-7  # probs_from_betas' floor on a SNP's beta sum
Q_FLOOR = 1e-4  # the per-call term's floor on q (demuxalot/demux.py:207)


def column_pairs(n_donors: int, doublet_prior: float) -> tuple:
    """The donors (i, j) of every column: singlets in donor order, then i < j pairs where the prior is nonzero."""
    ci, cj = list(range(n_donors)), list(range(n_donors))
    if doublet_prior != 0:
        for i in range(n_donors):
            for j in range(i + 1, n_donors):
                ci.append(i)
                cj.append(j)
    return np.asarray(ci), np.asarray(cj)


def doublet_penalties(n_donors: int, doublet_prior: float) -> np.ndarray:
    """Logit offsets that put ``1 - doublet_prior`` of the prior on singlets (demuxalot/demux.py:158-173)."""
    n_columns = len(column_pairs(n_donors, doublet_prior)[0])
    penalties = np.zeros(n_columns)
    if doublet_prior != 0:
        bonus = math.log(n_donors * doublet_prior)
        bonus -= math.log(n_donors * max(n_donors - 1, 1) / 2 * (1 - doublet_prior))
        penalties[n_donors:] = bonus
    return penalties


def _blocks(ptr: np.ndarray, chunk: int):
    """[g0, g1) runs of consecutive segments of ``ptr`` holding at most ``chunk`` entries (one at least)."""
    n = len(ptr) - 1
    g0 = 0
    while g0 < n:
        g1 = int(np.searchsorted(ptr, ptr[g0] + chunk, side="right")) - 1
        g1 = min(max(g1, g0 + 1), n)
        yield g0, g1
        g0 = g1


class Reference:
    """The EM's stages over one pool, in ``dtype`` on ``device``.

    Variant v of the registry is SNP v // 2 (chr1, position v // 2) with
    base "A" (v even) or "C" (v odd), as the configuration registers them.
    Arrays on the variant axis are in that order; barcode b is row b.
    """

    def __init__(self, draws: Draws, config: dict, traffic: dict, device, dtype=torch.float64,
                 chunk: int = CHUNK):
        self.device, self.dtype, self.chunk = torch.device(device), dtype, chunk
        self.traffic = traffic
        self.aggregate = traffic["likelihood"] == "aggregate_on_snps"
        s, d, b = draws.n_snps, draws.n_donors, draws.n_barcodes
        self.n_snps, self.n_donors, self.n_barcodes, self.n_variants = s, d, b, 2 * s
        f64 = dict(dtype=torch.float64, device=self.device)
        i64 = dict(dtype=torch.int64, device=self.device)
        self.variant2snp = torch.arange(2 * s, **i64) // 2

        # the join: each call's (position, base) key looked up among the registry's keys
        registry_key = self.variant2snp * 8 + torch.arange(2 * s, **i64) % 2
        order = torch.argsort(registry_key)
        sorted_key = registry_key[order]
        call_key = torch.as_tensor(draws.snp, **i64) * 8 + torch.as_tensor(draws.allele, **i64)
        at = torch.searchsorted(sorted_key, call_key).clamp(max=2 * s - 1)
        matched = sorted_key[at] == call_key
        vid = order[at][matched]
        cb = torch.as_tensor(draws.cb, **i64)[matched]
        q = torch.as_tensor(draws.q, **f64)[matched]
        self.n_molecules = int(vid.shape[0])

        # prior betas: betas + (1 + data prior + SNP-normalised beta sums) x default prior (demuxalot/demux.py:367-390)
        betas = torch.as_tensor(genotype_betas(draws, config), **f64)
        molecules_at = torch.bincount(vid, minlength=2 * s).to(torch.float64)

        def over_snp(counts: torch.Tensor, regularization: float) -> torch.Tensor:
            per_snp = torch.zeros(s, **f64).index_add_(0, self.variant2snp, counts)
            return counts / (per_snp[self.variant2snp] + regularization)

        prior = 1.0 + over_snp(molecules_at, 100.0) + over_snp(betas.sum(dim=1), 100.0)
        self.prior_betas = (betas + prior[:, None] * config["default_prior"]).to(dtype)

        # the collapse: one call per (variant, barcode), its q the product of its molecules'
        key, inverse = torch.unique(vid * b + cb, return_inverse=True)
        self.vid = key // b
        self.cb = key % b
        self.q = torch.zeros(key.shape[0], **f64).index_add_(0, inverse, torch.log(q)).exp().to(dtype)
        self.n_calls = int(key.shape[0])

        ci, cj = column_pairs(d, traffic["doublet_prior"])
        self.ci, self.cj = torch.as_tensor(ci, **i64), torch.as_tensor(cj, **i64)
        self.n_columns = len(ci)
        self.penalties = torch.as_tensor(doublet_penalties(d, traffic["doublet_prior"]), **f64).to(dtype)

        if self.aggregate:
            # (barcode, SNP) groups of the molecule calls, the calls in group order
            group_key, group_of_call, counts = torch.unique(cb * s + vid // 2, return_inverse=True,
                                                            return_counts=True)
            by_group = torch.argsort(group_of_call, stable=True)
            self.group_vid = vid[by_group]
            self.group_q = q[by_group].to(dtype)
            self.group_barcode = group_key // s
            self.group_size = counts.to(dtype)
            self.group_ptr = np.concatenate([[0], np.cumsum(counts.cpu().numpy())])
            self.n_groups = int(group_key.shape[0])

    @property
    def n_runs(self) -> int:
        """SNP runs of the variant axis: every SNP has its two variants."""
        return self.n_snps

    def normalise(self, addition: torch.Tensor) -> torch.Tensor:
        """Genotype probabilities [V, D]: betas over their SNP's sum, clipped (demuxalot/demux.py:267-274)."""
        betas = self.prior_betas + addition.to(self.dtype)
        per_snp = torch.zeros((self.n_snps, self.n_donors), dtype=self.dtype, device=self.device)
        per_snp.index_add_(0, self.variant2snp, betas)
        clip = self.traffic["p_genotype_clip"]
        return (betas / per_snp[self.variant2snp].clamp(min=DENOMINATOR_FLOOR)).clamp(clip, 1 - clip)

    def _columns(self, rows: torch.Tensor) -> torch.Tensor:
        """[n, PG]: each column's mean of its two donors' probabilities."""
        return 0.5 * (rows[:, self.ci] + rows[:, self.cj])

    def estep(self, genotype_prob: torch.Tensor) -> tuple:
        """(logits, probs) [B, PG]: the mix's likelihood and its row softmax."""
        logits = (self._aggregated if self.aggregate else self._per_call)(genotype_prob.to(self.dtype))
        return logits, torch.softmax(logits, dim=1)

    def _per_call(self, genotype_prob: torch.Tensor) -> torch.Tensor:
        """Σ over a barcode's calls of log(p·(1−q) + max(q, 1e-4)), plus the doublet penalties."""
        logits = torch.zeros((self.n_barcodes, self.n_columns), dtype=self.dtype, device=self.device)
        for lo in range(0, self.n_calls, self.chunk):
            hi = lo + self.chunk
            p = self._columns(genotype_prob[self.vid[lo:hi]])
            q = self.q[lo:hi, None]
            logits.index_add_(0, self.cb[lo:hi], torch.log(p * (1 - q) + q.clamp(min=Q_FLOOR)))
        return logits + self.penalties

    def _aggregated(self, genotype_prob: torch.Tensor) -> torch.Tensor:
        """Σ over a barcode's (barcode, SNP) groups of the group's floored log-softmax (demuxalot/demux.py:193-244)."""
        compensation = self.traffic["compensation"]
        floor = torch.tensor(math.log(self.traffic["p_bad_snp"] / self.n_columns), dtype=self.dtype,
                             device=self.device)
        logits = torch.zeros((self.n_barcodes, self.n_columns), dtype=self.dtype, device=self.device)
        for g0, g1 in _blocks(self.group_ptr, self.chunk):
            c0, c1 = int(self.group_ptr[g0]), int(self.group_ptr[g1])
            sizes = torch.as_tensor(np.diff(self.group_ptr[g0:g1 + 1]), device=self.device)
            local = torch.repeat_interleave(torch.arange(g1 - g0, device=self.device), sizes)
            terms = torch.log(self._columns(genotype_prob[self.group_vid[c0:c1]]) + self.group_q[c0:c1, None])
            z = torch.zeros((g1 - g0, self.n_columns), dtype=self.dtype, device=self.device).index_add_(0, local, terms)
            z = torch.log_softmax(z / self.group_size[g0:g1, None] ** compensation, dim=1)
            z = torch.log_softmax(torch.logaddexp(z, floor), dim=1)
            logits.index_add_(0, self.group_barcode[g0:g1], z)
        return logits

    def mstep(self, probs: torch.Tensor) -> torch.Tensor:
        """The addition [V, D]: Σ over a variant's calls of (singlet posterior · (1−q))**power (demuxalot/demux.py:113-118)."""
        probs = probs.to(self.dtype)
        power = self.traffic["contribution_power"]
        addition = torch.zeros((self.n_variants, self.n_donors), dtype=self.dtype, device=self.device)
        for lo in range(0, self.n_calls, self.chunk):
            hi = lo + self.chunk
            weight = probs[self.cb[lo:hi], :self.n_donors] * (1 - self.q[lo:hi, None])
            addition.index_add_(0, self.vid[lo:hi], weight ** power)
        return addition
