"""The benchmark's own generator of the synthetic pool.

The numpy draws of ``demuxalot_tpu_torch.sim.synthesize_compressed_calls``,
frozen, in the same order from the same ``RandomState``, with two shapes of
real pools added: how many calls each barcode has, and which SNPs they
land on. With both shapes flat (``calls_per_barcode_sigma`` 0, ``snp_zipf``
0) one seed gives the same arrays as the port's generator (a test holds the
two together at a small size). It returns plain arrays: the program's input
objects are built from them by ``program.inputs`` and the plain reference
reads them directly. Numpy only.

The pool: every SNP has two alleles ("A" = 0, "C" = 1) and every donor
carries one of them; a barcode is one donor or, with ``doublets_fraction``,
two distinct donors, each call drawn from one of its donors' alleles, flipped
with ``flip_prob``, with a base error probability at a Phred score drawn
uniformly from ``phred``.

- Calls a barcode: log-normal with mean ``calls_per_barcode`` and log-scale
  ``calls_per_barcode_sigma``, as scRNA-seq library sizes are simulated
  (Splat, Zappia et al. 2017). Every seed gets the same sizes, the
  distribution's quantiles at (i + 1/2) / B, dealt to the barcodes in its
  own order, so the work does not change with the seed.
- SNP of a call: the SNP of rank r takes a share 1 / r ** ``snp_zipf`` of
  all calls, as transcripts' abundances fall with their rank (Zipf's law in
  gene expression, Furusawa and Kaneko 2003), so a barcode's calls pile
  onto the SNPs of its most expressed genes and its (barcode, SNP) groups
  hold several molecules. Which SNPs are expressed, and how much, belongs
  to the deployment (its panel and tissue), not to the seed: every seed has
  the same calls on each SNP, dealt to the barcodes in its own order. The
  panel puts rank r at position (r mod S/k)·k + r div S/k, k being
  ``snp_rank_stride``: the most expressed SNPs every k-th position from the
  start. Where they sit decides when the program's M-step, a warp a SNP
  run in position order, starts its longest runs; at random positions
  that moved with each sample's light runs, and the iteration's time with
  it, by up to 7% from seed to seed.
"""
from __future__ import annotations

from dataclasses import dataclass
from statistics import NormalDist

import numpy as np


@dataclass
class Draws:
    """One pool: donors' alleles and the molecule calls (one call a molecule), as drawn."""

    n_barcodes: int
    n_donors: int
    n_snps: int
    donor_allele: np.ndarray  # int [n_snps, n_donors]: the allele each donor carries
    cb: np.ndarray  # int32 [n_calls]: the barcode of every call
    snp: np.ndarray  # int32 [n_calls]: the SNP (its position on chr1) of every call
    allele: np.ndarray  # int64 [n_calls]: the base read, 0 ("A") or 1 ("C")
    q: np.ndarray  # float32 [n_calls]: the probability that the base is wrong

    @property
    def n_calls(self) -> int:
        return len(self.cb)


def random_state(seed: int) -> np.random.RandomState:
    """The seed's RandomState: the seed itself below 2**32 (as the port's generator takes it), else its two words."""
    seed = int(seed)
    if seed < 0:
        raise ValueError(f"seed must be >= 0, got {seed}")
    if seed < 2 ** 32:
        return np.random.RandomState(seed)
    return np.random.RandomState([seed & 0xFFFFFFFF, seed >> 32])


def shape_state(seed: int) -> np.random.RandomState:
    """The seed's second stream, for the order of the barcodes' sizes: apart, so the port's draws stay as they are."""
    seed = int(seed)
    return np.random.RandomState([seed & 0xFFFFFFFF, seed >> 32, 0x5EED])


def barcode_sizes(n_barcodes: int, mean: float, sigma: float, rng: np.random.RandomState) -> np.ndarray:
    """int64 [n_barcodes]: calls of each barcode, the log-normal's quantiles (at least 1) in ``rng``'s order."""
    if sigma == 0:
        return np.full(n_barcodes, int(mean), dtype=np.int64)
    unit = NormalDist()
    z = np.array([unit.inv_cdf((i + 0.5) / n_barcodes) for i in range(n_barcodes)])
    sizes = np.maximum(1, np.rint(mean * np.exp(sigma * z - sigma * sigma / 2))).astype(np.int64)
    return sizes[rng.permutation(n_barcodes)]


def snp_sizes(n_snps: int, n_calls: int, exponent: float, stride: int) -> np.ndarray:
    """int64 [n_snps]: calls on each SNP, the SNP of rank r taking n_calls / r ** exponent of the whole (by largest
    remainder), rank r at position (r mod n_snps / stride) · stride + r div (n_snps / stride)."""
    if n_snps % stride:
        raise ValueError(f"snp_rank_stride {stride} does not divide n_snps {n_snps}")
    weight = 1.0 / np.arange(1, n_snps + 1, dtype=np.float64) ** exponent
    share = n_calls * weight / weight.sum()
    by_rank = np.floor(share).astype(np.int64)
    by_rank[np.argsort(by_rank - share, kind="stable")[:n_calls - int(by_rank.sum())]] += 1
    rank = np.arange(n_snps)
    per = n_snps // stride
    sizes = np.empty(n_snps, dtype=np.int64)
    sizes[(rank % per) * stride + rank // per] = by_rank
    return sizes


def draw(n_barcodes: int, n_donors: int, n_snps: int, calls_per_barcode: int, doublets_fraction: float,
         flip_prob: float, phred: tuple, seed: int, calls_per_barcode_sigma: float = 0.0,
         snp_zipf: float = 0.0, snp_rank_stride: int = 1) -> Draws:
    """The pool of ``seed``: the draws of the port's ``synthesize_compressed_calls`` in its order, with the shapes."""
    rng, shapes = random_state(seed), shape_state(seed)
    donor_allele = rng.randint(0, 2, size=(n_snps, n_donors))
    primary = rng.randint(0, n_donors, size=n_barcodes)
    is_doublet = rng.rand(n_barcodes) < doublets_fraction
    secondary = (primary + 1 + rng.randint(0, n_donors - 1, size=n_barcodes)) % n_donors

    sizes = barcode_sizes(n_barcodes, calls_per_barcode, calls_per_barcode_sigma, shapes)
    n_calls = int(sizes.sum())
    cb = np.repeat(np.arange(n_barcodes, dtype=np.int32), sizes)
    use_secondary = is_doublet[cb] & (rng.rand(n_calls) < 0.5)
    call_donor = np.where(use_secondary, secondary[cb], primary[cb])
    if snp_zipf == 0:
        snp = rng.randint(0, n_snps, size=n_calls).astype(np.int32)
    else:
        per_snp = snp_sizes(n_snps, n_calls, snp_zipf, snp_rank_stride)
        snp = np.repeat(np.arange(n_snps, dtype=np.int32), per_snp)[rng.permutation(n_calls)]
    allele = donor_allele[snp, call_donor]
    flip = rng.rand(n_calls) < flip_prob
    allele = np.where(flip, 1 - allele, allele).astype(np.int64)
    q = (0.1 ** (0.1 * rng.randint(phred[0], phred[1] + 1, size=n_calls))).astype(np.float32)
    return Draws(n_barcodes, n_donors, n_snps, donor_allele, cb, snp, allele, q)


def draw_config(config: dict, seed: int) -> Draws:
    """The pool a configuration file describes."""
    if config["variants_per_snp"] != 2:
        raise ValueError(f"the pool has two variants a SNP, not {config['variants_per_snp']}")
    return draw(config["n_barcodes"], config["n_donors"], config["n_snps"], config["calls_per_barcode"],
                config["doublets_fraction"], config["flip_prob"], tuple(config["phred"]), seed,
                config["calls_per_barcode_sigma"], config["snp_zipf"], config["snp_rank_stride"])


def genotype_betas(draws: Draws, config: dict) -> np.ndarray:
    """float32 [2·n_snps, n_donors]: the donors' betas, variants in registration order (SNP, then "A", "C")."""
    betas = np.full((2 * draws.n_snps, draws.n_donors), config["other_allele_beta"], dtype=np.float32)
    rows = np.arange(draws.n_snps) * 2
    for donor in range(draws.n_donors):
        betas[rows + draws.donor_allele[:, donor], donor] = config["own_allele_beta"]
    return betas
