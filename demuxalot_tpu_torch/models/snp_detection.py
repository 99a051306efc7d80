"""Discovery of new donor-discriminative SNP positions from the data.

Starting from loosely known genotypes, the pipeline is
(reference surface: demuxalot/snp_detection.py:128-215):

1. demultiplex provisionally — count at the known positions and take every
   barcode whose posterior concentrates (>0.8) on one donor (doublets off);
   this forward runs the E-step kernel on ``Demultiplexer.device``;
2. sweep the genome in parallel fragments: a pileup proposes biallelic
   candidate sites, the UMI-aware counter re-counts them, and each site is
   scored by how far individual donors' allele fractions sit from the
   pooled fraction (confident, divergent sites score high);
3. keep the best sites per donor plus the best overall, drop positions the
   genotypes already know, and export the rest as a positions-only parquet
   that ``add_prior_betas`` registers as zero-weight variants for the next
   EM round.

The scan is host-side streaming. Where the C++ scanner carries it (pileup
and recount), fragments run on threads, since ctypes releases the GIL;
otherwise on spawned worker processes (never forked: the provisional pass
has initialised the device), so ``parse_read`` must then be picklable. The
host logic is the numpy code of ``demuxalot_tpu.models.snp_detection``.
"""
from __future__ import annotations

import multiprocessing
import sys
from collections import Counter, defaultdict
from concurrent.futures import ProcessPoolExecutor, ThreadPoolExecutor
from pathlib import Path
from typing import Dict, Tuple

import numpy as np

from ..bamio import open_alignment, sniff_format
from ..frontend import cellranger
from ..frontend.snp_counter import CompressedSNPCalls, _n_workers, count_snps
from ..utils.barcodes import BarcodeHandler
from ..utils.files import as_str
from .demux import Demultiplexer
from .genotypes import ProbabilisticGenotypes


def _bam_paths(bamfile_location) -> list:
    if isinstance(bamfile_location, (str, Path)):
        return [bamfile_location]
    return list(bamfile_location.values())


def _filtered_pileup(bamfile_path, chromosome: str, start: int, stop: int, parse_read) -> np.ndarray:
    """ACGT coverage over [start, stop) counting only reads the filter accepts.

    Sums over all source files for dict-of-BAMs inputs; uses the C++ pileup
    when the standard tag filter is in use.
    """
    from ..frontend.native_counter import try_count_coverage_native

    total = np.zeros((4, stop - start), dtype=np.int64)
    for path in _bam_paths(bamfile_path):
        native = try_count_coverage_native(as_str(path), chromosome, start, stop, parse_read)
        if native is not None:
            total += np.asarray(native, dtype=np.int64)
            continue
        with open_alignment(as_str(path)) as bamfile:
            total += np.asarray(
                bamfile.count_coverage(
                    chromosome, start=start, stop=stop,
                    read_callback=lambda read: parse_read(read) is not None,
                ),
                dtype=np.int64,
            )
    return total


def _biallelic_candidates(
    coverage: np.ndarray,
    *,
    minimum_coverage: int,
    minimum_alternative_fraction: float,
    minimum_alternative_coverage: int,
    minimum_fraction_of_ref_and_alt: float,
    max_snp_candidates: int,
) -> np.ndarray:
    """Offsets (into the pileup window) of plausible biallelic sites.

    A site qualifies when its two dominant bases carry nearly all coverage,
    are deep enough, and the minor base is both deep and a sufficient
    fraction of the major one. Over-long candidate lists keep the sites
    with the strongest minor-allele support.
    """
    depth = coverage.sum(axis=0)
    ranked = np.sort(coverage, axis=0)
    major, minor = ranked[-1], ranked[-2]
    biallelic_depth = major + minor

    passes = (
        (biallelic_depth > minimum_coverage)
        & (biallelic_depth > minimum_fraction_of_ref_and_alt * depth)
        & (minor > minimum_alternative_coverage)
        & (minor > major * minimum_alternative_fraction)
    )
    offsets = np.flatnonzero(passes)
    if len(offsets) > max_snp_candidates:
        strongest = np.argsort(minor * passes)[-max_snp_candidates:]
        offsets = np.sort(strongest)
    return offsets


def _donor_base_tables(
    snp_calls: CompressedSNPCalls,
    barcode_handler,
    barcode2donor: dict,
    donor2dindex: dict,
    max_contribution_to_base_count_from_barcode: float = 3.0,
) -> Dict[int, np.ndarray]:
    """position -> [n_donors, 4] base-count table from confident calls.

    One barcode's repeated votes for the same (position, base) are capped
    so a single deep cell cannot dominate a site. Vectorized: confident
    A/C/G/T calls are grouped by (barcode, position, base) with a sort, the
    group counts clipped, then accumulated per (position, donor, base).
    Calls of 'N' (base code 4) carry no allele information and are dropped
    — the reference would crash on them (demuxalot/snp_detection.py:117-124).
    """
    snp_calls.minimize_memory_footprint()
    calls = snp_calls.snp_calls
    confident = calls[(calls["p_base_wrong"] < 0.01) & (calls["base_index"] < 4)]
    tables: Dict[int, np.ndarray] = defaultdict(lambda: np.zeros([len(donor2dindex), 4], dtype="int32"))
    if len(confident) == 0:
        return tables

    # barcode slot -> donor index (-1 = unassigned / not provisional)
    slot2donor = np.full(barcode_handler.n_barcodes, -1, dtype=np.int64)
    for barcode, donor in barcode2donor.items():
        slot = barcode_handler.barcode2index.get(barcode)
        if slot is not None:
            slot2donor[slot] = donor2dindex[donor]

    barcode_of_call = snp_calls.molecules["compressed_cb"][confident["molecule_index"]].astype(np.int64)
    position_of_call = confident["snp_position"].astype(np.int64)
    base_of_call = confident["base_index"].astype(np.int64)

    # group by (barcode, position, base); cap each group's vote
    vote_key = (barcode_of_call * (position_of_call.max() + 1) + position_of_call) * 4 + base_of_call
    order = np.argsort(vote_key, kind="stable")
    ordered_keys = vote_key[order]
    head = np.flatnonzero(np.concatenate([[True], ordered_keys[1:] != ordered_keys[:-1]]))
    votes = np.diff(np.append(head, len(ordered_keys))).astype(np.float64)
    capped = np.minimum(votes, max_contribution_to_base_count_from_barcode)

    representative = order[head]
    donor_of_group = slot2donor[barcode_of_call[representative]]
    assigned = donor_of_group >= 0
    group_pos = position_of_call[representative][assigned]
    group_base = base_of_call[representative][assigned]
    group_donor = donor_of_group[assigned]
    group_vote = capped[assigned].astype(np.int32)

    by_position = np.argsort(group_pos, kind="stable")
    sorted_pos = group_pos[by_position]
    run_heads = np.flatnonzero(np.concatenate([[True], sorted_pos[1:] != sorted_pos[:-1]]))
    for i, lo in enumerate(run_heads):
        hi = run_heads[i + 1] if i + 1 < len(run_heads) else len(sorted_pos)
        members = by_position[lo:hi]
        np.add.at(
            tables[int(sorted_pos[lo])],
            (group_donor[members], group_base[members]),
            group_vote[members],
        )
    return tables


def _site_score(counts: np.ndarray, regularization: float) -> Tuple[np.ndarray, dict]:
    """Per-donor divergence score and the two dominant bases' total counts.

    Restricting to the two dominant bases, each donor's smoothed minor-base
    fraction is compared to the pooled fraction; the squared gap is the
    score. 1.0 would be total confidence and total divergence — in practice
    0.4 is already an excellent site.
    """
    dominant = minor_base, major_base = np.argsort(counts.sum(axis=0))[-2:]
    base_totals = {
        "ACGT"[major_base]: counts[:, major_base].sum(),
        "ACGT"[minor_base]: counts[:, minor_base].sum(),
    }

    pair = counts[:, dominant] + 1e-4  # columns: (minor, major)
    minor_total, major_total = pair.sum(axis=0)
    pooled_major_fraction = major_total / (major_total + minor_total)
    donor_major_fraction = (pair[:, 1] + pooled_major_fraction * regularization) / (
        pair.sum(axis=1) + regularization
    )
    return np.square(pooled_major_fraction - donor_major_fraction), base_totals


def detect_snps_for_chromosome(
    bamfile_path,
    chromosome: str,
    start: int,
    stop: int,
    sorted_donors,
    barcode2donor: dict,
    parse_read,
    barcode_handler: BarcodeHandler,
    regularization: float,
    minimum_coverage: int,
    minimum_alternative_fraction: float,
    minimum_alternative_coverage: int,
    max_snp_candidates: int = 10000,
    minimum_fraction_of_ref_and_alt: float = 0.98,
) -> list:
    """Scan one genomic fragment; return scored candidate sites.

    Each result row is (chromosome, position, per-donor score vector,
    dominant-base counts dict).
    """
    coverage = _filtered_pileup(bamfile_path, chromosome, start, stop, parse_read)
    offsets = _biallelic_candidates(
        coverage,
        minimum_coverage=minimum_coverage,
        minimum_alternative_fraction=minimum_alternative_fraction,
        minimum_alternative_coverage=minimum_alternative_coverage,
        minimum_fraction_of_ref_and_alt=minimum_fraction_of_ref_and_alt,
        max_snp_candidates=max_snp_candidates,
    )
    # pileup offsets are window-relative; genomic positions are absolute
    candidate_positions = offsets + start

    recounted = count_snps(
        bamfile_path,
        chromosome2positions={chromosome: candidate_positions},
        barcode_handler=barcode_handler,
        parse_read=parse_read,
        joblib_n_jobs=None,  # this already runs inside a fragment worker
        joblib_verbosity=0,
    )
    if chromosome not in recounted:
        return []
    donor2dindex = {donor: dindex for dindex, donor in enumerate(sorted_donors)}
    tables = _donor_base_tables(recounted[chromosome], barcode_handler, barcode2donor, donor2dindex)
    return [
        (chromosome, position) + _site_score(counts, regularization)
        for position, counts in tables.items()
    ]


def _pick_informative_sites(scored_sites: list, n_additional_best_snps: int, n_best_snps_per_donor: int) -> list:
    """Union of each donor's best sites and the best sites overall."""
    scores = np.stack([score for _chrom, _pos, score, _bases in scored_sites], axis=0)
    chosen = set()
    for donor_column in scores.T:
        k = min(n_best_snps_per_donor, len(donor_column))
        chosen.update(np.argpartition(-donor_column, k - 1)[:k].tolist())

    extras_taken = 0
    for site in np.argsort(-scores.sum(axis=1)):
        if extras_taken >= n_additional_best_snps:
            break
        if site not in chosen:
            chosen.add(int(site))
            extras_taken += 1
    return [scored_sites[site] for site in sorted(chosen)]


def _write_positions_parquet(selected_sites: list, prior_filename) -> None:
    """Positions-only checkpoint: rows with a (CHROM, POS, BASE) index and
    zero donor columns, which add_prior_betas registers as zero-weight
    variants."""
    import pandas as pd

    rows = [
        (chromosome, position, base)
        for chromosome, position, _score, base_totals in selected_sites
        for base in base_totals
    ]
    frame = pd.DataFrame(rows, columns=["CHROM", "POS", "BASE"]).set_index(["CHROM", "POS", "BASE"])
    frame.to_parquet(prior_filename)


def _print_donor_counts(barcode2donor: dict) -> None:
    import pandas as pd

    print("confidently assigned barcodes per donor:")
    print(pd.Series(Counter(barcode2donor.values())).sort_index())


def _native_scan_applies(bamfile_location, barcode_handler, parse_read) -> bool:
    """Whether the fragment scans run on the C++ scanner (pileup and recount)."""
    from ..native import load_library
    from ..native.scanner import _extract_parse_params

    if _extract_parse_params(parse_read) is None:
        return False
    if barcode_handler.use_rg and not isinstance(bamfile_location, dict):
        return False  # the native recount does not read RG tags
    if any(sniff_format(as_str(path)) != "bam" for path in _bam_paths(bamfile_location)):
        return False
    try:
        load_library()
    except (OSError, RuntimeError):  # no g++, zlib or a failed build or load
        return False
    return True


def _scan_fragments(jobs: list, n_jobs, verbosity: int, native: bool) -> list:
    """:func:`detect_snps_for_chromosome` of every job, in job order."""
    n_workers = min(_n_workers(n_jobs), len(jobs))
    if n_workers <= 1:
        results = [detect_snps_for_chromosome(**job) for job in jobs]
    else:
        pool = (
            ThreadPoolExecutor(max_workers=n_workers) if native
            else ProcessPoolExecutor(max_workers=n_workers, mp_context=multiprocessing.get_context("spawn"))
        )
        with pool:
            futures = [pool.submit(detect_snps_for_chromosome, **job) for job in jobs]
            results = [future.result() for future in futures]
    if verbosity > 0:
        kind = "threads" if native else "processes"
        print(f"[detect_snps] {len(jobs)} fragments scanned on {max(n_workers, 1)} {kind}", file=sys.stderr)
    return results


def detect_snps_positions(
    bamfile_location: str,
    genotypes: ProbabilisticGenotypes,
    barcode_handler: BarcodeHandler,
    *,
    minimum_coverage: int,
    minimum_alternative_fraction: float = 0.01,
    minimum_alternative_coverage: int = 100,
    n_best_snps_per_donor: int = 100,
    n_additional_best_snps: int = 1000,
    regularization: float = 3.0,
    parse_read=cellranger.parse_read,
    joblib_n_jobs=-1,
    result_beta_prior_filename=None,
    ignore_known_snps: bool = True,
    max_fragment_step: int = 10_000_000,
    joblib_verbosity=11,
) -> list:
    """Detect SNPs from the data, starting from loosely known genotypes.

    Returns the selected (chromosome, position, score, base counts) rows;
    optionally exports them for the next refinement round.
    ``joblib_n_jobs`` is read as joblib reads ``n_jobs`` (None or 1 =
    inline, -1 = every core) for both the counting and the fragment scan.
    """
    # provisional demultiplexing at the already-known positions
    known_site_calls = count_snps(
        bamfile_location=bamfile_location,
        chromosome2positions=genotypes.get_chromosome2positions(),
        barcode_handler=barcode_handler,
        joblib_n_jobs=joblib_n_jobs,
        parse_read=parse_read,
        joblib_verbosity=joblib_verbosity,
    )
    _logits, posteriors, column_names = Demultiplexer.predict_posteriors_core(
        known_site_calls,
        genotypes=genotypes,
        barcode_handler=barcode_handler,
        doublet_prior=0.0,
    )
    posteriors = posteriors.cpu().numpy()
    decisive = posteriors.max(axis=1) > 0.8
    best = posteriors.argmax(axis=1)  # the first maximum, as pandas' idxmax
    barcode2donor = {
        barcode: column_names[best[slot]]
        for slot, barcode in enumerate(barcode_handler.ordered_barcodes)
        if decisive[slot]
    }
    _print_donor_counts(barcode2donor)

    # genome-wide fragment scan driven by the provisional assignments
    with open_alignment(as_str(_bam_paths(bamfile_location)[0])) as reader:
        contigs = [
            (stat.contig, reader.get_reference_length(stat.contig))
            for stat in reader.get_index_statistics()
        ]
    sorted_donors = np.unique(list(barcode2donor.values()))

    fragment_jobs = [
        dict(
            bamfile_path=bamfile_location,
            chromosome=chromosome,
            start=fragment_start,
            stop=min(fragment_start + max_fragment_step, contig_length),
            barcode2donor=barcode2donor,
            parse_read=parse_read,
            sorted_donors=sorted_donors,
            minimum_coverage=minimum_coverage,
            minimum_alternative_coverage=minimum_alternative_coverage,
            minimum_alternative_fraction=minimum_alternative_fraction,
            barcode_handler=barcode_handler,
            regularization=regularization,
        )
        for chromosome, contig_length in contigs
        for fragment_start in range(0, contig_length, max_fragment_step)
    ]
    native = _native_scan_applies(bamfile_location, barcode_handler, parse_read)
    per_fragment_results = _scan_fragments(fragment_jobs, joblib_n_jobs, joblib_verbosity, native)

    scored_sites = [site for fragment in per_fragment_results for site in fragment]
    if not scored_sites:
        print("no candidate site passed the thresholds")
        return []
    selected = _pick_informative_sites(scored_sites, n_additional_best_snps, n_best_snps_per_donor)

    if ignore_known_snps:
        already_known = genotypes.get_snp_positions_set()
        selected = [
            site for site in selected if (site[0], site[1]) not in already_known
        ]

    if result_beta_prior_filename is not None:
        _write_positions_parquet(selected, result_beta_prior_filename)
    return selected
