"""UMI-aware SNP evidence collection from coordinate-sorted BAM files.

The ingest stage: stream reads, bucket them into molecules (one molecule =
one (cell barcode, UMI) pair), and reduce each molecule's reads to a single
consensus base call per covered SNP position. The output — columnar
molecule/call tables per chromosome — is the host→device transfer format
consumed by the packing layer and the device kernels.

The counting half is a copy of ``demuxalot_tpu.frontend.snp_counter``; only
the fan-out differs: region tasks run on a ``concurrent.futures`` process
pool (spawned workers) instead of joblib, with the same reading of
``joblib_n_jobs``.

The probability chain is a hard numeric contract shared with the native C++
scanner and matching the reference engine (demuxalot/snp_counter.py:142-192):

  * reads with identical (start, end, alignment score) are duplicates and
    contribute once;
  * a molecule's misalignment probability is the product of its reads';
  * per (position, base), evidence multiplies as ``0.1 ** (0.1 * min(q, 40))``
    over supporting reads;
  * conflicting bases at one position survive only if every alternative is
    ≥1000× less likely; otherwise the position yields no call.

Scaling stance: the per-chromosome position index is a sorted array queried
by binary search — memory is O(n_SNPs), independent of chromosome length,
with no integer-width ceiling (a 250 Mb contig with millions of SNPs costs
a few MB). The C++ scanner (``demuxalot_tpu_torch.native.scanner``, built
from ``demuxalot_tpu_torch/native/scanner.cpp``) replaces the whole Python loop
when the standard tag filter is in use.
"""
from __future__ import annotations

import math
import multiprocessing
import os
import sys
from concurrent.futures import ProcessPoolExecutor
from pathlib import Path
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

from ..bamio import open_alignment
from ..utils.barcodes import BarcodeHandler
from ..utils.encoding import compress_base
from ..utils.files import as_str
from .cellranger import parse_read as default_parse_read

# a molecule's reads are assumed to span < this many bp; the streaming
# scanner settles molecule groups this far behind the read cursor.
# KEEP IN SYNC with demuxalot_tpu/native/scanner.cpp (kSegmentLength).
SEGMENT_LENGTH = 1000

MOLECULE_DTYPE = np.dtype(
    [("compressed_cb", "int32"), ("compressed_ub", "int32"), ("p_group_misaligned", "float32")]
)
SNP_CALL_DTYPE = np.dtype(
    [
        ("molecule_index", "int32"),
        ("snp_position", "int32"),
        ("base_index", "uint8"),
        ("p_base_wrong", "float32"),
    ]
)

# CIGAR op classes (SAM spec): which side(s) each op advances
_OPS_BOTH = frozenset((0, 7, 8))  # M, =, X
_OPS_REFERENCE_ONLY = frozenset((2, 3))  # D, N
_OPS_QUERY_ONLY = frozenset((1, 4))  # I, S
_OPS_NEITHER = frozenset((5, 6))  # H, P


def _aligned_spans(cigartuples, reference_start: int) -> Iterator[Tuple[int, int, int]]:
    """Decompose a CIGAR into (ref_lo, ref_hi, query_lo) aligned spans.

    Each yielded span is a maximal stretch where reference and query advance
    together; query offset of reference position p is
    ``query_lo + (p - ref_lo)``.
    """
    ref_cursor = reference_start
    query_cursor = 0
    for op, span in cigartuples:
        if op in _OPS_BOTH:
            yield ref_cursor, ref_cursor + span, query_cursor
            ref_cursor += span
            query_cursor += span
        elif op in _OPS_REFERENCE_ONLY:
            ref_cursor += span
        elif op in _OPS_QUERY_ONLY:
            query_cursor += span
        elif op not in _OPS_NEITHER:
            raise ValueError(f"unsupported CIGAR op code {op}")


class ChromosomeSNPLookup:
    """Sorted-position index for one chromosome's SNPs.

    Interval queries run by binary search over the position array itself —
    no chromosome-length tables, so memory is bounded by the number of SNPs
    and arbitrarily long contigs / arbitrarily many SNPs are fine.
    """

    __slots__ = ("positions",)

    def __init__(self, positions: np.ndarray):
        positions = np.asarray(positions)
        if len(positions) and (np.diff(positions) < 0).any():
            raise ValueError("SNP positions must be sorted ascending")
        self.positions = positions.astype(np.int64, copy=False)

    def snips_exist(self, start: int, end: int) -> bool:
        """Does any indexed position fall in the half-open window [start, end)?"""
        lo, hi = np.searchsorted(self.positions, [start, end])
        return hi > lo

    def get_snps(self, read) -> List[Tuple[int, str, int]]:
        """(position, base, quality) for every indexed position the read aligns over."""
        observations: List[Tuple[int, str, int]] = []
        sequence = None
        for ref_lo, ref_hi, query_lo in _aligned_spans(read.cigartuples, read.pos):
            lo, hi = np.searchsorted(self.positions, [ref_lo, ref_hi])
            if hi == lo:
                continue
            if sequence is None:
                sequence = read.seq
                qualities = read.query_qualities
            for position in self.positions[lo:hi]:
                at = query_lo + int(position) - ref_lo
                observations.append((int(position), sequence[at], qualities[at]))
        return observations


class CompressedSNPCalls:
    """Columnar per-chromosome store of molecules and their SNP calls.

    Two structured arrays (already SoA — they map directly to device arrays):
      molecules: (compressed_cb, compressed_ub, p_group_misaligned)
      snp_calls: (molecule_index, snp_position, base_index, p_base_wrong)
    """

    def __init__(self):
        self._molecule_rows: list = []
        self._call_rows: list = []
        self.molecules = np.empty(0, dtype=MOLECULE_DTYPE)
        self.snp_calls = np.empty(0, dtype=SNP_CALL_DTYPE)
        self._finalized = False

    @classmethod
    def from_arrays(cls, molecules: np.ndarray, snp_calls: np.ndarray) -> "CompressedSNPCalls":
        """Finalized store over existing structured arrays (copied)."""
        result = cls()
        result.molecules = np.ascontiguousarray(molecules, dtype=MOLECULE_DTYPE).copy()
        result.snp_calls = np.ascontiguousarray(snp_calls, dtype=SNP_CALL_DTYPE).copy()
        result._finalized = True
        return result

    @property
    def n_molecules(self) -> int:
        return len(self.molecules) if self._finalized else len(self._molecule_rows)

    @property
    def n_snp_calls(self) -> int:
        return len(self.snp_calls) if self._finalized else len(self._call_rows)

    def add_calls_from_read_group(self, compressed_cb, compressed_ub, p_group_misaligned, snps) -> None:
        assert not self._finalized, "cannot append after finalization"
        molecule_index = len(self._molecule_rows)
        self._molecule_rows.append((compressed_cb, compressed_ub, p_group_misaligned))
        for reference_position, base, p_base_wrong in snps:
            self._call_rows.append((molecule_index, reference_position, compress_base(base), p_base_wrong))

    def minimize_memory_footprint(self) -> None:
        """Finalize the growable builders into compact structured arrays."""
        if self._finalized:
            return
        self.molecules = np.array(self._molecule_rows, dtype=MOLECULE_DTYPE)
        self.snp_calls = np.array(self._call_rows, dtype=SNP_CALL_DTYPE)
        self._molecule_rows = []
        self._call_rows = []
        self._finalized = True

    def save(self, path) -> None:
        """Serialize to .npz (counting is expensive; results are reusable)."""
        self.minimize_memory_footprint()
        np.savez_compressed(path, molecules=self.molecules, snp_calls=self.snp_calls)

    @staticmethod
    def load(path) -> "CompressedSNPCalls":
        data = np.load(path)
        result = CompressedSNPCalls()
        result.molecules = data["molecules"].view(MOLECULE_DTYPE).reshape(-1)
        result.snp_calls = data["snp_calls"].view(SNP_CALL_DTYPE).reshape(-1)
        result._finalized = True
        return result

    @staticmethod
    def concatenate(snp_calls_list: List["CompressedSNPCalls"]) -> "CompressedSNPCalls":
        """Merge call sets from the same chromosome, re-basing molecule indices."""
        n_molecules = 0
        collected_calls = []
        collected_molecules = []
        for calls in snp_calls_list:
            calls.minimize_memory_footprint()
            variant_calls = calls.snp_calls.copy()
            variant_calls["molecule_index"] += n_molecules
            collected_calls.append(variant_calls)
            collected_molecules.append(calls.molecules)
            n_molecules += calls.n_molecules

        result = CompressedSNPCalls()
        result.molecules = (
            np.concatenate(collected_molecules) if collected_molecules else np.empty(0, MOLECULE_DTYPE)
        )
        result.snp_calls = (
            np.concatenate(collected_calls) if collected_calls else np.empty(0, SNP_CALL_DTYPE)
        )
        result._finalized = True
        return result


_EVIDENCE_STRENGTH = tuple(0.1 ** (0.1 * min(q, 40)) for q in range(256))


def _evidence_strength(quality: int) -> float:
    """Per-observation error probability factor from a phred base quality.

    Table-driven (decoded qualities are single bytes); entries are the
    exact ``0.1 ** (0.1 * min(q, 40))`` doubles the reference chain
    multiplies. Out-of-range ints (possible from user-constructed reads)
    fall back to the formula, bit-identical for every int.
    """
    if 0 <= quality:
        return _EVIDENCE_STRENGTH[quality if quality < 41 else 40]
    return 0.1 ** (0.1 * quality)


def _undisputed_base(per_base: Dict[str, float]) -> Optional[Tuple[str, float]]:
    """The single credible base at a position, or None if genuinely disputed.

    A molecule is one physical cDNA: seeing several bases means RT/PCR or
    sequencing artifacts. Alternatives ≥1000× less likely than the best
    candidate are discarded; anything still plural makes no call.
    """
    if len(per_base) > 1:
        cutoff = min(per_base.values()) * 1000
        per_base = {base: p for base, p in per_base.items() if p <= cutoff}
    if len(per_base) != 1:
        return None
    ((base, p_wrong),) = per_base.items()
    return base, p_wrong


def consensus_call_molecule(
    read_records,
    snp_lookup: ChromosomeSNPLookup,
    skip_complete_duplicates: bool = True,
) -> Tuple[float, list]:
    """Reduce one molecule's reads to (p_misaligned, [(pos, base, p_wrong)]).

    ``read_records`` is a list of (read, p_misaligned) pairs sharing a
    (cell barcode, UMI) identity. See the module docstring for the numeric
    contract this implements.
    """
    p_misaligned_product = 1.0
    alignment_fingerprints = set()
    evidence: Dict[int, Dict[str, float]] = {}

    for read, p_misaligned in read_records:
        if skip_complete_duplicates:
            fingerprint = (read.reference_start, read.reference_end, read.get_tag("AS"))
            if fingerprint in alignment_fingerprints:
                continue
            alignment_fingerprints.add(fingerprint)
        p_misaligned_product *= p_misaligned
        for position, base, quality in snp_lookup.get_snps(read):
            per_base = evidence.setdefault(position, {})
            per_base[base] = per_base.get(base, 1.0) * _evidence_strength(quality)

    consensus = []
    for position, per_base in evidence.items():
        resolved = _undisputed_base(per_base)
        if resolved is not None:
            consensus.append((position, *resolved))
    return p_misaligned_product, consensus


def _settle_molecules_behind(
    frontier: float,
    open_molecules: dict,
    snp_lookup: ChromosomeSNPLookup,
    sink: CompressedSNPCalls,
) -> None:
    """Consensus-call and evict molecules no future read can extend.

    A molecule is settled once its furthest read end is behind ``frontier``
    (the stream cursor minus SEGMENT_LENGTH): the BAM is coordinate-sorted,
    so every later read starts past that point.
    """
    settled = [key for key, (furthest_end, _) in open_molecules.items() if furthest_end < frontier]
    for key in settled:
        _, records = open_molecules.pop(key)
        leftmost = min(read.reference_start for read, _ in records)
        rightmost = max(read.reference_end for read, _ in records)
        if not snp_lookup.snips_exist(leftmost, rightmost + 1):
            continue
        p_misaligned, consensus = consensus_call_molecule(records, snp_lookup)
        if consensus:
            barcode_slot, umi_code = key
            sink.add_calls_from_read_group(barcode_slot, umi_code, p_misaligned, consensus)


def count_call_variants_for_chromosome(
    bamfile_or_filename,
    chromosome: str,
    chromosome_snps_zero_based: np.ndarray,
    barcode_handler: BarcodeHandler,
    parse_read,
    start: Optional[int] = None,
    stop: Optional[int] = None,
) -> Tuple[str, CompressedSNPCalls]:
    """Stream one region of one chromosome into compressed SNP calls.

    Single pass over the fetch iterator: whitelisted reads accumulate into
    open molecule groups keyed by (barcode slot, UMI); every SEGMENT_LENGTH
    of stream progress the groups left behind are consensus-called and
    evicted, bounding resident memory by read depth, not region size.
    """
    if isinstance(bamfile_or_filename, (str, Path)):
        bamfile_or_filename = open_alignment(as_str(bamfile_or_filename))
    snp_lookup = ChromosomeSNPLookup(chromosome_snps_zero_based)
    collected = CompressedSNPCalls()
    open_molecules: dict = {}
    current_segment = None

    for read in bamfile_or_filename.fetch(chromosome, start=start, stop=stop):
        verdict = parse_read(read)
        if verdict is None:
            continue
        barcode_slot = barcode_handler.get_barcode_index(read)
        if barcode_slot is None:
            continue
        p_misaligned, umi_code = verdict

        group = open_molecules.get((barcode_slot, umi_code))
        if group is None:
            open_molecules[barcode_slot, umi_code] = [read.reference_end, [(read, p_misaligned)]]
        else:
            group[0] = max(group[0], read.reference_end)
            group[1].append((read, p_misaligned))

        segment = read.pos // SEGMENT_LENGTH
        if segment != current_segment:
            _settle_molecules_behind(
                read.pos - SEGMENT_LENGTH, open_molecules, snp_lookup, collected
            )
            current_segment = segment

    _settle_molecules_behind(math.inf, open_molecules, snp_lookup, collected)
    collected.minimize_memory_footprint()
    return chromosome, collected


def save_snp_counts(chromosome2calls: Dict[str, CompressedSNPCalls], directory) -> None:
    """Persist a count_snps result, one .npz per chromosome."""
    directory = Path(directory)
    directory.mkdir(parents=True, exist_ok=True)
    for chromosome, calls in chromosome2calls.items():
        calls.save(directory / f"{chromosome}.calls.npz")


def load_snp_counts(directory) -> Dict[str, CompressedSNPCalls]:
    """Load a directory written by :func:`save_snp_counts`."""
    directory = Path(directory)
    result = {}
    for path in sorted(directory.glob("*.calls.npz")):
        chromosome = path.name[: -len(".calls.npz")]
        result[chromosome] = CompressedSNPCalls.load(path)
    return result


def _n_workers(n_jobs) -> int:
    """Worker count for joblib's ``n_jobs``: None → 1, -1 → every core, -2 → all but one."""
    if n_jobs is None:
        return 1
    if n_jobs == 0:
        raise ValueError("n_jobs == 0 has no meaning")
    if n_jobs < 0:
        return max(1, (os.cpu_count() or 1) + 1 + n_jobs)
    return int(n_jobs)


def _count_task(task, parse_read) -> Tuple[str, CompressedSNPCalls]:
    bamfile, chromosome, start, stop, positions, task_barcode_handler = task
    return count_call_variants_for_chromosome(
        bamfile, chromosome, positions, start=start, stop=stop,
        barcode_handler=task_barcode_handler, parse_read=parse_read,
    )


def _run_counting_tasks(tasks: list, parse_read, n_jobs, verbosity: int) -> list:
    """Results of :func:`_count_task` in task order, inline or on spawned workers."""
    n_workers = min(_n_workers(n_jobs), len(tasks))
    if n_workers <= 1:
        results = [_count_task(task, parse_read) for task in tasks]
    else:
        # spawn, not fork: the parent may hold threads (torch, thread pools)
        context = multiprocessing.get_context("spawn")
        with ProcessPoolExecutor(max_workers=n_workers, mp_context=context) as pool:
            futures = [pool.submit(_count_task, task, parse_read) for task in tasks]
            results = [future.result() for future in futures]
    if verbosity > 0:
        print(f"[count_snps] {len(results)} region shards counted on {max(n_workers, 1)} worker(s)",
              file=sys.stderr)
    return results


def count_snps(
    bamfile_location,
    chromosome2positions: Dict[str, np.ndarray],
    barcode_handler: BarcodeHandler,
    joblib_n_jobs=-1,
    joblib_verbosity=11,
    parse_read=default_parse_read,
    native: Optional[bool] = None,
) -> Dict[str, CompressedSNPCalls]:
    """Collect molecule-level SNP evidence from a BAM file.

    :param bamfile_location: path to a coordinate-sorted, indexed BAM — or a
        dict mapping RG values to paths when barcodes carry RG identity
    :param chromosome2positions: SNP positions of interest per chromosome
    :param barcode_handler: whitelist of cell barcodes
    :param joblib_n_jobs: process fan-out for region shards, read as joblib
        reads ``n_jobs`` (None or 1 = inline, -1 = every core)
    :param joblib_verbosity: above 0, a stderr line when the shards are counted
    :param parse_read: read-filtering plugin (see frontend.cellranger)
    :param native: use the C++ scanner when available (None = auto). The
        native path requires the default cellranger-style ``parse_read``
        (tag names/thresholds are forwarded); custom callables fall back to
        the Python scanner.
    :return: per-chromosome compressed calls, consumable by the Demultiplexer
    """
    if native is not False:
        from .native_counter import try_count_snps_native

        result = try_count_snps_native(
            bamfile_location, chromosome2positions, barcode_handler,
            parse_read=parse_read, n_jobs=joblib_n_jobs, required=(native is True),
        )
        if result is not None:
            return result

    tasks = prepare_counting_tasks(bamfile_location, chromosome2positions, barcode_handler=barcode_handler)
    shard_results = _run_counting_tasks(tasks, parse_read, joblib_n_jobs, joblib_verbosity)

    shards_by_chromosome: Dict[str, List[CompressedSNPCalls]] = {}
    for chromosome, calls in shard_results:
        shards_by_chromosome.setdefault(chromosome, []).append(calls)
    return {
        chromosome: CompressedSNPCalls.concatenate(shards)
        for chromosome, shards in shards_by_chromosome.items()
    }


def prepare_counting_tasks(
    bamfile_location,
    chromosome2positions: Dict[str, np.ndarray],
    barcode_handler: BarcodeHandler,
    n_reads_per_job: int = 10_000_000,
    minimum_fragment_length_per_job: int = 5_000,
    minimum_overlap: int = 100,
) -> list:
    """Carve the counting work into region tasks, costliest first.

    Each chromosome's position list is cut into contiguous stripes sized so
    one stripe sees roughly ``n_reads_per_job`` reads (uniform-density
    estimate from the BAM index) and spans at least
    ``minimum_fragment_length_per_job`` bp. Task windows get
    ``minimum_overlap`` bp margins so molecules straddling a cut are seen
    whole by the side that owns their positions.

    Task tuples: (bamfile, chromosome, start, stop, positions, handler).
    """
    if isinstance(bamfile_location, dict):
        # one BAM per read group: plan each file against the whitelist
        # restricted to its group (slot numbering is shared, see
        # BarcodeHandler.filter_to_rg_value)
        if not barcode_handler.use_rg:
            raise ValueError("dict-of-BAMs input needs an RG-aware barcode handler")
        tasks = []
        for rg in sorted({rg for _barcode, rg in barcode_handler.barcode2index}):
            if rg not in bamfile_location:
                raise KeyError(f"whitelist read group {rg!r} has no BAM path")
            tasks.extend(
                prepare_counting_tasks(
                    bamfile_location[rg],
                    chromosome2positions,
                    barcode_handler=barcode_handler.filter_to_rg_value(rg),
                    n_reads_per_job=n_reads_per_job,
                    minimum_fragment_length_per_job=minimum_fragment_length_per_job,
                    minimum_overlap=minimum_overlap,
                )
            )
        return tasks

    weighted_tasks = []
    with open_alignment(as_str(bamfile_location)) as reader:
        mapped_reads = {stat.contig: stat.mapped for stat in reader.get_index_statistics()}
        for chromosome, positions in chromosome2positions.items():
            positions = np.asarray(positions)
            if len(positions) == 0:
                continue
            length = reader.get_reference_length(chromosome)
            density = mapped_reads.get(chromosome, 0) / max(length, 1)

            n_stripes = max(
                1,
                min(
                    mapped_reads.get(chromosome, 0) // n_reads_per_job,
                    length // minimum_fragment_length_per_job,
                ),
            )
            for stripe in np.array_split(positions, min(n_stripes, len(positions))):
                if len(stripe) == 0:
                    continue
                start = max(0, int(stripe[0]) - minimum_overlap)
                stop = min(length, int(stripe[-1]) + minimum_overlap)
                task = (bamfile_location, chromosome, start, stop, stripe, barcode_handler)
                # schedule dense, SNP-rich windows first so stragglers finish early
                estimated_reads = density * max(stop - start, 1)
                weighted_tasks.append((estimated_reads * math.sqrt(len(stripe)), task))

    weighted_tasks.sort(key=lambda pair: pair[0], reverse=True)
    return [task for _cost, task in weighted_tasks]
