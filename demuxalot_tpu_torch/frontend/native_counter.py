"""Hooks for the C++ bulk BAM scanner (after ``demuxalot_tpu.frontend.native_counter``).

The native scanner (``demuxalot_tpu_torch.native``) fuses BGZF decompression, record
decoding, read filtering, molecule grouping, and consensus calling into one
C++ pass — replacing the per-read Python loop on the hot ingest path — and
counts the coverage pileup of SNP discovery. This module loads it when
built and falls back to the Python paths where it cannot apply.
"""
from __future__ import annotations

from typing import Dict

import numpy as np


def try_count_coverage_native(bamfile_path, chromosome, start, stop, parse_read,
                              quality_threshold: int = 15, required: bool = False):
    """Native A/C/G/T pileup over [start, stop), or None for the Python pileup.

    None only where the JAX package's counter declines too: a non-BAM
    input, a custom ``parse_read`` (the native path only encodes the
    standard tag-based filter) or no scanner library; with ``required``
    those raise instead. Unlike the JAX wrapper, a native failure mid-scan
    raises rather than falling back. The counts equal
    ``BamReader.count_coverage`` with the same filter, bit for bit.
    """
    from ..bamio import sniff_format

    if sniff_format(str(bamfile_path)) == "bam":
        from ..native import scanner

        counts = scanner.try_count_coverage_native(
            bamfile_path, chromosome, start, stop, parse_read, quality_threshold=quality_threshold,
        )
        if counts is not None:
            return counts
        reason = "the standard tag-based parse_read and a buildable C++ scanner"
    else:
        reason = "BAM input (the C++ scanner reads BGZF/BAM only)"
    if required:
        raise RuntimeError(f"the native pileup of {bamfile_path} needs {reason}")
    return None


def try_count_snps_native(
    bamfile_location,
    chromosome2positions: Dict[str, np.ndarray],
    barcode_handler,
    parse_read,
    n_jobs,
    required: bool = False,
):
    """Return per-chromosome CompressedSNPCalls via the C++ scanner, or None.

    Falls back (returns None) when the native library is not built, when a
    custom ``parse_read`` callable is in use (the native path only encodes
    the standard tag-based filter), or when barcode identity includes the RG
    tag on a single merged BAM (the C++ scanner does not read RG; multi-BAM
    dict inputs are fine because the task planner hands each file a plain
    string-keyed whitelist).
    """
    if barcode_handler.use_rg and not isinstance(bamfile_location, dict):
        if required:
            raise RuntimeError(
                "native=True cannot scan a single merged BAM with RG-based "
                "barcode identities; pass a {rg: path} dict or use native=False"
            )
        return None
    # the C++ scanner reads BGZF/BAM only; SAM inputs (accepted by the
    # Python scanner via bamio.open_alignment) fall back, CRAM fails with
    # the curated conversion message either way
    from ..bamio import sniff_format

    paths = (
        list(bamfile_location.values())
        if isinstance(bamfile_location, dict) else [bamfile_location]
    )
    kind_by_path = {str(p): sniff_format(str(p)) for p in paths}
    kinds = set(kind_by_path.values())
    if "cram" in kinds:
        from ..bamio.sam import CRAM_UNSUPPORTED_MESSAGE

        bad = next(p for p, k in kind_by_path.items() if k == "cram")
        raise ValueError(CRAM_UNSUPPORTED_MESSAGE.format(path=bad))
    if kinds != {"bam"}:
        if required:
            raise RuntimeError(
                "native=True requires BAM input (the C++ scanner reads "
                "BGZF/BAM only); convert SAM with `samtools view -b` or use "
                "native=False"
            )
        return None
    try:
        from ..native import load_library, scanner

        load_library()  # builds on demand; may fail without a toolchain
    except Exception as e:
        if required:
            raise RuntimeError(
                f"native=True requested but the C++ scanner is unavailable: {e}"
            )
        return None
    return scanner.count_snps_native(
        bamfile_location, chromosome2positions, barcode_handler, parse_read, n_jobs,
        required=required,
    )
