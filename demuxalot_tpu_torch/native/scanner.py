"""ctypes binding for the C++ BAM region scanner.

A copy of ``demuxalot_tpu.native.scanner``: the region scan of
``count_snps`` and the coverage pileup of SNP discovery. Reuses the Python
task planner (region splits, RG fan-out) and the Python BAI index for
virtual-offset chunks; each region-shard task becomes one
native call. Tasks run on a thread pool — the GIL is released for the
duration of each C++ scan, so threads scale across cores without a process
pool's pickling overhead.
"""
from __future__ import annotations

import ctypes
import functools
import inspect
import os
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Optional

import numpy as np

from . import load_library
from ..bamio import BamReader


def _extract_parse_params(parse_read) -> Optional[dict]:
    """Recognize the standard tag-based filters (incl. functools.partial).

    Returns the flattened keyword parameters, or None for arbitrary
    callables (which require the Python scanner).
    """
    from ..frontend import bd_rhapsody, cellranger

    overrides: dict = {}
    fn = parse_read
    while isinstance(fn, functools.partial):
        if fn.args:
            return None
        overrides = {**fn.keywords, **overrides}
        fn = fn.func

    if fn is cellranger.parse_read:
        base = dict(umi_tag="UB")
    elif fn is bd_rhapsody.parse_read:
        base = dict(umi_tag="MA")
    else:
        return None

    sig = inspect.signature(fn)
    params = {
        name: p.default
        for name, p in sig.parameters.items()
        if p.default is not inspect.Parameter.empty
    }
    params.update(base)
    params.update(overrides)
    unknown = set(params) - {
        "umi_tag", "nhits_tag", "score_tag", "score_diff_max", "mapq_threshold",
        "p_misaligned_default",
    }
    if unknown:
        return None
    return params


def _barcode_array(barcode_handler):
    """Whitelist as a char** indexed by the handler's dense indices.

    Slots without a plain-string identity (barcodes belonging to other
    read groups after filter_to_rg_value) use "\\x01": non-empty and
    impossible as a Z-tag value (the spec allows printable chars + space
    only), so an empty CB tag can never match them.
    """
    n = barcode_handler.n_barcodes
    arr = [b"\x01"] * n
    for key, index in barcode_handler.barcode2index.items():
        if isinstance(key, str):
            arr[index] = key.encode("ascii")
    c_arr = (ctypes.c_char_p * n)(*arr)
    return c_arr


def _scan_task(lib, bai_cache, task, params, cb_tag):
    from ..frontend.snp_counter import CompressedSNPCalls

    bamfile, chromosome, start, stop, positions, handler = task
    bamfile = str(bamfile)
    if bamfile not in bai_cache:
        reader = BamReader(bamfile)
        index = reader._load_index()
        bai_cache[bamfile] = (index, reader.header)
    index, header = bai_cache[bamfile]
    ref_id = header.ref2id[chromosome]
    ref_len = header.lengths[ref_id]
    beg = 0 if start is None else max(0, int(start))
    end = ref_len if stop is None else min(ref_len, int(stop))

    chunks = index.chunks_for_region(ref_id, beg, end) if end > beg else []
    result = CompressedSNPCalls()
    result.minimize_memory_footprint()
    if not chunks:
        return chromosome, result

    vbeg = (ctypes.c_uint64 * len(chunks))(*[c[0] for c in chunks])
    vend = (ctypes.c_uint64 * len(chunks))(*[c[1] for c in chunks])
    positions = np.ascontiguousarray(positions, dtype=np.int32)
    barcodes = _barcode_array(handler)

    handle = lib.scan_region(
        bamfile.encode(),
        vbeg, vend, len(chunks),
        ref_id, beg, end,
        positions.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), len(positions),
        barcodes, handler.n_barcodes,
        cb_tag.encode(), params["umi_tag"].encode(),
        params["nhits_tag"].encode(), params["score_tag"].encode(),
        int(params["score_diff_max"]), int(params["mapq_threshold"]),
        float(params["p_misaligned_default"]),
    )
    if not handle:
        raise RuntimeError(f"native scan failed for {bamfile}:{chromosome}:{beg}-{end}")
    try:
        n_mol = lib.scan_n_molecules(handle)
        n_calls = lib.scan_n_calls(handle)
        from ..frontend.snp_counter import MOLECULE_DTYPE, SNP_CALL_DTYPE

        molecules = np.empty(n_mol, dtype=MOLECULE_DTYPE)
        snp_calls = np.empty(n_calls, dtype=SNP_CALL_DTYPE)
        mol_cb = np.empty(n_mol, np.int32)
        mol_ub = np.empty(n_mol, np.int32)
        mol_p = np.empty(n_mol, np.float32)
        call_mol = np.empty(n_calls, np.int32)
        call_pos = np.empty(n_calls, np.int32)
        call_base = np.empty(n_calls, np.uint8)
        call_p = np.empty(n_calls, np.float32)
        lib.scan_fill(
            handle,
            mol_cb.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            mol_ub.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            mol_p.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            call_mol.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            call_pos.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            call_base.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            call_p.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        )
        molecules["compressed_cb"] = mol_cb
        molecules["compressed_ub"] = mol_ub
        molecules["p_group_misaligned"] = mol_p
        snp_calls["molecule_index"] = call_mol
        snp_calls["snp_position"] = call_pos
        snp_calls["base_index"] = call_base
        snp_calls["p_base_wrong"] = call_p
    finally:
        lib.scan_free(handle)

    result.molecules = molecules
    result.snp_calls = snp_calls
    result._finalized = True
    return chromosome, result


def try_count_coverage_native(bamfile_path, chromosome, start, stop, parse_read,
                              quality_threshold: int = 15):
    """A/C/G/T pileup over [start, stop) via the C++ scanner, or None.

    Returns a tuple of four int64 arrays like ``BamReader.count_coverage``.
    None for custom parse_read callables or where the library cannot be
    built or loaded; a failed native count raises.
    """
    params = _extract_parse_params(parse_read)
    if params is None:
        return None
    try:
        lib = load_library()
    except (OSError, RuntimeError):  # no g++, zlib or a failed build or load
        return None

    bamfile_path = str(bamfile_path)
    with BamReader(bamfile_path) as reader:
        index = reader._load_index()
        ref_id = reader.header.ref2id[chromosome]
        ref_len = reader.header.lengths[ref_id]
    beg = 0 if start is None else max(0, int(start))
    end = ref_len if stop is None else min(ref_len, int(stop))
    length = max(0, end - beg)
    counts = np.zeros((4, length), dtype=np.int64)
    if length == 0:
        return tuple(counts)

    chunks = index.chunks_for_region(ref_id, beg, end)
    if chunks:
        vbeg = (ctypes.c_uint64 * len(chunks))(*[c[0] for c in chunks])
        vend = (ctypes.c_uint64 * len(chunks))(*[c[1] for c in chunks])
        ret = lib.count_coverage(
            bamfile_path.encode(),
            vbeg, vend, len(chunks),
            ref_id, beg, end,
            params["umi_tag"].encode(), params["nhits_tag"].encode(),
            params["score_tag"].encode(),
            int(params["score_diff_max"]), int(params["mapq_threshold"]),
            int(quality_threshold),
            counts.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        )
        if ret != 0:
            raise RuntimeError(f"native count_coverage failed for {bamfile_path}")
    return counts[0], counts[1], counts[2], counts[3]


def count_snps_native(
    bamfile_location,
    chromosome2positions: Dict[str, np.ndarray],
    barcode_handler,
    parse_read,
    n_jobs,
    required: bool = False,
):
    """Native counterpart of count_snps; returns None to request fallback."""
    params = _extract_parse_params(parse_read)
    if params is None:
        if required:
            raise RuntimeError(
                "native=True requires the standard tag-based parse_read "
                "(custom callables run on the Python scanner)"
            )
        return None

    lib = load_library()

    from ..frontend.snp_counter import CompressedSNPCalls, prepare_counting_tasks

    tasks = prepare_counting_tasks(
        bamfile_location, chromosome2positions, barcode_handler=barcode_handler
    )
    if n_jobs in (None, 0):
        max_workers = 1
    elif n_jobs < 0:
        max_workers = os.cpu_count() or 1
    else:
        max_workers = n_jobs

    bai_cache: dict = {}
    # warm the index cache serially (BamReader construction is not thread-safe
    # per file; tasks only read afterwards)
    for task in tasks:
        bamfile = str(task[0])
        if bamfile not in bai_cache:
            reader = BamReader(bamfile)
            bai_cache[bamfile] = (reader._load_index(), reader.header)

    worker = functools.partial(_scan_task, lib, bai_cache, params=params, cb_tag=barcode_handler.tag)
    if max_workers == 1:
        results = [worker(task) for task in tasks]
    else:
        with ThreadPoolExecutor(max_workers=max_workers) as pool:
            results = list(pool.map(worker, tasks))

    per_chromosome: Dict[str, list] = {}
    for chromosome, calls in results:
        per_chromosome.setdefault(chromosome, []).append(calls)
    return {
        chromosome: CompressedSNPCalls.concatenate(calls_list)
        for chromosome, calls_list in per_chromosome.items()
    }
