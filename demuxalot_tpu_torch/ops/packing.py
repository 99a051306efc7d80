"""Host-side packing: compressed SNP calls → call columns and CSR offsets.

The boundary between the host call tables and the device kernels. It joins
molecule calls against genotype variants, collapses them to unique
(variant, barcode) rows, applies the beta regularization priors, and lays
the rows out in the two orders the EM kernels read:

* by variant (``CallColumns``, sorted by (device vid, cb)) with variant row
  pointers, for the M-step;
* by barcode (``CallColumns.by_barcode``) with barcode row pointers, for
  the E-step.

Semantics are those of ``demuxalot_tpu.ops.packing`` (itself mirroring the
reference packing, demuxalot/demux.py:276-392): searchsorted variant
matching with unmatched calls dropped, per-group probability products, and
the (1 + data-prior + sum-normalized-betas) × default_prior regularization.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Tuple

import numpy as np

from ..native.hostops import (
    collapse_calls_keyed, group_sum_broadcast, match_compact, match_keys, sort_calls_by_cb, stable_argsort,
)
from ..utils.encoding import base_lookup

# windowed denominators stay cheap only while SNP runs are short; genuine
# data has at most 4 variants (bases) per site, so anything past this cap
# falls back to the segment-sum path (ops.likelihood.probs_from_betas)
MAX_WINDOWED_RUN = 6


@dataclass
class MoleculeCalls:
    """Per-call records after variant matching (one row per molecule×variant)."""

    variant_id: np.ndarray  # int32 [n]
    snp_id: np.ndarray  # int32 [n]
    compressed_cb: np.ndarray  # int32 [n]
    molecule_id: np.ndarray  # int32 [n], for backtracking only
    p_base_wrong: np.ndarray  # float32 [n]
    p_molecule_aligned_wrong: np.ndarray  # float32 [n]

    def __len__(self):
        return len(self.variant_id)

    def __getitem__(self, key):
        # recarray-style field access for parity with reference call sites
        return getattr(self, key)


def match_calls_to_variants(chromosome2compressed_snp_calls, genotypes) -> MoleculeCalls:
    """Join raw calls to genotype variant ids; unmatched calls are dropped.

    Matching is per chromosome on the (position, base) key, like the
    reference's sorted searchsorted join (demuxalot/demux.py:334-358).
    """
    v2s_i32 = np.ascontiguousarray(genotypes.get_snp_ids_for_variants(), dtype=np.int32)

    # per-chromosome (pos*6 + base_code) key -> variant id, read straight
    # off the registry columns
    chrom_names, chrom_slots, positions, base_chars, base_slots = genotypes.variant_columns()
    # registry base chars -> call base codes; exotic bases get a sentinel
    # code that no call (0..4) can produce, so they simply never match
    slot2code = np.array([base_lookup.get(ch, 5) for ch in base_chars], dtype=np.int64)
    base_codes = slot2code[np.asarray(base_slots, dtype=np.int64)]
    chrom2keys: Dict[str, Tuple[np.ndarray, np.ndarray]] = {}
    all_vids = np.arange(len(positions), dtype=np.int64)
    for slot, chrom in enumerate(chrom_names):
        sel = np.asarray(chrom_slots) == slot
        keys = np.asarray(positions, dtype=np.int64)[sel] * 6 + base_codes[sel]
        chrom2keys[chrom] = (keys, all_vids[sel])

    names = ("variant_id", "snp_id", "compressed_cb", "molecule_id",
             "p_base_wrong", "p_molecule_aligned_wrong")
    collected = {name: [] for name in names}

    for chromosome, compressed in chromosome2compressed_snp_calls.items():
        compressed.minimize_memory_footprint()
        calls = compressed.snp_calls
        molecules = compressed.molecules
        if chromosome not in chrom2keys or len(calls) == 0:
            continue
        table_keys, table_vids = chrom2keys[chromosome]
        native = match_compact(table_keys, table_vids, calls, molecules)
        if native is not None:
            # fused C++ join: key build, hash lookup, compaction and the
            # molecule-field gathers in one pass
            vid_m, cb_m, mol_m, p_m, pmol_m = native
            if not len(vid_m):
                continue
            collected["variant_id"].append(vid_m)
            collected["snp_id"].append(v2s_i32[vid_m])
            collected["compressed_cb"].append(cb_m)
            collected["molecule_id"].append(mol_m)
            collected["p_base_wrong"].append(p_m)
            collected["p_molecule_aligned_wrong"].append(pmol_m)
            continue
        call_keys = calls["snp_position"].astype(np.int64) * 6 + calls["base_index"].astype(np.int64)
        joined = match_keys(table_keys, table_vids, call_keys)
        matched = joined >= 0
        if not matched.any():
            continue
        variant_id = joined[matched].astype(np.int32)
        mol_index = calls["molecule_index"][matched]

        collected["variant_id"].append(variant_id)
        collected["snp_id"].append(v2s_i32[variant_id])
        collected["compressed_cb"].append(molecules["compressed_cb"][mol_index])
        collected["molecule_id"].append(mol_index)
        collected["p_base_wrong"].append(calls["p_base_wrong"][matched])
        collected["p_molecule_aligned_wrong"].append(molecules["p_group_misaligned"][mol_index])

    def cat(name, dtype):
        chunks = collected[name]
        if not chunks:
            return np.empty(0, dtype=dtype)
        arr = chunks[0] if len(chunks) == 1 else np.concatenate(chunks)
        return arr.astype(dtype, copy=False)

    return MoleculeCalls(
        variant_id=cat("variant_id", np.int32),
        snp_id=cat("snp_id", np.int32),
        compressed_cb=cat("compressed_cb", np.int32),
        molecule_id=cat("molecule_id", np.int32),
        p_base_wrong=cat("p_base_wrong", np.float32),
        p_molecule_aligned_wrong=cat("p_molecule_aligned_wrong", np.float32),
    )


BARCODE_CALLS_DTYPE = np.dtype(
    [
        ("variant_id", "int32"),
        ("snp_id", "int32"),
        ("compressed_cb", "int32"),
        ("p_base_wrong", "float32"),
        ("barcode_variant_count", "int64"),
        ("barcode_snp_count", "float64"),
    ]
)


def _group_boundaries(sorted_keys: np.ndarray) -> np.ndarray:
    """Start indices of equal-key runs in a sorted array."""
    if len(sorted_keys) == 0:
        return np.zeros(0, dtype=np.int64)
    starts = np.empty(len(sorted_keys), dtype=bool)
    starts[0] = True
    np.not_equal(sorted_keys[1:], sorted_keys[:-1], out=starts[1:])
    return np.flatnonzero(starts)


def molecule_calls_to_barcode_calls(molecule_calls: MoleculeCalls) -> np.recarray:
    """Collapse molecule calls to unique (variant, snp, barcode) rows.

    The reference-shaped call table (registry variant order, rows sorted by
    (variant, barcode)): ``p_base_wrong`` of a row is the f32 product over
    its molecules' values in stable order, and the molecule counts per row
    and per (snp, barcode) ride along (reference: demuxalot/demux.py:276-300).
    The numpy path of the JAX package's function, on this package's host ops.
    """
    n = len(molecule_calls)
    cb_span = int(molecule_calls.compressed_cb.max()) + 1 if n else 1
    vid = molecule_calls.variant_id.astype(np.int64)
    cb = molecule_calls.compressed_cb.astype(np.int64)
    group_key = vid * cb_span + cb

    order = stable_argsort(group_key)
    sorted_keys = group_key[order]
    starts = _group_boundaries(sorted_keys)
    unique_keys = sorted_keys[starts]
    barcode_variant_counts = np.diff(np.append(starts, n))

    out_vid = (unique_keys // cb_span).astype(np.int32)
    out_cb = (unique_keys % cb_span).astype(np.int32)
    # snp_id is a function of variant_id: take it from the first member row
    out_snp = molecule_calls.snp_id[order[starts]]
    # probability of a wrong base = product of member molecules' probabilities
    if n:
        p_base_wrong = np.multiply.reduceat(molecule_calls.p_base_wrong[order], starts).astype("float32")
    else:
        p_base_wrong = np.zeros(0, "float32")

    # molecules per (snp, barcode), broadcast back to rows (f64 sums of
    # small int counts are exact)
    snp_cb_key = out_snp.astype(np.int64) * cb_span + out_cb
    barcode_snp_count = group_sum_broadcast(snp_cb_key, barcode_variant_counts.astype(np.float64))

    result = np.recarray(len(starts), dtype=BARCODE_CALLS_DTYPE)
    result["variant_id"] = out_vid
    result["snp_id"] = out_snp
    result["compressed_cb"] = out_cb
    result["p_base_wrong"] = p_base_wrong
    result["barcode_variant_count"] = barcode_variant_counts
    result["barcode_snp_count"] = barcode_snp_count
    return result


@dataclass
class CallColumns:
    """Collapsed (variant, barcode) call rows as contiguous columns.

    ``vid`` holds DEVICE (SNP-sorted) variant ids and rows are sorted by
    (vid, cb) — the M-step order, and one key sort away from the E-step's
    barcode-major order (:meth:`by_barcode`).
    """

    vid: np.ndarray  # int32 [n], device variant ids, non-decreasing
    cb: np.ndarray  # int32 [n]
    q: np.ndarray  # float32 [n], p_base_wrong product per row
    count: np.ndarray  # int64 [n], molecules collapsed into the row

    def __len__(self):
        return len(self.vid)

    def by_barcode(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(cb, vid, q) stably re-sorted to barcode-major order."""
        return sort_calls_by_cb(self.cb, self.vid, self.q)


def collapse_device_order(molecule_calls: MoleculeCalls, reindex: "VariantReindex") -> CallColumns:
    """Collapse molecule calls straight into device variant order.

    One row per (variant, barcode) with the f32 product of its molecules'
    ``p_base_wrong`` in stable order, sorted by (device vid, cb).
    """
    if len(molecule_calls) == 0:
        return CallColumns(
            vid=np.empty(0, np.int32), cb=np.empty(0, np.int32),
            q=np.empty(0, np.float32), count=np.empty(0, np.int64),
        )
    cb = molecule_calls.compressed_cb
    cb_bits = max(1, int(int(cb.max())).bit_length())
    vid, cb_out, q, count = collapse_calls_keyed(
        molecule_calls.variant_id, cb, molecule_calls.p_base_wrong,
        reindex.inverse, cb_bits,
    )
    return CallColumns(vid=vid, cb=cb_out, q=q, count=count)


def compute_prior_betas(
    genotypes,
    molecule_calls: MoleculeCalls,
    variant_index2snp_index: np.ndarray,
    add_data_prior: bool,
) -> np.ndarray:
    """Regularized betas: prior + (1 [+ data prior] + normalized sum) × default_prior.

    Matches demuxalot/demux.py:367-390; result is frozen (read-only) — EM
    accumulates into a separate addition array.
    """
    variant_index2betas = genotypes.get_betas()
    assert np.all(variant_index2betas >= 0), "bad genotypes provided, negative betas appeared"

    def normalize_over_snp(variant_counts, regularization=1.0):
        assert len(variant_counts) == len(variant_index2snp_index)
        snp_counts = np.bincount(variant_index2snp_index, weights=variant_counts)[variant_index2snp_index]
        return variant_counts / (snp_counts + regularization)

    prior_betas = 1.0  # baseline regularization
    if add_data_prior:
        # training only: molecule support counts as additional prior evidence
        variant_index2n_molecules = np.bincount(molecule_calls.variant_id, minlength=genotypes.n_variants)
        prior_betas = prior_betas + normalize_over_snp(variant_index2n_molecules, regularization=100.0)
    prior_betas = prior_betas + normalize_over_snp(variant_index2betas.sum(axis=1), regularization=100.0)
    addition = np.asarray(prior_betas)[:, np.newaxis] * genotypes.default_prior
    result = variant_index2betas + addition.astype(variant_index2betas.dtype)
    result.flags.writeable = False
    return result


def pack_calls(chromosome2compressed_snp_calls, genotypes, add_data_prior: bool):
    """Full packing pipeline; returns the same 4-tuple shape as the reference.

    (variant_index2snp_index, regularized_betas, molecule_calls, barcode_calls)
    """
    variant_index2snp_index = genotypes.get_snp_ids_for_variants()
    molecule_calls = match_calls_to_variants(chromosome2compressed_snp_calls, genotypes)
    barcode_calls = molecule_calls_to_barcode_calls(molecule_calls)
    variant_index2betas = compute_prior_betas(
        genotypes, molecule_calls, variant_index2snp_index, add_data_prior=add_data_prior
    )
    return variant_index2snp_index, variant_index2betas, molecule_calls, barcode_calls


@dataclass
class VariantReindex:
    """SNP-sorted renumbering of the variant axis for the device EM space.

    Variants sharing a SNP become contiguous rows, so the per-iteration
    genotype-prob normalization runs as windowed elementwise sums instead of
    a segment-sum scatter (``ops.likelihood.probs_from_betas`` with
    ``max_per_snp``). Registry-facing results (the learnt beta addition) are
    mapped back with :meth:`unpermute_rows`.
    """

    order: np.ndarray  # i64 [n_variants]; device row j holds registry row order[j]
    inverse: np.ndarray  # i32 [n_variants]; registry row i lives at device row inverse[i]
    variant2snp: np.ndarray  # i32 [n_variants], non-decreasing
    max_per_snp: int  # longest same-SNP run (window size for the denominators)

    @classmethod
    def build(cls, variant2snp: np.ndarray) -> "VariantReindex":
        v2s = np.asarray(variant2snp)
        order = stable_argsort(v2s)
        inverse = np.empty(len(order), dtype=np.int32)
        inverse[order] = np.arange(len(order), dtype=np.int32)
        sorted_v2s = np.ascontiguousarray(v2s[order].astype(np.int32))
        max_per_snp = int(np.bincount(sorted_v2s).max()) if len(sorted_v2s) else 1
        return cls(order=order, inverse=inverse, variant2snp=sorted_v2s, max_per_snp=max_per_snp)

    @property
    def windowed_max_per_snp(self) -> int:
        """`max_per_snp` when the windowed denominator path applies, else 0."""
        return self.max_per_snp if self.max_per_snp <= MAX_WINDOWED_RUN else 0

    def remap_variant_ids(self, vid: np.ndarray) -> np.ndarray:
        """Registry variant ids → device (SNP-sorted) variant ids."""
        return self.inverse[np.asarray(vid)]

    def permute_rows(self, table: np.ndarray) -> np.ndarray:
        """Registry-ordered [n_variants, ...] rows → device order."""
        return np.ascontiguousarray(np.asarray(table)[self.order])

    def unpermute_rows(self, table: np.ndarray) -> np.ndarray:
        """Device-ordered [n_variants, ...] rows → registry order."""
        return np.ascontiguousarray(np.asarray(table)[self.inverse])


def csr_row_pointers(sorted_rows: np.ndarray, n_rows: int) -> np.ndarray:
    """Row pointers int64 [n_rows + 1] over non-decreasing row ids.

    Calls of row r are ``[ptr[r], ptr[r + 1])``; rows without calls get an
    empty range. Every id must lie in ``[0, n_rows)``.
    """
    sorted_rows = np.asarray(sorted_rows)
    if len(sorted_rows) and (int(sorted_rows[0]) < 0 or int(sorted_rows[-1]) >= n_rows):
        raise ValueError(f"row ids must lie in [0, {n_rows})")
    return np.searchsorted(sorted_rows, np.arange(n_rows + 1), side="left").astype(np.int64)
