"""Genotype knowledge store backed by an array variant registry.

``ProbabilisticGenotypes`` accumulates Dirichlet pseudo-counts ("betas")
about which base each donor carries at each variant. A *variant* is one
``(chromosome, position, base)`` triple; a *SNP* is the set of variants
sharing ``(chromosome, position)``. Knowledge only ever accumulates —
importers add pseudo-counts, they never overwrite — so priors from SNP
arrays, WGS VCFs, and previously learnt betas can be layered freely.

Covers the reference store's behavior (demuxalot/genotypes.py:18-361):
the same importer rules, the same parquet checkpoint schema (index
CHROM/POS/BASE, columns = donor names — a hard format contract), the same
clone/query surface. The implementation is this framework's own: variants
live in parallel numpy columns (chromosome slot, position, base slot) with
a packed-integer hash index, capacity grows geometrically, importers are
vectorized, and serialization orders variants with one ``lexsort`` instead
of sorting Python tuples.

Same store as ``demuxalot_tpu.models.genotypes``. pandas is imported only
by the methods that read or build data frames and parquet files, so the
registry and the EM engine run without it.
"""
from __future__ import annotations

from collections import Counter
from copy import deepcopy
from typing import TYPE_CHECKING, Dict, List, Sequence
from warnings import warn

import numpy as np

from ..native.hostops import stable_argsort
from ..utils import tracing

if TYPE_CHECKING:
    import pandas as pd

# packed registry key: (chrom_slot * POSITION_SPAN + position) * BASE_SPAN + base_slot,
# evaluated in Python ints (no overflow); spans are generous upper bounds
_POSITION_SPAN = 1 << 44
_BASE_SPAN = 1 << 6

_DIPLOID_CALL_WEIGHTS = {"0/0": (1.0, 0.0), "0/1": (0.5, 0.5), "1/1": (0.0, 1.0)}


class ProbabilisticGenotypes:
    """Per-donor beta weights over a growing registry of variants.

    The donor set is fixed at construction (sorted, unique names). Betas are
    stored in ``variant_betas`` (float32, one row per variant, possibly with
    spare capacity rows at the end); ``n_variants`` rows are live. Row ids
    are assigned on first registration and never move, so external arrays
    indexed by variant id stay valid as more knowledge is added.
    """

    def __init__(self, genotype_names: List[str], default_prior: float = 1.0):
        names = list(genotype_names)
        if names != sorted(names):
            raise ValueError("genotype names must be passed in sorted order")
        if len(set(names)) != len(names):
            raise ValueError(f"genotype names contain duplicates: {names}")
        self.genotype_names: List[str] = names
        self.default_prior = default_prior

        self._donor_slot: Dict[str, int] = {name: slot for slot, name in enumerate(names)}
        # interning tables for chromosome names and base characters
        self._chrom_names: List[str] = []
        self._chrom_slots: Dict[str, int] = {}
        self._base_chars: List[str] = []
        self._base_slots: Dict[str, int] = {}
        # packed key -> variant row
        self._row_index: Dict[int, int] = {}
        # parallel per-variant columns (capacity-sized, first _n_rows live)
        self._n_rows = 0
        self._col_chrom = np.zeros(0, dtype=np.int32)
        self._col_pos = np.zeros(0, dtype=np.int64)
        self._col_base = np.zeros(0, dtype=np.int16)
        self.variant_betas = np.zeros((0, self.n_genotypes), dtype=np.float32)
        self._tuple_index_cache = None

    # ------------------------------------------------------------------
    # registry
    # ------------------------------------------------------------------
    @property
    def n_genotypes(self) -> int:
        return len(self.genotype_names)

    @property
    def n_variants(self) -> int:
        return self._n_rows

    def _intern(self, table: Dict[str, int], names: List[str], value: str) -> int:
        slot = table.get(value)
        if slot is None:
            slot = len(names)
            table[value] = slot
            names.append(value)
        return slot

    def _packed_key(self, chrom: str, pos: int, base: str) -> int:
        chrom_slot = self._intern(self._chrom_slots, self._chrom_names, chrom)
        base_slot = self._intern(self._base_slots, self._base_chars, base)
        assert base_slot < _BASE_SPAN and pos < _POSITION_SPAN
        return (chrom_slot * _POSITION_SPAN + int(pos)) * _BASE_SPAN + base_slot

    def _ensure_capacity(self, n_rows_needed: int) -> None:
        def grown(array: np.ndarray, capacity: int) -> np.ndarray:
            if len(array) >= capacity:
                return array
            extra_shape = (capacity - len(array),) + array.shape[1:]
            return np.concatenate([array, np.zeros(extra_shape, dtype=array.dtype)])

        if n_rows_needed <= len(self.variant_betas) and n_rows_needed <= len(self._col_pos):
            return
        capacity = max(n_rows_needed, 2 * len(self.variant_betas), 1024)
        self.variant_betas = grown(self.variant_betas, capacity)
        self._col_chrom = grown(self._col_chrom, capacity)
        self._col_pos = grown(self._col_pos, capacity)
        self._col_base = grown(self._col_base, capacity)

    def get_variant_id(self, chrom: str, pos: int, base: str) -> int:
        """Row id of the variant, registering it (zero betas) if new."""
        key = self._packed_key(chrom, pos, base)
        row = self._row_index.get(key)
        if row is None:
            row = self._n_rows
            self._ensure_capacity(row + 1)
            self._row_index[key] = row
            self._col_chrom[row] = self._chrom_slots[chrom]
            self._col_pos[row] = int(pos)
            self._col_base[row] = self._base_slots[base]
            self._n_rows = row + 1
            self._tuple_index_cache = None
        return row

    def _register_batch(self, chroms: Sequence, positions: Sequence, bases: Sequence) -> np.ndarray:
        """Row ids for aligned (chrom, pos, base) columns, registering news."""
        rows = np.empty(len(positions), dtype=np.int64)
        self._ensure_capacity(self._n_rows + len(positions))  # upper bound, cheap
        for i, (chrom, pos, base) in enumerate(zip(chroms, positions, bases)):
            rows[i] = self.get_variant_id(chrom, pos, base)
        return rows

    def extend_variants(self, n_samples: int = 1) -> None:
        """Reserve capacity for future registrations (compat convenience)."""
        self._ensure_capacity(self._n_rows + n_samples)

    @property
    def var2varid(self) -> Dict[tuple, int]:
        """Mapping view ``(chrom, pos, base) -> variant row`` (cached)."""
        if self._tuple_index_cache is None:
            n = self._n_rows
            self._tuple_index_cache = {
                (self._chrom_names[c], int(p), self._base_chars[b]): row
                for row, (c, p, b) in enumerate(
                    zip(self._col_chrom[:n], self._col_pos[:n], self._col_base[:n])
                )
            }
        return self._tuple_index_cache

    def variant_columns(self):
        """Raw registry columns: (chrom names list, chrom slots, positions, base chars list, base slots).

        Vectorized consumers (the packing layer) read these directly instead
        of iterating a dict of tuples.
        """
        n = self._n_rows
        return (
            self._chrom_names,
            self._col_chrom[:n],
            self._col_pos[:n],
            self._base_chars,
            self._col_base[:n],
        )

    # ------------------------------------------------------------------
    # queries
    # ------------------------------------------------------------------
    def get_betas(self) -> np.ndarray:
        """Live beta rows as a read-only view."""
        view = self.variant_betas[: self._n_rows]
        view.flags.writeable = False
        return view

    def get_snp_ids_for_variants(self) -> np.ndarray:
        """Variant row -> dense SNP id (variants sharing (chrom, pos))."""
        n = self._n_rows
        site_key = self._col_chrom[:n].astype(np.int64) * _POSITION_SPAN + self._col_pos[:n]
        order = stable_argsort(site_key)
        ordered = site_key[order]
        first_of_run = np.ones(n, dtype=bool)
        first_of_run[1:] = ordered[1:] != ordered[:-1]
        snp_of_ordered = np.cumsum(first_of_run) - 1
        result = np.empty(n, dtype=np.int32)
        result[order] = snp_of_ordered
        return result

    def get_chromosome2positions(self) -> Dict[str, np.ndarray]:
        """Distinct SNP positions per chromosome (sorted int64 arrays)."""
        n = self._n_rows
        if n == 0:
            warn("no variants registered yet — import a VCF or prior betas first")
        return {
            name: np.unique(self._col_pos[:n][self._col_chrom[:n] == slot])
            for slot, name in enumerate(self._chrom_names)
        }

    def get_snp_positions_set(self) -> set:
        """Set of (chromosome, position) pairs carrying any variant."""
        n = self._n_rows
        chrom_of_row = np.asarray(self._chrom_names, dtype=object)[self._col_chrom[:n]]
        return set(zip(chrom_of_row, (int(p) for p in self._col_pos[:n])))

    def __repr__(self):
        return (
            f"ProbabilisticGenotypes({self.n_variants} variants over "
            f"{len(self._chrom_names)} contigs; donors {self.genotype_names})"
        )

    # ------------------------------------------------------------------
    # importers
    # ------------------------------------------------------------------
    def _resolve_import_donors(self, imported: List[str], allow_duplicates: bool = False) -> Dict[str, int]:
        """Intersect imported donor names with ours; warn about the rest."""
        repeated = [name for name, times in Counter(imported).items() if times > 1]
        if repeated:
            if not allow_duplicates:
                raise RuntimeError(f"imported data repeats donor columns: {repeated}")
            warn(f"repeated donor columns will each be imported: {repeated}")

        known = {name: self._donor_slot[name] for name in imported if name in self._donor_slot}
        if not known:
            raise RuntimeError(
                f"imported donors {sorted(set(imported))} have no overlap with {self.genotype_names}"
            )
        foreign = sorted(set(imported) - set(known))
        if foreign:
            warn(f"ignoring donors absent from this genotype set: {foreign}")
        absent = sorted(set(self.genotype_names) - set(imported))
        if absent:
            print(f"import carries no information for donors: {absent}")
        return known

    # keep the reference's name for this hook as an alias (tests/users call it)
    _check_imported_genotypes = _resolve_import_donors

    def add_vcf(self, vcf_file_name, prior_strength: float = 100.0) -> None:
        """Accumulate diploid GT calls from a VCF.

        Import rules (reference parity, demuxalot/genotypes.py:112-168):
        only SNV records whose alleles are distinct single A/C/G/T bases
        qualify; each donor's diploid call spreads ``prior_strength``
        equally over its called alleles; a record needs calls from at least
        two known donors to contribute weight (its variants are still
        registered); donors without a call get a token 10% of the mean
        provided contribution.
        """
        from ..bamio import VariantFile

        n_records = 0
        n_rejected = 0
        rows_before = self._n_rows
        donor_slots: Dict[str, int] = {}
        pending_rows: List[np.ndarray] = []
        pending_weights: List[np.ndarray] = []

        with VariantFile(vcf_file_name) as vcf:
            for record in vcf.fetch():
                n_records += 1
                if any(len(allele) != 1 for allele in record.alleles):
                    print(f"ignoring non-SNV record at {record.chrom}:{record.pos} {record.alleles}")
                    continue
                if not donor_slots:
                    donor_slots = self._resolve_import_donors(list(record.samples))
                if len(set(record.alleles)) != len(record.alleles) or not all(
                    allele in "ACGT" for allele in record.alleles
                ):
                    n_rejected += 1
                    continue

                # VCF is 1-based; the registry is 0-based
                rows = np.array(
                    [self.get_variant_id(record.chrom, record.pos - 1, a) for a in record.alleles]
                )
                weights = np.zeros((len(rows), self.n_genotypes), dtype=np.float32)
                for donor, slot in donor_slots.items():
                    diploid = record.samples[donor]["GT"]
                    for allele_index in diploid:
                        if allele_index is not None:
                            weights[allele_index, slot] += prior_strength / len(diploid)

                covered = weights.sum(axis=0) > 0
                if covered.sum() < 2:
                    n_rejected += 1  # a single-donor SNP cannot discriminate
                    continue
                weights[:, ~covered] = 0.1 * weights[:, covered].mean(axis=1, keepdims=True)
                pending_rows.append(rows)
                pending_weights.append(weights)

        if pending_rows:
            self._scatter_add(np.concatenate(pending_rows), np.concatenate(pending_weights))
        if n_rejected:
            print(f"rejected {n_rejected} records (duplicate/non-ACGT alleles or <2 donors)")
        print(
            f"read {n_records} VCF records -> {self._n_rows - rows_before} newly registered variants"
        )

    def _scatter_add(self, rows: np.ndarray, weights: np.ndarray) -> None:
        """betas[rows] += weights with repeated rows accumulated."""
        n = self._n_rows
        for slot in range(self.n_genotypes):
            self.variant_betas[:n, slot] += np.bincount(
                rows, weights=weights[:, slot].astype(np.float64), minlength=n
            ).astype(np.float32)

    def add_assignment_dataframe(self, assignment: pd.DataFrame, *, prior_strength: float = 100.0) -> None:
        """Accumulate a '0/0'/'0/1'/'1/1' style assignment table.

        ``assignment``: donor columns over a (CHROM, POS1BASED, REF, ALT)
        index; './.' and missing entries carry no information.
        """
        table = assignment.fillna("./.")
        site = table.index.to_frame().reset_index(drop=True)
        donor_slots = self._resolve_import_donors(list(table.columns))

        rows_before = self._n_rows
        chroms = site["CHROM"].tolist()
        positions = (site["POS1BASED"].to_numpy() - 1).tolist()
        ref_rows = self._register_batch(chroms, positions, site["REF"].tolist())
        alt_rows = self._register_batch(chroms, positions, site["ALT"].tolist())

        for donor, slot in donor_slots.items():
            calls = table[donor].to_numpy()
            legal = np.isin(calls, list(_DIPLOID_CALL_WEIGHTS) + ["./."])
            if not legal.all():
                bad = calls[~legal][0]
                raise AssertionError(f"unrecognized assignment value {bad!r} for donor {donor}")
            ref_w = np.zeros(len(calls))
            alt_w = np.zeros(len(calls))
            for call, (wr, wa) in _DIPLOID_CALL_WEIGHTS.items():
                hit = calls == call
                ref_w[hit] = wr * prior_strength
                alt_w[hit] = wa * prior_strength
            n = self._n_rows
            self.variant_betas[:n, slot] += (
                np.bincount(ref_rows, weights=ref_w, minlength=n)
                + np.bincount(alt_rows, weights=alt_w, minlength=n)
            ).astype(np.float32)

        print(
            f"read {2 * len(table)} assignment variants -> "
            f"{self._n_rows - rows_before} newly registered"
        )

    def add_raw_values_from_bead_array(
        self,
        logrratio: pd.DataFrame,
        b_allele_freq: pd.DataFrame,
        *,
        prior_strength: float = 100.0,
    ) -> None:
        """Accumulate raw Illumina bead-array intensities.

        Aligned donor-column frames over a (chromosome, position1based,
        alleleA, alleleB) index. A probe contributes
        ``prior_strength * 2**logrratio`` split between its two alleles by
        ``b_allele_freq``; non-finite pairs degrade to logrratio −20 with
        all mass on allele A.
        """
        assert logrratio.columns.equals(b_allele_freq.columns), "frames must share donor columns"
        assert logrratio.index.equals(b_allele_freq.index), "frames must share the probe index"
        self._resolve_import_donors(list(logrratio.columns), allow_duplicates=True)

        site = logrratio.index.to_frame().reset_index(drop=True)
        chroms = site["chromosome"].map(str).tolist()
        positions = (site["position1based"].to_numpy() - 1).tolist()
        rows_before = self._n_rows
        rows_a = self._register_batch(chroms, positions, site["alleleA"].tolist())
        rows_b = self._register_batch(chroms, positions, site["alleleB"].tolist())

        ratio = logrratio.to_numpy(dtype=np.float64, copy=True).clip(-10, 0)
        freq_b = b_allele_freq.to_numpy(dtype=np.float64, copy=True)
        broken = ~(np.isfinite(ratio) & np.isfinite(freq_b))
        ratio[broken] = -20
        freq_b[broken] = 0
        assert freq_b.min() >= 0 and freq_b.max() <= 1, "b_allele_freq must lie in [0, 1]"
        assert ratio.max() == 0.0, "logrratio is expected to top out at 0"

        n = self._n_rows
        for column, donor in enumerate(logrratio.columns):
            slot = self._donor_slot.get(donor)
            if slot is None:
                continue
            probe_mass = prior_strength * np.exp2(ratio[:, column])
            self.variant_betas[:n, slot] += (
                np.bincount(rows_a, weights=probe_mass * (1 - freq_b[:, column]), minlength=n)
                + np.bincount(rows_b, weights=probe_mass * freq_b[:, column], minlength=n)
            ).astype(np.float32)

        print(
            f"read {2 * len(logrratio)} bead-array variants -> "
            f"{self._n_rows - rows_before} newly registered"
        )

    def add_prior_betas(self, prior_filename, *, prior_strength: float = 1.0) -> None:
        """Accumulate betas from a parquet checkpoint (the save format).

        Index must be (CHROM, POS, BASE); columns are donor names; values
        are scaled by ``prior_strength``. Unknown variants are registered —
        a positions-only parquet (no donor columns) registers zero-weight
        variants, which is how discovered SNPs enter the next EM round.
        """
        import pandas as pd

        checkpoint = pd.read_parquet(prior_filename)
        print(f"prior betas provide donors: {list(checkpoint.columns)}")
        uncovered = [name for name in self.genotype_names if name not in checkpoint.columns]
        if uncovered:
            print(f"no prior information for donors: {uncovered}")

        site = checkpoint.index.to_frame().reset_index(drop=True)
        rows = self._register_batch(
            site["CHROM"].tolist(), site["POS"].tolist(), site["BASE"].tolist()
        )
        n = self._n_rows
        for donor in checkpoint.columns:
            slot = self._donor_slot.get(donor)
            if slot is None:
                continue
            self.variant_betas[:n, slot] += np.bincount(
                rows,
                weights=checkpoint[donor].to_numpy(dtype=np.float64) * prior_strength,
                minlength=n,
            ).astype(np.float32)

    # ------------------------------------------------------------------
    # serialization & cloning
    # ------------------------------------------------------------------
    def as_pandas_dataframe(self) -> pd.DataFrame:
        """Betas over a canonically sorted (CHROM, POS, BASE) MultiIndex."""
        import pandas as pd

        n = self._n_rows
        chrom_of_row = np.asarray(self._chrom_names, dtype="U")[self._col_chrom[:n]]
        base_of_row = np.asarray(self._base_chars, dtype="U")[self._col_base[:n]]
        pos_of_row = self._col_pos[:n]
        order = np.lexsort((base_of_row, pos_of_row, chrom_of_row))
        return pd.DataFrame(
            data=self.variant_betas[:n][order],
            index=pd.MultiIndex.from_arrays(
                [chrom_of_row[order], pos_of_row[order], base_of_row[order]],
                names=["CHROM", "POS", "BASE"],
            ),
            columns=self.genotype_names,
        )

    def save_betas(self, path_or_buf) -> None:
        """Write the parquet checkpoint (re-importable via add_prior_betas)."""
        self.as_pandas_dataframe().to_parquet(path_or_buf)

    def clone(self) -> "ProbabilisticGenotypes":
        return deepcopy(self)

    @tracing.within("_with_betas")
    def _with_betas(self, external_betas: np.ndarray) -> "ProbabilisticGenotypes":
        """Clone carrying replacement beta weights (exact-size rows)."""
        assert external_betas.shape == (self.n_variants, self.n_genotypes)
        assert external_betas.dtype == self.variant_betas.dtype
        assert external_betas.min(initial=0) >= 0, "betas cannot be negative"
        result = self.clone()
        result.variant_betas = external_betas.copy()
        return result
