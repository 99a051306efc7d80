"""Demultiplexer: doublet-aware posterior inference and EM genotype refinement.

The PyTorch engine of the port. Host packing (``ops.packing``) builds the
call tables once; they go to the device in the two CSR orders the kernels
read, and every EM iteration then runs on the device:

1. normalise betas into genotype probabilities (``ops.likelihood.probs_from_betas``);
2. the E-step likelihood kernel with the row softmax fused
   (``ops.likelihood_kernel.estep_logits``, ``softmax=True``; iteration 0
   adds the prior logits inside the same launch);
3. the M-step kernel with the anchor mask and the next iteration's
   normalisation in its epilogue (``ops.mstep_kernel.mstep_update``), one
   launch; where a SNP has more variants than ``MAX_WINDOWED_RUN``, the
   addition-only kernel (``mstep_addition``), the mask and step 1 instead.

The EM state is variant-major [V, D]: a call's genotype row is then one
contiguous read in the E-step and the M-step writes whole variant rows.

Each public entry point is an array core that returns tensors
(:meth:`Demultiplexer.learn_genotypes_core`, which also runs
``damping="auto"`` as two EMs on one pack,
:meth:`Demultiplexer.predict_posteriors_core`) plus a thin wrapper that
builds the reference-shaped pandas frames; pandas is imported only there.
:meth:`Demultiplexer.predict_posteriors_compact` reduces the logits to
their top-k and logsumexp on the device.

With ``Demultiplexer.aggregate_on_snps`` the E-step is the per-SNP
aggregation over (barcode, snp) groups of the molecule calls
(:class:`_SnpAggregationLayout`, built once per dataset and device): the
kernel of ``ops.aggregate_kernel.aggregated_logits``, its row softmax
fused, with operands checked once per dataset, doublet prior and device
(:meth:`PackedCalls.aggregate_operands`); every sum in order, so every run
gives the same bits. The M-step stays the M-step kernel.

Every entry point records its stages as spans of ``utils.tracing``: the
``learn`` and ``predict`` calls, ``pack`` (with ``pack.join``,
``pack.reindex``, ``pack.collapse``), ``betas_for``, ``em.setup`` (with
``em.prior``, ``em.operands``, ``em.uploads``), ``em.loop``,
``registry_addition``, ``predict.*``, ``compact_topk`` and
``materialize``; each EM iteration's ``em.estep``, ``em.mstep`` and
``em.normalise`` only while a profiler records. Setting
:data:`STAGE_TIMINGS` to a dict also adds the stages' seconds into it.
Semantics are those of ``demuxalot_tpu.models.demux`` (reference:
demuxalot/demux.py:24-156).
"""
from __future__ import annotations

from contextlib import contextmanager
from dataclasses import dataclass, replace
from typing import Iterable, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..native.hostops import stable_argsort
from ..ops import likelihood as L
from ..ops import packing as P
from ..ops.aggregate_kernel import AggregateOperands, aggregate_operands, aggregated_logits
from ..ops.likelihood_kernel import estep_logits, estep_operands
from ..ops.mstep_kernel import MStepOperands, mstep_addition, mstep_operands, mstep_update
from ..utils.barcodes import BarcodeHandler
from ..utils import tracing
from ..utils.device import resolve_device
from .genotypes import ProbabilisticGenotypes

# Stage-timing hook for benchmarks. Set it to an empty dict before calling
# learn_genotypes(_core) / predict_posteriors(_core, _compact) and the entry
# point adds measured wall seconds per stage into it: host packing
# (pack_s), device tables built and uploaded (layout_s), the upload
# finished (upload_flush_s, h2d_bytes), the EM loop (device_loop_s), the
# predict forward (forward_s) and the copies back (materialize_s,
# d2h_logits_s/_bytes, d2h_addition_s/_bytes, d2h_compact_bytes). Only a
# dict makes the entry points synchronise the device between stages; None
# (the default) adds no synchronisation and no copy, and results are the
# same bit for bit either way. Each key's seconds are those of the stage
# spans that name it (_stage).
STAGE_TIMINGS: Optional[dict] = None


@contextmanager
def _stage(name: str, key: str):
    """The stage span ``name``; yields STAGE_TIMINGS, and where it is a dict adds the span's seconds into ``key``."""
    timings = STAGE_TIMINGS
    with tracing.span(name) as stage:
        yield timings
    if timings is not None:
        timings[key] = timings.get(key, 0.0) + stage.seconds


def _flush_device(tensors: Iterable[Optional[torch.Tensor]]) -> int:
    """Wait for the device work behind ``tensors``; return their bytes."""
    tensors = [t for t in tensors if t is not None]
    for device in {t.device for t in tensors if t.is_cuda}:
        torch.cuda.synchronize(device)
    return int(sum(t.numel() * t.element_size() for t in tensors))


def _to_device(array: np.ndarray, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(array)).to(device)


class DeviceCalls(NamedTuple):
    """Collapsed call rows on one device, in both CSR orders.

    Each order carries its row pointers (what the kernels read) and the row
    id of every call (what the plain versions read).
    """

    row_ptr: torch.Tensor  # i64 [B + 1] barcode row pointers (E-step)
    cb_b: torch.Tensor  # i32 [N] barcodes, barcode-sorted
    vid_b: torch.Tensor  # i32 [N] device variant ids, barcode-sorted
    q_b: torch.Tensor  # f32 [N]
    var_ptr: torch.Tensor  # i64 [V + 1] variant row pointers (M-step)
    vid_v: torch.Tensor  # i32 [N] device variant ids, (vid, cb)-sorted
    cb_v: torch.Tensor  # i32 [N] barcodes, (vid, cb)-sorted
    q_v: torch.Tensor  # f32 [N]


class _SnpAggregationLayout(NamedTuple):
    """(barcode, snp) groups of the molecule calls on one device (aggregate_on_snps).

    The grouping depends only on the calls, never on the EM state, so it is
    built once per (dataset, device) and reused by every iteration
    (:meth:`PackedCalls.snp_aggregation_layout`). Groups are numbered in
    (barcode, snp) order, the dense ids of ``utils.lookup.FeatureLookup``,
    and calls are sorted by group, stably: the JAX package's layout, held
    as CSR pointers. ``vid`` indexes the rows of whatever genotype table
    the caller passes: the engine builds it from molecule calls remapped to
    the device (SNP-sorted) variant order.
    """

    vid: torch.Tensor  # i32 [N] variant of every molecule call, sorted by group
    q: torch.Tensor  # f32 [N] p_base_wrong of every molecule call
    group_ptr: torch.Tensor  # i64 [G + 1] first call of every group
    barcode_ptr: torch.Tensor  # i64 [2 + the largest barcode of any group] first group of every barcode

    @classmethod
    def build(cls, molecule_calls: P.MoleculeCalls, device: torch.device) -> "_SnpAggregationLayout":
        # one stable sort by the (barcode, snp) key gives FeatureLookup's
        # dense ids (ranks of the distinct keys) and the calls in group order
        snp_span = int(molecule_calls.snp_id.max()) + 1 if len(molecule_calls) else 1
        key = molecule_calls.compressed_cb.astype(np.int64) * snp_span + molecule_calls.snp_id
        by_group = stable_argsort(key)
        sorted_key = key[by_group]
        first = P._group_boundaries(sorted_key)
        groups_per_barcode = np.bincount(sorted_key[first] // snp_span)
        return cls(
            vid=_to_device(molecule_calls.variant_id[by_group].astype(np.int32), device),
            q=_to_device(molecule_calls.p_base_wrong[by_group].astype(np.float32), device),
            group_ptr=_to_device(np.append(first, len(key)).astype(np.int64), device),
            barcode_ptr=_to_device(np.append(0, np.cumsum(groups_per_barcode)).astype(np.int64), device),
        )

    @property
    def n_groups(self) -> int:
        return self.group_ptr.shape[0] - 1

    def tensors(self) -> tuple:
        return self.vid, self.q, self.group_ptr, self.barcode_ptr

    def operands(self, n_barcodes: int, pairs: np.ndarray, n_donors: int, n_variants: int) -> AggregateOperands:
        """Checked operands of the aggregate E-step over ``n_barcodes`` barcodes (no doublet penalties).

        ``pairs`` int32 [2, PG]: the columns' donor pairs; ``n_variants`` x
        ``n_donors``: the genotype table's shape. Barcodes past the last group
        get no group.
        """
        reached = self.barcode_ptr.shape[0] - 1
        if n_barcodes < reached:
            raise ValueError(f"calls reach barcode {reached - 1}, but n_barcodes={n_barcodes}")
        barcode_ptr = torch.nn.functional.pad(self.barcode_ptr, (0, n_barcodes - reached), value=self.n_groups)
        return aggregate_operands(
            pairs, n_donors, self.vid, self.q, self.group_ptr, barcode_ptr, n_variants,
            compensation=float(Demultiplexer.compensation_during_computing_barcode_logits),
        )


class PackedCalls:
    """Pack once, run many: packed call tables plus a device-tensor cache.

    The calls↔variants join, the (variant, barcode) collapse and the
    SNP-sorted variant reindex depend only on the calls and the genotype
    registry's variant KEYS, never on beta values or the doublet prior.
    Build a :class:`PackedCalls` once and pass it anywhere
    ``chromosome2compressed_snp_calls`` is accepted::

        packed = Demultiplexer.pack_dataset(calls, genotypes)
        learnt, probs_em = Demultiplexer.learn_genotypes(packed, genotypes, handler)
        logits, probs = Demultiplexer.predict_posteriors(packed, learnt, handler)

    Genotype objects passed alongside may differ in beta VALUES (e.g. the
    learnt clone) but must carry the same variant registry; this is checked
    on every use. :meth:`device_calls` caches the device tensors per
    (n_barcodes, device), :meth:`mstep_operands` the M-step's checked
    operands over them, :meth:`snp_aggregation_layout` the (barcode, snp)
    groups of the aggregate_on_snps path per device and
    :meth:`aggregate_operands` its E-step's checked operands.
    """

    @tracing.within("pack")
    def __init__(self, chromosome2compressed_snp_calls, genotypes: ProbabilisticGenotypes):
        self.variant2snp = genotypes.get_snp_ids_for_variants()
        with tracing.span("pack.join"):
            self.molecule_calls = P.match_calls_to_variants(chromosome2compressed_snp_calls, genotypes)
        names, chrom_slots, positions, base_chars, base_slots = genotypes.variant_columns()
        self._registry_key = (
            tuple(names),
            np.array(chrom_slots, copy=True),
            np.array(positions, copy=True),
            tuple(base_chars),
            np.array(base_slots, copy=True),
        )
        with tracing.span("pack.reindex"):
            self.reindex = P.VariantReindex.build(self.variant2snp)
        # (device vid, cb)-sorted: the M-step order with no further sort
        with tracing.span("pack.collapse"):
            self.calls_v = P.collapse_device_order(self.molecule_calls, self.reindex)
        self._calls_b: Optional[tuple] = None
        self._barcode_calls: Optional[np.recarray] = None
        self._device_calls: dict = {}
        self._mstep_operands: dict = {}
        self._snp_layouts: dict = {}
        self._aggregate_operands: dict = {}
        self._sharded_layouts: dict = {}  # parallel.ShardedDemultiplexer's per-shard layouts

    @property
    def barcode_calls(self) -> np.recarray:
        """Reference-shaped collapsed call table, registry variant order (lazy).

        The engine runs on ``calls_v``; this exists for
        :meth:`Demultiplexer.pack_calls`'s 4-tuple.
        """
        if self._barcode_calls is None:
            self._barcode_calls = P.molecule_calls_to_barcode_calls(self.molecule_calls)
        return self._barcode_calls

    def snp_aggregation_layout(self, device: torch.device) -> _SnpAggregationLayout:
        """Cached (barcode, snp) groups on ``device``, variant ids in device order."""
        key = str(device)
        layout = self._snp_layouts.get(key)
        if layout is None:
            calls = self.molecule_calls
            remapped = replace(calls, variant_id=self.reindex.remap_variant_ids(calls.variant_id))
            layout = self._snp_layouts[key] = _SnpAggregationLayout.build(remapped, device)
        return layout

    def aggregate_operands(self, n_barcodes: int, n_donors: int, doublet_prior: float,
                           device: torch.device) -> AggregateOperands:
        """Cached operands of the aggregate E-step (indices checked once on a card) over the layout."""
        compensation = float(Demultiplexer.compensation_during_computing_barcode_logits)
        key = (n_barcodes, n_donors, doublet_prior, compensation, str(device))
        cached = self._aggregate_operands.get(key)
        if cached is None:
            pairs = np.stack(L.pseudogenotype_pairs(n_donors, doublet_prior))
            cached = self._aggregate_operands[key] = self.snp_aggregation_layout(device).operands(
                n_barcodes, pairs, n_donors, self.n_variants)
        return cached

    def calls_by_barcode(self) -> tuple:
        """(cb, vid, q) columns in barcode-major order (cached one-sort view)."""
        if self._calls_b is None:
            self._calls_b = self.calls_v.by_barcode()
        return self._calls_b

    @property
    def n_variants(self) -> int:
        return len(self.variant2snp)

    def verify_registry(self, genotypes: ProbabilisticGenotypes) -> None:
        """Raise if ``genotypes`` carries a different variant registry."""
        names, chrom_slots, positions, base_chars, base_slots = genotypes.variant_columns()
        ok = (
            tuple(names) == self._registry_key[0]
            and np.array_equal(chrom_slots, self._registry_key[1])
            and np.array_equal(positions, self._registry_key[2])
            and tuple(base_chars) == self._registry_key[3]
            and np.array_equal(base_slots, self._registry_key[4])
        )
        if not ok:
            raise ValueError(
                "PackedCalls was built against a different variant registry; "
                "beta values may change between uses (e.g. the learnt clone) "
                "but variants may not — re-pack with Demultiplexer.pack_dataset"
            )

    @tracing.within("betas_for")
    def betas_for(self, genotypes: ProbabilisticGenotypes, add_data_prior: bool) -> np.ndarray:
        """Regularized prior betas for THIS genotypes object (recomputed, cheap)."""
        self.verify_registry(genotypes)
        return P.compute_prior_betas(
            genotypes, self.molecule_calls, self.variant2snp, add_data_prior=add_data_prior
        )

    def device_calls(self, n_barcodes: int, device: torch.device) -> DeviceCalls:
        """Cached device tensors of both call orders with their row pointers."""
        key = (n_barcodes, str(device))
        cached = self._device_calls.get(key)
        if cached is None:
            cb_b, vid_b, q_b = self.calls_by_barcode()
            calls_v = self.calls_v
            cached = DeviceCalls(
                row_ptr=_to_device(P.csr_row_pointers(cb_b, n_barcodes), device),
                cb_b=_to_device(cb_b, device),
                vid_b=_to_device(vid_b, device),
                q_b=_to_device(q_b, device),
                var_ptr=_to_device(P.csr_row_pointers(calls_v.vid, self.n_variants), device),
                vid_v=_to_device(calls_v.vid, device),
                cb_v=_to_device(calls_v.cb, device),
                q_v=_to_device(calls_v.q, device),
            )
            self._device_calls[key] = cached
        return cached

    def mstep_operands(self, n_barcodes: int, device: torch.device) -> MStepOperands:
        """Cached M-step operands on ``device``: indices checked once, SNP runs where they are short enough."""
        key = (n_barcodes, str(device))
        cached = self._mstep_operands.get(key)
        if cached is None:
            c = self.device_calls(n_barcodes, device)
            windowed = self.reindex.windowed_max_per_snp > 0  # else the EM normalises on the segment path
            snp_ptr = _to_device(self.reindex.snp_pointers(), device) if windowed else None
            cached = self._mstep_operands[key] = mstep_operands(c.var_ptr, c.vid_v, c.cb_v, c.q_v, n_barcodes,
                                                                snp_ptr=snp_ptr)
        return cached


def ensure_packed(chromosome2compressed_snp_calls, genotypes) -> PackedCalls:
    """Route any calls input through one PackedCalls (transient for dicts)."""
    if isinstance(chromosome2compressed_snp_calls, PackedCalls):
        return chromosome2compressed_snp_calls
    return PackedCalls(chromosome2compressed_snp_calls, genotypes)


class _Likelihood:
    """E-step and M-step operands of one dataset and doublet prior on a device.

    With ``Demultiplexer.aggregate_on_snps`` the E-step is the per-SNP
    aggregation over the dataset's (barcode, snp) groups; the M-step is the
    kernel on the collapsed variant-CSR calls either way.
    """

    def __init__(self, packed: PackedCalls, n_barcodes: int, genotype_names: List[str],
                 doublet_prior: float, device: torch.device):
        assert 0 <= doublet_prior < 1
        self.column_names = L.pseudogenotype_names(genotype_names, doublet_prior)
        self.n_barcodes = n_barcodes
        self.calls = c = packed.device_calls(n_barcodes, device)
        self.estep = estep_operands(len(genotype_names), doublet_prior, c.row_ptr, c.cb_b, c.vid_b, c.q_b)
        self.mstep = packed.mstep_operands(n_barcodes, device)
        self.snp_groups = (packed.aggregate_operands(n_barcodes, len(genotype_names), doublet_prior, device)
                           if Demultiplexer.aggregate_on_snps else None)

    @property
    def n_options(self) -> int:
        return len(self.column_names)

    def tensors(self) -> list:
        """Every device tensor the E-step and M-step read."""
        groups = self.snp_groups.tensors() if self.snp_groups is not None else ()
        runs = [self.mstep.snp_ptr] if self.mstep.snp_ptr is not None else []
        return [*self.calls, *runs, self.estep.penalties, self.estep.schedule, self.estep.mixing, *groups]

    def logits(self, genotype_prob: torch.Tensor) -> torch.Tensor:
        if self.snp_groups is not None:
            return aggregated_logits(genotype_prob, self.snp_groups)
        return estep_logits(genotype_prob, self.estep)

    def posteriors(self, genotype_prob: torch.Tensor,
                   prior_logits: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
        """(logits + prior_logits, their row softmax): one fused kernel launch on the kernel path."""
        if self.snp_groups is not None:
            return aggregated_logits(genotype_prob, self.snp_groups, prior_logits=prior_logits, softmax=True)
        return estep_logits(genotype_prob, self.estep, prior_logits=prior_logits, softmax=True)

    def addition(self, probs: torch.Tensor, n_genotypes: int) -> torch.Tensor:
        return mstep_addition(probs, self.mstep, n_genotypes, float(Demultiplexer.contribution_power))

    def update(self, probs: torch.Tensor, prior_betas: torch.Tensor, anchor_mask: Optional[torch.Tensor],
               p_genotype_clip: float, n_genotypes: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """(masked addition, next genotype probabilities): one fused launch on the kernel path."""
        return mstep_update(probs, self.mstep, prior_betas, anchor_mask, p_genotype_clip, n_genotypes,
                            float(Demultiplexer.contribution_power))


class EMState(NamedTuple):
    """One EM iteration on the device (variant rows in device order)."""

    probs: torch.Tensor  # f32 [B, PG] posterior
    logits: torch.Tensor  # f32 [B, PG]
    addition: torch.Tensor  # f32 [V, D] beta addition ENTERING the iteration


class _EMRun:
    """Device-resident EM loop state shared by the learning entry points.

    ``device_iterations`` yields per-iteration device tensors only;
    ``materialize`` converts one yielded state into the reference-shaped
    (posterior df, debug dict), so ``learn_genotypes`` moves one iteration
    to the host while ``staged_genotype_learning`` keeps the reference's
    per-iteration generator (demuxalot/demux.py:68-118).
    """

    @tracing.within("em.setup")
    def __init__(
        self,
        chromosome2compressed_snp_calls,
        genotypes: ProbabilisticGenotypes,
        barcode_handler: BarcodeHandler,
        n_iterations: int,
        p_genotype_clip: float,
        doublet_prior: float,
        barcode_prior_logits: Optional[np.ndarray],
        damping: Optional[str] = None,
    ):
        if damping not in (None, "anchor"):
            raise ValueError(
                f"damping must be None or 'anchor', got {damping!r}"
                + (" ('auto' is only available through learn_genotypes, which"
                   " needs the whole trajectory to decide)" if damping == "auto" else "")
            )
        device = resolve_device(Demultiplexer.device)
        with _stage("em.prior", "pack_s"):
            packed = ensure_packed(chromosome2compressed_snp_calls, genotypes)
            self.prior_betas = packed.betas_for(genotypes, add_data_prior=True)
        self.barcode_handler = barcode_handler
        self.n_iterations = n_iterations
        self.p_genotype_clip = p_genotype_clip
        self.n_variants, self.n_genotypes = self.prior_betas.shape
        self.n_snps = int(packed.variant2snp.max()) + 1 if self.n_variants else 0
        self.reindex = packed.reindex
        self.max_per_snp = self.reindex.windowed_max_per_snp
        with _stage("em.operands", "layout_s"):
            self.likelihood = _Likelihood(
                packed, barcode_handler.n_barcodes, genotypes.genotype_names, doublet_prior, device
            )
        self.column_names = self.likelihood.column_names
        if barcode_prior_logits is not None:
            assert barcode_prior_logits.shape == (
                barcode_handler.n_barcodes, self.likelihood.n_options,
            ), "wrong shape of priors"

        with _stage("em.uploads", "layout_s") as timings:
            # the EM space uses SNP-sorted variant rows (windowed denominators);
            # additions are mapped back to registry order on the host
            self.variant2snp = _to_device(self.reindex.variant2snp, device)
            self.prior_betas_dev = _to_device(self.reindex.permute_rows(self.prior_betas), device)
            # damping="anchor": M-step additions apply only at variants whose
            # GENOTYPE prior carries information (nonzero betas before the data
            # prior); built from the packed betas the mask would be all ones
            self.anchor_mask = None
            if damping == "anchor":
                registry_mask = (np.asarray(genotypes.get_betas()).sum(axis=1) > 0).astype(np.float32)
                self.anchor_mask = _to_device(registry_mask[self.reindex.order][:, None], device)
            self.prior_logits = (
                _to_device(np.asarray(barcode_prior_logits, dtype=np.float32), device)
                if barcode_prior_logits is not None else None
            )
        if timings is not None:
            with _stage("em.flush", "upload_flush_s"):
                timings["h2d_bytes"] = timings.get("h2d_bytes", 0) + _flush_device([
                    self.variant2snp, self.prior_betas_dev, self.anchor_mask, self.prior_logits,
                    *self.likelihood.tensors(),
                ])

    def device_iterations(self):
        """Yield an :class:`EMState` per EM iteration (the last runs no M-step).

        With SNP runs of at most ``MAX_WINDOWED_RUN`` variants each M-step
        is one ``mstep_update`` launch that also normalises the next
        iteration's genotype probabilities; otherwise the addition-only
        kernel, the mask and ``probs_from_betas``' segment path.
        """
        likelihood = self.likelihood
        addition = torch.zeros_like(self.prior_betas_dev)
        with tracing.step("em.normalise"):
            genotype_prob = self._normalise(addition)
        for iteration in range(self.n_iterations):
            with tracing.step("em.estep"):
                logits, probs = likelihood.posteriors(genotype_prob, self.prior_logits if iteration == 0 else None)
            yield EMState(probs, logits, addition)
            if iteration == self.n_iterations - 1:
                break
            if likelihood.mstep.snp_ptr is not None:
                with tracing.step("em.mstep"):
                    addition, genotype_prob = likelihood.update(
                        probs, self.prior_betas_dev, self.anchor_mask, self.p_genotype_clip, self.n_genotypes)
                continue
            with tracing.step("em.mstep"):
                addition = likelihood.addition(probs, self.n_genotypes)
                if self.anchor_mask is not None:
                    addition = addition * self.anchor_mask
            with tracing.step("em.normalise"):
                genotype_prob = self._normalise(addition)

    def _normalise(self, addition: torch.Tensor) -> torch.Tensor:
        return L.probs_from_betas(self.prior_betas_dev + addition, self.variant2snp, self.n_snps,
                                  self.p_genotype_clip, max_per_snp=self.max_per_snp)

    @tracing.within("registry_addition")
    def registry_addition(self, state: EMState) -> np.ndarray:
        """The state's beta addition on the host, in registry variant order."""
        return self.reindex.unpermute_rows(_addition_to_host(state.addition))

    @tracing.within("materialize")
    def materialize(self, state: EMState):
        """One device state → (posterior probs df, debug dict) on the host."""
        debug_information = {
            "barcode_logits": state.logits.cpu().numpy(),
            "genotype_prior": self.prior_betas,
            "genotype_addition": self.registry_addition(state),
        }
        return _frame(state.probs.cpu().numpy(), self.barcode_handler, self.column_names), debug_information


def _addition_to_host(addition: torch.Tensor) -> np.ndarray:
    """The addition's device-to-host copy: the ``d2h.addition`` span (``d2h_addition_s``, ``d2h_addition_bytes``)."""
    with _stage("d2h.addition", "d2h_addition_s") as timings:
        addition = addition.cpu().numpy()
    if timings is not None:
        timings["d2h_addition_bytes"] = int(addition.nbytes)
    return addition


def _frame(values: np.ndarray, barcode_handler: BarcodeHandler, column_names, index_name=None):
    import pandas as pd

    frame = pd.DataFrame(data=values, index=list(barcode_handler.ordered_barcodes), columns=column_names)
    frame.index.name = index_name
    return frame


class LearnResult(NamedTuple):
    """What :meth:`Demultiplexer.learn_genotypes_core` returns."""

    genotypes: ProbabilisticGenotypes  # the learnt genotypes
    state: EMState  # the last EM iteration, on the device
    column_names: List[str]
    # damping="auto" only (None otherwise): the damping the selection took
    # ("anchor", or None for plain EM) and the disagreement it measured
    damping_selected: Optional[str] = None
    anchored_disagreement: Optional[float] = None


def auto_damping_select(probs_plain: torch.Tensor, probs_anchor: torch.Tensor,
                        n_genotypes: int) -> Tuple[Optional[str], float]:
    """damping="auto"'s choice from the posteriors of a plain and an anchored run.

    Among barcodes whose best singlet posterior under plain EM reaches
    ``Demultiplexer.auto_damping_confidence`` (all barcodes when none
    does), the fraction whose singlet argmax differs from the anchored
    run's. Above ``auto_damping_disagreement_threshold`` plain EM is taken
    to have diverged. Returns (``"anchor"`` or None, disagreement); the
    rule of ``demuxalot_tpu.models.demux.auto_damping_select``.
    """
    singlets_plain = probs_plain[:, :n_genotypes]
    assign_plain = singlets_plain.argmax(dim=1)  # first maximum, as np.argmax
    assign_anchor = probs_anchor[:, :n_genotypes].argmax(dim=1)
    confident = singlets_plain.max(dim=1).values >= Demultiplexer.auto_damping_confidence
    differs = assign_plain != assign_anchor
    counted = differs[confident] if bool(confident.any()) else differs
    disagreement = int(counted.sum()) / max(counted.numel(), 1)
    anchored = disagreement > Demultiplexer.auto_damping_disagreement_threshold
    return ("anchor" if anchored else None), disagreement


@dataclass
class CompactPosteriors:
    """Compact posterior result: the device's top-k instead of full frames.

    ``top_logits``/``top_index`` are the k best pseudogenotype logits per
    barcode (exact f32 frame entries, descending, ties toward the lowest
    index); ``logsumexp`` is the per-row softmax normalizer, so
    ``exp(top_logits - logsumexp[:, None])`` gives the exact top-k
    posterior probabilities without the full frame. ``logits_bf16`` (only
    when requested) is the full frame as a CPU ``torch.bfloat16`` tensor
    (numpy has no bfloat16): every entry the f32 value rounded to nearest.
    Same contract as ``demuxalot_tpu.models.demux.CompactPosteriors``.
    """

    column_names: list
    barcodes: list
    top_index: np.ndarray  # [n, k] int32, descending by logit
    top_logits: np.ndarray  # [n, k] float32 (exact frame entries)
    logsumexp: np.ndarray  # [n] float32
    logits_bf16: Optional[torch.Tensor]  # [n, n_pg] bfloat16 on the CPU, or None
    bytes_moved: int  # device -> host bytes of the arrays above

    @property
    def assignment(self) -> np.ndarray:
        """argmax pseudogenotype index per barcode (== full-frame argmax)."""
        return self.top_index[:, 0]

    @property
    def k(self) -> int:
        return self.top_index.shape[1]

    @property
    def runner_up(self) -> np.ndarray:
        if self.k < 2:
            raise ValueError(
                "no runner-up recorded: the result holds top-1 only "
                "(k=1, or a single pseudogenotype column)"
            )
        return self.top_index[:, 1]

    @property
    def margin(self) -> np.ndarray:
        """Top-1 minus top-2 logit (f32, exact)."""
        if self.k < 2:
            raise ValueError(
                "no margin available: the result holds top-1 only "
                "(k=1, or a single pseudogenotype column)"
            )
        return self.top_logits[:, 0] - self.top_logits[:, 1]

    @property
    def top_probs(self) -> np.ndarray:
        """Posterior probability of each of the k best pseudogenotypes."""
        return np.exp(
            self.top_logits.astype(np.float64) - self.logsumexp.astype(np.float64)[:, None]
        ).astype(np.float32)

    @property
    def assignment_names(self) -> list:
        return [self.column_names[i] for i in self.top_index[:, 0]]

    def to_dataframe(self):
        """Compact per-barcode summary frame (BARCODE-indexed).

        The runner-up/margin columns are present only when k >= 2.
        """
        import pandas as pd

        columns = {"assignment": self.assignment_names}
        if self.k >= 2:
            columns["runner_up"] = [self.column_names[i] for i in self.runner_up]
            columns["logit_margin"] = self.margin
        columns["posterior"] = self.top_probs[:, 0]
        df = pd.DataFrame(columns, index=list(self.barcodes))
        df.index.name = "BARCODE"
        return df

    def logits_dataframe(self):
        """Full logits frame upcast from bfloat16 (requires include_logits)."""
        if self.logits_bf16 is None:
            raise ValueError(
                "full logits were not requested; pass include_logits=True to "
                "predict_posteriors_compact"
            )
        import pandas as pd

        df = pd.DataFrame(
            data=self.logits_bf16.float().numpy(), index=list(self.barcodes), columns=self.column_names,
        )
        df.index.name = "BARCODE"
        return df


def _validate_topk(k, n_columns: int) -> int:
    """Clamp k into [1, n_columns]; reject non-positive requests early."""
    if int(k) < 1:
        raise ValueError(f"k must be >= 1, got {k}")
    return int(min(int(k), n_columns))


def compact_topk(logits: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(top-k values f32, top-k indices i32, row logsumexp f32), on the logits' device.

    A stable descending sort keeps equal logits in column order, so ties
    go to the lowest index, the rule of ``np.argmax`` and ``lax.top_k``
    (``torch.topk`` promises no order among equal values).
    """
    values, index = torch.sort(logits, dim=1, descending=True, stable=True)
    return values[:, :k], index[:, :k].to(torch.int32), torch.logsumexp(logits, dim=1)


class Demultiplexer:
    """Demultiplexer that can also learn (refine) genotypes from the data."""

    # contribution_power dampens contributions from barcodes that have no
    # clearly-best candidate donor
    contribution_power = 2.0
    # the reference's alternative likelihood: per-(barcode, snp) groups,
    # damped by molecule count**compensation, with a bad-SNP floor and no
    # doublet penalties (ops.aggregate_kernel.aggregated_logits); read by
    # every entry point
    aggregate_on_snps = False
    compensation_during_computing_barcode_logits = 0.5
    # explicit device, no silent CPU path: "cuda" raises without a card
    device = "cuda"
    # damping="auto": plain-vs-anchored disagreement among plain-confident
    # barcodes above this fraction means plain EM diverged (measured on the
    # JAX package's quality sweeps: converging runs <= 0.052, diverging
    # ones >= 0.239)
    auto_damping_disagreement_threshold = 0.15
    auto_damping_confidence = 0.9

    # -- array cores --------------------------------------------------------
    @staticmethod
    @tracing.within("learn")
    def learn_genotypes_core(
        chromosome2compressed_snp_calls,
        genotypes: ProbabilisticGenotypes,
        barcode_handler: BarcodeHandler,
        n_iterations: int = 5,
        p_genotype_clip: float = 0.01,
        doublet_prior: float = 0.0,
        barcode_prior_logits: Optional[np.ndarray] = None,
        damping: Optional[str] = None,
    ) -> LearnResult:
        """EM without data frames (see :class:`LearnResult`).

        ``damping="auto"`` packs once and runs a plain and an anchored EM
        through this core, then keeps one of them by
        :func:`auto_damping_select`.
        """
        if damping == "auto":
            packed = ensure_packed(chromosome2compressed_snp_calls, genotypes)
            runs = {
                choice: Demultiplexer.learn_genotypes_core(
                    packed, genotypes, barcode_handler, n_iterations, p_genotype_clip,
                    doublet_prior, barcode_prior_logits, damping=choice,
                )
                for choice in (None, "anchor")
            }
            selected, disagreement = auto_damping_select(
                runs[None].state.probs, runs["anchor"].state.probs, genotypes.n_genotypes,
            )
            return runs[selected]._replace(damping_selected=selected, anchored_disagreement=disagreement)
        run = _EMRun(
            chromosome2compressed_snp_calls, genotypes, barcode_handler,
            n_iterations, p_genotype_clip, doublet_prior, barcode_prior_logits,
            damping=damping,
        )
        with _stage("em.loop", "device_loop_s") as timings:
            state = None
            for state in run.device_iterations():
                pass
            if state is None:
                raise ValueError("n_iterations must be >= 1")
            if timings is not None:
                _flush_device(state)
        with _stage("materialize", "materialize_s"):
            learnt_genotypes = genotypes._with_betas(genotypes.get_betas() + run.registry_addition(state))
        return LearnResult(learnt_genotypes, state, run.column_names)

    @staticmethod
    def _predict_logits(
        chromosome2compressed_snp_calls,
        genotypes: ProbabilisticGenotypes,
        barcode_handler: BarcodeHandler,
        p_genotype_clip: float,
        doublet_prior: float,
        softmax: bool = False,
    ) -> Tuple[object, List[str]]:
        """The posterior forward: (logits on the device, or (logits, probs) with ``softmax``; column names)."""
        device = resolve_device(Demultiplexer.device)
        with _stage("predict.prior", "pack_s"):
            packed = ensure_packed(chromosome2compressed_snp_calls, genotypes)
            prior_betas = packed.betas_for(genotypes, add_data_prior=False)
        n_snps = int(packed.variant2snp.max()) + 1 if packed.n_variants else 0
        with _stage("predict.operands", "layout_s"):
            likelihood = _Likelihood(
                packed, barcode_handler.n_barcodes, genotypes.genotype_names, doublet_prior, device
            )
        with _stage("predict.uploads", "layout_s") as timings:
            # logits are invariant to the SNP-sorted renumbering: nothing maps back
            reindex = packed.reindex
            betas = _to_device(reindex.permute_rows(prior_betas), device)
            variant2snp = _to_device(reindex.variant2snp, device)
        if timings is not None:
            with _stage("predict.flush", "upload_flush_s"):
                timings["h2d_bytes"] = timings.get("h2d_bytes", 0) + _flush_device(
                    [betas, variant2snp, *likelihood.tensors()])
        with _stage("predict.forward", "forward_s"):
            genotype_prob = L.probs_from_betas(
                betas, variant2snp, n_snps, p_genotype_clip, max_per_snp=reindex.windowed_max_per_snp,
            )
            out = likelihood.posteriors(genotype_prob) if softmax else likelihood.logits(genotype_prob)
            if timings is not None:
                _flush_device(out if softmax else [out])
        return out, likelihood.column_names

    @staticmethod
    @tracing.within("predict")
    def predict_posteriors_core(
        chromosome2compressed_snp_calls,
        genotypes: ProbabilisticGenotypes,
        barcode_handler: BarcodeHandler,
        p_genotype_clip: float = 0.01,
        doublet_prior: float = 0.35,
    ) -> Tuple[torch.Tensor, torch.Tensor, List[str]]:
        """Posterior inference without data frames: (logits, probs, column names)."""
        (logits, probs), column_names = Demultiplexer._predict_logits(
            chromosome2compressed_snp_calls, genotypes, barcode_handler, p_genotype_clip, doublet_prior,
            softmax=True,
        )
        return logits, probs, column_names

    # -- public API ---------------------------------------------------------
    @staticmethod
    @tracing.within("learn")
    def learn_genotypes(
        chromosome2compressed_snp_calls,
        genotypes: ProbabilisticGenotypes,
        barcode_handler: BarcodeHandler,
        n_iterations: int = 5,
        p_genotype_clip: float = 0.01,
        doublet_prior: float = 0.0,
        barcode_prior_logits: Optional[np.ndarray] = None,
        damping: Optional[str] = None,
    ):
        """EM-refine genotypes from data, starting from an initial guess.

        :param chromosome2compressed_snp_calls: per-chromosome
            ``CompressedSNPCalls`` or a :class:`PackedCalls`
        :param genotypes: initial genotypes (e.g. from a bead array or WGS)
        :param barcode_handler: which barcodes to consider
        :param n_iterations: number of EM iterations
        :param p_genotype_clip: minimal probability assigned to a polymorphism
        :param doublet_prior: prior fraction of doublets; zero skips doublet
            columns entirely
        :param barcode_prior_logits: optional [n_barcodes, n_options] prior
            assignment logits, applied at the first iteration only
        :param damping: None (reference-parity EM), "anchor" (M-step
            updates only at variants whose genotype prior is informative:
            cannot diverge where plain EM does, but never refines prior-less
            variants) or "auto" (runs both; keeps the anchored result when
            plain EM's confident assignments disagree with it, see
            :func:`auto_damping_select`). With "auto" the frame's ``attrs``
            carry ``damping_selected`` and ``anchored_disagreement``.
        :return: (learnt genotypes, last-iteration barcode posterior probs)
        """
        result = Demultiplexer.learn_genotypes_core(
            chromosome2compressed_snp_calls, genotypes, barcode_handler, n_iterations,
            p_genotype_clip, doublet_prior, barcode_prior_logits, damping,
        )
        with _stage("materialize", "materialize_s"):
            probs = _frame(result.state.probs.cpu().numpy(), barcode_handler, result.column_names)
        if damping == "auto":
            probs.attrs["damping_selected"] = result.damping_selected
            probs.attrs["anchored_disagreement"] = result.anchored_disagreement
        return result.genotypes, probs

    @staticmethod
    def staged_genotype_learning(
        chromosome2compressed_snp_calls,
        genotypes: ProbabilisticGenotypes,
        barcode_handler: BarcodeHandler,
        n_iterations: int = 5,
        p_genotype_clip: float = 0.01,
        doublet_prior: float = 0.0,
        barcode_prior_logits: Optional[np.ndarray] = None,
        damping: Optional[str] = None,
    ):
        """Generator EM loop; yields (posterior probs df, debug info) per iteration.

        The prior betas stay frozen; learning accumulates into a separate
        additive term (``genotype_addition``), and only singlet posterior
        columns drive the M-step (reference: demuxalot/demux.py:68-118).
        ``damping`` is None or "anchor": "auto" needs the whole trajectory.
        """
        run = _EMRun(
            chromosome2compressed_snp_calls, genotypes, barcode_handler,
            n_iterations, p_genotype_clip, doublet_prior, barcode_prior_logits,
            damping=damping,
        )
        for state in run.device_iterations():
            yield run.materialize(state)

    @staticmethod
    @tracing.within("predict")
    def predict_posteriors(
        chromosome2compressed_snp_calls,
        genotypes: ProbabilisticGenotypes,
        barcode_handler: BarcodeHandler,
        p_genotype_clip: float = 0.01,
        doublet_prior: float = 0.35,
    ):
        """Posterior donor assignment for every barcode (no learning).

        Returns (logits_df, probs_df), both indexed by 'BARCODE' with columns
        = donors plus 'DonorA+DonorB' doublets.
        """
        logits, probs, column_names = Demultiplexer.predict_posteriors_core(
            chromosome2compressed_snp_calls, genotypes, barcode_handler,
            p_genotype_clip, doublet_prior,
        )
        with _stage("materialize", "materialize_s"):
            with _stage("d2h.logits", "d2h_logits_s") as timings:
                logits = logits.cpu().numpy()
            if timings is not None:
                timings["d2h_logits_bytes"] = int(logits.nbytes)
            probs = probs.cpu().numpy()
            return (
                _frame(logits, barcode_handler, column_names, index_name="BARCODE"),
                _frame(probs, barcode_handler, column_names, index_name="BARCODE"),
            )

    @staticmethod
    @tracing.within("predict")
    def predict_posteriors_compact(
        chromosome2compressed_snp_calls,
        genotypes: ProbabilisticGenotypes,
        barcode_handler: BarcodeHandler,
        p_genotype_clip: float = 0.01,
        doublet_prior: float = 0.35,
        k: int = 4,
        include_logits: bool = False,
    ) -> CompactPosteriors:
        """Posterior inference that moves only the top-k to the host.

        The forward of :meth:`predict_posteriors`, then the top-``k``
        logits and indices and the row logsumexp on the device
        (:func:`compact_topk`): (8k+4) bytes per barcode cross to the host
        instead of the full f32 frame. Assignments equal the argmax of the
        full f32 frame (same values, ties to the lowest index) and the
        top-k logits are exact frame entries. ``include_logits=True`` also
        returns the full frame as bfloat16 (half the bytes).
        """
        n_columns = len(L.pseudogenotype_names(genotypes.genotype_names, doublet_prior))
        k = _validate_topk(k, n_columns)
        logits, column_names = Demultiplexer._predict_logits(
            chromosome2compressed_snp_calls, genotypes, barcode_handler, p_genotype_clip, doublet_prior,
        )
        with tracing.span("compact_topk"):
            top_logits, top_index, logsumexp = compact_topk(logits, k)
        logits_bf16 = logits.to(torch.bfloat16) if include_logits else None
        with _stage("materialize", "materialize_s") as timings:
            top_logits, top_index, logsumexp = (t.cpu().numpy() for t in (top_logits, top_index, logsumexp))
            logits_bf16 = logits_bf16.cpu() if include_logits else None
            bytes_moved = top_logits.nbytes + top_index.nbytes + logsumexp.nbytes + (
                logits_bf16.numel() * logits_bf16.element_size() if logits_bf16 is not None else 0
            )
        if timings is not None:
            timings["d2h_compact_bytes"] = int(bytes_moved)
        return CompactPosteriors(
            column_names=list(column_names),
            barcodes=list(barcode_handler.ordered_barcodes),
            top_index=top_index,
            top_logits=top_logits,
            logsumexp=logsumexp,
            logits_bf16=logits_bf16,
            bytes_moved=int(bytes_moved),
        )

    @staticmethod
    def pack_dataset(chromosome2compressed_snp_calls, genotypes) -> PackedCalls:
        """Pack once for reuse across entry points (see :class:`PackedCalls`)."""
        return PackedCalls(chromosome2compressed_snp_calls, genotypes)

    # -- the reference's helper names (numpy in, numpy out) ------------------
    @staticmethod
    def pack_calls(chromosome2compressed_snp_calls, genotypes, add_data_prior: bool):
        """(variant2snp, regularized betas, molecule calls, barcode calls), the reference's 4-tuple."""
        if isinstance(chromosome2compressed_snp_calls, PackedCalls):
            packed = chromosome2compressed_snp_calls
            return (packed.variant2snp, packed.betas_for(genotypes, add_data_prior),
                    packed.molecule_calls, packed.barcode_calls)
        return P.pack_calls(chromosome2compressed_snp_calls, genotypes, add_data_prior)

    @staticmethod
    def _doublet_penalties(n_genotypes: int, doublet_prior: float) -> np.ndarray:
        return L.doublet_penalties(n_genotypes, doublet_prior)

    @staticmethod
    def molecule_calls2barcode_calls(molecule_calls):
        return P.molecule_calls_to_barcode_calls(molecule_calls)

    @staticmethod
    def _compute_probs_from_betas(variant_index2snp_index, variant_index2betas, p_genotype_clip):
        """Per-donor variant probabilities, on ``Demultiplexer.device``."""
        device = resolve_device(Demultiplexer.device)
        variant2snp = np.asarray(variant_index2snp_index, dtype=np.int64)
        n_snps = int(variant2snp.max()) + 1 if len(variant2snp) else 0
        probs = L.probs_from_betas(
            _to_device(np.asarray(variant_index2betas, dtype=np.float32), device),
            _to_device(variant2snp, device), n_snps, p_genotype_clip,
        )
        return probs.cpu().numpy()

    @staticmethod
    def _iterate_genotypes_options(genotype_names, genotype_prob: np.ndarray, doublet_prior: float):
        """Yield (pseudogenotype index, name, per-variant prob) incl. doublets."""
        mixing, names = L.pseudogenotype_mixing(list(genotype_names), doublet_prior)
        expanded = genotype_prob @ mixing
        for pg_index, name in enumerate(names):
            yield pg_index, name, expanded[:, pg_index]

    @staticmethod
    def compute_barcode_logits(
        genotype_names, barcode_calls, molecule_calls, doublet_prior: float,
        genotype_prob: np.ndarray, n_barcodes: int, n_genotypes: int,
    ):
        """(logits, column names); dispatches on ``aggregate_on_snps``."""
        if Demultiplexer.aggregate_on_snps:
            mixing, column_names = L.pseudogenotype_mixing(list(genotype_names), doublet_prior)
            penalties = L.doublet_penalties(n_genotypes, doublet_prior)
            logits = Demultiplexer._compute_logits_aggregating_on_snps(
                genotype_prob, mixing, penalties, molecule_calls, n_barcodes)
            return logits, column_names
        return Demultiplexer.compute_barcode_logits_using_barcode_calls(
            genotype_names, barcode_calls, doublet_prior, genotype_prob, n_barcodes, n_genotypes)

    @staticmethod
    def compute_barcode_logits_using_barcode_calls(
        genotype_names, barcode_calls, doublet_prior: float, genotype_prob: np.ndarray,
        n_barcodes: int, n_genotypes: int,
    ):
        """Logits over collapsed barcode calls through the E-step on ``Demultiplexer.device``."""
        device = resolve_device(Demultiplexer.device)
        cb = np.asarray(barcode_calls["compressed_cb"], dtype=np.int32)
        order = stable_argsort(cb)
        cb = cb[order]
        operands = estep_operands(
            n_genotypes, doublet_prior, _to_device(P.csr_row_pointers(cb, n_barcodes), device),
            _to_device(cb, device),
            _to_device(np.asarray(barcode_calls["variant_id"], dtype=np.int32)[order], device),
            _to_device(np.asarray(barcode_calls["p_base_wrong"], dtype=np.float32)[order], device),
        )
        logits = estep_logits(_to_device(np.asarray(genotype_prob, dtype=np.float32), device), operands)
        return logits.cpu().numpy(), L.pseudogenotype_names(list(genotype_names), doublet_prior)

    @staticmethod
    def _compute_logits_aggregating_on_snps(
        genotype_prob: np.ndarray,
        mixing: np.ndarray,
        penalties: np.ndarray,
        molecule_calls: P.MoleculeCalls,
        n_barcodes: int,
    ) -> np.ndarray:
        """Per-SNP aggregation logits on ``Demultiplexer.device``.

        ``molecule_calls`` index the rows of ``genotype_prob``. As in the
        reference, the doublet penalties are not applied on this path
        (demuxalot/demux.py:239-244 computes but never adds them). The EM
        loop does not come here: it keeps its layout on ``PackedCalls``.
        """
        del penalties
        device = resolve_device(Demultiplexer.device)
        mixing = np.asarray(mixing, dtype=np.float32)
        genotype_prob = _to_device(np.asarray(genotype_prob, dtype=np.float32), device)
        operands = _SnpAggregationLayout.build(molecule_calls, device).operands(
            n_barcodes, L.column_pairs(mixing), mixing.shape[0], genotype_prob.shape[0])
        return aggregated_logits(genotype_prob, operands).cpu().numpy()
