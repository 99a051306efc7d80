"""Barcode-sharded inference and EM over a mesh of devices and processes.

The counterpart of ``demuxalot_tpu/parallel/sharded.py`` (shard_map +
psum there). Shard s of a :class:`~.mesh.Mesh` owns the contiguous barcode
range ``[s·W, (s+1)·W)`` with ``W = ceil(max(B, n_shards) / n_shards)``:
its calls in both CSR orders (barcode ids made local), its logits rows and
its slice of the posterior. The last shard's range runs past the last
barcode; those rows have no calls, get the penalties-only logits the
single-device engine gives any barcode without calls, and are cut off
before results leave the engine. Genotype tables are replicated, once per
distinct device.

One EM iteration runs, per shard, ``probs_from_betas`` on its device's
copy of betas + addition, the E-step kernel with its fused softmax
(``estep_logits``, ``softmax=True``) and the M-step kernel
(``mstep_addition``) into a [V, D] partial. The addition-only kernel:
the normalisation needs the reduced sum, so the single-device engine's
fused ``mstep_update`` does not apply here.
The partials are then summed once, the counterpart of the JAX engine's
psum: within a process in shard order on the first shard's device (no
atomics, a fixed order), across processes by ``all_reduce(SUM)``. The
anchor mask multiplies the sum, which is then copied to every shard device.

Each barcode's E-step is one kernel warp over that barcode's calls in
order, so the first E-step of an EM (addition 0) and every predict give
the single-device engine's logits bit for bit on the same device. After an
M-step the partial sums differ from one sequential per-variant sum in
association only.

Per-shard device layouts are cached on the dataset (``_sharded_layouts``
of a :class:`~..models.demux.PackedCalls` or :class:`ColumnDataset`), so a
predict after a learn on one dataset lays out nothing again. Several
processes each hold only their own shards' calls on their devices; they
check that they see the same dataset dimensions, and results come back
through :func:`~.mesh.to_host`. The stages are the single-device engine's
spans of ``utils.tracing``, under the same names, and feed
``models.demux.STAGE_TIMINGS`` the same keys.
"""
from __future__ import annotations

from typing import List, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..models import demux as _dm
from ..models.demux import CompactPosteriors, Demultiplexer, compact_topk, ensure_packed
from ..ops import likelihood as L
from ..ops.likelihood_kernel import estep_logits, estep_operands
from ..ops.mstep_kernel import mstep_addition, mstep_operands
from ..ops.packing import CallColumns, csr_row_pointers
from ..utils import tracing
from .mesh import Mesh, allreduce_max_dims, local_shard_ids, make_mesh, to_host


class ColumnDataset:
    """A dataset of raw call columns that the shard layouts read.

    Exactly the part of :class:`~..models.demux.PackedCalls` the layout
    builder reads: the calls barcode-major (:meth:`calls_by_barcode`), the
    calls in (vid, cb) order (``calls_v``) and the layout cache, so
    synthetic workloads can drive the layouts without genotypes. The
    counterpart of ``demuxalot_tpu.parallel.ColumnDataset``.
    """

    def __init__(self, cb: np.ndarray, vid: np.ndarray, q: np.ndarray):
        order = np.argsort(cb, kind="stable")
        cb, vid, q = (np.ascontiguousarray(np.asarray(a)[order], dtype=t)
                      for a, t in ((cb, np.int32), (vid, np.int32), (q, np.float32)))
        self._cols = (cb, vid, q)
        by_variant = np.argsort(vid, kind="stable")  # (vid, cb) order: cb is already sorted
        self.calls_v = CallColumns(vid=vid[by_variant], cb=cb[by_variant], q=q[by_variant],
                                   count=np.ones(len(cb), np.int64))
        self._sharded_layouts: dict = {}

    def calls_by_barcode(self) -> tuple:
        return self._cols


class _ShardCalls(NamedTuple):
    """One shard's barcode-CSR calls on its device, barcodes numbered from the shard's first."""

    device: torch.device
    row_ptr: torch.Tensor  # i64 [W + 1]
    cb: torch.Tensor  # i32 [n] local barcode ids, non-decreasing
    vid: torch.Tensor  # i32 [n]
    q: torch.Tensor  # f32 [n]


def _refuse_aggregate() -> None:
    if Demultiplexer.aggregate_on_snps:
        raise ValueError(
            "ShardedDemultiplexer runs the per-call E-step only: the aggregate-on-SNPs E-step is not "
            "sharded (set Demultiplexer.aggregate_on_snps = False, or use Demultiplexer)"
        )


class _ShardedState(NamedTuple):
    """One EM iteration: this process's shards' tensors, and the addition entering it."""

    probs: List[torch.Tensor]  # f32 [W, PG] per local shard
    logits: List[torch.Tensor]  # f32 [W, PG] per local shard
    addition: torch.Tensor  # f32 [V, D] on the first shard's device, device variant order


class ShardedDemultiplexer:
    """Multi-device Demultiplexer: the single-device results, barcode-sharded execution."""

    contribution_power = 2.0

    def __init__(self, mesh: Optional[Mesh] = None):
        self.mesh = mesh if mesh is not None else make_mesh()
        # per-shard layouts live on the dataset; these count the builds and
        # the reuses (a predict after a learn on one dataset builds nothing)
        self.layout_cache_hits = 0
        self.layout_cache_misses = 0

    @property
    def n_shards(self) -> int:
        return self.mesh.n_shards

    def _barcodes_per_shard(self, n_barcodes: int) -> int:
        return -(-max(n_barcodes, self.n_shards) // self.n_shards)

    def _devices(self) -> list:
        """The distinct devices of this process's shards, first shard's first."""
        return list(dict.fromkeys(self.mesh.devices))

    def _replicate(self, array: np.ndarray) -> dict:
        return {device: _dm._to_device(array, device) for device in self._devices()}

    def _agree_on(self, **dims: int) -> None:
        """Raise unless every process sees the same dataset dimensions."""
        values = list(dims.values())
        agreed = allreduce_max_dims(values + [-v for v in values], self.mesh)
        if agreed[: len(values)] != [-v for v in agreed[len(values):]]:
            raise ValueError(f"the processes of the mesh disagree on the dataset: {dims} here")

    # -- layouts -------------------------------------------------------------
    def _shard_layouts(self, packed, n_barcodes: int, n_donors: int, n_variants: int, build_mstep: bool):
        """([_ShardCalls], [MStepOperands] or None) of this process's shards, cached on ``packed``."""
        per_shard = self._barcodes_per_shard(n_barcodes)
        cache = packed._sharded_layouts
        common = (self.mesh.key(), n_barcodes, per_shard, n_variants, n_donors)
        key_e, key_m = ("estep", *common), ("mstep", *common)
        entry_e = cache.get(key_e)
        entry_m = cache.get(key_m) if build_mstep else None
        self.layout_cache_hits += (entry_e is not None) + (entry_m is not None)
        my_shards = list(zip(local_shard_ids(self.mesh), self.mesh.devices))
        if entry_e is None:
            self.layout_cache_misses += 1
            cb_s, vid_s, q_s = packed.calls_by_barcode()
            if len(cb_s) and int(cb_s[-1]) >= n_barcodes:
                raise ValueError(f"calls reach barcode {int(cb_s[-1])}, but n_barcodes={n_barcodes}")
            bounds = np.searchsorted(cb_s, np.arange(self.n_shards + 1, dtype=np.int64) * per_shard)
            entry_e = []
            for shard, device in my_shards:
                rows = slice(bounds[shard], bounds[shard + 1])
                cb = (cb_s[rows] - shard * per_shard).astype(np.int32)
                entry_e.append(_ShardCalls(
                    device, _dm._to_device(csr_row_pointers(cb, per_shard), device), _dm._to_device(cb, device),
                    _dm._to_device(vid_s[rows], device), _dm._to_device(q_s[rows], device),
                ))
            cache[key_e] = entry_e
        if build_mstep and entry_m is None:
            self.layout_cache_misses += 1
            calls_v = packed.calls_v
            shard_of_call = calls_v.cb // per_shard
            entry_m = []
            for shard, device in my_shards:
                mine = shard_of_call == shard  # a mask keeps the (vid, cb) order: no re-sort
                vid = calls_v.vid[mine]
                var_ptr = csr_row_pointers(vid, n_variants)
                entry_m.append(mstep_operands(
                    _dm._to_device(var_ptr, device), _dm._to_device(vid, device),
                    _dm._to_device((calls_v.cb[mine] - shard * per_shard).astype(np.int32), device),
                    _dm._to_device(calls_v.q[mine], device), per_shard, host_ptrs=(var_ptr, None),
                ))
                entry_m[-1].slots(n_donors)  # the partial sums, made here and not on a launch
            cache[key_m] = entry_m
        return entry_e, entry_m

    # -- the forward ---------------------------------------------------------
    def _forward(self, chromosome2compressed_snp_calls, genotypes, barcode_handler, p_genotype_clip: float,
                 doublet_prior: float, softmax: bool = False) -> Tuple[list, List[str]]:
        """Predict logits of this process's shards (padded rows included), or (logits, probs) per shard
        with ``softmax``, and column names."""
        _refuse_aggregate()
        with _dm._stage("predict.prior", "pack_s"):
            packed = ensure_packed(chromosome2compressed_snp_calls, genotypes)
            prior_betas = packed.betas_for(genotypes, add_data_prior=False)
        with _dm._stage("predict.operands", "layout_s"):
            n_barcodes, n_variants, n_donors = barcode_handler.n_barcodes, packed.n_variants, genotypes.n_genotypes
            self._agree_on(n_barcodes=n_barcodes, n_variants=n_variants, n_donors=n_donors)
            shards, _ = self._shard_layouts(packed, n_barcodes, n_donors, n_variants, build_mstep=False)
            # the shards' calls hold global variant ids
            operands = [estep_operands(n_donors, doublet_prior, s.row_ptr, s.cb, s.vid, s.q, n_variants)
                        for s in shards]
        with _dm._stage("predict.uploads", "layout_s") as timings:
            # logits are invariant to the SNP-sorted renumbering: nothing maps back
            reindex = packed.reindex
            betas = self._replicate(reindex.permute_rows(prior_betas))
            variant2snp = self._replicate(reindex.variant2snp)
        if timings is not None:
            with _dm._stage("predict.flush", "upload_flush_s"):
                timings["h2d_bytes"] = timings.get("h2d_bytes", 0) + _dm._flush_device([
                    *betas.values(), *variant2snp.values(), *(t for s in shards for t in s[1:]),
                    *(t for o in operands for t in o[:3])])
        n_snps = int(packed.variant2snp.max()) + 1 if n_variants else 0
        with _dm._stage("predict.forward", "forward_s"):
            genotype_prob = {
                device: L.probs_from_betas(betas[device], variant2snp[device], n_snps, p_genotype_clip,
                                           max_per_snp=reindex.windowed_max_per_snp)
                for device in betas
            }
            out = [estep_logits(genotype_prob[s.device], o, softmax=softmax) for s, o in zip(shards, operands)]
            if timings is not None:
                _dm._flush_device([t for block in out for t in (block if softmax else [block])])
        return out, L.pseudogenotype_names(genotypes.genotype_names, doublet_prior)

    # -- public API ----------------------------------------------------------
    @tracing.within("predict")
    def predict_posteriors(self, chromosome2compressed_snp_calls, genotypes, barcode_handler,
                           p_genotype_clip: float = 0.01, doublet_prior: float = 0.35):
        """(logits_df, probs_df) as ``Demultiplexer.predict_posteriors`` gives them."""
        blocks, column_names = self._forward(
            chromosome2compressed_snp_calls, genotypes, barcode_handler, p_genotype_clip, doublet_prior,
            softmax=True)
        logits, probs = [block[0] for block in blocks], [block[1] for block in blocks]
        n_barcodes = barcode_handler.n_barcodes
        with _dm._stage("materialize", "materialize_s"):
            with _dm._stage("d2h.logits", "d2h_logits_s") as timings:
                logits = to_host(logits, self.mesh)
            if timings is not None:
                timings["d2h_logits_bytes"] = int(logits.numel() * logits.element_size())
            probs = to_host(probs, self.mesh)
            return (
                _dm._frame(logits[:n_barcodes].numpy(), barcode_handler, column_names, index_name="BARCODE"),
                _dm._frame(probs[:n_barcodes].numpy(), barcode_handler, column_names, index_name="BARCODE"),
            )

    @tracing.within("predict")
    def predict_posteriors_compact(self, chromosome2compressed_snp_calls, genotypes, barcode_handler,
                                   p_genotype_clip: float = 0.01, doublet_prior: float = 0.35, k: int = 4,
                                   include_logits: bool = False) -> CompactPosteriors:
        """``Demultiplexer.predict_posteriors_compact`` with the top-k taken per shard.

        The top-k is per row, so each shard reduces its own logits on its
        device with no collective; only (8k+4) bytes per barcode come back.
        """
        n_columns = len(L.pseudogenotype_names(genotypes.genotype_names, doublet_prior))
        k = _dm._validate_topk(k, n_columns)
        logits, column_names = self._forward(
            chromosome2compressed_snp_calls, genotypes, barcode_handler, p_genotype_clip, doublet_prior)
        with tracing.span("compact_topk"):
            top = [compact_topk(block, k) for block in logits]
        with _dm._stage("materialize", "materialize_s") as timings:
            # padded rows included: bytes_moved counts what crossed
            top_logits, top_index, logsumexp = (to_host([t[i] for t in top], self.mesh) for i in range(3))
            logits_bf16 = to_host([b.to(torch.bfloat16) for b in logits], self.mesh) if include_logits else None
            bytes_moved = sum(t.numel() * t.element_size()
                              for t in (top_logits, top_index, logsumexp, logits_bf16) if t is not None)
        if timings is not None:
            timings["d2h_compact_bytes"] = int(bytes_moved)
        n = barcode_handler.n_barcodes
        return CompactPosteriors(
            column_names=list(column_names),
            barcodes=list(barcode_handler.ordered_barcodes),
            top_index=top_index[:n].numpy(),
            top_logits=top_logits[:n].numpy(),
            logsumexp=logsumexp[:n].numpy(),
            logits_bf16=logits_bf16[:n].clone() if include_logits else None,
            bytes_moved=int(bytes_moved),
        )

    def staged_genotype_learning(self, chromosome2compressed_snp_calls, genotypes, barcode_handler,
                                 n_iterations: int = 5, p_genotype_clip: float = 0.01, doublet_prior: float = 0.0,
                                 barcode_prior_logits: Optional[np.ndarray] = None, damping: Optional[str] = None):
        """Sharded EM generator; yields (posterior probs df, debug info) per iteration.

        As ``Demultiplexer.staged_genotype_learning``: ``damping`` is None
        or "anchor", and ``barcode_prior_logits`` are added at iteration 0.
        """
        run = _ShardedEM(self, chromosome2compressed_snp_calls, genotypes, barcode_handler, n_iterations,
                         p_genotype_clip, doublet_prior, barcode_prior_logits, damping)
        for state in run.device_iterations():
            yield run.materialize(state)

    def _learn(self, chromosome2compressed_snp_calls, genotypes, barcode_handler, n_iterations, p_genotype_clip,
               doublet_prior, barcode_prior_logits, damping):
        """(learnt genotypes, last EM posteriors f32 [B, PG] on the CPU, column names)."""
        run = _ShardedEM(self, chromosome2compressed_snp_calls, genotypes, barcode_handler, n_iterations,
                         p_genotype_clip, doublet_prior, barcode_prior_logits, damping)
        with _dm._stage("em.loop", "device_loop_s") as timings:
            state = None
            for state in run.device_iterations():
                pass
            if state is None:
                raise ValueError("n_iterations must be >= 1")
            if timings is not None:
                _dm._flush_device([*state.probs, state.addition])
        with _dm._stage("materialize", "materialize_s"):
            learnt = genotypes._with_betas(genotypes.get_betas() + run.registry_addition(state))
            probs = to_host(state.probs, self.mesh)[: barcode_handler.n_barcodes]
        return learnt, probs, run.column_names

    @tracing.within("learn")
    def learn_genotypes(self, chromosome2compressed_snp_calls, genotypes, barcode_handler, n_iterations: int = 5,
                        p_genotype_clip: float = 0.01, doublet_prior: float = 0.0,
                        barcode_prior_logits: Optional[np.ndarray] = None, damping: Optional[str] = None):
        """(learnt genotypes, last-iteration posterior df), as ``Demultiplexer.learn_genotypes``.

        ``damping="auto"`` packs once, so its plain and anchored runs share
        one pack and one set of shard layouts, and keeps one of them by
        ``models.demux.auto_damping_select``; the frame's ``attrs`` carry
        ``damping_selected`` and ``anchored_disagreement``.
        """
        args = (n_iterations, p_genotype_clip, doublet_prior, barcode_prior_logits)
        if damping == "auto":
            packed = ensure_packed(chromosome2compressed_snp_calls, genotypes)
            runs = {choice: self._learn(packed, genotypes, barcode_handler, *args, damping=choice)
                    for choice in (None, "anchor")}
            selected, disagreement = _dm.auto_damping_select(runs[None][1], runs["anchor"][1],
                                                             genotypes.n_genotypes)
            learnt, probs, column_names = runs[selected]
        else:
            learnt, probs, column_names = self._learn(chromosome2compressed_snp_calls, genotypes, barcode_handler,
                                                      *args, damping=damping)
        frame = _dm._frame(probs.numpy(), barcode_handler, column_names)
        if damping == "auto":
            frame.attrs["damping_selected"] = selected
            frame.attrs["anchored_disagreement"] = disagreement
        return learnt, frame


class _ShardedEM:
    """Device state of one sharded EM run (the counterpart of ``models.demux._EMRun``)."""

    @tracing.within("em.setup")
    def __init__(self, engine: ShardedDemultiplexer, chromosome2compressed_snp_calls, genotypes, barcode_handler,
                 n_iterations: int, p_genotype_clip: float, doublet_prior: float,
                 barcode_prior_logits: Optional[np.ndarray], damping: Optional[str]):
        assert 0 <= doublet_prior < 1
        if damping not in (None, "anchor"):
            raise ValueError(
                f"damping must be None or 'anchor', got {damping!r}"
                + (" ('auto' is only available through learn_genotypes, which"
                   " needs the whole trajectory to decide)" if damping == "auto" else "")
            )
        _refuse_aggregate()
        self.engine = engine
        mesh = engine.mesh
        with _dm._stage("em.prior", "pack_s"):
            packed = ensure_packed(chromosome2compressed_snp_calls, genotypes)
            self.prior_betas = packed.betas_for(genotypes, add_data_prior=True)
        self.barcode_handler = barcode_handler
        self.n_iterations = n_iterations
        self.p_genotype_clip = p_genotype_clip
        self.n_variants, self.n_genotypes = self.prior_betas.shape
        self.n_snps = int(packed.variant2snp.max()) + 1 if self.n_variants else 0
        self.reindex = packed.reindex
        n_barcodes = barcode_handler.n_barcodes
        with _dm._stage("em.operands", "layout_s"):
            engine._agree_on(n_barcodes=n_barcodes, n_variants=self.n_variants, n_donors=self.n_genotypes)
            self.shards, self.mstep = engine._shard_layouts(packed, n_barcodes, self.n_genotypes, self.n_variants,
                                                            build_mstep=True)
            self.estep = [estep_operands(self.n_genotypes, doublet_prior, s.row_ptr, s.cb, s.vid, s.q,
                                         self.n_variants) for s in self.shards]
        self.column_names = L.pseudogenotype_names(genotypes.genotype_names, doublet_prior)
        self.devices = engine._devices()
        with _dm._stage("em.uploads", "layout_s") as timings:
            self.prior_betas_dev = engine._replicate(self.reindex.permute_rows(self.prior_betas))
            self.variant2snp = engine._replicate(self.reindex.variant2snp)
            # damping="anchor": additions only at variants whose GENOTYPE prior
            # carries information (nonzero betas before the data prior)
            self.anchor_mask = None
            if damping == "anchor":
                registry_mask = (np.asarray(genotypes.get_betas()).sum(axis=1) > 0).astype(np.float32)
                self.anchor_mask = _dm._to_device(registry_mask[self.reindex.order][:, None], self.devices[0])
            self.prior_logits = None
            if barcode_prior_logits is not None:
                assert barcode_prior_logits.shape == (n_barcodes, len(self.column_names)), "wrong shape of priors"
                per_shard = engine._barcodes_per_shard(n_barcodes)
                padded = np.zeros((engine.n_shards * per_shard, len(self.column_names)), dtype=np.float32)
                padded[:n_barcodes] = barcode_prior_logits
                self.prior_logits = [_dm._to_device(padded[shard * per_shard:(shard + 1) * per_shard], device)
                                     for shard, device in zip(local_shard_ids(mesh), mesh.devices)]
        if timings is not None:
            with _dm._stage("em.flush", "upload_flush_s"):
                timings["h2d_bytes"] = timings.get("h2d_bytes", 0) + _dm._flush_device([
                    *self.prior_betas_dev.values(), *self.variant2snp.values(), self.anchor_mask,
                    *(self.prior_logits or ()), *(t for s in self.shards for t in s[1:]),
                    *(t for o in self.mstep for t in o.tensors()), *(t for o in self.estep for t in o[:3])])

    def _reduce(self, partials: List[torch.Tensor]) -> dict:
        """Sum of every shard's M-step partial, anchor-masked, on each shard device."""
        first = self.devices[0]
        total = partials[0]
        for partial in partials[1:]:  # shard order: the same bits on every run
            total = total + partial.to(first)
        if self.engine.mesh.group is not None:
            dist.all_reduce(total, op=dist.ReduceOp.SUM, group=self.engine.mesh.group)
        if self.anchor_mask is not None:
            total = total * self.anchor_mask
        return {device: total.to(device) for device in self.devices}

    def device_iterations(self):
        """Yield a :class:`_ShardedState` per EM iteration (the last runs no M-step)."""
        addition = {device: torch.zeros_like(betas) for device, betas in self.prior_betas_dev.items()}
        power = float(self.engine.contribution_power)
        for iteration in range(self.n_iterations):
            with tracing.step("em.normalise"):
                genotype_prob = {
                    device: L.probs_from_betas(self.prior_betas_dev[device] + addition[device],
                                               self.variant2snp[device], self.n_snps, self.p_genotype_clip,
                                               max_per_snp=self.reindex.windowed_max_per_snp)
                    for device in self.devices
                }
            priors = [None] * len(self.shards)
            if iteration == 0 and self.prior_logits is not None:
                priors = self.prior_logits
            with tracing.step("em.estep"):
                blocks = [estep_logits(genotype_prob[s.device], o, prior_logits=prior, softmax=True)
                          for s, o, prior in zip(self.shards, self.estep, priors)]
            logits, probs = [block[0] for block in blocks], [block[1] for block in blocks]
            yield _ShardedState(probs, logits, addition[self.devices[0]])
            if iteration == self.n_iterations - 1:
                break
            with tracing.step("em.mstep"):
                addition = self._reduce([mstep_addition(p, o, self.n_genotypes, power)
                                         for p, o in zip(probs, self.mstep)])

    @tracing.within("registry_addition")
    def registry_addition(self, state: _ShardedState) -> np.ndarray:
        """The state's beta addition on the host, in registry variant order."""
        return self.reindex.unpermute_rows(_dm._addition_to_host(state.addition))

    @tracing.within("materialize")
    def materialize(self, state: _ShardedState):
        """One state → (posterior probs df, debug dict) on the host, every process alike."""
        n_barcodes = self.barcode_handler.n_barcodes
        debug_information = {
            "barcode_logits": to_host(state.logits, self.engine.mesh)[:n_barcodes].numpy(),
            "genotype_prior": self.prior_betas,
            "genotype_addition": self.registry_addition(state),
        }
        probs = to_host(state.probs, self.engine.mesh)[:n_barcodes].numpy()
        return _dm._frame(probs, self.barcode_handler, self.column_names), debug_information
