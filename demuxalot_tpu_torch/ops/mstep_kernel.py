"""M-step: the hand-written CUDA kernels and their plain versions.

Replaces ``demuxalot_tpu/ops/pallas_mstep.py:_mstep_kernel`` (the TPU
M-step) and the posterior gather the JAX package ran before it. Kernel:
``csrc/mstep.cu``. Per variant v and donor d < D it computes

    addition[v, d] = Σ_{calls c of v, in (vid, cb) order} (post[cb_c, d]·(1−q_c))^p

over calls in variant CSR form (the (vid, cb)-sorted call list); calls with
q ≥ 1 add exactly 0. The summation contract, with C = :data:`CHUNK_CALLS`
(``csrc/mstep.cu``'s ``kChunkCalls``), every multiply and add rounded on its
own:

- a variant of at most C calls: each (v, d) sum is one chain in call order
  from +0;
- a variant of more than C calls: its calls are cut in call order into
  chunks of C (the last holds the rest), each chunk summed as one such
  chain, and the chunk sums chained in chunk order from +0.

An output depends only on the data and C, never on the launch.
``tests/torch_problems.py:in_order_addition`` gives the bits in PyTorch.
On the H100 the kernel is bound by the L2 reads of the posterior rows, one
4·D-byte slice per call: a warp walks its unit's calls in tiles of 32 with
several row reads in flight, lanes over donors. A warp's unit, from the
work plan (:func:`mstep_plan`), is a whole SNP run, or a chunk of a run that
holds a variant of more than C calls, so no warp walks more than a run of
short variants or one chunk. See the source.

Two entry points, one kernel source:

- :func:`mstep_addition` → the addition [V, D] (the sharded engine, and
  the EM loop where a SNP has more than ``MAX_WINDOWED_RUN`` variants);
- :func:`mstep_update` → ``(addition·mask, genotype_prob)``: the same sum,
  then in the same launch the next EM iteration's genotype probabilities,
  ``ops.likelihood.probs_from_betas(prior + addition·mask)`` (its windowed
  branch, bit for bit). It needs operands built with ``snp_ptr``.

Operands come only from :func:`mstep_operands`, which checks the indices
once per dataset (``csrc/checks.cu``'s kernels, on a card), records the
posterior row count they were checked against and builds the work plan
(its tables, one int32 ticket per split run); the wrappers refuse any
others (:class:`CheckedMStepOperands`). The chunks' f32 slots for a
donor count come from :meth:`MStepOperands.slots`, which the EM loop and the
sharded engine call in their set-up. The launches check nothing on the
device. Launches over one operands' plan must be ordered by their stream
(its tickets and slots are shared): a graph's replays, or a side stream
that waits for the launch before it, are. It records the counters
``mstep.split_calls`` (calls in variants of more than C calls) and
``mstep.split_units`` (chunk units) in ``utils.tracing``. Each wrapper
launches its kernel for CUDA tensors and runs its plain version
(:func:`mstep_addition_plain`, :func:`mstep_update_plain`) for CPU tensors;
anything else raises. ``mstep_addition.launches`` and
``mstep_update.launches`` count launches, and ``.host_ns`` and
``.host_calls`` their host time (``utils.tracing.timed_op``).
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..utils import tracing
from . import _cuda
from .likelihood import DENOMINATOR_FLOOR, genotype_addition_from_posteriors, probs_from_betas
from .likelihood_kernel import _check
from .packing import MAX_WINDOWED_RUN

# calls a chunk (csrc/mstep.cu's kChunkCalls): variants of more calls are summed in chunks of this many, across
# warps. Of 256, 512, 1,024 and 2,048, 1,024 ran the bench pool's EM iteration fastest on an H100 (PERF.md)
CHUNK_CALLS = 1024

_CALL_TYPES = (("var_ptr", torch.int64), ("vid", torch.int32), ("cb", torch.int32), ("q", torch.float32))


class MStepPlan(NamedTuple):
    """The M-step kernel's work units for one dataset (:func:`mstep_plan`), on the operands' device.

    A run is a SNP run where the operands have ``snp_ptr``, else one
    variant. A run none of whose variants has more than ``CHUNK_CALLS``
    calls is one unit; the others are split: each variant cut into chunks
    of ``CHUNK_CALLS`` calls in call order (an empty or short variant is one
    chunk), a unit each, summed into its slot, and the run's last chunk to
    finish chains its slots and writes the run.
    """

    units: torch.Tensor  # i32 [U] heaviest first: r >= 0 the whole run r, -1 - c chunk c
    chunks: torch.Tensor  # i32 [K, 3] (variant, chunk of the variant, split run), by run, variant and chunk
    split_runs: torch.Tensor  # i32 [S, 3] (run, first chunk, chunks)
    tickets: torch.Tensor  # i32 [S] zeros: the kernel counts a run's chunks and puts them back to 0
    split_calls: int  # calls in variants of more than CHUNK_CALLS calls

    @property
    def n_chunks(self) -> int:
        return self.chunks.shape[0]

    def tensors(self) -> list:
        return [self.units, self.chunks, self.split_runs, self.tickets]


def mstep_plan(var_ptr: np.ndarray,
               snp_ptr: Optional[np.ndarray] = None) -> Tuple[np.ndarray, np.ndarray, np.ndarray, int]:
    """``(units, chunks, split_runs, split_calls)`` of :class:`MStepPlan` as numpy arrays.

    Runs are ``snp_ptr``'s (each variant its own run without it). A unit
    weighs its calls; units are ordered heaviest first (ties: whole runs in
    run order, then chunks in slot order), so the longest walks start
    first, wherever the runs lie.
    """
    chunk = CHUNK_CALLS
    var_ptr = np.asarray(var_ptr, dtype=np.int64)
    counts = np.diff(var_ptr)
    n_variants = counts.shape[0]
    run_ptr = np.arange(n_variants + 1, dtype=np.int64) if snp_ptr is None else np.asarray(snp_ptr, np.int64)
    n_runs = run_ptr.shape[0] - 1
    run_of_variant = np.repeat(np.arange(n_runs), np.diff(run_ptr))
    long = counts > chunk
    split = np.zeros(n_runs, dtype=bool)
    split[run_of_variant[long]] = True
    whole = np.flatnonzero(~split)
    split_runs = np.flatnonzero(split)
    # every variant of a split run: its chunks, in variant and chunk order
    variants = np.flatnonzero(split[run_of_variant])
    per_variant = np.maximum(1, -(-counts[variants] // chunk))
    n_chunks = int(per_variant.sum())
    chunk_variant = np.repeat(variants, per_variant)
    chunk_k = np.arange(n_chunks) - np.repeat(np.cumsum(per_variant) - per_variant, per_variant)
    chunk_split = np.repeat(np.searchsorted(split_runs, run_of_variant[variants]), per_variant)
    per_run = np.bincount(chunk_split, minlength=split_runs.shape[0])
    chunks = np.stack([chunk_variant, chunk_k, chunk_split], axis=1).astype(np.int32).reshape(-1, 3)
    table = np.stack([split_runs, np.cumsum(per_run) - per_run, per_run], axis=1).astype(np.int32).reshape(-1, 3)
    weights = np.concatenate([var_ptr[run_ptr[whole + 1]] - var_ptr[run_ptr[whole]],
                              np.minimum(chunk, counts[chunk_variant] - chunk_k * chunk)])
    ids = np.concatenate([whole, -1 - np.arange(n_chunks)])
    units = ids[np.argsort(-weights, kind="stable")].astype(np.int32)
    return units, chunks, table, int(counts[long].sum())


class MStepOperands(NamedTuple):
    """The (vid, cb)-sorted calls the M-step reads, checked once by :func:`mstep_operands`.

    The kernels read the variant CSR (and the SNP-run CSR); the plain
    versions read the variant of every call (and the run of every variant).
    """

    var_ptr: torch.Tensor  # i64 [V + 1] variant CSR over the calls (kernel)
    vid: torch.Tensor  # i32 [N] variant of every call (plain)
    cb: torch.Tensor  # i32 [N], sorted by (vid, cb)
    q: torch.Tensor  # f32 [N]
    n_barcodes: int  # posterior rows the indices were checked against
    snp_ptr: Optional[torch.Tensor] = None  # i64 [R + 1] SNP runs over the variant rows (kernel)
    variant_run: Optional[torch.Tensor] = None  # i32 [V] run of every variant (plain)
    max_per_snp: int = 0  # longest run
    plan: Optional[MStepPlan] = None  # the kernel's work units
    partials: Optional[dict] = None  # the chunks' f32 [K, D] slots by D (:meth:`slots`)

    @property
    def n_variants(self) -> int:
        return self.var_ptr.shape[0] - 1

    def tensors(self) -> list:
        return [t for t in (self.var_ptr, self.vid, self.cb, self.q, self.snp_ptr, self.variant_run)
                if t is not None] + (self.plan.tensors() if self.plan is not None else [])

    def slots(self, n_genotypes: int) -> torch.Tensor:
        """The chunks' partial sums at ``n_genotypes`` donors, f32 [K, D]; made at the first call, so call it in
        set-up."""
        slots = self.partials.get(n_genotypes)
        if slots is None:
            slots = self.partials[n_genotypes] = torch.empty((self.plan.n_chunks, n_genotypes), dtype=torch.float32,
                                                             device=self.var_ptr.device)
        return slots

    def plan_pointers(self, n_genotypes: int) -> tuple:
        """The launch's snp_ptr and plan arguments: snp_ptr (or None), units, n_units, chunks, split runs, tickets,
        slots."""
        plan = self.plan
        return (None if self.snp_ptr is None else self.snp_ptr.data_ptr(), plan.units.data_ptr(),
                plan.units.shape[0], plan.chunks.data_ptr(), plan.split_runs.data_ptr(), plan.tickets.data_ptr(),
                self.slots(n_genotypes).data_ptr())


CheckedMStepOperands = _cuda.checked(MStepOperands)


def mstep_operands(var_ptr: torch.Tensor, vid: torch.Tensor, cb: torch.Tensor, q: torch.Tensor, n_barcodes: int,
                   snp_ptr: Optional[torch.Tensor] = None,
                   host_ptrs: Optional[Tuple[np.ndarray, Optional[np.ndarray]]] = None) -> CheckedMStepOperands:
    """Checked M-step operands; build them once per dataset.

    ``snp_ptr`` (i64 [R + 1]) cuts the variant rows into SNP runs of 1 to
    ``MAX_WINDOWED_RUN`` variants from 0 to V (the layout of
    :class:`ops.packing.VariantReindex`); :func:`mstep_update` needs it.
    On a card, ``var_ptr`` must be a CSR over the calls and every ``cb``
    lie in ``[0, n_barcodes)``, or the check kernels trap before any kernel
    reads through them. The work plan (:func:`mstep_plan`) is built over
    the SNP runs, or over the variants without them, on the host: from
    ``host_ptrs``, the same ``(var_ptr, snp_ptr)`` as numpy arrays where the
    caller holds them, else from copies of the tensors.
    """
    device = var_ptr.device
    for (name, dtype), tensor in zip(_CALL_TYPES, (var_ptr, vid, cb, q)):
        _check(name, tensor, dtype, 1, device)
    n_variants = var_ptr.shape[0] - 1
    if not vid.shape == cb.shape == q.shape or n_variants < 0:
        raise ValueError("vid, cb and q must align, var_ptr needs at least one entry")
    if snp_ptr is not None:
        _check("snp_ptr", snp_ptr, torch.int64, 1, device)
    if host_ptrs is None:
        host_ptrs = (var_ptr.cpu().numpy(), None if snp_ptr is None else snp_ptr.cpu().numpy())
    host_var_ptr, host_snp_ptr = (None if a is None else np.asarray(a, dtype=np.int64) for a in host_ptrs)
    if host_var_ptr.shape != (n_variants + 1,) or (host_snp_ptr is None) != (snp_ptr is None):
        raise ValueError("host_ptrs must hold var_ptr and snp_ptr as the tensors do")
    variant_run, max_per_snp = None, 0
    if snp_ptr is not None:
        runs = np.diff(host_snp_ptr)
        if (host_snp_ptr.shape != tuple(snp_ptr.shape) or host_snp_ptr.shape[0] < 1 or host_snp_ptr[0] != 0
                or host_snp_ptr[-1] != n_variants or not ((runs >= 1) & (runs <= MAX_WINDOWED_RUN)).all()):
            raise ValueError(f"snp_ptr must cut [0, {n_variants}) into runs of 1 to {MAX_WINDOWED_RUN} variants")
        variant_run = torch.from_numpy(np.repeat(np.arange(runs.shape[0], dtype=np.int32), runs)).to(device)
        max_per_snp = int(runs.max()) if runs.shape[0] else 0
    if device.type == "cuda" and n_variants > 0:
        _check_on_card(var_ptr, var_ptr.data_ptr(), n_variants, cb.shape[0], cb.data_ptr(), n_barcodes)
    units, chunks, split_runs, split_calls = mstep_plan(host_var_ptr, host_snp_ptr)
    tracing.count("mstep.split_calls", split_calls)
    tracing.count("mstep.split_units", chunks.shape[0])
    upload = lambda array: torch.from_numpy(array).to(device)  # noqa: E731
    plan = MStepPlan(upload(units), upload(chunks), upload(split_runs),
                     torch.zeros(split_runs.shape[0], dtype=torch.int32, device=device), split_calls)
    return CheckedMStepOperands(var_ptr, vid, cb, q, n_barcodes, snp_ptr, variant_run, max_per_snp, plan, {})


def _check_inputs(name: str, posterior: torch.Tensor, operands: MStepOperands, n_genotypes: int) -> None:
    o = operands
    if not isinstance(o, CheckedMStepOperands):
        raise ValueError(f"{name}: operands must come from mstep_operands")
    device = posterior.device
    _check("posterior", posterior, torch.float32, 2, device)
    for name, dtype in _CALL_TYPES:
        _check(name, getattr(o, name), dtype, 1, device)
    if posterior.shape[0] != o.n_barcodes:
        raise ValueError(f"{name}: posterior has {posterior.shape[0]} rows, the operands were checked "
                         f"against {o.n_barcodes} barcodes")
    if not 0 < n_genotypes <= posterior.shape[1]:
        raise ValueError(f"n_genotypes={n_genotypes} must lie in 1..{posterior.shape[1]}")
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name} runs on cpu or cuda tensors, not {device}")
    if device.type == "cuda" and posterior.numel() >= 2 ** 32:
        raise ValueError(f"{name}: the kernel addresses posterior rows with 32-bit offsets")


def mstep_addition_plain(posterior, operands: MStepOperands, n_genotypes: int, power: float) -> torch.Tensor:
    """Plain PyTorch version of the addition kernel, on any device."""
    o = operands
    return genotype_addition_from_posteriors(posterior, o.vid, o.cb, o.q, o.n_variants, n_genotypes, power)


@tracing.timed_op
def mstep_addition(
    posterior: torch.Tensor,  # f32 [B, PG]
    operands: MStepOperands,
    n_genotypes: int,
    power: float,
) -> torch.Tensor:
    """Beta addition f32 [V, D]; the CUDA kernel for CUDA tensors."""
    _check_inputs("mstep_addition", posterior, operands, n_genotypes)
    if posterior.device.type == "cpu":
        return mstep_addition_plain(posterior, operands, n_genotypes, power)
    o = operands
    addition = torch.empty((o.n_variants, n_genotypes), dtype=torch.float32, device=posterior.device)
    if o.n_variants == 0:
        return addition
    _addition(posterior, posterior.data_ptr(), posterior.shape[1], n_genotypes, o.var_ptr.data_ptr(),
              o.cb.data_ptr(), o.q.data_ptr(), *o.plan_pointers(n_genotypes), float(power), addition.data_ptr())
    mstep_addition.launches += 1
    return addition


mstep_addition.launches = 0
_addition = _cuda.Entry("demux_mstep_addition")


def mstep_update_plain(posterior, operands: MStepOperands, prior_betas: torch.Tensor,
                       anchor_mask: Optional[torch.Tensor], p_genotype_clip: float, n_genotypes: int,
                       power: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the update kernel: the addition, the mask, ``probs_from_betas``."""
    o = operands
    addition = mstep_addition_plain(posterior, o, n_genotypes, power)
    if anchor_mask is not None:
        addition = addition * anchor_mask.reshape(-1, 1)
    n_runs = o.snp_ptr.shape[0] - 1
    genotype_prob = probs_from_betas(prior_betas + addition, o.variant_run, n_runs, p_genotype_clip,
                                     max_per_snp=o.max_per_snp)
    return addition, genotype_prob


@tracing.timed_op
def mstep_update(
    posterior: torch.Tensor,  # f32 [B, PG]
    operands: MStepOperands,
    prior_betas: torch.Tensor,  # f32 [V, D]
    anchor_mask: Optional[torch.Tensor],  # f32 [V, 1] or [V] of 0/1, or None
    p_genotype_clip: float,
    n_genotypes: int,
    power: float,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(addition·mask, probs_from_betas(prior + addition·mask)), each f32 [V, D]; one launch on a card.

    ``operands`` must carry SNP runs (:func:`mstep_operands` with ``snp_ptr``).
    """
    _check_inputs("mstep_update", posterior, operands, n_genotypes)
    o = operands
    if o.snp_ptr is None:
        raise ValueError("mstep_update: the operands carry no SNP runs (mstep_operands(..., snp_ptr=...))")
    device = posterior.device
    _check("prior_betas", prior_betas, torch.float32, 2, device)
    if tuple(prior_betas.shape) != (o.n_variants, n_genotypes):
        raise ValueError(f"prior_betas: expected {(o.n_variants, n_genotypes)}, got {tuple(prior_betas.shape)}")
    if anchor_mask is not None:
        _check("anchor_mask", anchor_mask, torch.float32, anchor_mask.dim(), device)
        if anchor_mask.numel() != o.n_variants or anchor_mask.dim() not in (1, 2):
            raise ValueError(f"anchor_mask: expected [{o.n_variants}] or [{o.n_variants}, 1], "
                             f"got {tuple(anchor_mask.shape)}")
    if device.type == "cpu":
        return mstep_update_plain(posterior, o, prior_betas, anchor_mask, p_genotype_clip, n_genotypes, power)
    addition = torch.empty((o.n_variants, n_genotypes), dtype=torch.float32, device=device)
    genotype_prob = torch.empty_like(addition)
    if o.snp_ptr.shape[0] == 1:
        return addition, genotype_prob
    _update(posterior, posterior.data_ptr(), posterior.shape[1], n_genotypes, o.var_ptr.data_ptr(), o.cb.data_ptr(),
            o.q.data_ptr(), *o.plan_pointers(n_genotypes), float(power), prior_betas.data_ptr(),
            anchor_mask.data_ptr() if anchor_mask is not None else None, DENOMINATOR_FLOOR, p_genotype_clip,
            1 - p_genotype_clip, addition.data_ptr(), genotype_prob.data_ptr())
    mstep_update.launches += 1
    return addition, genotype_prob


mstep_update.launches = 0
_update = _cuda.Entry("demux_mstep_update")
_check_on_card = _cuda.Entry("demux_mstep_check")
