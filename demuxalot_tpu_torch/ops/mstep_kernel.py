"""M-step: the hand-written CUDA kernels and their plain versions.

Replaces ``demuxalot_tpu/ops/pallas_mstep.py:_mstep_kernel`` (the TPU
M-step) and the posterior gather the JAX package ran before it. Kernel:
``csrc/mstep.cu``. Per variant v and donor d < D it computes

    addition[v, d] = Σ_{calls c of v, in (vid, cb) order} (post[cb_c, d]·(1−q_c))^p

over calls in variant CSR form (the (vid, cb)-sorted call list); calls with
q ≥ 1 add exactly 0. Each (v, d) sum is one chain in call order with every
multiply and add rounded on its own. On the H100 it is bound by the L2
reads of the posterior rows, one 4·D-byte slice per call: a warp walks its
calls in tiles of 32 with several row reads in flight, lanes over donors.
See the source.

Two entry points, one kernel source:

- :func:`mstep_addition` → the addition [V, D] (the sharded engine, and
  the EM loop where a SNP has more than ``MAX_WINDOWED_RUN`` variants);
- :func:`mstep_update` → ``(addition·mask, genotype_prob)``: the same sum,
  then in the same launch the next EM iteration's genotype probabilities,
  ``ops.likelihood.probs_from_betas(prior + addition·mask)`` (its windowed
  branch, bit for bit). It needs operands built with ``snp_ptr``.

Operands come only from :func:`mstep_operands`, which checks the indices
once per dataset (``csrc/checks.cu``'s kernels, on a card) and records the
posterior row count they were checked against; the launches check nothing
on the device. Each wrapper launches its kernel for CUDA tensors and runs
its plain version (:func:`mstep_addition_plain`, :func:`mstep_update_plain`)
for CPU tensors; anything else raises. ``mstep_addition.launches`` and
``mstep_update.launches`` count launches, and ``.host_ns`` and
``.host_calls`` their host time (``utils.tracing.timed_op``).
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from ..utils import tracing
from . import _cuda
from .likelihood import DENOMINATOR_FLOOR, genotype_addition_from_posteriors, probs_from_betas
from .likelihood_kernel import _check
from .packing import MAX_WINDOWED_RUN

# posterior row reads in flight per warp at p = 2 (csrc/mstep.cu's kDepth: 1,
# 2, 4, 8 or 16; other powers run at a fixed depth); other values are set
# only by chip_smoke's ablation
IN_FLIGHT = 16

_BUILT = object()  # marks operands that mstep_operands built and checked
_CALL_TYPES = (("var_ptr", torch.int64), ("vid", torch.int32), ("cb", torch.int32), ("q", torch.float32))


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
    built: object = None  # _BUILT when mstep_operands made these

    @property
    def n_variants(self) -> int:
        return self.var_ptr.shape[0] - 1

    def tensors(self) -> list:
        return [t for t in (self.var_ptr, self.vid, self.cb, self.q, self.snp_ptr, self.variant_run)
                if t is not None]


def mstep_operands(var_ptr: torch.Tensor, vid: torch.Tensor, cb: torch.Tensor, q: torch.Tensor, n_barcodes: int,
                   snp_ptr: Optional[torch.Tensor] = None) -> MStepOperands:
    """Checked M-step operands; build them once per dataset.

    ``snp_ptr`` (i64 [R + 1]) cuts the variant rows into SNP runs of 1 to
    ``MAX_WINDOWED_RUN`` variants from 0 to V (the layout of
    :class:`ops.packing.VariantReindex`); :func:`mstep_update` needs it.
    On a card, ``var_ptr`` must be a CSR over the calls and every ``cb``
    lie in ``[0, n_barcodes)``, or the check kernels trap before any kernel
    reads through them.
    """
    device = var_ptr.device
    for (name, dtype), tensor in zip(_CALL_TYPES, (var_ptr, vid, cb, q)):
        _check(name, tensor, dtype, 1, device)
    n_variants = var_ptr.shape[0] - 1
    if not vid.shape == cb.shape == q.shape or n_variants < 0:
        raise ValueError("vid, cb and q must align, var_ptr needs at least one entry")
    variant_run, max_per_snp = None, 0
    if snp_ptr is not None:
        _check("snp_ptr", snp_ptr, torch.int64, 1, device)
        runs = snp_ptr.diff()
        if (snp_ptr.shape[0] < 1 or int(snp_ptr[0]) != 0 or int(snp_ptr[-1]) != n_variants
                or (runs.numel() and not bool(((runs >= 1) & (runs <= MAX_WINDOWED_RUN)).all()))):
            raise ValueError(f"snp_ptr must cut [0, {n_variants}) into runs of 1 to {MAX_WINDOWED_RUN} variants")
        variant_run = torch.repeat_interleave(torch.arange(runs.numel(), dtype=torch.int32, device=device), runs)
        max_per_snp = int(runs.max()) if runs.numel() else 0
    if device.type == "cuda" and n_variants > 0:
        lib = _cuda.library()
        with torch.cuda.device(device):
            status = lib.demux_mstep_check(var_ptr.data_ptr(), n_variants, cb.shape[0], cb.data_ptr(), n_barcodes,
                                           torch.cuda.current_stream(device).cuda_stream)
        _cuda.check_launch("mstep_operands", status)
    return MStepOperands(var_ptr, vid, cb, q, n_barcodes, snp_ptr, variant_run, max_per_snp, _BUILT)


def _check_inputs(name: str, posterior: torch.Tensor, operands: MStepOperands, n_genotypes: int) -> None:
    o = operands
    if not isinstance(o, MStepOperands) or o.built is not _BUILT:
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
    lib = _cuda.library()
    with torch.cuda.device(posterior.device):
        status = lib.demux_mstep_addition(
            posterior.data_ptr(), posterior.shape[1], n_genotypes,
            o.var_ptr.data_ptr(), o.cb.data_ptr(), o.q.data_ptr(), o.n_variants,
            float(power), IN_FLIGHT, addition.data_ptr(), torch.cuda.current_stream(posterior.device).cuda_stream,
        )
    _cuda.check_launch("mstep_addition", status)
    mstep_addition.launches += 1
    return addition


mstep_addition.launches = 0


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
    n_runs = o.snp_ptr.shape[0] - 1
    if n_runs == 0:
        return addition, genotype_prob
    lib = _cuda.library()
    with torch.cuda.device(device):
        status = lib.demux_mstep_update(
            posterior.data_ptr(), posterior.shape[1], n_genotypes,
            o.var_ptr.data_ptr(), o.cb.data_ptr(), o.q.data_ptr(), o.snp_ptr.data_ptr(), n_runs,
            float(power), prior_betas.data_ptr(),
            anchor_mask.data_ptr() if anchor_mask is not None else None,
            DENOMINATOR_FLOOR, p_genotype_clip, 1 - p_genotype_clip, IN_FLIGHT,
            addition.data_ptr(), genotype_prob.data_ptr(), torch.cuda.current_stream(device).cuda_stream,
        )
    _cuda.check_launch("mstep_update", status)
    mstep_update.launches += 1
    return addition, genotype_prob


mstep_update.launches = 0
