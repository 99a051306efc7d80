"""Banded E-step and M-step: the hand-written CUDA kernels, their plain versions, the layouts and the A/B.

The counterpart of ``benchmarks/inkernel_gather_kernels.py`` and of the A/B
of ``benchmarks/exp_inkernel_gather_estep.py``. On the TPU those kernels
kept a band of a table resident in VMEM and gathered their rows from it
inside the kernel, to escape XLA's gather; on the H100 the mainline kernels
already gather inside the kernel, so what these carry over is the
banding: band-local ids and a band-sized table.

- :func:`estep_logits_banded` (``_likelihood_kernel_ig``,
  ``inkernel_gather_kernels.py:78``). The variants are cut into K bands at
  :func:`band_edges`; calls carry band-local variant ids and lie band-major,
  a barcode CSR per band (:class:`BandedEStepOperands`). Per barcode b and
  pseudogenotype g::

      logits[b, g] = pen[g] + Σ_k Σ_{calls c of b in band k} log(Σ_d mix[d, g]·u_d)
      u            = G[edges[k] + vid_c]·(1 − q_c) + max(q_c, 1e-4)

  summed in band order, then in call order. Kernel: ``csrc/likelihood.cu``
  (its banded instantiation), one warp per barcode as on the main path, its
  ring of 32-slot tiles running over one stream per barcode: the barcode's
  band segments end to end, each padded to whole groups of 8 calls
  (:func:`slot_plan` mirrors it), each row read from its band's slice of G.
- :func:`mstep_addition_banded` (``_mstep_kernel_ig``, ``:252``). The
  barcodes are cut into K ≥ 2 bands; calls carry band-local barcodes and
  lie band-major, a variant CSR per band (:class:`BandedMStepOperands`). Per
  variant v and donor d::

      addition[v, d] = Σ_k Σ_{calls c of v in band k} (post[edges[k] + cb_c, d]·(1 − q_c))^p

  Kernel: ``csrc/banded.cu``, one warp per variant walking its band
  segments in order through the mainline M-step's call tiles, the rows read
  from L2. The plain version keeps the TPU kernel's form: a table of
  ``posterior[:, :D] ** p`` stacked band by band (:func:`banded_table`)
  times ``q2 = (1 − q)^p`` (0 for q ≥ 1).

The operand builders check the band CSR, the band-local ids (and the
E-step's schedule) once on a card (``csrc/checks.cu``); the launches check
nothing, and refuse operands the builders did not make.
Each wrapper launches its kernel (through ``ops._cuda.Entry``) for CUDA
tensors and runs its plain version for CPU tensors; anything else raises. ``.launches`` counts
launches. :func:`bench_workload` and :func:`run_ab` time the banded kernels
beside the mainline ones at the JAX harness's shape; ``python -m
demuxalot_tpu_torch.experiments.inkernel_gather [--device cpu]`` prints the
result as JSON.
"""
from __future__ import annotations

import json
import math
from typing import NamedTuple

import numpy as np
import torch

from ..ops import _cuda
from ..ops import likelihood as L
from ..ops.likelihood_kernel import EStepOperands, LANES, ENTRY, _check, estep_logits, estep_operands, estep_schedule
from ..ops.mstep_kernel import MStepOperands, mstep_addition, mstep_operands
from ..ops.packing import csr_row_pointers
from .kernel_gather import time_ms

# the JAX harness's shape (exp_inkernel_gather_estep.py:28-32)
BENCH = dict(n_barcodes=65_536, n_donors=32, n_snps=65_536, calls_per_barcode=64)
DOUBLET_PRIOR = 0.35
ESTEP_BANDS = 12
POWER = 2.0  # the engine's default contribution_power
# the M-step's barcode bands are sized as the TPU harness sized its VMEM
# blocks: power-table rows of at most 100 KB a band (82 bands at the bench
# shape); the card's kernel stages nothing, so this only sets K
MSTEP_BAND_BYTES = 100 * 1024
# the bars the banded results meet against the mainline's (chip_smoke.py's)
LOGITS_TOL = dict(rtol=1e-4, atol=5e-3)
ADDITION_TOL = dict(rtol=1e-4, atol=1e-5)
LOG_FOLD = 8  # the E-step's calls per log: a band segment takes whole groups of slots


# ---------------------------------------------------------------------------
# layouts
# ---------------------------------------------------------------------------

def band_edges(n_rows: int, n_bands: int) -> np.ndarray:
    """int64 [K + 1], the JAX layout builders' edges: ``linspace(0, n_rows, K + 1)``.

    As ``demuxalot_tpu/ops/tiling.py:193`` cuts them.
    """
    if n_bands < 1:
        raise ValueError(f"n_bands must be >= 1, got {n_bands}")
    return np.linspace(0, n_rows, n_bands + 1).astype(np.int64)


def band_of(ids: torch.Tensor, edges: torch.Tensor) -> torch.Tensor:
    """int64 band of each id: ``searchsorted(edges, id, "right") − 1``, clipped to [0, K) (``tiling.py:202-203``)."""
    n_bands = edges.shape[0] - 1
    return (torch.searchsorted(edges, ids.long(), right=True) - 1).clamp_(0, n_bands - 1)


def _band_major(band: torch.Tensor, rows: torch.Tensor, n_bands: int, n_rows: int):
    """(order, band_ptr): the stable (band, row) order of the calls, and i64 [K, n_rows + 1] row pointers
    into it, ``band_ptr[k, r]`` = the calls before (band k, row r)."""
    key = band * n_rows + rows.long()
    order = torch.argsort(key, stable=True)
    counts = torch.bincount(key, minlength=n_bands * n_rows)
    starts = torch.cat([counts.new_zeros(1), torch.cumsum(counts, 0)])
    at = (torch.arange(n_bands, device=key.device)[:, None] * n_rows
          + torch.arange(n_rows + 1, device=key.device)[None, :])
    return order, starts[at].contiguous()


class BandedEStepOperands(NamedTuple):
    """What the banded E-step reads besides the genotype probabilities (:func:`banded_estep_operands`)."""

    penalties: torch.Tensor  # f32 [PG]
    schedule: torch.Tensor  # i32 [passes, 32, 24] the main path's tile schedule (kernel)
    mixing: torch.Tensor  # f32 [D, PG] (plain)
    band_edges: torch.Tensor  # i64 [K + 1] variant bands
    band_ptr: torch.Tensor  # i64 [K, B + 1] barcode CSR per band over the band-major calls (kernel)
    cb: torch.Tensor  # i32 [N] barcode of every call (plain)
    vid: torch.Tensor  # i32 [N] band-local variant
    q: torch.Tensor  # f32 [N]
    n_variants: int = 0  # rows of G the ids were checked against

    @property
    def n_bands(self) -> int:
        return self.band_ptr.shape[0]

    @property
    def n_barcodes(self) -> int:
        return self.band_ptr.shape[1] - 1


CheckedBandedEStepOperands = _cuda.checked(BandedEStepOperands)


def banded_estep_operands(n_donors: int, doublet_prior: float, cb: torch.Tensor, vid: torch.Tensor,
                          q: torch.Tensor, n_barcodes: int, n_variants: int,
                          n_bands: int) -> CheckedBandedEStepOperands:
    """The banded layout of the calls (cb, vid, q) on their device; a barcode's calls keep their order in a band.

    On a card the edges, the band CSR, the band-local ids and the schedule
    are checked once here (``csrc/checks.cu``'s kernels trap on a bad one).
    """
    device = cb.device
    edges = torch.from_numpy(band_edges(n_variants, n_bands)).to(device)
    band = band_of(vid, edges)
    order, band_ptr = _band_major(band, cb, n_bands, n_barcodes)
    col_i, col_j = L.pseudogenotype_pairs(n_donors, doublet_prior)
    operands = CheckedBandedEStepOperands(
        penalties=torch.from_numpy(L.doublet_penalties(n_donors, doublet_prior)).to(device),
        schedule=torch.from_numpy(estep_schedule(n_donors, doublet_prior).copy()).to(device),
        mixing=torch.from_numpy(L.mixing_from_pairs(col_i, col_j, n_donors)).to(device),
        band_edges=edges, band_ptr=band_ptr, cb=cb[order].contiguous(),
        vid=(vid[order].long() - edges[band[order]]).to(torch.int32), q=q[order].contiguous(),
        n_variants=n_variants,
    )
    if device.type == "cuda":
        o = operands
        _check_banded(edges, edges.data_ptr(), n_bands, n_variants, band_ptr.data_ptr(), n_barcodes,
                      o.vid.shape[0], o.vid.data_ptr(), o.schedule.data_ptr(), o.schedule.shape[0], ENTRY, n_donors,
                      o.penalties.shape[0])
    return operands


def slot_plan(band_ptr: torch.Tensor) -> tuple:
    """The banded E-step kernel's stream of slots per barcode (``csrc/likelihood.cu``, kBanded), on the host.

    Barcode b's K segments (its calls of band k, ``band_ptr[k, b] ..
    band_ptr[k, b + 1]``) lie end to end in band order, each from a
    multiple of ``LOG_FOLD`` slots and padded to the next; an empty segment
    takes no slot. Returns (``call_slot`` i64 [N], each call's slot in its
    barcode's stream; ``seg_start`` i64 [K, B], each segment's first slot;
    ``stream_len`` i64 [B]) for the band-major calls of ``band_ptr``.
    """
    n_bands, n_barcodes = band_ptr.shape[0], band_ptr.shape[1] - 1
    counts = band_ptr[:, 1:] - band_ptr[:, :-1]
    padded = (counts + LOG_FOLD - 1) // LOG_FOLD * LOG_FOLD
    ends = torch.cumsum(padded, 0)
    seg_start = ends - padded
    segment = torch.repeat_interleave(torch.arange(n_bands * n_barcodes, device=band_ptr.device),
                                      counts.reshape(-1))
    first = band_ptr[:, :-1].reshape(-1)
    call = torch.arange(segment.shape[0], device=band_ptr.device) + band_ptr[0, 0]
    call_slot = seg_start.reshape(-1)[segment] + call - first[segment]
    return call_slot, seg_start, ends[-1]


class BandedMStepOperands(NamedTuple):
    """The barcode-banded calls the banded M-step reads (:func:`banded_mstep_operands`)."""

    band_edges: torch.Tensor  # i64 [K + 1] barcode bands
    band_ptr: torch.Tensor  # i64 [K, V + 1] variant CSR per band over the band-major calls (kernel)
    vid: torch.Tensor  # i32 [N] variant of every call (plain)
    cb: torch.Tensor  # i32 [N] band-local barcode
    q: torch.Tensor  # f32 [N]
    band_rows: int  # rows of one band of the power table (:func:`band_rows`, plain)
    n_barcodes: int = 0  # posterior rows the barcodes were checked against

    @property
    def n_bands(self) -> int:
        return self.band_ptr.shape[0]

    @property
    def n_variants(self) -> int:
        return self.band_ptr.shape[1] - 1


CheckedBandedMStepOperands = _cuda.checked(BandedMStepOperands)


def banded_mstep_operands(vid: torch.Tensor, cb: torch.Tensor, q: torch.Tensor, n_variants: int,
                          n_barcodes: int, n_bands: int) -> CheckedBandedMStepOperands:
    """The barcode-banded layout of the calls (vid, cb, q) on their device; a variant's calls keep their order
    in a band (the JAX layout builder with the axes swapped, ``demuxalot_tpu/ops/pallas_mstep.py:476-485``).

    On a card the edges, the band CSR and the band-local barcodes are checked
    once here (``csrc/checks.cu``'s kernels trap on a bad one).
    """
    edges_np = band_edges(n_barcodes, n_bands)
    edges = torch.from_numpy(edges_np).to(cb.device)
    band = band_of(cb, edges)
    order, band_ptr = _band_major(band, vid, n_bands, n_variants)
    operands = CheckedBandedMStepOperands(
        band_edges=edges, band_ptr=band_ptr, vid=vid[order].contiguous(),
        cb=(cb[order].long() - edges[band[order]]).to(torch.int32), q=q[order].contiguous(),
        band_rows=band_rows(edges_np), n_barcodes=n_barcodes,
    )
    if cb.device.type == "cuda":
        o = operands
        _check_banded(edges, edges.data_ptr(), n_bands, n_barcodes, band_ptr.data_ptr(), n_variants, o.cb.shape[0],
                      o.cb.data_ptr(), None, 0, ENTRY, 1, 1)
    return operands


def band_rows(band_edges_: np.ndarray) -> int:
    """Rows of one band of :func:`banded_table`: the tallest band, rounded up to 4."""
    return max(4, -(-int(np.diff(band_edges_).max()) // 4) * 4)


def banded_table(rows: torch.Tensor, band_edges_: torch.Tensor, height: int) -> torch.Tensor:
    """[K·height, D]: band k's rows of ``rows`` [R, D] at [k·height, k·height + edges[k+1] − edges[k]), padding 0.

    The port of ``inkernel_gather_kernels.py:57`` (the plain M-step's table);
    ``height`` is at least the tallest band (:func:`band_rows`). No host sync.
    """
    n_bands = band_edges_.shape[0] - 1
    band = torch.repeat_interleave(torch.arange(n_bands, device=rows.device), band_edges_.diff(),
                                   output_size=rows.shape[0])
    dest = band * height + torch.arange(rows.shape[0], device=rows.device) - band_edges_[band]
    table = rows.new_zeros((n_bands * height, rows.shape[1]))
    table[dest] = rows
    return table


def mstep_bands_for(n_barcodes: int, n_donors: int) -> int:
    """The fewest barcode bands (at least 2) whose rows of the power table take at most MSTEP_BAND_BYTES each."""
    n_bands = max(2, math.ceil(n_barcodes * n_donors * 4 / MSTEP_BAND_BYTES))
    while band_rows(band_edges(n_barcodes, n_bands)) * n_donors * 4 > MSTEP_BAND_BYTES and n_bands < n_barcodes:
        n_bands += 1
    return n_bands


# ---------------------------------------------------------------------------
# banded E-step
# ---------------------------------------------------------------------------

def estep_logits_banded_plain(genotype_prob: torch.Tensor, operands: BandedEStepOperands) -> torch.Tensor:
    """Plain PyTorch version of the kernel, on any device: the main path's plain E-step band by band."""
    o = operands
    edges = o.band_edges.tolist()
    spans = o.band_ptr[:, [0, -1]].tolist()
    no_penalty = torch.zeros_like(o.penalties)
    logits = o.penalties.expand(o.n_barcodes, -1).clone()
    for k, (lo, hi) in enumerate(spans):
        logits += L.barcode_logits(genotype_prob[edges[k]: edges[k + 1]], o.mixing, no_penalty, o.vid[lo:hi],
                                   o.cb[lo:hi], o.q[lo:hi], o.n_barcodes)
    return logits


_ESTEP_TYPES = {
    "penalties": (torch.float32, 1), "schedule": (torch.int32, 3), "mixing": (torch.float32, 2),
    "band_edges": (torch.int64, 1), "band_ptr": (torch.int64, 2), "cb": (torch.int32, 1),
    "vid": (torch.int32, 1), "q": (torch.float32, 1),
}


def estep_logits_banded(genotype_prob: torch.Tensor, operands: BandedEStepOperands) -> torch.Tensor:
    """Barcode logits f32 [B, PG] from genotype_prob f32 [V, D]; the CUDA kernel for CUDA tensors."""
    device = genotype_prob.device
    _check("genotype_prob", genotype_prob, torch.float32, 2, device)
    for name, (dtype, ndim) in _ESTEP_TYPES.items():
        _check(name, getattr(operands, name), dtype, ndim, device)
    o = operands
    n_variants, n_donors = genotype_prob.shape
    n_pg = o.penalties.shape[0]
    if o.mixing.shape != (n_donors, n_pg):
        raise ValueError("mixing must have one row per donor and one column per penalty")
    if o.schedule.shape[0] < 1 or o.schedule.shape[1:] != (LANES, ENTRY):
        raise ValueError(f"schedule must be [passes >= 1, {LANES}, {ENTRY}], got {tuple(o.schedule.shape)}")
    if o.n_bands < 1 or o.band_edges.shape[0] != o.n_bands + 1 or not o.vid.shape == o.q.shape == o.cb.shape:
        raise ValueError("band_edges must have K + 1 entries for K >= 1 bands; cb, vid and q must align")
    if device.type == "cpu":
        return estep_logits_banded_plain(genotype_prob, operands)
    if device.type != "cuda":
        raise ValueError(f"estep_logits_banded runs on cpu or cuda tensors, not {device}")
    if not isinstance(o, CheckedBandedEStepOperands):
        raise ValueError("estep_logits_banded: operands must come from banded_estep_operands")
    if n_variants != o.n_variants:
        raise ValueError(f"estep_logits_banded: genotype_prob has {n_variants} rows, the operands were checked "
                         f"against {o.n_variants} variants")
    logits = torch.empty((o.n_barcodes, n_pg), dtype=torch.float32, device=device)
    if o.n_barcodes > 0:
        _estep_banded(genotype_prob, genotype_prob.data_ptr(), n_variants, n_donors, o.band_edges.data_ptr(),
                      o.n_bands, o.band_ptr.data_ptr(), o.vid.data_ptr(), o.q.data_ptr(), o.n_barcodes,
                      o.penalties.data_ptr(), o.schedule.data_ptr(), o.schedule.shape[0], n_pg, logits.data_ptr())
        estep_logits_banded.launches += 1
    return logits


estep_logits_banded.launches = 0


# ---------------------------------------------------------------------------
# banded M-step
# ---------------------------------------------------------------------------

def _check_banded_mstep(n_bands: int, power: float) -> None:
    # the JAX launcher's refusals (inkernel_gather_kernels.py:346-352)
    if n_bands < 2:
        raise ValueError("inkernel gather needs a barcode-banded layout "
                         "(TiledMstepCalls with n_bands sized for VMEM band blocks)")
    if power <= 0:
        raise ValueError("inkernel gather requires contribution_power > 0")


def _power_fold(posterior: torch.Tensor, operands: BandedMStepOperands, n_genotypes: int, power: float):
    """(table, q2) of the plain version: the banded posterior^p table and (1 − q)^p, exactly 0 for q ≥ 1."""
    table = banded_table(posterior[:, :n_genotypes] ** power, operands.band_edges, operands.band_rows)
    q2 = torch.where(operands.q >= 1.0, 0.0, (1.0 - operands.q) ** power)
    return table, q2


def mstep_addition_banded_plain(posterior: torch.Tensor, operands: BandedMStepOperands, n_genotypes: int,
                                power: float) -> torch.Tensor:
    """Plain PyTorch version of the kernel, on any device: band by band, ``index_add_`` of the calls' rows."""
    o = operands
    _check_banded_mstep(o.n_bands, power)
    table, q2 = _power_fold(posterior, o, n_genotypes, power)
    addition = posterior.new_zeros((o.n_variants, n_genotypes))
    for k, (lo, hi) in enumerate(o.band_ptr[:, [0, -1]].tolist()):
        rows = table[k * o.band_rows + o.cb[lo:hi].long()] * q2[lo:hi, None]
        addition.index_add_(0, o.vid[lo:hi], rows)
    return addition


def mstep_addition_banded(posterior: torch.Tensor, operands: BandedMStepOperands, n_genotypes: int,
                          power: float) -> torch.Tensor:
    """Beta addition f32 [V, D] from posterior f32 [B, PG]; the CUDA kernel for CUDA tensors.

    Raises for fewer than 2 bands and a power ≤ 0 (the JAX launcher's
    refusals), and on a card for operands :func:`banded_mstep_operands` did
    not build or a posterior of another row count than they were checked
    against.
    """
    device = posterior.device
    o = operands
    for name, tensor, dtype, ndim in (
        ("posterior", posterior, torch.float32, 2), ("band_edges", o.band_edges, torch.int64, 1),
        ("band_ptr", o.band_ptr, torch.int64, 2), ("vid", o.vid, torch.int32, 1),
        ("cb", o.cb, torch.int32, 1), ("q", o.q, torch.float32, 1),
    ):
        _check(name, tensor, dtype, ndim, device)
    n_barcodes, n_pg = posterior.shape
    if not 0 < n_genotypes <= n_pg:
        raise ValueError(f"n_genotypes={n_genotypes} must lie in 1..{n_pg}")
    if o.band_edges.shape[0] != o.n_bands + 1 or not o.vid.shape == o.cb.shape == o.q.shape:
        raise ValueError("band_edges must have K + 1 entries; vid, cb and q must align")
    _check_banded_mstep(o.n_bands, power)
    if device.type == "cpu":
        return mstep_addition_banded_plain(posterior, operands, n_genotypes, power)
    if device.type != "cuda":
        raise ValueError(f"mstep_addition_banded runs on cpu or cuda tensors, not {device}")
    if not isinstance(o, CheckedBandedMStepOperands):
        raise ValueError("mstep_addition_banded: operands must come from banded_mstep_operands")
    if n_barcodes != o.n_barcodes:
        raise ValueError(f"mstep_addition_banded: posterior has {n_barcodes} rows, the operands were checked "
                         f"against {o.n_barcodes} barcodes")
    if posterior.numel() >= 2 ** 32:
        raise ValueError("mstep_addition_banded: the kernel addresses posterior rows with 32-bit offsets")
    addition = torch.empty((o.n_variants, n_genotypes), dtype=torch.float32, device=device)
    if o.n_variants > 0:
        _mstep_banded(posterior, posterior.data_ptr(), n_pg, n_genotypes, o.band_edges.data_ptr(), o.n_bands,
                      o.band_ptr.data_ptr(), o.cb.data_ptr(), o.q.data_ptr(), o.n_variants, float(power),
                      addition.data_ptr())
        mstep_addition_banded.launches += 1
    return addition


mstep_addition_banded.launches = 0
_estep_banded = _cuda.Entry("demux_estep_logits_banded")
_mstep_banded = _cuda.Entry("demux_mstep_addition_banded")
_check_banded = _cuda.Entry("demux_banded_check")


# ---------------------------------------------------------------------------
# the A/B at the JAX harness's shape
# ---------------------------------------------------------------------------

class Workload(NamedTuple):
    """One EM step's inputs in both layouts: the mainline's and the banded ones."""

    genotype_prob: torch.Tensor  # f32 [V, D] from the betas after one M-step
    posterior: torch.Tensor  # f32 [B, PG] the E-step's posteriors on the prior betas
    estep: EStepOperands
    mstep: MStepOperands
    estep_banded: BandedEStepOperands
    mstep_banded: BandedMStepOperands
    n_genotypes: int
    power: float


def bench_workload(n_barcodes: int = BENCH["n_barcodes"], n_donors: int = BENCH["n_donors"],
                   n_snps: int = BENCH["n_snps"], calls_per_barcode: int = BENCH["calls_per_barcode"],
                   doublet_prior: float = DOUBLET_PRIOR, n_bands: int = ESTEP_BANDS, mstep_bands: int = 0,
                   seed: int = 0, device="cuda") -> Workload:
    """``sim.synthesize_device_workload`` in both layouts on ``device``, with learnt-beta genotype probabilities.

    The learnt betas are one EM step of the mainline kernels from the
    synthetic prior betas: the fused E-step, the M-step, prior + addition.
    ``mstep_bands`` 0 takes :func:`mstep_bands_for`.
    """
    from .. import sim

    device = torch.device(device)
    betas, variant2snp, vid, cb, q, _truth = sim.synthesize_device_workload(
        n_barcodes, n_donors, n_snps, calls_per_barcode, seed=seed)
    n_variants = betas.shape[0]
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)  # noqa: E731
    cb_t, vid_t, q_t = t(cb), t(vid), t(q)
    estep = estep_operands(n_donors, doublet_prior, t(csr_row_pointers(cb, n_barcodes)), cb_t, vid_t, q_t,
                           n_variants)
    order = np.lexsort((cb, vid))
    mstep = mstep_operands(t(csr_row_pointers(vid[order], n_variants)), t(vid[order]), t(cb[order]), t(q[order]),
                           n_barcodes)
    v2s, prior_betas = t(variant2snp), t(betas)
    gprob0 = L.probs_from_betas(prior_betas, v2s, n_snps, 0.01, 2)
    _logits, posterior = estep_logits(gprob0, estep, softmax=True)
    learnt = prior_betas + mstep_addition(posterior, mstep, n_donors, POWER)
    return Workload(
        genotype_prob=L.probs_from_betas(learnt, v2s, n_snps, 0.01, 2), posterior=posterior,
        estep=estep, mstep=mstep,
        estep_banded=banded_estep_operands(n_donors, doublet_prior, cb_t, vid_t, q_t, n_barcodes, n_variants,
                                           n_bands),
        mstep_banded=banded_mstep_operands(vid_t, cb_t, q_t, n_variants, n_barcodes,
                                           mstep_bands or mstep_bands_for(n_barcodes, n_donors)),
        n_genotypes=n_donors, power=POWER,
    )


def run_ab(workload: Workload, repeats: int = 10) -> dict:
    """The banded kernels beside the mainline ones on ``workload``, in turns, held to the mainline's bars.

    E-step: the mainline fused call (logits and posteriors), the mainline
    logits-only call and the banded one; M-step: the mainline and the
    banded one. The banded results must meet the mainline's bars (logits
    rtol 1e-4 / atol 5e-3 and the same argmax, additions rtol 1e-4 / atol
    1e-5). Times are CUDA events on a card and the host clock on the CPU.
    """
    w = workload
    device = w.genotype_prob.device
    mainline = estep_logits(w.genotype_prob, w.estep)
    banded = estep_logits_banded(w.genotype_prob, w.estep_banded)
    torch.testing.assert_close(banded, mainline, **LOGITS_TOL)
    if not torch.equal(banded.argmax(1), mainline.argmax(1)):
        raise RuntimeError("banded E-step: argmax differs from the mainline's")
    addition = mstep_addition(w.posterior, w.mstep, w.n_genotypes, w.power)
    addition_banded = mstep_addition_banded(w.posterior, w.mstep_banded, w.n_genotypes, w.power)
    torch.testing.assert_close(addition_banded, addition, **ADDITION_TOL)
    runs = {
        "estep_fused": lambda: estep_logits(w.genotype_prob, w.estep, softmax=True),
        "estep_logits": lambda: estep_logits(w.genotype_prob, w.estep),
        "estep_banded": lambda: estep_logits_banded(w.genotype_prob, w.estep_banded),
        "mstep": lambda: mstep_addition(w.posterior, w.mstep, w.n_genotypes, w.power),
        "mstep_banded": lambda: mstep_addition_banded(w.posterior, w.mstep_banded, w.n_genotypes, w.power),
    }
    samples = {name: [] for name in runs}
    for group in (("estep_fused", "estep_logits", "estep_banded"), ("mstep", "mstep_banded")):
        for name in group + group[::-1]:
            samples[name].append(time_ms(runs[name], device, repeats))
    return {
        "device": str(device), "n_barcodes": w.estep.n_barcodes, "n_variants": int(w.genotype_prob.shape[0]),
        "n_donors": w.n_genotypes, "n_calls": int(w.estep.q.shape[0]), "n_pg": int(w.estep.penalties.shape[0]),
        "estep_bands": w.estep_banded.n_bands, "mstep_bands": w.mstep_banded.n_bands,
        "mstep_band_rows": w.mstep_banded.band_rows,
        "estep_slots": int(slot_plan(w.estep_banded.band_ptr.cpu())[2].sum()),
        "genotype_table_bytes": w.genotype_prob.numel() * 4,
        "logits_max_abs_err": float((banded - mainline).abs().max()),
        "addition_max_abs_err": float((addition_banded - addition).abs().max()),
        "ms": {name: {"samples": ms, "mean": sum(ms) / len(ms)} for name, ms in samples.items()},
    }


def main(argv=None) -> int:
    import argparse

    parser = argparse.ArgumentParser(description="Banded E-step and M-step beside the mainline (inkernel_gather)")
    parser.add_argument("--device", default="cuda", help="cuda (default; raises without a card) or cpu")
    for name, value in BENCH.items():
        parser.add_argument(f"--{name.replace('_', '-')}", type=int, default=value)
    parser.add_argument("--doublet-prior", type=float, default=DOUBLET_PRIOR)
    parser.add_argument("--n-bands", type=int, default=ESTEP_BANDS, help="variant bands of the E-step")
    parser.add_argument("--mstep-bands", type=int, default=0, help="barcode bands of the M-step (0: as fit)")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--repeats", type=int, default=10)
    args = parser.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass --device cpu for the plain versions")
    workload = bench_workload(args.n_barcodes, args.n_donors, args.n_snps, args.calls_per_barcode,
                              args.doublet_prior, args.n_bands, args.mstep_bands, seed=args.seed, device=device)
    print(json.dumps(run_ab(workload, args.repeats)), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
