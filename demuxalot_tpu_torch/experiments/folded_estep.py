"""Folded E-step: the hand-written CUDA kernel, its plain version, the fold and the variants' operands.

The counterpart of ``benchmarks/exp_estep.py``, whose TPU kernel
``_folded_kernel`` (``:40``, via ``folded_logits`` ``:132``) streams the
calls' log arguments folded before the doublet expansion instead of
gathering genotype rows. Because every mixing column sums to 1,

    U[c, d]      = G[vid_c, d]·(1 − q_c) + max(q_c, 1e-4)        (:func:`fold_calls`, plain torch)
    logits[b, g] = pen[g] + Σ_{calls c of b} log(Σ_d mix[d, g]·U[c, d])

equals the mainline E-step (``ops.likelihood_kernel``); a padding call
(q = 1) has U = 1, its argument is 1 and its log 0. U is call-major, f32
[N, D], in the mainline's barcode CSR, so one call's row is one 128 B read
at 32 donors.

- :func:`folded_logits` (``csrc/folded.cu``): the mainline E-step's
  register tiles (``csrc/estep_tiles.cuh``, shared with ``group_estep``),
  one warp per barcode, each lane the 4 × 4 and 2 × 2 tiles of donor pairs
  of the operands' ``schedule``, and one log of the product of 8 arguments
  in call order where the TPU kernel takes a log per (call, column); a
  barcode's last product holds fewer real arguments (U ≥ 1e-4, so a
  product of 8 stays a normal float). ``use_log=False`` is the TPU file's
  ``nolog`` ablation: it sums the arguments. The TPU kernel's
  ``transposed_log`` only orients its tiles, so the port has no such knob. Its ``precision=DEFAULT`` ablation rounds U to
  one bf16 word on both dots; the mixing values (0, ½, 1) are exact in
  bf16, so that is ``split_estep.split_logits(..., 1, 1)``.

The wrapper launches the kernel for CUDA tensors and runs the plain version
for CPU tensors; anything else raises. ``.launches`` counts launches. The
three variant modules share :class:`VariantOperands` and the checks here;
:func:`variant_operands` builds the tile schedule and checks it, the
barcode CSR and the pairs once on a card (:class:`CheckedOperands`, which
the folded and split kernels require);
``python -m demuxalot_tpu_torch.experiments.folded_estep [--device cpu]``
runs the A/B of :mod:`.estep_variants` for this kernel alone.
"""
from __future__ import annotations

import sys
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..ops import _cuda
from ..ops.likelihood import DEFAULT_CALL_CHUNK, column_pairs
from ..ops.likelihood_kernel import ENTRY, EStepOperands, _check


class VariantOperands(NamedTuple):
    """What the E-step variants read besides the folded calls U (:func:`variant_operands`)."""

    penalties: torch.Tensor  # f32 [PG]
    mixing: torch.Tensor  # f32 [D, PG] (plain)
    pairs: torch.Tensor  # i32 [2, PG] each column's donor pair, (i, i) for a singlet (kernels)
    row_ptr: torch.Tensor  # i64 [B + 1] barcode CSR over the calls
    cb: torch.Tensor  # i32 [N] barcode of every call (plain)
    schedule: Optional[torch.Tensor] = None  # i32 [passes, 32, 24] the pairs' tile schedule (folded kernel)

    @property
    def n_barcodes(self) -> int:
        return self.row_ptr.shape[0] - 1


CheckedOperands = _cuda.checked(VariantOperands)


def check_on_card(row_ptr: torch.Tensor, n_calls: int, pairs: torch.Tensor, n_donors: int,
                  schedule=None) -> None:
    """On a card: the barcode CSR over ``n_calls``, every pair in ``[0, n_donors)`` and the group kernel's
    tile ``schedule`` (``csrc/checks.cu``'s kernels trap on a bad index); nothing on the CPU."""
    if row_ptr.device.type != "cuda":
        return
    n_passes = 0 if schedule is None else schedule.shape[0]
    _check_variant(row_ptr, row_ptr.data_ptr(), row_ptr.shape[0] - 1, n_calls, pairs.data_ptr(), pairs.shape[1],
                   n_donors, 0 if schedule is None else schedule.data_ptr(), n_passes, ENTRY)


def variant_operands(estep: EStepOperands) -> CheckedOperands:
    """The mainline's operands as the variants read them, checked once (the pairs and their tile schedule are
    found on the host)."""
    from .group_estep import group_schedule

    pairs = column_pairs(estep.mixing.cpu().numpy())
    device = estep.mixing.device
    schedule = torch.from_numpy(group_schedule(pairs, estep.mixing.shape[0])).to(device)
    pairs = torch.from_numpy(pairs).to(device)
    check_on_card(estep.row_ptr, estep.cb.shape[0], pairs, estep.mixing.shape[0], schedule)
    return CheckedOperands(estep.penalties, estep.mixing, pairs, estep.row_ptr, estep.cb, schedule)


def fold_calls(genotype_prob: torch.Tensor, calls) -> torch.Tensor:
    """U f32 [N, D] = G[vid]·(1 − q) + max(q, 1e-4) of ``calls``' ``vid`` and ``q`` (``exp_estep.py:156``)."""
    q = calls.q[:, None]
    return genotype_prob[calls.vid.long()] * (1.0 - q) + q.clamp(min=1e-4)


def check_variant(name: str, u: torch.Tensor, operands: VariantOperands) -> None:
    """Types, devices and shapes of a variant's inputs; raises ValueError."""
    device = u.device
    _check("u", u, torch.float32, 2, device)
    for field, dtype, ndim in (("penalties", torch.float32, 1), ("mixing", torch.float32, 2),
                               ("pairs", torch.int32, 2), ("row_ptr", torch.int64, 1), ("cb", torch.int32, 1)):
        _check(field, getattr(operands, field), dtype, ndim, device)
    n_pg = operands.penalties.shape[0]
    if operands.mixing.shape != (u.shape[1], n_pg) or operands.pairs.shape != (2, n_pg):
        raise ValueError(f"{name}: mixing must be [D, PG] and pairs [2, PG] for U [N, D] and PG penalties")
    if operands.cb.shape[0] != u.shape[0] or operands.n_barcodes < 0:
        raise ValueError(f"{name}: cb must have one entry per row of U, row_ptr at least one entry")
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name} runs on cpu or cuda tensors, not {device}")


def expand(u: torch.Tensor, mixing: torch.Tensor, n_words: int = 0) -> torch.Tensor:
    """Σ_d mix[d, g]·U[c, d] in f32: ``U @ mix``, or with U as ``n_words`` bf16 words, one product per word
    summed in word order (``exp_split.py:dot_split``)."""
    if u.is_cuda:
        torch.backends.cuda.matmul.allow_tf32 = False
    if n_words == 0:
        return u @ mixing
    words = split_words(u, n_words)
    args = words[0] @ mixing
    for word in words[1:]:
        args = args + word @ mixing
    return args


def split_words(x: torch.Tensor, n_words: int) -> torch.Tensor:
    """f32 [n_words, *x.shape]: x as bf16 words, ``word = bf16(rem); rem -= word`` (round to nearest even)."""
    words = []
    rem = x
    for _ in range(n_words):
        word = rem.to(torch.bfloat16).to(torch.float32)
        words.append(word)
        rem = rem - word
    return torch.stack(words)


def round_to_words(x: torch.Tensor, n_words: int) -> torch.Tensor:
    """x kept to ``n_words`` bf16 words: their sum in word order (x itself for 0)."""
    if n_words == 0:
        return x
    words = split_words(x, n_words)
    total = words[0]
    for word in words[1:]:
        total = total + word
    return total


def folded_logits_plain(u: torch.Tensor, operands: VariantOperands, *, use_log: bool = True,
                        call_chunk: int = DEFAULT_CALL_CHUNK) -> torch.Tensor:
    """Plain PyTorch version of the kernel, on any device, in call chunks."""
    o = operands
    sums = u.new_zeros((o.n_barcodes, o.penalties.shape[0]))
    for lo in range(0, u.shape[0], call_chunk):
        args = expand(u[lo: lo + call_chunk], o.mixing)
        sums.index_add_(0, o.cb[lo: lo + call_chunk], torch.log(args) if use_log else args)
    return o.penalties + sums


def folded_logits(u: torch.Tensor, operands: VariantOperands, *, use_log: bool = True) -> torch.Tensor:
    """Barcode logits f32 [B, PG] from the folded calls U f32 [N, D]; the CUDA kernel for CUDA tensors."""
    check_variant("folded_logits", u, operands)
    if u.device.type == "cpu":
        return folded_logits_plain(u, operands, use_log=use_log)
    if not isinstance(operands, CheckedOperands):
        raise ValueError("folded_logits: operands must come from variant_operands")
    o = operands
    n_pg = o.penalties.shape[0]
    logits = torch.empty((o.n_barcodes, n_pg), dtype=torch.float32, device=u.device)
    if o.n_barcodes > 0:
        _folded(u, u.data_ptr(), u.shape[0], u.shape[1], o.row_ptr.data_ptr(), o.n_barcodes, o.schedule.data_ptr(),
                o.schedule.shape[0], o.penalties.data_ptr(), n_pg, logits.data_ptr(), int(use_log))
        folded_logits.launches += 1
    return logits


folded_logits.launches = 0
_folded = _cuda.Entry("demux_folded_logits")
_check_variant = _cuda.Entry("demux_variant_check")


def main(argv=None) -> int:
    """The A/B of :mod:`.estep_variants` for the folded kernel alone."""
    from . import estep_variants

    return estep_variants.main(["--only", "folded", *(sys.argv[1:] if argv is None else argv)])


if __name__ == "__main__":
    raise SystemExit(main())
