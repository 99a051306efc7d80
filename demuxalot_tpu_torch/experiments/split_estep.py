"""Split-word E-step: the hand-written tensor-core CUDA kernel and its plain version.

The counterpart of ``benchmarks/exp_split.py``, whose TPU kernel (the one
``make_kernel`` builds, ``:62``, via ``run_variant`` ``:115``) asks how
few bf16 matrix passes give f32-grade posteriors. On the folded calls U
(``folded_estep.fold_calls``), per barcode b and column g::

    args[c, g]   = Σ_k Σ_d mix[d, g]·word_k(U)[c, d]         k < exp_words, summed in word order
    logits[b, g] = pen[g] + Σ_{calls c of b} words(log(args[c, g]))   the log kept to sc_words bf16 words

``word_k`` is :func:`folded_estep.split_words` (``word = bf16(rem); rem -=
word``, round to nearest even, as ``dot_split`` ``:37-59`` makes them); 0
words means full f32. The mixing values (0, ½, 1) are exact in bf16.

:func:`split_logits` (``csrc/split.cu``): one warp per barcode. With
``exp_words`` ≥ 1 the expansion runs on the tensor cores (``mma.sync``
m16n8k16 bf16 → f32): 16 calls × 8 columns × 16 donors a step, word by
word, each word's f32 product added in word order; with 0 it is
the f32 sum of the pair on CUDA cores. Then one log per (call, column) and
the scatter on CUDA cores: each lane owns a column and adds its calls'
word-rounded logs in call order (the TPU's one-hot product sums the same
terms in another order). ``exp_words`` runs from 0 to 3, ``sc_words`` from
0 to 2. The TPU harness runs (0,0), (2,2), (2,1), (1,1) and (3,2)
(:data:`HARNESS_PAIRS`).

The wrapper launches the kernel for CUDA tensors and runs the plain version
for CPU tensors; anything else raises. ``.launches`` counts launches.
``python -m demuxalot_tpu_torch.experiments.split_estep [--device cpu]``
runs the A/B of :mod:`.estep_variants` for this kernel alone.
"""
from __future__ import annotations

import sys

import torch

from ..ops import _cuda
from ..ops.likelihood import DEFAULT_CALL_CHUNK
from .folded_estep import VariantOperands, check_variant, expand, round_to_words, split_words  # noqa: F401

HARNESS_PAIRS = ((0, 0), (2, 2), (2, 1), (1, 1), (3, 2))
MAX_EXP_WORDS = 3
MAX_SC_WORDS = 2


def _check_words(exp_words: int, sc_words: int) -> None:
    if not (0 <= exp_words <= MAX_EXP_WORDS and 0 <= sc_words <= MAX_SC_WORDS):
        raise ValueError(f"exp_words must lie in 0..{MAX_EXP_WORDS} and sc_words in 0..{MAX_SC_WORDS}, "
                         f"got ({exp_words}, {sc_words})")


def split_logits_plain(u: torch.Tensor, operands: VariantOperands, exp_words: int, sc_words: int,
                       call_chunk: int = DEFAULT_CALL_CHUNK) -> torch.Tensor:
    """Plain PyTorch version of the kernel, on any device, in call chunks."""
    _check_words(exp_words, sc_words)
    o = operands
    sums = u.new_zeros((o.n_barcodes, o.penalties.shape[0]))
    for lo in range(0, u.shape[0], call_chunk):
        args = expand(u[lo: lo + call_chunk], o.mixing, exp_words)
        sums.index_add_(0, o.cb[lo: lo + call_chunk], round_to_words(torch.log(args), sc_words))
    return o.penalties + sums


def split_logits(u: torch.Tensor, operands: VariantOperands, exp_words: int, sc_words: int) -> torch.Tensor:
    """Barcode logits f32 [B, PG] from the folded calls U f32 [N, D]; the CUDA kernel for CUDA tensors."""
    check_variant("split_logits", u, operands)
    _check_words(exp_words, sc_words)
    if u.device.type == "cpu":
        return split_logits_plain(u, operands, exp_words, sc_words)
    o = operands
    n_pg = o.penalties.shape[0]
    logits = torch.empty((o.n_barcodes, n_pg), dtype=torch.float32, device=u.device)
    if o.n_barcodes > 0:
        with torch.cuda.device(u.device):
            status = _cuda.library().demux_split_logits(
                u.data_ptr(), u.shape[0], u.shape[1], o.row_ptr.data_ptr(), o.n_barcodes, o.pairs.data_ptr(),
                o.penalties.data_ptr(), n_pg, logits.data_ptr(), exp_words, sc_words,
                torch.cuda.current_stream(u.device).cuda_stream)
        _cuda.check_launch("split_logits", status)
        split_logits.launches += 1
    return logits


split_logits.launches = 0


def main(argv=None) -> int:
    """The A/B of :mod:`.estep_variants` for the split-word kernel alone."""
    from . import estep_variants

    return estep_variants.main(["--only", "split", *(sys.argv[1:] if argv is None else argv)])


if __name__ == "__main__":
    raise SystemExit(main())
