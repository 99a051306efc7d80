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

:func:`split_logits` (``csrc/split.cu``): with ``exp_words`` ≥ 1 the
expansion runs on Hopper's warpgroup MMA (``wgmma`` m64n64k16 bf16 → f32):
64 columns × 64 calls × 16 donors a step, the mixing matrix (transposed)
built once per block in shared memory, one accumulator per word added in
word order; with 0 it is the f32 sum of the pair on CUDA cores. Then one
log per (call, column) in the accumulators' registers, each thread's terms
summed in call order and each quad's four partial sums in a fixed order
(the TPU's one-hot product sums the same terms in another order).
``exp_words`` runs from 0 to 3, ``sc_words`` from 0 to 2. The TPU harness
runs (0,0), (2,2), (2,1), (1,1) and (3,2) (:data:`HARNESS_PAIRS`).

The wrapper launches the kernel for CUDA tensors, on operands that
``folded_estep.variant_operands`` built and checked, and runs the plain
version for CPU tensors; anything else raises. ``.launches`` counts
launches.
``python -m demuxalot_tpu_torch.experiments.split_estep [--device cpu]``
runs the A/B of :mod:`.estep_variants` for this kernel alone.
"""
from __future__ import annotations

import sys

import torch

from ..ops import _cuda
from ..ops.likelihood import DEFAULT_CALL_CHUNK
from .folded_estep import (CheckedOperands, VariantOperands, check_variant, expand, round_to_words,  # noqa: F401
                           split_words)

HARNESS_PAIRS = ((0, 0), (2, 2), (2, 1), (1, 1), (3, 2))
MAX_EXP_WORDS = 3
MAX_SC_WORDS = 2
MMA_M, MMA_K = 64, 16  # the kernel's wgmma tile: 64 columns, 16 donors a step


def donor_axis(n_donors: int) -> int:
    """The kernel's donor axis (the MMA's K): one or two steps of 16 donors, else a multiple of 64 (blocks of
    four steps)."""
    steps = -(-n_donors // MMA_K)
    return steps * MMA_K if steps <= 2 else -(-n_donors // (4 * MMA_K)) * 4 * MMA_K


def mixing_operand(pairs: torch.Tensor, n_donors: int) -> torch.Tensor:
    """bf16 [PG rounded up to 64, :func:`donor_axis`]: MixT, the MMA's A operand, as ``csrc/split.cu`` builds
    it in shared memory from the pairs (there in wgmma's core-matrix order): row g holds ½ at column g's two
    donors, 1 for a singlet; padding rows and donors hold 0. The values are exact in bf16."""
    n_pg = pairs.shape[1]
    mix = torch.zeros((-(-n_pg // MMA_M) * MMA_M, donor_axis(n_donors)), dtype=torch.float32, device=pairs.device)
    rows = torch.arange(n_pg, device=pairs.device)
    half = torch.full((n_pg,), 0.5, device=pairs.device)
    for donors in pairs.long():
        mix.index_put_((rows, donors), half, accumulate=True)
    return mix.to(torch.bfloat16)


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
    if not isinstance(operands, CheckedOperands):
        raise ValueError("split_logits: operands must come from folded_estep.variant_operands")
    o = operands
    n_pg = o.penalties.shape[0]
    logits = torch.empty((o.n_barcodes, n_pg), dtype=torch.float32, device=u.device)
    if o.n_barcodes > 0:
        _split(u, u.data_ptr(), u.shape[0], u.shape[1], o.row_ptr.data_ptr(), o.n_barcodes, o.pairs.data_ptr(),
               o.penalties.data_ptr(), n_pg, logits.data_ptr(), exp_words, sc_words)
        split_logits.launches += 1
    return logits


split_logits.launches = 0
_split = _cuda.Entry("demux_split_logits")


def main(argv=None) -> int:
    """The A/B of :mod:`.estep_variants` for the split-word kernel alone."""
    from . import estep_variants

    return estep_variants.main(["--only", "split", *(sys.argv[1:] if argv is None else argv)])


if __name__ == "__main__":
    raise SystemExit(main())
