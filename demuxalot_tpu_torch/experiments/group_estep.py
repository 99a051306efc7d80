"""Group-G E-step: the hand-written CUDA kernel, its plain version and the group layout.

The counterpart of ``benchmarks/exp_group.py``, whose TPU kernel
``_group_kernel`` (``:123``, via ``group_logits`` ``:188``, layout
``GroupLayout`` ``:42-95``) pads each barcode's calls to a multiple of G
(TC/128: 4 at TC 512, 8 at TC 1024) so that the logs of each group of G
calls can be summed before the scatter. :func:`group_layout` is the port's
copy of that layout in the barcode CSR: a barcode's calls keep their order,
then padding slots (vid 0, q 1, so U = 1) fill its last group; group g of
a barcode is its calls [g·G, (g+1)·G). On the folded calls U of that layout
(``folded_estep.fold_calls``), per barcode b and column g::

    args[c, g]   = Σ_k Σ_d mix[d, g]·word_k(U)[c, d]          k < n_words (0: U in full f32)
    gsum[h, g]   = Σ_{calls c of group h, in order} log(max(args[c, g], 1e-30))
    logits[b, g] = pen[g] + Σ_{groups h of b, in order} words(gsum[h, g])   kept to n_words bf16 words

:func:`group_logits` (``csrc/group.cu``): the mainline E-step's design,
one warp per barcode, each lane the 4 × 4 and 2 × 2 tiles of donor pairs of
:func:`group_schedule` (the mainline's ``estep_schedule`` with its columns
mapped to the operands' pairs), a 32-call tile of U in shared memory kept
to ``n_words`` words and halved (the words are summed before the
expansion, where the TPU adds the words' dots: they differ in the last bit
of an argument at most). At 0 and 2 words a group's sum is the log of the
product of its arguments (one log per group, per 4 calls past G = 8); at 1
word one ``logf`` per call. ``use_log=False`` sums the arguments (the TPU
file's ``nolog`` ablation). G must divide 32, the kernel's tile. The
product holds for U ≥ 1e-4 (``fold_calls``' floor): there the clamp at
1e-30 never acts and a product of 8 arguments stays a normal float.

:func:`group_layout` checks the layout's barcode CSR, the pairs and the
schedule once on a card; the wrapper launches the kernel for CUDA tensors
of a layout it built and runs the plain version for CPU tensors; anything
else raises. ``.launches`` counts launches.
``python -m demuxalot_tpu_torch.experiments.group_estep [--device cpu]``
runs the A/B of :mod:`.estep_variants` for this kernel alone.
"""
from __future__ import annotations

import sys
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..ops import _cuda
from ..ops import likelihood as L
from ..ops.likelihood import DEFAULT_CALL_CHUNK
from ..ops.likelihood_kernel import EStepOperands, estep_schedule
from .folded_estep import VariantOperands, check_on_card, check_variant, column_pairs, expand, round_to_words

HARNESS_GROUPS = (4, 8)  # TC / 128 at the TPU harness's TC 512 and 1024
TILE_CALLS = 32  # the kernel's tile of calls; a group must not straddle two
MAX_WORDS = 2


class GroupCalls(NamedTuple):
    """The calls in the group layout (:func:`group_layout`): the variants' operands over the padded calls."""

    operands: VariantOperands  # row_ptr and cb over the padded calls
    vid: torch.Tensor  # i32 [N_pad] (padding: 0)
    q: torch.Tensor  # f32 [N_pad] (padding: 1)
    group: int  # G
    schedule: Optional[torch.Tensor] = None  # i32 [passes, 32, 24] :func:`group_schedule` (kernel)

    @property
    def n_calls(self) -> int:
        return self.vid.shape[0]


CheckedGroupCalls = _cuda.checked(GroupCalls)


def group_schedule(pairs: np.ndarray, n_donors: int) -> np.ndarray:
    """The kernel's tile schedule, int32 [passes, 32, 24]: ``estep_schedule``'s tiles with each slot's column
    taken from ``pairs`` (int32 [2, PG], :func:`ops.likelihood.column_pairs`); raises unless every column of
    ``pairs`` lies in exactly one slot."""
    doublets = bool((pairs[0] != pairs[1]).any())
    prior = 1.0 if doublets else 0.0  # the schedule's tiles depend only on whether there are doublets
    table = estep_schedule(n_donors, prior).copy()
    col_i, col_j = L.pseudogenotype_pairs(n_donors, prior)
    column = {(int(i), int(j)): g for g, (i, j) in enumerate(zip(pairs[0], pairs[1]))}
    slots = table[..., 4:]
    used = slots >= 0
    slots[used] = [column.get((int(col_i[g]), int(col_j[g])), -1) for g in slots[used]]
    covered = np.bincount(slots[slots >= 0], minlength=pairs.shape[1])
    if len(covered) != pairs.shape[1] or not (covered == 1).all():
        raise ValueError("the tile schedule must hold every column of the pairs exactly once")
    return table


def group_layout(estep: EStepOperands, group: int) -> CheckedGroupCalls:
    """The mainline's barcode CSR with each barcode's calls padded to a multiple of ``group`` (on its device),
    checked once on a card."""
    if group < 1 or TILE_CALLS % group:
        raise ValueError(f"group must divide {TILE_CALLS}, got {group}")
    device = estep.row_ptr.device
    counts = estep.row_ptr.diff()
    padded = (counts + group - 1) // group * group
    row_ptr = torch.cat([padded.new_zeros(1), torch.cumsum(padded, 0)])
    n_calls = int(row_ptr[-1])
    cb = estep.cb.long()
    dest = row_ptr[cb] + torch.arange(cb.shape[0], device=device) - estep.row_ptr[cb]
    vid = torch.zeros(n_calls, dtype=torch.int32, device=device)
    q = torch.ones(n_calls, dtype=torch.float32, device=device)
    vid[dest] = estep.vid
    q[dest] = estep.q
    barcodes = torch.arange(estep.n_barcodes, device=device)
    cb_padded = torch.repeat_interleave(barcodes, padded, output_size=n_calls).to(torch.int32)
    pairs = column_pairs(estep.mixing.cpu().numpy())
    n_donors = estep.mixing.shape[0]
    schedule = torch.from_numpy(group_schedule(pairs, n_donors)).to(device)
    operands = VariantOperands(estep.penalties, estep.mixing, torch.from_numpy(pairs).to(device), row_ptr,
                               cb_padded)
    check_on_card(row_ptr, n_calls, operands.pairs, n_donors, schedule)
    return CheckedGroupCalls(operands, vid, q, group, schedule)


def _check_group(calls: GroupCalls, u: torch.Tensor, n_words: int) -> None:
    if not 0 <= n_words <= MAX_WORDS:
        raise ValueError(f"n_words must lie in 0..{MAX_WORDS}, got {n_words}")
    if calls.group < 1 or TILE_CALLS % calls.group or u.shape[0] % calls.group:
        raise ValueError(f"group {calls.group} must divide {TILE_CALLS} and the {u.shape[0]} padded calls")


def group_logits_plain(u: torch.Tensor, calls: GroupCalls, n_words: int = 2, *, use_log: bool = True,
                       call_chunk: int = DEFAULT_CALL_CHUNK) -> torch.Tensor:
    """Plain PyTorch version of the kernel, on any device, in chunks of whole groups."""
    _check_group(calls, u, n_words)
    o, g = calls.operands, calls.group
    n_pg = o.penalties.shape[0]
    sums = u.new_zeros((o.n_barcodes, n_pg))
    chunk = max(g, call_chunk // g * g)
    for lo in range(0, u.shape[0], chunk):
        args = expand(u[lo: lo + chunk], o.mixing, n_words)
        vals = (torch.log(args.clamp(min=1e-30)) if use_log else args).view(-1, g, n_pg)
        gsum = vals[:, 0]
        for j in range(1, g):
            gsum = gsum + vals[:, j]
        sums.index_add_(0, o.cb[lo: lo + chunk: g], round_to_words(gsum, n_words))
    return o.penalties + sums


def group_logits(u: torch.Tensor, calls: GroupCalls, n_words: int = 2, *, use_log: bool = True) -> torch.Tensor:
    """Barcode logits f32 [B, PG] from the folded padded calls U f32 [N_pad, D]; the CUDA kernel for CUDA
    tensors."""
    check_variant("group_logits", u, calls.operands)
    _check_group(calls, u, n_words)
    if u.device.type == "cpu":
        return group_logits_plain(u, calls, n_words, use_log=use_log)
    if not isinstance(calls, CheckedGroupCalls):
        raise ValueError("group_logits: calls must come from group_layout")
    o = calls.operands
    n_pg = o.penalties.shape[0]
    logits = torch.empty((o.n_barcodes, n_pg), dtype=torch.float32, device=u.device)
    if o.n_barcodes > 0:
        _group(u, u.data_ptr(), u.shape[0], u.shape[1], o.row_ptr.data_ptr(), o.n_barcodes, calls.group,
               calls.schedule.data_ptr(), calls.schedule.shape[0], o.penalties.data_ptr(), n_pg,
               logits.data_ptr(), n_words, int(use_log))
        group_logits.launches += 1
    return logits


group_logits.launches = 0
_group = _cuda.Entry("demux_group_logits")


def main(argv=None) -> int:
    """The A/B of :mod:`.estep_variants` for the group kernel alone."""
    from . import estep_variants

    return estep_variants.main(["--only", "group", *(sys.argv[1:] if argv is None else argv)])


if __name__ == "__main__":
    raise SystemExit(main())
