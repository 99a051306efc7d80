"""The host pieces of the split and group E-steps (``experiments.split_estep``, ``group_estep``), on the CPU.

- ``split_estep.mixing_operand``: the MMA's A operand that ``csrc/split.cu``
  builds in shared memory from the column pairs, held to ``mix_sl`` as
  ``benchmarks/exp_split.py:182-184`` builds it from the JAX package's
  mixing matrix.
- ``group_estep.group_schedule``: the mainline's tile schedule with its
  columns taken from the operands' pairs; it must hold every column exactly
  once, each in a slot of its own donor pair.
- The group kernel's arithmetic at 0 and 2 words, the log of each group's
  product of arguments (one log per group, or per 4 calls past G = 8) with
  U kept to its words before the expansion, written here in torch: held to
  the plain version's sum of logs at the logits bar with the same argmax.
- ``folded_estep.variant_operands``' schedule, which the folded kernel
  walks, and that kernel's arithmetic, the log of each product of 8
  arguments from a barcode's first call on (its last product padded with
  arguments of 1), against the plain version's log per call.
"""
import numpy as np
import pytest
import torch

from demuxalot_tpu.ops import likelihood as JL
from demuxalot_tpu_torch.experiments import estep_variants as EV
from demuxalot_tpu_torch.experiments import folded_estep as FE
from demuxalot_tpu_torch.experiments import group_estep as GE
from demuxalot_tpu_torch.experiments import split_estep as SE
from demuxalot_tpu_torch.ops import likelihood as L
from demuxalot_tpu_torch.ops.likelihood_kernel import estep_operands
from demuxalot_tpu_torch.ops.packing import csr_row_pointers
from torch_problems import t

TOL = dict(rtol=1e-4, atol=5e-3)  # the JAX tests' oracle tolerance, the variants' logits bar


def _pairs(n_donors: int, prior: float) -> np.ndarray:
    col_i, col_j = L.pseudogenotype_pairs(n_donors, prior)
    return FE.column_pairs(L.mixing_from_pairs(col_i, col_j, n_donors))


@pytest.mark.parametrize("n_donors, prior", [(2, 0.25), (6, 0.25), (7, 0.0), (32, 0.25), (48, 0.25), (64, 0.25)])
def test_mixing_operand_is_the_harness_mix_sl(n_donors, prior):
    """``exp_split.py:182-184``: mix_sl [PG rounded up to 8, D rounded up to 8] holds mixing.T; the operand
    holds the same values (exact in bf16), zero past them, on the kernel's 64-column tiles and donor axis."""
    mixing, _ = JL.pseudogenotype_mixing([f"D{i:02}" for i in range(n_donors)], prior)
    mixing = np.asarray(mixing, np.float32)
    pg = mixing.shape[1]
    mix_sl = np.zeros((-(-pg // 8) * 8, -(-n_donors // 8) * 8), np.float32)
    mix_sl[:pg, :n_donors] = mixing.T
    ours = SE.mixing_operand(t(FE.column_pairs(mixing)), n_donors)
    assert ours.dtype == torch.bfloat16 and ours.shape == (-(-pg // 64) * 64, SE.donor_axis(n_donors))
    ours = ours.float().numpy()
    np.testing.assert_array_equal(ours[:pg, :n_donors], mix_sl[:pg, :n_donors])
    assert not ours[pg:].any() and not ours[:, n_donors:].any()


def test_donor_axis_is_whole_mma_steps():
    """One or two steps of 16 donors, past 32 donors blocks of four steps."""
    assert [SE.donor_axis(d) for d in (1, 16, 17, 32, 33, 48, 64, 65, 130)] == [16, 16, 32, 32, 64, 64, 64, 128, 192]


@pytest.mark.parametrize("shuffle", [False, True])
@pytest.mark.parametrize("n_donors, prior", [(1, 0.25), (2, 0.0), (5, 0.25), (7, 0.25), (32, 0.25), (33, 0.0),
                                             (64, 0.25)])
def test_group_schedule_covers_every_column_once(n_donors, prior, shuffle):
    """Every column of the pairs in exactly one slot, the slot of its own donor pair, whatever the columns'
    order."""
    pairs = _pairs(n_donors, prior)
    if shuffle:
        pairs = pairs[:, np.random.RandomState(n_donors).permutation(pairs.shape[1])]
    table = GE.group_schedule(pairs, n_donors)
    assert table.dtype == np.int32 and table.shape[1:] == (32, 24)
    columns = table[..., 4:]
    assert sorted(columns[columns >= 0].tolist()) == list(range(pairs.shape[1]))
    for entry in table.reshape(-1, 24):
        p, q, r, s = entry[:4]
        slots = [(4 * p + a, 4 * q + b) for a in range(4) for b in range(4)] + \
                [(2 * r + a, 2 * s + b) for a in range(2) for b in range(2)]
        for (i, j), g in zip(slots, entry[4:]):
            if g >= 0:
                assert (pairs[0, g], pairs[1, g]) == (i, j)


def test_group_schedule_refuses_a_column_twice():
    pairs = _pairs(5, 0.25)
    with pytest.raises(ValueError, match="exactly once"):
        GE.group_schedule(np.concatenate([pairs, pairs[:, :1]], axis=1), 5)


@pytest.fixture(scope="module")
def workload():
    """The variants' harness inputs at a small size on the CPU (port's sim, seed 3, prior 0.25)."""
    return EV.variants_workload("cpu", n_barcodes=200, n_donors=6, n_snps=90, calls_per_barcode=20,
                                groups=(4, 8, 16))


def _log_of_products(u: torch.Tensor, calls: GE.GroupCalls, n_words: int) -> torch.Tensor:
    """The group kernel's sums at 0 and 2 words: U kept to its words and halved, each argument the sum of its
    column's two halves, each group's log the log of its products of 4 or G calls (their logs added past
    G = 8), rounded to the words and added in group order."""
    o, g = calls.operands, calls.group
    half = 0.5 * FE.round_to_words(u, n_words)
    args = half[:, o.pairs[0].long()] + half[:, o.pairs[1].long()]
    fold = g if g <= 8 else 4
    chunks = args.view(-1, fold, args.shape[1])
    prod = chunks[:, 0]
    for c in range(1, fold):
        prod = prod * chunks[:, c]
    logs = (torch.log2(prod) * np.float32(np.log(2.0))).view(-1, g // fold, args.shape[1])
    gsum = logs[:, 0]
    for c in range(1, g // fold):
        gsum = gsum + logs[:, c]
    sums = torch.zeros((o.n_barcodes, args.shape[1]))
    sums.index_add_(0, o.cb[::g].long(), FE.round_to_words(gsum, n_words))
    return o.penalties + sums


@pytest.mark.parametrize("n_words", [0, 2])
@pytest.mark.parametrize("group", [4, 8, 16])
def test_group_log_of_products_meets_the_sum_of_logs(workload, group, n_words):
    """The kernel's product-then-log group sums against the plain version's sum of logs per call."""
    calls = workload.groups[group]
    u = FE.fold_calls(workload.genotype_prob, calls)
    assert float(u.min()) >= 1e-4  # fold_calls' floor: a product of 8 arguments stays a normal float
    ours = _log_of_products(u, calls, n_words)
    plain = GE.group_logits_plain(u, calls, n_words)
    torch.testing.assert_close(ours, plain, **TOL)
    assert torch.equal(ours.argmax(1), plain.argmax(1))


def _even_barcodes(n_donors: int, calls_per_barcode: int, n_barcodes: int = 30, seed: int = 0):
    """(genotype_prob, EStepOperands) at doublet prior 0.25 on the CPU: every barcode with ``calls_per_barcode``
    calls, genotype probabilities in (0, 1), q below 0.5 and some calls at q = 1."""
    rng = np.random.RandomState(seed)
    n_variants = 80
    gprob = rng.rand(n_variants, n_donors).astype(np.float32)
    cb = np.repeat(np.arange(n_barcodes, dtype=np.int32), calls_per_barcode)
    vid = rng.randint(0, n_variants, len(cb)).astype(np.int32)
    q = (rng.rand(len(cb)) * 0.5).astype(np.float32)
    q[::11] = 1.0
    estep = estep_operands(n_donors, 0.25, t(csr_row_pointers(cb, n_barcodes)), t(cb), t(vid), t(q), n_variants)
    return t(gprob), estep


@pytest.mark.parametrize("n_donors", [2, 7, 32, 64])
def test_folded_schedule_covers_every_column_once(n_donors):
    """The operands' schedule holds every column of their pairs in exactly one slot, its own donor pair's."""
    _, estep = _even_barcodes(n_donors, 3)
    ops = FE.variant_operands(estep)
    assert isinstance(ops, FE.CheckedOperands)
    table, pairs = ops.schedule.numpy(), ops.pairs.numpy()
    assert table.dtype == np.int32 and table.shape[1:] == (32, 24)
    columns = table[..., 4:]
    assert sorted(columns[columns >= 0].tolist()) == list(range(pairs.shape[1]))
    for entry in table.reshape(-1, 24):
        p, q, r, s = entry[:4]
        slots = [(4 * p + a, 4 * q + b) for a in range(4) for b in range(4)] + \
                [(2 * r + a, 2 * s + b) for a in range(2) for b in range(2)]
        for (i, j), g in zip(slots, entry[4:]):
            if g >= 0:
                assert (pairs[0, g], pairs[1, g]) == (i, j)
    assert type(ops._replace(row_ptr=ops.row_ptr)) is FE.VariantOperands  # a replaced field drops the check


def _folded_log_of_products(u: torch.Tensor, ops: FE.VariantOperands) -> torch.Tensor:
    """The folded kernel's sums: U halved, each argument its column's two halves added, each barcode's calls in
    products of 8 from its first call on (the last padded with arguments of 1), one log2 each, summed in call
    order, scaled by ln 2."""
    half = 0.5 * u
    args = half[:, ops.pairs[0].long()] + half[:, ops.pairs[1].long()]
    n_pg = args.shape[1]
    sums = torch.zeros((ops.n_barcodes, n_pg))
    for b, (lo, hi) in enumerate(zip(ops.row_ptr[:-1].tolist(), ops.row_ptr[1:].tolist())):
        rows = torch.cat([args[lo:hi], torch.ones((-(hi - lo) % 8, n_pg))])
        total = torch.zeros(n_pg)
        for c0 in range(0, rows.shape[0], 8):
            prod = rows[c0]
            for c in range(c0 + 1, c0 + 8):
                prod = prod * rows[c]
            total = total + torch.log2(prod)
        sums[b] = total * np.float32(np.log(2.0))
    return ops.penalties + sums


@pytest.mark.parametrize("calls_per_barcode", [1, 7, 8, 9, 33])
def test_folded_log_of_products_meets_the_sum_of_logs(calls_per_barcode):
    """One log per 8 calls, a barcode's last product short, against the plain version's log per call."""
    gprob, estep = _even_barcodes(7, calls_per_barcode, seed=calls_per_barcode)
    u, ops = FE.fold_calls(gprob, estep), FE.variant_operands(estep)
    assert float(u.min()) >= 1e-4  # fold_calls' floor: a product of 8 arguments stays a normal float
    ours = _folded_log_of_products(u, ops)
    plain = FE.folded_logits_plain(u, ops)
    torch.testing.assert_close(ours, plain, **TOL)
    assert torch.equal(ours.argmax(1), plain.argmax(1))
