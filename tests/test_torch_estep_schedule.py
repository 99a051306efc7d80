"""The E-step kernel's tile schedule (``ops.likelihood_kernel.estep_schedule``), built on the host.

The CUDA kernel reads nothing else to know which donor pair each of its
register slots holds, so these tests pin the table: every column written
exactly once, every slot's pair the column's pair of
``ops.likelihood.pseudogenotype_pairs``, block indices inside the staged
row, and the lane shares at the bench width (32 donors, 528 columns).
"""
import numpy as np
import pytest

from demuxalot_tpu_torch.ops import likelihood as L
from demuxalot_tpu_torch.ops.likelihood_kernel import ENTRY, LANES, QUAD_SLOTS, SLOTS, estep_schedule

DONORS = [1, 2, 3, 4, 5, 31, 32, 33, 65, 128]
PRIORS = [0.0, 0.35]


def _slot_pairs(table: np.ndarray):
    """(column, donor i, donor j) of every slot of every (pass, lane), -1 columns included.

    Quad slot (a, b) holds donors (4p + a, 4q + b), duo slot (a, b) donors (2r + a, 2s + b).
    """
    entries = table.reshape(-1, ENTRY)
    for entry in entries:
        p, q, r, s = (int(v) for v in entry[:4])
        for k, g in enumerate(entry[4:4 + QUAD_SLOTS]):
            yield int(g), 4 * p + k // 4, 4 * q + k % 4
        for k, g in enumerate(entry[4 + QUAD_SLOTS:]):
            yield int(g), 2 * r + k // 2, 2 * s + k % 2


@pytest.mark.parametrize("doublet_prior", PRIORS)
@pytest.mark.parametrize("n_donors", DONORS)
def test_every_column_once_with_its_pair(n_donors, doublet_prior):
    table = estep_schedule(n_donors, doublet_prior)
    col_i, col_j = L.pseudogenotype_pairs(n_donors, doublet_prior)
    n_pg = len(col_i)
    assert table.dtype == np.int32 and table.ndim == 3 and table.shape[1:] == (LANES, ENTRY)
    assert not table.flags.writeable
    written = np.zeros(n_pg, np.int64)
    for g, i, j in _slot_pairs(table):
        assert -1 <= g < n_pg
        if g >= 0:
            written[g] += 1
            assert (i, j) == (col_i[g], col_j[g])
    np.testing.assert_array_equal(written, 1)


@pytest.mark.parametrize("doublet_prior", PRIORS)
@pytest.mark.parametrize("n_donors", DONORS)
def test_blocks_lie_inside_the_staged_row(n_donors, doublet_prior):
    """Quad blocks of 4 and duo blocks of 2 index the row padded to a multiple of 4 (checks.cu's bounds)."""
    table = estep_schedule(n_donors, doublet_prior)
    n_blocks = -(-n_donors // 4)
    assert (table[..., 0:2] >= 0).all() and (table[..., 0:2] < n_blocks).all()
    assert (table[..., 2:4] >= 0).all() and (table[..., 2:4] < 2 * n_blocks).all()
    assert (table[..., 0] <= table[..., 1]).all() and (table[..., 2] <= table[..., 3]).all()


@pytest.mark.parametrize("doublet_prior", PRIORS)
@pytest.mark.parametrize("n_donors", DONORS)
def test_passes_are_the_fewest_the_tiles_allow(n_donors, doublet_prior):
    """One pass walks the calls once: as many as the off-diagonal 4 x 4 tiles need, plus one if the
    diagonal blocks' 2 x 2 tiles do not fit the lanes left."""
    n_blocks = -(-n_donors // 4)
    off_diagonal = n_blocks * (n_blocks - 1) // 2 if doublet_prior else 0
    passes = estep_schedule(n_donors, doublet_prior).shape[0]
    assert passes >= max(1, -(-off_diagonal // LANES))
    assert passes <= max(1, -(-off_diagonal // LANES)) + 1


def test_bench_width_fits_one_warp():
    """32 donors with doublets: 528 columns in one pass of 32 lanes, at most 20 columns per lane."""
    table = estep_schedule(32, 0.35)
    assert table.shape == (1, LANES, ENTRY)
    per_lane = (table[0, :, 4:] >= 0).sum(axis=1)
    assert per_lane.sum() == 528 and per_lane.mean() == 16.5
    assert per_lane.max() == SLOTS == 20
    # 28 lanes take an off-diagonal tile of 16 pairs, 4 a diagonal one (10 pairs); 12 lanes take a 2 x 2
    # tile of blocks 4-7's diagonals, the 4 diagonal lanes first
    quads = table[0, :, :2]
    assert (quads[:, 0] < quads[:, 1]).sum() == 28
    duo = (table[0, :, 4 + QUAD_SLOTS:] >= 0).any(axis=1)
    assert duo.sum() == 12 and duo[quads[:, 0] == quads[:, 1]].all()
    assert sorted((table[0, duo, 2] // 2).tolist()) == [4] * 3 + [5] * 3 + [6] * 3 + [7] * 3


def test_singlets_only_schedule():
    """At doublet prior 0 the columns are the D singlets, i == j."""
    table = estep_schedule(32, 0.0)
    assert table.shape[0] == 1
    pairs = [(i, j) for g, i, j in _slot_pairs(table) if g >= 0]
    assert sorted(pairs) == [(d, d) for d in range(32)]
