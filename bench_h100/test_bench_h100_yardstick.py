"""The frozen copies (the generator's draws, the bounds' arithmetic) and the pool's shapes."""
import numpy as np
import pytest

from bench_h100 import bounds, generator, program
from bench_h100.tiny import TINY, tiny_cell


@pytest.mark.parametrize("seed", [0, 7, 2 ** 31 + 5])
def test_draws_match_the_ports_generator(seed):
    from demuxalot_tpu_torch.sim import synthesize_compressed_calls

    cell = tiny_cell("pbmc32_65k.em_percall")
    cell.config.update(calls_per_barcode_sigma=0, snp_zipf=0)  # the port's flat pool
    draws = generator.draw_config(cell.config, seed)
    want_genotypes, want_calls, _, names = synthesize_compressed_calls(
        TINY["n_barcodes"], TINY["n_donors"], TINY["n_snps"], TINY["calls_per_barcode"], seed=seed)
    genotypes, calls, handler = program.inputs(draws, cell.config)
    assert genotypes.genotype_names == names
    np.testing.assert_array_equal(genotypes.get_betas(), want_genotypes.get_betas())
    for a, b in zip(genotypes.variant_columns(), want_genotypes.variant_columns()):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    got, want = calls["chr1"], want_calls["chr1"]
    for field in want.snp_calls.dtype.names:
        np.testing.assert_array_equal(got.snp_calls[field], want.snp_calls[field])
    for field in want.molecules.dtype.names:
        np.testing.assert_array_equal(got.molecules[field], want.molecules[field])
    assert handler.n_barcodes == TINY["n_barcodes"]


def test_large_seeds_draw_distinct_pools():
    cell = tiny_cell("pbmc32_65k.em_percall")
    a = generator.draw_config(cell.config, 2 ** 32 + 1)
    b = generator.draw_config(cell.config, 1)
    assert not np.array_equal(a.snp, b.snp)
    np.testing.assert_array_equal(a.snp, generator.draw_config(cell.config, 2 ** 32 + 1).snp)


def test_every_seed_deals_the_same_barcode_sizes():
    cell = tiny_cell("pbmc32_65k.em_percall")
    a, b = (np.bincount(generator.draw_config(cell.config, seed).cb) for seed in (1, 2 ** 31 + 9))
    assert not np.array_equal(a, b)
    np.testing.assert_array_equal(np.sort(a), np.sort(b))
    mean = cell.config["calls_per_barcode"]
    assert abs(a.mean() - mean) < 0.01 * mean and a.max() > 1.5 * a.min()


def test_every_seed_puts_the_same_calls_on_each_snp():
    cell = tiny_cell("pbmc32_65k.em_percall")
    a, b = (generator.draw_config(cell.config, seed) for seed in (1, 2 ** 31 + 9))
    assert not np.array_equal(a.snp, b.snp)
    np.testing.assert_array_equal(np.bincount(a.snp, minlength=a.n_snps), np.bincount(b.snp, minlength=b.n_snps))


def test_calls_pile_onto_the_top_ranked_snps():
    """SNP of rank r draws 1 / r of the weight: the top one about 1 / H(S) of the calls, groups of several."""
    cell = tiny_cell("pbmc32_65k.em_percall")
    draws = generator.draw_config(cell.config, 4)
    per_snp = np.bincount(draws.snp, minlength=draws.n_snps)
    harmonic = (1.0 / np.arange(1, draws.n_snps + 1)).sum()
    assert abs(per_snp.max() / draws.n_calls - 1 / harmonic) < 0.2 / harmonic
    _, groups = np.unique(draws.cb.astype(np.int64) * draws.n_snps + draws.snp, return_counts=True)
    assert groups.max() >= 5 and groups.sum() > 1.1 * len(groups)


def test_a_config_with_other_than_two_variants_a_snp_is_refused():
    cell = tiny_cell("pbmc32_65k.em_percall")
    cell.config["variants_per_snp"] = 3
    with pytest.raises(ValueError):
        generator.draw_config(cell.config, 1)


def test_estep_bound_by_hand():
    r = bounds.Roofline(n_calls=10, n_donors=2, n_pseudogenotypes=3, n_barcodes=4, n_variants=5, softmax=True)
    assert r.bytes_moved() == 8 * 10 + 8 * 5 + 4 * 5 * 2 + 12 * 3 + 4 * 4 * 3 * 2 == 292
    assert r.operations() == 10 * (4 * 3 + 3 * 2) + 5 * 4 * 3 == 240
    assert r.speed_of_light_s() == max(292 / 3.35e12, 240 / 67e12)


def test_mstep_bound_by_hand():
    r = bounds.MStepRoofline(n_calls=10, n_donors=2, n_barcodes=4, n_variants=6, n_runs=3, neighbour_adds=6)
    assert r.bytes_moved() == (8 * 10 + 8 * 7 + 4 * 4 * 2 + 4 * 6 * 2) + 8 * 4 + 8 * 6 * 2 == 344
    assert r.operations() == 3 * 10 * 2 + 5 * 6 * 2 + 6 * 2 == 132


def test_aggregate_bound_by_hand():
    r = bounds.AggregateBound(n_calls=10, n_groups=6, n_barcodes=4, n_variants=6, n_donors=2, n_pseudogenotypes=3)
    assert r.bytes_moved() == 8 * 10 + 8 * 7 + 8 * 5 + 4 * 6 * 2 + 8 * 3 + 8 * 4 * 3 == 344
    # per (call, donor) 1, per (call, column) 1 + 1 past a group's first call, per (group, column) 4, softmax 5
    assert r.operations() == 10 * 2 + 10 * 3 + (10 - 6) * 3 + 4 * 6 * 3 + 5 * 4 * 3 == 194


def test_aggregate_bound_below_the_mufu_floor():
    """The bound counts fewer operations, at a faster rate, than the program's MUFU-only floor: it is lower."""
    from demuxalot_tpu_torch.utils.profiling import AggregateRoofline

    shape = dict(n_calls=4_194_296, n_groups=3_489_602, n_barcodes=65_536, n_variants=131_072, n_donors=32,
                 n_pseudogenotypes=528)
    ours = bounds.AggregateBound(**shape)
    theirs = AggregateRoofline(**shape, softmax=True)
    assert ours.bytes_moved() == theirs.bytes_moved()
    assert ours.speed_of_light_s() < theirs.speed_of_light_s()


@pytest.mark.parametrize("shape", [(3_529_404, 32, 528, 65_536, 131_072), (11, 3, 6, 5, 7)])
def test_frozen_bounds_equal_the_programs(shape):
    from demuxalot_tpu_torch.utils.profiling import MStepRoofline, Roofline

    n, d, pg, b, v = shape
    for softmax in (False, True):
        ours = bounds.Roofline(n, d, pg, b, v, softmax=softmax)
        theirs = Roofline(n, d, pg, b, v, softmax=softmax)
        assert (ours.bytes_moved(), ours.operations()) == (theirs.bytes_moved(), theirs.operations())
    ours = bounds.MStepRoofline(n, d, b, v, n_runs=v // 2, neighbour_adds=v)
    theirs = MStepRoofline(n, d, b, v, n_runs=v // 2, neighbour_adds=v)
    assert (ours.bytes_moved(), ours.operations()) == (theirs.bytes_moved(), theirs.operations())
