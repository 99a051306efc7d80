"""A 64-donor pool (2,080 columns at the doublet prior 0.35) on the port's plain path, at a small size on the CPU.

The pool is drawn in the benchmark cells' shape (``torch_problems.skewed_pool``:
log-normal calls a barcode, SNPs by Zipf rank) with 64 donors and 200
barcodes over 512 SNPs. ``_EMRun`` runs three iterations through either
likelihood: each iteration's logits and posteriors are held to the float64
oracle (``tests/oracle.py``) on that iteration's genotype probabilities,
and each M-step's addition to the oracle's on the posteriors before it. At
64 donors the kernels' plans take their wide paths: four E-step passes, the
aggregate row split over a block's warps, the M-step's chunk slots two
blocks of 32 donors wide; 32 donors take one pass and a warp a row.
"""
import numpy as np
import pytest
import torch

from demuxalot_tpu_torch import Demultiplexer
from demuxalot_tpu_torch.models.demux import _EMRun, _Likelihood
from demuxalot_tpu_torch.ops.aggregate_kernel import aggregate_plan
from demuxalot_tpu_torch.ops.likelihood_kernel import estep_schedule
from oracle import oracle_barcode_logits, oracle_mstep, oracle_snp_aggregated_logits
from torch_problems import skewed_pool

POOL = dict(n_barcodes=200, n_snps=512, calls_per_barcode=24)  # n_snps: a multiple of the pool's stride of 64
SEED = 2_160_484_321  # past 2**31
PRIOR, CLIP = 0.35, 0.01
# logits as the JAX tests hold the Pallas kernel to the oracle; posteriors at the bar the TPU kernel met against
# full f32; additions as the M-step oracle tests
LOGITS_TOL = dict(rtol=1e-4, atol=5e-3)
POSTERIOR_ATOL = 3e-5
ADDITION_TOL = dict(rtol=1e-4, atol=1e-5)


def _oracle_logits(likelihood, gprob: np.ndarray, n_donors: int) -> np.ndarray:
    """The oracle's logits of ``likelihood``'s calls (per call, or its (barcode, SNP) groups) on ``gprob``."""
    groups = likelihood.snp_groups
    if groups is None:
        c = likelihood.calls
        names = [f"Donor{i + 1:02}" for i in range(n_donors)]
        return oracle_barcode_logits(names, gprob, c.vid_b.numpy(), c.cb_b.numpy(), c.q_b.numpy().astype(np.float64),
                                     likelihood.n_barcodes, PRIOR)[0]
    pairs = groups.pairs.numpy()
    mixing = np.zeros((n_donors, pairs.shape[1]))
    np.add.at(mixing, (pairs[0], np.arange(pairs.shape[1])), 0.5)
    np.add.at(mixing, (pairs[1], np.arange(pairs.shape[1])), 0.5)
    calls_per_group = np.diff(groups.group_ptr.numpy())
    groups_per_barcode = np.diff(groups.barcode_ptr.numpy())
    group = np.repeat(np.arange(len(calls_per_group)), calls_per_group)  # a key of its own for every group
    barcode = np.repeat(np.arange(len(groups_per_barcode)), groups_per_barcode)[group]
    return oracle_snp_aggregated_logits(gprob.astype(np.float64), mixing, groups.vid.numpy(),
                                        groups.q.numpy().astype(np.float64), barcode, group, likelihood.n_barcodes,
                                        compensation=groups.compensation, p_bad_snp=groups.p_bad_snp)


@pytest.mark.parametrize("traffic", ["em_percall", "em_aggregate"])
def test_plain_em_at_64_donors_holds_to_the_float64_reference(traffic, monkeypatch):
    monkeypatch.setattr(Demultiplexer, "device", "cpu")
    monkeypatch.setattr(Demultiplexer, "aggregate_on_snps", traffic == "em_aggregate")
    genotypes, handler, packed = skewed_pool(SEED, n_donors=64, **POOL)
    run = _EMRun(packed, genotypes, handler, 3, CLIP, PRIOR, None)
    states = list(run.device_iterations())
    likelihood, power = run.likelihood, float(Demultiplexer.contribution_power)
    assert len(states) == 3 and likelihood.n_options == 2080
    assert (likelihood.snp_groups is not None) == (traffic == "em_aggregate")
    for state in states:
        gprob = run._normalise(state.addition).numpy()
        want = _oracle_logits(likelihood, gprob, 64)
        np.testing.assert_allclose(state.logits.numpy(), want, **LOGITS_TOL)
        want_probs = torch.softmax(torch.from_numpy(want).double(), dim=1).numpy()
        np.testing.assert_allclose(state.probs.numpy(), want_probs, rtol=0, atol=POSTERIOR_ATOL)
    o = likelihood.mstep
    for before, after in zip(states, states[1:]):
        want = oracle_mstep(before.probs.numpy().astype(np.float64), o.vid.numpy(), o.cb.numpy(),
                            o.q.numpy().astype(np.float64), o.n_variants, 64, power)
        assert after.addition.shape == (2 * POOL["n_snps"], 64)
        np.testing.assert_allclose(after.addition.numpy(), want, **ADDITION_TOL)


@pytest.mark.parametrize("n_donors, passes, row_split", [(64, 4, True), (32, 1, False)])
def test_kernel_plans_at_64_and_32_donors(n_donors, passes, row_split, monkeypatch):
    """The operands of a small pool: the E-step's schedule passes, whether the aggregate row is split over a
    block's warps (17 columns a lane at 2,080), and the M-step's chunk slots, one column a donor."""
    monkeypatch.setattr(Demultiplexer, "aggregate_on_snps", True)
    genotypes, handler, packed = skewed_pool(5, n_donors=n_donors, n_barcodes=4000, n_snps=512, calls_per_barcode=24)
    likelihood = _Likelihood(packed, handler.n_barcodes, genotypes.genotype_names, PRIOR, torch.device("cpu"))
    n_pg = n_donors * (n_donors + 1) // 2
    assert likelihood.n_options == int(likelihood.snp_groups.pairs.shape[1]) == n_pg
    assert likelihood.estep.schedule.shape[0] == estep_schedule(n_donors, PRIOR).shape[0] == passes
    plan = aggregate_plan(n_pg)
    assert (plan[0] == 0) == row_split
    if row_split:
        assert plan == (0, 17) and -(-n_pg // (32 * plan[1])) == 4
    o = likelihood.mstep
    assert o.plan.n_chunks > 0 and o.slots(n_donors).shape == (o.plan.n_chunks, n_donors)
