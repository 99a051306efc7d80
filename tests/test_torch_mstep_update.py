"""The fused M-step (``mstep_update``) and its operands against the JAX package.

On the CPU the wrappers run their plain versions. The JAX side of one EM
step is the M-step addition as tests/test_pallas_kernel.py runs it (the
Pallas kernel in interpret mode), the anchor mask, then
``demuxalot_tpu.ops.likelihood.probs_from_betas`` on prior + addition.
Tolerances: additions rtol=1e-4, atol=1e-5 (the M-step oracle tests');
genotype probabilities atol=1e-6; the EM loop to ROADMAP's bar: identical
argmax, additions and losses equal to 4 decimals. The CUDA kernels against
these plain versions, bit for bit, are in tests/test_torch_gpu.py.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from benchmarks.synth_calls import synthesize_compressed_calls as jax_compressed_calls
from demuxalot_tpu import BarcodeHandler as JaxBarcodeHandler
from demuxalot_tpu import Demultiplexer as JaxDemultiplexer
from demuxalot_tpu.ops import likelihood as JL
from demuxalot_tpu.ops.pallas_mstep import TiledMstepCalls
from demuxalot_tpu_torch import BarcodeHandler, Demultiplexer, sim
from demuxalot_tpu_torch.models.demux import _EMRun
from demuxalot_tpu_torch.ops import packing
from demuxalot_tpu_torch.ops.mstep_kernel import (
    MStepOperands, mstep_addition, mstep_addition_plain, mstep_update, mstep_update_plain)
from demuxalot_tpu_torch.utils.profiling import MStepRoofline
from torch_problems import mstep_operands, t, update_problem

torch.set_num_threads(1)

ADDITION_TOL = dict(rtol=1e-4, atol=1e-5)
CLIP = 0.01


def _jax_em_step(p, power, mask):
    """The JAX package's M-step addition (Pallas, interpret mode), the mask, probs_from_betas."""
    layout = TiledMstepCalls(p["vid"], p["cb"], p["q"], p["n_variants"], tile_variants=64, chunk_calls=128)
    addition = layout.addition(jnp.asarray(p["post"]), n_genotypes=p["n_donors"], contribution_power=power,
                               interpret=True)
    if mask is not None:
        addition = addition * jnp.asarray(mask)
    window = p["max_per_snp"] if p["max_per_snp"] <= packing.MAX_WINDOWED_RUN else 0
    gprob = JL.probs_from_betas(jnp.asarray(p["prior"]) + addition, jnp.asarray(p["variant2snp"]), p["n_snps"],
                                CLIP, max_per_snp=window)
    return np.asarray(addition), np.asarray(gprob)


@pytest.mark.parametrize("runs", [(1,), (2,), (6,), (1, 2, 6)])
@pytest.mark.parametrize("damping", [None, "anchor"])
@pytest.mark.parametrize("power", [1.0, 2.0, 0.5])
def test_mstep_update_plain_matches_jax_em_step(power, damping, runs):
    p = update_problem(seed=len(runs) + int(power * 10), runs=runs)
    mask = p["mask"] if damping == "anchor" else None
    operands = mstep_operands(p["vid"], p["cb"], p["q"], p["n_variants"], len(p["post"]), snp_ptr=p["snp_ptr"])
    args = (t(p["post"]), operands, t(p["prior"]), None if mask is None else t(mask), CLIP, p["n_donors"], power)
    addition, gprob = mstep_update_plain(*args)
    want_addition, want_gprob = _jax_em_step(p, power, mask)
    np.testing.assert_allclose(addition.numpy(), want_addition, **ADDITION_TOL)
    np.testing.assert_allclose(gprob.numpy(), want_gprob, rtol=0, atol=1e-6)
    if mask is not None:
        assert (addition.numpy()[mask[:, 0] == 0] == 0).all()
    # on CPU tensors the wrapper is the plain version, and counts no launch
    launches = mstep_update.launches
    wrapped = mstep_update(*args)
    assert mstep_update.launches == launches
    assert torch.equal(wrapped[0], addition) and torch.equal(wrapped[1], gprob)


def test_run_of_seven_takes_the_segment_path():
    """Past MAX_WINDOWED_RUN the operands carry no SNP runs: the addition kernel, then probs_from_betas'
    segment path, as the EM loop runs them."""
    p = update_problem(seed=3, runs=(7,))
    assert p["max_per_snp"] == 7 > packing.MAX_WINDOWED_RUN
    with pytest.raises(ValueError, match="runs of 1 to 6"):
        mstep_operands(p["vid"], p["cb"], p["q"], p["n_variants"], len(p["post"]), snp_ptr=p["snp_ptr"])
    operands = mstep_operands(p["vid"], p["cb"], p["q"], p["n_variants"], len(p["post"]))
    with pytest.raises(ValueError, match="no SNP runs"):
        mstep_update(t(p["post"]), operands, t(p["prior"]), None, CLIP, p["n_donors"], 2.0)
    addition = mstep_addition(t(p["post"]), operands, p["n_donors"], 2.0) * t(p["mask"])
    from demuxalot_tpu_torch.ops import likelihood as L
    gprob = L.probs_from_betas(t(p["prior"]) + addition, t(p["variant2snp"]), p["n_snps"], CLIP, max_per_snp=0)
    want_addition, want_gprob = _jax_em_step(p, 2.0, p["mask"])
    np.testing.assert_allclose(addition.numpy(), want_addition, **ADDITION_TOL)
    np.testing.assert_allclose(gprob.numpy(), want_gprob, rtol=0, atol=1e-6)


def _loss(probs, truth_columns):
    """Mean -log P(true column), clipped (tests/test_synthetic.py's loss)."""
    return float(-np.log(probs[np.arange(len(truth_columns)), truth_columns].clip(1e-4)).mean())


@pytest.mark.parametrize("damping", [None, "anchor"])
@pytest.mark.parametrize("fused", [True, False])
def test_em_run_matches_jax_engine(damping, fused, monkeypatch):
    """_EMRun over 3 iterations against the JAX engine: fused M-steps where SNP runs are short, the
    addition kernel and the segment normalisation where they are not (forced here by a cap of 1)."""
    monkeypatch.setattr(Demultiplexer, "device", "cpu")
    if not fused:
        monkeypatch.setattr(packing, "MAX_WINDOWED_RUN", 1)
    genotypes, calls, truth, _names = sim.synthesize_compressed_calls(200, 6, 300, 24, seed=2)
    jax_genotypes, jax_calls, _truth, _names = jax_compressed_calls(200, 6, 300, 24, seed=2)
    betas = np.array(genotypes.get_betas())
    betas[::3] = 0.0  # prior-less variants: the anchor mask takes them off
    genotypes, jax_genotypes = genotypes._with_betas(betas), jax_genotypes._with_betas(betas)
    barcodes = [f"BC{b:04d}" for b in range(200)]
    run = _EMRun(calls, genotypes, BarcodeHandler(barcodes), 3, CLIP, 0.35, None, damping=damping)
    assert (run.likelihood.mstep.snp_ptr is not None) == fused
    ours = [run.materialize(state) for state in run.device_iterations()]
    theirs = list(JaxDemultiplexer.staged_genotype_learning(jax_calls, jax_genotypes, JaxBarcodeHandler(barcodes),
                                                            n_iterations=3, doublet_prior=0.35, damping=damping))
    assert len(ours) == len(theirs) == 3
    for (probs, debug), (jax_probs, jax_debug) in zip(ours, theirs):
        truth_columns = [list(probs.columns).index("+".join(t)) for t in truth]
        np.testing.assert_array_equal(probs.values.argmax(1), jax_probs.values.argmax(1))
        np.testing.assert_almost_equal(debug["genotype_addition"], jax_debug["genotype_addition"], decimal=4)
        np.testing.assert_almost_equal(_loss(probs.values, truth_columns), _loss(jax_probs.values, truth_columns),
                                       decimal=4)
    if damping == "anchor":
        np.testing.assert_array_equal(ours[-1][1]["genotype_addition"][::3], 0.0)


@pytest.mark.parametrize("case", ["rows", "not_built", "no_runs", "runs_short", "run_empty"])
def test_mstep_operands_are_checked_once(case):
    """Operands come from mstep_operands, which records the barcodes it checked against."""
    p = update_problem(seed=5, runs=(2,))
    build = lambda snp_ptr=p["snp_ptr"]: mstep_operands(  # noqa: E731
        p["vid"], p["cb"], p["q"], p["n_variants"], len(p["post"]), snp_ptr=snp_ptr)
    post, prior = t(p["post"]), t(p["prior"])
    if case == "rows":  # a posterior of another dataset
        operands = build()
        for call in (lambda: mstep_addition(post[:-1], operands, p["n_donors"], 2.0),
                     lambda: mstep_update(post[:-1], operands, prior, None, CLIP, p["n_donors"], 2.0)):
            with pytest.raises(ValueError, match="rows"):
                call()
    elif case == "not_built":
        o = build()
        raw = MStepOperands(o.var_ptr, o.vid, o.cb, o.q, o.n_barcodes, o.snp_ptr, o.variant_run, o.max_per_snp)
        with pytest.raises(ValueError, match="mstep_operands"):
            mstep_addition(post, raw, p["n_donors"], 2.0)
        with pytest.raises(ValueError, match="mstep_operands"):
            mstep_update(post, raw, prior, None, CLIP, p["n_donors"], 2.0)
    elif case == "no_runs":
        with pytest.raises(ValueError, match="no SNP runs"):
            mstep_update(post, build(None), prior, None, CLIP, p["n_donors"], 2.0)
    else:  # snp_ptr that stops short of the last variant, or has an empty run
        snp_ptr = p["snp_ptr"][:-1] if case == "runs_short" else np.insert(p["snp_ptr"], 1, 0)
        with pytest.raises(ValueError, match="snp_ptr"):
            build(snp_ptr)


def test_snp_pointers_cut_the_device_rows_into_runs():
    reindex = packing.VariantReindex.build(np.array([3, 1, 1, 0, 3, 3, 5], dtype=np.int32))
    np.testing.assert_array_equal(reindex.snp_pointers(), [0, 1, 3, 6, 7])
    assert packing.VariantReindex.build(np.zeros(0, dtype=np.int32)).snp_pointers().tolist() == [0]


def test_mstep_roofline_counts_the_epilogue():
    shape = dict(n_calls=1000, n_donors=4, n_barcodes=50, n_variants=200)
    addition, update = MStepRoofline(**shape), MStepRoofline(**shape, n_runs=100, masked=True, neighbour_adds=200)
    # + run pointers, prior read and genotype_prob written, the mask
    assert update.bytes_moved() - addition.bytes_moved() == 8 * 101 + 8 * 200 * 4 + 4 * 200
    # + prior add, division, three clamps and the mask per (variant, donor), the denominators' adds
    assert update.operations() - addition.operations() == 6 * 200 * 4 + 200 * 4


def test_plain_update_is_the_plain_addition_then_probs_from_betas():
    """mstep_update_plain reads the run of every variant, which gives probs_from_betas' bits of the real
    SNP ids: each is contiguous either way."""
    from demuxalot_tpu_torch.ops import likelihood as L

    p = update_problem(seed=9, runs=(1, 2, 6))
    operands = mstep_operands(p["vid"], p["cb"], p["q"], p["n_variants"], len(p["post"]), snp_ptr=p["snp_ptr"])
    addition, gprob = mstep_update_plain(t(p["post"]), operands, t(p["prior"]), t(p["mask"]), CLIP, p["n_donors"],
                                         2.0)
    assert torch.equal(addition, mstep_addition_plain(t(p["post"]), operands, p["n_donors"], 2.0) * t(p["mask"]))
    want = L.probs_from_betas(t(p["prior"]) + addition, t(p["variant2snp"]) * 7 + 3, p["n_snps"] * 7 + 3, CLIP,
                              max_per_snp=p["max_per_snp"])
    assert torch.equal(gprob, want)
