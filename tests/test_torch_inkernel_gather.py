"""The port's banded E-step and M-step against the JAX in-kernel-gather kernels (interpret mode).

``benchmarks/inkernel_gather_kernels.py`` is imported as its own
``self_test`` imports it (through ``sys.path``), at ``self_test``'s size
(90 SNPs, 6 donors, 200 barcodes, 5,000 calls, prior 0.3, 3 bands). On the
CPU each wrapper runs its plain PyTorch version. Tolerances: banded logits
against the TPU kernel rtol=1e-4, atol=5e-3 with the same argmax (the JAX
tests' oracle tolerance); the banded plain E-step against the mainline
plain E-step rtol=1e-5, atol=1e-4 (``self_test``'s in-kernel-gather vs
mainline tolerance: only the order of the f32 sums differs); additions
rtol=1e-4, atol=1e-5. The CUDA kernels against these plain versions are in
tests/test_torch_gpu.py.
"""
import json
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from demuxalot_tpu.ops import likelihood as JL
from demuxalot_tpu.ops.pallas_likelihood import TiledDeviceCalls
from demuxalot_tpu.ops.pallas_mstep import TiledMstepCalls
from demuxalot_tpu.ops.tiling import tile_barcode_calls_banded
from demuxalot_tpu_torch.experiments import inkernel_gather as IG
from demuxalot_tpu_torch.ops.likelihood_kernel import estep_logits_plain, estep_operands
from demuxalot_tpu_torch.ops.packing import csr_row_pointers
from oracle import oracle_mstep, oracle_probs_from_betas
from torch_problems import t

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "benchmarks"))
import inkernel_gather_kernels as JIG  # noqa: E402

torch.set_num_threads(1)

N_SNPS, N_DONORS, N_BARCODES, N_CALLS, PRIOR, N_BANDS = 90, 6, 200, 5000, 0.3, 3
N_VARIANTS = 2 * N_SNPS


@pytest.fixture(scope="module")
def problem():
    """self_test's inputs (inkernel_gather_kernels.py:428-438), genotype probabilities from the oracle."""
    rng = np.random.RandomState(7)
    variant2snp = np.repeat(np.arange(N_SNPS, dtype=np.int32), 2)
    betas = rng.rand(N_VARIANTS, N_DONORS).astype(np.float32) * 10
    gprob = oracle_probs_from_betas(variant2snp, betas, 0.01)
    vid = rng.randint(0, N_VARIANTS, N_CALLS).astype(np.int32)
    cb = np.sort(rng.randint(0, N_BARCODES, N_CALLS)).astype(np.int32)
    q = (rng.rand(N_CALLS) * 0.8).astype(np.float32)
    post = rng.rand(N_BARCODES, N_DONORS * (N_DONORS + 1) // 2).astype(np.float32)
    post /= post.sum(axis=1, keepdims=True)
    return dict(gprob=gprob, vid=vid, cb=cb, q=q, post=post)


def _banded_estep(p, n_bands=N_BANDS, prior=PRIOR):
    return IG.banded_estep_operands(N_DONORS, prior, t(p["cb"]), t(p["vid"]), t(p["q"]), N_BARCODES, N_VARIANTS,
                                    n_bands)


def _jax_estep_layout(p):
    tiled = tile_barcode_calls_banded(p["cb"], p["vid"], p["q"], N_BARCODES, n_variants=N_VARIANTS,
                                      n_bands=N_BANDS, tile_barcodes=16, chunk_calls=128)
    mixing, _ = JL.pseudogenotype_mixing([f"D{i}" for i in range(N_DONORS)], PRIOR)
    return tiled, TiledDeviceCalls(mixing, JL.doublet_penalties(N_DONORS, PRIOR), tiled), mixing.shape[1]


def _jax_mstep_layout(p):
    order = np.argsort(p["vid"], kind="stable")
    layout = TiledMstepCalls(p["vid"][order], p["cb"][order], p["q"][order], N_VARIANTS, tile_variants=64,
                             chunk_calls=128, n_barcodes=N_BARCODES, n_bands=N_BANDS, n_genotypes=N_DONORS)
    assert len(layout.band_specs) >= 2
    return layout


def test_estep_banded_matches_jax_inkernel_gather(problem):
    """tiled_logits_inkernel_gather (the TPU kernel, interpret mode), sliced [:B, :PG], against the port."""
    _tiled, dev, n_pg = _jax_estep_layout(problem)
    theirs = np.asarray(JIG.tiled_logits_inkernel_gather(
        jnp.asarray(problem["gprob"]), dev.mixing_sl, dev.penalties_p, dev.vid, dev.seg_group, dev.q,
        dev.chunk_bounds, dev.chunk_suboff, n_super=dev.n_super, tbs=dev.tbs, tb=dev.tile_barcodes,
        tc=dev.chunk_calls, band_specs=dev.band_specs, interpret=True))[:N_BARCODES, :n_pg]
    ours = IG.estep_logits_banded(t(problem["gprob"]), _banded_estep(problem)).numpy()
    np.testing.assert_allclose(ours, theirs, rtol=1e-4, atol=5e-3)
    np.testing.assert_array_equal(ours.argmax(axis=1), theirs.argmax(axis=1))


@pytest.mark.parametrize("n_bands", [1, 3, 7, 250])
@pytest.mark.parametrize("prior", [0.0, PRIOR])
def test_estep_banded_plain_matches_mainline_plain(problem, n_bands, prior):
    """Band by band (250 bands over 180 variants: empty bands) the same logits as the main path's plain E-step."""
    p = problem
    mainline = estep_logits_plain(t(p["gprob"]), estep_operands(
        N_DONORS, prior, t(csr_row_pointers(p["cb"], N_BARCODES)), t(p["cb"]), t(p["vid"]), t(p["q"]),
        len(p["gprob"])))
    banded = IG.estep_logits_banded(t(p["gprob"]), _banded_estep(p, n_bands, prior))
    np.testing.assert_allclose(banded.numpy(), mainline.numpy(), rtol=1e-5, atol=1e-4)


def test_bands_match_the_jax_layouts(problem):
    """Every call lands in the band the JAX layout functions put it in: the same edges, and per band the same calls."""
    p = problem
    tiled, _dev, _ = _jax_estep_layout(p)
    ours = _banded_estep(p)
    np.testing.assert_array_equal(ours.band_edges.numpy(), tiled.band_edges)
    ptr = ours.band_ptr.numpy()
    assert ptr.shape == (N_BANDS, N_BARCODES + 1) and ptr[0, 0] == 0 and ptr[-1, -1] == N_CALLS
    np.testing.assert_array_equal(ptr[1:, 0], ptr[:-1, -1])  # band-major
    q_slots = tiled.q.reshape(-1)
    for k in range(N_BANDS):
        first, last = tiled.band_chunk_offsets[k], tiled.band_chunk_offsets[k + 1]
        slots = slice(first * tiled.chunk_calls, last * tiled.chunk_calls)
        real = q_slots[slots] < 1  # padding slots carry q = 1
        theirs = np.sort(tiled.vid[slots][real].astype(np.int64) + tiled.band_edges[k])
        lo, hi = ptr[k, 0], ptr[k, -1]
        mine = ours.vid[lo:hi].numpy().astype(np.int64) + tiled.band_edges[k]
        np.testing.assert_array_equal(np.sort(mine), theirs)
        assert (np.diff(ours.cb[lo:hi].numpy()) >= 0).all()  # barcode-sorted within the band
        np.testing.assert_array_equal(np.diff(ptr[k]), np.bincount(ours.cb[lo:hi].numpy(), minlength=N_BARCODES))

    layout = _jax_mstep_layout(p)
    n_bands = len(layout.band_specs)
    mine = IG.banded_mstep_operands(t(p["vid"]), t(p["cb"]), t(p["q"]), N_VARIANTS, N_BARCODES, n_bands)
    np.testing.assert_array_equal(mine.band_edges.numpy()[:-1], [spec[0] for spec in layout.band_specs])
    np.testing.assert_array_equal(mine.band_edges.numpy()[1:], [spec[1] for spec in layout.band_specs])
    q_slots = layout.q.reshape(-1)
    for k, (b_lo, _b_hi, c_lo, c_hi) in enumerate(layout.band_specs):
        slots = slice(c_lo * layout.chunk_calls, c_hi * layout.chunk_calls)
        real = q_slots[slots] < 1
        theirs = np.sort(layout.cb_global[slots][real].astype(np.int64) + b_lo)
        lo, hi = mine.band_ptr[k, 0].item(), mine.band_ptr[k, -1].item()
        np.testing.assert_array_equal(np.sort(mine.cb[lo:hi].numpy().astype(np.int64) + b_lo), theirs)
        assert (np.diff(mine.vid[lo:hi].numpy()) >= 0).all()


@pytest.mark.parametrize("n_bands", [1, 3, 7, 250])
def test_slot_plan_puts_every_call_in_one_slot(problem, n_bands):
    """The banded E-step's stream (``slot_plan``): each call in one slot of its barcode's stream, each segment
    from a multiple of 8 slots in band order, whole groups of 8, and no slot for an empty segment."""
    ops = _banded_estep(problem, n_bands)
    call_slot, seg_start, stream_len = IG.slot_plan(ops.band_ptr)
    counts = ops.band_ptr.diff(dim=1)
    assert call_slot.shape == (N_CALLS,) and seg_start.shape == (n_bands, N_BARCODES)
    assert bool((seg_start % IG.LOG_FOLD == 0).all()) and bool((stream_len % IG.LOG_FOLD == 0).all())
    keys = ops.cb.long() * int(stream_len.max()) + call_slot
    assert torch.unique(keys).numel() == N_CALLS  # one call a slot
    assert bool((call_slot < stream_len[ops.cb.long()]).all()) and bool((call_slot >= 0).all())
    padded = (counts + 7) // 8 * 8
    np.testing.assert_array_equal(seg_start[1:].numpy(), (seg_start[:-1] + padded[:-1]).numpy())  # band order
    np.testing.assert_array_equal(stream_len.numpy(), padded.sum(0).numpy())  # an empty segment takes no slot
    for k in range(n_bands):  # a segment's calls take its first slots, in order
        lo, hi = ops.band_ptr[k, 0].item(), ops.band_ptr[k, -1].item()
        b = ops.cb[lo:hi].long()
        offset = call_slot[lo:hi] - seg_start[k, b]
        np.testing.assert_array_equal(offset.numpy(), (torch.arange(lo, hi) - ops.band_ptr[k, b]).numpy())


@pytest.mark.parametrize("n_bands", [1, 12, 250])
def test_slot_plan_of_the_real_calls_ignores_padding(problem, n_bands):
    """Padding calls after each barcode's real calls end their band segments: the real calls keep their
    segment, their place in it and so their group of 8, and a segment's first slot moves by whole groups."""
    p = problem
    pad = 700
    rng = np.random.RandomState(11)
    vid = np.concatenate([p["vid"], rng.randint(0, N_VARIANTS, pad).astype(np.int32)])
    cb = np.concatenate([p["cb"], rng.randint(0, N_BARCODES, pad).astype(np.int32)])
    q = np.concatenate([p["q"], np.ones(pad, np.float32)])
    order = np.argsort(cb, kind="stable")
    plain, padded = _banded_estep(p, n_bands), _banded_estep(dict(p, vid=vid[order], cb=cb[order], q=q[order]),
                                                             n_bands)
    slots, starts, _ = IG.slot_plan(plain.band_ptr)
    slots_p, starts_p, _ = IG.slot_plan(padded.band_ptr)
    real = padded.q < 1
    np.testing.assert_array_equal(padded.vid[real].numpy(), plain.vid.numpy())  # the real calls, in order
    np.testing.assert_array_equal(padded.cb[real].numpy(), plain.cb.numpy())
    first = lambda o: torch.cat([o.band_ptr[:, 0], o.band_ptr[-1:, -1]])  # noqa: E731  each band's first call
    band = IG.band_of(torch.arange(N_CALLS), first(plain))  # band-major: a call's band from its index
    band_p = IG.band_of(torch.arange(N_CALLS + pad), first(padded))[real]
    np.testing.assert_array_equal(band_p.numpy(), band.numpy())
    b = plain.cb.long()
    offset = slots - starts[band, b]
    offset_p = slots_p[real] - starts_p[band, b]
    np.testing.assert_array_equal(offset_p.numpy(), offset.numpy())  # the same place, so the same group of 8
    assert bool(((starts_p - starts) % IG.LOG_FOLD == 0).all())


@pytest.mark.parametrize("n_bands", [0, -1])
def test_operand_builders_refuse_malformed_bands(problem, n_bands):
    p = problem
    with pytest.raises(ValueError, match="n_bands"):
        _banded_estep(p, n_bands)
    with pytest.raises(ValueError, match="n_bands"):
        IG.banded_mstep_operands(t(p["vid"]), t(p["cb"]), t(p["q"]), N_VARIANTS, N_BARCODES, n_bands)


def test_banded_table_places_each_band(problem):
    rows = torch.arange(13 * 3, dtype=torch.float32).reshape(13, 3) + 1
    edges = torch.from_numpy(IG.band_edges(13, 4))  # heights 3, 3, 3, 4
    height = IG.band_rows(edges.numpy())
    assert height == 4
    table = IG.banded_table(rows, edges, height)
    assert table.shape == (16, 3)
    for k in range(4):
        lo, hi = int(edges[k]), int(edges[k + 1])
        assert torch.equal(table[4 * k: 4 * k + hi - lo], rows[lo:hi])
        assert not table[4 * k + hi - lo: 4 * k + 4].any()


@pytest.mark.parametrize("power", [2.0, 1.0])
def test_mstep_banded_matches_jax_inkernel_gather_and_oracle(problem, power):
    """tiled_mstep_inkernel_gather (TiledMstepCalls(..., n_bands=3), interpret mode) and oracle_mstep."""
    p = problem
    layout = _jax_mstep_layout(p)
    theirs = np.asarray(JIG.tiled_mstep_inkernel_gather(
        jnp.asarray(p["post"]), *(jnp.asarray(x) for x in (
            layout.cb_global, layout.vl, layout.q, layout.chunk_bounds, layout.chunk_suboff)),
        n_variants=N_VARIANTS, n_genotypes=N_DONORS, tv=layout.tile_variants, tc=layout.chunk_calls,
        sps=layout.subtiles_per_super, contribution_power=power, band_specs=layout.band_specs, interpret=True))
    operands = IG.banded_mstep_operands(t(p["vid"]), t(p["cb"]), t(p["q"]), N_VARIANTS, N_BARCODES,
                                        len(layout.band_specs))
    ours = IG.mstep_addition_banded(t(p["post"]), operands, N_DONORS, power).numpy()
    np.testing.assert_allclose(ours, theirs, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(ours, oracle_mstep(p["post"], p["vid"], p["cb"], p["q"], N_VARIANTS, N_DONORS, power),
                               rtol=1e-4, atol=1e-5)


def test_padding_calls_are_exact_noops(problem):
    """Calls with q = 1 change no bit of the banded logits nor of the banded additions."""
    p = problem
    pad = 321
    rng = np.random.RandomState(5)
    vid = np.concatenate([p["vid"], rng.randint(0, N_VARIANTS, pad).astype(np.int32)])
    cb = np.concatenate([p["cb"], rng.randint(0, N_BARCODES, pad).astype(np.int32)])
    q = np.concatenate([p["q"], np.ones(pad, np.float32)])
    order = np.argsort(cb, kind="stable")  # padding after each barcode's real calls
    padded = dict(p, vid=vid[order], cb=cb[order], q=q[order])
    gprob = t(p["gprob"])
    assert torch.equal(IG.estep_logits_banded(gprob, _banded_estep(padded)),
                       IG.estep_logits_banded(gprob, _banded_estep(p)))
    mstep = lambda x: IG.mstep_addition_banded(  # noqa: E731
        t(p["post"]), IG.banded_mstep_operands(t(x["vid"]), t(x["cb"]), t(x["q"]), N_VARIANTS, N_BARCODES, 5),
        N_DONORS, 2.0)
    assert torch.equal(mstep(padded), mstep(p))


def test_banded_mstep_refuses_one_band_and_nonpositive_power(problem):
    p = problem
    post = t(p["post"])
    one_band = IG.banded_mstep_operands(t(p["vid"]), t(p["cb"]), t(p["q"]), N_VARIANTS, N_BARCODES, 1)
    with pytest.raises(ValueError, match="barcode-banded layout"):
        IG.mstep_addition_banded(post, one_band, N_DONORS, 2.0)
    two_bands = IG.banded_mstep_operands(t(p["vid"]), t(p["cb"]), t(p["q"]), N_VARIANTS, N_BARCODES, 2)
    for power in (0.0, -1.0):
        with pytest.raises(ValueError, match="contribution_power > 0"):
            IG.mstep_addition_banded(post, two_bands, N_DONORS, power)
        with pytest.raises(ValueError, match="contribution_power > 0"):
            IG.mstep_addition_banded_plain(post, two_bands, N_DONORS, power)


def test_wrappers_take_only_cpu_or_cuda_tensors(problem):
    p = problem
    estep = _banded_estep(p)
    meta = lambda x: x.to("meta")  # noqa: E731
    with pytest.raises(ValueError, match="cpu or cuda"):
        IG.estep_logits_banded(meta(t(p["gprob"])), IG.BandedEStepOperands(
            *(meta(x) if isinstance(x, torch.Tensor) else x for x in estep)))
    mstep = IG.banded_mstep_operands(t(p["vid"]), t(p["cb"]), t(p["q"]), N_VARIANTS, N_BARCODES, 3)
    with pytest.raises(ValueError, match="cpu or cuda"):
        IG.mstep_addition_banded(meta(t(p["post"])), mstep._replace(**{
            name: meta(getattr(mstep, name)) for name in ("band_edges", "band_ptr", "vid", "cb", "q")}), N_DONORS, 2.0)


def test_mstep_bands_for_fits_the_band_budget():
    n_bands = IG.mstep_bands_for(65_536, 32)
    assert IG.band_rows(IG.band_edges(65_536, n_bands)) * 32 * 4 <= IG.MSTEP_BAND_BYTES
    assert IG.band_rows(IG.band_edges(65_536, n_bands - 1)) * 32 * 4 > IG.MSTEP_BAND_BYTES
    assert IG.mstep_bands_for(10, 2) == 2


def test_ab_runner_on_the_cpu(capsys):
    """The A/B entry point at a small size on the CPU (the plain versions), and without a card for cuda."""
    args = ["--device", "cpu", "--n-barcodes", "300", "--n-donors", "5", "--n-snps", "400",
            "--calls-per-barcode", "20", "--n-bands", "4", "--mstep-bands", "3", "--repeats", "1"]
    assert IG.main(args) == 0
    result = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert result["device"] == "cpu" and result["estep_bands"] == 4 and result["mstep_bands"] == 3
    assert result["n_calls"] == 6000 and result["logits_max_abs_err"] < 5e-3
    assert np.isfinite(result["addition_max_abs_err"])
    assert set(result["ms"]) == {"estep_fused", "estep_logits", "estep_banded", "mstep", "mstep_banded"}
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            IG.main(["--n-barcodes", "10"])
