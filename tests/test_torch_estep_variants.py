"""The port's E-step variants against the JAX harnesses' TPU kernels (interpret mode).

``benchmarks/exp_estep.py``, ``exp_split.py`` and ``exp_group.py`` are
imported through ``sys.path`` and their kernels wrapped here in
``pl.pallas_call(..., grid_spec=PrefetchScalarGridSpec(...),
interpret=True)`` with the grid specs of ``folded_logits``,
``run_variant`` and ``group_logits`` (those wrappers hard-code no
``interpret``). Inputs: ``synthesize_device_workload(200, 6, 90, 20,
seed=3)`` at doublet prior 0.25, laid out as the harnesses lay them out
(``tile_barcode_calls`` with its defaults, TB 32 and TC 512,
``TiledDeviceCalls``, ``per_call_segments``; ``GroupLayout`` with
``choose_subtiles_per_super``). On the CPU each wrapper runs its plain
PyTorch version, held to the TPU kernel at rtol 1e-4 / atol 5e-3 with the
same argmax (the JAX tests' oracle tolerance). The CUDA kernels against
these plain versions are in tests/test_torch_gpu.py.
"""
import functools
import json
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from demuxalot_tpu import sim as jsim
from demuxalot_tpu.ops import likelihood as JL
from demuxalot_tpu.ops.pallas_likelihood import TiledDeviceCalls, padded_pg
from demuxalot_tpu.ops.tiling import choose_subtiles_per_super, per_call_segments, tile_barcode_calls
from demuxalot_tpu_torch.experiments import estep_variants as EV
from demuxalot_tpu_torch.experiments import folded_estep as FE
from demuxalot_tpu_torch.experiments import group_estep as GE
from demuxalot_tpu_torch.experiments import split_estep as SE
from demuxalot_tpu_torch.ops.likelihood_kernel import estep_operands
from demuxalot_tpu_torch.ops.packing import csr_row_pointers
from torch_problems import t

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "benchmarks"))
import exp_estep as JE  # noqa: E402
import exp_group as JG  # noqa: E402
import exp_split as JS  # noqa: E402

torch.set_num_threads(1)

N_BARCODES, N_DONORS, N_SNPS, CALLS_PER_BARCODE, SEED, PRIOR = 200, 6, 90, 20, 3, 0.25
TOL = dict(rtol=1e-4, atol=5e-3)


def _round_up(x, m):
    return -(-x // m) * m


@pytest.fixture(scope="module")
def harness():
    """The harnesses' inputs and layouts at the small size, numpy and JAX."""
    betas, v2s, vid, cb, q, _ = jsim.synthesize_device_workload(N_BARCODES, N_DONORS, N_SNPS, CALLS_PER_BARCODE,
                                                                seed=SEED)
    mixing, _ = JL.pseudogenotype_mixing([f"D{i:02}" for i in range(N_DONORS)], PRIOR)
    penalties = JL.doublet_penalties(N_DONORS, PRIOR)
    gp = np.array(jax.jit(JL.probs_from_betas, static_argnums=(2, 3))(
        jnp.asarray(betas), jnp.asarray(v2s), N_SNPS, 0.01))
    pg = mixing.shape[1]
    pgp, pg_sl, d_pad = padded_pg(pg), _round_up(pg, 8), _round_up(N_DONORS, 8)
    mixing_sl = np.zeros((pg_sl, d_pad), np.float32)
    mixing_sl[:pg, :N_DONORS] = mixing.T
    mixing_p = np.zeros((d_pad, pgp), np.float32)
    mixing_p[:N_DONORS, :pg] = mixing
    penalties_p = np.zeros((1, pgp), np.float32)
    penalties_p[0, :pg] = penalties
    return dict(gp=gp, vid=vid, cb=cb, q=q, mixing=mixing, penalties=penalties, pg=pg, pgp=pgp, pg_sl=pg_sl,
                d_pad=d_pad, mixing_sl=mixing_sl, mixing_p=mixing_p, penalties_p=penalties_p)


def _fold_jax(h, vid, q):
    """U [D_pad, N] as the harnesses fold it: G.T[:, vid]·(1 − q) + max(q, 1e-4), donor rows padded with 0."""
    gp_t = np.zeros((h["d_pad"], h["gp"].shape[0]), np.float32)
    gp_t[:N_DONORS] = h["gp"].T
    q = np.asarray(q, np.float32).reshape(1, -1)
    return jnp.asarray(gp_t)[:, jnp.asarray(vid)] * jnp.asarray(1.0 - q) + jnp.asarray(np.maximum(q, 1e-4))


def _estep_call(kernel, u, cbl, vmem, *, n_super, tbs, tc, cbl_width, pgp, bounds, suboff):
    """One harness kernel under ``pl.pallas_call(..., interpret=True)`` with the harnesses' grid spec."""
    grid_spec = pltpu.PrefetchScalarGridSpec(
        num_scalar_prefetch=2,
        grid=(n_super,),
        in_specs=[pl.BlockSpec(memory_space=pl.ANY), pl.BlockSpec(memory_space=pl.ANY)]
        + [pl.BlockSpec(x.shape, lambda s, *_: (0, 0)) for x in vmem],
        out_specs=pl.BlockSpec((tbs, pgp), lambda s, *_: (s, 0)),
        scratch_shapes=[
            pltpu.VMEM((2, u.shape[0], tc), jnp.float32),
            pltpu.VMEM((2, 1, cbl_width), jnp.int32),
            pltpu.SemaphoreType.DMA((2,)),
            pltpu.SemaphoreType.DMA((2,)),
        ],
    )
    call = pl.pallas_call(kernel, grid_spec=grid_spec, out_shape=jax.ShapeDtypeStruct((n_super * tbs, pgp), jnp.float32),
                          interpret=True)
    return np.asarray(call(jnp.asarray(bounds), jnp.asarray(suboff), u, jnp.asarray(cbl),
                           *(jnp.asarray(x) for x in vmem)))


@pytest.fixture(scope="module")
def tiled(harness):
    """The mainline TPU layout (tile_barcode_calls defaults) and its folded U, as exp_estep/exp_split build them."""
    h = harness
    layout = tile_barcode_calls(h["cb"], h["vid"], h["q"], N_BARCODES)
    dev = TiledDeviceCalls(h["mixing"], h["penalties"], layout)
    cb_local = per_call_segments(layout).reshape(1, -1)
    # the TPU's nolog ablation sums every slot's argument, and a padding slot's is 1 (U = 1), added to
    # the row its tile-local segment 0 maps to: pad_args counts them per output row
    padding = layout.q.reshape(-1) >= 1
    rows = layout.chunk2tile.repeat(layout.chunk_calls) * layout.tile_barcodes + cb_local.reshape(-1)
    pad_args = np.bincount(rows[padding], minlength=layout.n_tiles * layout.tile_barcodes)
    return dict(dev=dev, u=_fold_jax(h, np.asarray(dev.vid), layout.q), cb_local=cb_local, pad_args=pad_args)


def _mainline_call(tiled, kernel, vmem, pgp):
    dev = tiled["dev"]
    return _estep_call(kernel, tiled["u"], tiled["cb_local"], vmem, n_super=dev.n_super, tbs=dev.tbs,
                       tc=dev.chunk_calls, cbl_width=dev.chunk_calls, pgp=pgp, bounds=np.asarray(dev.chunk_bounds),
                       suboff=np.asarray(dev.chunk_suboff))


@pytest.fixture(scope="module")
def port(harness):
    """The port's operands and folded calls from the same numpy inputs."""
    h = harness
    estep = estep_operands(N_DONORS, PRIOR, t(csr_row_pointers(h["cb"], N_BARCODES)), t(h["cb"]), t(h["vid"]),
                           t(h["q"]), len(h["gp"]))
    gprob = t(h["gp"])
    return dict(estep=estep, gprob=gprob, operands=FE.variant_operands(estep), u=FE.fold_calls(gprob, estep))


def _same(ours: torch.Tensor, theirs: np.ndarray, pg: int):
    theirs = theirs[:N_BARCODES, :pg]
    np.testing.assert_allclose(ours.numpy(), theirs, **TOL)
    np.testing.assert_array_equal(ours.numpy().argmax(axis=1), theirs.argmax(axis=1))


@pytest.mark.parametrize("transposed_log", [True, False])
@pytest.mark.parametrize("use_log", [True, False])
def test_folded_matches_folded_kernel(harness, tiled, port, use_log, transposed_log):
    """Both TPU orientations (transposed_log only orients the tiles) against the one port.

    use_log off is the nolog ablation: the TPU kernel then also adds each
    padding slot's argument (1) to its tile's first row, which the test
    subtracts before holding the two to the same bar.
    """
    h, dev = harness, tiled["dev"]
    kernel = functools.partial(JE._folded_kernel, tb=dev.tile_barcodes, tc=dev.chunk_calls, pg_sl=h["pg_sl"],
                               use_log=use_log, transposed_log=transposed_log, precision=jax.lax.Precision.HIGHEST)
    theirs = _mainline_call(tiled, kernel, (h["mixing_sl"], h["mixing_p"], h["penalties_p"]), h["pgp"])
    ours = FE.folded_logits(port["u"], port["operands"], use_log=use_log)
    if not use_log:  # the port sums the real calls' arguments only
        theirs = theirs - tiled["pad_args"][: len(theirs), None]
    _same(ours, theirs, h["pg"])


@pytest.mark.parametrize("exp_words, sc_words", SE.HARNESS_PAIRS)
def test_split_matches_split_kernel(harness, tiled, port, exp_words, sc_words):
    h, dev = harness, tiled["dev"]
    kernel = JS.make_kernel(dev.tile_barcodes, dev.chunk_calls, h["pg_sl"], exp_words, sc_words)
    theirs = _mainline_call(tiled, kernel, (h["mixing_sl"], h["penalties_p"]), h["pgp"])
    _same(SE.split_logits(port["u"], port["operands"], exp_words, sc_words), theirs, h["pg"])


@pytest.fixture(scope="module")
def group_layouts(harness):
    """{TC: (GroupLayout, n_super, bounds, suboff)} as exp_group.main builds them, TB 32."""
    h = harness
    out = {}
    for tc in (512, 1024):
        lay = JG.GroupLayout(h["cb"], h["vid"], h["q"], N_BARCODES, tb=32, tc=tc)
        sps = choose_subtiles_per_super(lay.n_tiles, lay.n_chunks, 32, h["pgp"])
        n_super = -(-lay.n_tiles // sps)
        chunks_per_tile = np.bincount(lay.chunk2tile, minlength=lay.n_tiles)
        tile_starts = np.concatenate([[0], np.cumsum(chunks_per_tile)])
        bounds = tile_starts[::sps].tolist()
        if len(bounds) < n_super + 1 or bounds[-1] != lay.n_chunks:
            bounds = (bounds + [lay.n_chunks] * (n_super + 1))[: n_super + 1]
        out[tc] = (lay, n_super, sps, np.asarray(bounds, np.int32), (lay.chunk2tile % sps).astype(np.int32))
    return out


@pytest.mark.parametrize("n_words", [0, 1, 2])
@pytest.mark.parametrize("tc", [512, 1024])
def test_group_matches_group_kernel(harness, port, group_layouts, tc, n_words):
    """G = TC/128: 4 at TC 512, 8 at TC 1024."""
    h = harness
    lay, n_super, sps, bounds, suboff = group_layouts[tc]
    kernel = functools.partial(JG._group_kernel, tb=32, tc=tc, pg_sl=h["pg_sl"], n_words=n_words, use_log=True)
    theirs = _estep_call(kernel, _fold_jax(h, lay.vid, lay.q), lay.cbg, (h["mixing_sl"], h["penalties_p"]),
                         n_super=n_super, tbs=32 * sps, tc=tc, cbl_width=128, pgp=h["pgp"], bounds=bounds,
                         suboff=suboff)
    calls = GE.group_layout(port["estep"], tc // 128)
    ours = GE.group_logits(FE.fold_calls(port["gprob"], calls), calls, n_words)
    _same(ours, theirs, h["pg"])


@pytest.mark.parametrize("tc", [512, 1024])
def test_group_layout_puts_each_call_in_the_jax_group(harness, tc):
    """Every call lies in a group with the same calls as GroupLayout's: each call's id rides in as its vid."""
    h = harness
    ids = np.arange(len(h["vid"]), dtype=np.int32)
    q = np.full(len(ids), 0.5, np.float32)
    lay = JG.GroupLayout(h["cb"], ids, q, N_BARCODES, tb=32, tc=tc)
    real = lay.q.reshape(-1) < 1
    slot = np.nonzero(real)[0]
    jax_group = (slot // tc) * 128 + slot % 128  # lane (i % G)·128 + i // G holds group i // G
    theirs = {}
    for g, call in zip(jax_group, lay.vid[slot]):
        theirs.setdefault(int(g), []).append(int(call))
    estep = estep_operands(N_DONORS, PRIOR, t(csr_row_pointers(h["cb"], N_BARCODES)), t(h["cb"]), t(ids), t(q),
                           len(ids))
    calls = GE.group_layout(estep, tc // 128)
    ptr = calls.operands.row_ptr.numpy()
    assert (np.diff(ptr) % calls.group == 0).all() and calls.n_calls == ptr[-1]
    at = np.nonzero(calls.q.numpy() < 1)[0]
    barcode = calls.operands.cb.numpy()[at]
    ours = {}
    for b, position, call in zip(barcode, at, calls.vid.numpy()[at]):
        ours.setdefault((int(b), int(position - ptr[b]) // calls.group), []).append(int(call))
    assert sorted(map(sorted, theirs.values())) == sorted(map(sorted, ours.values()))
    np.testing.assert_array_equal(calls.vid.numpy()[calls.q.numpy() == 1], 0)  # padding slots: vid 0, q 1
    assert int((calls.q == 1).sum()) == calls.n_calls - len(ids)


@pytest.mark.parametrize("n_words", [1, 2, 3])
def test_split_words_match_bfloat16_words(n_words):
    """Word by word, split_words is dot_split's ``word = rem.astype(bfloat16); rem -= word``."""
    rng = np.random.RandomState(n_words)
    x = np.concatenate([rng.rand(500) * 10 ** rng.uniform(-6, 3, 500), -rng.rand(100) * 7,
                        [0.0, 1.0, 1e-4, 0.5 + 2 ** -9, 1 + 3 * 2 ** -9]]).astype(np.float32)
    ours = SE.split_words(t(x), n_words).numpy()
    rem = jnp.asarray(x)
    for k in range(n_words):
        word = rem.astype(jnp.bfloat16).astype(jnp.float32)
        np.testing.assert_array_equal(ours[k], np.asarray(word))
        rem = rem - word
    np.testing.assert_array_equal(FE.round_to_words(t(x), n_words).numpy(), ours.sum(axis=0) if n_words < 3
                                  else (ours[0] + ours[1]) + ours[2])


def test_padding_leaves_the_plain_logits_bit_equal(harness, port):
    """q = 1 calls after each barcode's real calls: U = 1, a log of 0, no bit of any variant's logits moves."""
    h = harness
    pad = 173
    rng = np.random.RandomState(4)
    cb = np.concatenate([h["cb"], rng.randint(0, N_BARCODES, pad).astype(np.int32)])
    vid = np.concatenate([h["vid"], rng.randint(0, h["gp"].shape[0], pad).astype(np.int32)])
    q = np.concatenate([h["q"], np.ones(pad, np.float32)])
    order = np.argsort(cb, kind="stable")
    padded = estep_operands(N_DONORS, PRIOR, t(csr_row_pointers(cb[order], N_BARCODES)), t(cb[order]),
                            t(vid[order]), t(q[order]), len(h["gp"]))
    gprob = port["gprob"]
    for estep in (port["estep"], padded):
        estep_u = FE.fold_calls(gprob, estep)
        ops = FE.variant_operands(estep)
        got = [FE.folded_logits(estep_u, ops)] + [SE.split_logits(estep_u, ops, e, s) for e, s in SE.HARNESS_PAIRS]
        for g in GE.HARNESS_GROUPS:
            calls = GE.group_layout(estep, g)
            got += [GE.group_logits(FE.fold_calls(gprob, calls), calls, w) for w in (0, 1, 2)]
        if estep is port["estep"]:
            base = got
    assert all(torch.equal(a, b) for a, b in zip(base, got))


def test_variants_meet_the_mainline_bars(port):
    """The plain versions against the mainline plain E-step: folded at the logits bar, split (2,2) and the
    group variants too, split (1,1) shifted by its one bf16 word."""
    from demuxalot_tpu_torch.ops.likelihood_kernel import estep_logits

    mainline = estep_logits(port["gprob"], port["estep"])
    u, ops = port["u"], port["operands"]
    torch.testing.assert_close(FE.folded_logits(u, ops), mainline, **TOL)
    torch.testing.assert_close(SE.split_logits(u, ops, 2, 2), mainline, **TOL)
    for g in GE.HARNESS_GROUPS:
        calls = GE.group_layout(port["estep"], g)
        torch.testing.assert_close(GE.group_logits(FE.fold_calls(port["gprob"], calls), calls, 2), mainline, **TOL)
    assert float((SE.split_logits(u, ops, 1, 1) - mainline).abs().max()) > TOL["atol"]


def test_column_pairs_roundtrip_and_refusal(harness):
    mixing = harness["mixing"]
    pairs = FE.column_pairs(mixing)
    assert pairs.dtype == np.int32 and pairs.shape == (2, mixing.shape[1])
    np.testing.assert_array_equal(pairs[:, :N_DONORS], np.stack([np.arange(N_DONORS)] * 2))
    assert (pairs[0, N_DONORS:] < pairs[1, N_DONORS:]).all()
    bad = mixing.copy()
    bad[0, 0] = 0.7
    with pytest.raises(ValueError, match="mixing column"):
        FE.column_pairs(bad)


def test_wrappers_check_their_inputs(port):
    u, ops = port["u"], port["operands"]
    meta = FE.VariantOperands(*(x.to("meta") for x in ops))
    for run in (lambda: FE.folded_logits(u.to("meta"), meta), lambda: SE.split_logits(u.to("meta"), meta, 2, 2)):
        with pytest.raises(ValueError, match="cpu or cuda"):
            run()
    with pytest.raises(ValueError, match="exp_words"):
        SE.split_logits(u, ops, 4, 0)
    with pytest.raises(ValueError, match="sc_words"):
        SE.split_logits_plain(u, ops, 0, 3)
    with pytest.raises(ValueError, match="must divide"):
        GE.group_layout(port["estep"], 3)
    calls = GE.group_layout(port["estep"], 4)
    with pytest.raises(ValueError, match="n_words"):
        GE.group_logits(FE.fold_calls(port["gprob"], calls), calls, 3)
    with pytest.raises(ValueError, match="one entry per row"):
        FE.folded_logits(u[1:], ops)


@pytest.mark.parametrize("module, only", [(EV, None), (FE, "folded"), (SE, "split"), (GE, "group")])
def test_entry_points_on_the_cpu(module, only, capsys):
    """Each module's main at a small size on the CPU (the plain versions), and without a card for cuda."""
    args = ["--device", "cpu", "--n-barcodes", "150", "--n-donors", "5", "--n-snps", "300",
            "--calls-per-barcode", "12", "--repeats", "1"]
    assert module.main(args) == 0
    result = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert result["device"] == "cpu" and result["n_calls"] == 1800 and result["n_pg"] == 15
    names = {"folded": {"folded"}, "split": {f"split_{e}{s}" for e, s in SE.HARNESS_PAIRS},
             "group": {f"group_G{g}" for g in GE.HARNESS_GROUPS}}
    expected = set().union(*names.values()) if only is None else names[only]
    assert set(result["checks"]) == expected
    assert {"estep_fused", "estep_logits"} | expected <= set(result["ms"])
    for name in expected & set(EV.HELD_TO_POSTERIOR_BAR):
        assert result["checks"][name]["posterior_max_abs_err"] <= EV.POSTERIOR_ATOL
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            module.main(["--n-barcodes", "10"])
