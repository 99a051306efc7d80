"""The port's kernel modules against the JAX Pallas kernels (interpret mode).

On the CPU each kernel wrapper runs its plain PyTorch version; that is
compared with the TPU kernel it replaces, run by JAX in interpret mode as
tests/test_pallas_kernel.py runs it (logits rtol=1e-4, atol=5e-3 as the
Pallas kernel is held to the oracle; posteriors atol=3e-5, the bar the
TPU kernel met against full f32; additions rtol=1e-4, atol=1e-5).
The CUDA kernels against the plain versions on a card are in
tests/test_torch_gpu.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from demuxalot_tpu.ops import likelihood as JL
from demuxalot_tpu.ops.pallas_likelihood import TiledDeviceCalls, barcode_logits_tiled, tiled_logits_impl
from demuxalot_tpu.ops.pallas_mstep import TiledMstepCalls
from demuxalot_tpu.ops.tiling import tile_barcode_calls
from demuxalot_tpu_torch.ops import likelihood as TL
from demuxalot_tpu_torch.ops.likelihood_kernel import estep_logits, estep_logits_plain
from demuxalot_tpu_torch.ops.mstep_kernel import mstep_addition, mstep_addition_plain
from oracle import oracle_barcode_logits, oracle_mstep
from torch_problems import estep_args, estep_problem, mstep_operands, mstep_problem, t

torch.set_num_threads(1)


def _pallas_logits(problem):
    gprob, vid, cb, q, n_barcodes, n_donors, doublet_prior = problem
    names = [f"Donor{i:02}" for i in range(n_donors)]
    mixing, _ = JL.pseudogenotype_mixing(names, doublet_prior)
    penalties = JL.doublet_penalties(n_donors, doublet_prior)
    tiled = tile_barcode_calls(cb, vid, q, n_barcodes, tile_barcodes=16, chunk_calls=128)
    return np.asarray(barcode_logits_tiled(jnp.asarray(gprob), mixing, penalties, tiled, interpret=True))


def _pallas_fused(problem):
    """(logits, probs) of the TPU kernel with its in-kernel softmax (softmax_out=True), interpret mode,
    called as tests/test_pallas_kernel.py calls it."""
    gprob, vid, cb, q, n_barcodes, n_donors, doublet_prior = problem
    mixing, _ = JL.pseudogenotype_mixing([f"Donor{i:02}" for i in range(n_donors)], doublet_prior)
    penalties = JL.doublet_penalties(n_donors, doublet_prior)
    tiled = tile_barcode_calls(cb, vid, q, n_barcodes, tile_barcodes=16, chunk_calls=128)
    dev = TiledDeviceCalls(mixing, penalties, tiled)
    n_pg = mixing.shape[1]
    logits, probs = tiled_logits_impl(
        jnp.asarray(gprob), dev.mixing_sl, dev.penalties_p, dev.vid, dev.seg_group, dev.q, dev.chunk_bounds,
        dev.chunk_suboff, n_super=dev.n_super, tbs=dev.tbs, tb=dev.tile_barcodes, tc=dev.chunk_calls,
        band_specs=dev.band_specs, interpret=True, softmax_out=True, n_pseudogenotypes=n_pg,
    )
    return np.asarray(logits)[:n_barcodes, :n_pg], np.asarray(probs)[:n_barcodes, :n_pg]


def _assert_fused_matches(logits, probs, want_logits, want_probs):
    """Logits at the oracle tolerance, posteriors at the TPU kernel's 3e-5 bar, rows summing to 1."""
    np.testing.assert_allclose(logits, want_logits, rtol=1e-4, atol=5e-3)
    np.testing.assert_allclose(probs, want_probs, rtol=0, atol=3e-5)
    np.testing.assert_allclose(probs.sum(axis=1), 1.0, rtol=0, atol=1e-5)


@pytest.mark.parametrize("n_donors", [2, 8])
@pytest.mark.parametrize("doublet_prior", [0.0, 0.35])
def test_estep_matches_pallas_kernel(n_donors, doublet_prior):
    problem = estep_problem(n_donors=n_donors, doublet_prior=doublet_prior)
    launches = estep_logits.launches
    ours = estep_logits(*estep_args(problem)).numpy()
    assert estep_logits.launches == launches  # CPU tensors: plain version, no launch
    want = _pallas_logits(problem)
    assert ours.shape == want.shape
    np.testing.assert_allclose(ours, want, rtol=1e-4, atol=5e-3)
    gprob, vid, cb, q, n_barcodes, _, _ = problem
    names = [f"Donor{i:02}" for i in range(n_donors)]
    ref, _ = oracle_barcode_logits(names, gprob, vid, cb, q, n_barcodes, doublet_prior)
    np.testing.assert_allclose(ours, ref, rtol=1e-4, atol=5e-3)


def test_estep_empty_barcodes_get_penalties():
    problem = estep_problem(n_calls=50, n_barcodes=200)
    args = estep_args(problem)
    ours = estep_logits(*args).numpy()
    np.testing.assert_allclose(ours, _pallas_logits(problem), rtol=1e-4, atol=5e-3)
    empty = np.setdiff1d(np.arange(200), problem[2])
    assert len(empty) > 0
    penalties = args[1].penalties.numpy()
    np.testing.assert_array_equal(ours[empty], np.broadcast_to(penalties, (len(empty), len(penalties))))


@pytest.mark.parametrize("n_donors", [2, 8])
@pytest.mark.parametrize("doublet_prior", [0.0, 0.35])
def test_fused_estep_matches_pallas_softmax_out(n_donors, doublet_prior):
    """softmax=True against the TPU kernel's in-kernel softmax: (logits, probs) of one call."""
    problem = estep_problem(n_donors=n_donors, doublet_prior=doublet_prior)
    launches = estep_logits.launches
    logits, probs = estep_logits(*estep_args(problem), softmax=True)
    assert estep_logits.launches == launches  # CPU tensors: plain version, no launch
    assert torch.equal(logits, estep_logits(*estep_args(problem)))
    _assert_fused_matches(logits.numpy(), probs.numpy(), *_pallas_fused(problem))


@pytest.mark.parametrize("n_donors", [2, 8])
@pytest.mark.parametrize("doublet_prior", [0.0, 0.35])
def test_fused_estep_with_prior_logits_matches_pallas(n_donors, doublet_prior):
    """prior_logits are added before the softmax: against the TPU kernel's logits + prior, then softmax."""
    problem = estep_problem(n_donors=n_donors, doublet_prior=doublet_prior)
    gprob, operands = estep_args(problem)
    n_pg = operands.penalties.shape[0]
    prior = np.random.RandomState(5).randn(problem[4], n_pg).astype(np.float32) * 2
    logits, probs = estep_logits(gprob, operands, prior_logits=t(prior), softmax=True)
    want = _pallas_fused(problem)[0] + prior
    want_probs = np.asarray(jax.nn.softmax(jnp.asarray(want), axis=-1))
    _assert_fused_matches(logits.numpy(), probs.numpy(), want, want_probs)
    assert torch.equal(estep_logits(gprob, operands, prior_logits=t(prior)), logits)


def test_fused_estep_empty_barcodes_get_softmax_of_penalties():
    problem = estep_problem(n_calls=50, n_barcodes=200)
    args = estep_args(problem)
    logits, probs = estep_logits(*args, softmax=True)
    _assert_fused_matches(logits.numpy(), probs.numpy(), *_pallas_fused(problem))
    empty = np.setdiff1d(np.arange(200), problem[2])
    assert len(empty) > 0
    penalties = args[1].penalties
    np.testing.assert_array_equal(probs.numpy()[empty],
                                  np.broadcast_to(torch.softmax(penalties, -1).numpy(), (len(empty), len(penalties))))


@pytest.mark.parametrize("bad", ["shape", "dtype", "device"])
def test_estep_wrapper_rejects_bad_prior_logits(bad):
    gprob, operands = estep_args(estep_problem(n_donors=2))
    prior = torch.zeros(operands.n_barcodes, operands.penalties.shape[0])
    prior = {"shape": prior[:, :-1], "dtype": prior.double(), "device": prior.to("meta")}[bad]
    with pytest.raises((TypeError, ValueError)):
        estep_logits(gprob, operands, prior_logits=prior, softmax=True)


@pytest.mark.parametrize("power", [2.0, 1.0])
def test_mstep_matches_pallas_kernel(power):
    post, vid, cb, q, n_variants, n_donors = mstep_problem()
    launches = mstep_addition.launches
    ours = mstep_addition(t(post), mstep_operands(vid, cb, q, n_variants), n_donors, power).numpy()
    assert mstep_addition.launches == launches
    layout = TiledMstepCalls(vid, cb, q, n_variants, tile_variants=64, chunk_calls=128)
    want = np.asarray(layout.addition(jnp.asarray(post), n_genotypes=n_donors,
                                      contribution_power=power, interpret=True))
    np.testing.assert_allclose(ours, want, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(ours, oracle_mstep(post, vid, cb, q, n_variants, n_donors, power),
                               rtol=1e-4, atol=1e-5)


def test_plain_versions_are_the_likelihood_ops():
    """The wrappers' plain versions are ops.likelihood on CSR inputs."""
    problem = estep_problem(n_donors=3)
    gprob, vid, cb, q, n_barcodes, n_donors, doublet_prior = problem
    mixing, _ = TL.pseudogenotype_mixing([str(i) for i in range(n_donors)], doublet_prior)
    penalties = TL.doublet_penalties(n_donors, doublet_prior)
    direct = TL.barcode_logits(t(gprob), t(mixing), t(penalties), t(vid), t(cb), t(q), n_barcodes)
    assert torch.equal(estep_logits_plain(*estep_args(problem)), direct)
    post, vid, cb, q, n_variants, n_donors = mstep_problem()
    direct = TL.genotype_addition_from_posteriors(t(post), t(vid), t(cb), t(q), n_variants, n_donors, 2.0)
    plain = mstep_addition_plain(t(post), mstep_operands(vid, cb, q, n_variants), n_donors, 2.0)
    assert torch.equal(plain, direct)


@pytest.mark.parametrize("bad", ["dtype", "contiguity", "device", "length"])
def test_estep_wrapper_rejects_bad_inputs(bad):
    gprob, operands = estep_args(estep_problem(n_donors=2))
    if bad == "dtype":
        operands = operands._replace(vid=operands.vid.long())
    elif bad == "contiguity":
        gprob = gprob.t().contiguous().t()
    elif bad == "device":
        gprob, operands = gprob.to("meta"), type(operands)(*(a.to("meta") for a in operands))
    else:
        operands = operands._replace(q=operands.q[:-1])
    with pytest.raises((TypeError, ValueError)):
        estep_logits(gprob, operands)


@pytest.mark.parametrize("bad", ["dtype", "n_genotypes", "device"])
def test_mstep_wrapper_rejects_bad_inputs(bad):
    post, vid, cb, q, n_variants, n_donors = mstep_problem(n_calls=500)
    operands = mstep_operands(vid, cb, q, n_variants)
    args = [t(post), operands, n_donors, 2.0]
    if bad == "dtype":
        args[1] = operands._replace(var_ptr=operands.var_ptr.int())
    elif bad == "n_genotypes":
        args[2] = post.shape[1] + 1
    else:
        args[:2] = [args[0].to("meta"), type(operands)(*(a.to("meta") for a in operands))]
    with pytest.raises((TypeError, ValueError)):
        mstep_addition(*args)


def test_build_raises_without_nvcc(tmp_path, monkeypatch):
    from demuxalot_tpu_torch.ops import _cuda

    monkeypatch.setattr(_cuda, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_cuda, "_build", None)
    monkeypatch.setattr(_cuda, "FALLBACK_NVCC", tmp_path / "no-nvcc")
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.delenv("CUDA_PATH", raising=False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _cuda.build()
    assert not (tmp_path / "build").exists()


_FAKE_NVCC = """#!/bin/sh
# records its arguments, writes its -o file, and says what ptxas would
echo "$@" >> "{calls}"
out=""
prev=""
for arg in "$@"; do
    if [ "$prev" = "-o" ]; then out="$arg"; fi
    prev="$arg"
done
case " $* " in *" -c "*) echo "ptxas info    : Used 8 registers for $out";; esac
printf x > "$out"
"""


def test_library_path_is_keyed_by_the_shared_headers(tmp_path, monkeypatch):
    """An edit to a csrc/*.cuh header names a new library, so a stale build is never loaded."""
    from demuxalot_tpu_torch.ops import _cuda

    (tmp_path / "a.cu").write_text('#include "common.cuh"\n')
    (tmp_path / "common.cuh").write_text("// one\n")
    monkeypatch.setattr(_cuda, "CSRC_DIR", tmp_path)
    before = _cuda.library_path()
    (tmp_path / "common.cuh").write_text("// two\n")
    assert _cuda.library_path() != before
    assert [s.name for s in _cuda.sources()] == ["a.cu"]  # headers are not compiled on their own


def test_build_compiles_each_source_then_links(tmp_path, monkeypatch):
    """One nvcc per csrc/*.cu with -c, then one -shared link of the objects into the hashed library name."""
    from demuxalot_tpu_torch.ops import _cuda

    nvcc = tmp_path / "nvcc"
    nvcc.write_text(_FAKE_NVCC.format(calls=tmp_path / "calls.txt"))
    nvcc.chmod(0o755)
    monkeypatch.setattr(_cuda, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_cuda, "_build", None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "cuda"))
    (tmp_path / "cuda" / "bin").mkdir(parents=True)
    nvcc.rename(tmp_path / "cuda" / "bin" / "nvcc")
    result = _cuda.build()
    calls = (tmp_path / "calls.txt").read_text().splitlines()
    sources = _cuda.sources()
    assert len(calls) == len(sources) + 1
    compiled = sorted(call.split(" -c ")[1].split()[0] for call in calls if " -c " in call)
    assert compiled == sorted(str(s) for s in sources)
    assert calls[-1].startswith("-shared -o ") and calls[-1].count(".o") == len(sources)
    assert result.path == _cuda.library_path() and result.path.read_text() == "x"
    assert result.log.count("ptxas info") == len(sources)
    assert [p.name for p in (tmp_path / "build").iterdir()] == [result.path.name]
