"""The CUDA kernels against their plain PyTorch versions on a card.

Marked ``gpu``: each test decides inside its body whether a card exists
and skips without one. This file imports no jax (the machine with the card
has none), so on the card it runs without the suite's conftest:
``python -m pytest -m gpu --noconftest tests/test_torch_gpu.py``.
Tolerances: logits rtol=1e-4, atol=5e-3; posteriors atol=3e-5 (the bar the
TPU kernel met against full f32); additions rtol=1e-4, atol=1e-5. The
engine-level tests (compact output, damping="auto") run the same call
through the kernels and through the plain versions.
"""
import contextlib
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from demuxalot_tpu_torch import BarcodeHandler, Demultiplexer, sim
from demuxalot_tpu_torch.models import demux
from demuxalot_tpu_torch.ops import likelihood_kernel
from demuxalot_tpu_torch.ops.likelihood_kernel import estep_logits, estep_logits_plain
from demuxalot_tpu_torch.ops import likelihood as L
from demuxalot_tpu_torch.ops.mstep_kernel import mstep_addition, mstep_addition_plain, mstep_update, mstep_update_plain
from oracle import oracle_barcode_logits
from torch_problems import (estep_args, estep_problem, in_order_addition, mstep_operands, mstep_problem, offset_view,
                            side_stream_and_replay, t, update_problem)


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.gpu
@pytest.mark.parametrize("n_donors", [1, 2, 32, 65])
@pytest.mark.parametrize("doublet_prior", [0.0, 0.35])
def test_gpu_estep_kernel_matches_plain(n_donors, doublet_prior):
    _need_card()
    args = estep_args(estep_problem(n_donors=n_donors, doublet_prior=doublet_prior), "cuda")
    launches = estep_logits.launches
    got = estep_logits(*args)
    assert estep_logits.launches == launches + 1
    want = estep_logits_plain(*args)
    torch.cuda.synchronize()
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), rtol=1e-4, atol=5e-3)
    np.testing.assert_allclose(torch.softmax(got, -1).cpu().numpy(),
                               torch.softmax(want, -1).cpu().numpy(), atol=3e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("n_donors", [32, 65])
def test_gpu_estep_kernel_across_tiles(n_donors):
    """Barcodes of ~375 calls each span several staged tiles (32 calls each).

    Over that many calls the plain version's own f32 sums drift from float64
    by about the posterior bar, so the kernel is held to the float64 oracle
    at both bars and to the plain version at the logits bar.
    """
    _need_card()
    problem = estep_problem(n_donors=n_donors, n_barcodes=16, n_calls=6000)
    gprob, vid, cb, q, n_barcodes, _, prior = problem
    args = estep_args(problem, "cuda")
    got = estep_logits(*args)
    want = estep_logits_plain(*args)
    torch.cuda.synchronize()
    ref, _ = oracle_barcode_logits([f"D{i}" for i in range(n_donors)], gprob, vid, cb, q, n_barcodes, prior)
    got = got.cpu().numpy()
    np.testing.assert_allclose(got, want.cpu().numpy(), rtol=1e-4, atol=5e-3)
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=5e-3)
    softmax = lambda x: torch.softmax(torch.from_numpy(x).double(), -1).numpy()
    np.testing.assert_allclose(softmax(got), softmax(ref), atol=3e-5)


@pytest.mark.gpu
def test_gpu_estep_padding_is_bit_exact():
    """Padding calls after the last barcode's calls change no bit of the logits nor of the fused probs."""
    _need_card()
    gprob, vid, cb, q, n_barcodes, n_donors, prior = estep_problem(n_donors=32)
    args = estep_args((gprob, vid, cb, q, n_barcodes, n_donors, prior), "cuda")
    base = estep_logits(*args)
    pad = 777
    padded = (gprob, np.concatenate([vid, np.zeros(pad, np.int32)]),
              np.concatenate([cb, np.full(pad, cb[-1], np.int32)]),
              np.concatenate([q, np.ones(pad, np.float32)]), n_barcodes, n_donors, prior)
    padded_args = estep_args(padded, "cuda")
    assert torch.equal(base, estep_logits(*padded_args))
    for got, want in zip(estep_logits(*padded_args, softmax=True), estep_logits(*args, softmax=True)):
        assert torch.equal(got, want)


@contextlib.contextmanager
def _log(fast: bool):
    """The kernel's log fold on the MUFU unit (fast) or through logf."""
    saved = likelihood_kernel.FAST_LOG
    likelihood_kernel.FAST_LOG = fast
    try:
        yield
    finally:
        likelihood_kernel.FAST_LOG = saved


@pytest.mark.gpu
@pytest.mark.parametrize("fast_log", [True, False])
@pytest.mark.parametrize("n_donors", [1, 2, 32, 33, 65])
@pytest.mark.parametrize("doublet_prior", [0.0, 0.35])
def test_gpu_fused_estep_matches_plain(n_donors, doublet_prior, fast_log):
    """softmax=True: one launch; logits as the logits-only call's bits, posteriors at 3e-5 from the plain
    version's logits + torch.softmax."""
    _need_card()
    args = estep_args(estep_problem(n_donors=n_donors, doublet_prior=doublet_prior), "cuda")
    with _log(fast_log):
        launches = estep_logits.launches
        logits, probs = estep_logits(*args, softmax=True)
        assert estep_logits.launches == launches + 1
        assert torch.equal(logits, estep_logits(*args))
    want_logits, want_probs = estep_logits_plain(*args, softmax=True)
    torch.cuda.synchronize()
    np.testing.assert_allclose(logits.cpu().numpy(), want_logits.cpu().numpy(), rtol=1e-4, atol=5e-3)
    np.testing.assert_allclose(probs.cpu().numpy(), want_probs.cpu().numpy(), atol=3e-5)
    assert float((probs.sum(dim=1) - 1).abs().max()) <= 1e-5


@pytest.mark.gpu
@pytest.mark.parametrize("fast_log", [True, False])
@pytest.mark.parametrize("n_donors", [32, 65])
def test_gpu_fused_estep_across_tiles_matches_oracle(n_donors, fast_log):
    """Barcodes of ~375 calls span twelve 32-call tiles: held to the float64 oracle at both bars."""
    _need_card()
    problem = estep_problem(n_donors=n_donors, n_barcodes=16, n_calls=6000)
    gprob, vid, cb, q, n_barcodes, _, prior = problem
    with _log(fast_log):
        logits, probs = estep_logits(*estep_args(problem, "cuda"), softmax=True)
    torch.cuda.synchronize()
    ref, _ = oracle_barcode_logits([f"D{i}" for i in range(n_donors)], gprob, vid, cb, q, n_barcodes, prior)
    np.testing.assert_allclose(logits.cpu().numpy(), ref, rtol=1e-4, atol=5e-3)
    np.testing.assert_allclose(probs.cpu().numpy(), torch.softmax(torch.from_numpy(ref), -1).numpy(), atol=3e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("n_donors", [2, 32])
def test_gpu_fused_estep_with_prior_logits(n_donors):
    """prior_logits enter before the softmax: the logits are the plain logits + prior at the bars, and the
    kernel's own logits-only call + prior bit for bit."""
    _need_card()
    args = estep_args(estep_problem(n_donors=n_donors), "cuda")
    n_pg = args[1].penalties.shape[0]
    prior = torch.from_numpy(np.random.RandomState(2).randn(args[1].n_barcodes, n_pg).astype(np.float32)).cuda()
    logits, probs = estep_logits(*args, prior_logits=prior, softmax=True)
    assert torch.equal(logits, estep_logits(*args) + prior)
    want_logits, want_probs = estep_logits_plain(*args, prior_logits=prior, softmax=True)
    np.testing.assert_allclose(logits.cpu().numpy(), want_logits.cpu().numpy(), rtol=1e-4, atol=5e-3)
    np.testing.assert_allclose(probs.cpu().numpy(), want_probs.cpu().numpy(), atol=3e-5)


@pytest.mark.gpu
def test_gpu_fused_estep_runs_are_bit_equal():
    """Each barcode's columns are one warp's in-order sums: two runs give the same bits."""
    _need_card()
    args = estep_args(estep_problem(n_donors=32, n_barcodes=400, n_calls=30000), "cuda")
    first = estep_logits(*args, softmax=True)
    second = estep_logits(*args, softmax=True)
    assert all(torch.equal(a, b) for a, b in zip(first, second))


@pytest.mark.gpu
@pytest.mark.parametrize("n_donors", [1, 32, 65])
@pytest.mark.parametrize("power", [1.0, 2.0, 0.5])
def test_gpu_mstep_kernel_matches_plain(n_donors, power):
    _need_card()
    post, vid, cb, q, n_variants, n_donors = mstep_problem(n_donors=n_donors)
    q[::53] = 1.0
    args = (t(post, "cuda"), mstep_operands(vid, cb, q, n_variants, len(post), "cuda"), n_donors, power)
    launches = mstep_addition.launches
    got = mstep_addition(*args)
    assert mstep_addition.launches == launches + 1
    want = mstep_addition_plain(*args)
    torch.cuda.synchronize()
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), rtol=1e-4, atol=1e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("n_donors", [1, 32, 65])
@pytest.mark.parametrize("power", [1.0, 2.0, 0.5])
@pytest.mark.parametrize("runs", [(1,), (2,), (6,), (1, 2, 6), (7,)])
def test_gpu_mstep_addition_is_bit_equal_in_order(n_donors, power, runs):
    """Each (variant, donor) sum is one chain in call order: the kernel gives the in-order reference's bits."""
    _need_card()
    p = update_problem(seed=n_donors, n_donors=n_donors, runs=runs)
    operands = mstep_operands(p["vid"], p["cb"], p["q"], p["n_variants"], len(p["post"]), "cuda")
    post = t(p["post"], "cuda")
    got = mstep_addition(post, operands, n_donors, power)
    assert torch.equal(got, in_order_addition(post, operands, n_donors, power))
    assert torch.equal(got, mstep_addition(post, operands, n_donors, power))


@pytest.mark.gpu
@pytest.mark.parametrize("n_donors", [1, 32, 65])
@pytest.mark.parametrize("power", [1.0, 2.0, 0.5])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("runs", [(1,), (2,), (6,), (1, 2, 6)])
def test_gpu_mstep_update_matches_plain(n_donors, power, masked, runs):
    """One launch: the masked addition in order, and probs_from_betas' bits on it."""
    _need_card()
    p = update_problem(seed=n_donors + 7, n_donors=n_donors, runs=runs)
    operands = mstep_operands(p["vid"], p["cb"], p["q"], p["n_variants"], len(p["post"]), "cuda",
                              snp_ptr=p["snp_ptr"])
    mask = t(p["mask"], "cuda") if masked else None
    args = (t(p["post"], "cuda"), operands, t(p["prior"], "cuda"), mask, 0.01, n_donors, power)
    launches = mstep_update.launches
    addition, gprob = mstep_update(*args)
    assert mstep_update.launches == launches + 1
    plain_addition, plain_gprob = mstep_update_plain(*args)
    np.testing.assert_allclose(addition.cpu().numpy(), plain_addition.cpu().numpy(), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(gprob.cpu().numpy(), plain_gprob.cpu().numpy(), rtol=0, atol=1e-6)
    in_order = in_order_addition(args[0], operands, n_donors, power)
    assert torch.equal(addition, in_order if mask is None else in_order * mask)
    betas = args[2] + addition
    assert torch.equal(gprob, L.probs_from_betas(betas, t(p["variant2snp"], "cuda"), p["n_snps"], 0.01,
                                                 p["max_per_snp"]))
    again = mstep_update(*args)
    assert torch.equal(again[0], addition) and torch.equal(again[1], gprob)


_TRAP_SCRIPT = """
import sys
import torch
sys.path[:0] = {paths!r}
from demuxalot_tpu_torch.ops.likelihood_kernel import estep_logits
from torch_problems import estep_args, estep_problem, mstep_operands, mstep_problem, t
if {kernel!r}.startswith("take"):
    from demuxalot_tpu_torch.experiments import gather_forms as GF
    axis = int({kernel!r}[len("take_axis")])
    table = torch.rand(64, 32, device="cuda")
    idx = torch.randint(0, table.shape[axis], (64, 32), dtype=torch.int32, device="cuda")
    idx[40, 7] = table.shape[axis] if axis == 0 else -1  # one past the last row; a negative column
    launch = lambda: GF.take_along_axis(table, idx, axis)
elif {kernel!r} == "variants":
    from demuxalot_tpu_torch.experiments import folded_estep as FE
    gprob, operands = estep_args(estep_problem(n_donors=4), "cuda")
    bad = operands.row_ptr.clone()
    bad[-1] = len(operands.cb) + 1  # a barcode's calls past the last call
    # the operands' constructor checks the CSR once, so no split kernel ever reads through it
    launch = lambda: FE.variant_operands(operands._replace(row_ptr=bad))
elif {kernel!r} == "estep":
    gprob, operands = estep_args(estep_problem(n_donors=4), "cuda")
    bad = operands.vid.clone()
    bad[len(bad) // 2] = gprob.shape[0]  # one past the last variant
    launch = lambda: estep_logits(gprob, operands._replace(vid=bad))
else:
    post, vid, cb, q, n_variants, n_donors = mstep_problem()
    cb[len(cb) // 2] = post.shape[0]  # one past the last barcode
    # the operands' constructor checks cb once, so no M-step kernel ever reads through it
    launch = lambda: mstep_operands(vid, cb, q, n_variants, len(post), "cuda")
try:
    launch()
    torch.cuda.synchronize()
except Exception as error:
    print(type(error).__name__, error)
    sys.exit(3)
"""


@pytest.mark.gpu
@pytest.mark.parametrize("kernel", ["estep", "mstep", "variants", "take_axis0", "take_axis1"])
def test_gpu_out_of_range_index_traps(kernel):
    """An index past its table traps in checks.cu before the main kernel reads it: the E-step's at each
    launch, the M-step's and the split and group E-steps' when their operands are built. take_along_axis
    tests each index inside its gather and traps there.

    A trap ends the process's CUDA context, so the launch runs in a child process.
    """
    _need_card()
    tests = Path(__file__).resolve().parent
    script = _TRAP_SCRIPT.format(paths=[str(tests.parent), str(tests)], kernel=kernel)
    proc = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True, timeout=600)
    assert proc.returncode == 3, proc.stdout + proc.stderr


@contextlib.contextmanager
def _plain_versions():
    """Point the engine at the kernels' plain versions."""
    saved = demux.estep_logits, demux.mstep_addition, demux.mstep_update
    demux.estep_logits, demux.mstep_addition, demux.mstep_update = (estep_logits_plain, mstep_addition_plain,
                                                                    mstep_update_plain)
    try:
        yield
    finally:
        demux.estep_logits, demux.mstep_addition, demux.mstep_update = saved


@pytest.fixture
def engine_problem(monkeypatch):
    """Synthetic calls with doublets (6 donors, 400 barcodes) on the card's engine."""
    monkeypatch.setattr(Demultiplexer, "device", "cuda")
    genotypes, calls, _truth, _names = sim.synthesize_compressed_calls(400, 6, 600, 30, seed=1)
    handler = BarcodeHandler([f"BC{b:04d}" for b in range(400)])
    return Demultiplexer.pack_dataset(calls, genotypes), genotypes, handler


@pytest.mark.gpu
def test_gpu_compact_matches_plain(engine_problem):
    _need_card()
    packed, genotypes, handler = engine_problem
    launches = estep_logits.launches
    compact = Demultiplexer.predict_posteriors_compact(packed, genotypes, handler, k=4, include_logits=True)
    assert estep_logits.launches == launches + 1
    with _plain_versions():
        plain = Demultiplexer.predict_posteriors_compact(packed, genotypes, handler, k=4, include_logits=True)
    np.testing.assert_array_equal(compact.assignment, plain.assignment)
    np.testing.assert_allclose(compact.top_logits, plain.top_logits, rtol=1e-4, atol=5e-3)
    np.testing.assert_allclose(compact.logsumexp, plain.logsumexp, rtol=1e-4, atol=5e-3)
    np.testing.assert_allclose(compact.top_probs, plain.top_probs, atol=3e-5)
    assert compact.logits_bf16.dtype == torch.bfloat16 and compact.logits_bf16.device.type == "cpu"
    # the compact result is the card's full frame, reduced on the card
    logits, _probs, _names = Demultiplexer.predict_posteriors_core(packed, genotypes, handler)
    full = logits.cpu().numpy()
    np.testing.assert_array_equal(compact.assignment, full.argmax(axis=1))
    np.testing.assert_array_equal(compact.top_logits, np.take_along_axis(full, compact.top_index, axis=1))
    np.testing.assert_array_equal(compact.logits_bf16.float().numpy(), logits.to(torch.bfloat16).float().cpu().numpy())


@pytest.mark.gpu
@pytest.mark.parametrize("erased", [0.0, 0.95])
def test_gpu_auto_damping_matches_plain(engine_problem, erased):
    """damping="auto" on the card against the same call through the plain versions.

    The anchored disagreement counts barcodes, so a barcode whose singlet
    argmax is a tie, or whose confidence sits at the threshold, within the
    posterior bar may count differently on the two paths (the plain
    version's atomic sums break exact ties either way). Over every other
    barcode the disagreement must be the same number.
    """
    _need_card()
    packed, genotypes, handler = engine_problem
    degraded = genotypes.clone()
    snp_ids = degraded.get_snp_ids_for_variants()
    mask = np.random.RandomState(5).random_sample(snp_ids.max() + 1) < erased
    degraded.variant_betas[np.nonzero(mask[snp_ids])[0], :] = 0
    learn = lambda damping: Demultiplexer.learn_genotypes_core(packed, degraded, handler, n_iterations=2,
                                                               doublet_prior=0.35, damping=damping)
    launches = estep_logits.launches, mstep_addition.launches, mstep_update.launches
    result = learn("auto")
    # every M-step is one fused launch (the data's SNP runs are short)
    assert (estep_logits.launches - launches[0], mstep_addition.launches - launches[1],
            mstep_update.launches - launches[2]) == (4, 0, 2)
    runs = {"kernel": [learn(damping).state.probs for damping in (None, "anchor")]}
    with _plain_versions():
        plain = learn("auto")
        runs["plain"] = [learn(damping).state.probs for damping in (None, "anchor")]
    assert result.damping_selected == plain.damping_selected
    np.testing.assert_allclose(result.state.probs.cpu().numpy(), plain.state.probs.cpu().numpy(), atol=3e-5)
    np.testing.assert_allclose(result.genotypes.get_betas(), plain.genotypes.get_betas(), rtol=1e-4, atol=1e-2)

    n_genotypes = genotypes.n_genotypes
    # the kernel path is deterministic: these are the two runs "auto" compared
    assert demux.auto_damping_select(*runs["kernel"], n_genotypes) == (
        result.damping_selected, result.anchored_disagreement)
    near = torch.zeros(handler.n_barcodes, dtype=torch.bool, device=result.state.probs.device)
    for probs in runs["plain"]:
        top2 = probs[:, :n_genotypes].topk(2, dim=1).values
        near |= top2[:, 0] - top2[:, 1] <= 2 * 3e-5
    confidence = runs["plain"][0][:, :n_genotypes].max(dim=1).values
    near |= (confidence - Demultiplexer.auto_damping_confidence).abs() <= 3e-5
    keep = ~near
    assert demux.auto_damping_select(*(p[keep] for p in runs["kernel"]), n_genotypes) == \
        demux.auto_damping_select(*(p[keep] for p in runs["plain"]), n_genotypes)


@pytest.mark.gpu
def test_gpu_aggregate_em_matches_plain(engine_problem, monkeypatch):
    """aggregate_on_snps on the card: the E-step is torch ops, every M-step the fused kernel."""
    _need_card()
    packed, genotypes, handler = engine_problem
    monkeypatch.setattr(Demultiplexer, "aggregate_on_snps", True)
    learn = lambda: Demultiplexer.learn_genotypes_core(packed, genotypes, handler, n_iterations=3, doublet_prior=0.35)
    launches = estep_logits.launches, mstep_addition.launches, mstep_update.launches
    result = learn()
    assert (estep_logits.launches - launches[0], mstep_addition.launches - launches[1],
            mstep_update.launches - launches[2]) == (0, 0, 2)
    with _plain_versions():
        plain = learn()
    np.testing.assert_allclose(result.state.probs.cpu().numpy(), plain.state.probs.cpu().numpy(), atol=3e-5)
    np.testing.assert_allclose(result.state.logits.cpu().numpy(), plain.state.logits.cpu().numpy(),
                               rtol=1e-4, atol=5e-3)
    np.testing.assert_allclose(result.genotypes.get_betas(), plain.genotypes.get_betas(), rtol=1e-4, atol=1e-2)
    # the same run on the CPU: one path, two devices
    monkeypatch.setattr(Demultiplexer, "device", "cpu")
    cpu = learn()
    np.testing.assert_allclose(result.state.probs.cpu().numpy(), cpu.state.probs.numpy(), atol=3e-5)
    assert bool((result.state.probs.sum(dim=1) - 1).abs().max() <= 1e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("doublet_prior", [0.0, 0.35])
def test_gpu_aggregated_logits_are_deterministic(engine_problem, doublet_prior):
    """The aggregate E-step gives the same bits on every call, zeros for barcodes without calls,
    and the CPU's values within the logits bar."""
    _need_card()
    from dataclasses import replace

    from demuxalot_tpu_torch.ops import likelihood as L

    packed, genotypes, handler = engine_problem
    calls = packed.molecule_calls
    keep = calls.compressed_cb % 5 != 2  # every fifth barcode loses its calls
    fields = ("variant_id", "snp_id", "compressed_cb", "molecule_id", "p_base_wrong", "p_molecule_aligned_wrong")
    kept = replace(calls, **{field: getattr(calls, field)[keep] for field in fields})
    rng = np.random.RandomState(0)
    gprob = rng.uniform(0.01, 0.99, (packed.n_variants, genotypes.n_genotypes)).astype(np.float32)
    mixing, _ = L.pseudogenotype_mixing(list(genotypes.genotype_names), doublet_prior)
    logits = {}
    for device in ("cuda", "cpu"):
        layout = demux._SnpAggregationLayout.build(kept, torch.device(device))
        run = lambda: layout.logits(t(gprob, device), t(mixing, device), handler.n_barcodes)  # noqa: E731
        logits[device] = run()
        assert torch.equal(logits[device], run())
    got = logits["cuda"].cpu().numpy()
    empty = np.arange(handler.n_barcodes) % 5 == 2
    assert (got[empty] == 0).all() and (got[~empty] != 0).any(axis=1).all()
    np.testing.assert_allclose(got, logits["cpu"].numpy(), rtol=1e-4, atol=5e-3)


@pytest.fixture(scope="module")
def discovery_bam(tmp_path_factory):
    """The port's synthetic BAM of the discovery tests (4 donors, chr2's variants hidden)."""
    from demuxalot_tpu_torch import ProbabilisticGenotypes

    _need_card()
    filename = str(tmp_path_factory.mktemp("bam") / "d.bam")
    filename, genotypes, _ids, names = sim.generate_bam_file(
        filename, n_genotypes=4, doublets_fraction=0.1, mutation_prob=0.03, n_barcodes=300,
        n_reads_per_barcode=80, chromosome2length={"chr1": 800, "chr2": 800}, rng=5,
    )
    known = ProbabilisticGenotypes(genotypes.genotype_names)
    for (chrom, pos, base), vid in genotypes.var2varid.items():
        if chrom == "chr1":
            row = known.get_variant_id(chrom, pos, base)  # registers the row before the view is taken
            known.variant_betas[row] = genotypes.variant_betas[vid]
    return filename, known, BarcodeHandler(list(names))


@pytest.mark.gpu
def test_gpu_native_coverage_equals_python(discovery_bam):
    """The C++ pileup, built on the card's host, against the Python pileup."""
    _need_card()
    from demuxalot_tpu_torch.bamio import BamReader
    from demuxalot_tpu_torch.frontend import cellranger
    from demuxalot_tpu_torch.frontend.native_counter import try_count_coverage_native

    filename = discovery_bam[0]
    for chromosome, start, stop in (("chr1", 0, 800), ("chr2", 123, 654)):
        native = try_count_coverage_native(filename, chromosome, start, stop, cellranger.parse_read, required=True)
        with BamReader(filename) as reader:
            python = reader.count_coverage(chromosome, start, stop,
                                           read_callback=lambda read: cellranger.parse_read(read) is not None)
        for ours, theirs in zip(native, python):
            np.testing.assert_array_equal(ours, theirs)


@pytest.mark.gpu
def test_gpu_detect_snps_runs_the_estep_kernel(discovery_bam, monkeypatch):
    """Discovery on the card: the provisional predict launches the E-step kernel once."""
    _need_card()
    from demuxalot_tpu_torch import detect_snps_positions

    filename, known, handler = discovery_bam
    kwargs = dict(minimum_coverage=50, minimum_alternative_coverage=10, joblib_n_jobs=2, joblib_verbosity=0)
    monkeypatch.setattr(Demultiplexer, "device", "cuda")
    launches = estep_logits.launches
    selected = detect_snps_positions(filename, known, handler, **kwargs)
    assert estep_logits.launches == launches + 1
    assert "chr2" in {chrom for chrom, *_ in selected}
    monkeypatch.setattr(Demultiplexer, "device", "cpu")
    on_cpu = detect_snps_positions(filename, known, handler, **kwargs)
    assert [(c, p, list(b)) for c, p, _s, b in selected] == [(c, p, list(b)) for c, p, _s, b in on_cpu]


@pytest.mark.gpu
@pytest.mark.parametrize("extra_barcodes", [0, 200])
def test_gpu_sharded_matches_single_device(engine_problem, extra_barcodes):
    """4 shards on cuda:0: the first E-step and the predict bit-equal, EM within 3e-5, runs repeatable.

    With 200 whitelisted barcodes that have no reads, shard 3 holds no call
    at all: its kernels get an empty CSR and give the penalties.
    """
    _need_card()
    from demuxalot_tpu_torch.parallel import ShardedDemultiplexer, make_mesh

    packed, genotypes, handler = engine_problem
    if extra_barcodes:
        handler = BarcodeHandler(list(handler.ordered_barcodes) + [f"ZZZ{i:04d}" for i in range(extra_barcodes)])
    sharded = ShardedDemultiplexer(make_mesh(["cuda:0"] * 4))
    launches = estep_logits.launches, mstep_addition.launches
    (_, first), = sharded.staged_genotype_learning(packed, genotypes, handler, n_iterations=1, doublet_prior=0.35)
    (_, single_first), = Demultiplexer.staged_genotype_learning(packed, genotypes, handler, n_iterations=1,
                                                                doublet_prior=0.35)
    assert (estep_logits.launches - launches[0], mstep_addition.launches - launches[1]) == (4 + 1, 0)
    np.testing.assert_array_equal(first["barcode_logits"], single_first["barcode_logits"])

    learn = lambda engine: engine.learn_genotypes(packed, genotypes, handler, n_iterations=3, doublet_prior=0.35)
    launches = estep_logits.launches, mstep_addition.launches
    learnt, probs = learn(sharded)
    assert (estep_logits.launches - launches[0], mstep_addition.launches - launches[1]) == (4 * 3, 4 * 2)
    single_learnt, single_probs = learn(Demultiplexer)
    np.testing.assert_allclose(probs.values, single_probs.values, atol=3e-5)
    np.testing.assert_allclose(learnt.get_betas(), single_learnt.get_betas(), rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(probs.values.argmax(1), single_probs.values.argmax(1))
    again_learnt, again_probs = learn(sharded)
    np.testing.assert_array_equal(again_probs.values, probs.values)
    np.testing.assert_array_equal(again_learnt.get_betas(), learnt.get_betas())

    logits, _ = sharded.predict_posteriors(packed, learnt, handler, doublet_prior=0.35)
    single_logits, _ = Demultiplexer.predict_posteriors(packed, learnt, handler, doublet_prior=0.35)
    np.testing.assert_array_equal(logits.values, single_logits.values)
    if extra_barcodes:
        penalties = demux.L.doublet_penalties(genotypes.n_genotypes, 0.35)
        np.testing.assert_array_equal(logits.values[400:], np.broadcast_to(penalties, (extra_barcodes, len(penalties))))


# ---------------------------------------------------------------------------
# F1: probs_from_betas' general branch sums each SNP in order
# ---------------------------------------------------------------------------

@pytest.mark.gpu
def test_gpu_compute_probs_from_betas_is_deterministic(monkeypatch):
    """A shuffled variant2snp takes the segment-sum branch: two calls on the card give the same bits."""
    _need_card()
    from oracle import oracle_probs_from_betas

    monkeypatch.setattr(Demultiplexer, "device", "cuda")
    rng = np.random.RandomState(4)
    variant2snp = np.repeat(np.arange(0, 60_000, 3), rng.randint(1, 6, 20_000)).astype(np.int32)
    variant2snp = variant2snp[rng.permutation(len(variant2snp))]
    betas = (rng.rand(len(variant2snp), 32) * 50).astype(np.float32)
    first = Demultiplexer._compute_probs_from_betas(variant2snp, betas, 0.01)
    np.testing.assert_array_equal(first, Demultiplexer._compute_probs_from_betas(variant2snp, betas, 0.01))
    np.testing.assert_allclose(first, oracle_probs_from_betas(variant2snp, betas, 0.01), rtol=0, atol=1e-6)


# ---------------------------------------------------------------------------
# the experiments' kernels: banded E-step and M-step, row gather, gather-sum
# ---------------------------------------------------------------------------

def _banded_estep_args(n_donors, n_bands, device="cuda", n_barcodes=100, n_calls=6000, pad=0):
    from demuxalot_tpu_torch.experiments.inkernel_gather import banded_estep_operands

    gprob, vid, cb, q, n_barcodes, n_donors, prior = estep_problem(n_donors=n_donors, n_barcodes=n_barcodes,
                                                                   n_calls=n_calls)
    if pad:  # padding calls (q = 1) after each barcode's real calls
        rng = np.random.RandomState(9)
        vid = np.concatenate([vid, rng.randint(0, gprob.shape[0], pad).astype(np.int32)])
        cb = np.concatenate([cb, rng.randint(0, n_barcodes, pad).astype(np.int32)])
        q = np.concatenate([q, np.ones(pad, np.float32)])
        order = np.argsort(cb, kind="stable")
        vid, cb, q = vid[order], cb[order], q[order]
    operands = banded_estep_operands(n_donors, prior, t(cb, device), t(vid, device), t(q, device), n_barcodes,
                                     gprob.shape[0], n_bands)
    return t(gprob, device), operands


@pytest.mark.gpu
@pytest.mark.parametrize("n_bands", [1, 12, 300])
@pytest.mark.parametrize("n_donors", [2, 7, 32, 64])
def test_gpu_estep_banded_matches_plain(n_donors, n_bands):
    """One band, 12 bands, and 300 bands over 200 variants (empty bands; most barcodes lack calls in most bands)."""
    _need_card()
    from demuxalot_tpu_torch.experiments.inkernel_gather import estep_logits_banded, estep_logits_banded_plain

    args = _banded_estep_args(n_donors, n_bands)
    launches = estep_logits_banded.launches
    got = estep_logits_banded(*args)
    assert estep_logits_banded.launches == launches + 1
    want = estep_logits_banded_plain(*args)
    torch.cuda.synchronize()
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), rtol=1e-4, atol=5e-3)
    assert torch.equal(got.argmax(1), want.argmax(1))
    assert torch.equal(got, estep_logits_banded(*args))


@pytest.mark.gpu
def test_gpu_estep_banded_padding_is_bit_exact():
    _need_card()
    from demuxalot_tpu_torch.experiments.inkernel_gather import estep_logits_banded

    assert torch.equal(estep_logits_banded(*_banded_estep_args(32, 12)),
                       estep_logits_banded(*_banded_estep_args(32, 12, pad=999)))


@pytest.mark.gpu
@pytest.mark.parametrize("power", [1.0, 2.0])
@pytest.mark.parametrize("n_bands", [2, 40])
@pytest.mark.parametrize("n_donors", [1, 7, 32, 65])
def test_gpu_mstep_banded_matches_plain(n_donors, n_bands, power):
    """Two bands and 40 bands of 150 barcodes; every odd variant has no call, q = 1 calls add exactly 0."""
    _need_card()
    from demuxalot_tpu_torch.experiments.inkernel_gather import (
        banded_mstep_operands, mstep_addition_banded, mstep_addition_banded_plain,
    )

    post, vid, cb, q, n_variants, n_donors = mstep_problem(n_donors=n_donors)
    vid = vid // 2 * 2
    q[::53] = 1.0
    operands = banded_mstep_operands(t(vid, "cuda"), t(cb, "cuda"), t(q, "cuda"), n_variants, post.shape[0], n_bands)
    args = (t(post, "cuda"), operands, n_donors, power)
    launches = mstep_addition_banded.launches
    got = mstep_addition_banded(*args)
    assert mstep_addition_banded.launches == launches + 1
    want = mstep_addition_banded_plain(*args)
    torch.cuda.synchronize()
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), rtol=1e-4, atol=1e-5)
    assert not got[1::2].any()
    assert torch.equal(got, mstep_addition_banded(*args))


@pytest.mark.gpu
def test_gpu_mstep_banded_band_past_shared_memory_raises():
    """Two bands of 35,000 barcodes x 32 donors (4.5 MB each) cannot sit in a block's shared memory."""
    _need_card()
    from demuxalot_tpu_torch.experiments.inkernel_gather import banded_mstep_operands, mstep_addition_banded

    post, vid, cb, q, n_variants, _ = mstep_problem(n_donors=32, n_barcodes=70_000)
    operands = banded_mstep_operands(t(vid, "cuda"), t(cb, "cuda"), t(q, "cuda"), n_variants, 70_000, 2)
    launches = mstep_addition_banded.launches
    with pytest.raises(ValueError, match="shared memory"):
        mstep_addition_banded(t(post, "cuda"), operands, 32, 2.0)
    assert mstep_addition_banded.launches == launches


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(8192, 64), (131_072, 32), (1000, 7)])
def test_gpu_gather_rows_is_bit_equal(shape):
    """16-byte rows (widths 64, 32) and 4-byte ones (width 7)."""
    _need_card()
    from demuxalot_tpu_torch.experiments.kernel_gather import gather_rows, rate_inputs

    table, idx = rate_inputs(*shape, n_idx=100_003, seed=1)
    launches = gather_rows.launches
    got = gather_rows(table, idx)
    assert gather_rows.launches == launches + 1
    assert torch.equal(got, table[idx.long()])


@pytest.mark.gpu
@pytest.mark.parametrize("shape, n_idx, step", [((8192, 64), 1 << 20, 4096), ((1000, 7), 10_001, 4096),
                                                ((131_072, 32), 5000, 1)])
def test_gpu_gather_sum_matches_float64(shape, n_idx, step):
    _need_card()
    from demuxalot_tpu_torch.experiments.kernel_gather import gather_sum, gather_sum_plain, rate_inputs

    table, idx = rate_inputs(*shape, n_idx=n_idx, seed=2)
    got = gather_sum(table, idx, step)
    exact = float(table.double()[idx.long()].sum())
    assert float(got) == pytest.approx(exact, rel=1e-5)
    assert float(gather_sum_plain(table, idx, step)) == pytest.approx(exact, rel=1e-5)
    assert torch.equal(got, gather_sum(table, idx, step))


_BANDED_TRAP_SCRIPT = """
import sys
import torch
sys.path[:0] = {paths!r}
from demuxalot_tpu_torch.experiments import inkernel_gather as IG
from demuxalot_tpu_torch.experiments import kernel_gather as KG
from torch_problems import estep_problem, mstep_problem, t
if {kernel!r} == "estep_banded":
    gprob, vid, cb, q, n_barcodes, n_donors, prior = estep_problem(n_donors=4)
    operands = IG.banded_estep_operands(n_donors, prior, t(cb, "cuda"), t(vid, "cuda"), t(q, "cuda"), n_barcodes,
                                        gprob.shape[0], 4)
    bad = operands.vid.clone()
    bad[len(bad) // 2] = 50  # band 2 of 200 variants holds 50: one past its last
    launch = lambda: IG.estep_logits_banded(t(gprob, "cuda"), operands._replace(vid=bad))
elif {kernel!r} == "mstep_banded":
    post, vid, cb, q, n_variants, n_donors = mstep_problem()
    operands = IG.banded_mstep_operands(t(vid, "cuda"), t(cb, "cuda"), t(q, "cuda"), n_variants, post.shape[0], 3)
    bad = operands.cb.clone()
    bad[len(bad) // 2] = 50  # band 1 of 150 barcodes holds 50: one past its last
    launch = lambda: IG.mstep_addition_banded(t(post, "cuda"), operands._replace(cb=bad), n_donors, 2.0)
else:
    table, idx = KG.rate_inputs(100, 8, 1000)
    idx[500] = 100
    launch = lambda: KG.gather_sum(table, idx)
try:
    launch()
    torch.cuda.synchronize()
except Exception as error:
    print(type(error).__name__, error)
    sys.exit(3)
"""


@pytest.mark.gpu
@pytest.mark.parametrize("kernel", ["estep_banded", "mstep_banded", "gather"])
def test_gpu_banded_out_of_range_index_traps(kernel):
    """A band-local id past its band (or an index past the table) traps in checks.cu, in a child process."""
    _need_card()
    tests = Path(__file__).resolve().parent
    script = _BANDED_TRAP_SCRIPT.format(paths=[str(tests.parent), str(tests)], kernel=kernel)
    proc = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True, timeout=600)
    assert proc.returncode == 3, proc.stdout + proc.stderr


# ---------------------------------------------------------------------------
# the E-step variants: folded, split-word (tensor cores), group-G
# ---------------------------------------------------------------------------

# barcode: calls at the kernels' tile edges (split's 64-call and group's 32-call tiles), on barcodes that
# _variant_problem otherwise leaves empty
VARIANT_EDGE_CALLS = {2: 1, 4: 31, 5: 33, 7: 63, 8: 64, 10: 65, 11: 129}


def _variant_problem(n_donors, pad=0, seed=0):
    """Calls on every third of 60 barcodes, barcode 1 with 1,200 of its own, the tile edges of
    VARIANT_EDGE_CALLS; ``pad`` q = 1 calls after each barcode's real calls."""
    gprob, vid, cb, q, n_barcodes, _, _ = estep_problem(seed=seed, n_donors=n_donors, n_barcodes=60, n_calls=3000)
    rng = np.random.RandomState(seed + 1)
    n_variants = gprob.shape[0]
    extra = np.concatenate([np.ones(1200, np.int32)] + [np.full(n, b, np.int32) for b, n in VARIANT_EDGE_CALLS.items()])
    vid = np.concatenate([vid, rng.randint(0, n_variants, len(extra)).astype(np.int32)])
    q = np.concatenate([q, (rng.rand(len(extra)) * 0.5).astype(np.float32), np.ones(pad, np.float32)])
    # the padding is drawn last, so the real calls are the same with and without it
    vid = np.concatenate([vid, rng.randint(0, n_variants, pad).astype(np.int32)])
    cb = np.concatenate([cb // 3 * 3, extra, rng.randint(0, n_barcodes, pad).astype(np.int32)])
    order = np.argsort(cb, kind="stable")
    return gprob, vid[order], cb[order], q[order], n_barcodes


def _variant_args(n_donors, pad=0, device="cuda"):
    """(genotype_prob, EStepOperands) of :func:`_variant_problem` at doublet prior 0.25 on ``device``."""
    from demuxalot_tpu_torch.ops.likelihood_kernel import estep_operands
    from demuxalot_tpu_torch.ops.packing import csr_row_pointers

    gprob, vid, cb, q, n_barcodes = _variant_problem(n_donors, pad)
    estep = estep_operands(n_donors, 0.25, t(csr_row_pointers(cb, n_barcodes), device), t(cb, device),
                           t(vid, device), t(q, device))
    return t(gprob, device), estep


def _held_to_plain(kernel, plain, *args, argmax=True, **kwargs):
    """One launch of ``kernel``; its logits at the logits bar of ``plain``'s (same arguments), the same argmax,
    two runs bit-equal."""
    launches = kernel.launches
    got = kernel(*args, **kwargs)
    assert kernel.launches == launches + 1
    want = plain(*args, **kwargs)
    torch.cuda.synchronize()
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), rtol=1e-4, atol=5e-3)
    if argmax:
        assert torch.equal(got.argmax(1), want.argmax(1))
    assert torch.equal(got, kernel(*args, **kwargs))


@pytest.mark.gpu
@pytest.mark.parametrize("use_log", [True, False])
@pytest.mark.parametrize("n_donors", [2, 7, 32, 64])
def test_gpu_folded_matches_plain(n_donors, use_log):
    _need_card()
    from demuxalot_tpu_torch.experiments import folded_estep as FE

    gprob, estep = _variant_args(n_donors)
    u, ops = FE.fold_calls(gprob, estep), FE.variant_operands(estep)
    _held_to_plain(FE.folded_logits, FE.folded_logits_plain, u, ops, use_log=use_log, argmax=use_log)


@pytest.mark.gpu
@pytest.mark.parametrize("sc_words", [0, 1, 2])
@pytest.mark.parametrize("exp_words", [0, 1, 2, 3])
@pytest.mark.parametrize("n_donors", [2, 7, 32, 48, 64])
def test_gpu_split_matches_plain(n_donors, exp_words, sc_words):
    """64 donors give 2,080 columns (33 column tiles of 64, in several column ranges), 48 donors pad the
    donor axis to 64 and 7 pad the MMA's K; barcodes of 1,200 calls and at the 64-call tile's edges."""
    _need_card()
    from demuxalot_tpu_torch.experiments import folded_estep as FE
    from demuxalot_tpu_torch.experiments import split_estep as SE

    gprob, estep = _variant_args(n_donors)
    u, ops = FE.fold_calls(gprob, estep), FE.variant_operands(estep)
    _held_to_plain(SE.split_logits, SE.split_logits_plain, u, ops, exp_words, sc_words)


@pytest.mark.gpu
@pytest.mark.parametrize("n_words", [0, 1, 2])
@pytest.mark.parametrize("group", [1, 4, 8, 16])
@pytest.mark.parametrize("n_donors", [2, 7, 32, 64])
def test_gpu_group_matches_plain(n_donors, group, n_words):
    """G 1, 4 and 8 take a log per group, 16 the sum of four logs of 4 calls per group; barcodes of
    1,200 calls and at the 32-call tile's edges; 64 donors walk the calls in several schedule passes."""
    _need_card()
    from demuxalot_tpu_torch.experiments import folded_estep as FE
    from demuxalot_tpu_torch.experiments import group_estep as GE

    gprob, estep = _variant_args(n_donors)
    calls = GE.group_layout(estep, group)
    u = FE.fold_calls(gprob, calls)
    _held_to_plain(GE.group_logits, GE.group_logits_plain, u, calls, n_words)


@pytest.mark.gpu
@pytest.mark.parametrize("n_words", [0, 1, 2])
def test_gpu_group_without_log_matches_plain(n_words):
    """The nolog ablation: each group's arguments summed."""
    _need_card()
    from demuxalot_tpu_torch.experiments import folded_estep as FE
    from demuxalot_tpu_torch.experiments import group_estep as GE

    gprob, estep = _variant_args(32)
    calls = GE.group_layout(estep, 4)
    _held_to_plain(GE.group_logits, GE.group_logits_plain, FE.fold_calls(gprob, calls), calls, n_words,
                   use_log=False, argmax=False)


@pytest.mark.gpu
def test_gpu_variant_kernels_refuse_unchecked_operands():
    """Split and group launch only on operands their constructors checked; a replaced CSR drops the check."""
    _need_card()
    from demuxalot_tpu_torch.experiments import folded_estep as FE
    from demuxalot_tpu_torch.experiments import group_estep as GE
    from demuxalot_tpu_torch.experiments import split_estep as SE

    gprob, estep = _variant_args(7)
    u, ops = FE.fold_calls(gprob, estep), FE.variant_operands(estep)
    for unchecked in (FE.VariantOperands(*ops), ops._replace(row_ptr=ops.row_ptr.clone())):
        with pytest.raises(ValueError, match="variant_operands"):
            SE.split_logits(u, unchecked, 2, 2)
    calls = GE.group_layout(estep, 4)
    with pytest.raises(ValueError, match="group_layout"):
        GE.group_logits(FE.fold_calls(gprob, calls), calls._replace(built=None), 2)


@pytest.mark.gpu
def test_gpu_variants_padding_is_bit_exact():
    """q = 1 calls after each barcode's real calls change no bit of any variant kernel's logits."""
    _need_card()
    from demuxalot_tpu_torch.experiments import folded_estep as FE
    from demuxalot_tpu_torch.experiments import group_estep as GE
    from demuxalot_tpu_torch.experiments import split_estep as SE

    runs = []
    for pad in (0, 999):
        gprob, estep = _variant_args(32, pad)
        u, ops = FE.fold_calls(gprob, estep), FE.variant_operands(estep)
        got = [FE.folded_logits(u, ops)] + [SE.split_logits(u, ops, e, s) for e, s in SE.HARNESS_PAIRS]
        for group in GE.HARNESS_GROUPS:
            calls = GE.group_layout(estep, group)
            got += [GE.group_logits(FE.fold_calls(gprob, calls), calls, w) for w in (0, 1, 2)]
        runs.append(got)
    assert all(torch.equal(a, b) for a, b in zip(*runs))


# ---------------------------------------------------------------------------
# the streams, the gather forms, the cluster gather-sum and the tiny kernel
# ---------------------------------------------------------------------------

@pytest.mark.gpu
@pytest.mark.parametrize("cols", [True, False])
@pytest.mark.parametrize("n_slots, d, step", [(65_536, 32, 512), (65_536 + 777, 32, 32768), (70_001, 7, 4096),
                                              (100_003, 32, 100), (4096, 32, 4096)])
def test_gpu_streams_match_float64(cols, n_slots, d, step):
    """Ragged tails, a D that leaves rows unaligned (7), steps narrower than the corner, one whole step."""
    _need_card()
    from demuxalot_tpu_torch.experiments import dma_pattern as DP

    x = DP.stream_inputs(n_slots, d, seed=step, cols=cols)
    kernel, plain = (DP.stream_cols, DP.stream_cols_plain) if cols else (DP.stream_rows, DP.stream_rows_plain)
    launches = kernel.launches
    got = kernel(x, step)
    assert kernel.launches == launches + 1
    exact = float(plain(x.double(), step))
    assert float(got) == pytest.approx(exact, rel=1e-6)
    assert float(plain(x, step)) == pytest.approx(exact, rel=1e-6)
    assert torch.equal(got, kernel(x, step))


def _take_problem(axis, shape, out_rows, table_offset=0, idx_offset=0):
    rng = np.random.RandomState(sum(shape))
    table = offset_view(t(rng.rand(*shape).astype(np.float32), "cuda"), table_offset)
    idx_shape = (out_rows, shape[1]) if axis == 0 else (shape[0], 2 * shape[1] + 1)
    idx = offset_view(t(rng.randint(0, shape[axis], idx_shape).astype(np.int32), "cuda"), idx_offset)
    return table, idx


_TAKE_SHAPES = [(0, (1024, 128), 256), (0, (8192, 128), 8192), (0, (50, 7), 13), (1, (256, 512), 256),
                (1, (9, 33), 9)]


@pytest.mark.gpu
@pytest.mark.parametrize("table_offset, idx_offset", [(0, 0), (1, 0), (0, 1)])
@pytest.mark.parametrize("axis, shape, out_rows", _TAKE_SHAPES)
def test_gpu_take_along_axis_is_bit_equal(axis, shape, out_rows, table_offset, idx_offset):
    """Aligned, and with the table or the indices one float off a 16-byte boundary (the scalar paths)."""
    _need_card()
    from demuxalot_tpu_torch.experiments.gather_forms import take_along_axis, take_along_axis_plain

    table, idx = _take_problem(axis, shape, out_rows, table_offset, idx_offset)
    launches = take_along_axis.launches
    got = take_along_axis(table, idx, axis)
    assert take_along_axis.launches == launches + 1
    assert torch.equal(got, take_along_axis_plain(table, idx, axis))
    assert torch.equal(got, torch.gather(table, axis, idx.long()))


@pytest.mark.gpu
@pytest.mark.parametrize("axis, shape, out_rows", _TAKE_SHAPES)
def test_gpu_take_along_axis_on_a_side_stream_and_in_a_graph(axis, shape, out_rows):
    """The kernel goes on whatever stream is current: a side stream's output and a graph's replay equal the
    eager call's, bit for bit."""
    _need_card()
    from demuxalot_tpu_torch.experiments import gather_forms as GF

    table, idx = _take_problem(axis, shape, out_rows)
    eager = GF.take_along_axis(table, idx, axis)
    on_side, replayed = side_stream_and_replay(lambda: GF.take_along_axis(table, idx, axis))
    assert torch.equal(on_side, eager) and torch.equal(replayed, eager)
    assert torch.equal(eager, GF.take_along_axis_plain(table, idx, axis))


@pytest.mark.gpu
@pytest.mark.parametrize("shape, n_idx, step, high", [((8192, 32), 1 << 20, 8192, 8192),
                                                       ((8192, 32), 10_001, 8192, 1024),
                                                       ((1000, 7), 5000, 1, 1000), ((5, 4), 999, 100, 5)])
def test_gpu_cluster_gather_sum_matches_float64(shape, n_idx, step, high):
    """The harness's table, every index in CTA 0's slice (high 1024), a width of 7, fewer rows than CTAs."""
    _need_card()
    from demuxalot_tpu_torch.experiments.gather_forms import cluster_gather_sum, cluster_gather_sum_plain

    rng = np.random.RandomState(n_idx)
    table = t(rng.rand(*shape).astype(np.float32), "cuda")
    idx = t(rng.randint(0, high, n_idx).astype(np.int32), "cuda")
    launches = cluster_gather_sum.launches
    got = cluster_gather_sum(table, idx, step)
    assert cluster_gather_sum.launches == launches + 1
    exact = float(table.double()[idx.long()].sum())
    assert float(got) == pytest.approx(exact, rel=1e-6)
    assert float(cluster_gather_sum_plain(table, idx, step)) == pytest.approx(exact, rel=1e-6)
    assert torch.equal(got, cluster_gather_sum(table, idx, step))


@pytest.mark.gpu
@pytest.mark.parametrize("n_rows", [16_384, 131_072])
def test_gpu_cluster_gather_sum_refuses_a_table_past_the_cluster(n_rows):
    """2 and 16 MiB tables (256 KB and 2 MiB per CTA) fit no cluster of 8 CTAs: it raises, and nothing falls back."""
    _need_card()
    from demuxalot_tpu_torch.experiments.gather_forms import cluster_gather_sum

    table = torch.rand(n_rows, 32, device="cuda")
    idx = torch.zeros(100, dtype=torch.int32, device="cuda")
    launches = cluster_gather_sum.launches
    with pytest.raises(RuntimeError, match="does not fit"):
        cluster_gather_sum(table, idx)
    assert cluster_gather_sum.launches == launches


@pytest.mark.gpu
@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("shape", [(8, 128), (3, 5), (1_000_003,)])
def test_gpu_tiny_is_bit_equal(shape, offset):
    """Aligned, and with x one float off a 16-byte boundary (the scalar path)."""
    _need_card()
    from demuxalot_tpu_torch.experiments.gather_operand import tiny, tiny_plain

    x = offset_view(t(np.random.RandomState(len(shape)).randn(*shape).astype(np.float32), "cuda"), offset)
    launches = tiny.launches
    got = tiny(x)
    assert tiny.launches == launches + 1
    assert torch.equal(got, tiny_plain(x))


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(8, 128), (3, 5), (1_000_003,)])
def test_gpu_tiny_on_a_side_stream_and_in_a_graph(shape):
    _need_card()
    from demuxalot_tpu_torch.experiments.gather_operand import tiny

    x = torch.randn(shape, device="cuda")
    eager = tiny(x)
    on_side, replayed = side_stream_and_replay(lambda: tiny(x))
    assert torch.equal(on_side, eager) and torch.equal(replayed, eager)
    assert torch.equal(eager, x * 2.0)
