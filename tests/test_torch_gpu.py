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
from demuxalot_tpu_torch.ops.mstep_kernel import mstep_addition, mstep_addition_plain
from oracle import oracle_barcode_logits
from torch_problems import estep_args, estep_problem, mstep_operands, mstep_problem, t


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
    args = (t(post, "cuda"), mstep_operands(vid, cb, q, n_variants, "cuda"), n_donors, power)
    launches = mstep_addition.launches
    got = mstep_addition(*args)
    assert mstep_addition.launches == launches + 1
    want = mstep_addition_plain(*args)
    torch.cuda.synchronize()
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), rtol=1e-4, atol=1e-5)


_TRAP_SCRIPT = """
import sys
import torch
sys.path[:0] = {paths!r}
from demuxalot_tpu_torch.ops.likelihood_kernel import estep_logits
from demuxalot_tpu_torch.ops.mstep_kernel import mstep_addition
from torch_problems import estep_args, estep_problem, mstep_operands, mstep_problem, t
if {kernel!r} == "estep":
    gprob, operands = estep_args(estep_problem(n_donors=4), "cuda")
    bad = operands.vid.clone()
    bad[len(bad) // 2] = gprob.shape[0]  # one past the last variant
    launch = lambda: estep_logits(gprob, operands._replace(vid=bad))
else:
    post, vid, cb, q, n_variants, n_donors = mstep_problem()
    cb[len(cb) // 2] = post.shape[0]  # one past the last barcode
    launch = lambda: mstep_addition(t(post, "cuda"), mstep_operands(vid, cb, q, n_variants, "cuda"), n_donors, 2.0)
try:
    launch()
    torch.cuda.synchronize()
except Exception as error:
    print(type(error).__name__, error)
    sys.exit(3)
"""


@pytest.mark.gpu
@pytest.mark.parametrize("kernel", ["estep", "mstep"])
def test_gpu_out_of_range_index_traps(kernel):
    """An index past its table traps in checks.cu before the main kernel reads it.

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
    saved = demux.estep_logits, demux.mstep_addition
    demux.estep_logits, demux.mstep_addition = estep_logits_plain, mstep_addition_plain
    try:
        yield
    finally:
        demux.estep_logits, demux.mstep_addition = saved


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
    launches = estep_logits.launches, mstep_addition.launches
    result = learn("auto")
    assert (estep_logits.launches - launches[0], mstep_addition.launches - launches[1]) == (4, 2)
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
    """aggregate_on_snps on the card: the E-step is torch ops, every M-step the kernel."""
    _need_card()
    packed, genotypes, handler = engine_problem
    monkeypatch.setattr(Demultiplexer, "aggregate_on_snps", True)
    learn = lambda: Demultiplexer.learn_genotypes_core(packed, genotypes, handler, n_iterations=3, doublet_prior=0.35)
    launches = estep_logits.launches, mstep_addition.launches
    result = learn()
    assert (estep_logits.launches - launches[0], mstep_addition.launches - launches[1]) == (0, 2)
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
