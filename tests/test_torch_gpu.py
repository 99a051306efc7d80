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
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from demuxalot_tpu_torch import BarcodeHandler, Demultiplexer, sim
from demuxalot_tpu_torch.experiments.kernel_gather import H100_SHARED_OPTIN, slice_rows
from demuxalot_tpu_torch.models import demux
from demuxalot_tpu_torch.ops import likelihood_kernel
from demuxalot_tpu_torch.ops.aggregate_kernel import aggregated_logits, aggregated_logits_plain
from demuxalot_tpu_torch.ops.likelihood_kernel import estep_logits, estep_logits_plain
from demuxalot_tpu_torch.ops import likelihood as L
from demuxalot_tpu_torch.ops.mstep_kernel import mstep_addition, mstep_addition_plain, mstep_update, mstep_update_plain
from oracle import oracle_barcode_logits
from torch_problems import (aggregate_args, aggregate_problem, estep_args, estep_problem, in_order_addition,
                            mstep_operands, mstep_problem, offset_view, side_stream_and_replay, t, update_problem)


# the most rows an on-chip gather-sum slice holds at width 64 on an H100
FULL_SLICE = slice_rows(64, H100_SHARED_OPTIN)


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
elif {kernel!r}.startswith("cluster"):
    from demuxalot_tpu_torch.experiments import gather_forms as GF
    table = torch.rand(8192, 32, device="cuda")
    idx = torch.randint(0, 8192, (100_000,), dtype=torch.int32, device="cuda")
    idx[77_777] = 8192 if {kernel!r} == "cluster_past" else -1  # one past the last row; a negative row
    launch = lambda: GF.cluster_gather_sum(table, idx)
elif {kernel!r} == "variants":
    from demuxalot_tpu_torch.experiments import folded_estep as FE
    gprob, operands = estep_args(estep_problem(n_donors=4), "cuda")
    bad = operands.row_ptr.clone()
    bad[-1] = len(operands.cb) + 1  # a barcode's calls past the last call
    # the operands' constructor checks the CSR once, so no split kernel ever reads through it
    launch = lambda: FE.variant_operands(operands._replace(row_ptr=bad))
elif {kernel!r}.startswith("aggregate"):
    import numpy as np
    from demuxalot_tpu_torch.models.demux import _SnpAggregationLayout
    from demuxalot_tpu_torch.ops.likelihood import pseudogenotype_pairs
    from torch_problems import aggregate_problem
    p = aggregate_problem(n_donors=4)
    layout = _SnpAggregationLayout.build(p["calls"], torch.device("cuda"))
    n_variants = p["gprob"].shape[0]
    if {kernel!r} == "aggregate_groups":
        group_ptr = layout.group_ptr.clone()
        group_ptr[-1] = len(p["calls"]) + 1  # the last group's calls past the last call
        layout = layout._replace(group_ptr=group_ptr)
    else:
        n_variants = int(p["calls"].variant_id.max())  # the largest id is one past the table
    # the operands' constructor checks the CSRs and ids once, so no aggregate kernel ever reads through them
    launch = lambda: layout.operands(p["n_barcodes"], np.stack(pseudogenotype_pairs(4, 0.35)), 4, n_variants)
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
@pytest.mark.parametrize("kernel", ["estep", "mstep", "variants", "take_axis0", "take_axis1", "cluster_past",
                                    "cluster_negative", "aggregate_groups", "aggregate_vid"])
def test_gpu_out_of_range_index_traps(kernel):
    """An index past its table traps in checks.cu before the main kernel reads it: the E-step's at each
    launch, the M-step's, the split and group E-steps' and the aggregate E-step's (a group's calls past the
    last call, a variant id past the table) when their operands are built. take_along_axis
    and the cluster gather-sum test each index inside the kernel and trap there.

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
    saved = demux.estep_logits, demux.mstep_addition, demux.mstep_update, demux.aggregated_logits
    (demux.estep_logits, demux.mstep_addition, demux.mstep_update,
     demux.aggregated_logits) = estep_logits_plain, mstep_addition_plain, mstep_update_plain, aggregated_logits_plain
    try:
        yield
    finally:
        demux.estep_logits, demux.mstep_addition, demux.mstep_update, demux.aggregated_logits = saved


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
    """aggregate_on_snps on the card: every E-step is one aggregate kernel launch (the plain chain never
    runs), every M-step the fused kernel."""
    _need_card()
    packed, genotypes, handler = engine_problem
    monkeypatch.setattr(Demultiplexer, "aggregate_on_snps", True)
    learn = lambda: Demultiplexer.learn_genotypes_core(packed, genotypes, handler, n_iterations=3, doublet_prior=0.35)
    kernels = (estep_logits, mstep_addition, mstep_update, aggregated_logits)
    launches = [kernel.launches for kernel in kernels]
    with monkeypatch.context() as patch:
        patch.setattr(L, "snp_aggregated_logits", lambda *args, **kwargs: pytest.fail("the plain chain ran"))
        result = learn()
    assert tuple(kernel.launches - n for kernel, n in zip(kernels, launches)) == (0, 0, 2, 3)
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
@pytest.mark.parametrize("aggregate", [False, True])
def test_gpu_em_launches_lie_inside_the_iteration_spans(engine_problem, monkeypatch, tmp_path, aggregate):
    """Under ``device_trace`` every E-step and M-step kernel of a learn is launched inside its iteration span.

    A kernel event and its runtime call share the trace's correlation id; the
    call must lie within an ``em.estep`` span (E-step kernels) or an
    ``em.mstep`` span (M-step kernels) of the same thread.
    """
    _need_card()
    from demuxalot_tpu_torch.utils import device_trace

    packed, genotypes, handler = engine_problem
    monkeypatch.setattr(Demultiplexer, "aggregate_on_snps", aggregate)
    learn = lambda: Demultiplexer.learn_genotypes_core(packed, genotypes, handler, n_iterations=3, doublet_prior=0.35)
    untraced = learn()
    with device_trace(str(tmp_path)):
        traced = learn()
        torch.cuda.synchronize()
    assert torch.equal(traced.state.probs, untraced.state.probs)
    events = [e for e in json.loads((tmp_path / "trace.json").read_text())["traceEvents"] if e.get("ph") == "X"]
    spans = [(e["name"], e["tid"], e["ts"], e["ts"] + e["dur"]) for e in events
             if e.get("cat") == "user_annotation" and e["name"] in ("em.estep", "em.mstep")]
    calls = {e["args"]["correlation"]: e for e in events
             if e.get("cat") == "cuda_runtime" and "correlation" in e.get("args", {})}
    kernels = {"em.estep": ("aggregate_kernel" if aggregate else "estep_kernel"), "em.mstep": "mstep_kernel"}
    launched = {span: 0 for span in kernels}
    for e in events:
        for span, kernel in kernels.items():
            if e.get("cat") == "kernel" and kernel in e["name"]:
                call = calls[e["args"]["correlation"]]
                begin, finish = call["ts"], call["ts"] + call["dur"]
                assert any(name == span and tid == call["tid"] and start <= begin <= finish <= end
                           for name, tid, start, end in spans), (e["name"], call["name"])
                launched[span] += 1
    assert launched == {"em.estep": 3, "em.mstep": 2}


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
    pairs = np.stack(L.pseudogenotype_pairs(genotypes.n_genotypes, doublet_prior))
    logits = {}
    for device in ("cuda", "cpu"):
        layout = demux._SnpAggregationLayout.build(kept, torch.device(device))
        operands = layout.operands(handler.n_barcodes, pairs, genotypes.n_genotypes, packed.n_variants)
        run = lambda: aggregated_logits(t(gprob, device), operands)  # noqa: E731
        logits[device] = run()
        assert torch.equal(logits[device], run())
    got = logits["cuda"].cpu().numpy()
    empty = np.arange(handler.n_barcodes) % 5 == 2
    assert (got[empty] == 0).all() and (got[~empty] != 0).any(axis=1).all()
    np.testing.assert_allclose(got, logits["cpu"].numpy(), rtol=1e-4, atol=5e-3)


# (donors, doublet prior): teams of lanes at 1, 10 and 32 columns (the aggregate EM's width at 32 donors), a warp
# a group at 528 (predict's), the row split over a block's warps at 561 and 2,080 (64 donors)
AGGREGATE_SHAPES = [(1, 0.0), (4, 0.35), (32, 0.0), (32, 0.35), (33, 0.35), (64, 0.35)]


def _aggregate_held_to_plain(gprob, operands, seed):
    """The kernel's fused call against the plain version, with and without prior logits; one launch a call, and
    the logits-only call gives the fused call's logits bit for bit."""
    n_pg = operands.n_columns
    prior = t(np.random.RandomState(seed).randn(operands.n_barcodes, n_pg).astype(np.float32), "cuda")
    for prior_logits in (None, prior):
        launches = aggregated_logits.launches
        logits, probs = aggregated_logits(gprob, operands, prior_logits=prior_logits, softmax=True)
        assert aggregated_logits.launches == launches + 1
        want_logits, want_probs = aggregated_logits_plain(gprob, operands, prior_logits=prior_logits, softmax=True)
        torch.cuda.synchronize()
        np.testing.assert_allclose(logits.cpu().numpy(), want_logits.cpu().numpy(), rtol=1e-4, atol=5e-3)
        np.testing.assert_allclose(probs.cpu().numpy(), want_probs.cpu().numpy(), atol=3e-5)
        assert torch.equal(probs.argmax(1), want_probs.argmax(1))
        assert torch.equal(aggregated_logits(gprob, operands, prior_logits=prior_logits), logits)
        empty = operands.barcode_ptr.diff() == 0
        assert bool(empty.any()) and torch.equal(logits[empty], prior_logits[empty] if prior_logits is not None
                                                 else torch.zeros_like(logits[empty]))


@pytest.mark.gpu
@pytest.mark.parametrize("n_donors, doublet_prior", AGGREGATE_SHAPES)
def test_gpu_aggregated_logits_match_plain(n_donors, doublet_prior):
    """The aggregate kernel against its plain version, with and without prior logits: groups of one molecule and
    of many, empty barcodes, q down to 1e-7 and genotype rows of 0, and the edge barcodes of
    ``AGGREGATE_EDGE_GROUPS`` (one group, fewer groups than teams, 31-33 and 62-65 groups, long groups beside
    groups of one). One launch a call; the logits-only call gives the fused call's logits bit for bit."""
    _need_card()
    gprob, operands = aggregate_args(aggregate_problem(seed=n_donors, n_donors=n_donors,
                                                       doublet_prior=doublet_prior, edges=True), "cuda")
    _aggregate_held_to_plain(gprob, operands, n_donors)


def _plan_switches(limit=9000):
    """One width each side of every change of ``aggregate_plan``'s instantiation up to ``limit`` columns."""
    from demuxalot_tpu_torch.ops.aggregate_kernel import aggregate_plan

    return sorted({w for n in range(2, limit) if aggregate_plan(n) != aggregate_plan(n - 1) for w in (n - 1, n)})


def _donors_for(n_pg):
    return next(d for d in range(1, 200) if d * (d + 1) // 2 >= n_pg)


@pytest.mark.gpu
@pytest.mark.parametrize("n_pg", _plan_switches())
def test_gpu_aggregated_logits_at_plan_switches(n_pg):
    """One width each side of every switch of the plan's instantiation (the first n_pg of the donors' singlets
    and doublets), on the edge barcodes."""
    _need_card()
    n_donors = _donors_for(n_pg)
    problem = aggregate_problem(seed=n_pg, n_donors=n_donors, n_calls=1500, n_barcodes=40, edges=True)
    _aggregate_held_to_plain(*aggregate_args(problem, "cuda", n_pg=n_pg), n_pg)


def _every_instantiation(widths=(4, 10, 32, 64, 136, 528, 561, 2080)):
    from demuxalot_tpu_torch.ops.aggregate_kernel import instantiations

    return [(n_pg, *plan) for n_pg in widths for plan in instantiations(n_pg)]


@pytest.mark.gpu
@pytest.mark.parametrize("n_pg, team, cols", _every_instantiation())
def test_gpu_aggregated_logits_every_instantiation(n_pg, team, cols, monkeypatch):
    """Each instantiation that holds the row, forced (``aggregate_kernel.PLAN``), on the edge barcodes; up to 544
    columns every one but the split row gives the first design's bits (a warp a group, 17 columns a lane)."""
    _need_card()
    from demuxalot_tpu_torch.ops import aggregate_kernel

    monkeypatch.setattr(aggregate_kernel, "PLAN", (team, cols))
    problem = aggregate_problem(seed=n_pg + team, n_donors=_donors_for(n_pg), n_calls=1500, n_barcodes=40,
                                edges=True)
    gprob, operands = aggregate_args(problem, "cuda", n_pg=n_pg)
    _aggregate_held_to_plain(gprob, operands, n_pg)
    first = aggregated_logits(gprob, operands, softmax=True)
    again = aggregated_logits(gprob, operands, softmax=True)
    assert torch.equal(first[0], again[0]) and torch.equal(first[1], again[1])
    if team != 0 and n_pg <= 544:
        monkeypatch.setattr(aggregate_kernel, "PLAN", (32, 17))
        warp = aggregated_logits(gprob, operands, softmax=True)
        assert torch.equal(first[0], warp[0]) and torch.equal(first[1], warp[1])


@pytest.mark.gpu
@pytest.mark.parametrize("n_donors", [32, 64])
def test_gpu_aggregated_logits_runs_are_bit_equal(n_donors):
    _need_card()
    gprob, operands = aggregate_args(aggregate_problem(seed=1, n_donors=n_donors, n_barcodes=300, n_calls=20_000),
                                     "cuda")
    first = aggregated_logits(gprob, operands, softmax=True)
    again = aggregated_logits(gprob, operands, softmax=True)
    assert torch.equal(first[0], again[0]) and torch.equal(first[1], again[1])


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
@pytest.mark.parametrize("n_bands", [1, 12, 300])
def test_gpu_estep_banded_padding_is_bit_exact(n_bands):
    """999 padding calls after each barcode's real calls lie, once banded, at the ends of their band segments,
    inside the barcode's stream of bands: they leave every logit's bits."""
    _need_card()
    from demuxalot_tpu_torch.experiments.inkernel_gather import estep_logits_banded

    base = _banded_estep_args(32, n_bands)
    padded = _banded_estep_args(32, n_bands, pad=999)
    ptr, ptr_padded = base[1].band_ptr, padded[1].band_ptr
    assert n_bands == 1 or bool((ptr_padded[:-1, -1] > ptr[:-1, -1]).any()), "padding before later bands' calls"
    assert torch.equal(estep_logits_banded(*base), estep_logits_banded(*padded))


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
def test_gpu_mstep_banded_past_shared_memory_matches_plain():
    """Two bands of 35,000 barcodes x 32 donors (4.5 MB each, past a block's shared memory): the kernel stages no
    band, so it runs them, held to its plain version."""
    _need_card()
    from demuxalot_tpu_torch.experiments.inkernel_gather import (
        banded_mstep_operands, mstep_addition_banded, mstep_addition_banded_plain,
    )

    post, vid, cb, q, n_variants, _ = mstep_problem(n_donors=32, n_barcodes=70_000)
    operands = banded_mstep_operands(t(vid, "cuda"), t(cb, "cuda"), t(q, "cuda"), n_variants, 70_000, 2)
    args = (t(post, "cuda"), operands, 32, 2.0)
    launches = mstep_addition_banded.launches
    got = mstep_addition_banded(*args)
    assert mstep_addition_banded.launches == launches + 1
    want = mstep_addition_banded_plain(*args)
    torch.cuda.synchronize()
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), rtol=1e-4, atol=1e-5)
    assert torch.equal(got, mstep_addition_banded(*args))


@pytest.mark.gpu
@pytest.mark.parametrize("n_bands", [2, 40])
def test_gpu_mstep_banded_padding_mid_band_is_bit_exact(n_bands):
    """q = 1 calls inserted at random places of the calls, so mid-band once banded, add exactly 0."""
    _need_card()
    from demuxalot_tpu_torch.experiments.inkernel_gather import banded_mstep_operands, mstep_addition_banded

    post, vid, cb, q, n_variants, n_donors = mstep_problem(n_donors=7)
    rng = np.random.RandomState(21)
    at = np.sort(rng.randint(0, len(vid) + 1, 1500))
    vid_p = np.insert(vid, at, rng.randint(0, n_variants, len(at)).astype(np.int32))
    cb_p = np.insert(cb, at, rng.randint(0, post.shape[0], len(at)).astype(np.int32))
    q_p = np.insert(q, at, np.ones(len(at), np.float32))
    runs = []
    for v, c, w in ((vid, cb, q), (vid_p, cb_p, q_p)):
        operands = banded_mstep_operands(t(v, "cuda"), t(c, "cuda"), t(w, "cuda"), n_variants, post.shape[0], n_bands)
        runs.append(mstep_addition_banded(t(post, "cuda"), operands, n_donors, 2.0))
    assert torch.equal(*runs)


@pytest.mark.gpu
def test_gpu_banded_calls_in_one_band_or_none():
    """A barcode (E-step) and a variant (M-step) whose calls all lie in one band, and ones with none."""
    _need_card()
    from demuxalot_tpu_torch.experiments import inkernel_gather as IG

    gprob, vid, cb, q, n_barcodes, n_donors, prior = estep_problem(n_donors=7, n_barcodes=60, n_calls=3000)
    n_variants = gprob.shape[0]  # 200 in 8 bands of 25
    vid = vid.copy()
    vid[cb == 3] = 50 + vid[cb == 3] % 25  # barcode 3: band 2 only
    vid[cb == 4] = 199  # barcode 4: one variant of the last band
    keep = (cb != 5) & (cb != 6)  # barcodes 5 and 6: no calls
    operands = IG.banded_estep_operands(n_donors, prior, t(cb[keep], "cuda"), t(vid[keep], "cuda"),
                                        t(q[keep], "cuda"), n_barcodes, n_variants, 8)
    ptr = operands.band_ptr.diff(dim=1)
    assert int((ptr[:, 3] > 0).sum()) == 1 and int((ptr[:, 4] > 0).sum()) == 1 and not ptr[:, 5:7].any()
    got = IG.estep_logits_banded(t(gprob, "cuda"), operands)
    want = IG.estep_logits_banded_plain(t(gprob, "cuda"), operands)
    torch.cuda.synchronize()
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), rtol=1e-4, atol=5e-3)
    assert torch.equal(got[5], operands.penalties) and torch.equal(got[6], operands.penalties)

    post, vid, cb, q, n_variants, n_donors = mstep_problem(n_donors=7)
    cb = cb.copy()
    cb[vid == 10] = 60 + cb[vid == 10] % 30  # variant 10: barcode band 2 (60 .. 90) only
    cb[vid == 11] = 149  # variant 11: one barcode of the last band
    keep = vid != 12  # variant 12: no calls
    operands = IG.banded_mstep_operands(t(vid[keep], "cuda"), t(cb[keep], "cuda"), t(q[keep], "cuda"), n_variants,
                                        post.shape[0], 5)
    ptr = operands.band_ptr.diff(dim=1)
    assert int((ptr[:, 10] > 0).sum()) == 1 and int((ptr[:, 11] > 0).sum()) == 1 and not ptr[:, 12].any()
    args = (t(post, "cuda"), operands, n_donors, 2.0)
    got = IG.mstep_addition_banded(*args)
    want = IG.mstep_addition_banded_plain(*args)
    torch.cuda.synchronize()
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), rtol=1e-4, atol=1e-5)
    assert not got[12].any()


def _captured_nodes(fn) -> list:
    """The node types (CUgraphNodeType, 0 a kernel) of ``fn()`` captured in a CUDA graph, read by libcuda."""
    import ctypes

    fn()  # the library is loaded and each kernel's attributes set before the capture
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph):
        fn()
    libcuda = ctypes.CDLL("libcuda.so.1")
    count = ctypes.c_size_t(0)
    handle = ctypes.c_void_p(graph.raw_cuda_graph())
    assert libcuda.cuGraphGetNodes(handle, None, ctypes.byref(count)) == 0
    nodes = (ctypes.c_void_p * count.value)()
    assert libcuda.cuGraphGetNodes(handle, nodes, ctypes.byref(count)) == 0
    types = []
    for node in nodes:
        kind = ctypes.c_int(-1)
        assert libcuda.cuGraphNodeGetType(ctypes.c_void_p(node), ctypes.byref(kind)) == 0
        types.append(kind.value)
    return types


@pytest.mark.gpu
@pytest.mark.parametrize("entry", ["estep", "mstep"])
def test_gpu_banded_entries_launch_one_kernel(entry):
    """Each banded entry is one launch and runs no check kernel: its call captures as one kernel node."""
    _need_card()
    from demuxalot_tpu_torch.experiments import inkernel_gather as IG

    if entry == "estep":
        args, wrapper = _banded_estep_args(32, 12), IG.estep_logits_banded
    else:
        post, vid, cb, q, n_variants, n_donors = mstep_problem(n_donors=7)
        operands = IG.banded_mstep_operands(t(vid, "cuda"), t(cb, "cuda"), t(q, "cuda"), n_variants, post.shape[0],
                                            40)
        args, wrapper = (t(post, "cuda"), operands, n_donors, 2.0), IG.mstep_addition_banded
    launches = wrapper.launches
    assert _captured_nodes(lambda: wrapper(*args)) == [0]
    assert wrapper.launches == launches + 2


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
@pytest.mark.parametrize("shape, n_idx, step, path", [
    ((8192, 64), 1 << 20, 4096, "chip"), ((8192, 32), 200_000, 8192, "chip"), ((1000, 7), 10_001, 4096, "chip"),
    ((1000, 7), 5000, 1, "chip"), ((8192, 64), 50_001, 100, "chip"), ((8192, 64), 50_001, 1001, "chip"),
    ((3 * FULL_SLICE, 64), 200_000, 4096, "chip"), ((3 * FULL_SLICE - 5, 64), 200_000, 4096, "chip"),
    ((131_072, 32), 5000, 1, "l2"), ((131_072, 32), 100_003, 4096, "l2"), ((800_000, 32), 1 << 20, 4096, "l2"),
    ((100, 1), 20_000, 4096, "l2")])
def test_gpu_gather_sum_matches_float64(shape, n_idx, step, path):
    """Both paths of the plan's rule: tables on chip (W = 7: 4-byte row reads; steps of 1, 100 and 1001: no
    multiple of 32, 1001 none of 4, so 4-byte index loads; FULL_SLICE rows, the most a slice holds at W = 64 on
    an H100, times 3, and 5 rows fewer: the last slice short) and through L2 (S >= W, and W = 1 whatever S)."""
    _need_card()
    from demuxalot_tpu_torch.experiments.kernel_gather import gather_sum, gather_sum_plain, rate_inputs

    table, idx = rate_inputs(*shape, n_idx=n_idx, seed=2)
    launches = gather_sum.launches
    got = gather_sum(table, idx, step).clone()  # the wrapper's own buffer: the next call writes it again
    assert gather_sum.launches == launches + 1 and gather_sum.last_path == path
    exact = float(table.double()[idx.long()].sum())
    assert float(got) == pytest.approx(exact, rel=1e-5)
    assert float(gather_sum_plain(table, idx, step)) == pytest.approx(exact, rel=1e-5)
    assert torch.equal(got, gather_sum(table, idx, step))


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(8192, 64), (131_072, 32)])
def test_gpu_gather_sum_on_a_side_stream_and_in_a_graph(shape):
    """Its buffers made at the first call, the gather-sum runs on a side stream and in a CUDA graph's replay."""
    _need_card()
    from demuxalot_tpu_torch.experiments.kernel_gather import gather_sum, rate_inputs

    table, idx = rate_inputs(*shape, n_idx=100_000, seed=3)
    want = gather_sum(table, idx).clone()
    on_side, replayed = side_stream_and_replay(lambda: gather_sum(table, idx).clone())
    assert torch.equal(on_side, want) and torch.equal(replayed, want)


_BANDED_TRAP_SCRIPT = """
import sys
import torch
sys.path[:0] = {paths!r}
from demuxalot_tpu_torch.experiments import inkernel_gather as IG
from demuxalot_tpu_torch.experiments import kernel_gather as KG
from torch_problems import estep_problem, mstep_problem, t
if {kernel!r} == "estep_banded":
    gprob, vid, cb, q, n_barcodes, n_donors, prior = estep_problem(n_donors=4)
    vid[len(vid) // 2] = gprob.shape[0]  # one past the last variant: past its band's last row
    # the operands' constructor checks the band-local ids once, so no banded kernel ever reads through them
    launch = lambda: IG.banded_estep_operands(n_donors, prior, t(cb, "cuda"), t(vid, "cuda"), t(q, "cuda"),
                                              n_barcodes, gprob.shape[0], 4)
elif {kernel!r} == "mstep_banded":
    post, vid, cb, q, n_variants, n_donors = mstep_problem()
    cb[len(cb) // 2] = post.shape[0]  # one past the last barcode: past its band's last row
    launch = lambda: IG.banded_mstep_operands(t(vid, "cuda"), t(cb, "cuda"), t(q, "cuda"), n_variants,
                                              post.shape[0], 3)
elif {kernel!r} == "gather":
    table, idx = KG.rate_inputs(100, 8, 1000)  # on chip
    idx[500] = 100
    launch = lambda: KG.gather_sum(table, idx)
else:
    table, idx = KG.rate_inputs(131_072, 32, 10_000)  # through L2
    idx[5000] = -1
    launch = lambda: KG.gather_sum(table, idx)
try:
    launch()
    torch.cuda.synchronize()
except Exception as error:
    print(type(error).__name__, error)
    sys.exit(3)
"""


@pytest.mark.gpu
@pytest.mark.parametrize("kernel", ["estep_banded", "mstep_banded", "gather", "gather_l2"])
def test_gpu_banded_out_of_range_index_traps(kernel):
    """A band-local id past its band traps in checks.cu when the banded operands are built; an index past the
    table (or negative) traps inside the gather-sum on either path. In a child process."""
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
@pytest.mark.parametrize("use_log", [True, False])
@pytest.mark.parametrize("n_donors", [7, 64])
@pytest.mark.parametrize("calls", [1, 7, 8, 9, 31, 33, 1200])
def test_gpu_folded_at_the_fold_edges(calls, n_donors, use_log):
    """Every barcode with ``calls`` calls: a last product of 8 short by 7, 1 or none, a 32-call tile short or
    one call past it, 38 tiles; 64 donors walk the calls in several schedule passes."""
    _need_card()
    from demuxalot_tpu_torch.experiments import folded_estep as FE
    from demuxalot_tpu_torch.ops.likelihood_kernel import estep_operands
    from demuxalot_tpu_torch.ops.packing import csr_row_pointers

    gprob, vid, _, q, _, _, _ = estep_problem(seed=calls, n_donors=n_donors, n_barcodes=40, n_calls=40 * calls)
    cb = np.repeat(np.arange(40, dtype=np.int32), calls)
    estep = estep_operands(n_donors, 0.25, t(csr_row_pointers(cb, 40), "cuda"), t(cb, "cuda"), t(vid, "cuda"),
                           t(q, "cuda"))
    gprob = t(gprob, "cuda")
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
    """Folded, split and group launch only on operands their constructors checked; a replaced CSR drops the
    check."""
    _need_card()
    from demuxalot_tpu_torch.experiments import folded_estep as FE
    from demuxalot_tpu_torch.experiments import group_estep as GE
    from demuxalot_tpu_torch.experiments import split_estep as SE

    gprob, estep = _variant_args(7)
    u, ops = FE.fold_calls(gprob, estep), FE.variant_operands(estep)
    for unchecked in (FE.VariantOperands(*ops), ops._replace(row_ptr=ops.row_ptr.clone())):
        with pytest.raises(ValueError, match="variant_operands"):
            SE.split_logits(u, unchecked, 2, 2)
        with pytest.raises(ValueError, match="variant_operands"):
            FE.folded_logits(u, unchecked)
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

# the route stream_plan takes for each case: TMA where a tensor map can address x (N % 4 == 0 for cols,
# D % 4 == 0 for rows, torch's 16-byte-aligned storage), cp.async for the rest
_STREAM_ROUTES = {(True, 65_536, 32, 512): "tma", (False, 65_536, 32, 512): "tma",
                  (True, 65_536 + 777, 32, 32768): "cp.async", (False, 65_536 + 777, 32, 32768): "tma",
                  (True, 70_001, 7, 4096): "cp.async", (False, 70_001, 7, 4096): "cp.async",
                  (True, 100_003, 32, 100): "cp.async", (False, 100_003, 32, 100): "tma",
                  (True, 4096, 32, 4096): "tma", (False, 4096, 32, 4096): "tma"}


@pytest.mark.gpu
@pytest.mark.parametrize("cols", [True, False])
@pytest.mark.parametrize("n_slots, d, step", [(65_536, 32, 512), (65_536 + 777, 32, 32768), (70_001, 7, 4096),
                                              (100_003, 32, 100), (4096, 32, 4096)])
def test_gpu_streams_match_float64(cols, n_slots, d, step):
    """Ragged tails, a D that leaves rows unaligned (7), steps narrower than the corner, one whole step; each on
    the route its plan names."""
    _need_card()
    from demuxalot_tpu_torch.experiments import dma_pattern as DP

    x = DP.stream_inputs(n_slots, d, seed=step, cols=cols)
    kernel, plain = (DP.stream_cols, DP.stream_cols_plain) if cols else (DP.stream_rows, DP.stream_rows_plain)
    launches = kernel.launches
    got = kernel(x, step)
    assert kernel.launches == launches + 1
    assert kernel.last_plan == DP.stream_plan(x, step, cols)
    assert kernel.last_plan.route == _STREAM_ROUTES[(cols, n_slots, d, step)]
    exact = float(plain(x.double(), step))
    assert float(got) == pytest.approx(exact, rel=1e-6)
    assert float(plain(x, step)) == pytest.approx(exact, rel=1e-6)
    assert torch.equal(got, kernel(x, step))


# each route on each layout: (cols, n_slots, d, step, offset, route); 1M slots give every block of the persistent
# grid several rounds of its ring of 32 KB boxes
_STREAM_ROUTE_CASES = [(True, 1 << 20, 32, 512, 0, "tma"), (False, 1 << 20, 32, 512, 0, "tma"),
                       (True, 1 << 20, 32, 512, 1, "cp.async"), (False, 1 << 20, 32, 512, 1, "cp.async"),
                       (False, 70_001, 7, 4096, 0, "cp.async"), (True, 70_001, 7, 4096, 0, "cp.async")]


def _stream_case(cols, n_slots, d, step, offset):
    """(a call of one route case's stream, the float64 sum); x ``offset`` floats into its storage."""
    from demuxalot_tpu_torch.experiments import dma_pattern as DP

    x = offset_view(DP.stream_inputs(n_slots, d, seed=n_slots + step, cols=cols), offset)
    run = lambda: (DP.stream_cols if cols else DP.stream_rows)(x, step)  # noqa: E731
    return run, float((DP.stream_cols_plain if cols else DP.stream_rows_plain)(x.double(), step))


@pytest.mark.gpu
@pytest.mark.parametrize("cols, n_slots, d, step, offset, route", _STREAM_ROUTE_CASES)
def test_gpu_streams_are_bit_equal_run_to_run(cols, n_slots, d, step, offset, route):
    """Two runs give the same bits on every route (partials in a fixed order, no atomics)."""
    _need_card()
    from demuxalot_tpu_torch.experiments import dma_pattern as DP

    run, exact = _stream_case(cols, n_slots, d, step, offset)
    first = run()
    assert (DP.stream_cols if cols else DP.stream_rows).last_plan.route == route
    assert float(first) == pytest.approx(exact, rel=1e-6)
    assert torch.equal(first, run())


@pytest.mark.gpu
@pytest.mark.parametrize("cols, n_slots, d, step, offset, route", _STREAM_ROUTE_CASES)
def test_gpu_streams_on_a_side_stream_and_in_a_graph(cols, n_slots, d, step, offset, route):
    """Each route goes on whatever stream is current, and a graph's replay launches with the tensor map it
    captured: bit-equal to the eager call."""
    _need_card()
    from demuxalot_tpu_torch.experiments import dma_pattern as DP

    run, exact = _stream_case(cols, n_slots, d, step, offset)
    eager = run()
    assert (DP.stream_cols if cols else DP.stream_rows).last_plan.route == route
    on_side, replayed = side_stream_and_replay(run)
    assert torch.equal(on_side, eager) and torch.equal(replayed, eager)
    assert float(eager) == pytest.approx(exact, rel=1e-6)


@pytest.mark.gpu
def test_gpu_stream_refuses_a_route_its_tensor_cannot_take():
    """The C entry checks TMA's rules again: a TMA plan on x one float off a 16-byte boundary is refused, and
    nothing retries another route."""
    _need_card()
    from demuxalot_tpu_torch.experiments import dma_pattern as DP

    aligned = DP.stream_inputs(1 << 16, 32, seed=3, cols=True)
    plan = DP.stream_plan(aligned, 512, cols=True)
    assert plan.route == "tma"
    with pytest.raises(RuntimeError, match="demux_stream_sum"):
        DP._launch(offset_view(aligned, 1), 512, True, plan)


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
@pytest.mark.parametrize("shape, n_idx, step, high, offset", [((8192, 32), 1 << 20, 8192, 8192, 0),
                                                               ((8192, 32), 10_001, 8192, 1024, 0),
                                                               ((1000, 7), 5000, 1, 1000, 0),
                                                               ((5, 4), 999, 100, 5, 0),
                                                               ((8192, 32), 50_000, 8192, 8192, 1),
                                                               ((8192, 32), 3 * 8192 + 1002, 8192, 8192, 0),
                                                               ((4000, 33), 70_001, 3000, 4000, 3)])
def test_gpu_cluster_gather_sum_matches_float64(shape, n_idx, step, high, offset):
    """The harness's table, every index in CTA 0's slice (high 1024), a width of 7, fewer rows than CTAs, indices
    one int past a 16-byte boundary, a tail shorter than a stage, a width of 33 with steps over several chunks."""
    _need_card()
    from demuxalot_tpu_torch.experiments.gather_forms import cluster_gather_sum, cluster_gather_sum_plain

    rng = np.random.RandomState(n_idx)
    table = t(rng.rand(*shape).astype(np.float32), "cuda")
    idx = offset_view(t(rng.randint(0, high, n_idx).astype(np.int32), "cuda"), offset)
    launches = cluster_gather_sum.launches
    got = cluster_gather_sum(table, idx, step).clone()  # the wrapper's own buffer: the next call writes it again
    assert cluster_gather_sum.launches == launches + 1
    exact = float(table.double()[idx.long()].sum())
    assert float(got) == pytest.approx(exact, rel=1e-6)
    assert float(cluster_gather_sum_plain(table, idx, step)) == pytest.approx(exact, rel=1e-6)
    assert torch.equal(got, cluster_gather_sum(table, idx, step))


@pytest.mark.gpu
def test_gpu_cluster_gather_sum_on_a_side_stream_and_in_a_graph():
    """The kernel and its in-order sum go on whatever stream is current: bit-equal to the eager call."""
    _need_card()
    from demuxalot_tpu_torch.experiments.gather_forms import cluster_gather_sum

    rng = np.random.RandomState(5)
    table = t(rng.rand(8192, 32).astype(np.float32), "cuda")
    idx = t(rng.randint(0, 8192, 300_001).astype(np.int32), "cuda")
    want = cluster_gather_sum(table, idx).clone()
    on_side, replayed = side_stream_and_replay(lambda: cluster_gather_sum(table, idx).clone())
    assert torch.equal(on_side, want) and torch.equal(replayed, want)


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
