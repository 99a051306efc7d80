"""The aggregate E-step's kernel module (``ops.aggregate_kernel``) on the CPU, against the JAX package.

Inputs come from numpy seeds (``torch_problems.aggregate_problem``): groups
of one molecule and of many, barcodes without calls, q down to 1e-7 and
genotype rows of 0. Covered here:

- the layout's CSR pointers (the device barcode pointer and ``group_ptr``)
  against the JAX layout's ``group_of_call`` and ``barcode_of_group``;
- the wrapper's dispatch: CPU tensors run the plain version and count no
  launch, another device raises;
- the CPU path gives the engine's previous logits (+ prior, ``torch.softmax``)
  bit for bit;
- a float32 torch transcription of the kernel's scheme (``csrc/aggregate.cu``:
  a group of one call in the probability domain, its terms over their sum
  and one log; longer groups in log2 units, one log per call term; the
  second normaliser as log(1 + p_bad_snp)) against JAX's
  ``snp_aggregated_logits`` and the float64 oracle, also on pools of groups of
  one only and of none;
- the layout's counters of groups and groups of one.

Tolerances: logits rtol 1e-4 / atol 5e-3, posteriors atol 3e-5, the same
argmax.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from demuxalot_tpu.models.demux import _SnpAggregationLayout as JaxLayout
from demuxalot_tpu.ops import likelihood as JL
from demuxalot_tpu.ops.packing import MoleculeCalls as JaxMoleculeCalls
from demuxalot_tpu_torch import Demultiplexer
from demuxalot_tpu_torch.models import demux
from demuxalot_tpu_torch.ops import aggregate_kernel as A
from demuxalot_tpu_torch.ops import likelihood as L
from oracle import oracle_snp_aggregated_logits
from torch_problems import aggregate_args, aggregate_problem, t

torch.set_num_threads(1)

LOGITS_TOL = dict(rtol=1e-4, atol=5e-3)
POSTERIOR_ATOL = 3e-5
SHAPES = [(1, 0.0), (1, 0.35), (4, 0.0), (4, 0.35), (33, 0.0), (33, 0.35)]


def _jax_layout(calls):
    return JaxLayout.build(JaxMoleculeCalls(**vars(calls)))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_layout_pointers_equal_jax(seed):
    """The port's group and barcode CSRs expand to JAX's group of every call and barcode of every group."""
    problem = aggregate_problem(seed=seed, n_donors=3)
    calls = problem["calls"]
    layout = demux._SnpAggregationLayout.build(calls, torch.device("cpu"))
    theirs = _jax_layout(calls)
    group_ptr, barcode_ptr = layout.group_ptr.numpy(), layout.barcode_ptr.numpy()
    n_groups = len(group_ptr) - 1
    assert n_groups == theirs.n_groups and barcode_ptr[-1] == n_groups
    np.testing.assert_array_equal(np.repeat(np.arange(n_groups), np.diff(group_ptr)),
                                  np.asarray(theirs.group_of_call))
    np.testing.assert_array_equal(np.repeat(np.arange(len(barcode_ptr) - 1), np.diff(barcode_ptr)),
                                  np.asarray(theirs.barcode_of_group))
    np.testing.assert_array_equal(layout.vid.numpy(), np.asarray(theirs.vid_by_group))
    # the operands: the same group CSR on the device, the barcode CSR padded to every barcode with no group
    _gprob, operands = aggregate_args(problem)
    np.testing.assert_array_equal(operands.group_ptr.numpy(), group_ptr)
    assert operands.n_barcodes == problem["n_barcodes"] > len(barcode_ptr) - 1
    np.testing.assert_array_equal(operands.barcode_ptr.numpy()[:len(barcode_ptr)], barcode_ptr)
    assert (operands.barcode_ptr.numpy()[len(barcode_ptr):] == n_groups).all()
    sizes = np.diff(group_ptr)
    assert sizes.min() == 1 and sizes.max() > 1, "groups of one molecule and of many"
    assert (np.diff(operands.barcode_ptr.numpy()) == 0).any(), "barcodes without a group"


def test_wrapper_runs_the_plain_version_on_the_cpu_and_raises_elsewhere():
    gprob, operands = aggregate_args(aggregate_problem(n_donors=4))
    launches = A.aggregated_logits.launches
    got = A.aggregated_logits(gprob, operands)
    assert torch.equal(got, A.aggregated_logits_plain(gprob, operands))
    assert A.aggregated_logits.launches == launches  # the plain version is no launch
    # unchecked operands run on the CPU too (there is nothing to check there)
    assert torch.equal(A.aggregated_logits(gprob, operands._replace(q=operands.q)), got)
    meta = operands._replace(**{name: getattr(operands, name).to("meta") for name in
                                ("pairs", "vid", "q", "group_ptr", "barcode_ptr")})
    with pytest.raises(ValueError, match="cpu or cuda"):
        A.aggregated_logits(gprob.to("meta"), meta)
    with pytest.raises(ValueError, match="is on cpu, expected meta"):
        A.aggregated_logits(gprob.to("meta"), operands)
    with pytest.raises(ValueError, match="genotype_prob must be"):
        A.aggregated_logits(gprob[1:], operands)
    with pytest.raises(ValueError, match="prior_logits must be"):
        A.aggregated_logits(gprob, operands, prior_logits=torch.zeros(3, 3))
    with pytest.raises(TypeError):
        A.aggregated_logits(gprob, tuple(operands))
    assert A.aggregated_logits.launches == launches


def test_operands_refuse_bad_shapes():
    problem = aggregate_problem(n_donors=2)
    _gprob, operands = aggregate_args(problem)
    args = (np.stack(L.pseudogenotype_pairs(2, 0.35)), 2, operands.vid, operands.q, operands.group_ptr,
            operands.barcode_ptr, 10, 0.5)
    assert isinstance(A.aggregate_operands(*args), A.CheckedAggregateOperands)
    with pytest.raises(ValueError, match="pairs"):
        A.aggregate_operands(np.zeros((3, 4), np.int32), *args[1:])
    with pytest.raises(ValueError, match="align"):
        A.aggregate_operands(args[0], 2, operands.vid[1:], *args[3:])
    with pytest.raises(ValueError, match="expected torch.int64"):
        A.aggregate_operands(*args[:5], operands.barcode_ptr.int(), *args[6:])
    with pytest.raises(ValueError, match="½e_i"):
        L.column_pairs(np.full((3, 2), 1 / 3, np.float32))


@pytest.mark.parametrize("softmax", [False, True])
@pytest.mark.parametrize("n_donors, doublet_prior", SHAPES)
def test_cpu_path_keeps_the_engine_bits(n_donors, doublet_prior, softmax):
    """The wrapper on the CPU: the engine's previous aggregate logits (+ prior, then torch.softmax), bit for bit."""
    problem = aggregate_problem(seed=n_donors, n_donors=n_donors, doublet_prior=doublet_prior)
    gprob, operands = aggregate_args(problem)
    layout = demux._SnpAggregationLayout.build(problem["calls"], torch.device("cpu"))
    mixing, _ = L.pseudogenotype_mixing([f"D{i}" for i in range(n_donors)], doublet_prior)
    # the engine's call before the kernel: the layout's host group pointers and run lengths
    groups_per_barcode = layout.barcode_ptr.diff()
    n_barcodes, reached = problem["n_barcodes"], groups_per_barcode.shape[0]
    before = L.snp_aggregated_logits(
        gprob, torch.from_numpy(mixing), layout.vid, layout.q, layout.group_ptr.numpy(), layout.group_ptr.diff(),
        torch.nn.functional.pad(groups_per_barcode, (0, n_barcodes - reached)), compensation=0.5)
    prior = t(np.random.RandomState(7).randn(*before.shape).astype(np.float32))
    before = before + prior
    got = A.aggregated_logits(gprob, operands, prior_logits=prior, softmax=softmax)
    if softmax:
        assert torch.equal(got[0], before) and torch.equal(got[1], torch.softmax(before, dim=-1))
    else:
        assert torch.equal(got, before)


def _butterfly(v, lanes):
    """v [..., lanes] after xor butterflies with offsets lanes / 2, ..., 1: every lane's a + b (== b + a), lane 0."""
    idx = torch.arange(lanes)
    o = lanes // 2
    while o > 0:
        v = v + v[..., idx ^ o]
        o //= 2
    return v[..., 0]


def _row_sums(e, team, cols):
    """S = Σ_k e[:, k] in the kernel's order: lane l of a warp holds columns K·32 + l, summed in K order, then the
    warp's butterfly (teams of 1-16 lanes reproduce this order, the first design's); at team 0 the row is split
    over warps of ``cols`` columns a lane, each warp's sum so, then the warps in warp order."""
    n, n_pg = e.shape
    per_lane = cols if team == 0 else -(-n_pg // 32)
    warps = -(-n_pg // (32 * per_lane))
    padded = torch.nn.functional.pad(e, (0, warps * per_lane * 32 - n_pg)).view(n, warps, per_lane, 32)
    lane = padded[:, :, 0]
    for k in range(1, per_lane):
        lane = lane + padded[:, :, k]
    warp = _butterfly(lane, 32)
    total = warp[:, 0]
    for w in range(1, warps):
        total = total + warp[:, w]
    return total


def _barcode_sums(z, barcode_ptr):
    """logits = each barcode's z rows added in group order, from zero."""
    counts = barcode_ptr.diff()
    n_barcodes = counts.shape[0]
    barcode = torch.repeat_interleave(torch.arange(n_barcodes), counts)
    rank = torch.arange(z.shape[0]) - barcode_ptr[barcode]
    rows = z.new_zeros((n_barcodes, z.shape[1]))
    for r in range(int(counts.max()) if n_barcodes else 0):
        at = torch.nonzero(rank == r).squeeze(1)
        rows[barcode[at]] = rows[barcode[at]] + z[at]
    return rows


def kernel_scheme_logits(gprob, operands, plan=None):
    """csrc/aggregate.cu's scheme in float32 torch at the instantiation ``plan`` (lanes a group, columns a lane;
    ``aggregate_plan``'s by default): call terms t = ½(G_i + G_j) + q; a group of one call's e its terms t; a
    longer group's x the log2(t) of its calls, one log each, summed in call order and scaled by 1 /
    n^compensation, e = 2^(x - max); S = Σ e in the kernel's order (T = Σ t for a group of one); z = ln 2 ·
    log2(e / S + escape) − log(1 + PG · escape) (Σ_k e^{y_k} = 1); logits = the groups' z summed per barcode in
    group order."""
    o = operands
    n_pg = o.pairs.shape[1]
    team, cols = plan or A.aggregate_plan(n_pg)
    g = gprob[o.vid.long()]
    terms = (g[:, o.pairs[0].long()] + g[:, o.pairs[1].long()]) * 0.5 + o.q[:, None]
    calls = o.group_ptr.diff()
    x = torch.segment_reduce(torch.log2(terms), "sum", lengths=calls, unsafe=True)
    x = x * (1.0 / calls.to(torch.float32).clamp(min=1.0) ** o.compensation)[:, None]
    e = torch.exp2(x - x.max(dim=1, keepdim=True).values)
    one = calls == 1  # the probability domain: e^{x - m} / S = t / T
    e[one] = terms[o.group_ptr[:-1][one]]
    escape = torch.tensor(o.p_bad_snp / n_pg, dtype=torch.float32)
    s = _row_sums(e, team, cols)
    z = torch.log2(e * (1.0 / s)[:, None] + escape) * math.log(2) - math.log1p(n_pg * float(escape))
    return _barcode_sums(z, o.barcode_ptr)


def _references(problem):
    """JAX's snp_aggregated_logits and the float64 oracle on ``problem``."""
    calls, n_barcodes, n_donors = problem["calls"], problem["n_barcodes"], problem["n_donors"]
    theirs = _jax_layout(calls)
    mixing, _ = L.pseudogenotype_mixing([f"D{i}" for i in range(n_donors)], problem["doublet_prior"])
    want = np.asarray(JL.snp_aggregated_logits(
        jnp.asarray(problem["gprob"]), jnp.asarray(mixing), theirs.vid_by_group, theirs.q_by_group,
        theirs.group_of_call, theirs.barcode_of_group, theirs.calls_per_group, n_groups=theirs.n_groups,
        n_barcodes=n_barcodes, compensation=0.5))
    oracle = oracle_snp_aggregated_logits(problem["gprob"].astype(np.float64), mixing.astype(np.float64),
                                          calls.variant_id, calls.p_base_wrong.astype(np.float64),
                                          calls.compressed_cb, calls.snp_id, n_barcodes)
    return (("jax", want), ("oracle", oracle))


def _held_to(got, references):
    softmax = lambda x: torch.softmax(torch.from_numpy(np.asarray(x, np.float64)), -1).numpy()  # noqa: E731
    for name, reference in references:
        np.testing.assert_allclose(got, reference, **LOGITS_TOL, err_msg=name)
        np.testing.assert_allclose(softmax(got), softmax(reference), atol=POSTERIOR_ATOL, err_msg=name)
        np.testing.assert_array_equal(got.argmax(1), np.asarray(reference).argmax(1), err_msg=name)


@pytest.mark.parametrize("n_donors, doublet_prior", SHAPES)
def test_kernel_scheme_matches_jax_and_oracle(n_donors, doublet_prior):
    problem = aggregate_problem(seed=10 + n_donors, n_donors=n_donors, doublet_prior=doublet_prior)
    calls = problem["calls"]
    gprob, operands = aggregate_args(problem)
    got = kernel_scheme_logits(gprob, operands).numpy()
    _held_to(got, _references(problem))
    empty = np.diff(operands.barcode_ptr.numpy()) == 0
    assert empty.any() and (got[empty] == 0).all()
    assert (problem["gprob"] == 0).all(axis=1).any() and calls.p_base_wrong.min() < 1e-6


# every instantiation that holds the row (its lanes a group T, its columns a lane), at the shapes above
TEAM_CASES = [(n_donors, prior, *plan) for n_donors, prior in SHAPES
              for plan in A.instantiations(n_donors * (n_donors + 1) // 2 if prior else n_donors)]


@pytest.mark.parametrize("n_donors, doublet_prior, team, cols", TEAM_CASES)
def test_kernel_scheme_at_every_team_matches_jax_and_oracle(n_donors, doublet_prior, team, cols):
    """The scheme at each instantiation (its S and barcode sum orders) on the edge barcodes: one group, fewer
    groups than teams, 31-33 and 62-65 groups, long groups beside groups of one, barcodes without calls."""
    problem = aggregate_problem(seed=20 + n_donors, n_donors=n_donors, doublet_prior=doublet_prior, n_calls=1500,
                                edges=True)
    gprob, operands = aggregate_args(problem)
    plan = (team, cols)
    got = kernel_scheme_logits(gprob, operands, plan).numpy()
    _held_to(got, _references(problem))
    empty = np.diff(operands.barcode_ptr.numpy()) == 0
    assert empty.sum() >= 3 and (got[empty] == 0).all()
    if plan == A.aggregate_plan(operands.n_columns):  # the default plan: the scheme's own bits
        assert torch.equal(torch.from_numpy(got), kernel_scheme_logits(gprob, operands))


# pools of one kind: every group of one call, or none (2-6 calls a group)
POOLS = {"groups_of_one": (1, 1), "no_group_of_one": (2, 6)}


@pytest.mark.parametrize("pool", POOLS)
@pytest.mark.parametrize("n_donors, doublet_prior", SHAPES)
def test_kernel_scheme_on_pools_of_one_kind_matches_jax_and_oracle(n_donors, doublet_prior, pool):
    """The scheme at every instantiation that holds the row on a pool whose groups all hold one call (the
    probability domain alone) and on one where none does (the log domain alone), with the edge barcodes that fit."""
    lo, hi = POOLS[pool]
    problem = aggregate_problem(seed=30 + n_donors, n_donors=n_donors, doublet_prior=doublet_prior, n_calls=1500,
                                edges=True, group_sizes=(lo, hi))
    gprob, operands = aggregate_args(problem)
    calls = operands.group_ptr.diff()
    assert int(calls.min()) == lo and int(calls.max()) == hi
    references = _references(problem)
    empty = np.diff(operands.barcode_ptr.numpy()) == 0
    for plan in A.instantiations(operands.n_columns):
        got = kernel_scheme_logits(gprob, operands, plan).numpy()
        _held_to(got, references)
        assert empty.sum() >= 3 and (got[empty] == 0).all()


def test_layout_counts_groups_and_groups_of_one():
    """``aggregate.groups`` and ``aggregate.single_groups`` grow by the layout's groups and its groups of one call."""
    from demuxalot_tpu_torch.utils import tracing

    shares = []
    for problem in (aggregate_problem(seed=3, edges=True), aggregate_problem(seed=4, group_sizes=(1, 1)),
                    aggregate_problem(seed=5, group_sizes=(2, 6))):
        before = tracing.snapshot()["counters"]
        layout = demux._SnpAggregationLayout.build(problem["calls"], torch.device("cpu"))
        after = tracing.snapshot()["counters"]
        calls = np.diff(layout.group_ptr.numpy())
        grew = {name: after.get(name, 0) - before.get(name, 0) for name in ("aggregate.groups",
                                                                           "aggregate.single_groups")}
        assert grew == {"aggregate.groups": len(calls), "aggregate.single_groups": int((calls == 1).sum())}
        shares.append(grew["aggregate.single_groups"] / grew["aggregate.groups"])
    assert 0 < shares[0] < 1 and shares[1:] == [1, 0]


def test_engine_paths_go_through_the_wrapper(monkeypatch):
    """_Likelihood (EM and predict) and the numpy helper call the wrapper; the EM caches its operands."""
    seen = []

    def spy(genotype_prob, operands, **kwargs):
        seen.append(kwargs.get("softmax", False))
        return A.aggregated_logits(genotype_prob, operands, **kwargs)

    monkeypatch.setattr(demux, "aggregated_logits", spy)
    monkeypatch.setattr(Demultiplexer, "device", "cpu")
    problem = aggregate_problem(n_donors=3)
    calls = problem["calls"]
    mixing, _ = L.pseudogenotype_mixing(["A", "B", "C"], 0.35)
    helper = Demultiplexer._compute_logits_aggregating_on_snps(problem["gprob"], mixing, None, calls,
                                                               problem["n_barcodes"])
    _gprob, operands = aggregate_args(problem)
    np.testing.assert_array_equal(helper, A.aggregated_logits_plain(_gprob, operands).numpy())
    assert seen == [False]


def test_em_takes_the_fused_call_on_cached_operands(monkeypatch):
    from demuxalot_tpu_torch import BarcodeHandler, sim

    calls_seen = []

    def spy(genotype_prob, operands, **kwargs):
        calls_seen.append((id(operands), kwargs.get("softmax", False), kwargs.get("prior_logits") is not None))
        return A.aggregated_logits(genotype_prob, operands, **kwargs)

    monkeypatch.setattr(demux, "aggregated_logits", spy)
    monkeypatch.setattr(Demultiplexer, "device", "cpu")
    monkeypatch.setattr(Demultiplexer, "aggregate_on_snps", True)
    genotypes, calls, _truth, _names = sim.synthesize_compressed_calls(60, 3, 80, 12, seed=2)
    handler = BarcodeHandler([f"BC{b:03d}" for b in range(60)])
    packed = Demultiplexer.pack_dataset(calls, genotypes)
    prior = np.random.RandomState(0).randn(60, 6).astype(np.float32)
    Demultiplexer.learn_genotypes_core(packed, genotypes, handler, n_iterations=3, doublet_prior=0.35,
                                       barcode_prior_logits=prior)
    Demultiplexer.learn_genotypes_core(packed, genotypes, handler, n_iterations=2, doublet_prior=0.35)
    # every E-step one fused call, the prior only at iteration 0, one set of operands for both runs
    assert [seen[1:] for seen in calls_seen] == [(True, True), (True, False), (True, False), (True, False),
                                                 (True, False)]
    assert len({seen[0] for seen in calls_seen}) == 1 and len(packed._aggregate_operands) == 1
    Demultiplexer.predict_posteriors_compact(packed, genotypes, handler, doublet_prior=0.0, k=2)
    assert calls_seen[-1][1:] == (False, False) and len(packed._aggregate_operands) == 2


@pytest.mark.parametrize("softmax, prior", [(False, False), (True, False), (True, True)])
def test_aggregate_roofline_counts_mufu_operations(softmax, prior):
    from demuxalot_tpu_torch.utils.profiling import H100_MUFU_LOGS_PER_S, AggregateRoofline

    n_calls, n_groups, n_barcodes, n_variants, n_donors, n_pg = 1000, 600, 50, 400, 32, 528
    bound = AggregateRoofline(n_calls, n_groups, n_barcodes, n_variants, n_donors, n_pg, softmax=softmax,
                              prior=prior)
    rows = 1 + softmax + prior
    assert bound.bytes_moved() == (8 * n_calls + 8 * (n_groups + 1) + 8 * (n_barcodes + 1)
                                   + 4 * n_variants * n_donors + 8 * n_pg + 4 * n_barcodes * n_pg * rows)
    # a log per (call, column), an exp and a log per (group, column), 2 per group
    assert bound.operations() == n_calls * n_pg + 2 * n_groups * n_pg + 2 * n_groups
    assert bound.speed_of_light_s() == bound.operations() / H100_MUFU_LOGS_PER_S
    assert bound.bound_by() == "operations"
    # the bench shape: ≈ 1.59 ms at 528 columns, ≈ 0.098 ms at 32
    bench = dict(n_calls=4_194_304, n_groups=4_192_197, n_barcodes=65_536, n_variants=131_072, n_donors=32)
    assert 1.58e-3 < AggregateRoofline(**bench, n_pseudogenotypes=528).speed_of_light_s() < 1.60e-3
    assert 0.097e-3 < AggregateRoofline(**bench, n_pseudogenotypes=32).speed_of_light_s() < 0.099e-3


def test_plan_picks_an_instantiation_that_holds_the_row():
    """aggregate_plan at every width up to 9,000 columns: one of TEAM_COLUMNS' instantiations that holds the row
    (teams and warps: lanes x columns; split: at most MAX_SPLIT_WARPS warps), the first design's at 257-544
    columns, the shared-memory row only past the split's widest."""
    widest_split = A.MAX_SPLIT_WARPS * 32 * max(A.TEAM_COLUMNS[0])
    for n_pg in range(1, 9000):
        plan = A.aggregate_plan(n_pg)
        assert plan in A.instantiations(n_pg), n_pg
        if 257 <= n_pg <= 544:
            assert plan == (32, 17)
        assert (plan == (32, 0)) == (n_pg > widest_split), n_pg
    with pytest.raises(ValueError, match="positive"):
        A.aggregate_plan(0)


def test_team_columns_are_the_sources_instantiations():
    """TEAM_COLUMNS names exactly the instantiations csrc/aggregate.cu's pick() launches."""
    import re

    from demuxalot_tpu_torch.ops import _cuda

    source = next(s for s in _cuda.sources() if s.name == "aggregate.cu").read_text()
    cols_max = int(re.search(r"kMaxRegisterCols = (\d+);", source).group(1))
    built = {(int(team), cols_max if cols == "kMaxRegisterCols" else int(cols))
             for team, cols in re.findall(r"DEMUX_AGGREGATE\((\d+), (\w+)\)", source)}
    assert built == {(team, cols) for team, options in A.TEAM_COLUMNS.items() for cols in options}
    assert int(re.search(r"kMaxSplitWarps = (\d+);", source).group(1)) == A.MAX_SPLIT_WARPS


def test_regrouping_many_molecules_keeps_the_calls():
    """chip_smoke's case of groups of many molecules: the same calls in groups of 8 within each barcode."""
    import importlib.util
    from pathlib import Path

    spec = importlib.util.spec_from_file_location("chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    _gprob, operands = aggregate_args(aggregate_problem(n_donors=3, edges=True))
    regrouped = smoke._regrouped(operands, 8)
    sizes = regrouped.group_ptr.diff().numpy()
    assert sizes.max() == 8 and sizes.min() >= 1 and torch.equal(regrouped.vid, operands.vid)
    calls_of = lambda o: (o.group_ptr[o.barcode_ptr[1:]] - o.group_ptr[o.barcode_ptr[:-1]])  # noqa: E731
    assert torch.equal(calls_of(regrouped), calls_of(operands))
    assert int((regrouped.barcode_ptr.diff() == 0).sum()) == int((operands.barcode_ptr.diff() == 0).sum())
