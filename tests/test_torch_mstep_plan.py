"""The M-step's work plan (``ops.mstep_kernel.mstep_plan``) and its summation contract, on the CPU.

The plan cuts a dataset's calls into the kernel's units: whole SNP runs
(each variant a run without SNP runs) where no variant holds more than
C = ``CHUNK_CALLS`` calls, else one unit per chunk of C calls of each
variant of the run, heaviest units first. ``tests/torch_problems.py``'s
``in_order_addition`` gives the kernel's bits in PyTorch: here it is held
to the single chain wherever no variant exceeds C, to a scalar float32
transcription of the contract, and to a float64 sum on a 100,000-call
variant. The kernel against it, bit for bit, is in tests/test_torch_gpu.py.
"""
import re

import numpy as np
import pytest
import torch

from demuxalot_tpu_torch.ops import _cuda, mstep_kernel
from demuxalot_tpu_torch.ops.mstep_kernel import CHUNK_CALLS, mstep_plan
from demuxalot_tpu_torch.utils import tracing
from demuxalot_tpu_torch.ops.mstep_kernel import mstep_operands as build_mstep_operands
from demuxalot_tpu_torch.ops.packing import csr_row_pointers
from torch_problems import HEAVY_CALLS, in_order_addition, mstep_operands, t, update_problem

C = CHUNK_CALLS


def _operands(p, runs=True):
    return mstep_operands(p["vid"], p["cb"], p["q"], p["n_variants"], len(p["post"]),
                          snp_ptr=p["snp_ptr"] if runs else None)


def _runs(o) -> np.ndarray:
    return o.snp_ptr.numpy() if o.snp_ptr is not None else np.arange(o.n_variants + 1)


def _units(o) -> list:
    """The kernel's units in launch order: the plan's table."""
    return o.plan.units.tolist()


def _unit_calls(o) -> list:
    """[(unit, [lo, hi) of each variant part it sums)] in launch order."""
    var_ptr, run_ptr = o.var_ptr.numpy(), _runs(o)
    chunks = o.plan.chunks.numpy()
    out = []
    for unit in _units(o):
        if unit >= 0:
            out.append((unit, [(var_ptr[v], var_ptr[v + 1]) for v in range(run_ptr[unit], run_ptr[unit + 1])]))
        else:
            v, k, _s = chunks[-1 - unit]
            lo = var_ptr[v] + k * C
            out.append((unit, [(lo, min(lo + C, var_ptr[v + 1]))]))
    return out


PLANNED = [dict(heavy=True, runs=(1, 2, 6)), dict(heavy=True, runs=(2,)), dict(heavy=False, runs=(1, 2, 6))]


@pytest.mark.parametrize("with_runs", [True, False])
@pytest.mark.parametrize("case", PLANNED, ids=["heavy", "heavy_pairs", "short"])
def test_every_call_lies_in_exactly_one_unit(case, with_runs):
    o = _operands(update_problem(seed=2, **case), with_runs)
    covered = np.zeros(o.cb.shape[0], dtype=np.int64)
    for _unit, parts in _unit_calls(o):
        for lo, hi in parts:
            covered[lo:hi] += 1
    assert (covered == 1).all()


@pytest.mark.parametrize("with_runs", [True, False])
def test_chunks_hold_at_most_c_calls_in_call_order(with_runs):
    o = _operands(update_problem(seed=3, heavy=True), with_runs)
    var_ptr = o.var_ptr.numpy()
    chunks = o.plan.chunks.numpy()
    assert len(chunks) == o.plan.n_chunks > 0
    for v in np.unique(chunks[:, 0]):
        mine = chunks[chunks[:, 0] == v]
        n = var_ptr[v + 1] - var_ptr[v]
        # the variant's chunks are 0, 1, ... in slot order: C calls each from var_ptr[v] + k·C, the last the rest
        assert mine[:, 1].tolist() == list(range(len(mine)))
        assert len(mine) == max(1, -(-n // C)) and (len(mine) - 1) * C <= n
    # slots run by split run, then variant, then chunk
    order = np.lexsort((chunks[:, 1], chunks[:, 0], chunks[:, 2]))
    assert (order == np.arange(len(chunks))).all()


@pytest.mark.parametrize("with_runs", [True, False])
@pytest.mark.parametrize("case", PLANNED, ids=["heavy", "heavy_pairs", "short"])
def test_whole_run_units_are_the_runs_with_no_long_variant(case, with_runs):
    o = _operands(update_problem(seed=4, **case), with_runs)
    counts, run_ptr = np.diff(o.var_ptr.numpy()), _runs(o)
    long = [bool((counts[run_ptr[r]:run_ptr[r + 1]] > C).any()) for r in range(len(run_ptr) - 1)]
    whole = sorted(u for u in _units(o) if u >= 0)
    assert whole == [r for r, is_long in enumerate(long) if not is_long]
    assert sorted(o.plan.split_runs.numpy()[:, 0].tolist()) == [r for r, is_long in enumerate(long) if is_long]
    if not case["heavy"]:  # no chunks: every run is a unit
        assert o.plan.n_chunks == 0 and sorted(_units(o)) == list(range(len(run_ptr) - 1))


@pytest.mark.parametrize("with_runs", [True, False])
@pytest.mark.parametrize("heavy", [True, False])
def test_units_come_heaviest_first(heavy, with_runs):
    """Heaviest first with chunks and without: one order, whatever the pool."""
    o = _operands(update_problem(seed=5, heavy=heavy), with_runs)
    weights = [sum(hi - lo for lo, hi in parts) for _unit, parts in _unit_calls(o)]
    assert weights == sorted(weights, reverse=True)
    if heavy and not with_runs:
        assert weights[0] == C  # a variant of C calls, and full chunks
    # ties keep whole runs before chunks, each in run or slot order
    units = _units(o)
    for a, b, wa, wb in zip(units, units[1:], weights, weights[1:]):
        if wa == wb:
            assert (a >= 0 and b >= 0 and a < b) or (a < 0 and b < 0 and a > b) or (a >= 0 > b)


@pytest.mark.parametrize("with_runs", [True, False])
def test_one_ticket_per_split_run(with_runs):
    o = _operands(update_problem(seed=6, heavy=True), with_runs)
    plan = o.plan
    table = plan.split_runs.numpy()
    chunks = plan.chunks.numpy()
    assert plan.tickets.dtype == torch.int32 and plan.tickets.shape == (len(table),)
    assert not plan.tickets.any()
    # each split run's slots: a contiguous range of the chunk table, all its chunks
    for s, (run, first, n) in enumerate(table):
        assert (chunks[first:first + n, 2] == s).all()
        assert (np.delete(chunks[:, 2], np.s_[first:first + n]) != s).all()
        run_ptr = _runs(o)
        assert set(chunks[first:first + n, 0]) == set(range(run_ptr[run], run_ptr[run + 1]))
    assert table[:, 2].sum() == len(chunks)


def test_edge_counts_and_empty_variants():
    """Variants of C − 1, C, C + 1, 2C + 1 and 100,000 calls, and an empty one, in runs of 2, 6 and 1."""
    p = update_problem(seed=7, heavy=True)
    o = _operands(p)
    counts = np.diff(o.var_ptr.numpy())
    exact = HEAVY_CALLS >= 0
    assert (counts[:10][exact] == HEAVY_CALLS[exact]).all()
    per_variant = np.bincount(o.plan.chunks.numpy()[:, 0], minlength=o.n_variants)
    # run of 2 (C − 1, C + 1): split, the short variant one chunk; run of 6: 100,000 calls in ⌈100,000 / C⌉, the
    # empty variant one chunk of 0 calls, C one chunk, 2C + 1 three; runs of 1: C whole, C + 1 two chunks
    assert per_variant[:10].tolist() == [1, 2, -(-100_000 // C), 1, 1, 3, 1, 1, 0, 2]
    units = _units(o)
    assert 2 in units and 3 not in units and 0 not in units and 1 not in units
    weights = dict(_unit_calls(o))
    empty = [u for u in units if u < 0 and o.plan.chunks[-1 - u, 0] == 3]
    assert len(empty) == 1 and weights[empty[0]][0][0] == weights[empty[0]][0][1]
    assert o.plan.split_calls == int(counts[counts > C].sum()) == C + 1 + 100_000 + 2 * C + 1 + C + 1


def test_plan_of_no_variant():
    units, chunks, table, split_calls = mstep_plan(np.zeros(1, np.int64))
    assert units.shape == (0,) and chunks.shape == (0, 3) and table.shape == (0, 3) and split_calls == 0


def test_plan_at_another_chunk_size(monkeypatch):
    """The plan follows CHUNK_CALLS: a variant of n calls is ceil(n / CHUNK_CALLS) chunks once n > CHUNK_CALLS."""
    monkeypatch.setattr(mstep_kernel, "CHUNK_CALLS", 3)
    var_ptr = np.array([0, 3, 3, 10, 11], dtype=np.int64)  # 3, 0, 7, 1 calls
    units, chunks, table, split_calls = mstep_plan(var_ptr, np.array([0, 2, 4]))
    assert chunks.tolist() == [[2, 0, 0], [2, 1, 0], [2, 2, 0], [3, 0, 0]]
    assert table.tolist() == [[1, 0, 4]] and split_calls == 7
    assert units.tolist() == [0, -1, -2, -3, -4]  # run 0 (3 calls), then chunks of 3, 3, 1 and 1 calls


def test_chunked_reference_is_the_single_chain_without_long_variants():
    p = update_problem(seed=8, runs=(1, 2, 6))
    o = _operands(p)
    assert int(o.var_ptr.diff().max()) <= C
    post = t(p["post"])
    for power in (1.0, 2.0, 0.5):
        assert torch.equal(in_order_addition(post, o, p["n_donors"], power),
                           in_order_addition(post, o, p["n_donors"], power, chunk=None))


def _scalar_contract(post, vid, cb, q, n_variants, n_donors, chunk):
    """The summation contract one float32 operation at a time (numpy scalars), for small problems."""
    out = np.zeros((n_variants, n_donors), dtype=np.float32)
    for v in range(n_variants):
        mine = np.flatnonzero(vid == v)
        for d in range(n_donors):
            total = np.float32(0)
            for start in range(0, len(mine), chunk):
                acc = np.float32(0)
                for c in mine[start:start + chunk]:
                    w = np.float32(post[cb[c], d] * np.float32(np.float32(1) - q[c]))
                    term = np.float32(0) if q[c] >= 1 else np.float32(w * w)
                    acc = np.float32(acc + np.float32(term))
                total = np.float32(total + acc)
            out[v, d] = total
    return out


@pytest.mark.parametrize("chunk", [1, 3, 7, 1000])
def test_chunked_reference_is_the_contract(chunk):
    p = update_problem(seed=9, runs=(1, 2), n_snps=8, n_calls=300, n_donors=3)
    o = _operands(p)
    got = in_order_addition(t(p["post"]), o, p["n_donors"], 2.0, chunk=chunk)
    want = _scalar_contract(p["post"], p["vid"], p["cb"], p["q"], p["n_variants"], p["n_donors"], chunk)
    assert np.array_equal(got.numpy(), want)


def test_chunked_reference_on_a_long_variant_against_float64():
    p = update_problem(seed=10, heavy=True)
    o = _operands(p)
    post = t(p["post"])
    got = in_order_addition(post, o, p["n_donors"], 2.0)
    q = o.q.double().unsqueeze(1)
    terms = torch.where(q >= 1, 0.0, (post.double()[o.cb.long(), :p["n_donors"]] * (1 - q)) ** 2)
    want = torch.zeros((o.n_variants, p["n_donors"]), dtype=torch.float64).index_add_(0, o.vid.long(), terms)
    assert int(o.var_ptr.diff().max()) >= 100_000
    np.testing.assert_allclose(got[2].double().numpy(), want[2].numpy(), rtol=1e-6)


@pytest.mark.parametrize("heavy", [True, False])
def test_split_counters(heavy):
    tracing.reset()
    p = update_problem(seed=11, heavy=heavy)
    o = _operands(p)
    counters = tracing.snapshot()["counters"]
    assert counters["mstep.split_calls"] == o.plan.split_calls
    assert counters["mstep.split_units"] == o.plan.n_chunks
    if heavy:
        assert counters["mstep.split_calls"] > 100_000 and counters["mstep.split_units"] > 100_000 // C
    else:
        assert counters["mstep.split_calls"] == counters["mstep.split_units"] == 0
    # each build adds its plan's counts
    again = _operands(p, runs=False)
    assert tracing.snapshot()["counters"]["mstep.split_units"] == o.plan.n_chunks + again.plan.n_chunks
    tracing.reset()


def test_chunk_calls_is_the_sources_constant():
    source = next(s for s in _cuda.sources() if s.name == "mstep.cu").read_text()
    assert int(re.search(r"kChunkCalls = (\d+);", source).group(1)) == CHUNK_CALLS


def test_engine_operands_carry_the_plan(monkeypatch):
    """The EM loop's operands carry the plan, and its tensors are among those the loop uploads."""
    from demuxalot_tpu_torch import BarcodeHandler, Demultiplexer, sim
    from demuxalot_tpu_torch.models.demux import _EMRun

    monkeypatch.setattr(Demultiplexer, "device", "cpu")
    genotypes, calls, _truth, _names = sim.synthesize_compressed_calls(60, 4, 100, 12, seed=3)
    run = _EMRun(calls, genotypes, BarcodeHandler([f"BC{b:03d}" for b in range(60)]), 2, 0.01, 0.35, None)
    operands = run.likelihood.mstep
    plan = operands.plan
    assert plan is not None and plan.n_chunks == 0
    assert sorted(plan.units.tolist()) == list(range(operands.snp_ptr.numel() - 1))
    # the slots at the run's donor count are made in its set-up
    assert list(operands.partials) == [run.n_genotypes]
    tensors = run.likelihood.tensors()
    assert all(any(x is y for y in tensors) for x in [*plan.tensors(), *operands.partials.values()])


@pytest.mark.parametrize("with_runs", [True, False])
def test_plan_from_host_pointers_is_the_plan_from_the_tensors(with_runs):
    """``host_ptrs`` (var_ptr and snp_ptr as the caller holds them on the host) give the plan and the run checks
    that copies of the tensors give."""
    p = update_problem(seed=12, heavy=True)
    var_ptr = csr_row_pointers(p["vid"], p["n_variants"])
    snp_ptr = p["snp_ptr"] if with_runs else None
    built = _operands(p, with_runs)
    given = build_mstep_operands(t(var_ptr), t(p["vid"]), t(p["cb"]), t(p["q"]), len(p["post"]),
                                 snp_ptr=None if snp_ptr is None else t(snp_ptr), host_ptrs=(var_ptr, snp_ptr))
    for a, b in zip(built.plan.tensors(), given.plan.tensors()):
        assert torch.equal(a, b)
    assert built.plan.split_calls == given.plan.split_calls and built.max_per_snp == given.max_per_snp
    if with_runs:
        assert torch.equal(built.variant_run, given.variant_run)


def test_host_pointers_must_match_the_tensors():
    p = update_problem(seed=13)
    var_ptr = csr_row_pointers(p["vid"], p["n_variants"])
    args = (t(var_ptr), t(p["vid"]), t(p["cb"]), t(p["q"]), len(p["post"]))
    with pytest.raises(ValueError, match="host_ptrs"):
        build_mstep_operands(*args, snp_ptr=t(p["snp_ptr"]), host_ptrs=(var_ptr, None))
    with pytest.raises(ValueError, match="host_ptrs"):
        build_mstep_operands(*args, host_ptrs=(var_ptr[:-1], None))
    with pytest.raises(ValueError, match="snp_ptr must cut"):
        bad = p["snp_ptr"].copy()
        bad[-1] += 1
        build_mstep_operands(*args, snp_ptr=t(bad), host_ptrs=(var_ptr, bad))


def test_slots_are_made_once_per_donor_count():
    o = _operands(update_problem(seed=14, heavy=True))
    first = o.slots(6)
    assert first.shape == (o.plan.n_chunks, 6) and first.dtype == torch.float32
    assert o.slots(6) is first and o.slots(3).shape == (o.plan.n_chunks, 3) and sorted(o.partials) == [3, 6]
