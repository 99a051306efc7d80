"""Random inputs for the port's kernel tests, made by numpy from a seed (no jax)."""
import numpy as np
import torch

from demuxalot_tpu_torch.ops.likelihood_kernel import estep_operands
from demuxalot_tpu_torch.ops.mstep_kernel import mstep_operands as build_mstep_operands
from demuxalot_tpu_torch.ops.packing import csr_row_pointers
from oracle import oracle_probs_from_betas


def t(array, device="cpu"):
    return torch.from_numpy(np.ascontiguousarray(array)).to(device)


def offset_view(values: torch.Tensor, offset: int) -> torch.Tensor:
    """``values`` in a contiguous tensor that starts ``offset`` elements into a larger buffer on the same device
    (offset 1 puts 4-byte elements off every 16-byte boundary)."""
    if offset == 0:
        return values
    buffer = torch.empty(values.numel() + offset, dtype=values.dtype, device=values.device)
    view = buffer[offset:].view(values.shape)
    view.copy_(values)
    return view


def side_stream_and_replay(fn) -> tuple:
    """(``fn()`` under ``torch.cuda.stream(side)``, a captured ``fn()``'s output after its CUDA graph's replay)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        on_side = fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = fn()
    captured.fill_(float("nan"))  # the replay, not the capture, must write it
    graph.replay()
    torch.cuda.synchronize()
    return on_side, captured.clone()


def estep_problem(seed=0, n_snps=100, n_donors=8, n_barcodes=100, n_calls=6000, doublet_prior=0.35):
    rng = np.random.RandomState(seed)
    n_variants = n_snps * 2
    variant2snp = np.repeat(np.arange(n_snps, dtype=np.int32), 2)
    betas = (rng.rand(n_variants, n_donors) * 50).astype(np.float32)
    vid = rng.randint(0, n_variants, n_calls).astype(np.int32)
    cb = np.sort(rng.randint(0, n_barcodes, n_calls)).astype(np.int32)
    q = (rng.rand(n_calls) * 0.5).astype(np.float32)
    gprob = oracle_probs_from_betas(variant2snp, betas, 0.01)
    return gprob, vid, cb, q, n_barcodes, n_donors, doublet_prior


def estep_args(problem, device="cpu"):
    """(genotype_prob, EStepOperands) of an :func:`estep_problem` on ``device``."""
    gprob, vid, cb, q, n_barcodes, n_donors, doublet_prior = problem
    operands = estep_operands(
        n_donors, doublet_prior, t(csr_row_pointers(cb, n_barcodes), device),
        t(cb, device), t(vid, device), t(q, device),
    )
    return t(gprob, device), operands


def mstep_problem(seed=13, n_variants=300, n_donors=6, n_barcodes=150, n_calls=20000):
    rng = np.random.RandomState(seed)
    vid = rng.randint(0, n_variants, n_calls).astype(np.int32)
    cb = rng.randint(0, n_barcodes, n_calls).astype(np.int32)
    q = (rng.rand(n_calls) * 0.7).astype(np.float32)
    n_pg = n_donors + n_donors * (n_donors - 1) // 2
    post = rng.rand(n_barcodes, n_pg).astype(np.float32)
    post /= post.sum(axis=1, keepdims=True)
    order = np.argsort(vid, kind="stable")
    return post, vid[order], cb[order], q[order], n_variants, n_donors


def update_problem(seed=17, n_donors=6, runs=(1, 2, 6), n_snps=60, n_barcodes=150, n_calls=20000):
    """An EM step's M-step inputs with SNP runs whose lengths are drawn from ``runs``.

    Every 7th variant has no calls, every 53rd call is padding (q = 1), every
    5th variant's prior is 0 and 3 variants in 10 are off the anchor mask.
    Calls are (vid, cb)-sorted; ``snp_ptr`` cuts the variant rows into runs.
    """
    rng = np.random.RandomState(seed)
    lengths = rng.choice(np.asarray(runs), n_snps)
    variant2snp = np.repeat(np.arange(n_snps, dtype=np.int32), lengths)
    n_variants = len(variant2snp)
    vid = rng.randint(0, n_variants, n_calls).astype(np.int32)
    cb = rng.randint(0, n_barcodes, n_calls).astype(np.int32)
    keep = vid % 7 != 3
    vid, cb = vid[keep], cb[keep]
    q = (rng.rand(len(vid)) * 0.7).astype(np.float32)
    q[::53] = 1.0
    n_pg = n_donors + n_donors * (n_donors - 1) // 2
    post = rng.rand(n_barcodes, n_pg).astype(np.float32)
    post /= post.sum(axis=1, keepdims=True)
    prior = (rng.rand(n_variants, n_donors) * 5).astype(np.float32)
    prior[::5] = 0.0
    mask = (rng.rand(n_variants, 1) >= 0.3).astype(np.float32)
    order = np.lexsort((cb, vid))
    return dict(post=post, vid=vid[order], cb=cb[order], q=q[order], n_variants=n_variants, n_donors=n_donors,
                variant2snp=variant2snp, n_snps=n_snps, snp_ptr=np.concatenate([[0], np.cumsum(lengths)]),
                prior=prior, mask=mask, max_per_snp=int(lengths.max()))


def mstep_operands(vid, cb, q, n_variants, n_barcodes, device="cpu", snp_ptr=None):
    """Checked MStepOperands of (vid, cb)-sorted calls on ``device`` (with SNP runs where ``snp_ptr`` is given)."""
    return build_mstep_operands(t(csr_row_pointers(vid, n_variants), device), t(vid, device), t(cb, device),
                                t(q, device), n_barcodes, snp_ptr=None if snp_ptr is None else t(snp_ptr, device))


def in_order_addition(posterior, operands, n_genotypes, power):
    """The M-step addition as the kernels define it, in PyTorch: each (v, d) sum one chain in call order.

    Step k adds every variant's k-th call: ``w = post·(1 − q)``, the term
    ``w ** power`` (0 where q ≥ 1) and ``acc + term``, each its own op, so
    every multiply and add is rounded on its own, as in ``csrc/mstep.cu``.
    """
    o = operands
    counts = o.var_ptr.diff()
    rank = torch.arange(o.cb.shape[0], device=o.cb.device) - o.var_ptr[o.vid.long()]
    acc = posterior.new_zeros((o.n_variants, n_genotypes))
    for k in range(int(counts.max()) if counts.numel() else 0):
        calls = torch.nonzero(rank == k).squeeze(1)
        q = o.q[calls].unsqueeze(1)
        w = posterior[o.cb[calls].long(), :n_genotypes] * (1 - q)
        term = torch.where(q >= 1, 0.0, w ** power)
        rows = o.vid[calls].long()
        acc[rows] = acc[rows] + term
    return acc


def aggregate_problem(seed=0, n_donors=4, doublet_prior=0.35, n_barcodes=60, n_snps=2000, n_calls=3000, q_low=1e-7,
                      zero_rows=0.1):
    """Molecule calls for the aggregate E-step: barcodes b % 3 == 0 call 4 SNPs only (groups of many molecules),
    the others any of ``n_snps`` (groups of one, mostly); barcodes b % 7 == 3 and the last 5 have no call; q
    down to ``q_low``; a ``zero_rows`` share of the genotype rows is 0 (an unclipped table, p = 0)."""
    from demuxalot_tpu_torch.ops.packing import MoleculeCalls

    rng = np.random.RandomState(seed)
    barcodes = np.array([b for b in range(n_barcodes - 5) if b % 7 != 3])
    cb = rng.choice(barcodes, n_calls)
    snp = np.where(cb % 3 == 0, rng.randint(0, 4, n_calls), rng.randint(0, n_snps, n_calls))
    vid = 2 * snp + rng.randint(0, 2, n_calls)
    q = np.exp(rng.uniform(np.log(q_low), np.log(0.3), n_calls))
    gprob = rng.uniform(0.01, 0.99, (2 * n_snps, n_donors))
    gprob[rng.rand(2 * n_snps) < zero_rows] = 0.0
    calls = MoleculeCalls(variant_id=vid.astype(np.int32), snp_id=snp.astype(np.int32),
                          compressed_cb=cb.astype(np.int32), molecule_id=np.arange(n_calls, dtype=np.int32),
                          p_base_wrong=q.astype(np.float32), p_molecule_aligned_wrong=np.zeros(n_calls, np.float32))
    return dict(gprob=gprob.astype(np.float32), calls=calls, n_barcodes=n_barcodes, n_donors=n_donors,
                doublet_prior=doublet_prior)


def aggregate_args(problem, device="cpu"):
    """(genotype_prob, checked AggregateOperands) of an :func:`aggregate_problem` on ``device``, through the engine's
    layout."""
    from demuxalot_tpu_torch.models.demux import _SnpAggregationLayout
    from demuxalot_tpu_torch.ops.likelihood import pseudogenotype_pairs

    gprob, n_donors = problem["gprob"], problem["n_donors"]
    pairs = np.stack(pseudogenotype_pairs(n_donors, problem["doublet_prior"]))
    layout = _SnpAggregationLayout.build(problem["calls"], torch.device(device))
    return t(gprob, device), layout.operands(problem["n_barcodes"], pairs, n_donors, gprob.shape[0])
