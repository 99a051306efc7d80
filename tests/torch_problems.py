"""Random inputs for the port's kernel tests, made by numpy from a seed (no jax)."""
import numpy as np
import torch

from demuxalot_tpu_torch.ops.likelihood_kernel import estep_operands
from demuxalot_tpu_torch.ops.mstep_kernel import CHUNK_CALLS
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
        t(cb, device), t(vid, device), t(q, device), len(gprob),
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


# calls of the first 10 variants of update_problem(heavy=True) (-1: drawn; variant 3, the 7th's, has none)
HEAVY_CALLS = np.array([CHUNK_CALLS - 1, CHUNK_CALLS + 1, 100_000, 0, CHUNK_CALLS, 2 * CHUNK_CALLS + 1, -1, -1,
                        CHUNK_CALLS, CHUNK_CALLS + 1])


def update_problem(seed=17, n_donors=6, runs=(1, 2, 6), n_snps=60, n_barcodes=150, n_calls=20000, heavy=False):
    """An EM step's M-step inputs with SNP runs whose lengths are drawn from ``runs``.

    Every 7th variant has no calls, every 53rd call is padding (q = 1), every
    5th variant's prior is 0 and 3 variants in 10 are off the anchor mask.
    Calls are (vid, cb)-sorted; ``snp_ptr`` cuts the variant rows into runs.
    With ``heavy``, four runs come first that hold variants of around
    C = ``CHUNK_CALLS`` calls and more (``HEAVY_CALLS``), the drawn runs after
    them: a run of 2 (C − 1 and C + 1 calls), a run of 6 (100,000 calls, an
    empty variant, C and 2C + 1 calls, two drawn ones) and runs of 1 of C
    and of C + 1 calls.
    """
    rng = np.random.RandomState(seed)
    lengths = rng.choice(np.asarray(runs), n_snps)
    if heavy:
        lengths = np.concatenate([[2, 6, 1, 1], lengths])
        n_snps += 4
    variant2snp = np.repeat(np.arange(n_snps, dtype=np.int32), lengths)
    n_variants = len(variant2snp)
    vid = rng.randint(0, n_variants, n_calls).astype(np.int32)
    cb = rng.randint(0, n_barcodes, n_calls).astype(np.int32)
    if heavy:
        exact = np.flatnonzero(HEAVY_CALLS >= 0)
        keep = ~np.isin(vid, exact)
        extra = np.repeat(exact, HEAVY_CALLS[exact]).astype(np.int32)
        vid = np.concatenate([vid[keep], extra])
        cb = np.concatenate([cb[keep], rng.randint(0, n_barcodes, len(extra)).astype(np.int32)])
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


def in_order_addition(posterior, operands, n_genotypes, power, chunk=CHUNK_CALLS):
    """The M-step addition as the kernels define it, in PyTorch: a variant's calls cut in call order into chunks
    of ``chunk`` (None: one chunk a variant), each chunk's sum one chain in call order from +0, and the chunk
    sums one chain in chunk order from +0. A variant of at most ``chunk`` calls is one chain in call order.

    Step k adds the k-th call of every chunk: ``w = post·(1 − q)``, the term
    ``w ** power`` (0 where q ≥ 1) and ``acc + term``, each its own op, so
    every multiply and add is rounded on its own, as in ``csrc/mstep.cu``;
    then step j adds every variant's j-th chunk sum.
    """
    o = operands
    counts = o.var_ptr.diff()
    longest = int(counts.max()) if counts.numel() else 0
    size = max(1, longest) if chunk is None else chunk
    rank = torch.arange(o.cb.shape[0], device=o.cb.device) - o.var_ptr[o.vid.long()]
    per_variant = (counts + size - 1) // size
    first = per_variant.cumsum(0) - per_variant  # the variant's first chunk
    slot = first[o.vid.long()] + rank // size
    position = rank % size
    sums = posterior.new_zeros((int(per_variant.sum()), n_genotypes))
    for k in range(min(size, longest)):
        calls = torch.nonzero(position == k).squeeze(1)
        q = o.q[calls].unsqueeze(1)
        w = posterior[o.cb[calls].long(), :n_genotypes] * (1 - q)
        term = torch.where(q >= 1, 0.0, w ** power)
        rows = slot[calls]
        sums[rows] = sums[rows] + term
    acc = posterior.new_zeros((o.n_variants, n_genotypes))
    for j in range(int(per_variant.max()) if per_variant.numel() else 0):
        variants = torch.nonzero(per_variant > j).squeeze(1)
        acc[variants] = acc[variants] + sums[first[variants] + j]
    return acc


def float64_update(p, operands, mask, power, device="cpu"):
    """probs_from_betas(prior + addition·mask) with the addition summed in float64 (index_add_): where a variant has
    100,000 calls (``update_problem(heavy=True)``) the float32 plain path's own rounding moves genotype_prob by more
    than 1e-6, so that bar is held against this."""
    from demuxalot_tpu_torch.ops.likelihood import probs_from_betas

    o, n_donors = operands, p["n_donors"]
    q = o.q.double().unsqueeze(1)
    w = t(p["post"], device).double()[o.cb.long(), :n_donors] * (1 - q)
    terms = torch.where(q >= 1, 0.0, w ** power)
    addition = torch.zeros((o.n_variants, n_donors), dtype=torch.float64, device=device).index_add_(
        0, o.vid.long(), terms)
    if mask is not None:
        addition = addition * mask.double()
    return probs_from_betas(t(p["prior"], device).double() + addition, t(p["variant2snp"], device), p["n_snps"], 0.01,
                            p["max_per_snp"])


# the edge barcodes of aggregate_problem(edges=True): each a list of group sizes (calls of one SNP a group). One
# group and fewer groups than a warp has teams; 31, 32 and 33 groups and 62-65 (the kernel's windows of 31 and 32
# groups, its rounds of 2-32 groups); one long group beside groups of one (past a 32-call tile, a round of over
# 32 calls), one in the middle of them, and groups of many molecules
AGGREGATE_EDGE_GROUPS = ([1], [1] * 3, [1] * 31, [1] * 32, [1] * 33, [1] * 62, [1] * 63, [2] * 64, [1] * 65,
                         [100] + [1] * 20, [1] * 5 + [40] + [1] * 10, [7] * 9, [33, 1, 31])


def aggregate_problem(seed=0, n_donors=4, doublet_prior=0.35, n_barcodes=60, n_snps=2000, n_calls=3000, q_low=1e-7,
                      zero_rows=0.1, edges=False, group_sizes=None):
    """Molecule calls for the aggregate E-step: barcodes b % 3 == 0 call 4 SNPs only (groups of many molecules),
    the others any of ``n_snps`` (groups of one, mostly); barcodes b % 7 == 3 and the last 5 have no call; q
    down to ``q_low``; a ``zero_rows`` share of the genotype rows is 0 (an unclipped table, p = 0). With
    ``group_sizes`` (lo, hi), every group instead holds lo to hi calls (uniform), about ``n_calls`` in all, each
    group on its own SNP of a random barcode: (1, 1) gives a pool of groups of one only, lo >= 2 one without them.
    With ``edges``, one barcode for each entry of ``AGGREGATE_EDGE_GROUPS`` (those whose groups all hold lo to hi
    calls, with ``group_sizes``) follows the random ones, then 3 more without a call."""
    from demuxalot_tpu_torch.ops.packing import MoleculeCalls

    rng = np.random.RandomState(seed)
    barcodes = np.array([b for b in range(n_barcodes - 5) if b % 7 != 3])
    edge_groups = AGGREGATE_EDGE_GROUPS
    if group_sizes is None:
        cb = rng.choice(barcodes, n_calls)
        snp = np.where(cb % 3 == 0, rng.randint(0, 4, n_calls), rng.randint(0, n_snps, n_calls))
    else:
        lo, hi = group_sizes
        sizes = rng.randint(lo, hi + 1, n_calls)
        sizes = sizes[:np.searchsorted(np.cumsum(sizes), n_calls) + 1]
        group_cb = rng.choice(barcodes, len(sizes))
        rank = np.empty(len(sizes), dtype=np.int64)  # each group's rank among its barcode's groups: its own SNP
        by_cb = np.argsort(group_cb, kind="stable")
        starts = np.searchsorted(group_cb[by_cb], group_cb[by_cb])
        rank[by_cb] = np.arange(len(sizes)) - starts
        assert rank.max() < n_snps, "more groups in a barcode than SNPs"
        group_snp = rng.permutation(n_snps)[(group_cb * 7919 + rank) % n_snps]
        order = rng.permutation(int(sizes.sum()))
        cb, snp = np.repeat(group_cb, sizes)[order], np.repeat(group_snp, sizes)[order]
        n_calls = len(cb)
        edge_groups = [g for g in AGGREGATE_EDGE_GROUPS if lo <= min(g) and max(g) <= hi]
    if edges:
        extra_cb, extra_snp = [], []
        for i, sizes in enumerate(edge_groups):
            snps = rng.choice(n_snps, len(sizes), replace=False)
            extra_cb += [n_barcodes + i] * sum(sizes)
            extra_snp += [s for s, size in zip(snps, sizes) for _ in range(size)]
        cb = np.concatenate([cb, extra_cb])
        snp = np.concatenate([snp, extra_snp])
        n_barcodes += len(edge_groups) + 3
        n_calls = len(cb)
    vid = 2 * snp + rng.randint(0, 2, n_calls)
    q = np.exp(rng.uniform(np.log(q_low), np.log(0.3), n_calls))
    gprob = rng.uniform(0.01, 0.99, (2 * n_snps, n_donors))
    gprob[rng.rand(2 * n_snps) < zero_rows] = 0.0
    calls = MoleculeCalls(variant_id=vid.astype(np.int32), snp_id=snp.astype(np.int32),
                          compressed_cb=cb.astype(np.int32), molecule_id=np.arange(n_calls, dtype=np.int32),
                          p_base_wrong=q.astype(np.float32), p_molecule_aligned_wrong=np.zeros(n_calls, np.float32))
    return dict(gprob=gprob.astype(np.float32), calls=calls, n_barcodes=n_barcodes, n_donors=n_donors,
                doublet_prior=doublet_prior)


def aggregate_args(problem, device="cpu", n_pg=None):
    """(genotype_prob, checked AggregateOperands) of an :func:`aggregate_problem` on ``device``, through the engine's
    layout; with ``n_pg``, the columns are the first ``n_pg`` of the donors' singlets and doublets (whatever the
    problem's doublet prior)."""
    from demuxalot_tpu_torch.models.demux import _SnpAggregationLayout
    from demuxalot_tpu_torch.ops.likelihood import pseudogenotype_pairs

    gprob, n_donors = problem["gprob"], problem["n_donors"]
    if n_pg is None:
        pairs = np.stack(pseudogenotype_pairs(n_donors, problem["doublet_prior"]))
    else:
        pairs = np.stack(pseudogenotype_pairs(n_donors, 1.0))[:, :n_pg]
        assert pairs.shape[1] == n_pg, f"{n_donors} donors have fewer than {n_pg} columns"
    layout = _SnpAggregationLayout.build(problem["calls"], torch.device(device))
    return t(gprob, device), layout.operands(problem["n_barcodes"], pairs, n_donors, gprob.shape[0])


def skewed_pool(seed, n_barcodes, n_donors, n_snps, calls_per_barcode, sigma=0.2, zipf=1.0, stride=64):
    """(genotypes, handler, packed) of a pool in the benchmark cells' shape, drawn with numpy from ``seed``:
    ``sim.synthesize_compressed_calls``' model (two alleles a SNP, 20% doublets, 2% flips, Phred 20-40) with each
    barcode's calls the log-normal's quantiles (mean ``calls_per_barcode``, log-scale ``sigma``) in the seed's
    order and each SNP's calls its Zipf share (1 / rank ** ``zipf``, largest remainders to the top ranks), the most
    expressed SNPs every ``stride``-th position. Its most expressed SNPs hold variants of many calls, past
    ``CHUNK_CALLS`` at a few thousand barcodes; ``n_snps`` is a multiple of ``stride``."""
    from statistics import NormalDist

    from demuxalot_tpu_torch import BarcodeHandler, Demultiplexer
    from demuxalot_tpu_torch.frontend.snp_counter import MOLECULE_DTYPE, SNP_CALL_DTYPE, CompressedSNPCalls
    from demuxalot_tpu_torch.models.genotypes import ProbabilisticGenotypes

    rng = np.random.RandomState([seed & 0xFFFFFFFF, seed >> 32])
    donor_allele = rng.randint(0, 2, size=(n_snps, n_donors))
    genotypes = ProbabilisticGenotypes([f"Donor{i + 1:02}" for i in range(n_donors)])
    for pos in range(n_snps):
        for base in ("A", "C"):
            genotypes.get_variant_id("chr1", pos, base)
    betas = np.full((2 * n_snps, n_donors), 0.5, dtype=np.float32)
    betas[np.arange(n_snps)[:, None] * 2 + donor_allele, np.arange(n_donors)] = 100.0
    genotypes = genotypes._with_betas(betas)

    z = np.array([NormalDist().inv_cdf((i + 0.5) / n_barcodes) for i in range(n_barcodes)])
    sizes = np.maximum(1, np.rint(calls_per_barcode * np.exp(sigma * z - sigma * sigma / 2))).astype(np.int64)
    cb = np.repeat(np.arange(n_barcodes, dtype=np.int32), sizes[rng.permutation(n_barcodes)])
    n_calls = len(cb)
    primary = rng.randint(0, n_donors, size=n_barcodes)
    secondary = (primary + 1 + rng.randint(0, n_donors - 1, size=n_barcodes)) % n_donors
    doublet = rng.rand(n_barcodes) < 0.2
    donor = np.where(doublet[cb] & (rng.rand(n_calls) < 0.5), secondary[cb], primary[cb])
    weight = 1.0 / np.arange(1, n_snps + 1, dtype=np.float64) ** zipf
    share = n_calls * weight / weight.sum()
    by_rank = np.floor(share).astype(np.int64)
    by_rank[:n_calls - int(by_rank.sum())] += 1
    rank, per = np.arange(n_snps), n_snps // stride
    per_snp = np.empty(n_snps, dtype=np.int64)
    per_snp[(rank % per) * stride + rank // per] = by_rank
    snp = np.repeat(np.arange(n_snps, dtype=np.int32), per_snp)[rng.permutation(n_calls)]
    allele = donor_allele[snp, donor]
    allele = np.where(rng.rand(n_calls) < 0.02, 1 - allele, allele)
    q = (0.1 ** (0.1 * rng.randint(20, 41, size=n_calls))).astype(np.float32)

    molecules = np.empty(n_calls, dtype=MOLECULE_DTYPE)
    molecules["compressed_cb"] = cb
    molecules["compressed_ub"] = np.arange(n_calls, dtype=np.int32)
    molecules["p_group_misaligned"] = 0.01
    snp_calls = np.empty(n_calls, dtype=SNP_CALL_DTYPE)
    snp_calls["molecule_index"] = np.arange(n_calls, dtype=np.int32)
    snp_calls["snp_position"] = snp
    snp_calls["base_index"] = allele.astype(np.uint8)  # A = 0, C = 1
    snp_calls["p_base_wrong"] = q
    calls = CompressedSNPCalls()
    calls.molecules = molecules
    calls.snp_calls = snp_calls
    calls._finalized = True
    handler = BarcodeHandler([f"BC{b:06d}" for b in range(n_barcodes)])
    return genotypes, handler, Demultiplexer.pack_dataset({"chr1": calls}, genotypes)
