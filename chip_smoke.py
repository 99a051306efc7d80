#!/usr/bin/env python3
"""Smoke run of demuxalot_tpu_torch on one CUDA card.

Run from the repository root: ``python3 chip_smoke.py``. It needs one
CUDA card, ``nvcc``, ``g++`` with zlib's headers, ``nvidia-smi``, pandas and
pyarrow (for the CLI runs of phases 6 and 8), and no jax. Phases, one line each
(any failed check raises and the exit code is non-zero):

1. device: name, count, versions, nvidia-smi's name and power limit,
   whether pandas, pyarrow and joblib are importable, and whether g++ finds
   ``zlib.h`` for the BAM scanner;
2. build: nvcc builds ``demuxalot_tpu_torch/csrc/*.cu`` while g++ builds
   the BAM scanner and the host ops (``demuxalot_tpu_torch.native``);
   seconds of each and ptxas' registers/spills per kernel (no kernel may
   spill);
3. kernels: each CUDA kernel against its plain PyTorch version on the card
   at edge shapes (the E-step logits-only and with its fused softmax, with
   and without prior logits), the padding no-op, barcodes that span several
   staged tiles of calls (also against ``tests/oracle.py``, float64
   accumulation), and the oracle at a small shape;
4. main path at the bench shape (32 donors, 65,536 SNPs, 65,536 barcodes,
   64 calls per barcode, 20% doublets, seed 0): ``learn_genotypes_core``
   (5 iterations, doublet prior 0.35) then ``predict_posteriors_core``,
   with launch counters, output checks and truth accuracy, then the same
   run through the plain versions on the card for comparison;
5. timing with CUDA events: E-step (logits only), E-step with its fused
   softmax (``estep_softmax``, against the plain logits + ``torch.softmax``),
   M-step and a full EM iteration, kernel and plain in turns (plain,
   kernel, kernel, plain); ``torch.softmax`` alone on the bench logits (the
   epilogue's library call), and the fused E-step with its log fold through
   ``logf`` against the default MUFU log2, in turns;
6. the BAM path at the end-to-end shape of ``benchmarks/end_to_end.py``
   (32 donors, 65,536 barcodes x 20 reads, 8 chromosomes x 20,000 bp,
   mutation 0.003, 20% doublets, seed 0): ``sim.generate_bam_file``,
   ``count_snps(native=True)``, ``pack_dataset`` on the native host ops,
   ``learn_genotypes_core(damping="auto")`` and
   ``predict_posteriors_compact``, with launch counts over the last two,
   the native paths held against the Python/numpy ones, the compact
   result against the full frame, truth accuracy, the same flow through
   ``python -m demuxalot_tpu_torch demux --compact``, and last the same
   learn + predict through the plain versions on the card (phase 4's
   bars). Host-clock seconds per stage;
7. the aggregate-on-SNPs path and SNP discovery. (a) On phase 4's data,
   ``aggregate_on_snps = True``: ``learn_genotypes_core`` (5 iterations,
   doublet prior 0, one ``STAGE_TIMINGS`` dict printed) then
   ``predict_posteriors_compact`` (prior 0.35), launch counts, output
   checks, truth accuracy, the same run through the plain versions at
   phase 4's bars, and the CUDA-event time of ``snp_aggregated_logits`` at
   32 and 528 columns. (b) On phase 6's BAM with only chr1–chr4 known:
   ``detect_snps_positions`` (the provisional predict launches the E-step
   kernel; the pileup takes the C++ scanner), its selections against the
   hidden truth, the parquet fed back through ``add_prior_betas``, native
   against Python coverage on one chromosome, and ``python -m
   demuxalot_tpu_torch detect-snps`` against the API's parquet;
8. the barcode-sharded engine (``parallel.ShardedDemultiplexer``). (a) 4
   shards on cuda:0 at phase 4's shape: ``learn_genotypes`` (5 iterations,
   prior 0.35), ``predict_posteriors`` and ``predict_posteriors_compact``
   on the learnt genotypes, launch counts (4 shards x 7 E-steps, 4 x 4
   M-steps), output checks, truth accuracy; iteration-0 and predict logits
   bit-equal to the single-device engine on the same inputs, EM posteriors
   and learnt betas against phase 4's, two sharded runs bit-equal; the
   CUDA-event time of one sharded EM iteration beside the single-device
   one, in turns, and of each step over the 4 shards (the fused E-step,
   M-step, reduction). (b) Two processes on the card joined by ``gloo``, 2
   shards each, and (c) one process in an ``nccl`` group with 4 shards, at
   8,192 barcodes (``tests/torch_sharded_worker.py``, under a timeout),
   against (a)'s engine in this process at that size. (d) ``python -m
   demuxalot_tpu_torch demux --sharded --compact`` on phase 6's BAM against
   phase 6's CLI run.

The line before the last is a JSON object with one entry per kernel
(``launches`` sums the runs of phases 4, 6, 7 and 8a, ``launches_by_path``
keeps them apart; ``bound_ms`` is the least time the card could take for
the bench-shape call that ``ms`` times, from ``utils.profiling``; the
E-step's ``ms`` is its fused call, logits and posteriors, as the EM loop
and predict make it); the line before it is nvidia-smi's name and power
limit; the last line is ``{"ok": true, "device": {...}}``.

``python3 chip_smoke.py --parent DIR`` runs only the comparison of this
tree's E-step with the one under ``DIR`` (an unpacked older commit):
phases 1-2, then each tree's E-step and softmax at the bench shape in its
own process, in turns (parent, this tree, this tree, parent).
"""
from __future__ import annotations

import contextlib
import importlib.util
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parent
sys.path.insert(0, str(REPO))
sys.path.insert(0, str(REPO / "tests"))  # oracle.py: numpy only
if "--estep-ms" in sys.argv[1:-1]:  # a child of --parent imports the package under the given root
    sys.path.insert(0, str(Path(sys.argv[sys.argv.index("--estep-ms") + 1]).resolve()))

BENCH = dict(n_barcodes=65_536, n_donors=32, n_snps=65_536, calls_per_barcode=64)
DOUBLET_PRIOR = 0.35
N_ITERATIONS = 5
# tolerances: logits as the JAX tests hold the Pallas kernel to the oracle;
# posteriors at the bar the TPU kernel met against full f32; additions as
# the M-step oracle tests
LOGITS_TOL = dict(rtol=1e-4, atol=5e-3)
POSTERIOR_ATOL = 3e-5
ADDITION_TOL = dict(rtol=1e-4, atol=1e-5)
BETAS_TOL = dict(rtol=1e-4, atol=1e-2)
# phase 6: benchmarks/end_to_end.py:94-96 (its default shape), seed 0
E2E_FIXTURE = dict(
    n_genotypes=32, n_barcodes=65_536, n_reads_per_barcode=20, mutation_prob=0.003,
    doublets_fraction=0.2, chromosome2length={f"chr{i}": 20_000 for i in range(1, 9)},
)
E2E_TOPK = 4
# phase 8: shards of the sharded engine on the one card; learnt betas held
# to single-device at rtol 1e-5 (their smallest entry is 0.5); the
# multi-process runs at phase 4's widths with fewer barcodes
SHARDS = 4
SHARDED_BETAS_TOL = dict(rtol=1e-5, atol=1e-6)
MULTIPROCESS = dict(n_barcodes=8_192, n_donors=BENCH["n_donors"], n_snps=BENCH["n_snps"],
                    calls_per_barcode=BENCH["calls_per_barcode"], seed=0)
# phase 7b: SNP discovery on phase 6's BAM with these chromosomes' variants
# known and the other four hidden. Depth per position is reads x read
# length / genome length = 1,310,720 x 100 / 160,000 ≈ 819; a variant that
# one donor of 32 carries shows ≈ 819 / 32 ≈ 26 alternative reads (the
# simulated reads carry no sequencing errors). Sites must reach half the
# depth, and half of one donor's alternative reads.
DISCOVERY_KNOWN = ("chr1", "chr2", "chr3", "chr4")
_E2E_DEPTH = (E2E_FIXTURE["n_barcodes"] * E2E_FIXTURE["n_reads_per_barcode"] * 100
              / sum(E2E_FIXTURE["chromosome2length"].values()))
DISCOVERY_THRESHOLDS = dict(
    minimum_coverage=int(_E2E_DEPTH / 2),
    minimum_alternative_coverage=int(_E2E_DEPTH / E2E_FIXTURE["n_genotypes"] / 2),
)


def say(phase: str, **fields) -> None:
    print(f"[{phase}] " + json.dumps(fields, default=str), flush=True)


def require(condition: bool, what: str) -> None:
    if not condition:
        raise RuntimeError(f"check failed: {what}")


def compare(what: str, got: torch.Tensor, want: torch.Tensor, rtol: float, atol: float) -> float:
    """Max |got - want|; raises unless |got - want| <= atol + rtol·|want| everywhere."""
    got = got.double().cpu()
    want = want.double().cpu()
    require(got.shape == want.shape, f"{what}: shape {tuple(got.shape)} vs {tuple(want.shape)}")
    require(bool(torch.isfinite(got).all()), f"{what}: non-finite values")
    diff = (got - want).abs()
    excess = float((diff - (atol + rtol * want.abs())).max()) if diff.numel() else 0.0
    max_err = float(diff.max()) if diff.numel() else 0.0
    require(excess <= 0.0, f"{what}: max |err| {max_err} exceeds atol={atol}, rtol={rtol}")
    return max_err


# ---------------------------------------------------------------------------
# phase 1-2
# ---------------------------------------------------------------------------

def phase_device() -> dict:
    from demuxalot_tpu_torch.utils.device import device_report

    require(torch.cuda.is_available(), "torch.cuda.is_available()")
    report = device_report()
    for module in ("pandas", "pyarrow", "joblib"):
        report[module] = importlib.util.find_spec(module) is not None
    # the BAM scanner (demuxalot_tpu_torch/native/scanner.cpp) includes zlib.h
    zlib = subprocess.run(["g++", "-E", "-x", "c++", "-"], input="#include <zlib.h>\n",
                          capture_output=True, text=True)
    report["zlib_h"] = zlib.returncode == 0
    torch.backends.cuda.matmul.allow_tf32 = False  # plain path in full f32
    torch.backends.cudnn.allow_tf32 = False
    report["allow_tf32"] = torch.backends.cuda.matmul.allow_tf32
    say("device", **report)
    return report


def phase_build() -> None:
    """nvcc builds the kernels while g++ builds the BAM scanner and the host ops."""
    from concurrent.futures import ThreadPoolExecutor

    from demuxalot_tpu_torch import native
    from demuxalot_tpu_torch.ops import _cuda

    def timed(build):
        t0 = time.perf_counter()
        build()
        return time.perf_counter() - t0

    with ThreadPoolExecutor(max_workers=3) as pool:
        futures = {name: pool.submit(timed, build) for name, build in (
            ("nvcc", _cuda.build), ("scanner", native.load_library), ("hostops", native.load_host_library))}
        seconds = {name: future.result() for name, future in futures.items()}
    result = _cuda.build()
    _cuda.library()
    say("build", seconds=seconds, library=result.path.name)
    for line in result.log.splitlines():
        if any(key in line for key in ("Compiling entry", "registers", "spill")):
            print("  ptxas: " + line.strip(), flush=True)
    spills = [line.strip() for line in result.log.splitlines()
              if "spill" in line and "0 bytes spill stores, 0 bytes spill loads" not in line]
    require(not spills, f"kernels spill registers: {spills}")
    cuobjdump = Path(_cuda.find_nvcc()).parent / "cuobjdump"
    if cuobjdump.is_file():
        sass = subprocess.run([str(cuobjdump), "-sass", str(result.path)], capture_output=True, text=True).stdout
        say("build", estep_hot_loop=_estep_hot_loops(sass))


def _estep_hot_loops(sass: str) -> dict:
    """Per instantiation of the E-step kernel: the innermost loop with the most FADD and FMUL both (the
    per-call products, 8 calls per trip), its instructions and their main kinds, from cuobjdump's SASS."""
    import collections
    import re

    found = {}
    for function in re.split(r"\n\s+Function : ", sass)[1:]:
        args = re.search(r"estep_kernelILb(\d)ELi(\d+)E", function.splitlines()[0])
        if args is None:
            continue
        lines = re.findall(r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)([^;]*);", function)
        code = [(int(at, 16), op.split(".")[0], rest) for at, op, rest in lines]
        loops = []  # (first, last) address of every backward branch's body
        for at, op, rest in code:
            target = re.search(r"(0x[0-9a-f]+)", rest) if op == "BRA" else None
            if target is not None and int(target.group(1), 16) < at:
                loops.append((int(target.group(1), 16), at))
        best = None
        for lo, hi in loops:
            if any(lo <= inner_lo and inner_hi < hi for inner_lo, inner_hi in loops):
                continue  # not innermost
            kinds = collections.Counter(o for a, o, _ in code if lo <= a <= hi)
            if best is None or min(kinds["FADD"], kinds["FMUL"]) > min(best["FADD"], best["FMUL"]):
                best = kinds
        if best is not None:
            found[f"fast_log={bool(int(args.group(1)))} chunk={args.group(2)}"] = {
                "instructions": sum(best.values()), **{k: best[k] for k in ("FADD", "FMUL", "FFMA", "LDS", "MUFU")}}
    return found


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions at edge shapes
# ---------------------------------------------------------------------------

def _csr(rows: np.ndarray, n_rows: int) -> np.ndarray:
    from demuxalot_tpu_torch.ops.packing import csr_row_pointers

    return csr_row_pointers(rows, n_rows)


def _estep_inputs(n_donors: int, doublet_prior: float, seed: int, n_snps=200, n_barcodes=300, n_calls=8000):
    rng = np.random.RandomState(seed)
    n_variants = n_snps * 2
    variant2snp = np.repeat(np.arange(n_snps, dtype=np.int32), 2)
    betas = (rng.rand(n_variants, n_donors) * 50).astype(np.float32)
    vid = rng.randint(0, n_variants, n_calls).astype(np.int32)
    # every third barcode gets no calls: empty CSR rows
    cb = np.sort(rng.randint(0, n_barcodes // 3, n_calls) * 3).astype(np.int32)
    q = (rng.rand(n_calls) * 0.5).astype(np.float32)
    return dict(variant2snp=variant2snp, betas=betas, vid=vid, cb=cb, q=q, n_barcodes=n_barcodes,
                n_donors=n_donors, doublet_prior=doublet_prior)


def _estep_tensors(p: dict, device):
    """(genotype_prob, EStepOperands) of :func:`_estep_inputs` on ``device``."""
    from demuxalot_tpu_torch.ops import likelihood as L
    from demuxalot_tpu_torch.ops.likelihood_kernel import estep_operands

    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
    gprob = L.probs_from_betas(t(p["betas"]), t(p["variant2snp"]), len(p["variant2snp"]) // 2, 0.01, 2)
    operands = estep_operands(p["n_donors"], p["doublet_prior"], t(_csr(p["cb"], p["n_barcodes"])),
                              t(p["cb"]), t(p["vid"]), t(p["q"]))
    return gprob, operands


def _mstep_operands(vid: np.ndarray, cb: np.ndarray, q: np.ndarray, n_variants: int, device):
    """MStepOperands of (vid, cb)-sorted calls on ``device``."""
    from demuxalot_tpu_torch.ops.mstep_kernel import MStepOperands

    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
    return MStepOperands(t(_csr(vid, n_variants)), t(vid), t(cb), t(q))


def phase_kernels() -> None:
    from demuxalot_tpu_torch.ops.likelihood_kernel import estep_logits, estep_logits_plain
    from demuxalot_tpu_torch.ops.mstep_kernel import mstep_addition, mstep_addition_plain
    from oracle import oracle_barcode_logits, oracle_mstep

    cuda = torch.device("cuda")
    for n_donors in (1, 2, 32, 33, 65):
        for doublet_prior in (0.0, 0.35):
            args = _estep_tensors(_estep_inputs(n_donors, doublet_prior, seed=n_donors), cuda)
            got = estep_logits(*args)
            want = estep_logits_plain(*args)
            torch.cuda.synchronize()
            what = f"D={n_donors} prior={doublet_prior}"
            err = compare(f"estep {what}", got, want, **LOGITS_TOL)
            perr = compare(f"estep posteriors {what}", torch.softmax(got, -1), torch.softmax(want, -1), 0.0,
                           POSTERIOR_ATOL)
            # the fused softmax, without and with prior logits: one launch, logits as the logits-only
            # call's bits (+ prior), posteriors against the plain logits (+ prior) and torch.softmax
            prior = torch.from_numpy(np.random.RandomState(n_donors).randn(*got.shape).astype(np.float32)).to(cuda)
            fused = {}
            for name, prior_logits in (("fused", None), ("fused_prior", prior)):
                launches = estep_logits.launches
                logits, probs = estep_logits(*args, prior_logits=prior_logits, softmax=True)
                require(estep_logits.launches == launches + 1, f"fused E-step {what}: one launch")
                want_logits, want_probs = estep_logits_plain(*args, prior_logits=prior_logits, softmax=True)
                same = got if prior_logits is None else got + prior_logits
                require(torch.equal(logits, same), f"{name} {what}: logits equal the logits-only call's")
                fused[name] = compare(f"{name} posteriors {what}", probs, want_probs, 0.0, POSTERIOR_ATOL)
                compare(f"{name} logits {what}", logits, want_logits, **LOGITS_TOL)
                row_err = float((probs.sum(dim=1) - 1).abs().max())
                require(row_err <= 1e-5, f"{name} {what}: rows sum to 1 within {row_err}")
            say("kernels", kernel="estep_logits", n_donors=n_donors, doublet_prior=doublet_prior,
                n_pg=int(args[1].penalties.shape[0]), max_abs_err=err, posterior_max_abs_err=perr,
                fused_posterior_max_abs_err=fused)

    # padding calls (q = 1) after the last barcode's real calls change no bit
    p = _estep_inputs(32, 0.35, seed=7)
    base = estep_logits(*_estep_tensors(p, cuda))
    pad = 1234
    padded = dict(p, vid=np.concatenate([p["vid"], np.zeros(pad, np.int32)]),
                  cb=np.concatenate([p["cb"], np.full(pad, p["cb"][-1], np.int32)]),
                  q=np.concatenate([p["q"], np.ones(pad, np.float32)]))
    with_pad = estep_logits(*_estep_tensors(padded, cuda))
    require(torch.equal(base, with_pad), "padding calls must leave the E-step logits bit-equal")
    fused = estep_logits(*_estep_tensors(p, cuda), softmax=True)
    fused_pad = estep_logits(*_estep_tensors(padded, cuda), softmax=True)
    again = estep_logits(*_estep_tensors(p, cuda), softmax=True)
    require(all(torch.equal(a, b) for a, b in zip(fused, fused_pad)),
            "padding calls must leave the fused logits and posteriors bit-equal")
    require(all(torch.equal(a, b) for a, b in zip(fused, again)), "two fused E-step runs bit-equal")
    say("kernels", kernel="estep_logits", padding_noop="bit-equal (logits, fused logits and posteriors)",
        runs="bit-equal", pad_calls=pad)

    # twenty barcodes of ~400 calls each span thirteen staged tiles of 32
    # calls. Over that many calls the plain version's own f32 sums drift from
    # float64 by about the posterior bar, so the kernel is held to the float64
    # oracle at both bars and to the plain version at the logits bar
    for n_donors in (32, 65):
        p = _estep_inputs(n_donors, 0.35, seed=11, n_barcodes=60)
        args = _estep_tensors(p, cuda)
        got, want = estep_logits(*args), estep_logits_plain(*args)
        fused_logits, fused_probs = estep_logits(*args, softmax=True)
        torch.cuda.synchronize()
        ref, _ = oracle_barcode_logits([f"D{i}" for i in range(n_donors)], args[0].cpu().numpy(), p["vid"],
                                       p["cb"], p["q"], p["n_barcodes"], 0.35)
        ref = torch.from_numpy(ref)
        err = compare(f"estep across tiles D={n_donors}", got, want, **LOGITS_TOL)
        oerr = compare(f"estep across tiles vs oracle D={n_donors}", got, ref, **LOGITS_TOL)
        perr = compare(f"estep across tiles posteriors vs oracle D={n_donors}", torch.softmax(got, -1),
                       torch.softmax(ref, -1), 0.0, POSTERIOR_ATOL)
        compare(f"fused estep across tiles vs oracle D={n_donors}", fused_logits, ref, **LOGITS_TOL)
        fused_perr = compare(f"fused estep across tiles posteriors vs oracle D={n_donors}", fused_probs,
                             torch.softmax(ref, -1), 0.0, POSTERIOR_ATOL)
        plain_perr = float((torch.softmax(want.cpu().double(), -1) - torch.softmax(ref.double(), -1)).abs().max())
        calls = int(np.diff(args[1].row_ptr.cpu().numpy()).max())
        say("kernels", kernel="estep_logits", n_donors=n_donors, max_calls_per_barcode=calls,
            max_abs_err=err, oracle_max_abs_err=oerr, posterior_vs_oracle_max_abs_err=perr,
            fused_posterior_vs_oracle_max_abs_err=fused_perr, plain_posterior_vs_oracle_max_abs_err=plain_perr)

    for n_donors in (1, 32, 65):
        for power in (1.0, 2.0):
            rng = np.random.RandomState(100 + n_donors)
            n_variants, n_barcodes, n_calls = 300, 150, 20_000
            n_pg = n_donors + n_donors * (n_donors - 1) // 2
            vid = np.sort(rng.randint(0, n_variants // 2, n_calls) * 2).astype(np.int32)  # odd rows empty
            cb = rng.randint(0, n_barcodes, n_calls).astype(np.int32)
            q = (rng.rand(n_calls) * 0.7).astype(np.float32)
            q[::97] = 1.0  # padding-valued calls inside the runs add exactly 0
            post = rng.rand(n_barcodes, n_pg).astype(np.float32)
            post /= post.sum(axis=1, keepdims=True)
            args = (torch.from_numpy(post).to(cuda), _mstep_operands(vid, cb, q, n_variants, cuda),
                    n_donors, power)
            got = mstep_addition(*args)
            want = mstep_addition_plain(*args)
            torch.cuda.synchronize()
            err = compare(f"mstep D={n_donors} p={power}", got, want, **ADDITION_TOL)
            say("kernels", kernel="mstep_addition", n_donors=n_donors, power=power, max_abs_err=err)

    # the numpy oracle (float64 accumulation) at one small shape
    p = _estep_inputs(6, 0.35, seed=3)
    args = _estep_tensors(p, cuda)
    names = [f"D{i}" for i in range(6)]
    ref, _ = oracle_barcode_logits(names, args[0].cpu().numpy(), p["vid"], p["cb"], p["q"],
                                   p["n_barcodes"], 0.35)
    err = compare("estep vs oracle", estep_logits(*args), torch.from_numpy(ref), **LOGITS_TOL)
    order = np.argsort(p["vid"], kind="stable")
    post = torch.softmax(estep_logits(*args), -1)
    ref_m = oracle_mstep(post.cpu().numpy(), p["vid"], p["cb"], p["q"], len(p["variant2snp"]), 6, 2.0)
    got_m = mstep_addition(post, _mstep_operands(p["vid"][order], p["cb"][order], p["q"][order],
                                                 len(p["variant2snp"]), cuda), 6, 2.0)
    err_m = compare("mstep vs oracle", got_m, torch.from_numpy(ref_m), **ADDITION_TOL)
    say("kernels", oracle="tests/oracle.py", estep_max_abs_err=err, mstep_max_abs_err=err_m)


# ---------------------------------------------------------------------------
# phase 4: the main path at the bench shape
# ---------------------------------------------------------------------------

def _bench_data():
    from demuxalot_tpu_torch import BarcodeHandler, Demultiplexer
    from demuxalot_tpu_torch.sim import synthesize_compressed_calls

    t0 = time.perf_counter()
    genotypes, calls, truth, _names = synthesize_compressed_calls(
        doublets_fraction=0.2, seed=0, **BENCH
    )
    # zero-padded names sort in index order, so slot b is synthetic barcode b
    handler = BarcodeHandler([f"BC{b:06d}" for b in range(BENCH["n_barcodes"])])
    t1 = time.perf_counter()
    packed = Demultiplexer.pack_dataset(calls, genotypes)
    t2 = time.perf_counter()
    say("main", synth_s=round(t1 - t0, 3), pack_s=round(t2 - t1, 3),
        n_collapsed_calls=len(packed.calls_v), n_variants=packed.n_variants)
    return genotypes, handler, packed, truth


@contextlib.contextmanager
def plain_versions():
    """Point the engine at the kernels' plain versions (comparison runs only)."""
    from demuxalot_tpu_torch.models import demux
    from demuxalot_tpu_torch.ops.likelihood_kernel import estep_logits_plain
    from demuxalot_tpu_torch.ops.mstep_kernel import mstep_addition_plain

    saved = demux.estep_logits, demux.mstep_addition
    demux.estep_logits, demux.mstep_addition = estep_logits_plain, mstep_addition_plain
    try:
        yield
    finally:
        demux.estep_logits, demux.mstep_addition = saved


def _run_main_path(genotypes, handler, packed):
    from demuxalot_tpu_torch import Demultiplexer

    learnt = Demultiplexer.learn_genotypes_core(
        packed, genotypes, handler, n_iterations=N_ITERATIONS, doublet_prior=DOUBLET_PRIOR,
    )
    logits, probs, columns = Demultiplexer.predict_posteriors_core(
        packed, learnt.genotypes, handler, doublet_prior=DOUBLET_PRIOR,
    )
    torch.cuda.synchronize()
    return learnt.genotypes, learnt.state, logits, probs, columns


def phase_main(genotypes, handler, packed, truth) -> dict:
    from demuxalot_tpu_torch import Demultiplexer
    from demuxalot_tpu_torch.ops.likelihood_kernel import estep_logits
    from demuxalot_tpu_torch.ops.mstep_kernel import mstep_addition

    Demultiplexer.device = "cuda"
    estep_logits.launches = 0
    mstep_addition.launches = 0
    t0 = time.perf_counter()
    learnt, state, logits, probs, columns = _run_main_path(genotypes, handler, packed)
    wall = time.perf_counter() - t0
    launches = {"estep_logits": estep_logits.launches, "mstep_addition": mstep_addition.launches}
    require(launches["estep_logits"] == N_ITERATIONS + 1,
            f"E-step kernel launched {launches['estep_logits']} times, expected {N_ITERATIONS + 1}")
    require(launches["mstep_addition"] == N_ITERATIONS - 1,
            f"M-step kernel launched {launches['mstep_addition']} times, expected {N_ITERATIONS - 1}")

    n_barcodes, n_pg = BENCH["n_barcodes"], len(columns)
    for name, frame in (("em_probs", state.probs), ("logits", logits), ("probs", probs)):
        require(tuple(frame.shape) == (n_barcodes, n_pg), f"{name} shape {tuple(frame.shape)}")
        require(bool(torch.isfinite(frame).all()), f"{name} has non-finite values")
    row_err = float((probs.sum(dim=1) - 1).abs().max())
    require(row_err <= 1e-5, f"posterior rows sum to 1 within {row_err}")
    require(bool(np.isfinite(learnt.get_betas()).all()), "learnt betas finite")

    truth_column = np.array([columns.index("+".join(t)) for t in truth])
    assigned = probs.argmax(dim=1).cpu().numpy()
    accuracy = float((assigned == truth_column).mean())
    singlet = np.array([len(t) == 1 for t in truth])
    singlet_accuracy = float((assigned[singlet] == truth_column[singlet]).mean())
    require(accuracy > 0.9, f"assignment accuracy {accuracy}")
    say("main", path="kernels", launches=launches, wall_s=round(wall, 3), n_pg=n_pg,
        max_row_sum_err=row_err, accuracy=accuracy, singlet_accuracy=singlet_accuracy,
        max_memory_allocated=torch.cuda.max_memory_allocated())

    # the same run through the plain versions on the card
    with plain_versions():
        learnt_p, state_p, logits_p, probs_p, _ = _run_main_path(genotypes, handler, packed)
    errors = {
        "em_posteriors": compare("EM posteriors", state.probs, state_p.probs, 0.0, POSTERIOR_ATOL),
        "learnt_betas": compare("learnt betas", torch.from_numpy(np.array(learnt.get_betas())),
                                torch.from_numpy(np.array(learnt_p.get_betas())), **BETAS_TOL),
        "logits": compare("predict logits", logits, logits_p, **LOGITS_TOL),
        "posteriors": compare("predict posteriors", probs, probs_p, 0.0, POSTERIOR_ATOL),
    }
    argmax_same = float((probs.argmax(1) == probs_p.argmax(1)).float().mean())
    require(argmax_same == 1.0, f"argmax agrees on {argmax_same} of barcodes")
    say("main", path="plain vs kernels", max_abs_err=errors, argmax_agreement=argmax_same)
    return {"launches": launches, "learnt": learnt, "state": state}


# ---------------------------------------------------------------------------
# phase 5: timing
# ---------------------------------------------------------------------------

def _time_ms(fn, repeats: int = 10) -> float:
    fn()
    fn()  # warm
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(repeats):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / repeats


@contextlib.contextmanager
def _log_fold(likelihood_kernel, fast: bool):
    """The E-step kernel's log fold on the MUFU unit (fast, the default) or through logf."""
    saved = likelihood_kernel.FAST_LOG
    likelihood_kernel.FAST_LOG = fast
    try:
        yield
    finally:
        likelihood_kernel.FAST_LOG = saved


def _em_iteration_ms(genotypes, handler, packed, repeats: int = 5, sharded=None) -> float:
    """Per-iteration time of the EM generator in steady state (M + E step), or of ``sharded``'s."""
    from demuxalot_tpu_torch.models.demux import _EMRun
    from demuxalot_tpu_torch.parallel.sharded import _ShardedEM

    if sharded is None:
        run = _EMRun(packed, genotypes, handler, repeats + 2, 0.01, DOUBLET_PRIOR, None)
    else:
        run = _ShardedEM(sharded, packed, genotypes, handler, repeats + 2, 0.01, DOUBLET_PRIOR, None, None)
    iterations = run.device_iterations()
    next(iterations)
    next(iterations)  # warm
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(repeats):
        next(iterations)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / repeats


def phase_timing(genotypes, handler, packed, main: dict, card: str) -> dict:
    from demuxalot_tpu_torch import Demultiplexer
    from demuxalot_tpu_torch.models.demux import _Likelihood
    from demuxalot_tpu_torch.ops import likelihood as L
    from demuxalot_tpu_torch.ops import likelihood_kernel
    from demuxalot_tpu_torch.ops.likelihood_kernel import estep_logits, estep_logits_plain
    from demuxalot_tpu_torch.ops.mstep_kernel import mstep_addition, mstep_addition_plain
    from demuxalot_tpu_torch.utils.profiling import MStepRoofline, Roofline

    cuda = torch.device("cuda")
    lik = _Likelihood(packed, handler.n_barcodes, genotypes.genotype_names, DOUBLET_PRIOR, cuda)
    reindex = packed.reindex
    betas = torch.from_numpy(reindex.permute_rows(packed.betas_for(main["learnt"], False))).to(cuda)
    gprob = L.probs_from_betas(betas, torch.from_numpy(reindex.variant2snp).to(cuda),
                               int(packed.variant2snp.max()) + 1, 0.01, reindex.windowed_max_per_snp)
    probs = main["state"].probs
    n_genotypes = len(genotypes.genotype_names)
    power = float(Demultiplexer.contribution_power)
    estep_args = (gprob, lik.estep)
    mstep_args = (probs, lik.mstep, n_genotypes, power)

    # kernel vs plain on the main path's own inputs at the bench shape
    logits_k = estep_logits(*estep_args)
    logits_p = estep_logits_plain(*estep_args)
    estep_err = compare("bench-shape estep", logits_k, logits_p, **LOGITS_TOL)
    post_err = compare("bench-shape estep posteriors", torch.softmax(logits_k, -1),
                       torch.softmax(logits_p, -1), 0.0, POSTERIOR_ATOL)
    mstep_err = compare("bench-shape mstep", mstep_addition(*mstep_args),
                        mstep_addition_plain(*mstep_args), **ADDITION_TOL)
    # the fused E-step (the EM loop's and predict's call) against the plain
    # logits + torch.softmax, with its log fold on the MUFU unit (the
    # default) and through logf
    probs_p = torch.softmax(logits_p, -1)
    fused_errors = {}
    for fast_log in (True, False):
        with _log_fold(likelihood_kernel, fast_log):
            fused_logits, fused_probs = estep_logits(*estep_args, softmax=True)
        name = "fast_log" if fast_log else "logf"
        fused_errors[name] = {
            "logits": compare(f"bench-shape fused estep logits ({name})", fused_logits, logits_p, **LOGITS_TOL),
            "posteriors": compare(f"bench-shape fused estep posteriors ({name})", fused_probs, probs_p, 0.0,
                                  POSTERIOR_ATOL),
        }
        require(torch.equal(fused_probs.argmax(1), probs_p.argmax(1)), f"fused estep ({name}): same argmax")
        row_err = float((fused_probs.sum(dim=1) - 1).abs().max())
        require(row_err <= 1e-5, f"fused estep ({name}): rows sum to 1 within {row_err}")

    def plain_em_ms() -> float:
        with plain_versions():
            return _em_iteration_ms(genotypes, handler, packed)

    runs = {
        "estep": (lambda: estep_logits(*estep_args), lambda: estep_logits_plain(*estep_args)),
        "estep_softmax": (lambda: estep_logits(*estep_args, softmax=True),
                          lambda: estep_logits_plain(*estep_args, softmax=True)),
        "mstep": (lambda: mstep_addition(*mstep_args), lambda: mstep_addition_plain(*mstep_args)),
        "em_iteration": (lambda: _em_iteration_ms(genotypes, handler, packed), plain_em_ms),
    }
    timings = {}
    torch.cuda.reset_peak_memory_stats()
    for name, (kernel, plain) in runs.items():
        measure = _time_ms if name != "em_iteration" else (lambda fn: fn())
        order = ("plain", "kernel", "kernel", "plain")
        samples = {"plain": [], "kernel": []}
        for which in order:
            samples[which].append(measure(plain if which == "plain" else kernel))
        timings[name] = {
            "kernel_ms": samples["kernel"], "plain_ms": samples["plain"],
            "kernel_ms_mean": sum(samples["kernel"]) / 2, "plain_ms_mean": sum(samples["plain"]) / 2,
        }
        say("timing", step=name, card=card, **timings[name])
    say("timing", card=card, max_memory_allocated=torch.cuda.max_memory_allocated(),
        estep_max_abs_err=estep_err, estep_posterior_max_abs_err=post_err, mstep_max_abs_err=mstep_err,
        fused_estep_max_abs_err=fused_errors)
    # the epilogue's library call: torch.softmax alone on the bench logits
    softmax_ms = [_time_ms(lambda: torch.softmax(logits_p, -1)) for _ in range(2)]
    # the fused E-step's log fold: MUFU log2 (the default) against logf, in turns
    fold_ms = {"fast_log": [], "logf": []}
    for fast_log in (True, False, False, True):
        with _log_fold(likelihood_kernel, fast_log):
            fold_ms["fast_log" if fast_log else "logf"].append(
                _time_ms(lambda: estep_logits(*estep_args, softmax=True)))
    say("timing", step="estep_softmax", card=card, torch_softmax_ms=softmax_ms, log_fold_ms=fold_ms)
    timings["torch_softmax_ms"] = sum(softmax_ms) / 2
    timings["log_fold_ms"] = {name: sum(v) / 2 for name, v in fold_ms.items()}

    # the least time the card could take for the same two calls (H100 SXM
    # peaks at 700 W; the card's own limit is printed beside them)
    n_calls, n_barcodes, n_variants = int(lik.calls.q_b.shape[0]), handler.n_barcodes, packed.n_variants
    shape = dict(n_calls=n_calls, n_donors=n_genotypes, n_pseudogenotypes=lik.n_options, n_barcodes=n_barcodes,
                 n_variants=n_variants)
    bounds = {
        "estep": Roofline(**shape),
        "estep_softmax": Roofline(**shape, softmax=True),
        "mstep": MStepRoofline(n_calls=n_calls, n_donors=n_genotypes, n_barcodes=n_barcodes, n_variants=n_variants),
    }
    for name, bound in bounds.items():
        say("timing", step=name, card=card, bound_ms=bound.speed_of_light_s() * 1e3, bound_by=bound.bound_by(),
            bytes=bound.bytes_moved(), operations=bound.operations(),
            share_of_bound=bound.speed_of_light_s() * 1e3 / timings[name]["kernel_ms_mean"])
    return {"timings": timings, "estep_err": estep_err, "mstep_err": mstep_err, "bounds": bounds, "gprob": gprob,
            "fused_errors": fused_errors}


# ---------------------------------------------------------------------------
# phase 6: the BAM path at the end-to-end shape
# ---------------------------------------------------------------------------

def _same_counts(ours: dict, theirs: dict, what: str) -> None:
    require(sorted(ours) == sorted(theirs), f"{what}: chromosomes {sorted(ours)} vs {sorted(theirs)}")
    for chromosome in ours:
        a, b = ours[chromosome], theirs[chromosome]
        require(a.molecules.tobytes() == b.molecules.tobytes(), f"{what}: molecules of {chromosome}")
        require(a.snp_calls.tobytes() == b.snp_calls.tobytes(), f"{what}: calls of {chromosome}")


def _packed_arrays(packed) -> list:
    arrays = [packed.variant2snp, packed.reindex.order, packed.reindex.inverse]
    arrays += [getattr(packed.molecule_calls, field) for field in (
        "variant_id", "snp_id", "compressed_cb", "molecule_id", "p_base_wrong", "p_molecule_aligned_wrong")]
    arrays += [packed.calls_v.vid, packed.calls_v.cb, packed.calls_v.q, packed.calls_v.count]
    return arrays + list(packed.calls_by_barcode())


def _run_cli(bam: str, genotypes, barcodes: list, tmp: Path, *flags: str) -> list:
    """``python -m demuxalot_tpu_torch demux --compact [flags]`` on the BAM; its assignments.csv lines.

    The one part of phases 6 and 8 that uses pandas and pyarrow (betas
    parquet in, CSV out), which phase 1 showed the card's machine has.
    """
    betas = tmp / "prior_betas.parquet"
    genotypes.save_betas(str(betas))
    whitelist = tmp / "barcodes.csv"
    whitelist.write_text("\n".join(barcodes) + "\n")
    out = tmp / ("cli" + "".join(flags).replace("-", "_"))
    cli = [sys.executable, "-m", "demuxalot_tpu_torch", "demux", "--bam", bam, "--barcodes", str(whitelist),
           "--prior-betas", str(betas), "--output-dir", str(out), "--compact", "--damping", "auto",
           "--doublet-prior", str(DOUBLET_PRIOR), "--n-iterations", str(N_ITERATIONS), "--device", "cuda", *flags]
    proc = subprocess.run(cli, cwd=REPO, capture_output=True, text=True, timeout=900)
    require(proc.returncode == 0, f"CLI exited {proc.returncode}: {proc.stderr[-2000:]}")
    return (out / "assignments.csv").read_text().splitlines()


def phase_bam(card: str, tmp: Path) -> dict:
    """Phase 6; the BAM fixture stays in ``tmp`` for phase 7."""
    from demuxalot_tpu_torch import BarcodeHandler, Demultiplexer, count_snps, native, sim
    from demuxalot_tpu_torch.native import hostops
    from demuxalot_tpu_torch.ops.likelihood_kernel import estep_logits
    from demuxalot_tpu_torch.ops.mstep_kernel import mstep_addition

    Demultiplexer.device = "cuda"
    stages = {}
    t0 = time.perf_counter()
    bam, genotypes, _ids, barcode2donors = sim.generate_bam_file(str(tmp / "e2e.bam"), rng=0, **E2E_FIXTURE)
    stages["fixture_s"] = time.perf_counter() - t0
    n_reads = E2E_FIXTURE["n_barcodes"] * E2E_FIXTURE["n_reads_per_barcode"]
    handler = BarcodeHandler(list(barcode2donors))
    positions = genotypes.get_chromosome2positions()
    say("bam", stage="fixture", card=card, seconds=stages["fixture_s"], n_reads=n_reads,
        bam_bytes=Path(bam).stat().st_size, n_variants=genotypes.n_variants)

    # phase 2 built the native libraries; the host ops must run on them
    require(hostops.native_library() is native.load_host_library(), "native host library loaded")

    t0 = time.perf_counter()
    calls = count_snps(bam, positions, handler, joblib_n_jobs=-1, joblib_verbosity=0, native=True)
    stages["count_native_s"] = time.perf_counter() - t0
    n_molecule_calls = sum(c.n_snp_calls for c in calls.values())
    t0 = time.perf_counter()
    python_chr1 = count_snps(bam, {"chr1": positions["chr1"]}, handler, joblib_n_jobs=None,
                             joblib_verbosity=0, native=False)
    stages["count_python_chr1_s"] = time.perf_counter() - t0
    _same_counts({"chr1": calls["chr1"]}, python_chr1, "native vs Python scanner on chr1")
    say("bam", stage="count", card=card, path="native scanner", seconds=stages["count_native_s"],
        reads_per_s=n_reads / stages["count_native_s"], n_molecule_calls=n_molecule_calls,
        python_chr1_s=stages["count_python_chr1_s"], native_equals_python_on_chr1=True)

    t0 = time.perf_counter()
    cli_rows = _run_cli(bam, genotypes, list(barcode2donors), tmp)
    stages["cli_s"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    packed = Demultiplexer.pack_dataset(calls, genotypes)
    stages["pack_native_s"] = time.perf_counter() - t0
    with hostops.numpy_paths():
        t0 = time.perf_counter()
        packed_numpy = Demultiplexer.pack_dataset(calls, genotypes)
        stages["pack_numpy_s"] = time.perf_counter() - t0
    for a, b in zip(_packed_arrays(packed), _packed_arrays(packed_numpy)):
        require(a.dtype == b.dtype and a.tobytes() == b.tobytes(), "native and numpy packing bit-identical")
    say("bam", stage="pack", card=card, native_s=stages["pack_native_s"], numpy_s=stages["pack_numpy_s"],
        n_collapsed_calls=len(packed.calls_v), bit_identical=True)

    estep_logits.launches = 0
    mstep_addition.launches = 0
    t0 = time.perf_counter()
    learnt = Demultiplexer.learn_genotypes_core(packed, genotypes, handler, n_iterations=N_ITERATIONS,
                                                doublet_prior=DOUBLET_PRIOR, damping="auto")
    torch.cuda.synchronize()
    stages["learn_auto_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    compact = Demultiplexer.predict_posteriors_compact(packed, learnt.genotypes, handler, k=E2E_TOPK,
                                                       doublet_prior=DOUBLET_PRIOR)
    stages["predict_compact_s"] = time.perf_counter() - t0
    launches = {"estep_logits": estep_logits.launches, "mstep_addition": mstep_addition.launches}
    expected = {"estep_logits": 2 * N_ITERATIONS + 1, "mstep_addition": 2 * (N_ITERATIONS - 1)}
    require(launches == expected, f"BAM path launches {launches}, expected {expected}")
    say("bam", stage="learn auto + compact", card=card, launches=launches, learn_auto_s=stages["learn_auto_s"],
        damping_selected=learnt.damping_selected, anchored_disagreement=learnt.anchored_disagreement,
        predict_compact_s=stages["predict_compact_s"], bytes_moved=compact.bytes_moved)

    # the compact result against the full frame of the same forward
    logits, probs, columns = Demultiplexer.predict_posteriors_core(packed, learnt.genotypes, handler,
                                                                   doublet_prior=DOUBLET_PRIOR)
    full = logits.cpu().numpy()
    require(bool(np.isfinite(full).all()) and bool(torch.isfinite(probs).all()), "posteriors finite")
    require(bool(np.isfinite(compact.top_logits).all()) and bool(np.isfinite(compact.logsumexp).all()),
            "compact output finite")
    require(bool(torch.isfinite(learnt.state.probs).all()), "EM posteriors finite")
    require(np.array_equal(compact.assignment, full.argmax(axis=1)), "compact assignment = full-frame argmax")
    require(np.array_equal(compact.top_logits, np.take_along_axis(full, compact.top_index, axis=1)),
            "top_logits are exact frame entries")
    truth = np.array([columns.index("+".join(sorted(set(barcode2donors[b])))) for b in compact.barcodes])
    accuracy = float((compact.assignment == truth).mean())
    singlet = np.array([len(set(barcode2donors[b])) == 1 for b in compact.barcodes])
    singlet_accuracy = float((compact.assignment[singlet] == truth[singlet]).mean())
    require(accuracy > 0.9, f"assignment accuracy {accuracy}")
    cli_assignment = [row.split(",")[1] for row in cli_rows[1:]]
    require(cli_rows[0].startswith("BARCODE,assignment") and cli_assignment == compact.assignment_names,
            "the CLI's assignments equal the API's")
    say("bam", stage="checks", card=card, accuracy=accuracy, singlet_accuracy=singlet_accuracy,
        compact_equals_full_argmax=True, top_logits_exact=True, cli_s=stages["cli_s"],
        cli_assignments_equal=True, stages=stages)

    # the same learn + predict through the plain versions on the card, at this
    # path's shapes: most barcodes here span several E-step tiles of calls
    per_barcode = np.bincount(packed.calls_v.cb, minlength=handler.n_barcodes)
    with plain_versions():
        learnt_p = Demultiplexer.learn_genotypes_core(packed, genotypes, handler, n_iterations=N_ITERATIONS,
                                                      doublet_prior=DOUBLET_PRIOR, damping="auto")
        logits_p, probs_p, _ = Demultiplexer.predict_posteriors_core(packed, learnt_p.genotypes, handler,
                                                                     doublet_prior=DOUBLET_PRIOR)
    require(learnt.damping_selected == learnt_p.damping_selected,
            f"damping_selected {learnt.damping_selected} vs plain {learnt_p.damping_selected}")
    errors = {
        "em_posteriors": compare("BAM path EM posteriors", learnt.state.probs, learnt_p.state.probs,
                                 0.0, POSTERIOR_ATOL),
        "learnt_betas": compare("BAM path learnt betas", torch.from_numpy(np.array(learnt.genotypes.get_betas())),
                                torch.from_numpy(np.array(learnt_p.genotypes.get_betas())), **BETAS_TOL),
        "logits": compare("BAM path predict logits", logits, logits_p, **LOGITS_TOL),
        "posteriors": compare("BAM path predict posteriors", probs, probs_p, 0.0, POSTERIOR_ATOL),
    }
    em_argmax_same = float((learnt.state.probs.argmax(1) == learnt_p.state.probs.argmax(1)).float().mean())
    argmax_same = float((probs.argmax(1) == probs_p.argmax(1)).float().mean())
    require(em_argmax_same == 1.0 and argmax_same == 1.0,
            f"argmax agrees on {em_argmax_same} (EM) and {argmax_same} (predict) of barcodes")
    say("bam", stage="plain vs kernels", card=card, max_abs_err=errors, argmax_agreement=argmax_same,
        em_argmax_agreement=em_argmax_same, damping_selected=[learnt.damping_selected, learnt_p.damping_selected],
        anchored_disagreement=[learnt.anchored_disagreement, learnt_p.anchored_disagreement],
        calls_per_barcode={"mean": float(per_barcode.mean()), "max": int(per_barcode.max()),
                           "share_over_128": float((per_barcode > 128).mean())})
    return {"launches": launches, "stages": stages, "errors": errors, "fixture": (bam, genotypes, handler),
            "cli_rows": cli_rows}


# ---------------------------------------------------------------------------
# phase 7: the aggregate-on-SNPs path and SNP discovery
# ---------------------------------------------------------------------------

def phase_aggregate(genotypes, handler, packed, truth, gprob, card: str) -> dict:
    from demuxalot_tpu_torch import Demultiplexer
    from demuxalot_tpu_torch.models import demux
    from demuxalot_tpu_torch.ops import likelihood as L
    from demuxalot_tpu_torch.ops.likelihood_kernel import estep_logits
    from demuxalot_tpu_torch.ops.mstep_kernel import mstep_addition

    Demultiplexer.device = "cuda"
    cuda = demux.resolve_device(Demultiplexer.device)  # the engine's device key, as its layout cache has it
    Demultiplexer.aggregate_on_snps = True
    try:
        torch.cuda.reset_peak_memory_stats()
        estep_logits.launches = 0
        mstep_addition.launches = 0
        demux.STAGE_TIMINGS = {}
        t0 = time.perf_counter()
        learnt = Demultiplexer.learn_genotypes_core(packed, genotypes, handler, n_iterations=N_ITERATIONS,
                                                    doublet_prior=0.0)
        torch.cuda.synchronize()
        learn_s = time.perf_counter() - t0
        learn_launches = {"estep_logits": estep_logits.launches, "mstep_addition": mstep_addition.launches}
        stage_timings, demux.STAGE_TIMINGS = demux.STAGE_TIMINGS, None
        t0 = time.perf_counter()
        compact = Demultiplexer.predict_posteriors_compact(packed, learnt.genotypes, handler,
                                                           doublet_prior=DOUBLET_PRIOR, k=E2E_TOPK)
        compact_s = time.perf_counter() - t0
        launches = {"estep_logits": estep_logits.launches, "mstep_addition": mstep_addition.launches}
        expected = {"estep_logits": 0, "mstep_addition": N_ITERATIONS - 1}
        require(learn_launches == expected, f"aggregate EM launches {learn_launches}, expected {expected}")
        require(launches == expected, f"aggregate path launches {launches}, expected {expected}")
        layout = packed.snp_aggregation_layout(cuda)
        # the learn run's layout_s: this one-off grouping on the host and its upload
        t0 = time.perf_counter()
        demux._SnpAggregationLayout.build(packed.molecule_calls, cuda)
        torch.cuda.synchronize()
        layout_build_s = time.perf_counter() - t0
        say("aggregate", stage="learn + compact", card=card, launches=launches, learn_s=learn_s,
            compact_s=compact_s, layout_build_s=layout_build_s, n_groups=layout.n_groups,
            n_molecule_calls=int(layout.vid.shape[0]), max_molecules_per_group=int(layout.calls_per_group.max()),
            max_memory_allocated=torch.cuda.max_memory_allocated())
        say("aggregate", stage="STAGE_TIMINGS of the learn run", card=card, **stage_timings)

        logits, probs, columns = Demultiplexer.predict_posteriors_core(packed, learnt.genotypes, handler,
                                                                       doublet_prior=DOUBLET_PRIOR)
        n_barcodes, n_donors, n_pg = handler.n_barcodes, len(genotypes.genotype_names), len(columns)
        for name, frame, width in (("em_probs", learnt.state.probs, n_donors), ("logits", logits, n_pg),
                                   ("probs", probs, n_pg)):
            require(tuple(frame.shape) == (n_barcodes, width), f"aggregate {name} shape {tuple(frame.shape)}")
            require(bool(torch.isfinite(frame).all()), f"aggregate {name} has non-finite values")
        row_err = max(float((p.sum(dim=1) - 1).abs().max()) for p in (learnt.state.probs, probs))
        require(row_err <= 1e-5, f"aggregate posterior rows sum to 1 within {row_err}")
        require(bool(np.isfinite(compact.top_logits).all()) and bool(np.isfinite(compact.logsumexp).all()),
                "aggregate compact output finite")
        # the aggregate forward sums in order, so the compact result and a
        # second forward's full frame agree bit for bit
        full = logits.cpu().numpy()
        require(np.array_equal(compact.assignment, full.argmax(axis=1)), "aggregate compact = full-frame argmax")
        require(np.array_equal(compact.top_logits, np.take_along_axis(full, compact.top_index, axis=1)),
                "aggregate top_logits are exact frame entries")
        truth_column = np.array([columns.index("+".join(t)) for t in truth])
        accuracy = float((compact.assignment == truth_column).mean())
        singlet = np.array([len(t) == 1 for t in truth])
        singlet_accuracy = float((compact.assignment[singlet] == truth_column[singlet]).mean())
        require(accuracy >= 0.9, f"aggregate assignment accuracy {accuracy}")

        # a second run through the kernels gives the same bits (every sum of
        # the path runs in a fixed order; with atomic sums in the E-step,
        # five iterations had amplified run-order noise past the posterior bar)
        again = Demultiplexer.learn_genotypes_core(packed, genotypes, handler, n_iterations=N_ITERATIONS,
                                                   doublet_prior=0.0)
        require(torch.equal(again.state.probs, learnt.state.probs) and torch.equal(again.state.logits,
                                                                                   learnt.state.logits),
                "two aggregate EM runs through the kernels are bit-equal")

        # the same path through the plain versions: reruns the M-step, while
        # snp_aggregated_logits is the same torch ops on both runs
        with plain_versions():
            learnt_p = Demultiplexer.learn_genotypes_core(packed, genotypes, handler, n_iterations=N_ITERATIONS,
                                                          doublet_prior=0.0)
            logits_p, probs_p, _ = Demultiplexer.predict_posteriors_core(packed, learnt_p.genotypes, handler,
                                                                         doublet_prior=DOUBLET_PRIOR)
        errors = {
            "em_posteriors": compare("aggregate EM posteriors", learnt.state.probs, learnt_p.state.probs,
                                     0.0, POSTERIOR_ATOL),
            "learnt_betas": compare("aggregate learnt betas",
                                    torch.from_numpy(np.array(learnt.genotypes.get_betas())),
                                    torch.from_numpy(np.array(learnt_p.genotypes.get_betas())), **BETAS_TOL),
            "logits": compare("aggregate predict logits", logits, logits_p, **LOGITS_TOL),
            "posteriors": compare("aggregate predict posteriors", probs, probs_p, 0.0, POSTERIOR_ATOL),
        }
        argmax_same = float((probs.argmax(1) == probs_p.argmax(1)).float().mean())
        require(argmax_same == 1.0, f"aggregate argmax agrees on {argmax_same} of barcodes")
        say("aggregate", stage="checks", card=card, accuracy=accuracy, singlet_accuracy=singlet_accuracy,
            max_row_sum_err=row_err, compact_equals_full_frame=True, kernel_runs_bit_equal=True,
            plain_vs_kernels_max_abs_err=errors,
            argmax_agreement=argmax_same)

        # one snp_aggregated_logits call at the learn run's and the predict's
        # widths; two calls on the same inputs give the same bits
        aggregated_ms = {}
        for prior in (0.0, DOUBLET_PRIOR):
            mixing = torch.from_numpy(L.pseudogenotype_mixing(list(genotypes.genotype_names), prior)[0]).to(cuda)
            run = lambda: layout.logits(gprob, mixing, handler.n_barcodes)  # noqa: E731
            require(torch.equal(run(), run()), f"snp_aggregated_logits bit-equal across calls at prior {prior}")
            torch.cuda.reset_peak_memory_stats()
            samples = [_time_ms(run, repeats=5) for _ in range(2)]
            aggregated_ms[int(mixing.shape[1])] = samples
            say("aggregate", stage="snp_aggregated_logits", card=card, n_columns=int(mixing.shape[1]),
                ms=samples, n_groups=layout.n_groups, bit_equal_across_calls=True,
                max_memory_allocated=torch.cuda.max_memory_allocated())
    finally:
        Demultiplexer.aggregate_on_snps = False
        demux.STAGE_TIMINGS = None
    return {"launches": launches, "accuracy": accuracy, "errors": errors, "aggregated_ms": aggregated_ms,
            "learn_s": learn_s, "compact_s": compact_s}


@contextlib.contextmanager
def _timed_calls(owner, name: str, seconds: list, static: bool = False):
    """Record the seconds of every call of ``owner.name`` in the block (ending in a device sync)."""
    original = getattr(owner, name)

    def timed(*args, **kwargs):
        t0 = time.perf_counter()
        try:
            return original(*args, **kwargs)
        finally:
            torch.cuda.synchronize()
            seconds.append(time.perf_counter() - t0)

    setattr(owner, name, staticmethod(timed) if static else timed)
    try:
        yield
    finally:
        setattr(owner, name, staticmethod(original) if static else original)


def phase_discovery(card: str, fixture: tuple, tmp: Path) -> dict:
    import pandas as pd

    from demuxalot_tpu_torch import Demultiplexer, ProbabilisticGenotypes, detect_snps_positions
    from demuxalot_tpu_torch.bamio import BamReader
    from demuxalot_tpu_torch.frontend import cellranger, native_counter
    from demuxalot_tpu_torch.models import snp_detection
    from demuxalot_tpu_torch.ops.likelihood_kernel import estep_logits
    from demuxalot_tpu_torch.ops.mstep_kernel import mstep_addition

    bam, genotypes, handler = fixture
    Demultiplexer.device = "cuda"
    known = ProbabilisticGenotypes(genotypes.genotype_names)
    for (chrom, pos, base), vid in genotypes.var2varid.items():
        if chrom in DISCOVERY_KNOWN:
            row = known.get_variant_id(chrom, pos, base)
            known.variant_betas[row] = genotypes.variant_betas[vid]
    # the API reads the genotypes as the CLI does: from a betas parquet
    betas = tmp / "known_betas.parquet"
    known.save_betas(str(betas))
    store = ProbabilisticGenotypes(known.genotype_names)
    store.add_prior_betas(str(betas), prior_strength=1.0)
    api_parquet = tmp / "discovered_api.parquet"

    pileups = []  # whether each fragment's pileup took the C++ scanner
    real_pileup = native_counter.try_count_coverage_native

    def counting_pileup(*args, **kwargs):
        counts = real_pileup(*args, **kwargs)
        pileups.append(counts is not None)
        return counts

    walls = {"count": [], "predict": [], "scan": []}
    native_counter.try_count_coverage_native = counting_pileup
    estep_logits.launches = 0
    mstep_addition.launches = 0
    t0 = time.perf_counter()
    try:
        with _timed_calls(snp_detection, "count_snps", walls["count"]), \
                _timed_calls(snp_detection, "_scan_fragments", walls["scan"]), \
                _timed_calls(Demultiplexer, "predict_posteriors_core", walls["predict"], static=True):
            selected = detect_snps_positions(bam, store, handler, joblib_n_jobs=-1, joblib_verbosity=0,
                                             result_beta_prior_filename=str(api_parquet), **DISCOVERY_THRESHOLDS)
    finally:
        native_counter.try_count_coverage_native = real_pileup
    total_s = time.perf_counter() - t0
    launches = {"estep_logits": estep_logits.launches, "mstep_addition": mstep_addition.launches}
    expected = {"estep_logits": 1, "mstep_addition": 0}
    require(launches == expected, f"discovery launches {launches}, expected {expected}")
    n_fragments = len(E2E_FIXTURE["chromosome2length"])
    require(len(pileups) == n_fragments and all(pileups),
            f"every fragment's pileup on the C++ scanner: {pileups}")

    hidden = [(chrom, pos) for chrom, pos, _score, _bases in selected if chrom not in DISCOVERY_KNOWN]
    require(len(hidden) > 0, "sites selected on the hidden chromosomes")
    known_positions = store.get_snp_positions_set()
    require(not any((chrom, pos) in known_positions for chrom, pos, _s, _b in selected),
            "no selected site at a known position")
    true_hidden = {(chrom, pos) for chrom, pos, _base in genotypes.var2varid if chrom not in DISCOVERY_KNOWN}
    true_share = len(set(hidden) & true_hidden) / len(hidden)
    require(true_share > 0.5, f"share of hidden-chromosome sites at true variant positions {true_share}")
    enriched = store.clone()
    enriched.add_prior_betas(str(api_parquet), prior_strength=10)
    require(enriched.n_variants > store.n_variants, "the parquet grows the registry through add_prior_betas")
    say("discovery", stage="detect_snps_positions", card=card, launches=launches, thresholds=DISCOVERY_THRESHOLDS,
        n_selected=len(selected), n_hidden_selected=len(hidden), n_true_hidden_positions=len(true_hidden),
        true_share=true_share, native_pileups=len(pileups), registry=[store.n_variants, enriched.n_variants],
        provisional_count_s=walls["count"][0], predict_s=walls["predict"], scan_s=walls["scan"], total_s=total_s)

    # the C++ pileup against the Python pileup on one hidden chromosome
    chromosome = "chr5"
    length = E2E_FIXTURE["chromosome2length"][chromosome]
    t0 = time.perf_counter()
    native = real_pileup(bam, chromosome, 0, length, cellranger.parse_read, required=True)
    native_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    with BamReader(bam) as reader:
        python = reader.count_coverage(chromosome, 0, length,
                                       read_callback=lambda read: cellranger.parse_read(read) is not None)
    python_s = time.perf_counter() - t0
    require(all(np.array_equal(a, b) for a, b in zip(native, python)) and len(native) == len(python) == 4,
            f"native coverage equals Python coverage on {chromosome}")

    # the CLI on the same inputs writes the API's rows
    whitelist = tmp / "discovery_barcodes.csv"
    whitelist.write_text("\n".join(handler.ordered_barcodes) + "\n")
    cli_parquet = tmp / "discovered_cli.parquet"
    cli = [sys.executable, "-m", "demuxalot_tpu_torch", "detect-snps", "--bam", bam, "--barcodes", str(whitelist),
           "--prior-betas", str(betas), "--out", str(cli_parquet),
           "--min-coverage", str(DISCOVERY_THRESHOLDS["minimum_coverage"]),
           "--min-alternative-coverage", str(DISCOVERY_THRESHOLDS["minimum_alternative_coverage"]),
           "--device", "cuda"]
    t0 = time.perf_counter()
    proc = subprocess.run(cli, cwd=REPO, capture_output=True, text=True, timeout=900)
    cli_s = time.perf_counter() - t0
    require(proc.returncode == 0, f"detect-snps CLI exited {proc.returncode}: {proc.stderr[-2000:]}")
    api_rows, cli_rows = pd.read_parquet(api_parquet), pd.read_parquet(cli_parquet)
    require(len(cli_rows) > 0 and api_rows.equals(cli_rows), "the CLI's parquet rows equal the API's")
    say("discovery", stage="checks", card=card, native_coverage_equals_python=chromosome,
        native_pileup_s=native_s, python_pileup_s=python_s, cli_s=cli_s, cli_rows_equal_api=len(cli_rows))
    return {"launches": launches, "total_s": total_s}


# ---------------------------------------------------------------------------
# phase 8: the barcode-sharded engine
# ---------------------------------------------------------------------------

def phase_sharded(genotypes, handler, packed, truth, main: dict, timing: dict, card: str, bam_result: dict,
                  tmp: Path) -> dict:
    """Phase 8: (a) 4 shards on cuda:0 at the bench shape, (b) two processes (gloo), (c) one-process
    NCCL, (d) ``demux --sharded``."""
    from demuxalot_tpu_torch import Demultiplexer
    from demuxalot_tpu_torch.models.demux import _EMRun
    from demuxalot_tpu_torch.ops.likelihood_kernel import estep_logits
    from demuxalot_tpu_torch.ops.mstep_kernel import mstep_addition
    from demuxalot_tpu_torch.parallel import ShardedDemultiplexer, make_mesh
    from demuxalot_tpu_torch.parallel.sharded import _ShardedEM
    from torch_sharded_worker import free_port, run as worker_run, run_processes

    Demultiplexer.device = "cuda"
    sharded = ShardedDemultiplexer(make_mesh(["cuda:0"] * SHARDS))

    # (a) the main path through the sharded engine, counted
    estep_logits.launches = 0
    mstep_addition.launches = 0
    t0 = time.perf_counter()
    learnt, em_probs = sharded.learn_genotypes(packed, genotypes, handler, n_iterations=N_ITERATIONS,
                                               doublet_prior=DOUBLET_PRIOR)
    logits, probs = sharded.predict_posteriors(packed, learnt, handler, doublet_prior=DOUBLET_PRIOR)
    compact = sharded.predict_posteriors_compact(packed, learnt, handler, doublet_prior=DOUBLET_PRIOR, k=E2E_TOPK)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"estep_logits": estep_logits.launches, "mstep_addition": mstep_addition.launches}
    expected = {"estep_logits": SHARDS * (N_ITERATIONS + 2), "mstep_addition": SHARDS * (N_ITERATIONS - 1)}
    require(launches == expected, f"sharded launches {launches}, expected {expected}")
    require((sharded.layout_cache_misses, sharded.layout_cache_hits) == (2, 2),
            f"layouts built {sharded.layout_cache_misses}, reused {sharded.layout_cache_hits}: expected 2 and 2")
    n_barcodes, n_pg = handler.n_barcodes, probs.shape[1]
    em, logits, probs = (np.array(frame.values) for frame in (em_probs, logits, probs))
    for name, frame in (("em_probs", em), ("logits", logits), ("probs", probs)):
        require(frame.shape == (n_barcodes, n_pg) and bool(np.isfinite(frame).all()), f"sharded {name}: shape, finite")
    require(float(np.abs(probs.sum(axis=1) - 1).max()) <= 1e-5, "sharded posterior rows sum to 1")
    truth_column = np.array([list(em_probs.columns).index("+".join(t)) for t in truth])
    accuracy = float((probs.argmax(1) == truth_column).mean())
    require(accuracy > 0.9, f"sharded assignment accuracy {accuracy}")
    require(np.array_equal(compact.assignment, logits.argmax(1)), "sharded compact = full-frame argmax")
    require(np.array_equal(compact.top_logits, np.take_along_axis(logits, compact.top_index, axis=1)),
            "sharded top_logits are exact frame entries")

    # against the single-device engine on the same inputs: phase 4's EM, and
    # its first E-step and its predict on the sharded run's learnt genotypes
    single = main["state"]
    errors = {
        "em_posteriors": compare("sharded vs single EM posteriors", torch.from_numpy(em), single.probs, 0.0,
                                 POSTERIOR_ATOL),
        "learnt_betas": compare("sharded vs single learnt betas", torch.from_numpy(np.array(learnt.get_betas())),
                                torch.from_numpy(np.array(main["learnt"].get_betas())), **SHARDED_BETAS_TOL),
    }
    require(np.array_equal(em.argmax(1), single.probs.argmax(1).cpu().numpy()), "sharded EM argmax = single's")
    single_logits, _, _ = Demultiplexer.predict_posteriors_core(packed, learnt, handler, doublet_prior=DOUBLET_PRIOR)
    require(np.array_equal(logits, single_logits.cpu().numpy()), "sharded predict logits bit-equal to single's")
    (_, first), = sharded.staged_genotype_learning(packed, genotypes, handler, n_iterations=1,
                                                   doublet_prior=DOUBLET_PRIOR)
    first_single = next(_EMRun(packed, genotypes, handler, 1, 0.01, DOUBLET_PRIOR, None).device_iterations())
    require(np.array_equal(first["barcode_logits"], first_single.logits.cpu().numpy()),
            "sharded iteration-0 logits bit-equal to single's")
    again_learnt, again = sharded.learn_genotypes(packed, genotypes, handler, n_iterations=N_ITERATIONS,
                                                  doublet_prior=DOUBLET_PRIOR)
    require(np.array_equal(again.values, em) and np.array_equal(again_learnt.get_betas(), learnt.get_betas()),
            "two sharded runs bit-equal")
    say("sharded", stage="4 shards on cuda:0, bench shape", card=card, launches=launches, wall_s=wall,
        accuracy=accuracy, max_abs_err=errors, first_estep_bit_equal=True, predict_bit_equal=True,
        runs_bit_equal=True, compact_equals_full_frame=True,
        layout_cache={"misses": sharded.layout_cache_misses, "hits": sharded.layout_cache_hits},
        max_memory_allocated=torch.cuda.max_memory_allocated())

    # one EM iteration, sharded and single-device in turns
    samples = {"single": [], "sharded": []}
    for which in ("single", "sharded", "sharded", "single"):
        samples[which].append(_em_iteration_ms(genotypes, handler, packed,
                                               sharded=sharded if which == "sharded" else None))
    iteration = {"sharded_ms": samples["sharded"], "single_ms": samples["single"],
                 "sharded_ms_mean": sum(samples["sharded"]) / 2, "single_ms_mean": sum(samples["single"]) / 2,
                 "phase5_single_ms_mean": timing["timings"]["em_iteration"]["kernel_ms_mean"]}
    say("sharded", stage="EM iteration", card=card, n_shards=SHARDS, **iteration)

    # where the difference goes: each step over the 4 shards, beside phase 5's single-device calls
    run = _ShardedEM(sharded, packed, genotypes, handler, 2, 0.01, DOUBLET_PRIOR, None, None)
    state = next(run.device_iterations())
    gprob, power = timing["gprob"], float(sharded.contribution_power)
    partials = [mstep_addition(p, o, run.n_genotypes, power) for p, o in zip(state.probs, run.mstep)]
    # the E-step is the fused call (logits and posteriors), as in the EM loop
    steps = {
        "estep_softmax": lambda: [estep_logits(gprob, o, softmax=True) for o in run.estep],
        "mstep": lambda: [mstep_addition(p, o, run.n_genotypes, power) for p, o in zip(state.probs, run.mstep)],
        "reduce": lambda: run._reduce(partials),
    }
    breakdown = {f"{name}_ms": [_time_ms(step) for _ in range(2)] for name, step in steps.items()}
    say("sharded", stage="steps over 4 shards", card=card, **breakdown,
        phase5_single_ms={name: timing["timings"][name]["kernel_ms_mean"] for name in ("estep_softmax", "mstep")})
    iteration["steps"] = breakdown

    # (b) two processes on the one card through gloo, 2 shards each, and (c) one
    # process in an NCCL group with 4 shards, against (a)'s engine in this process
    sizes = dict(MULTIPROCESS, n_iterations=N_ITERATIONS, doublet_prior=DOUBLET_PRIOR)
    reference = worker_run(make_mesh(["cuda:0"] * SHARDS), **sizes)
    flags = [f"--{name.replace('_', '-')}={value}" for name, value in sizes.items()]
    worker = [sys.executable, str(REPO / "tests" / "torch_sharded_worker.py"), "--device", "cuda", *flags]
    children = {}
    for name, backend, world in (("two_processes_gloo", "gloo", 2), ("one_process_nccl", "nccl", 1)):
        out, port = tmp / f"{name}.npz", free_port()
        t0 = time.perf_counter()
        run_processes([[*worker, "--rank", str(rank), "--world", str(world), "--port", str(port), "--backend",
                        backend, "--shards", str(SHARDS // world), "--out", str(out)] for rank in range(world)],
                      timeout=600)
        seconds = time.perf_counter() - t0
        result = dict(np.load(out))
        got = {key: torch.tensor(result[key]) for key in ("em_probs", "betas", "logits")}
        want = {key: torch.tensor(reference[key]) for key in ("em_probs", "betas", "logits")}
        child_errors = {
            "em_posteriors": compare(f"{name} EM posteriors", got["em_probs"], want["em_probs"], 0.0, POSTERIOR_ATOL),
            "learnt_betas": compare(f"{name} learnt betas", got["betas"], want["betas"], **SHARDED_BETAS_TOL),
            "logits": compare(f"{name} predict logits", got["logits"], want["logits"], **LOGITS_TOL),
        }
        require(np.array_equal(result["logits0"], reference["logits0"]), f"{name}: first E-step bit-equal")
        require(np.array_equal(result["em_probs"].argmax(1), reference["em_probs"].argmax(1))
                and np.array_equal(result["top_index"][:, 0], reference["top_index"][:, 0]), f"{name}: same argmax")
        per_process = SHARDS // world
        expected_child = [per_process * (2 + N_ITERATIONS + 2), per_process * (1 + N_ITERATIONS - 1)]
        require(result["launches"].tolist() == expected_child,
                f"{name}: rank 0 launched {result['launches'].tolist()}, expected {expected_child}")
        if backend == "nccl":  # one rank: the all-reduce and the gathers move nothing
            require(all(np.array_equal(result[key], reference[key]) for key in reference if key != "launches"),
                    f"{name}: bit-equal to the in-process run")
        children[name] = {"seconds": seconds, "max_abs_err": child_errors, "launches_rank0": expected_child}
        say("sharded", stage=name, card=card, n_barcodes=MULTIPROCESS["n_barcodes"], processes=world,
            shards_per_process=per_process, seconds=seconds, max_abs_err=child_errors,
            first_estep_bit_equal=True, launches_rank0=result["launches"].tolist(),
            bit_equal=backend == "nccl")

    # (d) the CLI with --sharded on phase 6's BAM
    bam, bam_genotypes, bam_handler = bam_result["fixture"]
    t0 = time.perf_counter()
    rows = _run_cli(bam, bam_genotypes, list(bam_handler.ordered_barcodes), tmp, "--sharded")
    cli_s = time.perf_counter() - t0
    assignment = lambda lines: [line.split(",")[1] for line in lines[1:]]  # noqa: E731
    require(rows[0] == bam_result["cli_rows"][0] and assignment(rows) == assignment(bam_result["cli_rows"]),
            "demux --sharded writes the assignments of demux")
    say("sharded", stage="demux --sharded --compact", card=card, cli_s=cli_s, assignments_equal=len(rows) - 1)
    return {"launches": launches, "errors": errors, "iteration": iteration, "children": children}


# ---------------------------------------------------------------------------
# --parent: this tree's E-step beside an older tree's, in turns
# ---------------------------------------------------------------------------

def estep_ms() -> dict:
    """The bench-shape E-step and its softmax of the package on sys.path, as its EM loop runs them."""
    import inspect

    from demuxalot_tpu_torch.models.demux import _Likelihood
    from demuxalot_tpu_torch.ops import likelihood as L
    from demuxalot_tpu_torch.ops.likelihood_kernel import estep_logits

    genotypes, handler, packed, _truth = _bench_data()
    cuda = torch.device("cuda")
    lik = _Likelihood(packed, handler.n_barcodes, genotypes.genotype_names, DOUBLET_PRIOR, cuda)
    reindex = packed.reindex
    betas = torch.from_numpy(reindex.permute_rows(packed.betas_for(genotypes, False))).to(cuda)
    gprob = L.probs_from_betas(betas, torch.from_numpy(reindex.variant2snp).to(cuda),
                               int(packed.variant2snp.max()) + 1, 0.01, reindex.windowed_max_per_snp)
    fused = "softmax" in inspect.signature(estep_logits).parameters
    if fused:
        step = lambda: estep_logits(gprob, lik.estep, softmax=True)  # noqa: E731
    else:
        step = lambda: torch.softmax(estep_logits(gprob, lik.estep), dim=-1)  # noqa: E731
    return {"package": str(Path(inspect.getfile(estep_logits)).parents[2]), "fused": fused,
            "estep_softmax_ms": [_time_ms(step) for _ in range(3)],
            "estep_ms": [_time_ms(lambda: estep_logits(gprob, lik.estep)) for _ in range(3)]}


def compare_with_parent(parent: Path, card: str) -> None:
    """Each tree's E-step in its own process (one package per process), parent, this, this, parent."""
    samples = {"parent": [], "this": []}
    for which in ("parent", "this", "this", "parent"):
        root = parent if which == "parent" else REPO
        proc = subprocess.run([sys.executable, str(Path(__file__).resolve()), "--estep-ms", str(root)],
                              capture_output=True, text=True, timeout=900)
        require(proc.returncode == 0, f"E-step timing of {root} exited {proc.returncode}: {proc.stderr[-2000:]}")
        result = json.loads(proc.stdout.strip().splitlines()[-1])
        require(Path(result["package"]).resolve() == root.resolve(), f"{root}: imported {result['package']}")
        samples[which].append(result)
        say("parent", tree=which, card=card, **result)
    mean = lambda key, which: sum(sum(r[key]) / len(r[key]) for r in samples[which]) / 2  # noqa: E731
    say("parent", card=card, estep_softmax_ms={w: mean("estep_softmax_ms", w) for w in samples},
        estep_ms={w: mean("estep_ms", w) for w in samples})


def main() -> int:
    import argparse

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--parent", type=Path, help="compare this tree's E-step with the one under this directory")
    parser.add_argument("--estep-ms", type=Path, help=argparse.SUPPRESS)  # a child of --parent
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)", file=sys.stderr)
        return 1
    if args.estep_ms is not None:
        print(json.dumps(estep_ms()), flush=True)
        return 0
    report = phase_device()
    if args.parent is not None:
        phase_build()
        compare_with_parent(args.parent, report["nvidia_smi"])
        return 0
    card = report["nvidia_smi"]
    phase_build()
    phase_kernels()
    genotypes, handler, packed, truth = _bench_data()
    main_result = phase_main(genotypes, handler, packed, truth)
    timing = phase_timing(genotypes, handler, packed, main_result, card)
    with tempfile.TemporaryDirectory() as tmp:
        bam_result = phase_bam(card, Path(tmp))
        aggregate = phase_aggregate(genotypes, handler, packed, truth, timing["gprob"], card)
        discovery = phase_discovery(card, bam_result["fixture"], Path(tmp))
        sharded = phase_sharded(genotypes, handler, packed, truth, main_result, timing, card, bam_result, Path(tmp))
    t = timing["timings"]

    def launches(name: str) -> dict:
        by_path = {"packed_calls": main_result["launches"][name], "bam_flow": bam_result["launches"][name],
                   "aggregate_em": aggregate["launches"][name], "detect_snps": discovery["launches"][name],
                   "sharded": sharded["launches"][name]}
        return {"launches": sum(by_path.values()), "launches_by_path": by_path}

    def bound(step: str) -> dict:
        roofline = timing["bounds"][step]
        return {"bound_ms": roofline.speed_of_light_s() * 1e3, "bound_by": roofline.bound_by()}

    # no single PyTorch call computes either function, so neither has a library time; the E-step's
    # epilogue alone is torch.softmax (softmax_library_ms). The E-step's ms is its fused call, logits and
    # posteriors, as the EM loop and predict make it. Every number here is measured in this run; the
    # earlier kernel's time is in PERF.md
    fused = t["estep_softmax"]["kernel_ms_mean"]
    kernels = [
        {"name": "estep_logits", "route": "cuda", "source": "demuxalot_tpu_torch/csrc/likelihood.cu",
         "replaces": "demuxalot_tpu/ops/pallas_likelihood.py:180", **launches("estep_logits"),
         "max_abs_err": timing["estep_err"],
         "posterior_max_abs_err": timing["fused_errors"]["fast_log"]["posteriors"],
         "ms": fused, "plain_ms": t["estep_softmax"]["plain_ms_mean"], **bound("estep_softmax"),
         "share_of_bound": bound("estep_softmax")["bound_ms"] / fused, "library_ms": None,
         "logits_only_ms": t["estep"]["kernel_ms_mean"], "logf_ms": t["log_fold_ms"]["logf"],
         "softmax_library_ms": t["torch_softmax_ms"]},
        {"name": "mstep_addition", "route": "cuda", "source": "demuxalot_tpu_torch/csrc/mstep.cu",
         "replaces": "demuxalot_tpu/ops/pallas_mstep.py:56", **launches("mstep_addition"),
         "max_abs_err": timing["mstep_err"],
         "ms": t["mstep"]["kernel_ms_mean"], "plain_ms": t["mstep"]["plain_ms_mean"], **bound("mstep"),
         "share_of_bound": bound("mstep")["bound_ms"] / t["mstep"]["kernel_ms_mean"], "library_ms": None},
    ]
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
