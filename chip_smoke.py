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
   spill), the split and group kernels' registers by instantiation, the
   folded and gather-sum kernels' registers and spills, the aggregate
   E-step's kernels' registers (``aggregate.cu``: every instantiation of
   ``aggregate_kernel.TEAM_COLUMNS`` at both copy widths), the
   E-step's hot loop and split (2,2)'s instruction mix per term from
   cuobjdump's SASS (split's kernels must hold HGMMA and no HMMA);
3. kernels: each CUDA kernel against its plain PyTorch version on the card
   at edge shapes (the E-step logits-only and with its fused softmax, with
   and without prior logits), the padding no-op, barcodes that span several
   staged tiles of calls (also against ``tests/oracle.py``, float64
   accumulation), both M-step entry points (``mstep_addition``,
   ``mstep_update``) at SNP runs of 1, 2 and 6 variants (7: addition
   only; and beside variants of C − 1 to 100,000 calls, which the plan
   splits into chunks), p = 1, 2 and 0.5, with and without an anchor mask, against their
   plain versions and bit for bit against the in-order reference
   (``tests/torch_problems.py``) and ``probs_from_betas``, and the oracle
   at a small shape;
4. main path at the bench shape (32 donors, 65,536 SNPs, 65,536 barcodes,
   64 calls per barcode, 20% doublets, seed 0): ``learn_genotypes_core``
   (5 iterations, doublet prior 0.35) then ``predict_posteriors_core``,
   with launch counters (each M-step one ``mstep_update`` launch), output
   checks and truth accuracy, then the same run through the plain versions
   on the card for comparison; then the learn again under
   ``utils.profiling.device_trace`` (its bits equal to the untraced run's,
   the program's spans among the trace's annotations, each E-step and M-step
   kernel launched inside its ``em.estep`` or ``em.mstep`` span, the
   profiler's device time), and the recorder's ``snapshot()`` so far
   (``utils.tracing``: the import, the libraries' loads and builds, the
   stages, the ops' host ns);
5. timing with CUDA events: E-step (logits only), E-step with its fused
   softmax (``estep_softmax``, against the plain logits + ``torch.softmax``),
   the M-step addition, the fused M-step (``mstep_update``), the chain it
   replaces (the addition kernel, then ``probs_from_betas``) and a full EM
   iteration, kernel and plain in turns (plain, kernel, kernel, plain),
   after both M-step entry points are held bit for bit to the in-order
   reference and ``probs_from_betas`` on the main path's inputs (with and
   without a mask); the E-step's and M-step's index checks, which run once
   when their operands are built; the same M-step checks and times on a second pool in
   the bench cells' shape (``SKEWED``, drawn from ``--seed``), whose work
   plan has chunk units where the flat pool has none; that pool again at 64 donors, 2,080 columns (the
   ``pbmc64_65k`` cells' paths): the fused E-step in its 4 schedule passes and the fused aggregate kernel with
   its row split over a block's warps against their plain versions (the aggregate's in blocks of barcodes), the
   fused M-step in 2 donor blocks bit for bit against the in-order reference and against its plain version, and
   each one's launches, time and bound with an EM iteration through either likelihood;
   ``torch.softmax`` alone on the bench logits (the
   epilogue's library call); then what the recorder
   costs: the host µs an EM iteration takes to issue (100 a window, no
   synchronise, the median of 5 windows) and the EM iteration's CUDA-event
   time, with no profiler, with one recording, and with one recording and
   the program's spans off, in turns, and the host µs of each of its
   pieces alone (an iteration span with no profiler, a stage span, an op's
   host counter, the profiler check);
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
   doublet prior 0, one ``STAGE_TIMINGS`` dict printed beside the recorder's
   ``snapshot()`` of the same run) then
   ``predict_posteriors_compact`` (prior 0.35), launch counts (every
   E-step one ``aggregated_logits`` launch), output checks, truth
   accuracy, the predict's device peak above what it held before (its
   output, no [groups, columns] buffer); each EM E-step against the plain
   chain on its own inputs, the EM with the plain M-step at phase 4's bars,
   and the plain path: learnt betas at phase 4's bar, the same argmax, an
   EM drift no larger than the plain path's own with a float64 E-step (five
   iterations amplify float32 rounding) and under a fixed 2e-3, the predict on the same learnt
   genotypes at phase 4's bars; then the aggregate kernel against its plain
   version at 32 and 528 columns on the learn's and predict's operands, at
   64 donors (8,192 barcodes, 2,080 columns) and on the learn's calls
   regrouped 8 a group (groups of many molecules): logits, posteriors,
   argmax, float64 beside both, two runs bit-equal, each call's peak, the
   CUDA-event times in turns beside ``AggregateRoofline``'s bound, the
   aggregate EM iteration and predict in turns; every instantiation that
   holds the row (``aggregate_kernel.instantiations``) at widths 4-528 on
   the bench calls and 561-2,080 on the 64-donor case's, its time and its
   logits against the plan's pick; the wrapper's host µs a call at 32
   columns; and the operands' one check trapping on a group past the calls
   and a variant id past the table, in child processes. (b) On phase 6's BAM with only chr1–chr4 known:
   ``detect_snps_positions`` (the provisional predict launches the E-step
   kernel; the pileup takes the C++ scanner), its selections against the
   hidden truth, the parquet fed back through ``add_prior_betas``, native
   against Python coverage on one chromosome, and ``python -m
   demuxalot_tpu_torch detect-snps`` against the API's parquet;
8. the barcode-sharded engine (``parallel.ShardedDemultiplexer``). (a) 4
   shards on cuda:0 at phase 4's shape: ``learn_genotypes`` (5 iterations,
   prior 0.35), ``predict_posteriors`` and ``predict_posteriors_compact``
   on the learnt genotypes, launch counts (4 shards x 7 E-steps, 4 x 4
   addition-only M-steps), output checks, truth accuracy; iteration-0 and predict logits
   bit-equal to the single-device engine on the same inputs, EM posteriors
   and learnt betas against phase 4's, two sharded runs bit-equal; the
   CUDA-event time of one sharded EM iteration beside the single-device
   one, in turns, and of each step over the 4 shards (the fused E-step,
   M-step, reduction). (b) Two processes on the card joined by ``gloo``, 2
   shards each, and (c) one process in an ``nccl`` group with 4 shards, at
   8,192 barcodes (``tests/torch_sharded_worker.py``, under a timeout),
   against (a)'s engine in this process at that size. (d) ``python -m
   demuxalot_tpu_torch demux --sharded --compact`` on phase 6's BAM against
   phase 6's CLI run;
9. the in-kernel-gather experiments (``demuxalot_tpu_torch.experiments``).
   (a) The banded E-step (1 and 12 bands over 400 variants, 60 over 40,
   some empty; donors 2, 7, 32, 64; padding calls at the ends of band
   segments at 1, 12 and 60 bands, bit-equal), the banded M-step (2 and 40
   bands, p = 1 and 2, variants with no calls, q = 1 calls inserted
   mid-band bit-equal, two 35,000-row bands), the row gather and the
   gather-sum against their plain
   versions (the gather bit for bit, the sum against float64: on chip and
   through L2, W = 7, steps of 1 and 1001, a table of exactly 3 slices and
   one with its last slice short), two runs bit-equal, and an index out of
   range trapping inside the gather-sum on each path, in child processes.
   (b) The A/B at
   the JAX harness's shape (``benchmarks/exp_inkernel_gather_estep.py:28-32``:
   32 donors, 65,536 SNPs, 65,536 barcodes x 64 calls, prior 0.35, 12
   variant bands; learnt-beta G from one EM step of the mainline kernels):
   mainline fused, mainline logits-only and banded E-step, mainline and
   banded M-step, in turns, the banded results at the mainline's bars. (c)
   The same with 400,000 SNPs (800,000 variants, a 102.4 MB G past the
   50 MB L2: the PMBC shape's variant count). (d) The gather rate: both
   gather kernels with 1,048,576 uniform indices (seed 0) on [8192, 64]
   (the TPU bench's table), [131,072, 32] (the bench G) and [800,000, 32];
   (b)-(d) are the experiments' path, counted. Then the plain versions'
   and the library calls' times on the same inputs, and the gather-sum's
   CUDA-graph replay beside ``index_select(...).sum()``'s, in turns, with
   its plan's path, index passes and shared memory;
10. the E-step variants (``experiments.folded_estep``, ``split_estep``,
   ``group_estep``). (a) Each kernel against its plain version at edge
   shapes: donors 2, 7, 32, 64 (2,080 columns), prior 0.25, two barcodes
   in three without calls, one of 1,200 and barcodes at the tiles' edges
   (1, 7, 9, 31, 33, 63, 64, 65 and 129 calls); folded with and without the
   log, split at the harness's five word pairs (all twelve at 7 and 64
   donors), group at G 4 and 8 with 0-2 words; two runs bit-equal, and 999
   padding calls leaving every kernel's logits bit-equal. (b) The A/B of
   ``estep_variants.run_ab`` at the JAX harnesses' shape
   (``synthesize_device_workload(65536, 32, 65536, 64, seed=3)``, prior
   0.25): the mainline fused and logits-only E-step, ``fold_calls``,
   ``folded_logits`` and the two together, split at its five pairs, group
   at G 4 and 8 with 2 words, in turns, each at the mainline's logits bar
   (split (1,1) and (2,1) at their plain version's), folded, split (2,2)
   and (3,2) within 3e-5 of the mainline's posteriors; the experiments'
   path, counted. (c) Each kernel against its plain version there and the
   plain versions' times;
11. the last three TPU harnesses (``experiments.dma_pattern``,
   ``gather_forms``, ``gather_operand``). (a) Each kernel against its plain
   version: the streams' first launches on each route in a child process
   under a timeout (a hang fails the smoke), then each route of
   ``dma_pattern.stream_plan`` (TMA boxes, cp.async), the route asserted,
   on 1M slots, ragged N (66,313 and 70,001), steps of 512,
   4,096 and 32,768, D of 32 and 7 and x one float off a 16-byte boundary,
   against float64 at 1e-6, two runs, a side stream and a graph's replay
   bit for bit;
   take_along_axis on both axes with widths of 7 and 33, at D2's and E2's
   shapes and with the table and indices one float off a 16-byte boundary,
   eagerly, on a side stream and in a CUDA graph's replay, bit for bit, and
   an index out of range on each axis trapping in a child process; the cluster
   gather-sum's first launches in a child process under a timeout (a hang
   fails the smoke), its plan on the card against ``cluster_plan``'s
   mirror, the clusters placed and SMs used, then a ragged last step, every
   index in CTA 0's slice, a width of 7 with steps of 1, 1M indices on the
   harness's table, indices one int past a 16-byte boundary, a short last
   stage with a plain tail and a width of 33, against float64 at 1e-6,
   eagerly, on a side stream and in a graph's replay, bit for bit, an
   index past the table and a negative one trapping in child processes,
   and a 16 MiB table that must raise; tiny at [8, 128], [3, 5],
   [1,000,003] and one float off a boundary, eagerly, on a side stream and
   in a graph's replay, bit for bit; two runs bit-equal. (b) The stream rates at the
   harness's shape (570.4 MB; widths and rows of 512, 2,048, 8,192 and
   32,768): each step's route (TMA at all 8, or the smoke fails), stages and
   box, ms, GB/s and share of the streamed bytes' bound beside ``torch.sum``
   over the streamed bytes in turns, each failing above 1.05 of its bytes'
   bound. (c) The forms probe
   (A-E2 on ``main``'s inputs) and the microbench (4,194,304 indices on
   [8192, 32]: ``index_select(...).sum()``, ``gather_sum`` with its path,
   ``cluster_gather_sum``). (d) The gather-operand stages of phases 1-3 at
   the harness's shape (post [131,072, 528], 10,652,672 gathered columns,
   the mainline E-step on 131,072 barcodes x 72 calls over 327,680 SNPs);
   (b)-(d) are the experiments' path, counted. Then each kernel against its
   plain version at those shapes, the plain versions' and the library
   calls' times (one ``torch.sum`` over the corners, the streams' scalar,
   with ``torch.sum`` over the streamed bytes beside it; ``torch.gather``,
   ``index_select``, ``torch.mul``). The launch-bound kernels,
   take_along_axis at forms C-E2 and tiny at [8, 128], the cluster
   gather-sum at the microbench's shape (with ``index_select(...).sum()``,
   and beside its bound the layout's L2 bytes of indices and slices and the
   floor of its shared-memory reads at the card's highest SM clock), and their library
   calls (``torch.gather`` on int64 indices, ``torch.mul(x, 2.0)``) each
   take three times, each the mean of two samples in turns with the
   library call's (kernel, library, library, kernel): ``ms``, CUDA events
   around 100 eager calls on the same inputs (as do forms A and B);
   ``graph_ms``, 100 calls captured in one CUDA graph and replayed between
   events, the device's time without the host's, each call on the next of
   enough copies of its inputs to fill twice the card's L2 (at most 100
   copies: tiny's 8 KB calls stay in L2 whatever, and take the launch's
   time); ``host_us``, the host clock over 200 calls with no synchronise
   inside (below the launch queue's depth), the median of 5 such windows,
   the host's enqueue time. Beside them the host µs of each piece of a
   launch's host path (a device guard, a stream object and a library
   lookup, which ``_cuda.Entry`` spares a launch; the raw stream handle;
   the output's allocation by ``torch.empty`` and ``torch.empty_like``; the
   ``Entry`` launch alone, and on an empty output, where the C entry returns
   before it launches; the whole wrapper).

The line before the last is a JSON object with one entry per kernel
(``launches``: the mainline kernels' runs on the package paths, phases 4,
6, 7 and 8a, which ``launches_by_path`` keeps apart, with the A/B's runs
of them in ``ab_launches``; ``mstep_update`` stands beside
``mstep_addition`` with the old chain's time; ``estep_logits`` and
``mstep_addition`` carry their operands' one index check's time
(``index_checks_ms``); ``aggregated_logits``'s ``ms`` is its fused call at
528 columns, 32 columns and 64 donors in ``by_columns`` and ``d64``, groups
of 8 molecules in ``many_molecules``, each instantiation by width in
``by_instantiation``, the wrapper's ``host_us``; the E-step's, ``mstep_update``'s and
``aggregated_logits``' ``pool64``, their ``ms``, ``bound_ms`` and launches on phase 5's 64-donor pool; the
experiments' kernels' runs in 9b-d, 10b and 11b-d;
``bound_ms`` is the least time the card could take for the call that
``ms`` times, from ``utils.profiling``, the banded kernels' that of the
function they compute, with their band CSRs in ``layout_bytes``; the
E-step's ``ms`` is its fused call, logits and posteriors, as the EM loop
and predict make it; the gathers' ``ms`` is the TPU bench's table, the gather-sum's with its
``graph_ms`` and plan beside it; the
variants' bound is ``utils.profiling.VariantRoofline``'s, the E-step's
terms over U with the logs the function needs (``log_count``) at the MUFU
rate and split's dense bf16 products on the tensor cores, their U bytes in
``layout_bytes``, split's ``ms`` at (2,2), group's at G 4, each other
setting with its bound in ``by_pair`` and ``by_group``; the streams'
``ms`` at step 512 with its ``path`` (the plan's route), ``stages`` and ``box`` and every
step's in ``by_step``, take_along_axis's at
form D2 with every form in ``by_form``,
the tiny kernel's with the gather-operand stages in ``stages_ms``;
take_along_axis, the cluster gather-sum and tiny carry ``graph_ms``, ``host_us`` and the library
call's ``library_graph_ms`` and ``library_host_us``, with the bytes their
graph's input copies hold in ``graph_input_mb``);
the line before it is nvidia-smi's name and power limit; the last line is
``{"ok": true, "device": {...}}``.

``python3 chip_smoke.py --tracing`` runs only phases 1, 2 and 4 and the
recorder's cost of phase 5; ``--pool64`` only phases 1, 2 and phase 5's
64-donor pool; ``--trace-dir DIR`` keeps phase 4's ``trace.json`` in
``DIR``.

``python3 chip_smoke.py --parent DIR`` runs only the comparison of this
tree with the one under ``DIR`` (an unpacked older commit): phases 1-2,
then each tree's E-step and softmax, M-step and EM iteration at the bench
shape, as its EM loop runs them, its take_along_axis at form D2 and tiny
at [8, 128], gather_sum at [8192, 64] (1,048,576 indices) and
cluster_gather_sum at [8192, 32] (4,194,304), eagerly
(100 calls) and in a CUDA graph's replay, its split E-step at (2,2)
and (0,0), group E-step at G 4 with 2 words and folded E-step at phase
10b's shape, its banded E-step and M-step at phase 9b's shape, and its
aggregate kernel's fused call at 32 and 528 columns, at 64 donors and on
the 32-column calls regrouped 8 a group, with the wrapper's host µs at 32 (a tree without the kernel has none), both
streams at the harness's shape at all 8 steps with each step's route, in its
own process, in turns (parent, this tree, this tree, parent). Then
whether each output is bit-equal to the parent's on the same inputs: the
bench-shape E-step's logits and posteriors, the M-step addition and the
EM loop's M-step, the banded logits and additions (with a digest of the
banded inputs, which the mainline kernels make), gather_sum's sum, each
stream's scalar at each step, the
aggregate kernel's logits and probs at each case, with their largest
difference from the parent's and the argmax agreement; and the E-step's and
M-step's registers in both trees' libraries (``cuobjdump
--dump-resource-usage``), with whether the mainline's are unchanged.
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
if "--steps-ms" in sys.argv[1:-1]:  # a child of --parent imports the package under the given root
    sys.path.insert(0, str(Path(sys.argv[sys.argv.index("--steps-ms") + 1]).resolve()))

BENCH = dict(n_barcodes=65_536, n_donors=32, n_snps=65_536, calls_per_barcode=64)
# phase 5's second pool: BENCH's sizes in the bench cells' shape (bench_h100/configs/pbmc32_65k.json): calls a
# barcode log-normal at log-scale 0.2, the SNP of rank r drawing 1 / r of the calls, the most expressed SNPs every
# 64th position
SKEWED = dict(calls_per_barcode_sigma=0.2, snp_zipf=1.0, snp_rank_stride=64)
DOUBLET_PRIOR = 0.35
N_ITERATIONS = 5
# tolerances: logits as the JAX tests hold the Pallas kernel to the oracle;
# posteriors at the bar the TPU kernel met against full f32; additions as
# the M-step oracle tests
LOGITS_TOL = dict(rtol=1e-4, atol=5e-3)
POSTERIOR_ATOL = 3e-5
ADDITION_TOL = dict(rtol=1e-4, atol=1e-5)
BETAS_TOL = dict(rtol=1e-4, atol=1e-2)
# phase 7a: max |Δposterior| of five aggregate EM iterations from the plain path's
AGGREGATE_EM_DRIFT_CEILING = 2e-3
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
# phase 9c: the bench shape's widths with the PMBC shape's ~800,000 variants
# (E2E_PMBC_r05.json), so G (102.4 MB at 32 donors) outgrows the 50 MB L2
PAST_L2_SNPS = 400_000
# 1M gathered rows summed in f32 against float64: sound sums land within
# 2.1e-7 (H100); one row of N dropped or added moves the sum by about 1/N,
# 9.5e-7 at N = 1,048,576
GATHER_SUM_RTOL = 5e-7


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
    from demuxalot_tpu_torch.utils import tracing

    say("build", seconds=seconds, library=result.path.name, builds=tracing.snapshot()["counters"]["builds"])
    # C7519: ptxas put a warpgroup.arrive before a wgmma that reads registers (split.cu); counted, not printed
    for line in result.log.splitlines():
        if any(key in line for key in ("Compiling entry", "registers", "spill")) and "C7519" not in line:
            print("  ptxas: " + line.strip(), flush=True)
    spills = [line.strip() for line in result.log.splitlines()
              if "spill" in line and "0 bytes spill stores, 0 bytes spill loads" not in line]
    require(not spills, f"kernels spill registers: {spills}")
    kernels = _ptxas_kernels(result.log)
    say("build", variant_registers={name: k["registers"] for name, k in kernels.items()
                                    if name.startswith(("split", "group"))},
        injected_warpgroup_arrives=result.log.count("C7519"))
    say("build", folded_and_gather_sum={name: k for name, k in kernels.items()
                                        if name.startswith(("folded", "gather_sum", "cluster_gather_sum"))})
    # the aggregate E-step (aggregate.cu): <lanes a group (0: the block's warps split the row), columns a lane in
    # registers (0: the shared-memory row), floats per copy>, every instantiation of aggregate_kernel.TEAM_COLUMNS
    # at both copy widths
    from demuxalot_tpu_torch.ops.aggregate_kernel import TEAM_COLUMNS

    aggregate = {name: k for name, k in kernels.items() if name.startswith("aggregate")}
    wanted = 2 * sum(len(cols) for cols in TEAM_COLUMNS.values())
    require(not result.log or len(aggregate) == wanted,
            f"aggregate.cu's {wanted} kernels in ptxas' report: {sorted(aggregate)}")
    say("build", aggregate_registers=aggregate)
    # the E-step's and M-step's instantiations, main path and banded: the banded E-step at the main path's 4
    # blocks of 4 warps per SM, so at most 128 registers; its shared memory at 32 donors (528 columns): each
    # warp's ring of two 32-call tiles, its row of logits and its window of 32 segments (an SM's 228 KB hold a
    # block's bytes and 1 KB the card keeps per block)
    steps = ({name: k["registers"] for name, k in kernels.items() if name.startswith(("estep", "mstep"))}
             or _library_registers(result.path))  # a library built earlier has no ptxas log
    banded_estep = {name: r for name, r in steps.items() if name.startswith("estep") and name.endswith(",1>")}
    require(len(banded_estep) == 2 and max(banded_estep.values()) <= 128,
            f"the banded E-step must fit 128 registers (4 blocks per SM): {banded_estep}")
    shared = 4 * (2 * 32 * 32 + 528 + 32 * 5) * 4
    blocks = min(65_536 // (128 * 128), 233_472 // (shared + 1024))
    say("build", step_registers=steps, banded_estep_blocks_per_sm=blocks, banded_estep_block_shared_bytes=shared)
    cuobjdump = Path(_cuda.find_nvcc()).parent / "cuobjdump"
    require(cuobjdump.is_file(), f"{cuobjdump} reads the kernels' SASS")
    sass = subprocess.run([str(cuobjdump), "-sass", str(result.path)], capture_output=True, text=True).stdout
    say("build", estep_hot_loop=_estep_hot_loops(sass))
    split = _split_sass(sass)
    say("build", split_hot_loop=split)
    require(split["HGMMA"] > 0 and split["HMMA"] == 0,
            f"split.cu's kernels must run on wgmma (HGMMA {split['HGMMA']}) and not mma.sync (HMMA {split['HMMA']})")


def _ptxas_kernels(log: str) -> dict:
    """{kernel<template arguments>: {registers, spill_stores, spill_loads}} of the variants', the gather-sum's and
    the E-step's and M-step's kernels, from ptxas' report: split.cu's (exp_words, sc_words, MMA steps), the
    register-tile kernels of group.cu and folded.cu (words, mode, fold, chunked, vec; folded's are the ragged
    ones), gather.cu's gather-sums (the L2 path's floats per load; the on-chip path's floats per row read,
    16-byte index loads), forms.cu's cluster gather-sum (floats per row read), likelihood.cu's (chunk,
    banded), mstep.cu's (power, depth, update) and banded.cu's (power, depth)."""
    import re

    found, name, spills = {}, None, (0, 0)
    for line in log.splitlines():
        if "Compiling entry function" in line:
            name, spills = _kernel_name(line), (0, 0)
            continue
        spilled = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if spilled is not None and name is not None:
            spills = (int(spilled.group(1)), int(spilled.group(2)))
        used = re.search(r"Used (\d+) registers", line)
        if used is not None and name is not None:
            found[name] = {"registers": int(used.group(1)), "spill_stores": spills[0], "spill_loads": spills[1]}
            name = None
    return found


def _kernel_name(text: str):
    """kernel<template arguments> of the first mangled kernel name in ``text`` that ``_ptxas_kernels`` reports,
    or None."""
    import re

    entry = re.search(r"((?:split_f32|split|tiles|cluster_gather_sum|gather_sum_chip|gather_sum|estep|mstep_banded|"
                      r"aggregate|mstep)_kernel)"
                      r"I(\S*?)EEv", text)
    if entry is None:
        return None
    kind, args = entry.group(1), re.findall(r"L[ib](\d+)E", entry.group(2) + "E")
    if kind == "tiles_kernel":
        kind = "folded_kernel" if args[5] == "1" else "group_kernel"
        args = args[:5]
    return f"{kind}<{','.join(args)}>"


def _library_registers(library: Path) -> dict:
    """{kernel<template arguments>: registers} of the E-step's and M-step's kernels in a built library, from
    ``cuobjdump --dump-resource-usage`` (a library built earlier has no ptxas log)."""
    import re

    from demuxalot_tpu_torch.ops import _cuda

    cuobjdump = Path(_cuda.find_nvcc()).parent / "cuobjdump"
    usage = subprocess.run([str(cuobjdump), "--dump-resource-usage", str(library)], capture_output=True,
                           text=True).stdout
    found = {}
    for mangled, registers in re.findall(r"Function (\S+?):\s*\n\s*REG:(\d+)", usage):
        name = _kernel_name(mangled)
        if name is not None and name.startswith(("estep", "mstep")):
            found[name] = int(registers)
    require(bool(found), f"no E-step or M-step kernel in cuobjdump's resource usage of {library}: {usage[:1500]}")
    return found


def _split_sass(sass: str) -> dict:
    """split.cu's kernels in cuobjdump's SASS: their HGMMA and HMMA counts, and the instruction mix per term of
    the (2,2) kernel at two MMA steps (the harness's pair at 32 donors): the stretch from its first log2 to the
    running sums' store after its last, over the log2 count (one per term)."""
    import collections
    import re

    counts = {"HGMMA": 0, "HMMA": 0}
    per_term = {}
    for function in re.split(r"\n\s+Function : ", sass)[1:]:
        header = function.splitlines()[0]
        if "split" not in header:
            continue
        full = re.findall(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)", function)
        kinds = collections.Counter(op.split(".")[0] for op in full)
        counts["HGMMA"] += kinds["HGMMA"]
        counts["HMMA"] += kinds["HMMA"]
        if "split_kernelILi2ELi2ELi2E" not in header:
            continue
        logs = [i for i, op in enumerate(full) if op == "MUFU.LG2"]
        if not logs:
            continue
        end = next((i for i in range(logs[-1], len(full)) if full[i].startswith("STS")), len(full) - 1)
        kinds = collections.Counter(op.split(".")[0] for op in full[logs[0]: end + 1])
        terms = len(logs)
        per_term = {"terms": terms, "instructions": round(sum(kinds.values()) / terms, 3),
                    **{k: round(kinds[k] / terms, 3) for k in ("MUFU", "F2FP", "FADD", "FMUL", "IMAD", "LOP3",
                                                               "BRA", "ISETP")}}
    return {**counts, "per_term_22": per_term}


def _estep_hot_loops(sass: str) -> dict:
    """Per instantiation of the E-step kernel: the innermost loop with the most FADD and FMUL both (the
    per-call products, 8 calls per trip), its instructions and their main kinds, from cuobjdump's SASS."""
    import collections
    import re

    found = {}
    for function in re.split(r"\n\s+Function : ", sass)[1:]:
        args = re.search(r"estep_kernelILi(\d+)ELb(\d)E", function.splitlines()[0])
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
            found[f"chunk={args.group(1)} banded={bool(int(args.group(2)))}"] = {
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
                              t(p["cb"]), t(p["vid"]), t(p["q"]), len(p["betas"]))
    return gprob, operands


def _mstep_operands(vid: np.ndarray, cb: np.ndarray, q: np.ndarray, n_variants: int, n_barcodes: int, device):
    """Checked MStepOperands of (vid, cb)-sorted calls on ``device``."""
    from demuxalot_tpu_torch.ops.mstep_kernel import mstep_operands

    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
    return mstep_operands(t(_csr(vid, n_variants)), t(vid), t(cb), t(q), n_barcodes)


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
            args = (torch.from_numpy(post).to(cuda), _mstep_operands(vid, cb, q, n_variants, n_barcodes, cuda),
                    n_donors, power)
            got = mstep_addition(*args)
            want = mstep_addition_plain(*args)
            torch.cuda.synchronize()
            err = compare(f"mstep D={n_donors} p={power}", got, want, **ADDITION_TOL)
            say("kernels", kernel="mstep_addition", n_donors=n_donors, power=power, max_abs_err=err)

    phase_mstep_update_kernel()

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
                                                 len(p["variant2snp"]), p["n_barcodes"], cuda), 6, 2.0)
    err_m = compare("mstep vs oracle", got_m, torch.from_numpy(ref_m), **ADDITION_TOL)
    say("kernels", oracle="tests/oracle.py", estep_max_abs_err=err, mstep_max_abs_err=err_m)


def phase_mstep_update_kernel() -> None:
    """Both M-step kernels at the card tests' shapes: SNP runs of 1, 2 and 6 variants (7: addition only),
    and runs of 1, 2 and 6 beside variants of C − 1 to 100,000 calls (``update_problem(heavy=True)``: chunk
    units), p = 1, 2 and 0.5, with and without an anchor mask. Against the plain versions at the addition bar
    and 1e-6, and bit for bit: the addition against the in-order reference (chunked past C calls),
    ``genotype_prob`` against ``probs_from_betas`` on the kernel's own addition."""
    from demuxalot_tpu_torch.ops import likelihood as L
    from demuxalot_tpu_torch.ops.mstep_kernel import mstep_addition, mstep_update, mstep_update_plain
    from torch_problems import float64_update, in_order_addition, mstep_operands, t, update_problem

    cuda = torch.device("cuda")
    for n_donors in (1, 32, 65):
        for runs, heavy in (((1,), False), ((2,), False), ((6,), False), ((1, 2, 6), False), ((7,), False),
                            ((1, 2, 6), True)):
            p = update_problem(seed=n_donors + len(runs), n_donors=n_donors, runs=runs, heavy=heavy)
            windowed = max(runs) <= 6
            ops = mstep_operands(p["vid"], p["cb"], p["q"], p["n_variants"], len(p["post"]), cuda,
                                 snp_ptr=p["snp_ptr"] if windowed else None)
            post, prior, v2s = t(p["post"], cuda), t(p["prior"], cuda), t(p["variant2snp"], cuda)
            errors = {}
            for power in (1.0, 2.0, 0.5):
                want = in_order_addition(post, ops, n_donors, power)
                what = f"D={n_donors} runs={runs} p={power}"
                require(torch.equal(mstep_addition(post, ops, n_donors, power), want),
                        f"mstep_addition {what}: bit-equal to the in-order reference")
                if not windowed:
                    continue
                for mask in (None, t(p["mask"], cuda)):
                    launches = mstep_update.launches
                    addition, gprob = mstep_update(post, ops, prior, mask, 0.01, n_donors, power)
                    require(mstep_update.launches == launches + 1, f"mstep_update {what}: one launch")
                    plain_addition, plain_gprob = mstep_update_plain(post, ops, prior, mask, 0.01, n_donors, power)
                    masked = "mask" if mask is not None else "no mask"
                    # beside a 100,000-call variant, genotype_prob at 1e-6 against a float64 addition's: the float32
                    # plain path's own rounding there exceeds the bar
                    want_gprob = float64_update(p, ops, mask, power, cuda).float() if heavy else plain_gprob
                    errors[f"p={power} {masked}"] = [
                        compare(f"mstep_update addition {what} {masked}", addition, plain_addition, **ADDITION_TOL),
                        compare(f"mstep_update genotype_prob {what} {masked}", gprob, want_gprob, 0.0, 1e-6)]
                    require(torch.equal(addition, want if mask is None else want * mask),
                            f"mstep_update {what} {masked}: addition bit-equal to the in-order reference")
                    require(torch.equal(gprob, L.probs_from_betas(prior + addition, v2s, p["n_snps"], 0.01,
                                                                  p["max_per_snp"])),
                            f"mstep_update {what} {masked}: genotype_prob bit-equal to probs_from_betas")
            say("kernels", kernel="mstep_update" if windowed else "mstep_addition", n_donors=n_donors, runs=runs,
                heavy=heavy, chunks=ops.plan.n_chunks, n_variants=p["n_variants"], bit_equal=True,
                max_abs_err=errors)


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


def _mainline_kernels() -> dict:
    """{name: wrapper} of the package paths' kernels (each wrapper carries ``.launches``)."""
    from demuxalot_tpu_torch.ops.aggregate_kernel import aggregated_logits
    from demuxalot_tpu_torch.ops.likelihood_kernel import estep_logits
    from demuxalot_tpu_torch.ops.mstep_kernel import mstep_addition, mstep_update

    return {"estep_logits": estep_logits, "mstep_addition": mstep_addition, "mstep_update": mstep_update,
            "aggregated_logits": aggregated_logits}


def _zero_launches() -> None:
    for kernel in _mainline_kernels().values():
        kernel.launches = 0


def _launches() -> dict:
    return {name: kernel.launches for name, kernel in _mainline_kernels().items()}


@contextlib.contextmanager
def plain_versions(*names: str, **replacements):
    """Point the engine at the kernels' plain versions (comparison runs only): every kernel's, or those of
    ``names``; ``replacements`` binds other functions in their place."""
    from demuxalot_tpu_torch.models import demux
    from demuxalot_tpu_torch.ops.aggregate_kernel import aggregated_logits_plain
    from demuxalot_tpu_torch.ops.likelihood_kernel import estep_logits_plain
    from demuxalot_tpu_torch.ops.mstep_kernel import mstep_addition_plain, mstep_update_plain

    plain = {"estep_logits": estep_logits_plain, "mstep_addition": mstep_addition_plain,
             "mstep_update": mstep_update_plain, "aggregated_logits": aggregated_logits_plain}
    bound = {name: plain[name] for name in (names or plain)}
    bound.update(replacements)
    saved = {name: getattr(demux, name) for name in bound}
    for name, fn in bound.items():
        setattr(demux, name, fn)
    try:
        yield
    finally:
        for name, kernel in saved.items():
            setattr(demux, name, kernel)


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


def _device_microseconds(prof) -> float:
    """The device time a profiler's ``key_averages()`` holds, µs (0 where it saw no device)."""
    return sum(getattr(e, "self_device_time_total", getattr(e, "self_cuda_time_total", 0))
               for e in prof.key_averages())


def _traced_learn(genotypes, handler, packed, untraced_state, trace_dir) -> dict:
    """Phase 4's learn under ``device_trace``: the same bits, the program's spans in the trace around its kernels."""
    from demuxalot_tpu_torch import Demultiplexer
    from demuxalot_tpu_torch.utils import device_trace

    with tempfile.TemporaryDirectory() as tmp:
        where = Path(trace_dir or tmp)
        t0 = time.perf_counter()
        with device_trace(str(where)) as prof:
            learnt = Demultiplexer.learn_genotypes_core(packed, genotypes, handler, n_iterations=N_ITERATIONS,
                                                        doublet_prior=DOUBLET_PRIOR)
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        events = [e for e in json.loads((where / "trace.json").read_text())["traceEvents"] if e.get("ph") == "X"]
    require(torch.equal(learnt.state.probs, untraced_state.probs), "the traced learn gives the untraced bits")
    annotations = {}
    for e in events:
        if e.get("cat") == "user_annotation":
            annotations[e["name"]] = annotations.get(e["name"], 0) + 1
    spans = [(e["name"], e["tid"], e["ts"], e["ts"] + e["dur"]) for e in events
             if e.get("cat") == "user_annotation" and e["name"] in ("em.estep", "em.mstep")]
    calls = {e["args"]["correlation"]: e for e in events
             if e.get("cat") == "cuda_runtime" and "correlation" in e.get("args", {})}
    inside = {"estep_kernel": 0, "mstep_kernel": 0}
    for e in events:
        for kernel, span in (("estep_kernel", "em.estep"), ("mstep_kernel", "em.mstep")):
            if e.get("cat") == "kernel" and kernel in e["name"]:
                call = calls[e["args"]["correlation"]]
                inner = (call["tid"], call["ts"], call["ts"] + call["dur"])
                require(any(name == span and tid == inner[0] and start <= inner[1] <= inner[2] <= end
                            for name, tid, start, end in spans), f"{kernel} launched outside {span}")
                inside[kernel] += 1
    require(inside == {"estep_kernel": N_ITERATIONS, "mstep_kernel": N_ITERATIONS - 1},
            f"E-step and M-step kernels inside their spans: {inside}")
    device_us = _device_microseconds(prof)
    require(device_us > 0, "the profiler's key_averages() hold device time")
    say("main", path="device_trace", wall_s=wall, kernels_inside_their_spans=inside, annotations=annotations,
        key_averages_device_us=device_us, kernel_events=sum(e.get("cat") == "kernel" for e in events),
        trace=str(where / "trace.json") if trace_dir else None)
    return annotations


def phase_main(genotypes, handler, packed, truth, trace_dir=None) -> dict:
    from demuxalot_tpu_torch import Demultiplexer
    from demuxalot_tpu_torch.utils import tracing

    Demultiplexer.device = "cuda"
    require(packed.reindex.windowed_max_per_snp > 0, "the bench shape's SNP runs take the fused M-step")
    _zero_launches()
    t0 = time.perf_counter()
    learnt, state, logits, probs, columns = _run_main_path(genotypes, handler, packed)
    wall = time.perf_counter() - t0
    launches = _launches()
    # every M-step is one mstep_update launch (addition, mask and the next normalisation)
    expected = {"estep_logits": N_ITERATIONS + 1, "mstep_addition": 0, "mstep_update": N_ITERATIONS - 1,
                "aggregated_logits": 0}
    require(launches == expected, f"main path launches {launches}, expected {expected}")

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
    _traced_learn(genotypes, handler, packed, state, trace_dir)
    say("main", path="tracing.snapshot()", **tracing.snapshot())
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


def _rotation(fn, inputs: tuple, calls: int = 100) -> tuple:
    """(copies, bytes per call) for ``_graph_ms``: a call's bytes are its inputs' and its output's, and the copies
    of ``inputs`` fill twice the card's L2, at most ``calls`` of them."""
    nbytes = sum(t.nbytes for t in inputs) + fn(*inputs).nbytes
    l2 = torch.cuda.get_device_properties(torch.cuda.current_device()).L2_cache_size
    return max(1, min(calls, -(-2 * l2 // nbytes))), nbytes


def _graph_ms(fn, inputs: tuple, calls: int = 100, replays: int = 5) -> float:
    """Device ms per call of ``fn(*inputs)``: ``calls`` calls captured in one CUDA graph (after a warm-up on a side
    stream, as ``torch.cuda.graphs`` asks), replayed ``replays`` times between events, per call. No host path in
    it. Call k reads copy k % copies of ``inputs`` (``_rotation``) and every output is kept, so a call's bytes come
    from HBM as an eager call's on fresh data would, not from the L2 that the call before it filled; a call of
    under 1 MB (tiny's 8 KB) stays in L2 whatever, and takes the launch's time."""
    copies, _ = _rotation(fn, inputs, calls)
    sets = [inputs] + [tuple(t.clone() for t in inputs) for _ in range(copies - 1)]
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn(*inputs)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = [fn(*sets[k % copies]) for k in range(calls)]
    graph.replay()  # warm
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / (replays * calls)
    del graph, outs, sets
    return ms


def _host_us(fn, calls: int = 200, windows: int = 5) -> float:
    """Host enqueue time per call, µs: the host clock over ``calls`` calls with no synchronise inside the window,
    the median of ``windows`` windows (the host's cores are shared). 200 launches stay well below the launch
    queue's depth, so the host never waits on the card."""
    fn()
    fn()  # warm
    samples = []
    for _ in range(windows):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        samples.append((time.perf_counter() - t0) * 1e6 / calls)
    torch.cuda.synchronize()
    return float(np.median(samples))


@contextlib.contextmanager
def _spans_off():
    """The recorder as where no profiler records: no iteration span and no annotation (comparison runs only)."""
    from demuxalot_tpu_torch.utils import tracing

    saved = tracing.profiling
    tracing.profiling = lambda: False
    try:
        yield
    finally:
        tracing.profiling = saved


def _piece_us(fn, calls: int = 100_000) -> float:
    """Host µs a call of ``fn``, over ``calls`` calls in a row."""
    fn()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    return (time.perf_counter() - t0) * 1e6 / calls


def phase_tracing_cost(genotypes, handler, packed, card: str) -> dict:
    """What the recorder costs on the EM loop: with no profiler, with one recording, with one and no spans."""
    from demuxalot_tpu_torch.models.demux import _EMRun
    from demuxalot_tpu_torch.utils import tracing

    run = _EMRun(packed, genotypes, handler, 1 << 62, 0.01, DOUBLET_PRIOR, None)
    iterations = run.device_iterations()
    pull = lambda: next(iterations)
    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]

    def measure(setting: str) -> dict:
        with contextlib.ExitStack() as stack:
            if setting != "no_profiler":
                stack.enter_context(torch.profiler.profile(activities=activities))
            if setting == "profiler_spans_off":
                stack.enter_context(_spans_off())
            return {"host_us": _host_us(pull, calls=100), "em_iter_ms": _time_ms(pull, repeats=50)}

    settings = ("no_profiler", "profiler", "profiler_spans_off")
    samples = {s: [] for s in settings}
    for setting in (*settings, *reversed(settings)):  # in turns
        samples[setting].append(measure(setting))
    loop = {s: {k: (a[k] + b[k]) / 2 for k in a} for s, (a, b) in samples.items()}

    def iteration_span():
        with tracing.step("em.estep"):
            pass

    def stage_span():
        with tracing.span("chip_smoke.stage"):
            pass

    def noop():
        pass

    counted = tracing.timed_op(noop)
    counted()
    pieces = {"iteration_span_no_profiler_us": _piece_us(iteration_span), "stage_span_us": _piece_us(stage_span),
              "op_counter_us": _piece_us(counted) - _piece_us(noop), "profiler_check_us": _piece_us(tracing.profiling)}
    tracing._ops.remove(counted)
    # an iteration with no profiler: two op counters and two iteration spans (the fused M-step)
    pieces["per_iteration_no_profiler_us"] = 2 * (pieces["op_counter_us"] + pieces["iteration_span_no_profiler_us"])
    say("tracing", card=card, loop=loop, samples=samples, pieces=pieces)
    iterations.close()
    return {"loop": loop, "pieces": pieces}


def _sm_clock_mhz() -> float:
    """The card's highest SM clock in MHz, as nvidia-smi reports it."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, check=True).stdout
    return float(out.strip().splitlines()[0])


def _in_turns(first, second, measure) -> tuple:
    """(``measure(first)``, ``measure(second)``), each the mean of two samples taken in turns: first, second,
    second, first."""
    a1, b1, b2, a2 = measure(first), measure(second), measure(second), measure(first)
    return (a1 + a2) / 2, (b1 + b2) / 2


def _em_iteration_ms(genotypes, handler, packed, repeats: int = 5, sharded=None,
                     doublet_prior: float = DOUBLET_PRIOR) -> float:
    """Per-iteration time of the EM generator in steady state (M + E step), or of ``sharded``'s."""
    from demuxalot_tpu_torch.models.demux import _EMRun
    from demuxalot_tpu_torch.parallel.sharded import _ShardedEM

    if sharded is None:
        run = _EMRun(packed, genotypes, handler, repeats + 2, 0.01, doublet_prior, None)
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
    from demuxalot_tpu_torch.ops import likelihood_kernel, mstep_kernel
    from demuxalot_tpu_torch.ops.likelihood_kernel import estep_logits, estep_logits_plain
    from demuxalot_tpu_torch.ops.mstep_kernel import (
        mstep_addition, mstep_addition_plain, mstep_update, mstep_update_plain)
    from demuxalot_tpu_torch.utils.profiling import MStepRoofline, Roofline
    from torch_problems import in_order_addition

    cuda = torch.device("cuda")
    lik = _Likelihood(packed, handler.n_barcodes, genotypes.genotype_names, DOUBLET_PRIOR, cuda)
    reindex = packed.reindex
    variant2snp = torch.from_numpy(reindex.variant2snp).to(cuda)
    n_snps, window = int(packed.variant2snp.max()) + 1, reindex.windowed_max_per_snp
    betas = torch.from_numpy(reindex.permute_rows(packed.betas_for(main["learnt"], False))).to(cuda)
    gprob = L.probs_from_betas(betas, variant2snp, n_snps, 0.01, window)
    probs = main["state"].probs
    n_genotypes = len(genotypes.genotype_names)
    power = float(Demultiplexer.contribution_power)
    estep_args = (gprob, lik.estep)
    mstep_args = (probs, lik.mstep, n_genotypes, power)
    # the EM's own M-step inputs: its prior betas (data prior added), no mask on the main path; a mask
    # that takes every third variant off checks the masked epilogue at this shape too
    prior = torch.from_numpy(reindex.permute_rows(packed.betas_for(genotypes, True))).to(cuda)
    anchor = (torch.arange(packed.n_variants, device=cuda) % 3 != 0).to(torch.float32)[:, None]
    update_args = (probs, lik.mstep, prior, None, 0.01, n_genotypes, power)
    old_chain = lambda addition: L.probs_from_betas(prior + addition(*mstep_args), variant2snp, n_snps, 0.01,  # noqa
                                                    window)

    require(lik.mstep.plan.n_chunks == 0, "the flat bench pool: no variant past CHUNK_CALLS calls")
    # kernel vs plain on the main path's own inputs at the bench shape
    logits_k = estep_logits(*estep_args)
    logits_p = estep_logits_plain(*estep_args)
    estep_err = compare("bench-shape estep", logits_k, logits_p, **LOGITS_TOL)
    post_err = compare("bench-shape estep posteriors", torch.softmax(logits_k, -1),
                       torch.softmax(logits_p, -1), 0.0, POSTERIOR_ATOL)
    mstep_err = compare("bench-shape mstep", mstep_addition(*mstep_args),
                        mstep_addition_plain(*mstep_args), **ADDITION_TOL)
    # both M-step entry points bit for bit: the addition against the in-order reference (each sum one
    # chain in call order, chunked past CHUNK_CALLS calls, every multiply and add its own op), genotype_prob
    # against probs_from_betas on the kernel's own addition
    in_order = in_order_addition(*mstep_args)
    require(torch.equal(mstep_addition(*mstep_args), in_order), "bench-shape mstep_addition: bit-equal in order")
    update_err = {}
    for mask in (None, anchor):
        masked = "mask" if mask is not None else "no mask"
        addition, update_gprob = mstep_update(probs, lik.mstep, prior, mask, 0.01, n_genotypes, power)
        require(torch.equal(addition, in_order if mask is None else in_order * mask),
                f"bench-shape mstep_update ({masked}): addition bit-equal in order")
        require(torch.equal(update_gprob, L.probs_from_betas(prior + addition, variant2snp, n_snps, 0.01, window)),
                f"bench-shape mstep_update ({masked}): genotype_prob bit-equal to probs_from_betas")
        plain_addition, plain_gprob = mstep_update_plain(probs, lik.mstep, prior, mask, 0.01, n_genotypes, power)
        update_err[masked] = {
            "addition": compare(f"bench-shape mstep_update addition ({masked})", addition, plain_addition,
                                **ADDITION_TOL),
            "genotype_prob": compare(f"bench-shape mstep_update genotype_prob ({masked})", update_gprob,
                                     plain_gprob, 0.0, 1e-6)}
    # the fused E-step (the EM loop's and predict's call) against the plain
    # logits + torch.softmax
    probs_p = torch.softmax(logits_p, -1)
    fused_logits, fused_probs = estep_logits(*estep_args, softmax=True)
    fused_errors = {
        "logits": compare("bench-shape fused estep logits", fused_logits, logits_p, **LOGITS_TOL),
        "posteriors": compare("bench-shape fused estep posteriors", fused_probs, probs_p, 0.0, POSTERIOR_ATOL),
    }
    require(torch.equal(fused_probs.argmax(1), probs_p.argmax(1)), "fused estep: same argmax")
    row_err = float((fused_probs.sum(dim=1) - 1).abs().max())
    require(row_err <= 1e-5, f"fused estep: rows sum to 1 within {row_err}")

    def plain_em_ms() -> float:
        with plain_versions():
            return _em_iteration_ms(genotypes, handler, packed)

    runs = {
        "estep": (lambda: estep_logits(*estep_args), lambda: estep_logits_plain(*estep_args)),
        "estep_softmax": (lambda: estep_logits(*estep_args, softmax=True),
                          lambda: estep_logits_plain(*estep_args, softmax=True)),
        "mstep": (lambda: mstep_addition(*mstep_args), lambda: mstep_addition_plain(*mstep_args)),
        "mstep_update": (lambda: mstep_update(*update_args), lambda: mstep_update_plain(*update_args)),
        # what mstep_update replaces, as this tree runs it: the addition kernel, then probs_from_betas
        "old_chain": (lambda: old_chain(mstep_addition), lambda: old_chain(mstep_addition_plain)),
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
        mstep_update_max_abs_err=update_err, mstep_bit_equal_in_order=True, fused_estep_max_abs_err=fused_errors)
    # the index checks (checks.cu's kernels over each op's indices) run once, when the operands are built;
    # before, every M-step launch ran the M-step's two and every E-step launch the E-step's three
    o, e = lik.mstep, lik.estep
    check_launches = {
        "mstep": lambda: mstep_kernel._check_on_card(o.var_ptr, o.var_ptr.data_ptr(), o.n_variants, o.cb.shape[0],
                                                     o.cb.data_ptr(), o.n_barcodes),
        "estep": lambda: likelihood_kernel._check_on_card(
            e.vid, e.row_ptr.data_ptr(), e.n_barcodes, e.vid.shape[0], e.vid.data_ptr(), e.n_variants,
            e.schedule.data_ptr(), e.schedule.shape[0], likelihood_kernel.ENTRY, n_genotypes, lik.n_options)}
    checks_ms = {name: [_time_ms(launch) for _ in range(2)] for name, launch in check_launches.items()}
    say("timing", step="index checks", card=card, ms=checks_ms)
    timings["checks_ms"] = {name: sum(v) / 2 for name, v in checks_ms.items()}
    # the epilogue's library call: torch.softmax alone on the bench logits
    softmax_ms = [_time_ms(lambda: torch.softmax(logits_p, -1)) for _ in range(2)]
    say("timing", step="estep_softmax", card=card, torch_softmax_ms=softmax_ms)
    timings["torch_softmax_ms"] = sum(softmax_ms) / 2

    # the least time the card could take for the same two calls (H100 SXM
    # peaks at 700 W; the card's own limit is printed beside them)
    n_calls, n_barcodes, n_variants = int(lik.calls.q_b.shape[0]), handler.n_barcodes, packed.n_variants
    shape = dict(n_calls=n_calls, n_donors=n_genotypes, n_pseudogenotypes=lik.n_options, n_barcodes=n_barcodes,
                 n_variants=n_variants)
    run_lengths = np.diff(lik.mstep.snp_ptr.cpu().numpy())
    mstep_shape = dict(n_calls=n_calls, n_donors=n_genotypes, n_barcodes=n_barcodes, n_variants=n_variants)
    bounds = {
        "estep": Roofline(**shape),
        "estep_softmax": Roofline(**shape, softmax=True),
        "mstep": MStepRoofline(**mstep_shape),
        "mstep_update": MStepRoofline(**mstep_shape, n_runs=len(run_lengths),
                                      neighbour_adds=int((run_lengths * (run_lengths - 1)).sum())),
    }
    for name, bound in bounds.items():
        say("timing", step=name, card=card, bound_ms=bound.speed_of_light_s() * 1e3, bound_by=bound.bound_by(),
            bytes=bound.bytes_moved(), operations=bound.operations(),
            share_of_bound=bound.speed_of_light_s() * 1e3 / timings[name]["kernel_ms_mean"])
    return {"timings": timings, "estep_err": estep_err, "mstep_err": mstep_err, "bounds": bounds, "gprob": gprob,
            "fused_errors": fused_errors, "update_err": update_err}


def _skewed_data(seed: int, n_barcodes: int = BENCH["n_barcodes"], n_donors: int = BENCH["n_donors"],
                 n_snps: int = BENCH["n_snps"], calls_per_barcode: int = BENCH["calls_per_barcode"]):
    """(genotypes, handler, packed) of a pool in the bench cells' shape (``SKEWED``), drawn with numpy from
    ``seed`` (``tests/torch_problems.py:skewed_pool``). Its most expressed SNPs hold variants of tens of thousands
    of calls, past ``CHUNK_CALLS``, where BENCH's flat pool holds none."""
    from torch_problems import skewed_pool

    return skewed_pool(seed, n_barcodes, n_donors, n_snps, calls_per_barcode,
                       sigma=SKEWED["calls_per_barcode_sigma"], zipf=SKEWED["snp_zipf"],
                       stride=SKEWED["snp_rank_stride"])


def phase_skewed_mstep(card: str, seed: int) -> dict:
    """Phase 5's M-step on the bench cells' pool shape (``_skewed_data``), where the plan holds chunk units: both
    entry points bit for bit against the in-order reference (chunked past ``CHUNK_CALLS`` calls) and
    ``probs_from_betas`` on the kernel's own addition, against their plain versions at the addition bar and
    ``genotype_prob`` at 1e-6, and ``genotype_prob`` at 1e-6 against ``probs_from_betas`` on a float64 addition
    too, with and without a mask; then both kernels' times, their bounds and an EM iteration, as phase 5 gives
    them for the flat pool."""
    from demuxalot_tpu_torch import Demultiplexer
    from demuxalot_tpu_torch.models.demux import _Likelihood
    from demuxalot_tpu_torch.ops import likelihood as L
    from demuxalot_tpu_torch.ops.likelihood_kernel import estep_logits
    from demuxalot_tpu_torch.ops.mstep_kernel import (
        mstep_addition, mstep_addition_plain, mstep_update, mstep_update_plain)
    from demuxalot_tpu_torch.utils.profiling import MStepRoofline
    from torch_problems import in_order_addition

    t0 = time.perf_counter()
    genotypes, handler, packed = _skewed_data(seed)
    cuda = torch.device("cuda")
    lik = _Likelihood(packed, handler.n_barcodes, genotypes.genotype_names, DOUBLET_PRIOR, cuda)
    o = lik.mstep
    require(o.snp_ptr is not None and o.plan.n_chunks > 0, "skewed pool: SNP runs, and chunk units in the plan")
    reindex = packed.reindex
    variant2snp = torch.from_numpy(reindex.variant2snp).to(cuda)
    n_snps, window = int(packed.variant2snp.max()) + 1, reindex.windowed_max_per_snp
    betas = torch.from_numpy(reindex.permute_rows(packed.betas_for(genotypes, False))).to(cuda)
    _logits, probs = estep_logits(L.probs_from_betas(betas, variant2snp, n_snps, 0.01, window), lik.estep,
                                  softmax=True)
    prior = torch.from_numpy(reindex.permute_rows(packed.betas_for(genotypes, True))).to(cuda)
    anchor = (torch.arange(packed.n_variants, device=cuda) % 3 != 0).to(torch.float32)[:, None]
    n_genotypes, power = len(genotypes.genotype_names), float(Demultiplexer.contribution_power)
    args = (probs, o, n_genotypes, power)

    in_order = in_order_addition(*args)
    require(torch.equal(mstep_addition(*args), in_order), "skewed mstep_addition: bit-equal in order")
    errors = {"addition": compare("skewed mstep_addition", mstep_addition(*args), mstep_addition_plain(*args),
                                  **ADDITION_TOL)}
    q = o.q.double().unsqueeze(1)
    terms = torch.where(q >= 1, 0.0, (probs.double()[o.cb.long(), :n_genotypes] * (1 - q)) ** power)
    float64_addition = torch.zeros((o.n_variants, n_genotypes), dtype=torch.float64, device=cuda).index_add_(
        0, o.vid.long(), terms)
    del q, terms
    for mask in (None, anchor):
        masked = "mask" if mask is not None else "no mask"
        addition, gprob = mstep_update(probs, o, prior, mask, 0.01, n_genotypes, power)
        require(torch.equal(addition, in_order if mask is None else in_order * mask),
                f"skewed mstep_update ({masked}): addition bit-equal in order")
        require(torch.equal(gprob, L.probs_from_betas(prior + addition, variant2snp, n_snps, 0.01, window)),
                f"skewed mstep_update ({masked}): genotype_prob bit-equal to probs_from_betas")
        plain_addition, plain_gprob = mstep_update_plain(probs, o, prior, mask, 0.01, n_genotypes, power)
        wide = float64_addition if mask is None else float64_addition * mask.double()
        want_gprob = L.probs_from_betas(prior.double() + wide, variant2snp, n_snps, 0.01, window).float()
        errors[masked] = {
            "addition": compare(f"skewed mstep_update addition ({masked})", addition, plain_addition, **ADDITION_TOL),
            "genotype_prob": compare(f"skewed mstep_update genotype_prob ({masked})", gprob, want_gprob, 0.0, 1e-6),
            "genotype_prob_plain": compare(f"skewed mstep_update genotype_prob vs plain ({masked})", gprob,
                                           plain_gprob, 0.0, 1e-6)}

    update_args = (probs, o, prior, None, 0.01, n_genotypes, power)
    ms = {"mstep": [_time_ms(lambda: mstep_addition(*args)) for _ in range(2)],
          "mstep_update": [_time_ms(lambda: mstep_update(*update_args)) for _ in range(2)],
          "em_iteration": [_em_iteration_ms(genotypes, handler, packed) for _ in range(2)]}
    run_lengths = np.diff(reindex.snp_pointers())
    shape = dict(n_calls=int(o.cb.shape[0]), n_donors=n_genotypes, n_barcodes=handler.n_barcodes,
                 n_variants=packed.n_variants)
    bounds = {"mstep": MStepRoofline(**shape),
              "mstep_update": MStepRoofline(**shape, n_runs=len(run_lengths),
                                            neighbour_adds=int((run_lengths * (run_lengths - 1)).sum()))}
    counts = np.diff(o.var_ptr.cpu().numpy())
    result = {name: {"ms": sum(ms[name]) / 2, "bound_ms": bound.speed_of_light_s() * 1e3,
                     "share_of_bound": bound.speed_of_light_s() * 1e3 / (sum(ms[name]) / 2)}
              for name, bound in bounds.items()}
    summary = dict(seed=seed, n_calls=shape["n_calls"], longest_variant=int(counts.max()),
                   split_calls=o.plan.split_calls, split_units=o.plan.n_chunks,
                   em_iteration_ms=sum(ms["em_iteration"]) / 2, max_abs_err=errors, bit_equal_in_order=True)
    say("timing", step="skewed_mstep", card=card, ms=ms, **summary, **result, seconds=time.perf_counter() - t0)
    return {**result, **summary}


# phase 5's 64-donor pool: BENCH's sizes in the bench cells' shape (SKEWED) at bench_h100/configs/pbmc64_65k.json's
# 64 donors, 2,080 columns at DOUBLET_PRIOR
POOL64_DONORS = 64
# barcodes a block of the aggregate kernel's plain comparison there: the plain chain's [groups, 2,080] f32
# temporaries over the whole pool (3.5M groups, 29 GB each) would not fit the card together
POOL64_PLAIN_BARCODES = 8_192


def _aggregate_block(operands, b0: int, b1: int):
    """``operands``' barcodes [b0, b1), with their groups and calls, as operands of their own
    (``aggregate_operands``)."""
    from demuxalot_tpu_torch.ops.aggregate_kernel import aggregate_operands

    o = operands
    g0, g1 = int(o.barcode_ptr[b0]), int(o.barcode_ptr[b1])
    c0, c1 = int(o.group_ptr[g0]), int(o.group_ptr[g1])
    return aggregate_operands(o.pairs.cpu().numpy(), o.n_donors, o.vid[c0:c1], o.q[c0:c1],
                              o.group_ptr[g0:g1 + 1] - c0, o.barcode_ptr[b0:b1 + 1] - g0, o.n_variants,
                              o.compensation, o.p_bad_snp)


def phase_pool64(card: str, seed: int) -> dict:
    """Phase 5 at 64 donors, the paths of ``pbmc64_65k``'s cells at their scale: BENCH's sizes in the bench cells'
    shape (``_skewed_data``) with 64 donors, 2,080 columns at ``DOUBLET_PRIOR``. The fused E-step (its schedule in
    4 passes) and the fused aggregate kernel (the row split over a block's warps) against their plain versions at
    the logits and posterior bars, the aggregate's plain version in blocks of ``POOL64_PLAIN_BARCODES`` barcodes;
    the fused M-step (2 blocks of 32 donors, variants past ``CHUNK_CALLS`` in chunks), with and without a mask, bit
    for bit against the in-order reference and ``probs_from_betas`` on its own addition, and against its plain
    version; then each kernel's launches in this phase, its time (kernel and plain in turns; the aggregate kernel
    alone, its plain version does not fit whole), its bound, and an EM iteration through either likelihood."""
    from demuxalot_tpu_torch import Demultiplexer
    from demuxalot_tpu_torch.models.demux import _Likelihood
    from demuxalot_tpu_torch.ops import aggregate_kernel as AK
    from demuxalot_tpu_torch.ops import likelihood as L
    from demuxalot_tpu_torch.ops.likelihood_kernel import estep_logits, estep_logits_plain
    from demuxalot_tpu_torch.ops.mstep_kernel import mstep_update, mstep_update_plain
    from demuxalot_tpu_torch.utils.profiling import AggregateRoofline, MStepRoofline, Roofline
    from torch_problems import in_order_addition

    t0 = time.perf_counter()
    launches_before = _launches()
    torch.cuda.reset_peak_memory_stats()
    genotypes, handler, packed = _skewed_data(seed, n_donors=POOL64_DONORS)
    cuda = torch.device("cuda")
    n_barcodes, n_genotypes = handler.n_barcodes, POOL64_DONORS
    lik = _Likelihood(packed, n_barcodes, genotypes.genotype_names, DOUBLET_PRIOR, cuda)
    groups = packed.aggregate_operands(n_barcodes, n_genotypes, DOUBLET_PRIOR, cuda)
    o = lik.mstep
    n_pg, passes, plan = lik.n_options, int(lik.estep.schedule.shape[0]), AK.aggregate_plan(lik.n_options)
    require(n_pg == 2080 and passes == 4, f"64 donors: 2,080 columns in 4 E-step passes, got {n_pg} in {passes}")
    require(plan[0] == 0, f"2,080 columns: the aggregate row split over a block's warps, got plan {plan}")
    require(o.snp_ptr is not None and o.plan.n_chunks > 0, "64-donor pool: SNP runs, and chunk units in the plan")
    reindex = packed.reindex
    variant2snp = torch.from_numpy(reindex.variant2snp).to(cuda)
    n_snps, window = int(packed.variant2snp.max()) + 1, reindex.windowed_max_per_snp
    betas = torch.from_numpy(reindex.permute_rows(packed.betas_for(genotypes, False))).to(cuda)
    gprob = L.probs_from_betas(betas, variant2snp, n_snps, 0.01, window)

    # the E-step: its fused call against the plain logits + torch.softmax
    estep = lambda: estep_logits(gprob, lik.estep, softmax=True)  # noqa: E731
    estep_plain = lambda: estep_logits_plain(gprob, lik.estep, softmax=True)  # noqa: E731
    logits, probs = estep()
    want_logits, want_probs = estep_plain()
    errors = {"estep_softmax": {
        "logits": compare("64-donor estep logits", logits, want_logits, **LOGITS_TOL),
        "posteriors": compare("64-donor estep posteriors", probs, want_probs, 0.0, POSTERIOR_ATOL),
        "argmax_agreement": float((probs.argmax(1) == want_probs.argmax(1)).float().mean())}}
    row_err = float((probs.sum(dim=1) - 1).abs().max())
    require(row_err <= 1e-5, f"64-donor estep: rows sum to 1 within {row_err}")
    del logits, want_logits, want_probs

    # the aggregate kernel: two runs bit-equal, then block by block against its plain version
    aggregate = lambda: AK.aggregated_logits(gprob, groups, softmax=True)  # noqa: E731
    a_logits, a_probs = aggregate()
    again = aggregate()
    require(torch.equal(a_logits, again[0]) and torch.equal(a_probs, again[1]),
            "64-donor aggregate: two runs bit-equal")
    del again
    a_errors, agree = {"logits": 0.0, "posteriors": 0.0}, 0
    for b0 in range(0, n_barcodes, POOL64_PLAIN_BARCODES):
        b1 = min(n_barcodes, b0 + POOL64_PLAIN_BARCODES)
        want_logits, want_probs = AK.aggregated_logits_plain(gprob, _aggregate_block(groups, b0, b1), softmax=True)
        a_errors["logits"] = max(a_errors["logits"], compare(f"64-donor aggregate logits, barcodes {b0}-{b1}",
                                                             a_logits[b0:b1], want_logits, **LOGITS_TOL))
        a_errors["posteriors"] = max(a_errors["posteriors"], compare(
            f"64-donor aggregate posteriors, barcodes {b0}-{b1}", a_probs[b0:b1], want_probs, 0.0, POSTERIOR_ATOL))
        agree += int((a_probs[b0:b1].argmax(1) == want_probs.argmax(1)).sum())
        del want_logits, want_probs
    errors["aggregated_logits"] = {**a_errors, "argmax_agreement": agree / n_barcodes}
    del a_logits, a_probs

    # the M-step on the E-step's posteriors, with and without a mask
    power = float(Demultiplexer.contribution_power)
    prior = torch.from_numpy(reindex.permute_rows(packed.betas_for(genotypes, True))).to(cuda)
    anchor = (torch.arange(packed.n_variants, device=cuda) % 3 != 0).to(torch.float32)[:, None]
    in_order = in_order_addition(probs, o, n_genotypes, power)
    errors["mstep_update"] = {}
    for mask in (None, anchor):
        masked = "mask" if mask is not None else "no mask"
        addition, update_gprob = mstep_update(probs, o, prior, mask, 0.01, n_genotypes, power)
        require(torch.equal(addition, in_order if mask is None else in_order * mask),
                f"64-donor mstep_update ({masked}): addition bit-equal in order")
        require(torch.equal(update_gprob, L.probs_from_betas(prior + addition, variant2snp, n_snps, 0.01, window)),
                f"64-donor mstep_update ({masked}): genotype_prob bit-equal to probs_from_betas")
        plain_addition, plain_gprob = mstep_update_plain(probs, o, prior, mask, 0.01, n_genotypes, power)
        errors["mstep_update"][masked] = {
            "addition": compare(f"64-donor mstep_update addition ({masked})", addition, plain_addition,
                                **ADDITION_TOL),
            "genotype_prob": compare(f"64-donor mstep_update genotype_prob ({masked})", update_gprob, plain_gprob,
                                     0.0, 1e-6)}
    del in_order, addition, update_gprob, plain_addition, plain_gprob

    update_args = (probs, o, prior, None, 0.01, n_genotypes, power)
    runs = {"estep_softmax": (estep, estep_plain),
            "mstep_update": (lambda: mstep_update(*update_args), lambda: mstep_update_plain(*update_args))}
    samples = {name: {"plain": [], "kernel": []} for name in runs}
    for name, (kernel, plain) in runs.items():
        for which in ("plain", "kernel", "kernel", "plain"):
            samples[name][which].append(_time_ms(plain if which == "plain" else kernel, repeats=5))
    samples["aggregated_logits"] = {"kernel": [_time_ms(aggregate, repeats=5) for _ in range(2)], "plain": []}
    del probs
    em_ms = {"estep_softmax": [_em_iteration_ms(genotypes, handler, packed) for _ in range(2)]}
    saved = Demultiplexer.aggregate_on_snps
    Demultiplexer.aggregate_on_snps = True
    try:
        em_ms["aggregated_logits"] = [_em_iteration_ms(genotypes, handler, packed) for _ in range(2)]
    finally:
        Demultiplexer.aggregate_on_snps = saved

    n_variants = packed.n_variants
    run_lengths = np.diff(reindex.snp_pointers())
    bounds = {
        "estep_softmax": Roofline(n_calls=int(lik.calls.q_b.shape[0]), n_donors=n_genotypes, n_pseudogenotypes=n_pg,
                                  n_barcodes=n_barcodes, n_variants=n_variants, softmax=True),
        "mstep_update": MStepRoofline(n_calls=int(o.cb.shape[0]), n_donors=n_genotypes, n_barcodes=n_barcodes,
                                      n_variants=n_variants, n_runs=len(run_lengths),
                                      neighbour_adds=int((run_lengths * (run_lengths - 1)).sum())),
        # the longer groups alone: a group of one call takes one log a column (as in _aggregate_case)
        "aggregated_logits": AggregateRoofline(n_calls=int(groups.vid.shape[0]),
                                               n_groups=groups.n_groups - int((groups.group_ptr.diff() == 1).sum()),
                                               n_barcodes=n_barcodes, n_variants=n_variants, n_donors=n_genotypes,
                                               n_pseudogenotypes=n_pg, softmax=True)}
    launches = {name: count - launches_before[name] for name, count in _launches().items()}
    wrappers = {"estep_softmax": "estep_logits", "mstep_update": "mstep_update",
                "aggregated_logits": "aggregated_logits"}
    result = {}
    for name, bound in bounds.items():
        kernel_ms = sum(samples[name]["kernel"]) / 2
        plain = samples[name]["plain"]
        result[name] = {"ms": kernel_ms, "plain_ms": sum(plain) / 2 if plain else None,
                        "bound_ms": bound.speed_of_light_s() * 1e3, "bound_by": bound.bound_by(),
                        "share_of_bound": bound.speed_of_light_s() * 1e3 / kernel_ms,
                        "launches": launches[wrappers[name]], "max_abs_err": errors[name]}
        if name in em_ms:
            result[name]["em_iteration_ms"] = sum(em_ms[name]) / 2
    counts = np.diff(o.var_ptr.cpu().numpy())
    summary = dict(seed=seed, n_donors=n_genotypes, n_columns=n_pg, estep_passes=passes, aggregate_plan=list(plan),
                   n_calls=int(o.cb.shape[0]), n_groups=groups.n_groups, longest_variant=int(counts.max()),
                   split_calls=o.plan.split_calls, split_units=o.plan.n_chunks, mstep_bit_equal_in_order=True,
                   peak_bytes=torch.cuda.max_memory_allocated())
    say("timing", step="pool64", card=card, samples_ms=samples, em_iteration_samples_ms=em_ms, **summary, **result,
        seconds=time.perf_counter() - t0)
    return {**result, **summary}


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

    _zero_launches()
    t0 = time.perf_counter()
    learnt = Demultiplexer.learn_genotypes_core(packed, genotypes, handler, n_iterations=N_ITERATIONS,
                                                doublet_prior=DOUBLET_PRIOR, damping="auto")
    torch.cuda.synchronize()
    stages["learn_auto_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    compact = Demultiplexer.predict_posteriors_compact(packed, learnt.genotypes, handler, k=E2E_TOPK,
                                                       doublet_prior=DOUBLET_PRIOR)
    stages["predict_compact_s"] = time.perf_counter() - t0
    launches = _launches()
    # the fused M-step where every SNP has at most MAX_WINDOWED_RUN variants (a BAM's alleles: at most 4)
    fused = packed.reindex.windowed_max_per_snp > 0
    m_steps = 2 * (N_ITERATIONS - 1)
    expected = {"estep_logits": 2 * N_ITERATIONS + 1, "mstep_addition": 0 if fused else m_steps,
                "mstep_update": m_steps if fused else 0, "aggregated_logits": 0}
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
    from demuxalot_tpu_torch.ops.aggregate_kernel import aggregated_logits
    from demuxalot_tpu_torch.utils import tracing

    Demultiplexer.device = "cuda"
    cuda = demux.resolve_device(Demultiplexer.device)  # the engine's device key, as its layout cache has it
    Demultiplexer.aggregate_on_snps = True
    try:
        torch.cuda.reset_peak_memory_stats()
        _zero_launches()
        tracing.reset()
        demux.STAGE_TIMINGS = {}
        t0 = time.perf_counter()
        learnt = Demultiplexer.learn_genotypes_core(packed, genotypes, handler, n_iterations=N_ITERATIONS,
                                                    doublet_prior=0.0)
        torch.cuda.synchronize()
        learn_s = time.perf_counter() - t0
        learn_launches = _launches()
        stage_timings, demux.STAGE_TIMINGS = demux.STAGE_TIMINGS, None
        snapshot = tracing.snapshot()
        t0 = time.perf_counter()
        compact = Demultiplexer.predict_posteriors_compact(packed, learnt.genotypes, handler,
                                                           doublet_prior=DOUBLET_PRIOR, k=E2E_TOPK)
        compact_s = time.perf_counter() - t0
        launches = _launches()
        # every aggregate E-step is one aggregate kernel launch: the EM's 5 (softmax fused) and the compact
        # predict's forward; the aggregate EM shares the fused M-step (same SNP runs as phase 4)
        expected = {"estep_logits": 0, "mstep_addition": 0, "mstep_update": N_ITERATIONS - 1,
                    "aggregated_logits": N_ITERATIONS}
        require(learn_launches == expected, f"aggregate EM launches {learn_launches}, expected {expected}")
        expected["aggregated_logits"] += 1
        require(launches == expected, f"aggregate path launches {launches}, expected {expected}")
        layout = packed.snp_aggregation_layout(cuda)
        # the learn run's layout_s: this one-off grouping on the host and its upload
        t0 = time.perf_counter()
        demux._SnpAggregationLayout.build(packed.molecule_calls, cuda)
        torch.cuda.synchronize()
        layout_build_s = time.perf_counter() - t0
        say("aggregate", stage="learn + compact", card=card, launches=launches, learn_s=learn_s,
            compact_s=compact_s, layout_build_s=layout_build_s, n_groups=layout.n_groups,
            n_molecule_calls=int(layout.vid.shape[0]), max_molecules_per_group=int(layout.group_ptr.diff().max()),
            max_memory_allocated=torch.cuda.max_memory_allocated())
        say("aggregate", stage="STAGE_TIMINGS of the learn run", card=card, **stage_timings)
        say("aggregate", stage="tracing.snapshot() of the learn run", card=card, **snapshot)

        logits, probs, columns, predict_peak = _predict_peak(packed, learnt.genotypes, handler)
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
        # the predict's device peak at 528 columns: its output (logits and probs) beside the genotype table's
        # normalisation, no [groups, columns] buffer
        out_bytes, table_bytes = logits.nbytes + probs.nbytes, gprob.nbytes
        operands = packed.aggregate_operands(n_barcodes, n_donors, DOUBLET_PRIOR, cuda)
        layout_bytes = sum(t.nbytes for t in operands.tensors())
        require(predict_peak <= out_bytes + 8 * table_bytes + (64 << 20),
                f"aggregate predict peaked {predict_peak} B above what it held before: output {out_bytes} B")

        # a second run through the kernels gives the same bits (every sum of
        # the path runs in a fixed order; with atomic sums in the E-step,
        # five iterations had amplified run-order noise past the posterior bar)
        again = Demultiplexer.learn_genotypes_core(packed, genotypes, handler, n_iterations=N_ITERATIONS,
                                                   doublet_prior=0.0)
        require(torch.equal(again.state.probs, learnt.state.probs) and torch.equal(again.state.logits,
                                                                                   learnt.state.logits),
                "two aggregate EM runs through the kernels are bit-equal")

        # each E-step of the kernels' EM against the plain chain on its own genotype probabilities
        em_steps = _aggregate_em_steps(packed, genotypes, handler)
        # the kernels' EM against the plain M-step on the same E-step kernel (the E-step the same code on both
        # runs, as this comparison ran before the aggregate E-step had a kernel)
        learn = lambda: Demultiplexer.learn_genotypes_core(packed, genotypes, handler,  # noqa: E731
                                                           n_iterations=N_ITERATIONS, doublet_prior=0.0)
        with plain_versions("mstep_addition", "mstep_update"):
            learnt_m = learn()
        # the plain path (the plain aggregate chain and the plain M-step). Five EM iterations amplify any rounding
        # difference of the E-step (atomic sum order alone moved the EM posteriors by 1.09e-3, PR 3), so beside it
        # the plain path with a float64 E-step: how far the float32 rounding of the plain chain itself moves the EM
        with plain_versions():
            learnt_p = learn()
            logits_p, probs_p, _, plain_predict_peak = _predict_peak(packed, learnt_p.genotypes, handler)
            # the plain predict on the kernels' learnt genotypes: the predict's E-step on the same inputs
            logits_s, probs_s, _, _ = _predict_peak(packed, learnt.genotypes, handler)
        with plain_versions(aggregated_logits=_aggregate_float64):
            learnt_d = learn()
        betas = lambda result: torch.from_numpy(np.array(result.genotypes.get_betas()))  # noqa: E731
        errors = {
            "em_estep_posteriors": max(e["posteriors"] for e in em_steps),
            "em_estep_logits": max(e["logits"] for e in em_steps),
            "plain_mstep_em_posteriors": compare("aggregate EM posteriors, plain M-step", learnt.state.probs,
                                                 learnt_m.state.probs, 0.0, POSTERIOR_ATOL),
            "plain_mstep_learnt_betas": compare("aggregate learnt betas, plain M-step", betas(learnt),
                                                betas(learnt_m), **BETAS_TOL),
            "learnt_betas": compare("aggregate learnt betas", betas(learnt), betas(learnt_p), **BETAS_TOL),
            "logits": compare("aggregate predict logits", logits, logits_s, **LOGITS_TOL),
            "posteriors": compare("aggregate predict posteriors", probs, probs_s, 0.0, POSTERIOR_ATOL),
        }
        argmax_same = float((probs.argmax(1) == probs_s.argmax(1)).float().mean())
        require(argmax_same == 1.0, f"aggregate argmax agrees on {argmax_same} of barcodes")
        # the drift of five EM iterations from the plain path: the kernels' path, and the plain path's own with a
        # float64 E-step; the kernels may move the EM no further than the plain chain's float32 rounding does
        drift = {name: {"em_posteriors": float((other.state.probs - learnt_p.state.probs).abs().max()),
                        "em_argmax_agreement": float((other.state.probs.argmax(1) == learnt_p.state.probs.argmax(1))
                                                     .float().mean()),
                        "learnt_betas": float((betas(other) - betas(learnt_p)).abs().max())}
                 for name, other in (("kernels", learnt), ("float64_estep", learnt_d))}
        drift["kernels"].update(predict_logits=float((logits - logits_p).abs().max()),
                                predict_posteriors=float((probs - probs_p).abs().max()),
                                predict_argmax_agreement=float((probs.argmax(1) == probs_p.argmax(1)).float().mean()))
        require(drift["kernels"]["em_posteriors"] <= drift["float64_estep"]["em_posteriors"],
                f"aggregate EM: the kernels drift from the plain path by {drift['kernels']['em_posteriors']}, "
                f"further than its float64 E-step ({drift['float64_estep']['em_posteriors']})")
        # and under a fixed ceiling: H100 readings 5.61e-4 (kernels) and 8.29e-4 (float64 E-step)
        require(drift["kernels"]["em_posteriors"] <= AGGREGATE_EM_DRIFT_CEILING,
                f"aggregate EM: the kernels drift from the plain path by {drift['kernels']['em_posteriors']}, "
                f"over {AGGREGATE_EM_DRIFT_CEILING}")
        require(drift["kernels"]["em_argmax_agreement"] == 1.0, "aggregate EM: the same argmax as the plain path")
        say("aggregate", stage="checks", card=card, accuracy=accuracy, singlet_accuracy=singlet_accuracy,
            max_row_sum_err=row_err, compact_equals_full_frame=True, kernel_runs_bit_equal=True,
            plain_vs_kernels_max_abs_err=errors, argmax_agreement=argmax_same, em_estep_errors=em_steps,
            drift_from_the_plain_path=drift)
        say("aggregate", stage="predict peak", card=card, kernel_peak_bytes=predict_peak,
            plain_peak_bytes=plain_predict_peak, output_bytes=out_bytes, layout_bytes=layout_bytes,
            genotype_table_bytes=table_bytes, groups_x_columns_f32_bytes=4 * layout.n_groups * n_pg)
        del logits_p, probs_p, logits_s, probs_s, learnt_p, learnt_m, learnt_d, again

        # the aggregate EM iteration (the learn run's: 32 columns, the fused M-step) and the predict's wall, each
        # through the kernels and the plain versions, in turns (plain, kernels, kernels, plain)
        def plain_run(fn):
            with plain_versions():
                return fn()

        em = lambda: _em_iteration_ms(genotypes, handler, packed, doublet_prior=0.0)  # noqa: E731
        predict = lambda: _predict_peak(packed, learnt.genotypes, handler)[-1]  # noqa: E731
        em_plain_ms, em_ms = _in_turns(lambda: plain_run(em), em, lambda fn: fn())
        predict_plain_s, predict_s = _in_turns(lambda: plain_run(predict), predict, _host_seconds)
        say("aggregate", stage="EM iteration and predict", card=card, em_iteration_ms=em_ms,
            plain_em_iteration_ms=em_plain_ms, predict_s=predict_s, plain_predict_s=predict_plain_s)

        # the kernel against its plain version at the learn run's and the predict's widths (their cached
        # operands), then at 64 donors; each one call, fused softmax, as the EM loop and predict make it
        widths = {}
        for prior in (0.0, DOUBLET_PRIOR):
            case = _aggregate_case(gprob, packed.aggregate_operands(n_barcodes, n_donors, prior, cuda),
                                   f"bench shape, prior {prior}")
            widths[case["n_pg"]] = case
            say("aggregate", stage="aggregated_logits", card=card, **case)
        d64_inputs = _aggregate_d64_inputs(cuda)
        d64 = _aggregate_case(*d64_inputs, "64 donors")
        say("aggregate", stage="aggregated_logits at 64 donors", card=card, shape=AGGREGATE_D64, **d64)
        # groups of many molecules: the bench calls at 32 columns regrouped 8 calls a group
        em_operands = packed.aggregate_operands(n_barcodes, n_donors, 0.0, cuda)
        many = _aggregate_case(gprob, _regrouped(em_operands, AGGREGATE_GROUP_CALLS),
                               f"groups of {AGGREGATE_GROUP_CALLS} molecules")
        say("aggregate", stage=f"aggregated_logits, groups of {AGGREGATE_GROUP_CALLS} molecules", card=card, **many)
        # every instantiation that holds each width, beside the plan's pick; the wrapper's host path
        sweep = {**_aggregate_sweep(gprob, em_operands, AGGREGATE_SWEEP_WIDTHS),
                 **_aggregate_sweep(*d64_inputs, AGGREGATE_D64_SWEEP_WIDTHS)}
        say("aggregate", stage="instantiations by width", card=card, sweep=sweep)
        host_us = _host_us(lambda: aggregated_logits(gprob, em_operands, softmax=True))
        say("aggregate", stage="wrapper host path", card=card, host_us_per_call=host_us, n_pg=em_operands.n_columns)
        del d64_inputs, em_operands
        trapped = _trapping_children(_AGGREGATE_TRAP, ("groups", "vid"))
        say("aggregate", stage="operands checked once", card=card, trapped=trapped)
    finally:
        Demultiplexer.aggregate_on_snps = False
        demux.STAGE_TIMINGS = None
    return {"launches": launches, "accuracy": accuracy, "errors": errors, "widths": widths, "d64": d64,
            "many": many, "sweep": sweep, "host_us": host_us, "learn_s": learn_s, "compact_s": compact_s, "predict_peak": predict_peak,
            "plain_predict_peak": plain_predict_peak, "em_ms": em_ms, "plain_em_ms": em_plain_ms,
            "predict_s": predict_s, "plain_predict_s": predict_plain_s}


def _host_seconds(fn) -> float:
    """Host seconds of ``fn()`` (which ends in a device synchronise)."""
    t0 = time.perf_counter()
    fn()
    return time.perf_counter() - t0


def _aggregate_em_steps(packed, genotypes, handler) -> list:
    """Each E-step of a 5-iteration aggregate EM through the kernels (prior 0, as phase 7a learns) against the
    plain chain on the same genotype probabilities: {logits, posteriors} max |err| per iteration, at the bars."""
    from demuxalot_tpu_torch.models.demux import _EMRun
    from demuxalot_tpu_torch.ops.aggregate_kernel import aggregated_logits_plain

    run = _EMRun(packed, genotypes, handler, N_ITERATIONS, 0.01, 0.0, None)
    likelihood, errors = run.likelihood, []
    kernel = likelihood.posteriors

    def held(genotype_prob, prior_logits=None):
        logits, probs = kernel(genotype_prob, prior_logits)
        want_logits, want_probs = aggregated_logits_plain(genotype_prob, likelihood.snp_groups,
                                                          prior_logits=prior_logits, softmax=True)
        what = f"aggregate EM E-step {len(errors)}"
        errors.append({"logits": compare(f"{what} logits", logits, want_logits, **LOGITS_TOL),
                       "posteriors": compare(f"{what} posteriors", probs, want_probs, 0.0, POSTERIOR_ATOL)})
        require(torch.equal(probs.argmax(1), want_probs.argmax(1)), f"{what}: the same argmax")
        return logits, probs

    likelihood.posteriors = held
    for _state in run.device_iterations():
        pass
    require(len(errors) == N_ITERATIONS, f"{len(errors)} aggregate E-steps held to the plain chain")
    return errors


def _float64_logits(genotype_prob, operands) -> torch.Tensor:
    """The plain aggregate chain in float64."""
    from demuxalot_tpu_torch.ops import likelihood as L

    o = operands
    pairs = o.pairs.cpu().numpy()
    mixing = torch.from_numpy(L.mixing_from_pairs(pairs[0], pairs[1], o.n_donors)).to(genotype_prob.device)
    return L.snp_aggregated_logits(genotype_prob.double(), mixing.double(), o.vid, o.q.double(),
                                   o.group_ptr.cpu().numpy(), o.group_ptr.diff(), o.barcode_ptr.diff(),
                                   compensation=o.compensation, p_bad_snp=o.p_bad_snp)


def _aggregate_float64(genotype_prob, operands, *, prior_logits=None, softmax=False):
    """The plain aggregate chain in float64, its logits rounded to float32 (phase 7a's reference for rounding)."""
    logits = _float64_logits(genotype_prob, operands).float()
    if prior_logits is not None:
        logits = logits + prior_logits
    return (logits, torch.softmax(logits, dim=-1)) if softmax else logits


def _float64_errors(gprob, operands, n_barcodes: int = 8_192) -> dict:
    """The kernel's and the plain chain's max |err| against float64 over the first ``n_barcodes`` barcodes (their
    groups and calls; float64 [groups, columns] at the whole bench shape would not fit beside the rest)."""
    from demuxalot_tpu_torch.ops.aggregate_kernel import aggregate_operands, aggregated_logits, aggregated_logits_plain

    o = operands
    n_barcodes = min(n_barcodes, o.n_barcodes)
    n_groups = int(o.barcode_ptr[n_barcodes])
    n_calls = int(o.group_ptr[n_groups])
    sub = aggregate_operands(o.pairs.cpu().numpy(), o.n_donors, o.vid[:n_calls], o.q[:n_calls],
                             o.group_ptr[:n_groups + 1], o.barcode_ptr[:n_barcodes + 1], o.n_variants,
                             o.compensation, o.p_bad_snp)
    want = _float64_logits(gprob, sub)
    want_probs = torch.softmax(want, dim=-1)
    errors = {}
    for name, fn in (("kernel", aggregated_logits), ("plain", aggregated_logits_plain)):
        logits, probs = fn(gprob, sub, softmax=True)
        errors[name] = {"logits": float((logits.double() - want).abs().max()),
                        "posteriors": float((probs.double() - want_probs).abs().max()),
                        "argmax_agreement": float((probs.argmax(1) == want_probs.argmax(1)).float().mean())}
    return {"n_barcodes": n_barcodes, **errors}


def _predict_peak(packed, genotypes, handler) -> tuple:
    """(logits, probs, columns, the device bytes ``predict_posteriors_core`` allocated above what was held before)."""
    from demuxalot_tpu_torch import Demultiplexer

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    logits, probs, columns = Demultiplexer.predict_posteriors_core(packed, genotypes, handler,
                                                                   doublet_prior=DOUBLET_PRIOR)
    torch.cuda.synchronize()
    return logits, probs, columns, torch.cuda.max_memory_allocated() - before


def _aggregate_case(gprob, operands, what: str) -> dict:
    """The aggregate kernel against its plain version on one set of operands: logits, posteriors and argmax,
    two runs bit-equal, each one's device peak above what was held before (the kernel's: its output), and
    both times in turns (plain, kernel, kernel, plain), beside ``AggregateRoofline``'s bound."""
    from demuxalot_tpu_torch.ops.aggregate_kernel import aggregated_logits, aggregated_logits_plain
    from demuxalot_tpu_torch.utils.profiling import AggregateRoofline

    kernel = lambda: aggregated_logits(gprob, operands, softmax=True)  # noqa: E731
    plain = lambda: aggregated_logits_plain(gprob, operands, softmax=True)  # noqa: E731
    logits, probs = kernel()
    again = kernel()
    require(torch.equal(logits, again[0]) and torch.equal(probs, again[1]), f"aggregate {what}: two runs bit-equal")
    want_logits, want_probs = plain()
    errors = {"logits": compare(f"aggregate {what} logits", logits, want_logits, **LOGITS_TOL),
              "posteriors": compare(f"aggregate {what} posteriors", probs, want_probs, 0.0, POSTERIOR_ATOL)}
    require(torch.equal(probs.argmax(1), want_probs.argmax(1)), f"aggregate {what}: the same argmax")
    require(torch.equal(aggregated_logits(gprob, operands), logits), f"aggregate {what}: logits-only bits")
    # as close to float64 as the plain chain: its float32 rounding sets the floor
    float64 = _float64_errors(gprob, operands)
    require(float64["kernel"]["posteriors"] <= 1.5 * max(float64["plain"]["posteriors"], 1e-6),
            f"aggregate {what}: posteriors against float64 {float64}")
    out_bytes = logits.nbytes + probs.nbytes
    del again, want_logits, want_probs, logits, probs
    peaks = {}
    for name, fn in (("kernel", kernel), ("plain", plain)):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
        out = fn()
        torch.cuda.synchronize()
        peaks[name] = torch.cuda.max_memory_allocated() - before
        del out
    require(peaks["kernel"] <= out_bytes + (4 << 20),
            f"aggregate {what}: the kernel's call peaked {peaks['kernel']} B, its output is {out_bytes} B")
    samples = {"plain": [], "kernel": []}
    for which in ("plain", "kernel", "kernel", "plain"):
        samples[which].append(_time_ms(plain if which == "plain" else kernel, repeats=5))
    kernel_ms, plain_ms = sum(samples["kernel"]) / 2, sum(samples["plain"]) / 2
    n_variants, n_donors = gprob.shape
    n_pg = int(operands.pairs.shape[1])
    # the kernel closes a group of one call with one log a column, a longer group with an exp and a log: counted
    # as the longer groups alone, AggregateRoofline's (calls + 2 x groups) x columns is exactly that work
    n_groups_of_one = int((operands.group_ptr.diff() == 1).sum())
    bound = AggregateRoofline(n_calls=int(operands.vid.shape[0]), n_groups=operands.n_groups - n_groups_of_one,
                              n_barcodes=operands.n_barcodes, n_variants=n_variants, n_donors=n_donors,
                              n_pseudogenotypes=n_pg, softmax=True)
    bound_ms = bound.speed_of_light_s() * 1e3
    return {"n_pg": n_pg, "n_groups": operands.n_groups, "n_calls": int(operands.vid.shape[0]),
            "n_groups_of_one": n_groups_of_one,
            "n_barcodes": operands.n_barcodes, "errors": errors, "float64_errors": float64, "bit_equal_runs": True,
            "ms": kernel_ms, "plain_ms": plain_ms, "samples_ms": samples,
            "logits_only_ms": _time_ms(lambda: aggregated_logits(gprob, operands), repeats=5),
            "bound_ms": bound_ms, "bound_by": bound.bound_by(), "share_of_bound": bound_ms / kernel_ms,
            "bound_bytes": bound.bytes_moved(), "bound_mufu_operations": bound.operations(),
            "kernel_peak_bytes": peaks["kernel"], "plain_peak_bytes": peaks["plain"], "output_bytes": out_bytes}


# phase 7a's 64-donor case (2,080 columns: the row split over a block's warps): the bench shape's SNPs and calls per
# barcode, fewer barcodes, seed 0
AGGREGATE_D64 = dict(n_barcodes=8_192, n_donors=64, n_snps=65_536, calls_per_barcode=64)
# phase 7a's case of groups of many molecules: the bench calls at 32 columns, this many calls a group
AGGREGATE_GROUP_CALLS = 8
# phase 7a's sweep of the instantiations: the first n columns of the donors' singlets and doublets, on the bench
# calls (32 donors) and on the 64-donor case's
AGGREGATE_SWEEP_WIDTHS = (4, 8, 10, 16, 32, 64, 128, 256, 528)
AGGREGATE_D64_SWEEP_WIDTHS = (561, 1088, 1089, 2080)


def _regrouped(operands, calls: int):
    """``operands``' calls in groups of ``calls`` consecutive calls of each barcode (its last group shorter), through
    ``aggregate_operands``."""
    from demuxalot_tpu_torch.ops.aggregate_kernel import aggregate_operands

    o = operands
    group_ptr, barcode_ptr = o.group_ptr.cpu().numpy(), o.barcode_ptr.cpu().numpy()
    starts, ends = group_ptr[barcode_ptr[:-1]], group_ptr[barcode_ptr[1:]]
    n_groups = -(-(ends - starts) // calls)
    new_barcode_ptr = np.concatenate([[0], np.cumsum(n_groups)])
    rank = np.arange(new_barcode_ptr[-1]) - np.repeat(new_barcode_ptr[:-1], n_groups)
    new_group_ptr = np.concatenate([np.repeat(starts, n_groups) + calls * rank, [group_ptr[-1]]])
    device = o.vid.device
    return aggregate_operands(o.pairs.cpu().numpy(), o.n_donors, o.vid, o.q,
                              torch.from_numpy(new_group_ptr.astype(np.int64)).to(device),
                              torch.from_numpy(new_barcode_ptr.astype(np.int64)).to(device), o.n_variants,
                              o.compensation, o.p_bad_snp)


def _aggregate_sweep(gprob, operands, widths) -> dict:
    """The kernel's fused call at every instantiation that holds each width (``aggregate_kernel.instantiations``),
    on ``operands``' calls with the first n columns of their donors' singlets and doublets: each instantiation's ms
    (one sample) and its logits against the plan's own pick's at the logits bar."""
    from demuxalot_tpu_torch.ops import aggregate_kernel as AK
    from demuxalot_tpu_torch.ops import likelihood as L

    o = operands
    pairs = np.stack(L.pseudogenotype_pairs(o.n_donors, 1.0))
    result = {}
    for n_pg in widths:
        sub = AK.aggregate_operands(pairs[:, :n_pg], o.n_donors, o.vid, o.q, o.group_ptr, o.barcode_ptr, o.n_variants,
                                    o.compensation, o.p_bad_snp)
        run = lambda: AK.aggregated_logits(gprob, sub, softmax=True)  # noqa: E731
        own = run()[0]
        times, errors = {}, {}
        for plan in AK.instantiations(n_pg):
            AK.PLAN = plan
            try:
                name = f"{plan[0]},{plan[1]}"
                errors[name] = compare(f"aggregate at {n_pg} columns, instantiation {name}", run()[0], own,
                                       **LOGITS_TOL)
                times[name] = _time_ms(run, repeats=5)
            finally:
                AK.PLAN = None
        result[str(n_pg)] = {"plan": "%d,%d" % AK.aggregate_plan(n_pg), "fastest": min(times, key=times.get),
                             "ms": times, "logits_err_vs_plan": errors}
        del own, sub
    return result


def _aggregate_d64_inputs(cuda) -> tuple:
    """(genotype_prob, the aggregate operands at prior 0.35) of a synthetic 64-donor dataset, as predict makes them."""
    from demuxalot_tpu_torch import Demultiplexer
    from demuxalot_tpu_torch.ops import likelihood as L
    from demuxalot_tpu_torch.sim import synthesize_compressed_calls

    genotypes, calls, _truth, _names = synthesize_compressed_calls(doublets_fraction=0.2, seed=0, **AGGREGATE_D64)
    packed = Demultiplexer.pack_dataset(calls, genotypes)
    reindex = packed.reindex
    betas = torch.from_numpy(reindex.permute_rows(packed.betas_for(genotypes, False))).to(cuda)
    gprob = L.probs_from_betas(betas, torch.from_numpy(reindex.variant2snp).to(cuda), int(packed.variant2snp.max()) + 1,
                               0.01, reindex.windowed_max_per_snp)
    return gprob, packed.aggregate_operands(AGGREGATE_D64["n_barcodes"], AGGREGATE_D64["n_donors"], DOUBLET_PRIOR,
                                            cuda)


# a child process: the aggregate operands with a group's calls past the last call, or a variant id past the table,
# must trap when they are built (their one check), before any launch
_AGGREGATE_TRAP = """
import sys
import numpy as np
import torch
sys.path[:0] = [{repo!r}, {repo!r} + "/tests"]
from demuxalot_tpu_torch.models.demux import _SnpAggregationLayout
from demuxalot_tpu_torch.ops.likelihood import pseudogenotype_pairs
from torch_problems import aggregate_problem
p = aggregate_problem(n_donors=4)
layout = _SnpAggregationLayout.build(p["calls"], torch.device("cuda"))
n_variants = p["gprob"].shape[0]
if {case!r} == "groups":
    group_ptr = layout.group_ptr.clone()
    group_ptr[-1] = len(p["calls"]) + 1
    layout = layout._replace(group_ptr=group_ptr)
else:
    n_variants = int(p["calls"].variant_id.max())
try:
    layout.operands(p["n_barcodes"], np.stack(pseudogenotype_pairs(4, 0.35)), 4, n_variants)
    torch.cuda.synchronize()
except Exception as error:
    print(type(error).__name__, error)
    sys.exit(3)
"""


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
    _zero_launches()
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
    launches = _launches()
    expected = {"estep_logits": 1, "mstep_addition": 0, "mstep_update": 0, "aggregated_logits": 0}
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
    _zero_launches()
    t0 = time.perf_counter()
    learnt, em_probs = sharded.learn_genotypes(packed, genotypes, handler, n_iterations=N_ITERATIONS,
                                               doublet_prior=DOUBLET_PRIOR)
    logits, probs = sharded.predict_posteriors(packed, learnt, handler, doublet_prior=DOUBLET_PRIOR)
    compact = sharded.predict_posteriors_compact(packed, learnt, handler, doublet_prior=DOUBLET_PRIOR, k=E2E_TOPK)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _launches()
    # the shards' partials are reduced before the normalisation: addition-only launches
    expected = {"estep_logits": SHARDS * (N_ITERATIONS + 2), "mstep_addition": SHARDS * (N_ITERATIONS - 1),
                "mstep_update": 0, "aggregated_logits": 0}
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
# phase 9: the in-kernel-gather experiments
# ---------------------------------------------------------------------------

def _experiment_kernels() -> dict:
    """{name: wrapper} of the experiments' four kernels (each wrapper carries ``.launches``)."""
    from demuxalot_tpu_torch.experiments import inkernel_gather as IG
    from demuxalot_tpu_torch.experiments import kernel_gather as KG

    return {"estep_logits_banded": IG.estep_logits_banded, "mstep_addition_banded": IG.mstep_addition_banded,
            "gather_rows": KG.gather_rows, "gather_sum": KG.gather_sum}


def phase_gather_kernels() -> None:
    """Phase 9a: the experiments' kernels against their plain versions at edge shapes."""
    from demuxalot_tpu_torch.experiments import inkernel_gather as IG
    from demuxalot_tpu_torch.experiments import kernel_gather as KG

    cuda = torch.device("cuda")
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(cuda)  # noqa: E731

    def banded_estep(p: dict, n_bands: int):
        gprob, _ = _estep_tensors(p, cuda)
        return gprob, IG.banded_estep_operands(p["n_donors"], p["doublet_prior"], t(p["cb"]), t(p["vid"]), t(p["q"]),
                                               p["n_barcodes"], len(p["variant2snp"]), n_bands)

    # every third barcode has no calls, and with 12 bands over 400 variants most
    # barcodes have none in most bands; 60 bands over 40 variants leave some empty
    for n_donors in (2, 7, 32, 64):
        for n_snps, n_bands in ((200, 1), (200, 12), (20, 60)):
            args = banded_estep(_estep_inputs(n_donors, DOUBLET_PRIOR, seed=n_donors, n_snps=n_snps), n_bands)
            got = IG.estep_logits_banded(*args)
            want = IG.estep_logits_banded_plain(*args)
            what = f"banded estep D={n_donors} K={n_bands}"
            err = compare(what, got, want, **LOGITS_TOL)
            require(torch.equal(got.argmax(1), want.argmax(1)), f"{what}: same argmax")
            require(torch.equal(got, IG.estep_logits_banded(*args)), f"{what}: two runs bit-equal")
            ptr = args[1].band_ptr
            empty = float((ptr[:, 1:] == ptr[:, :-1]).float().mean())
            say("experiments", kernel="estep_logits_banded", n_donors=n_donors, n_bands=n_bands, max_abs_err=err,
                empty_band_barcode_share=empty, runs="bit-equal")
    # padding calls after each barcode's real calls: once banded they end their band segments, inside the
    # barcode's stream of bands
    p = _estep_inputs(32, DOUBLET_PRIOR, seed=7)
    pad = 1234
    rng = np.random.RandomState(8)
    cb = np.concatenate([p["cb"], rng.randint(0, p["n_barcodes"], pad).astype(np.int32)])
    vid = np.concatenate([p["vid"], rng.randint(0, len(p["variant2snp"]), pad).astype(np.int32)])
    q = np.concatenate([p["q"], np.ones(pad, np.float32)])
    order = np.argsort(cb, kind="stable")  # padding after each barcode's real calls
    padded = dict(p, cb=cb[order], vid=vid[order], q=q[order])
    for n_bands in (1, 12, 60):
        base, with_pad = (IG.estep_logits_banded(*banded_estep(x, n_bands)) for x in (p, padded))
        require(torch.equal(base, with_pad), f"padding calls must leave the banded E-step logits bit-equal "
                                             f"(K={n_bands})")
    say("experiments", kernel="estep_logits_banded", padding_noop="bit-equal", pad_calls=pad, n_bands=[1, 12, 60])

    for n_donors in (7, 32):
        for n_bands in (2, 40):
            for power in (1.0, 2.0):
                rng = np.random.RandomState(200 + n_donors)
                n_variants, n_barcodes, n_calls = 300, 150, 20_000
                n_pg = n_donors + n_donors * (n_donors - 1) // 2
                vid = np.sort(rng.randint(0, n_variants // 2, n_calls) * 2).astype(np.int32)  # odd rows empty
                cb = rng.randint(0, n_barcodes, n_calls).astype(np.int32)
                q = (rng.rand(n_calls) * 0.7).astype(np.float32)
                q[::97] = 1.0
                post = rng.rand(n_barcodes, n_pg).astype(np.float32)
                post /= post.sum(axis=1, keepdims=True)
                operands = IG.banded_mstep_operands(t(vid), t(cb), t(q), n_variants, n_barcodes, n_bands)
                args = (t(post), operands, n_donors, power)
                got = IG.mstep_addition_banded(*args)
                what = f"banded mstep D={n_donors} K={n_bands} p={power}"
                err = compare(what, got, IG.mstep_addition_banded_plain(*args), **ADDITION_TOL)
                require(not bool(got[1::2].any()), f"{what}: variants with no calls add 0")
                require(torch.equal(got, IG.mstep_addition_banded(*args)), f"{what}: two runs bit-equal")
                # q = 1 calls inserted at random places of the calls, so mid-band once banded: exactly 0
                at = np.sort(rng.randint(0, n_calls + 1, 1500))
                mid = IG.banded_mstep_operands(
                    t(np.insert(vid, at, rng.randint(0, n_variants, len(at)).astype(np.int32))),
                    t(np.insert(cb, at, rng.randint(0, n_barcodes, len(at)).astype(np.int32))),
                    t(np.insert(q, at, np.ones(len(at), np.float32))), n_variants, n_barcodes, n_bands)
                require(torch.equal(got, IG.mstep_addition_banded(t(post), mid, n_donors, power)),
                        f"{what}: q = 1 calls mid-band leave the additions bit-equal")
                say("experiments", kernel="mstep_addition_banded", n_donors=n_donors, n_bands=n_bands, power=power,
                    max_abs_err=err, runs="bit-equal", padding_mid_band="bit-equal")
    # two bands of 35,000 barcodes x 32 donors (4.5 MB each, past a block's shared memory): nothing is staged
    rng = np.random.RandomState(3)
    vid = np.sort(rng.randint(0, 100, 5000)).astype(np.int32)
    cb = rng.randint(0, 70_000, 5000).astype(np.int32)
    q = (rng.rand(5000) * 0.7).astype(np.float32)
    post = torch.rand(70_000, 32, device=cuda)
    tall = IG.banded_mstep_operands(t(vid), t(cb), t(q), 100, 70_000, 2)
    err = compare("banded mstep, two 35,000-row bands", IG.mstep_addition_banded(post, tall, 32, 2.0),
                  IG.mstep_addition_banded_plain(post, tall, 32, 2.0), **ADDITION_TOL)
    say("experiments", kernel="mstep_addition_banded", bands_of_35000_rows_max_abs_err=err)

    # the gather-sum on both paths of its plan: on chip ([8192, 64]; W = 7 with 4-byte row reads; steps of 1 and
    # 1001, 4-byte index loads; 3 slices of the most rows a slice holds at W = 64 on an H100, and 5 rows fewer,
    # the last slice short) and through L2 ([131,072, 32])
    full = KG.slice_rows(64, KG.H100_SHARED_OPTIN)
    for shape, n_idx, step in (((8192, 64), 1 << 20, KG.STEP), ((1000, 7), 100_003, KG.STEP), ((1000, 7), 5000, 1),
                               ((8192, 64), 50_001, 1001), ((3 * full, 64), 200_000, KG.STEP),
                               ((3 * full - 5, 64), 200_000, KG.STEP), ((131_072, 32), 100_003, KG.STEP)):
        table, idx = KG.rate_inputs(*shape, n_idx=n_idx, seed=1, device=cuda)
        require(torch.equal(KG.gather_rows(table, idx), KG.gather_rows_plain(table, idx)),
                f"gather_rows {shape}: bit-equal to table[idx]")
        got, plain = float(KG.gather_sum(table, idx, step)), float(KG.gather_sum_plain(table, idx, step))
        path = KG.gather_sum.last_path
        exact = float(table.double()[idx.long()].sum())
        for name, value in (("kernel", got), ("plain", plain)):
            require(abs(value - exact) <= GATHER_SUM_RTOL * abs(exact),
                    f"gather_sum {shape} step {step} {name}: {value} vs {exact}")
        require(float(KG.gather_sum(table, idx, step)) == got, f"gather_sum {shape} step {step}: two runs bit-equal")
        say("experiments", kernel="gather_rows, gather_sum", table=list(shape), n_idx=n_idx, step=step, path=path,
            plan=KG.plan_for(table, idx, step)._asdict(), rows="bit-equal",
            sum_rel_err=abs(got - exact) / abs(exact), plain_sum_rel_err=abs(plain - exact) / abs(exact))
    # an index past the table (on chip) or negative (through L2) traps inside the gather-sum: a trap ends the
    # process's CUDA context, so each runs in a child process, both at once
    trapped = _trapping_children(_GATHER_TRAP, ("chip", "l2"))
    say("experiments", kernel="gather_sum", index_out_of_range=trapped)


# a child process: gather_sum with one index past the table (on chip) or negative (through L2) must trap
_GATHER_TRAP = """
import sys
import torch
sys.path.insert(0, {repo!r})
from demuxalot_tpu_torch.experiments import kernel_gather as KG
shape, bad = ((100, 8), 100) if {case!r} == "chip" else ((131_072, 32), -1)
table, idx = KG.rate_inputs(*shape, n_idx=10_000, device="cuda")
idx[5000] = bad
try:
    KG.gather_sum(table, idx)
    torch.cuda.synchronize()
except Exception as error:
    print(type(error).__name__, error)
    sys.exit(3)
print("no trap", KG.gather_sum.last_path)
"""


def _trapping_children(script: str, cases) -> dict:
    """Runs ``script`` formatted with each case in a child process, all at once; each must exit 3 (its launch
    trapped). {case: the child's last line}."""
    children = {case: subprocess.Popen([sys.executable, "-c", script.format(repo=str(REPO), case=case)],
                                       stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True) for case in cases}
    trapped = {}
    for case, child in children.items():
        try:
            out, _ = child.communicate(timeout=300)
        except subprocess.TimeoutExpired:
            child.kill()
            out, _ = child.communicate()
        require(child.returncode == 3, f"{case}: an index out of range did not trap (exit {child.returncode}): "
                                       f"{out[-2000:]}")
        trapped[str(case)] = out.strip().splitlines()[-1][:160]
    return trapped


def phase_experiments(card: str) -> dict:
    """Phase 9b-d: the experiments' path (counted), then the plain versions' and library calls' times."""
    from demuxalot_tpu_torch.experiments import inkernel_gather as IG
    from demuxalot_tpu_torch.experiments import kernel_gather as KG
    from demuxalot_tpu_torch.ops.likelihood_kernel import estep_logits
    from demuxalot_tpu_torch.ops.mstep_kernel import mstep_addition
    from demuxalot_tpu_torch.utils.profiling import GatherRoofline, MStepRoofline, Roofline

    cuda = torch.device("cuda")
    counted = {"estep_logits": estep_logits, "mstep_addition": mstep_addition, **_experiment_kernels()}
    for wrapper in counted.values():
        wrapper.launches = 0
    t0 = time.perf_counter()
    bench = IG.bench_workload(device=cuda)
    ab = IG.run_ab(bench)
    past = IG.bench_workload(n_snps=PAST_L2_SNPS, device=cuda)
    ab_past = IG.run_ab(past)
    rate = KG.run_rate(cuda)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: wrapper.launches for name, wrapper in counted.items()}
    for name in _experiment_kernels():
        require(launches[name] > 0, f"the experiments' path launched {name} {launches[name]} times")
    del past
    for name, result in (("bench shape", ab), ("G past L2", ab_past)):
        say("experiments", stage=f"A/B, {name}", card=card,
            **{key: value for key, value in result.items() if key != "ms"},
            ms={key: value["mean"] for key, value in result["ms"].items()},
            samples={key: value["samples"] for key, value in result["ms"].items()})
    say("experiments", stage="path", card=card, launches=launches, wall_s=wall)

    # the banded kernels against their plain versions at the bench shape, and the plain versions' times
    w = bench
    estep_args = (w.genotype_prob, w.estep_banded)
    mstep_args = (w.posterior, w.mstep_banded, w.n_genotypes, w.power)
    got, want = IG.estep_logits_banded(*estep_args), IG.estep_logits_banded_plain(*estep_args)
    estep_err = compare("bench-shape banded estep vs plain", got, want, **LOGITS_TOL)
    require(torch.equal(got.argmax(1), want.argmax(1)), "bench-shape banded estep: same argmax as plain")
    mstep_err = compare("bench-shape banded mstep vs plain", IG.mstep_addition_banded(*mstep_args),
                        IG.mstep_addition_banded_plain(*mstep_args), **ADDITION_TOL)
    plain_ms = {"estep_logits_banded": _time_ms(lambda: IG.estep_logits_banded_plain(*estep_args), repeats=2),
                "mstep_addition_banded": _time_ms(lambda: IG.mstep_addition_banded_plain(*mstep_args), repeats=2)}
    shape = dict(n_calls=ab["n_calls"], n_donors=ab["n_donors"], n_pseudogenotypes=ab["n_pg"],
                 n_barcodes=ab["n_barcodes"], n_variants=ab["n_variants"])
    # the bounds are the function's own work, the unbanded one; the band CSRs
    # are the layout's cost, reported beside them (layout_bytes)
    bounds = {"estep_logits_banded": Roofline(**shape),
              "mstep_addition_banded": MStepRoofline(n_calls=ab["n_calls"], n_donors=ab["n_donors"],
                                                     n_barcodes=ab["n_barcodes"], n_variants=ab["n_variants"])}
    layout_bytes = {name: 8 * (o.band_ptr.numel() + o.band_edges.numel())
                    for name, o in (("estep_logits_banded", w.estep_banded), ("mstep_addition_banded", w.mstep_banded))}
    say("experiments", stage="banded vs plain, bench shape", card=card, estep_max_abs_err=estep_err,
        mstep_max_abs_err=mstep_err, plain_ms=plain_ms, layout_bytes=layout_bytes,
        bound_ms={name: bound.speed_of_light_s() * 1e3 for name, bound in bounds.items()})

    # the gathers: plain versions and the library calls on the rate runner's inputs, and the bounds
    gathers = []
    for result in rate:
        table, idx = KG.rate_inputs(*result["table"], n_idx=result["n_idx"], seed=0, device=cuda)
        touched = int(torch.unique(idx).numel())
        entry = {"table": result["table"], "table_bytes": result["table_bytes"], "rows_touched": touched}
        for name, rows_out, plain, library in (
            ("gather_rows", True, lambda: KG.gather_rows_plain(table, idx), lambda: torch.index_select(table, 0, idx)),
            ("gather_sum", False, lambda: KG.gather_sum_plain(table, idx),
             lambda: torch.index_select(table, 0, idx).sum()),
        ):
            bound = GatherRoofline(n_idx=result["n_idx"], n_rows_touched=touched, width=result["table"][1],
                                   rows_out=rows_out)
            entry[name] = {**result[name], "plain_ms": _time_ms(plain), "library_ms": _time_ms(library),
                           "bound_ms": bound.speed_of_light_s() * 1e3, "bound_by": bound.bound_by()}
            entry[name]["share_of_bound"] = entry[name]["bound_ms"] / entry[name]["ms_mean"]
        # the gather-sum's device time without the host's: 100 calls in a CUDA graph's replay, each on its own
        # copy of the inputs (copies filling twice the L2), beside index_select(...).sum()'s, in turns; its
        # plan's path, index passes and shared memory, the layout's cost beside the bound
        g = entry["gather_sum"]
        graphed = ((lambda t, i: KG.gather_sum(t, i)), (table, idx))
        g["graph_ms"], g["library_graph_ms"] = _in_turns(
            graphed, ((lambda t, i: torch.index_select(t, 0, i).sum()), (table, idx)), lambda c: _graph_ms(*c))
        plan, (copies, nbytes) = KG.plan_for(table, idx), _rotation(*graphed)
        g.update(path=result["gather_sum_path"], graph_ns_per_row=g["graph_ms"] * 1e6 / result["n_idx"],
                 graph_share_of_bound=g["bound_ms"] / g["graph_ms"], graph_input_mb=copies * nbytes / 1e6,
                 index_passes=plan.index_passes, index_pass_bytes=4 * result["n_idx"] * plan.index_passes,
                 slices=plan.n_slices if plan.path == "chip" else 0, blocks_per_slice=plan.replicas,
                 shared_bytes_per_block=plan.shared_bytes)
        # the kernels against their plain versions on the same inputs: the rows bit for bit, the sums
        # (f32, in other orders) within GATHER_SUM_RTOL of the float64 sum, as each is of it
        require(bool(torch.equal(KG.gather_rows(table, idx), KG.gather_rows_plain(table, idx))),
                f"gather_rows {result['table']}: bit-equal to table[idx]")
        exact, plain_sum = result["float64_sum"], float(KG.gather_sum_plain(table, idx))
        entry["sum_abs_err"] = abs(result["sum"] - plain_sum)
        entry["sum_rel_err_vs_float64"] = {"kernel": abs(result["sum"] - exact) / abs(exact),
                                           "plain": abs(plain_sum - exact) / abs(exact)}
        require(entry["sum_abs_err"] <= GATHER_SUM_RTOL * abs(exact),
                f"gather_sum {result['table']}: {result['sum']} vs plain {plain_sum}")
        gathers.append(entry)
        say("experiments", stage="gather rate", card=card, **entry)
    return {"launches": launches, "ab": ab, "ab_past": ab_past, "gathers": gathers, "plain_ms": plain_ms,
            "bounds": bounds, "layout_bytes": layout_bytes, "estep_err": estep_err, "mstep_err": mstep_err}


# ---------------------------------------------------------------------------
# phase 10: the E-step variants
# ---------------------------------------------------------------------------

def _variant_kernels() -> dict:
    """{name: wrapper} of the E-step variants' three kernels (each wrapper carries ``.launches``)."""
    from demuxalot_tpu_torch.experiments.folded_estep import folded_logits
    from demuxalot_tpu_torch.experiments.group_estep import group_logits
    from demuxalot_tpu_torch.experiments.split_estep import split_logits

    return {"folded_logits": folded_logits, "split_logits": split_logits, "group_logits": group_logits}


# barcode: calls of phase 10a's tile edges (split's 64-call and the register tiles' 32-call tiles, folded's
# products of 8), on barcodes the base inputs leave empty
VARIANT_EDGE_CALLS = {2: 1, 4: 31, 5: 33, 7: 63, 8: 64, 10: 65, 11: 129, 13: 7, 14: 9}


def _variant_inputs(n_donors: int, pad: int = 0) -> dict:
    """:func:`_estep_inputs` at the variants' prior (calls on every third barcode) plus 1,200 calls of barcode 1
    and the tile edges of ``VARIANT_EDGE_CALLS``; ``pad`` q = 1 calls after each barcode's real calls."""
    from demuxalot_tpu_torch.experiments.estep_variants import DOUBLET_PRIOR as VARIANT_PRIOR

    p = _estep_inputs(n_donors, VARIANT_PRIOR, seed=n_donors)
    rng = np.random.RandomState(n_donors + 100)
    n_variants = len(p["variant2snp"])
    extra = np.concatenate([np.ones(1200, np.int32)] + [np.full(n, b, np.int32) for b, n in VARIANT_EDGE_CALLS.items()])
    vid = np.concatenate([p["vid"], rng.randint(0, n_variants, len(extra)).astype(np.int32)])
    q = np.concatenate([p["q"], (rng.rand(len(extra)) * 0.5).astype(np.float32), np.ones(pad, np.float32)])
    cb = np.concatenate([p["cb"], extra, rng.randint(0, p["n_barcodes"], pad).astype(np.int32)])
    vid = np.concatenate([vid, rng.randint(0, n_variants, pad).astype(np.int32)])
    order = np.argsort(cb, kind="stable")
    return dict(p, cb=cb[order], vid=vid[order], q=q[order])


def _variant_cases(gprob, estep, pairs) -> list:
    """(name, kernel, plain, args, kwargs) of every variant kernel on one input: folded with and without the
    log, split at ``pairs``, group at G 4 and 8 with 0-2 words."""
    from demuxalot_tpu_torch.experiments import folded_estep as FE
    from demuxalot_tpu_torch.experiments import group_estep as GE
    from demuxalot_tpu_torch.experiments import split_estep as SE

    u, ops = FE.fold_calls(gprob, estep), FE.variant_operands(estep)
    cases = [(f"folded use_log={use_log}", FE.folded_logits, FE.folded_logits_plain, (u, ops), {"use_log": use_log})
             for use_log in (True, False)]
    cases += [(f"split ({e},{s})", SE.split_logits, SE.split_logits_plain, (u, ops, e, s), {}) for e, s in pairs]
    for group in GE.HARNESS_GROUPS:
        calls = GE.group_layout(estep, group)
        ug = FE.fold_calls(gprob, calls)
        cases += [(f"group G={group} words={w}", GE.group_logits, GE.group_logits_plain, (ug, calls, w), {})
                  for w in (0, 1, 2)]
    return cases


def phase_variant_kernels() -> None:
    """Phase 10a: the variants' kernels against their plain versions at edge shapes, padding, repeat runs."""
    from demuxalot_tpu_torch.experiments.split_estep import HARNESS_PAIRS, MAX_EXP_WORDS, MAX_SC_WORDS

    cuda = torch.device("cuda")
    every_pair = [(e, s) for e in range(MAX_EXP_WORDS + 1) for s in range(MAX_SC_WORDS + 1)]
    # 64 donors: 2,080 columns, 33 column tiles of 64 in three ranges; 7: the MMA's K padded
    for n_donors in (2, 7, 32, 64):
        p = _variant_inputs(n_donors)
        gprob, estep = _estep_tensors(p, cuda)
        errors = {}
        for name, kernel, plain, args, kwargs in _variant_cases(gprob, estep,
                                                                every_pair if n_donors in (7, 64) else HARNESS_PAIRS):
            got, want = kernel(*args, **kwargs), plain(*args, **kwargs)
            what = f"{name} D={n_donors}"
            errors[name] = compare(what, got, want, **LOGITS_TOL)
            if kwargs.get("use_log", True):
                require(torch.equal(got.argmax(1), want.argmax(1)), f"{what}: same argmax")
            require(torch.equal(got, kernel(*args, **kwargs)), f"{what}: two runs bit-equal")
        counts = np.bincount(p["cb"], minlength=p["n_barcodes"])
        say("variants", n_donors=n_donors, max_abs_err=errors, runs="bit-equal",
            empty_barcodes=int((counts == 0).sum()), largest_barcode_calls=int(counts.max()))
    pad = 999
    cases = [_variant_cases(*_estep_tensors(_variant_inputs(32, p), cuda), HARNESS_PAIRS) for p in (0, pad)]
    for (name, kernel, _, args, kwargs), (_, _, _, padded_args, _) in zip(*cases):
        if not kwargs.get("use_log", True):
            continue  # the nolog ablation sums arguments, and a padding call's is 1
        require(torch.equal(kernel(*args, **kwargs), kernel(*padded_args, **kwargs)),
                f"{name}: padding calls must leave the logits bit-equal")
    say("variants", padding_noop="bit-equal", pad_calls=pad,
        kernels=[name for name, *_, kwargs in cases[0] if kwargs.get("use_log", True)])


def phase_variants(card: str) -> dict:
    """Phase 10b-c: the A/B at the JAX harnesses' shape (counted), then each kernel against its plain version
    there and the plain versions' times."""
    from demuxalot_tpu_torch.experiments import estep_variants as EV
    from demuxalot_tpu_torch.experiments import folded_estep as FE
    from demuxalot_tpu_torch.experiments import group_estep as GE
    from demuxalot_tpu_torch.experiments import split_estep as SE
    from demuxalot_tpu_torch.ops.likelihood_kernel import estep_logits

    cuda = torch.device("cuda")
    counted = {"estep_logits": estep_logits, **_variant_kernels()}
    for wrapper in counted.values():
        wrapper.launches = 0
    t0 = time.perf_counter()
    w = EV.variants_workload(cuda)
    ab = EV.run_ab(w)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: wrapper.launches for name, wrapper in counted.items()}
    for name in _variant_kernels():
        require(launches[name] > 0, f"the experiments' path launched {name} {launches[name]} times")
    say("variants", stage="A/B, harness shape", card=card, **{key: value for key, value in ab.items() if key != "ms"},
        ms={key: value["mean"] for key, value in ab["ms"].items()},
        samples={key: value["samples"] for key, value in ab["ms"].items()})
    say("variants", stage="path", card=card, launches=launches, wall_s=wall)

    # each kernel against its plain version at the harness shape (split at (2,2), group at G 4, 2 words),
    # then the plain versions' times
    u = FE.fold_calls(w.genotype_prob, w.estep)
    calls = w.groups[4]
    ug = FE.fold_calls(w.genotype_prob, calls)
    runs = {
        "folded_logits": (lambda: FE.folded_logits(u, w.operands), lambda: FE.folded_logits_plain(u, w.operands)),
        "split_logits": (lambda: SE.split_logits(u, w.operands, 2, 2),
                         lambda: SE.split_logits_plain(u, w.operands, 2, 2)),
        "group_logits": (lambda: GE.group_logits(ug, calls, EV.GROUP_WORDS),
                         lambda: GE.group_logits_plain(ug, calls, EV.GROUP_WORDS)),
    }
    errors, plain_ms = {}, {}
    for name, (kernel, plain) in runs.items():
        got, want = kernel(), plain()
        errors[name] = compare(f"harness-shape {name} vs plain", got, want, **LOGITS_TOL)
        require(torch.equal(got.argmax(1), want.argmax(1)), f"harness-shape {name}: same argmax as plain")
        plain_ms[name] = _time_ms(plain, repeats=2)
    del u, ug
    bounds = _variant_bounds(w, ab)
    say("variants", stage="kernels vs plain, harness shape", card=card, max_abs_err=errors, plain_ms=plain_ms,
        bound_ms={name: b.speed_of_light_s() * 1e3 for name, b in bounds.items()},
        bound_by={name: b.bound_by() for name, b in bounds.items()},
        log_count={name: b.log_count for name, b in bounds.items()})
    return {"ab": ab, "launches": launches, "errors": errors, "plain_ms": plain_ms, "bounds": bounds}


def _variant_bounds(w, ab: dict) -> dict:
    """{A/B name: VariantRoofline} of phase 10b's variants: the E-step's terms over the calls each reads, U's
    bytes, the logs the function needs (a log per term where each is rounded to bf16 words: split with
    sc_words >= 1, group at 1 word; else one per 8 calls or per group) and split's dense bf16 products."""
    from demuxalot_tpu_torch.experiments.estep_variants import GROUP_WORDS
    from demuxalot_tpu_torch.experiments.split_estep import HARNESS_PAIRS
    from demuxalot_tpu_torch.utils.profiling import VariantRoofline, logs_needed

    n_pg, n_donors = ab["n_pg"], ab["n_donors"]
    counts = w.estep.row_ptr.diff().cpu().numpy()

    def bound(n_calls, u_bytes, counts, per, exp_words=0):
        return VariantRoofline(n_calls=n_calls, n_donors=n_donors, n_pseudogenotypes=n_pg,
                               n_barcodes=ab["n_barcodes"], n_variants=ab["n_variants"], u_bytes=u_bytes,
                               log_count=logs_needed(counts, n_pg, per),
                               tensor_flop=2 * exp_words * n_donors * n_pg * n_calls)

    bounds = {"folded": bound(ab["n_calls"], ab["u_bytes"], counts, 8)}
    for e, sc in HARNESS_PAIRS:
        bounds[f"split_{e}{sc}"] = bound(ab["n_calls"], ab["u_bytes"], counts, 1 if sc else 8, e)
    for g, calls in w.groups.items():
        layout = ab["groups"][g]
        per = 1 if GROUP_WORDS == 1 else min(g, 8)
        bounds[f"group_G{g}"] = bound(layout["n_calls"], layout["u_bytes"],
                                      calls.operands.row_ptr.diff().cpu().numpy(), per)
    return bounds


def _variant_entries(variants: dict, launches) -> list:
    """The kernels line's entries of phase 10's three kernels; ``launches(name)`` gives their launch fields."""
    # the E-step variants at the JAX harnesses' shape (phase 10b-c): split's ms at (2,2), the pair that meets
    # the posterior bar, group's at G 4 (TC 512), 2 words; the other settings beside them, each with its bound
    v = variants
    entries = []
    ab, bounds = v["ab"], v["bounds"]
    mean = lambda step: ab["ms"][step]["mean"]  # noqa: E731
    bound_ms = lambda step: bounds[step].speed_of_light_s() * 1e3  # noqa: E731
    by_kernel = {
        "folded_logits": ("folded", "benchmarks/exp_estep.py:40", ab["u_bytes"],
                          {"fold_calls_ms": mean("fold_calls"), "fold_and_folded_ms": mean("fold_and_folded")}),
        "split_logits": ("split_22", "benchmarks/exp_split.py:62", ab["u_bytes"],
                         {"by_pair": {name[6:]: {"ms": mean(name), "bound_ms": bound_ms(name),
                                                 "share_of_bound": bound_ms(name) / mean(name),
                                                 "log_count": bounds[name].log_count, **ab["checks"][name]}
                                      for name in ab["checks"] if name.startswith("split_")}}),
        "group_logits": ("group_G4", "benchmarks/exp_group.py:123", ab["groups"][4]["u_bytes"],
                         {"by_group": {g: {"ms": mean(f"group_G{g}"), "n_calls": x["n_calls"],
                                           "bound_ms": bound_ms(f"group_G{g}"),
                                           "share_of_bound": bound_ms(f"group_G{g}") / mean(f"group_G{g}"),
                                           **ab["checks"][f"group_G{g}"]} for g, x in ab["groups"].items()}}),
    }
    for name, (step, replaces, layout_bytes, extra) in by_kernel.items():
        ms = mean(step)
        entries.append({
            "name": name, "route": "cuda", "source": f"demuxalot_tpu_torch/csrc/{name.split('_')[0]}.cu",
            "replaces": replaces, **launches(name), "max_abs_err": v["errors"][name],
            "posterior_max_abs_err": ab["checks"][step]["posterior_max_abs_err"], "ms": ms,
            "plain_ms": v["plain_ms"][name], "bound_ms": bound_ms(step), "bound_by": bounds[step].bound_by(),
            "share_of_bound": bound_ms(step) / ms, "library_ms": None,
            "library_ms_reason": "no single PyTorch call computes it", "mainline_ms": mean("estep_logits"),
            "mainline_fused_ms": mean("estep_fused"), "layout_bytes": layout_bytes,
            "log_count": bounds[step].log_count, **extra})
    return entries


# ---------------------------------------------------------------------------
# phase 11: the DMA streams, the gather forms and the tiny kernel beside a gather
# ---------------------------------------------------------------------------

def _last_kernels() -> dict:
    """{name: wrapper} of phase 11's five kernels (each wrapper carries ``.launches``)."""
    from demuxalot_tpu_torch.experiments import dma_pattern as DP
    from demuxalot_tpu_torch.experiments import gather_forms as GF
    from demuxalot_tpu_torch.experiments import gather_operand as GO

    return {"stream_cols": DP.stream_cols, "stream_rows": DP.stream_rows, "take_along_axis": GF.take_along_axis,
            "cluster_gather_sum": GF.cluster_gather_sum, "tiny": GO.tiny}


# a child process: each stream route's first launches, each against float64 (1M slots: every block of the
# persistent grid goes round its ring several times)
_STREAM_FIRST = """
import sys
import torch
sys.path.insert(0, {repo!r})
from demuxalot_tpu_torch.experiments import dma_pattern as DP
routes = []
for cols, n_slots, d, step in ((True, 1 << 20, 32, 512), (False, 1 << 20, 32, 512), (True, 70_001, 7, 4096)):
    x = DP.stream_inputs(n_slots, d, seed=1, device="cuda", cols=cols)
    got = float(DP.stream_cols(x, step) if cols else DP.stream_rows(x, step))
    exact = float((DP.stream_cols_plain if cols else DP.stream_rows_plain)(x.double(), step))
    assert abs(got - exact) <= DP.SUM_RTOL * abs(exact), (cols, n_slots, d, step, got, exact)
    routes.append((DP.stream_cols if cols else DP.stream_rows).last_plan.route)
print("ok", routes)
"""


# a child process: take_along_axis with one index past the table (axis 0) or negative (axis 1) must trap
_TAKE_TRAP = """
import sys
import torch
sys.path.insert(0, {repo!r})
from demuxalot_tpu_torch.experiments import gather_forms as GF
axis = {case!r}
table = torch.rand(64, 32, device="cuda")
idx = torch.randint(0, table.shape[axis], (64, 32), dtype=torch.int32, device="cuda")
idx[40, 7] = table.shape[axis] if axis == 0 else -1
try:
    GF.take_along_axis(table, idx, axis)
    torch.cuda.synchronize()
except Exception as error:
    print(type(error).__name__, error)
    sys.exit(3)
print("no trap")
"""


# a child process: the cluster gather-sum's first launches, each against float64
_CLUSTER_FIRST = """
import sys
import numpy as np
import torch
sys.path.insert(0, {repo!r})
from demuxalot_tpu_torch.experiments import gather_forms as GF
rng = np.random.RandomState(2)
for shape, n_idx, step in (((8192, 32), 10_001, 8192), ((1000, 7), 999, 1), ((8192, 32), 1 << 22, 8192)):
    table = torch.from_numpy(rng.rand(*shape).astype(np.float32)).cuda()
    idx = torch.from_numpy(rng.randint(0, shape[0], n_idx).astype(np.int32)).cuda()
    got, exact = float(GF.cluster_gather_sum(table, idx, step)), float(table.double()[idx.long()].sum())
    assert abs(got - exact) <= GF.SUM_RTOL * abs(exact), (shape, n_idx, got, exact)
print("ok", GF.card_plan(8192, 32, torch.cuda.current_device()))
"""

# a child process: the cluster gather-sum with one index past the table or negative must trap
_CLUSTER_TRAP = """
import sys
import torch
sys.path.insert(0, {repo!r})
from demuxalot_tpu_torch.experiments import gather_forms as GF
table = torch.rand(8192, 32, device="cuda")
idx = torch.randint(0, 8192, (100_000,), dtype=torch.int32, device="cuda")
idx[77_777] = 8192 if {case!r} == "past" else -1
try:
    GF.cluster_gather_sum(table, idx)
    torch.cuda.synchronize()
except Exception as error:
    print(type(error).__name__, error)
    sys.exit(3)
print("no trap")
"""


def phase_last_kernels() -> None:
    """Phase 11a: the streams, take_along_axis, the cluster gather-sum and tiny against their plain versions."""
    from demuxalot_tpu_torch.experiments import dma_pattern as DP
    from demuxalot_tpu_torch.experiments import gather_forms as GF
    from demuxalot_tpu_torch.experiments import gather_operand as GO
    from demuxalot_tpu_torch.experiments import kernel_gather as KG
    from torch_problems import offset_view, side_stream_and_replay

    cuda = torch.device("cuda")
    # the streams' first launches on both routes in a child process under a timeout (an mbarrier phase that
    # slips hangs the TMA route, and a hang must fail the smoke, not stall it)
    try:
        first = subprocess.run([sys.executable, "-c", _STREAM_FIRST.format(repo=str(REPO))], capture_output=True,
                               text=True, timeout=180)
        require(first.returncode == 0, f"the streams' first launches failed: {(first.stdout + first.stderr)[-2000:]}")
    except subprocess.TimeoutExpired as expired:
        require(False, f"the streams' first launches did not end in 180 s (a hang): {expired.stdout}")
    say("last", kernel="streams", first_launches=first.stdout.strip().splitlines()[-1][:200])
    # each route against float64 (the plain version beside it), two runs, a side stream and a graph's replay, bit
    # for bit: TMA boxes at the harness's widths and 1M slots (several rounds of each block's ring), with a ragged
    # tail (66,313 = 2 x 32,768 + 777 rows), and cp.async where TMA cannot address x: N = 66,313 columns, D = 7
    # rows, x one float off a 16-byte boundary
    for cols, n_slots, d, step, offset, route in (
            (True, 1 << 20, 32, 512, 0, "tma"), (True, 65_536, 32, 32_768, 0, "tma"),
            (False, 1 << 20, 32, 512, 0, "tma"), (False, 65_536 + 777, 32, 512, 0, "tma"),
            (False, 65_536 + 777, 32, 32_768, 0, "tma"), (True, 65_536 + 777, 32, 512, 0, "cp.async"),
            (True, 65_536 + 777, 32, 32_768, 0, "cp.async"), (True, 70_001, 7, 4096, 0, "cp.async"),
            (False, 70_001, 7, 4096, 0, "cp.async"), (True, 1 << 20, 32, 512, 1, "cp.async")):
        kernel, plain = (DP.stream_cols, DP.stream_cols_plain) if cols else (DP.stream_rows, DP.stream_rows_plain)
        x = offset_view(DP.stream_inputs(n_slots, d, seed=step, device=cuda, cols=cols), offset)
        run = lambda: kernel(x, step)  # noqa: E731
        got, want = run(), float(plain(x, step))
        plan = kernel.last_plan
        require(plan.route == route and plan == DP.stream_plan(x, step, cols),
                f"{kernel.__name__}({step}) on {tuple(x.shape)} offset {offset}: route {plan.route}, not {route}")
        exact = float(plain(x.double(), step))
        for name, value in (("kernel", float(got)), ("plain", want)):
            require(abs(value - exact) <= DP.SUM_RTOL * abs(exact),
                    f"{kernel.__name__}({step}) on {tuple(x.shape)} {name}: {value} vs float64 {exact}")
        require(torch.equal(run(), got), f"{kernel.__name__}({step}) {route}: two runs bit-equal")
        on_side, replayed = side_stream_and_replay(run)
        require(torch.equal(on_side, got) and torch.equal(replayed, got),
                f"{kernel.__name__}({step}) {route}: side stream and graph replay bit-equal")
        say("last", kernel=kernel.__name__, shape=list(x.shape), step=step, offset=offset, route=plan.route,
            stages=plan.stages, box=list(plan.box), tma_refusal=plan.reason, rel_err=abs(float(got) - exact) / exact,
            plain_rel_err=abs(want - exact) / exact, runs="bit-equal", side_stream_and_graph="bit-equal")
        del x
    # both axes, widths of 7 and 33 (no multiple of 4), the harness's D2 and E2, and a table and indices one
    # float past a 16-byte boundary (the scalar paths): bit-equal eagerly, on a side stream and in a graph's replay
    rng = np.random.RandomState(11)
    for axis, shape, out_rows, offset in ((0, (50, 7), 13, 0), (0, (8192, 128), 8192, 0), (1, (9, 33), 9, 0),
                                          (1, (256, 512), 256, 0), (0, (8192, 128), 8192, 1), (1, (256, 512), 256, 1)):
        table = offset_view(torch.from_numpy(rng.rand(*shape).astype(np.float32)).to(cuda), offset)
        idx_shape = (out_rows, shape[1]) if axis == 0 else (shape[0], 2 * shape[1] + 1)
        idx = offset_view(torch.from_numpy(rng.randint(0, shape[axis], idx_shape).astype(np.int32)).to(cuda), offset)
        want = GF.take_along_axis_plain(table, idx, axis)
        got = GF.take_along_axis(table, idx, axis)
        require(torch.equal(got, want), f"take_along_axis axis {axis} {shape} offset {offset}: bit-equal to the "
                                        f"plain version")
        require(torch.equal(got, GF.take_along_axis(table, idx, axis)), f"take_along_axis {shape}: runs bit-equal")
        on_side, replayed = side_stream_and_replay(lambda: GF.take_along_axis(table, idx, axis))
        require(torch.equal(on_side, want) and torch.equal(replayed, want),
                f"take_along_axis axis {axis} {shape} offset {offset}: side stream and graph replay bit-equal")
        say("last", kernel="take_along_axis", axis=axis, table=list(shape), idx=list(idx_shape), offset=offset,
            out="bit-equal", side_stream_and_graph="bit-equal")
    # the cluster gather-sum: its first launches in a child process under a timeout (an mbarrier phase that slips
    # hangs the kernel, and a hang must fail the smoke, not stall it), then its cases here: a ragged last step,
    # every index in CTA 0's slice (rows < 1,024), a width of 7 with steps of 1, the harness's table, indices one
    # int past a 16-byte boundary, a length whose last stage is short and whose tail is read by plain loads, a
    # width of 33 with steps over several chunks; against float64, two runs, a side stream and a graph's replay
    try:
        first = subprocess.run([sys.executable, "-c", _CLUSTER_FIRST.format(repo=str(REPO))], capture_output=True,
                               text=True, timeout=180)
        first_out = first.stdout + first.stderr
        require(first.returncode == 0, f"cluster_gather_sum's first launches failed: {first_out[-2000:]}")
    except subprocess.TimeoutExpired as expired:
        require(False, f"cluster_gather_sum's first launches did not end in 180 s (a hang): {expired.stdout}")
    index = torch.cuda.current_device()
    card = GF.card_plan(GF.RB, GF.WB, index)
    mirror = GF.cluster_plan(GF.RB, GF.WB, GF.STEP, GF.NIDX, KG._card_limits(index)[0])
    require((card["stages"], card["shared_bytes"]) == (mirror.stages, mirror.shared_bytes),
            f"cluster_plan {mirror} mirrors the card's plan {card}")
    sms = card["clusters"] * GF.CLUSTER_CTAS // card["ctas_per_sm"]
    say("last", kernel="cluster_gather_sum", first_launches=first_out.strip().splitlines()[-1][:200],
        card_plan=card, sms_used=sms)
    for shape, n_idx, step, high, offset in (((8192, 32), 10_001, 8192, 8192, 0), ((8192, 32), 50_000, 8192, 1024, 0),
                                             ((1000, 7), 5000, 1, 1000, 0), ((8192, 32), 1 << 20, 8192, 8192, 0),
                                             ((8192, 32), 50_000, 8192, 8192, 1),
                                             ((8192, 32), 3 * 8192 + 1002, 8192, 8192, 0),
                                             ((4000, 33), 70_001, 3000, 4000, 3)):
        table = torch.from_numpy(rng.rand(*shape).astype(np.float32)).to(cuda)
        idx = offset_view(torch.from_numpy(rng.randint(0, high, n_idx).astype(np.int32)).to(cuda), offset)
        got, want = float(GF.cluster_gather_sum(table, idx, step)), float(GF.cluster_gather_sum_plain(table, idx, step))
        exact = float(table.double()[idx.long()].sum())
        for name, value in (("kernel", got), ("plain", want)):
            require(abs(value - exact) <= GF.SUM_RTOL * abs(exact),
                    f"cluster_gather_sum {shape} n={n_idx} {name}: {value} vs float64 {exact}")
        require(float(GF.cluster_gather_sum(table, idx, step)) == got, f"cluster_gather_sum {shape}: runs bit-equal")
        on_side, replayed = side_stream_and_replay(lambda: GF.cluster_gather_sum(table, idx, step).clone())
        require(float(on_side) == got and float(replayed) == got,
                f"cluster_gather_sum {shape} n={n_idx}: side stream and graph replay bit-equal")
        plan = GF.card_plan(*shape, index)
        say("last", kernel="cluster_gather_sum", table=list(shape), n_idx=n_idx, step=step, index_below=high,
            offset=offset, rel_err=abs(got - exact) / exact, plain_rel_err=abs(want - exact) / exact,
            runs="bit-equal", side_stream_and_graph="bit-equal", stages=plan["stages"], clusters=plan["clusters"],
            sms_used=plan["clusters"] * GF.CLUSTER_CTAS // plan["ctas_per_sm"])
    try:  # a 16 MiB table fits no cluster: it raises, and nothing falls back
        GF.cluster_gather_sum(torch.rand(131_072, 32, device=cuda), torch.zeros(8, dtype=torch.int32, device=cuda))
        raised = None
    except RuntimeError as error:
        raised = str(error)
    require(raised is not None and "does not fit" in raised, "a table past the cluster's shared memory raises")
    for shape, offset in (((8, 128), 0), ((3, 5), 0), ((1_000_003,), 0), ((8, 128), 1)):
        x = offset_view(torch.randn(shape, device=cuda), offset)
        want = GO.tiny_plain(x)
        require(torch.equal(GO.tiny(x), want), f"tiny {shape} offset {offset}: bit-equal to x * 2")
        on_side, replayed = side_stream_and_replay(lambda: GO.tiny(x))
        require(torch.equal(on_side, want) and torch.equal(replayed, want),
                f"tiny {shape}: side stream and graph replay bit-equal")
    say("last", kernel="tiny", shapes=[[8, 128], [3, 5], [1_000_003], "[8, 128] one float off"], out="bit-equal",
        side_stream_and_graph="bit-equal", table_past_cluster=raised)
    # an index out of range traps inside the gather: a trap ends the process's CUDA context, so each axis runs
    # in a child process, both at once
    trapped = _trapping_children(_TAKE_TRAP, (0, 1))
    say("last", kernel="take_along_axis", index_out_of_range={f"axis {axis}": v for axis, v in trapped.items()})
    say("last", kernel="cluster_gather_sum", index_out_of_range=_trapping_children(_CLUSTER_TRAP, ("past", "negative")))


def phase_last(card: str) -> dict:
    """Phase 11b-d: the stream rates, the forms probe and microbench, the gather-operand stages (counted), then
    each kernel against its plain version at the harnesses' shapes and the plain versions' and library calls'
    times."""
    from demuxalot_tpu_torch.experiments import dma_pattern as DP
    from demuxalot_tpu_torch.experiments import gather_forms as GF
    from demuxalot_tpu_torch.experiments import gather_operand as GO
    from demuxalot_tpu_torch.experiments import kernel_gather as KG
    from demuxalot_tpu_torch.ops.likelihood_kernel import estep_logits
    from demuxalot_tpu_torch.utils.profiling import GatherRoofline, StreamRoofline

    cuda = torch.device("cuda")
    counted = {"estep_logits": estep_logits, "gather_rows": KG.gather_rows, "gather_sum": KG.gather_sum,
               **_last_kernels()}
    for wrapper in counted.values():
        wrapper.launches = 0
    t0 = time.perf_counter()
    streams = DP.run_stream(cuda)
    forms = GF.probe_forms(cuda)
    bench = GF.microbench(cuda)
    post, cb = GO.operand_inputs(device=cuda)
    stages = {1: GO.run_stages(GO.stages(1, cb), post)}
    estep = GO.pmbc_estep(cuda)
    for phase in (2, 3):
        stages[phase] = GO.run_stages(GO.stages(phase, cb, estep), post)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: wrapper.launches for name, wrapper in counted.items()}
    for name in _last_kernels():
        require(launches[name] > 0, f"the experiments' path launched {name} {launches[name]} times")
    require(all(r["ok"] for r in forms.values()), f"forms: {[f for f, r in forms.items() if not r['ok']]} differ")
    del post, cb, estep
    for r in streams:
        say("last", stage="stream rate", card=card, **r)
        require(r["route"] == "tma", f"{r['layout']} at step {r.get('width', r.get('rows'))}: the harness's shape "
                                     f"takes the {r['route']} route, not TMA ({r['tma_refusal']})")
    say("last", stage="forms", card=card,
        **{form: {k: v for k, v in r.items() if k != "output"} for form, r in forms.items()})
    say("last", stage="microbench", card=card, **bench)
    for phase, result in stages.items():
        say("last", stage=f"gather operand, phase {phase}", card=card, **result)
    say("last", stage="path", card=card, launches=launches, wall_s=wall)

    # the streams at the harness's shape: kernel against plain (both f32, in other orders, against float64),
    # the plain version's time, one torch.sum over the corners (the scalar's library call) and torch.sum over
    # the streamed bytes (what the kernel exists to measure)
    entries = {}
    for cols, kernel, plain in ((True, DP.stream_cols, DP.stream_cols_plain),
                                (False, DP.stream_rows, DP.stream_rows_plain)):
        x = DP.stream_inputs(device=cuda, cols=cols)
        step = (DP.WIDTHS if cols else DP.ROWS)[0]
        n_steps = (x.shape[1] if cols else x.shape[0]) // step
        corners = (x.narrow(1, 0, n_steps * step).unflatten(1, (n_steps, step))[:, :, :DP.CORNER_COLS] if cols
                   else x.narrow(0, 0, n_steps * step).unflatten(0, (n_steps, step))[:, :DP.CORNER_ROWS, :])
        got, want = float(kernel(x, step)), float(plain(x, step))
        exact = float(plain(x.double(), step))
        require(abs(want - exact) <= DP.SUM_RTOL * abs(exact), f"{kernel.__name__} plain: {want} vs {exact}")
        bound = DP.corner_bound(x, step, cols)
        entries[kernel.__name__] = {
            "max_abs_err": abs(got - want), "float64_rel_err": abs(got - exact) / exact,
            "plain_ms": _time_ms(lambda: plain(x, step), repeats=3),
            "library_ms": _time_ms(lambda: torch.sum(corners)), "stream_library_ms": _time_ms(lambda: torch.sum(x)),
            "bound_ms": bound.speed_of_light_s() * 1e3, "bound_by": bound.bound_by(),
            "by_step": [r for r in streams if r["layout"] == ("cols" if cols else "rows")]}
        del x, corners
    # take_along_axis on the forms' inputs: each form's time beside torch.gather's (A and B: gather_rows
    # beside index_select), the entry's at D2, the largest
    by_form = {}
    for form, (table_np, idx_np, axis) in GF.form_inputs(np.random.default_rng(0)).items():
        table, idx = torch.from_numpy(table_np).to(cuda), torch.from_numpy(idx_np).to(cuda)
        idx_long = idx.long()
        if axis is None:
            library = lambda: torch.index_select(table, 0, idx)  # noqa: E731
            flat = idx_long
            width = table.shape[1]
        else:
            library = lambda: torch.gather(table, axis, idx_long)  # noqa: E731
            cols = torch.arange(idx.shape[1], device=cuda)
            rows = torch.arange(idx.shape[0], device=cuda)[:, None]
            flat = (idx_long * table.shape[1] + cols) if axis == 0 else (rows * table.shape[1] + idx_long)
            width = 1
        bound = GatherRoofline(n_idx=idx.numel(), n_rows_touched=int(torch.unique(flat).numel()), width=width,
                               rows_out=True)
        run = lambda: GF.run_form(table, idx, axis)  # noqa: E731
        plain = lambda: (GF.take_along_axis_plain(table, idx, axis) if axis is not None  # noqa: E731
                         else KG.gather_rows_plain(table, idx))
        ms, library_ms = _in_turns(run, library, lambda fn: _time_ms(fn, repeats=100))
        by_form[form] = {"table": list(table.shape), "idx": list(idx.shape), "axis": axis,
                         "kernel": "gather_rows" if axis is None else "take_along_axis",
                         "max_abs_err": float((run() - plain()).abs().max()), "ms": ms,
                         "plain_ms": _time_ms(plain, repeats=100), "library_ms": library_ms,
                         "bound_ms": bound.speed_of_light_s() * 1e3, "bound_by": bound.bound_by(),
                         "share_of_bound": bound.speed_of_light_s() * 1e3 / ms}
        if axis is not None:
            # the device time (graph replay over copies of the inputs past L2) and the host's enqueue time beside
            # the eager time, the library call's beside each, in turns
            graphed = ((lambda t, i: GF.run_form(t, i, axis)), (table, idx))
            library_graphed = ((lambda t, i: torch.gather(t, axis, i)), (table, idx_long))
            graph_ms, library_graph_ms = _in_turns(graphed, library_graphed, lambda c: _graph_ms(*c))
            host_us, library_host_us = _in_turns(run, library, _host_us)
            copies, nbytes = _rotation(*graphed)
            by_form[form].update(graph_ms=graph_ms, host_us=host_us, library_graph_ms=library_graph_ms,
                                 library_host_us=library_host_us, graph_input_mb=copies * nbytes / 1e6,
                                 graph_share_of_bound=bound.speed_of_light_s() * 1e3 / graph_ms)
    say("last", stage="forms timed", card=card, by_form=by_form)
    # the cluster gather-sum at the microbench's shape: against its plain version, the plain version's time
    rng = np.random.default_rng(0)
    GF.form_inputs(rng)
    table, idx = GF.microbench_inputs(rng, cuda)
    got, want = float(GF.cluster_gather_sum(table, idx)), float(GF.cluster_gather_sum_plain(table, idx))
    require(abs(got - want) <= GF.SUM_RTOL * abs(bench["float64_sum"]), f"cluster_gather_sum {got} vs plain {want}")
    # its device time (graph replay over copies of the inputs past L2) and the host's enqueue time beside the
    # eager time, index_select(...).sum()'s beside each, in turns; the layout's own cost beside the bound: the
    # indices and slices it reads from L2 and the floor of its shared-memory reads (128 B a clock on each SM used)
    run, library = (lambda: GF.cluster_gather_sum(table, idx)), (lambda: torch.index_select(table, 0, idx).sum())
    graphed = ((lambda t, i: GF.cluster_gather_sum(t, i)), (table, idx))
    library_graphed = ((lambda t, i: torch.index_select(t, 0, i).sum()), (table, idx))
    graph_ms, library_graph_ms = _in_turns(graphed, library_graphed, lambda c: _graph_ms(*c))
    host_us, library_host_us = _in_turns(run, library, _host_us)
    copies, nbytes = _rotation(*graphed)
    plan = GF.card_plan(*table.shape, torch.cuda.current_device())
    sms = plan["clusters"] * GF.CLUSTER_CTAS // plan["ctas_per_sm"]
    layout = GF.cluster_layout(tuple(table.shape), idx.shape[0], GF.STEP, plan["clusters"])
    clock_mhz = _sm_clock_mhz()
    entries["cluster_gather_sum"] = {
        "max_abs_err": abs(got - want),
        "plain_ms": _time_ms(lambda: GF.cluster_gather_sum_plain(table, idx), repeats=3),
        "graph_ms": graph_ms, "host_us": host_us, "library_graph_ms": library_graph_ms,
        "library_host_us": library_host_us, "graph_input_mb": copies * nbytes / 1e6,
        "graph_share_of_bound": bench["bound_ms"] / graph_ms, "clusters": plan["clusters"], "sms_used": sms,
        "stages": plan["stages"], "shared_bytes_per_cta": plan["shared_bytes"], **layout,
        "index_passes": 1, "sm_clock_mhz": clock_mhz,
        "shared_floor_ms": layout["shared_read_bytes"] / 128 / sms / (clock_mhz * 1e6) * 1e3}
    del table, idx
    # tiny at its shape, beside x * 2 and torch.mul: eager, graph replay and host enqueue times
    x = torch.randn(GO.TINY_SHAPE, device=cuda)
    run, library = (lambda: GO.tiny(x)), (lambda: torch.mul(x, 2.0))
    ms, library_ms = _in_turns(run, library, lambda fn: _time_ms(fn, repeats=100))
    graphed, library_graphed = (GO.tiny, (x,)), ((lambda t: torch.mul(t, 2.0)), (x,))
    graph_ms, library_graph_ms = _in_turns(graphed, library_graphed, lambda c: _graph_ms(*c))
    copies, nbytes = _rotation(*graphed)
    host_us, library_host_us = _in_turns(run, library, _host_us)
    entries["tiny"] = {"max_abs_err": float((GO.tiny(x) - GO.tiny_plain(x)).abs().max()),
                       "ms": ms, "graph_ms": graph_ms, "host_us": host_us,
                       "plain_ms": _time_ms(lambda: GO.tiny_plain(x), repeats=100),
                       "library_ms": library_ms, "library_graph_ms": library_graph_ms,
                       "library_host_us": library_host_us, "graph_input_mb": copies * nbytes / 1e6,
                       "bound": StreamRoofline(bytes_read=x.numel() * 4, bytes_written=x.numel() * 4,
                                               n_operations=x.numel())}
    host_path = _host_path_us(GF, cuda)
    say("last", stage="kernels vs plain", card=card, host_path_us=host_path,
        **{name: {k: v for k, v in e.items() if k not in ("by_step", "bound")} for name, e in entries.items()})
    return {"launches": launches, "streams": streams, "bench": bench, "by_form": by_form, "stages": stages,
            "entries": entries, "host_path_us": host_path, "wall_s": wall}


def _host_path_us(GF, cuda) -> dict:
    """Host µs per call of each piece of a launch's host path, at D2's shape (``_host_us``: medians of 5 windows of
    200 calls).

    ``device_guard``, ``current_stream`` and ``library_lookup`` are what a launch without ``_cuda.Entry`` would
    pay each call (``with torch.cuda.device(d)``, ``torch.cuda.current_stream(d).cuda_stream``,
    ``_cuda.library().<fn>``); ``Entry`` keeps the ctypes function, reads the stream's raw handle and passes the
    device index to C.
    ``launch`` is the Entry's call alone (no checks, no allocation), ``launch_empty`` the same on an empty output,
    where the C entry returns before its device guard and the launch; ``wrapper`` the whole call."""
    from demuxalot_tpu_torch.ops import _cuda

    table = torch.rand(8192, 128, device=cuda)
    idx = torch.randint(0, 8192, (8192, 128), device=cuda, dtype=torch.int32)
    out = torch.empty(idx.shape, device=cuda)
    index = torch.cuda.current_device()
    args = (table.data_ptr(), 8192, 128, idx.data_ptr(), 8192, 128, 0, out.data_ptr())  # up to the device
    empty = (*args[:4], 0, *args[5:])  # rows_out 0

    def guard():
        with torch.cuda.device(cuda):
            pass

    return {"device_guard": _host_us(guard),
            "current_stream": _host_us(lambda: torch.cuda.current_stream(cuda).cuda_stream),
            "raw_stream": _host_us(lambda: torch._C._cuda_getCurrentRawStream(index)),
            "library_lookup": _host_us(lambda: _cuda.library().demux_take_along_axis),
            "empty": _host_us(lambda: torch.empty(idx.shape, dtype=torch.float32, device=cuda)),
            "empty_like": _host_us(lambda: torch.empty_like(idx, dtype=torch.float32)),
            "launch": _host_us(lambda: GF._take_along_axis(table, *args)),
            "launch_empty": _host_us(lambda: GF._take_along_axis(table, *empty)),
            "wrapper": _host_us(lambda: GF.take_along_axis(table, idx, 0))}


def _last_entries(last: dict, launches) -> list:
    """The kernels line's entries of phase 11's five kernels; ``launches(name)`` gives their launch fields."""
    e = last["entries"]
    entries = []
    # the streams: ms at the TPU harness's first width / row count (512), every step beside it. bound_ms and
    # library_ms are the scalar's own (the corners' bytes, one torch.sum over them); the stream reads every
    # byte of each step by design, so it is slower than both: stream_bound_ms and stream_library_ms
    # (torch.sum over the streamed bytes) are what it measures itself against
    for name, replaces in (("stream_cols", "benchmarks/exp_dma_pattern.py:32"),
                           ("stream_rows", "benchmarks/exp_dma_pattern.py:71")):
        first, *_ = e[name]["by_step"]
        entries.append({
            "name": name, "route": "cuda", "source": "demuxalot_tpu_torch/csrc/stream.cu", "replaces": replaces,
            **launches(name), "max_abs_err": e[name]["max_abs_err"], "ms": first["ms_mean"],
            "plain_ms": e[name]["plain_ms"], "bound_ms": e[name]["bound_ms"], "bound_by": e[name]["bound_by"],
            "share_of_bound": e[name]["bound_ms"] / first["ms_mean"], "library_ms": e[name]["library_ms"],
            "library_ms_reason": "one torch.sum over the corners computes the scalar; the kernel streams every "
                                 "byte of each step by design",
            "stream_bound_ms": first["stream_bound_ms"], "stream_share_of_bound": first["stream_share_of_bound"],
            "stream_library_ms": e[name]["stream_library_ms"], "shape": first["shape"], "gb_per_s": first["gb_per_s"],
            "path": first["route"], "stages": first["stages"], "box": first["box"],
            "by_step": [{"step": r.get("width", r.get("rows")), "run_bytes": r["run_bytes"], "path": r["route"],
                         "stages": r["stages"], "box": r["box"], "boxes_per_step": r["boxes_per_step"],
                         "ms": r["ms_mean"], "gb_per_s": r["gb_per_s"], "stream_bound_ms": r["stream_bound_ms"],
                         "stream_share_of_bound": r["stream_share_of_bound"],
                         "stream_library_ms": r["library_ms_mean"], "corner_bound_ms": r["corner_bound_ms"]}
                        for r in e[name]["by_step"]]})
    # take_along_axis and tiny: ms (eager), graph_ms (device), host_us (the host's enqueue time), each beside the
    # library call's
    split = ("graph_ms", "host_us", "library_graph_ms", "library_host_us", "graph_input_mb")
    d2 = last["by_form"]["D2"]
    entries.append({
        "name": "take_along_axis", "route": "cuda", "source": "demuxalot_tpu_torch/csrc/forms.cu",
        "replaces": "benchmarks/exp_gather_forms.py:38", **launches("take_along_axis"),
        "max_abs_err": d2["max_abs_err"],
        "ms": d2["ms"], "plain_ms": d2["plain_ms"], "bound_ms": d2["bound_ms"], "bound_by": d2["bound_by"],
        "share_of_bound": d2["share_of_bound"], "library_ms": d2["library_ms"], **{k: d2[k] for k in split},
        "graph_share_of_bound": d2["graph_share_of_bound"], "form": "D2", "by_form": last["by_form"], "host_path_us": last["host_path_us"]})
    b = last["bench"]
    entries.append({
        "name": "cluster_gather_sum", "route": "cuda", "source": "demuxalot_tpu_torch/csrc/forms.cu",
        "replaces": "benchmarks/exp_gather_forms.py:183", **launches("cluster_gather_sum"),
        "max_abs_err": e["cluster_gather_sum"]["max_abs_err"], "ms": b["cluster_gather_sum"]["ms_mean"],
        "plain_ms": e["cluster_gather_sum"]["plain_ms"], "bound_ms": b["bound_ms"], "bound_by": b["bound_by"],
        "share_of_bound": b["bound_ms"] / b["cluster_gather_sum"]["ms_mean"],
        "library_ms": b["library"]["ms_mean"], "ns_per_row": b["cluster_gather_sum"]["ns_per_row"],
        "gather_sum_ms": b["gather_sum"]["ms_mean"], "gather_sum_path": b["gather_sum"]["path"], "table": b["table"],
        "n_idx": b["n_idx"],
        **{k: v for k, v in e["cluster_gather_sum"].items() if k not in ("max_abs_err", "plain_ms")}})
    tiny, bound = e["tiny"], e["tiny"]["bound"]
    entries.append({
        "name": "tiny", "route": "cuda", "source": "demuxalot_tpu_torch/csrc/tiny.cu",
        "replaces": "benchmarks/exp_gather_operand.py:108", **launches("tiny"), "max_abs_err": tiny["max_abs_err"],
        "ms": tiny["ms"], "plain_ms": tiny["plain_ms"], "bound_ms": bound.speed_of_light_s() * 1e3,
        "bound_by": bound.bound_by(), "share_of_bound": bound.speed_of_light_s() * 1e3 / tiny["ms"],
        "library_ms": tiny["library_ms"], **{k: tiny[k] for k in split},
        "stages_ms": {str(p): {n: s["ms"] for n, s in r.items()} for p, r in last["stages"].items()}})
    return entries


# ---------------------------------------------------------------------------
# --parent: this tree's steps beside an older tree's, in turns
# ---------------------------------------------------------------------------

def steps_ms() -> dict:
    """The bench-shape E-step and its softmax, the M-step and one EM iteration of the package on sys.path,
    as its EM loop runs them (the M-step as ``_EMRun`` calls it: fused with the normalisation where the
    package has ``mstep_update``, else the addition kernel, then ``probs_from_betas``)."""
    import inspect

    from demuxalot_tpu_torch import Demultiplexer
    from demuxalot_tpu_torch.models import demux
    from demuxalot_tpu_torch.models.demux import _EMRun, _Likelihood
    from demuxalot_tpu_torch.ops import likelihood as L
    from demuxalot_tpu_torch.ops.likelihood_kernel import estep_logits
    from demuxalot_tpu_torch.ops.mstep_kernel import mstep_addition

    genotypes, handler, packed, _truth = _bench_data()
    Demultiplexer.device = "cuda"
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
    # one M-step on the first iteration's posteriors, through the EM loop's own call
    run = _EMRun(packed, genotypes, handler, 2, 0.01, DOUBLET_PRIOR, None)
    state = next(run.device_iterations())
    if hasattr(demux, "mstep_update") and run.likelihood.mstep.snp_ptr is not None:
        m_step = lambda: run.likelihood.update(state.probs, run.prior_betas_dev, None, 0.01,  # noqa: E731
                                               run.n_genotypes)
    else:
        m_step = lambda: L.probs_from_betas(  # noqa: E731
            run.prior_betas_dev + mstep_addition(state.probs, run.likelihood.mstep, run.n_genotypes, 2.0),
            run.variant2snp, run.n_snps, 0.01, max_per_snp=run.max_per_snp)
    # the outputs' bits (digests) on the same inputs: the bench-shape E-step, its posteriors, the M-step
    logits_probs = estep_logits(gprob, lik.estep, softmax=True) if fused else (estep_logits(gprob, lik.estep),)
    m_out = m_step()
    bits = {"estep_logits": _digest(estep_logits(gprob, lik.estep)), "estep_probs": _digest(logits_probs[-1]),
            "mstep_addition": _digest(mstep_addition(state.probs, run.likelihood.mstep, run.n_genotypes, 2.0)),
            "m_step": _digest(*(m_out if isinstance(m_out, tuple) else (m_out,)))}
    # the M-step plan's split counters (a tree without them: None); 0 on this flat pool
    from demuxalot_tpu_torch.utils import tracing
    counters = tracing.snapshot()["counters"]
    split = {name: counters.get(f"mstep.{name}") for name in ("split_calls", "split_units")}
    banded, launch_bound = _banded_steps(cuda), _launch_bound_ms(cuda)
    aggregate = _aggregate_steps(packed, handler, gprob, cuda)
    streams = _stream_steps(cuda)
    return {"package": str(Path(inspect.getfile(estep_logits)).parents[2]), "fused": fused, "mstep": split,
            "bits": {**bits, **banded.pop("bits"), **launch_bound.pop("bits"), **aggregate.pop("bits"),
                     **streams.pop("bits")}, **banded, **aggregate, **streams,
            "estep_softmax_ms": [_time_ms(step) for _ in range(3)],
            "estep_ms": [_time_ms(lambda: estep_logits(gprob, lik.estep)) for _ in range(3)],
            "mstep_addition_ms": [_time_ms(lambda: mstep_addition(state.probs, run.likelihood.mstep,
                                                                  run.n_genotypes, 2.0)) for _ in range(3)],
            "m_step_ms": [_time_ms(m_step) for _ in range(3)],
            "em_iteration_ms": [_em_iteration_ms(genotypes, handler, packed) for _ in range(2)],
            **launch_bound, **_variant_steps_ms(cuda)}


def _aggregate_steps(packed, handler, gprob, cuda) -> dict:
    """The aggregate kernel's fused call of the package on sys.path at 32 and 528 columns (the bench shape's EM and
    predict operands), at 64 donors and on the calls at 32 columns regrouped ``AGGREGATE_GROUP_CALLS`` a group
    (phase 7a's cases): three samples each, the wrapper's host µs a call at 32
    columns, its outputs' bits; where ``CHIP_SMOKE_SAVE`` gives a path prefix, the logits and probs stacked into
    ``<prefix>_<case>.npy`` for the drift between trees. Nothing for a package without the kernel."""
    import os

    if not hasattr(packed, "aggregate_operands"):
        return {"bits": {}}
    from demuxalot_tpu_torch.ops.aggregate_kernel import aggregated_logits

    n_barcodes, n_donors = handler.n_barcodes, BENCH["n_donors"]
    cases = {str(prior_pg): (gprob, packed.aggregate_operands(n_barcodes, n_donors, prior, cuda))
             for prior, prior_pg in ((0.0, 32), (DOUBLET_PRIOR, 528))}
    cases["d64"] = _aggregate_d64_inputs(cuda)
    cases["many"] = (gprob, _regrouped(cases["32"][1], AGGREGATE_GROUP_CALLS))
    result, bits = {}, {}
    save = os.environ.get("CHIP_SMOKE_SAVE")
    for name, (g, operands) in cases.items():
        run = lambda: aggregated_logits(g, operands, softmax=True)  # noqa: E731
        result[f"aggregate_{name}_ms"] = [_time_ms(run, repeats=5) for _ in range(3)]
        logits, probs = run()
        bits[f"aggregate_{name}"] = _digest(logits, probs)
        if save:
            np.save(f"{save}_{name}.npy", torch.stack([logits, probs]).cpu().numpy())
        del logits, probs
    result["aggregate_host_us"] = [_host_us(lambda: aggregated_logits(gprob, cases["32"][1], softmax=True))]
    return {**result, "bits": bits}


def _stream_steps(cuda) -> dict:
    """Both streams of the package on sys.path at the harness's shape and all 8 steps: three samples each (CUDA
    events over 10 calls), each step's route (None for a tree without a plan) and the bits of each scalar."""
    from demuxalot_tpu_torch.experiments import dma_pattern as DP

    result, bits, routes = {}, {}, {}
    for cols, kernel, steps in ((True, DP.stream_cols, DP.WIDTHS), (False, DP.stream_rows, DP.ROWS)):
        x = DP.stream_inputs(device=cuda, cols=cols)
        for step in steps:
            name = f"{kernel.__name__}_{step}"
            result[f"{name}_ms"] = [_time_ms(lambda: kernel(x, step)) for _ in range(3)]
            bits[name] = _digest(kernel(x, step))
            plan = getattr(kernel, "last_plan", None)
            routes[name] = plan.route if plan is not None else None
        del x
    return {**result, "stream_routes": routes, "bits": bits}


def _digest(*tensors: torch.Tensor) -> str:
    """The first 16 hex digits of the sha256 of the tensors' bytes."""
    import hashlib

    digest = hashlib.sha256()
    for tensor in tensors:
        digest.update(tensor.detach().contiguous().cpu().numpy().tobytes())
    return digest.hexdigest()[:16]


def _banded_steps(cuda) -> dict:
    """The banded E-step and M-step at phase 9b's shape (``bench_workload``: the JAX harness's, 12 and 82 bands) of
    the package on sys.path: three samples each, and their outputs' bits with those of the workload's inputs
    (made by the mainline kernels, so equal where the mainline's outputs are)."""
    from demuxalot_tpu_torch.experiments import inkernel_gather as IG

    w = IG.bench_workload(device=cuda)
    estep = lambda: IG.estep_logits_banded(w.genotype_prob, w.estep_banded)  # noqa: E731
    mstep = lambda: IG.mstep_addition_banded(w.posterior, w.mstep_banded, w.n_genotypes, w.power)  # noqa: E731
    return {"banded_estep_ms": [_time_ms(estep) for _ in range(3)],
            "banded_mstep_ms": [_time_ms(mstep) for _ in range(3)],
            "bits": {"banded_inputs": _digest(w.genotype_prob, w.posterior), "banded_logits": _digest(estep()),
                     "banded_addition": _digest(mstep())}}


def _variant_steps_ms(cuda) -> dict:
    """split at (2,2) and (0,0), group at G 4 with 2 words and folded, at the E-step variants' harness shape
    (phase 10b), of the package on sys.path: three samples each."""
    from demuxalot_tpu_torch.experiments import estep_variants as EV
    from demuxalot_tpu_torch.experiments import folded_estep as FE
    from demuxalot_tpu_torch.experiments import group_estep as GE
    from demuxalot_tpu_torch.experiments import split_estep as SE

    w = EV.variants_workload(cuda, groups=(4,))
    u, calls = FE.fold_calls(w.genotype_prob, w.estep), w.groups[4]
    ug = FE.fold_calls(w.genotype_prob, calls)
    runs = {"split_22_ms": lambda: SE.split_logits(u, w.operands, 2, 2),
            "split_00_ms": lambda: SE.split_logits(u, w.operands, 0, 0),
            "group_G4_ms": lambda: GE.group_logits(ug, calls, EV.GROUP_WORDS),
            "folded_ms": lambda: FE.folded_logits(u, w.operands)}
    return {name: [_time_ms(run) for _ in range(3)] for name, run in runs.items()}


def _launch_bound_ms(cuda) -> dict:
    """take_along_axis at form D2, tiny at [8, 128], gather_sum at [8192, 64] x 1,048,576 indices and
    cluster_gather_sum at the microbench's [8192, 32] x 4,194,304 of the package on sys.path: eager (100 calls
    between events) and graph-replay ms per call (``_graph_ms``: copies of the inputs past L2), three samples each,
    and the bits of gather_sum's sum. A tree whose cluster gather-sum a graph cannot capture has None there."""
    from demuxalot_tpu_torch.experiments import gather_forms as GF
    from demuxalot_tpu_torch.experiments import gather_operand as GO
    from demuxalot_tpu_torch.experiments import kernel_gather as KG

    table_np, idx_np, axis = GF.form_inputs(np.random.default_rng(0))["D2"]
    table, idx = torch.from_numpy(table_np).to(cuda), torch.from_numpy(idx_np).to(cuda)
    x = torch.randn(GO.TINY_SHAPE, device=cuda)
    take, tiny = (lambda: GF.take_along_axis(table, idx, axis)), (lambda: GO.tiny(x))
    gtable, gidx = KG.rate_inputs(KG.N_ROWS, KG.WIDTH, device=cuda)
    rng = np.random.default_rng(0)
    GF.form_inputs(rng)
    ctable, cidx = GF.microbench_inputs(rng, cuda)
    result = {"take_along_axis_ms": [_time_ms(take, repeats=100) for _ in range(3)],
              "take_along_axis_graph_ms": [_graph_ms(lambda t, i: GF.take_along_axis(t, i, axis), (table, idx))
                                           for _ in range(3)],
              "tiny_ms": [_time_ms(tiny, repeats=100) for _ in range(3)],
              "tiny_graph_ms": [_graph_ms(GO.tiny, (x,)) for _ in range(3)],
              "gather_sum_ms": [_time_ms(lambda: KG.gather_sum(gtable, gidx), repeats=100) for _ in range(3)],
              "gather_sum_graph_ms": [_graph_ms(lambda t, i: KG.gather_sum(t, i), (gtable, gidx)) for _ in range(3)],
              "cluster_gather_sum_ms": [_time_ms(lambda: GF.cluster_gather_sum(ctable, cidx), repeats=100)
                                        for _ in range(3)],
              "bits": {"gather_sum": _digest(KG.gather_sum(gtable, gidx))}}
    try:
        result["cluster_gather_sum_graph_ms"] = [_graph_ms(lambda t, i: GF.cluster_gather_sum(t, i), (ctable, cidx))
                                                 for _ in range(3)]
    except RuntimeError as error:
        result["cluster_gather_sum_graph_ms"] = None
        result["cluster_gather_sum_graph_error"] = str(error)[:300]
    return result


def compare_with_parent(parent: Path, card: str) -> None:
    """Each tree's steps in its own process (one package per process), parent, this, this, parent."""
    import os

    samples = {"parent": [], "this": []}
    saved = tempfile.TemporaryDirectory()
    for which in ("parent", "this", "this", "parent"):
        root = parent if which == "parent" else REPO
        env = {**os.environ, "CHIP_SMOKE_SAVE": f"{saved.name}/{which}"}
        proc = subprocess.run([sys.executable, str(Path(__file__).resolve()), "--steps-ms", str(root)],
                              capture_output=True, text=True, timeout=900, env=env)
        require(proc.returncode == 0, f"step timing of {root} exited {proc.returncode}: {proc.stderr[-2000:]}")
        result = json.loads(proc.stdout.strip().splitlines()[-1])
        require(Path(result["package"]).resolve() == root.resolve(), f"{root}: imported {result['package']}")
        samples[which].append(result)
        say("parent", tree=which, card=card, **result)
    def mean(key: str, which: str):  # over both runs of a tree; None where a tree could not time it
        runs = [sum(r[key]) / len(r[key]) for r in samples[which] if r.get(key)]
        return sum(runs) / len(runs) if runs else None

    say("parent", card=card, **{key: {w: mean(key, w) for w in samples} for key in (
        "estep_softmax_ms", "estep_ms", "mstep_addition_ms", "m_step_ms", "em_iteration_ms", "take_along_axis_ms",
        "take_along_axis_graph_ms", "tiny_ms", "tiny_graph_ms", "split_22_ms", "split_00_ms", "group_G4_ms",
        "folded_ms", "gather_sum_ms", "gather_sum_graph_ms", "cluster_gather_sum_ms", "cluster_gather_sum_graph_ms",
        "banded_estep_ms", "banded_mstep_ms", "aggregate_32_ms", "aggregate_528_ms", "aggregate_d64_ms",
        "aggregate_many_ms",
        "aggregate_host_us", *(f"stream_{layout}_{step}_ms" for layout in ("cols", "rows")
                               for step in (512, 2048, 8192, 32768)))})
    # bit for bit: each output of this tree against the parent's on the same inputs, every run alike
    bits = {key: "bit-equal" if len({r["bits"].get(key) for r in samples["parent"] + samples["this"]}) == 1
            else "differs" for key in samples["this"][0]["bits"]}
    # the aggregate kernel's outputs, this tree's against the parent's (the runs of each tree are bit-equal)
    drift = {}
    for case in ("32", "528", "d64", "many"):
        ours, theirs = (Path(f"{saved.name}/{which}_{case}.npy") for which in ("this", "parent"))
        if ours.is_file() and theirs.is_file():
            a, b = np.load(ours), np.load(theirs)
            drift[case] = {"logits": float(np.abs(a[0] - b[0]).max()), "probs": float(np.abs(a[1] - b[1]).max()),
                           "argmax_agreement": float((a[1].argmax(1) == b[1].argmax(1)).mean())}
    saved.cleanup()
    say("parent", card=card, aggregate_drift_from_parent=drift)
    # the E-step's and M-step's registers in each tree's library (the parent's built by its first child)
    from demuxalot_tpu_torch.ops import _cuda

    built = sorted((parent / "demuxalot_tpu_torch" / "_build").glob("libdemux_kernels_*.so"))
    require(len(built) == 1, f"{parent}: one kernel library must have been built, found {built}")
    theirs, ours = _library_registers(built[0]), _library_registers(_cuda.build().path)
    mainline = sorted(name for name in theirs if not (name.startswith("mstep_banded") or name.endswith(",1>")
                                                      and name.startswith("estep")))
    say("parent", card=card, bits=bits, registers={name: {"parent": theirs.get(name), "this": ours.get(name)}
                                                   for name in sorted(set(theirs) | set(ours))},
        mainline_registers_equal=all(theirs[name] == ours.get(name) for name in mainline))


def main() -> int:
    import argparse

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--parent", type=Path, help="compare this tree's steps with the ones under this directory")
    parser.add_argument("--steps-ms", type=Path, help=argparse.SUPPRESS)  # a child of --parent
    parser.add_argument("--tracing", action="store_true",
                        help="run phases 1, 2 and 4 and the recorder's cost only")
    parser.add_argument("--trace-dir", type=Path, help="keep phase 4's trace.json in this directory")
    parser.add_argument("--seed", type=int, default=0, help="the seed of phase 5's skewed pools (default 0)")
    parser.add_argument("--pool64", action="store_true", help="run phases 1 and 2 and phase 5's 64-donor pool only")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)", file=sys.stderr)
        return 1
    if args.steps_ms is not None:
        print(json.dumps(steps_ms()), flush=True)
        return 0
    report = phase_device()
    if args.parent is not None:
        phase_build()
        compare_with_parent(args.parent, report["nvidia_smi"])
        return 0
    card = report["nvidia_smi"]
    if args.tracing:
        phase_build()
        genotypes, handler, packed, truth = _bench_data()
        phase_main(genotypes, handler, packed, truth, args.trace_dir)
        phase_tracing_cost(genotypes, handler, packed, card)
        return 0
    if args.pool64:
        phase_build()
        phase_pool64(card, args.seed)
        return 0
    seconds, mark = {}, [time.perf_counter()]

    def lap(name: str) -> None:  # the host seconds of each phase since the last lap
        now = time.perf_counter()
        seconds[name] = now - mark[0]
        mark[0] = now

    phase_build()
    lap("build")
    phase_kernels()
    lap("kernels")
    genotypes, handler, packed, truth = _bench_data()
    main_result = phase_main(genotypes, handler, packed, truth, args.trace_dir)
    lap("main")
    timing = phase_timing(genotypes, handler, packed, main_result, card)
    skewed = phase_skewed_mstep(card, args.seed)
    pool64 = phase_pool64(card, args.seed)
    lap("timing")
    phase_tracing_cost(genotypes, handler, packed, card)
    lap("tracing")
    with tempfile.TemporaryDirectory() as tmp:
        bam_result = phase_bam(card, Path(tmp))
        lap("bam")
        aggregate = phase_aggregate(genotypes, handler, packed, truth, timing["gprob"], card)
        lap("aggregate")
        discovery = phase_discovery(card, bam_result["fixture"], Path(tmp))
        lap("discovery")
        sharded = phase_sharded(genotypes, handler, packed, truth, main_result, timing, card, bam_result, Path(tmp))
        lap("sharded")
    phase_gather_kernels()
    lap("gather_kernels")
    experiments = phase_experiments(card)
    lap("experiments")
    phase_variant_kernels()
    lap("variant_kernels")
    variants = phase_variants(card)
    lap("variants")
    phase_last_kernels()
    lap("last_kernels")
    last = phase_last(card)
    lap("last")
    say("smoke", phase_seconds=seconds, total_s=sum(seconds.values()))
    t = timing["timings"]

    def launches(name: str) -> dict:
        # no package path calls the experiments' kernels; phase 11's probe and microbench also run the gathers
        if name in _experiment_kernels() or name in _variant_kernels() or name in _last_kernels():
            by_path = {"experiments": sum(r["launches"].get(name, 0) for r in (experiments, variants, last))}
            if name in ("gather_rows", "gather_sum"):
                by_path = {"experiments": experiments["launches"][name], "forms": last["launches"][name]}
            return {"launches": sum(by_path.values()), "launches_by_path": by_path}
        # the package paths; the A/Bs' warm-ups and repeats of the mainline kernels stand apart (ab_launches)
        by_path = {"packed_calls": main_result["launches"][name], "bam_flow": bam_result["launches"][name],
                   "aggregate_em": aggregate["launches"][name], "detect_snps": discovery["launches"][name],
                   "sharded": sharded["launches"][name]}
        return {"launches": sum(by_path.values()), "launches_by_path": by_path,
                "ab_launches": sum(r["launches"].get(name, 0) for r in (experiments, variants, last))}

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
         "posterior_max_abs_err": timing["fused_errors"]["posteriors"],
         "ms": fused, "plain_ms": t["estep_softmax"]["plain_ms_mean"], **bound("estep_softmax"),
         "share_of_bound": bound("estep_softmax")["bound_ms"] / fused, "library_ms": None,
         "logits_only_ms": t["estep"]["kernel_ms_mean"], "index_checks_ms": t["checks_ms"]["estep"],
         "softmax_library_ms": t["torch_softmax_ms"], "pool64": pool64["estep_softmax"]},
        {"name": "mstep_addition", "route": "cuda", "source": "demuxalot_tpu_torch/csrc/mstep.cu",
         "replaces": "demuxalot_tpu/ops/pallas_mstep.py:56", **launches("mstep_addition"),
         "max_abs_err": timing["mstep_err"],
         "ms": t["mstep"]["kernel_ms_mean"], "plain_ms": t["mstep"]["plain_ms_mean"], **bound("mstep"),
         "share_of_bound": bound("mstep")["bound_ms"] / t["mstep"]["kernel_ms_mean"], "library_ms": None,
         "index_checks_ms": t["checks_ms"]["mstep"],
         "skewed_pool": skewed["mstep"]},
        # the same kernel source with the next iteration's probs_from_betas in its epilogue; the old chain
        # (addition kernel, then probs_from_betas) beside it
        {"name": "mstep_update", "route": "cuda", "source": "demuxalot_tpu_torch/csrc/mstep.cu",
         "replaces": "demuxalot_tpu/ops/pallas_mstep.py:56", **launches("mstep_update"),
         "max_abs_err": max(e[key] for e in timing["update_err"].values() for key in e),
         "ms": t["mstep_update"]["kernel_ms_mean"], "plain_ms": t["mstep_update"]["plain_ms_mean"],
         **bound("mstep_update"),
         "share_of_bound": bound("mstep_update")["bound_ms"] / t["mstep_update"]["kernel_ms_mean"],
         "library_ms": None, "old_chain_ms": t["old_chain"]["kernel_ms_mean"],
         "skewed_pool": {**skewed["mstep_update"], "em_iteration_ms": skewed["em_iteration_ms"],
                         "split_calls": skewed["split_calls"], "split_units": skewed["split_units"],
                         "max_abs_err": skewed["max_abs_err"]},
         "pool64": {**pool64["mstep_update"], "split_calls": pool64["split_calls"],
                    "split_units": pool64["split_units"]}},
    ]
    # the aggregate E-step: an XLA op of the JAX package, its hand kernel on the aggregate EM and predict; ms at
    # the predict's 528 columns (fused softmax), the learn run's 32 and 64 donors beside it
    case_keys = ("n_pg", "n_groups", "n_barcodes", "ms", "plain_ms", "logits_only_ms", "bound_ms", "bound_by",
                 "share_of_bound", "errors", "float64_errors", "kernel_peak_bytes", "plain_peak_bytes", "output_bytes")
    a = aggregate["widths"][max(aggregate["widths"])]
    kernels.append({
        "name": "aggregated_logits", "route": "cuda", "source": "demuxalot_tpu_torch/csrc/aggregate.cu",
        "replaces": "demuxalot_tpu/ops/likelihood.py:258", **launches("aggregated_logits"),
        "max_abs_err": a["errors"]["logits"], "posterior_max_abs_err": a["errors"]["posteriors"], "ms": a["ms"],
        "plain_ms": a["plain_ms"], "bound_ms": a["bound_ms"], "bound_by": a["bound_by"],
        "share_of_bound": a["share_of_bound"], "library_ms": None,
        "library_ms_reason": "no single PyTorch call computes it",
        "by_columns": {str(n): {k: case[k] for k in case_keys} for n, case in aggregate["widths"].items()},
        "d64": {k: aggregate["d64"][k] for k in case_keys},
        "many_molecules": {k: aggregate["many"][k] for k in case_keys}, "by_instantiation": aggregate["sweep"],
        "pool64": {**pool64["aggregated_logits"], "n_groups": pool64["n_groups"], "plan": pool64["aggregate_plan"]},
        "host_us": aggregate["host_us"], "predict_peak_bytes": aggregate["predict_peak"], "plain_predict_peak_bytes": aggregate["plain_predict_peak"],
        "em_iteration_ms": aggregate["em_ms"], "plain_em_iteration_ms": aggregate["plain_em_ms"],
        "predict_s": aggregate["predict_s"], "plain_predict_s": aggregate["plain_predict_s"]})
    # the experiments' kernels: the banded ones at the JAX harness's shape (phase 9b, G past L2 beside
    # it), the gathers on the TPU bench's [8192, 64] table (the other tables beside it)
    ab, ab_past, e = experiments["ab"], experiments["ab_past"], experiments
    for name, step, mainline, replaces, source in (
        ("estep_logits_banded", "estep_banded", "estep_logits", "benchmarks/inkernel_gather_kernels.py:78",
         "demuxalot_tpu_torch/csrc/likelihood.cu"),
        ("mstep_addition_banded", "mstep_banded", "mstep", "benchmarks/inkernel_gather_kernels.py:252",
         "demuxalot_tpu_torch/csrc/banded.cu"),
    ):
        ms, roofline = ab["ms"][step]["mean"], e["bounds"][name]
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces, **launches(name),
            "max_abs_err": e["estep_err" if step == "estep_banded" else "mstep_err"], "ms": ms,
            "plain_ms": e["plain_ms"][name], "bound_ms": roofline.speed_of_light_s() * 1e3,
            "bound_by": roofline.bound_by(), "share_of_bound": roofline.speed_of_light_s() * 1e3 / ms,
            "library_ms": None, "library_ms_reason": "no single PyTorch call computes it",
            "layout_bytes": e["layout_bytes"][name], "mainline_ms": ab["ms"][mainline]["mean"],
            "past_l2_ms": ab_past["ms"][step]["mean"], "past_l2_mainline_ms": ab_past["ms"][mainline]["mean"],
            "n_bands": ab["estep_bands" if step == "estep_banded" else "mstep_bands"],
            **({"slots": ab["estep_slots"]} if step == "estep_banded" else {})})
    tpu_table, *other_tables = e["gathers"]
    # the gather-sum's graph-replay time, path and plan beside its eager time, at every table
    sum_keys = ("path", "graph_ms", "library_graph_ms", "graph_share_of_bound", "graph_ns_per_row", "graph_input_mb",
                "index_passes", "index_pass_bytes", "slices", "blocks_per_slice", "shared_bytes_per_block")
    for name, replaces in (("gather_rows", "benchmarks/exp_kernel_gather.py:39"),
                           ("gather_sum", "benchmarks/exp_kernel_gather.py:63")):
        g = tpu_table[name]
        extra = (lambda x: {k: x[k] for k in sum_keys}) if name == "gather_sum" else (lambda x: {})  # noqa: E731
        kernels.append({
            "name": name, "route": "cuda", "source": "demuxalot_tpu_torch/csrc/gather.cu", "replaces": replaces,
            **launches(name), "max_abs_err": 0.0 if name == "gather_rows" else tpu_table["sum_abs_err"],
            "ms": g["ms_mean"], "plain_ms": g["plain_ms"], "bound_ms": g["bound_ms"], "bound_by": g["bound_by"],
            "share_of_bound": g["share_of_bound"], "library_ms": g["library_ms"], "ns_per_row": g["ns_per_row"],
            "table": tpu_table["table"], **extra(g),
            "by_table": [{"table": o["table"], "ms": o[name]["ms_mean"], "ns_per_row": o[name]["ns_per_row"],
                          "library_ms": o[name]["library_ms"], "bound_ms": o[name]["bound_ms"],
                          "share_of_bound": o[name]["share_of_bound"], **extra(o[name])} for o in other_tables]})
    kernels += _variant_entries(variants, launches)
    kernels += _last_entries(last, launches)
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
