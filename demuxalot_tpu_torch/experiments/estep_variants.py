"""The E-step variants beside the mainline E-step: the JAX harnesses' workload and the A/B.

``benchmarks/exp_estep.py``, ``exp_group.py`` and ``exp_split.py`` each time
their variant against the production E-step on one workload
(``exp_estep.py:201-218``, ``exp_group.py:249-268``, ``exp_split.py:156-164``):
``synthesize_device_workload(65536, 32, 65536, 64, seed=3)`` (65,536
barcodes × 64 calls = 4,194,304 calls, 131,072 variants, 32 donors), doublet
prior 0.25 (528 columns) and G = ``probs_from_betas(betas, ..., 0.01)``.
:func:`variants_workload` builds it through the port's own ``sim``, and
:func:`run_ab` times, in turns with ``kernel_gather.time_ms``:

- the mainline E-step (``csrc/likelihood.cu``), fused and logits-only;
- ``fold_calls`` alone, ``folded_logits`` alone, and the two together;
- ``split_logits`` at the harness's (exp_words, sc_words) pairs;
- ``group_logits`` at G 4 and 8 (the TPU's TC 512 and 1024) with 2 words.

Each variant is held to the mainline's logits at ``LOGITS_TOL`` with the
same argmax, except split with a one-word scatter, (2,1) and (1,1): one bf16
word shifts the logits by about 3e-2, so those are reported against the
mainline and held to their plain version. Each variant's max |Δposterior|
against the mainline's fused posteriors is reported; folded, split (2,2) and
split (3,2) must meet POSTERIOR_ATOL. ``python -m
demuxalot_tpu_torch.experiments.estep_variants [--device cpu] [--only
folded|split|group]`` prints the result as JSON.
"""
from __future__ import annotations

import json
from typing import NamedTuple

import numpy as np
import torch

from ..ops import likelihood as L
from ..ops.likelihood_kernel import EStepOperands, estep_logits, estep_operands
from ..ops.packing import csr_row_pointers
from .folded_estep import VariantOperands, fold_calls, folded_logits, variant_operands
from .group_estep import HARNESS_GROUPS, GroupCalls, group_layout, group_logits
from .inkernel_gather import LOGITS_TOL
from .kernel_gather import time_ms
from .split_estep import HARNESS_PAIRS, split_logits, split_logits_plain

HARNESS = dict(n_barcodes=65_536, n_donors=32, n_snps=65_536, calls_per_barcode=64)
SEED = 3
DOUBLET_PRIOR = 0.25
GROUP_WORDS = 2
ONE_WORD_SCATTER = ((2, 1), (1, 1))  # held to their plain version, not to the mainline
# the posterior bar the TPU kernel met against full f32 (ROADMAP "Numerics that carry over")
POSTERIOR_ATOL = 3e-5
HELD_TO_POSTERIOR_BAR = ("folded", "split_22", "split_32")
KINDS = ("folded", "split", "group")


class Workload(NamedTuple):
    """The harnesses' inputs in the mainline's layout and in the group layouts."""

    genotype_prob: torch.Tensor  # f32 [V, D]
    estep: EStepOperands
    operands: VariantOperands
    groups: dict  # {G: GroupCalls}


def variants_workload(device="cuda", seed: int = SEED, doublet_prior: float = DOUBLET_PRIOR,
                      n_barcodes: int = HARNESS["n_barcodes"], n_donors: int = HARNESS["n_donors"],
                      n_snps: int = HARNESS["n_snps"], calls_per_barcode: int = HARNESS["calls_per_barcode"],
                      groups=HARNESS_GROUPS) -> Workload:
    """``sim.synthesize_device_workload`` on ``device`` with G from the synthetic betas, in both layouts."""
    from .. import sim

    device = torch.device(device)
    betas, variant2snp, vid, cb, q, _truth = sim.synthesize_device_workload(
        n_barcodes, n_donors, n_snps, calls_per_barcode, seed=seed)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)  # noqa: E731
    estep = estep_operands(n_donors, doublet_prior, t(csr_row_pointers(cb, n_barcodes)), t(cb), t(vid), t(q))
    gprob = L.probs_from_betas(t(betas), t(variant2snp), n_snps, 0.01)
    return Workload(gprob, estep, variant_operands(estep), {g: group_layout(estep, g) for g in groups})


def _variants(w: Workload, u: torch.Tensor, group_u: dict, kinds) -> dict:
    """{name: (run, plain run or None)} of the variants of ``kinds``; plain runs only for one-word scatters."""
    runs = {}
    if "folded" in kinds:
        runs["folded"] = (lambda: folded_logits(u, w.operands), None)
    if "split" in kinds:
        for e, s in HARNESS_PAIRS:
            runs[f"split_{e}{s}"] = (
                lambda e=e, s=s: split_logits(u, w.operands, e, s),
                (lambda e=e, s=s: split_logits_plain(u, w.operands, e, s)) if (e, s) in ONE_WORD_SCATTER else None)
    if "group" in kinds:
        for g, calls in w.groups.items():
            runs[f"group_G{g}"] = (lambda g=g, calls=calls: group_logits(group_u[g], calls, GROUP_WORDS), None)
    return runs


def run_ab(workload: Workload, repeats: int = 10, kinds=KINDS) -> dict:
    """The variants of ``kinds`` beside the mainline E-step on ``workload``: bars, errors and times in turns.

    Raises if a variant misses its bar. Times are CUDA events on a card and
    the host clock on the CPU.
    """
    w = workload
    device = w.genotype_prob.device
    mainline, mainline_probs = estep_logits(w.genotype_prob, w.estep, softmax=True)
    u = fold_calls(w.genotype_prob, w.estep)
    group_u = {g: fold_calls(w.genotype_prob, calls) for g, calls in w.groups.items()}
    variants = _variants(w, u, group_u, kinds)
    checks = {}
    for name, (run, plain) in variants.items():
        logits = run()
        entry = {"logits_max_abs_err": float((logits - mainline).abs().max()),
                 "posterior_max_abs_err": float((torch.softmax(logits, -1) - mainline_probs).abs().max()),
                 "held_to": "mainline" if plain is None else "plain"}
        want = mainline if plain is None else plain()
        torch.testing.assert_close(logits, want, **LOGITS_TOL, msg=lambda m, name=name: f"{name}: {m}")
        if not torch.equal(logits.argmax(1), want.argmax(1)):
            raise RuntimeError(f"{name}: argmax differs from the {entry['held_to']}'s")
        if plain is not None:
            entry["plain_max_abs_err"] = float((logits - want).abs().max())
        if name in HELD_TO_POSTERIOR_BAR and entry["posterior_max_abs_err"] > POSTERIOR_ATOL:
            raise RuntimeError(f"{name}: posteriors {entry['posterior_max_abs_err']} from the mainline's, "
                               f"past {POSTERIOR_ATOL}")
        checks[name] = entry
    timed = {"estep_fused": lambda: estep_logits(w.genotype_prob, w.estep, softmax=True),
             "estep_logits": lambda: estep_logits(w.genotype_prob, w.estep)}
    if "folded" in kinds:
        timed["fold_calls"] = lambda: fold_calls(w.genotype_prob, w.estep)
        timed["fold_and_folded"] = lambda: folded_logits(fold_calls(w.genotype_prob, w.estep), w.operands)
    timed.update({name: run for name, (run, _plain) in variants.items()})
    samples = {name: [] for name in timed}
    for name in list(timed) + list(timed)[::-1]:
        samples[name].append(time_ms(timed[name], device, repeats))
    n_pg = int(w.estep.penalties.shape[0])
    return {
        "device": str(device), "n_barcodes": w.estep.n_barcodes, "n_variants": int(w.genotype_prob.shape[0]),
        "n_donors": int(w.genotype_prob.shape[1]), "n_calls": int(w.estep.q.shape[0]), "n_pg": n_pg,
        "u_bytes": u.numel() * 4, "log_count": u.shape[0] * n_pg,
        "groups": {g: {"n_calls": calls.n_calls, "u_bytes": group_u[g].numel() * 4,
                       "log_count": calls.n_calls * n_pg} for g, calls in w.groups.items()},
        "checks": checks,
        "ms": {name: {"samples": ms, "mean": sum(ms) / len(ms)} for name, ms in samples.items()},
    }


def main(argv=None) -> int:
    import argparse

    parser = argparse.ArgumentParser(description="The E-step variants beside the mainline E-step (estep_variants)")
    parser.add_argument("--device", default="cuda", help="cuda (default; raises without a card) or cpu")
    for name, value in HARNESS.items():
        parser.add_argument(f"--{name.replace('_', '-')}", type=int, default=value)
    parser.add_argument("--doublet-prior", type=float, default=DOUBLET_PRIOR)
    parser.add_argument("--seed", type=int, default=SEED)
    parser.add_argument("--repeats", type=int, default=10)
    parser.add_argument("--only", choices=KINDS, help="one kernel's variants (default: all three)")
    args = parser.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass --device cpu for the plain versions")
    workload = variants_workload(device, args.seed, args.doublet_prior, args.n_barcodes, args.n_donors,
                                 args.n_snps, args.calls_per_barcode)
    kinds = KINDS if args.only is None else (args.only,)
    print(json.dumps(run_ab(workload, args.repeats, kinds)), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
