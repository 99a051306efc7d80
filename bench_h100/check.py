"""The comparison that decides ``correct``: what the timed path produced against the plain reference.

The window drives the program's EM loop, thousands of iterations from one
start. The reference follows the first three itself, from the raw draws
(the start: the join and collapse, the prior, the normalisation, the
E-step and its softmax, two M-steps), and checks the window's last
iteration step by step from the program's own state there: the E-step of
the addition the program entered it with, and the M-step of the posteriors
it gave. Eight numbers; a cell holds those its limits file names, each to
its limit there:

- ``*_logits_gap``: the largest |Δ| of a logit over max(1, |reference|);
- ``*_posterior_gap``: the largest |Δ| of a posterior from the reference's
  own (the float64 softmax of the reference's logits): what users read;
- ``*_softmax_gap``: the largest |Δ| between a posterior and the float64
  softmax of the program's own logits row: the fused softmax stage, read
  apart from the logits so that a barcode whose top two columns all but
  tie does not swing it, where the posteriors saturate;
- ``*_addition_gap``: the largest |Δ| of the M-step's addition over the
  reference's largest entry.

A candidate with a non-finite value or the wrong shape reads infinity.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

import numpy as np
import torch

NUMBERS = ("start_logits_gap", "start_posterior_gap", "start_softmax_gap", "start_addition_gap",
           "end_logits_gap", "end_posterior_gap", "end_softmax_gap", "end_addition_gap")
START_ITERATIONS = 3


@dataclass
class Iteration:
    """One EM iteration as a candidate gave it, on the host: the addition it entered with, its logits and posteriors."""

    addition: np.ndarray  # [V, D], registry variant order
    logits: np.ndarray  # [B, PG]
    probs: np.ndarray  # [B, PG]


@dataclass
class Trajectory:
    """What the comparison reads: the first iterations, the window's last, and the addition its M-step gave."""

    start: List[Iteration]
    end: Iteration
    next_addition: np.ndarray  # [V, D]


def _gap(got, want: torch.Tensor, scale) -> float:
    got = torch.as_tensor(np.asarray(got), device=want.device).to(torch.float64)
    if got.shape != want.shape:
        return float("inf")
    want = want.to(torch.float64)
    diff = torch.nan_to_num((got - want).abs(), nan=float("inf"))
    return float((diff / scale(want)).max()) if diff.numel() else 0.0


def softmax_gap(got_probs, got_logits, device) -> float:
    logits = torch.as_tensor(np.asarray(got_logits), device=device).to(torch.float64)
    return _gap(got_probs, torch.softmax(torch.nan_to_num(logits), dim=1), lambda w: 1.0)


def posterior_gap(got, want: torch.Tensor) -> float:
    return _gap(got, want, lambda w: 1.0)


def logits_gap(got, want: torch.Tensor) -> float:
    return _gap(got, want, lambda w: w.abs().clamp(min=1.0))


def addition_gap(got, want: torch.Tensor) -> float:
    return _gap(got, want, lambda w: w.abs().max().clamp(min=1e-30))


def gaps(reference, trajectory: Trajectory) -> dict:
    """The eight numbers of one trajectory against the reference (float64)."""
    out = dict.fromkeys(NUMBERS, 0.0)

    def keep(name: str, value: float) -> None:
        out[name] = max(out[name], value)

    addition = torch.zeros((reference.n_variants, reference.n_donors), dtype=torch.float64, device=reference.device)
    for i, got in enumerate(trajectory.start):
        if i > 0:
            addition = reference.mstep(probs)
            keep("start_addition_gap", addition_gap(got.addition, addition))
        logits, probs = reference.estep(reference.normalise(addition))
        keep("start_logits_gap", logits_gap(got.logits, logits))
        keep("start_posterior_gap", posterior_gap(got.probs, probs))
        keep("start_softmax_gap", softmax_gap(got.probs, got.logits, reference.device))
        del logits

    end = trajectory.end
    entered = torch.as_tensor(np.asarray(end.addition), device=reference.device).to(torch.float64)
    logits, probs = reference.estep(reference.normalise(torch.nan_to_num(entered)))
    out["end_logits_gap"] = logits_gap(end.logits, logits)
    out["end_posterior_gap"] = posterior_gap(end.probs, probs)
    out["end_softmax_gap"] = softmax_gap(end.probs, end.logits, reference.device)
    del logits, probs
    got_probs = torch.nan_to_num(torch.as_tensor(np.asarray(end.probs), device=reference.device).to(torch.float64))
    out["end_addition_gap"] = addition_gap(trajectory.next_addition, reference.mstep(got_probs))
    return out


def judge(numbers: dict, limits: Optional[dict]) -> tuple:
    """({name: {"value", "limit"}}, the names over their limit): the numbers ``limits`` names, or with no limits
    every number, each without a limit failing."""
    names = [name for name in NUMBERS if limits is None or name in limits]
    names += sorted(set(limits or ()) - set(NUMBERS))  # a limit on no number the comparison reads: fails
    limits = limits or {}
    checks = {name: {"value": numbers.get(name, float("inf")), "limit": limits.get(name)} for name in names}
    failed = [name for name, c in checks.items() if c["limit"] is None or not c["value"] <= c["limit"]]
    return checks, failed
