"""A gather beside the E-step and beside a tiny kernel: the tiny kernel, the E-step workload and the stages.

The counterpart of ``benchmarks/exp_gather_operand.py``, which asked why the
M-step's posterior gather cost about 2x its standalone time inside the EM
chain on the TPU, by timing the same gather ``g`` (``:30-31``: ``Σ
post[:, :32].T[:, cb]`` × 1e-30, 32 × 10,652,672 gathered elements) in
three programs:

- phase 1 (``:82-93``): how the gathered table is produced (parameter,
  fresh, sliced, softmaxed);
- phase 2 (``:96-105``): the E-step (``build_estep``, ``:49-79``) in the
  same program, with and without the gather depending on it;
- phase 3 (``:108-129``): order, a tiny kernel beside the gather, two
  gathers. The tiny kernel is the TPU file's only Pallas kernel
  (``tiny_kernel``, ``:108``, ``o = x · 2`` on f32 [8, 128]).

Here :func:`tiny` is a hand-written CUDA kernel (``csrc/tiny.cu``) with its
plain version beside it (CPU tensors take the plain version; ``.launches``
counts launches); :func:`g` stays torch indexing, as it was an XLA gather
outside any kernel; :func:`pmbc_estep` is ``build_estep``'s counterpart on
the port's mainline E-step (``ops.likelihood_kernel``), and
:func:`run_stages` times each stage over ``K`` = 6 chained repeats with
``kernel_gather.time_ms`` (CUDA events; the host clock on the CPU). ``python -m
demuxalot_tpu_torch.experiments.gather_operand [--device cpu] [--phase
1|2|3]`` prints one phase's times as JSON; the JAX file reads ``PHASE``.
"""
from __future__ import annotations

import json

import numpy as np
import torch

from ..ops import _cuda
from .kernel_gather import time_ms

# the TPU harness's shape (exp_gather_operand.py:19-21, 57)
N_B, N_SLOTS = 131_072, 10_652_672
N_D, PG, K = 32, 528, 6
N_S, CPB = 327_680, 72
DOUBLET_PRIOR = 0.35
TINY_SHAPE = (8, 128)
PHASES = (1, 2, 3)


def tiny_plain(x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the kernel, on any device."""
    return x * 2.0


def tiny(x: torch.Tensor) -> torch.Tensor:
    """``x · 2`` for a contiguous f32 tensor of any shape; the CUDA kernel for CUDA tensors."""
    if not (isinstance(x, torch.Tensor) and x.is_cuda and x.dtype is torch.float32 and x.is_contiguous()):
        if not isinstance(x, torch.Tensor) or x.dtype != torch.float32 or not x.is_contiguous():
            raise ValueError("tiny takes a contiguous float32 tensor")
        if x.device.type != "cpu":
            raise ValueError(f"tiny runs on cpu or cuda tensors, not {x.device}")
        return tiny_plain(x)
    out = torch.empty_like(x)
    _tiny(x, x.data_ptr(), x.numel(), out.data_ptr())
    tiny.launches += 1
    return out


tiny.launches = 0
_tiny = _cuda.Entry("demux_tiny")


def operand_inputs(n_b: int = N_B, n_slots: int = N_SLOTS, device="cuda", seed: int = 0) -> tuple:
    """(post f32 [n_b, PG], cb i32 [n_slots]) drawn as the JAX file draws them (:26-28), on ``device``."""
    rng = np.random.default_rng(seed)
    post = rng.random((n_b, PG), np.float32)
    cb = rng.integers(0, n_b, n_slots).astype(np.int32)
    return torch.from_numpy(post).to(device), torch.from_numpy(cb).to(device)


def g(table_t: torch.Tensor, cb: torch.Tensor) -> torch.Tensor:
    """``Σ table_t[:, cb]`` × 1e-30 (exp_gather_operand.py:30-31): PyTorch's gather, where the TPU had XLA's."""
    return torch.sum(torch.index_select(table_t, 1, cb)) * 1e-30


def pmbc_estep(device="cuda", n_b: int = N_B, n_d: int = N_D, n_s: int = N_S, cpb: int = CPB, seed: int = 0):
    """``build_estep``'s counterpart (:49-79): ``estep(t)`` → the mainline E-step's logits f32 [n_b, PG].

    ``sim.synthesize_device_workload(n_b, n_d, n_s, cpb, seed)`` through the
    port's ``estep_operands`` at doublet prior 0.35, and G drawn from
    ``np.random.default_rng(1)`` in the betas' shape; ``estep(t)`` scales G by
    ``1 + t·1e-30`` (a 0-dim tensor ``t``), as the JAX closure does, and runs
    ``estep_logits`` (the CUDA kernel for CUDA tensors).
    """
    from .. import sim
    from ..ops.likelihood_kernel import estep_logits, estep_operands
    from ..ops.packing import csr_row_pointers

    device = torch.device(device)
    betas, _v2s, vid, cb, q, _truth = sim.synthesize_device_workload(n_b, n_d, n_s, cpb, seed=seed)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)  # noqa: E731
    operands = estep_operands(n_d, DOUBLET_PRIOR, t(csr_row_pointers(cb, n_b)), t(cb), t(vid), t(q), betas.shape[0])
    gp = t(np.random.default_rng(1).random(betas.shape, np.float32))

    def estep(s: torch.Tensor) -> torch.Tensor:
        return estep_logits(gp * (1.0 + s * 1e-30), operands)

    estep.genotype_prob, estep.operands = gp, operands
    return estep


def stages(phase: int, cb: torch.Tensor, estep=None) -> dict:
    """{name: step(c, a)} of one JAX phase (:82-129), each step a 0-dim tensor from the carry ``c`` and post ``a``.

    Phases 2 and 3 need ``estep`` (from :func:`pmbc_estep`).
    """
    gather = lambda table_t: g(table_t, cb)  # noqa: E731
    if phase == 1:
        return {
            "param+scalar": lambda c, a: gather((a + c)[:, :N_D].T) + c,
            "fresh barrier": lambda c, a: gather((a * (1.0 + c * 1e-30))[:, :N_D].T) + c,
            "fresh sliced": lambda c, a: gather((a[:, :N_D] * (1.0 + c * 1e-30)).T) + c,
            "fresh softmax": lambda c, a: gather(torch.softmax(a + c * 1e-30, dim=-1)[:, :N_D].T) + c,
        }
    if estep is None:
        raise ValueError(f"phase {phase} needs the E-step")
    if phase == 2:
        return {
            "estep only": lambda c, a: torch.sum(estep(c)) * 1e-30 + c,
            "estep+gather(indep post)": lambda c, a: torch.sum(estep(c)) * 1e-30
            + gather((a + c * 1e-30)[:, :N_D].T) + c,
            "estep+gather(softmax)": lambda c, a: gather(torch.softmax(estep(c), dim=-1)[:, :N_D].T) + c,
        }
    if phase != 3:
        raise ValueError(f"phase is 1, 2 or 3, not {phase}")
    tiny_in = torch.ones(TINY_SHAPE, dtype=torch.float32, device=cb.device)
    tiny_of = lambda s: tiny(tiny_in * (1.0 + s * 1e-30))  # noqa: E731
    estep_sum = lambda s: torch.sum(estep(s)) * 1e-30  # noqa: E731
    gaz = lambda c, a: gather((a + c * 1e-30)[:, :N_D].T)  # noqa: E731 - one gather, scalar-dependent operand
    return {
        "gather alone": lambda c, a: gaz(c, a) + c,
        "gather THEN estep": lambda c, a: estep_sum(gaz(c, a) * 1e30 + c) + c,
        "tiny pallas + gather": lambda c, a: torch.sum(tiny_of(c)) * 1e-30 + gaz(c, a) + c,
        "estep + 2 gathers": lambda c, a: estep_sum(c) + gaz(c, a) + gaz(c + 1e-12, a) + c,
    }


def chain(step, post: torch.Tensor, k: int = K) -> torch.Tensor:
    """``k`` repeats of ``step``, each taking the last one's carry (the JAX file's fori_loop), from 0."""
    c = torch.zeros((), dtype=torch.float32, device=post.device)
    for _ in range(k):
        c = step(c, post)
    return c


def run_stages(named_steps: dict, post: torch.Tensor, k: int = K, repeats: int = 3) -> dict:
    """{name: {ms, value}}: ms per step, the best of ``repeats`` timed chains over ``k``.

    Each chain is timed by ``kernel_gather.time_ms`` (CUDA events on a
    card, the host clock on the CPU); ``value`` is the chain's final carry,
    which must be finite.
    """
    results = {}
    for name, step in named_steps.items():
        value = float(chain(step, post, k))
        if not np.isfinite(value):
            raise RuntimeError(f"stage {name!r}: carry {value}")
        best = min(time_ms(lambda: chain(step, post, k), post.device, 1) for _ in range(repeats))
        results[name] = {"ms": best / k, "value": value}
    return results


def main(argv=None) -> int:
    import argparse

    parser = argparse.ArgumentParser(description="A gather beside the E-step and a tiny kernel (gather_operand)")
    parser.add_argument("--device", default="cuda", help="cuda (default; raises without a card) or cpu")
    parser.add_argument("--phase", type=int, choices=PHASES, default=1, help="the JAX file's PHASE")
    parser.add_argument("--n-b", type=int, default=N_B, help="barcodes (post's rows and the E-step's)")
    parser.add_argument("--n-slots", type=int, default=N_SLOTS, help="gathered columns")
    parser.add_argument("--n-snps", type=int, default=N_S)
    parser.add_argument("--calls-per-barcode", type=int, default=CPB)
    parser.add_argument("--repeats", type=int, default=3)
    args = parser.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass --device cpu for the plain versions")
    post, cb = operand_inputs(args.n_b, args.n_slots, device)
    estep = None if args.phase == 1 else pmbc_estep(device, args.n_b, N_D, args.n_snps, args.calls_per_barcode)
    result = run_stages(stages(args.phase, cb, estep), post, K, args.repeats)
    print(json.dumps({"phase": args.phase, "device": str(device), "n_b": args.n_b, "n_slots": args.n_slots,
                      "stages": result}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
