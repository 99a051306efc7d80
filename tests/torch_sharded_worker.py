"""One process of a multi-process run of the port's sharded engine (no jax).

Launched through :func:`run_processes` by tests/test_torch_multiprocess.py
(CPU shards, ``gloo``) and by chip_smoke.py phase 8 (shards on a card,
``gloo`` or ``nccl``). Every process synthesizes the same calls from the
seed, joins the process group through ``init_distributed``, shards over
its own ``--shards`` copies of ``--device`` and runs :func:`run`; rank 0
writes the results. :func:`run` is also the in-process reference the
callers compare with.

Usage: python torch_sharded_worker.py --rank R --world N --port P --out result.npz
           [--backend gloo] [--device cpu] [--shards 2] [problem flags]
"""
import argparse
import datetime
import socket
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from demuxalot_tpu_torch import BarcodeHandler, Demultiplexer, sim  # noqa: E402
from demuxalot_tpu_torch.ops.likelihood_kernel import estep_logits  # noqa: E402
from demuxalot_tpu_torch.ops.mstep_kernel import mstep_addition  # noqa: E402
from demuxalot_tpu_torch.parallel import ShardedDemultiplexer  # noqa: E402

PROBLEM = dict(n_barcodes=256, n_donors=6, n_snps=300, calls_per_barcode=16, n_iterations=3,
               doublet_prior=0.35, seed=4)


def problem(n_barcodes, n_donors, n_snps, calls_per_barcode, seed, **_):
    """(packed calls, genotypes, barcode handler, truth) made from the seed."""
    genotypes, calls, truth, _names = sim.synthesize_compressed_calls(
        n_barcodes, n_donors, n_snps, calls_per_barcode, doublets_fraction=0.2, seed=seed)
    handler = BarcodeHandler([f"BC{b:06d}" for b in range(n_barcodes)])
    return Demultiplexer.pack_dataset(calls, genotypes), genotypes, handler, truth


def run(mesh, n_iterations, doublet_prior, **sizes) -> dict:
    """The sharded engine's results on :func:`problem` over ``mesh``, as numpy arrays.

    ``logits0``/``addition1``: the first E-step's logits and the all-reduced
    addition of the first M-step (``staged_genotype_learning``, two
    iterations); ``em_probs``/``betas``: ``learn_genotypes``;
    ``logits``/``top_index``: the predict and the compact predict on the
    learnt genotypes; ``launches``: the kernels' launches in this process.
    """
    packed, genotypes, handler, _truth = problem(**sizes)
    engine = ShardedDemultiplexer(mesh)
    launches = estep_logits.launches, mstep_addition.launches
    (_, first), (_, second) = engine.staged_genotype_learning(
        packed, genotypes, handler, n_iterations=2, doublet_prior=doublet_prior)
    learnt, em_probs = engine.learn_genotypes(packed, genotypes, handler, n_iterations=n_iterations,
                                              doublet_prior=doublet_prior)
    logits, _probs = engine.predict_posteriors(packed, learnt, handler, doublet_prior=doublet_prior)
    compact = engine.predict_posteriors_compact(packed, learnt, handler, doublet_prior=doublet_prior)
    return dict(
        logits0=first["barcode_logits"], addition1=second["genotype_addition"], em_probs=em_probs.values,
        betas=np.asarray(learnt.get_betas()), logits=logits.values, top_index=compact.top_index,
        launches=np.array([estep_logits.launches - launches[0], mstep_addition.launches - launches[1]]),
    )


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def run_processes(commands: list, timeout: float) -> list:
    """Run the commands together; their outputs.

    Raises, with the output of the process at fault, as soon as one exits
    non-zero or when ``timeout`` seconds pass, after killing the others:
    a peer that died leaves the rest waiting in a collective.
    """
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT) for cmd in commands]
    deadline = time.monotonic() + timeout
    try:
        while any(p.poll() is None for p in procs):
            if any(p.poll() not in (None, 0) for p in procs) or time.monotonic() > deadline:
                break
            time.sleep(0.1)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        outputs = [p.communicate(timeout=60)[0].decode(errors="replace") for p in procs]
    for rank, (p, out) in enumerate(zip(procs, outputs)):
        if p.returncode != 0:
            raise RuntimeError(f"process {rank} exited {p.returncode} (killed after a peer failed or "
                               f"{timeout} s passed):\n{out[-3000:]}")
    return outputs


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--rank", type=int, required=True)
    parser.add_argument("--world", type=int, required=True)
    parser.add_argument("--port", type=int, required=True)
    parser.add_argument("--out", required=True)
    parser.add_argument("--backend", default="gloo")
    parser.add_argument("--device", default="cpu")
    parser.add_argument("--shards", type=int, default=2)
    parser.add_argument("--timeout", type=float, default=120.0, help="seconds a collective may wait")
    for name, value in PROBLEM.items():
        parser.add_argument("--" + name.replace("_", "-"), type=type(value), default=value)
    args = parser.parse_args()

    import torch.distributed as dist

    from demuxalot_tpu_torch.parallel import init_distributed, make_mesh

    init_distributed(backend=args.backend, init_method=f"tcp://localhost:{args.port}", world_size=args.world,
                     rank=args.rank, timeout=datetime.timedelta(seconds=args.timeout))
    try:
        mesh = make_mesh([torch.device(args.device)] * args.shards)
        assert mesh.n_shards == args.world * args.shards, mesh
        result = run(mesh, **{name: getattr(args, name) for name in PROBLEM})
    finally:
        dist.destroy_process_group()
    if args.rank == 0:
        np.savez(args.out, **result)
    print(f"rank {args.rank} of {args.world} done", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
