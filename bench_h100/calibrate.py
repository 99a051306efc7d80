"""Read the comparison's numbers of sound runs and of the control, to set a cell's limits.

    python3 bench_h100/calibrate.py --workload pbmc32_65k.em_percall --seeds 1 2 3 --control-seeds 4 5 6

On the card, in one process. For each of ``--seeds`` a run of the cell
(set-up, a window of ``--seconds``, the comparison) gives every number of
``check.NUMBERS``, not only those the cell holds, of a sound run of the
program: their largest over a dozen seeds or more is a limit's lower
reading. For each of ``--control-seeds`` the control takes
the program's place: the plain reference computed in bfloat16, the
precision below the configuration's float32, run through the same start
and ``CONTROL_ITERATIONS`` more iterations, then judged by the float64
reference as the program is; the smallest of its readings is the upper
one. One JSON line a run. The benchmark's own runs never run this.
"""
import argparse
import dataclasses
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

CONTROL_ITERATIONS = 5  # the control's short window: enough to leave the start, as the program's window does


def control_trajectory(reference, iterations: int):
    """The reference's own EM in its dtype: the start, ``iterations`` more, and the next addition."""
    import torch

    from bench_h100.check import START_ITERATIONS, Iteration, Trajectory

    def host(t: torch.Tensor):
        return t.float().cpu().numpy()

    addition = torch.zeros((reference.n_variants, reference.n_donors), dtype=reference.dtype,
                           device=reference.device)
    start, probs = [], None
    for i in range(START_ITERATIONS + iterations):
        if i > 0:
            addition = reference.mstep(probs)
        logits, probs = reference.estep(reference.normalise(addition))
        done = Iteration(host(addition), host(logits), host(probs))
        if i < START_ITERATIONS:
            start.append(done)
    return Trajectory(start, done, host(reference.mstep(probs)))


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", type=int, nargs="*", default=[])
    parser.add_argument("--control-seeds", type=int, nargs="*", default=[])
    parser.add_argument("--seconds", type=float, default=1.0)
    args = parser.parse_args()

    import torch

    from bench_h100.check import gaps
    from bench_h100.generator import draw_config
    from bench_h100.harness import load_cell, run_cell
    from bench_h100.reference import Reference

    cell = dataclasses.replace(load_cell(args.workload), limits=None)  # every number, none judged
    for seed in args.seeds:
        result = run_cell(cell, seed, args.seconds, False, time.perf_counter())
        numbers = {name: c["value"] for name, c in result["checks"].items()}
        print(json.dumps({"workload": cell.name, "kind": "program", "seed": seed, "numbers": numbers,
                          "attempted": result["attempted"], "metrics": result["metrics"]}), flush=True)
    for seed in args.control_seeds:
        draws = draw_config(cell.config, seed)
        control = Reference(draws, cell.config, cell.traffic, "cuda", dtype=torch.bfloat16)
        trajectory = control_trajectory(control, CONTROL_ITERATIONS)
        del control
        numbers = gaps(Reference(draws, cell.config, cell.traffic, "cuda"), trajectory)
        print(json.dumps({"workload": cell.name, "kind": "control", "seed": seed, "numbers": numbers}), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
