"""Run one cell of the H100 benchmark of ``demuxalot_tpu_torch`` and print its result as the last line.

    python3 bench_h100/run.py --workload pbmc32_65k.em_percall --seed 7 --seconds 10 --trace 0

From the root of a checkout. ``--trace 0`` reports the cell's end-to-end
metrics, ``--trace 1`` its per-layer ones from a profiled window. Each
number the comparison reads is printed beside its limit, as the last lines
of standard error and under ``checks`` at the end of the result. Exits
with another code than 0, printing no result, without a card, with fewer
cards than the cell asks for, or where the run loaded JAX or the JAX
package.
"""
import time

STARTED = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "demuxalot_tpu"})  # compared with each module's top-level name


def forbidden_modules() -> list:
    return sorted({name.split(".", 1)[0] for name in list(sys.modules)} & FORBIDDEN)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)

    import torch

    from bench_h100.harness import load_cell, run_cell

    cell = load_cell(args.workload)
    if not torch.cuda.is_available():
        print("bench_h100: no CUDA device (torch.cuda.is_available() is False)", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell.chips:
        print(f"bench_h100: {cell.name} needs {cell.chips} cards, {torch.cuda.device_count()} found", file=sys.stderr)
        return 2
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace), STARTED)
    found = forbidden_modules()
    if found:
        print(f"bench_h100: the run loaded {', '.join(found)}", file=sys.stderr)
        return 3
    print("spans " + json.dumps(result["spans"]), file=sys.stderr)
    for name, check in result["checks"].items():
        print(f"{name} {check['value']!r} limit {check['limit']!r}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
