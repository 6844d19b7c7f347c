"""Run one cell of the port's benchmark once and print its result line.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> \\
        --trace <0|1>

The cell, its configuration, traffic mix, limits and metric readers are
found by name from ``BENCHMARK.json`` at the root of the checkout. The
program under test is ``megacrn_tpu_torch`` in the same checkout. The last
line of standard output is one JSON object: ``correct``, ``attempted``,
``failed``, ``metrics`` (the cell's end-to-end metrics, or with
``--trace 1`` its per-layer ones), ``device``, with ``--trace 1`` a
``breakdown``, and last ``compared``: each number the correctness check
compared, with its limit (also the last lines of standard error).
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

# Imported by whole top-level name, never present after the window.
FORBIDDEN = ("jax", "jaxlib", "flax", "megacrn_tpu")


def forbidden_modules():
    return sorted({name.split(".")[0] for name in sys.modules}
                  & set(FORBIDDEN))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from portbench.harness import cell as cells
    from portbench.harness import env

    cell = cells.load(args.workload)
    device = env.require_cards(cell.chips)
    outcome, result = env.run_cell(cell, args.seed, args.seconds,
                                   bool(args.trace), device, T_START)
    found = forbidden_modules()
    if found:
        print(f"the run imported {', '.join(found)}: the benchmark and the "
              "port must not load JAX or the JAX package", file=sys.stderr)
        return 3
    for name, (value, limit) in outcome.compared(cell.limits).items():
        print(f"compared {name} {value!r} limit {limit!r}", file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
