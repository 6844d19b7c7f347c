"""The readings that the correctness limits are set from, for one cell, in
one process: the program on each seed (with ``--control``, the reference
in TF32 beside it, compared with the float32 reference on the same
inputs), or the program with a fault planted (``--fault``).

    python3 portbench/calibrate.py --workload expytky-road.train \\
        --seeds 11,12,13 --seconds 2 --control [--fault half_batch]

One JSON line a seed: the readings, the control's, the end-to-end
quantities and the outcome's counts. The benchmark's own runs never run
this; ``PERF.md`` keeps what it read and the limits set from it.
"""
import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--control", action="store_true")
    ap.add_argument("--fault", default=None)
    args = ap.parse_args(argv)

    from portbench.harness import cell as cells
    from portbench.harness import env

    cell = cells.load(args.workload)
    device = env.require_cards(cell.chips)
    for seed in [int(s) for s in args.seeds.split(",")]:
        t = time.perf_counter()
        out, line = env.run_cell(cell, seed, args.seconds, False, device, t,
                                 fault=args.fault, control=args.control)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "fault": args.fault, "correct": line["correct"],
                          "readings": out.readings,
                          "control": out.control_readings,
                          "quantities": out.quantities,
                          "attempted": out.attempted, "failed": out.failed,
                          "quiet_leaves": out.layer.get("quiet_leaves"),
                          "worst": out.layer.get("worst"),
                          "control_worst": out.layer.get("control_worst"),
                          "seconds": time.perf_counter() - t}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
