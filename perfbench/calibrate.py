"""Readings that set a cell's limits: the compared numbers of the program,
of the control or of a planted fault, over many seeds.

    python3 perfbench/calibrate.py --workload <cell> --seeds 11,12,13 \
        --seconds 4 [--fault control] [--out build/perfbench/calib.jsonl]

Each seed is a whole run of the cell (set-up, a window of ``--seconds``,
the check) in this one process, with ``--fault`` planted where the runner
plants it: ``control`` puts the reference at the precision below the
configuration's in the program's place (float8 weights for a served
cell, TF32 matmuls for training), and the check judges it as it judges
the program. One JSON line a seed, on standard output and appended to
``--out``.
"""

from __future__ import annotations

import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main(argv=None) -> int:
    import argparse
    import json

    from perfbench import core

    core.checkout_caches(ROOT)
    import torch

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--out", default=None)
    ap.add_argument("--fault", default=None,
                    help="a fault the runner plants under the timed path")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("calibrate: needs a CUDA card", file=sys.stderr)
        return 1
    bench = core.load_json(os.path.join(ROOT, "BENCHMARK.json"))
    for seed in (int(s) for s in args.seeds.split(",")):
        cell = core.Cell(bench, args.workload, seed, args.seconds, False,
                         ROOT, device=torch.device("cuda", 0))
        cell.fault = args.fault
        out = core.run_cell(cell, time.perf_counter(),
                            log=lambda m: print(m, file=sys.stderr))
        line = {"workload": args.workload, "seed": seed, "fault": args.fault,
                "correct": out["correct"], "checks": out["checks"],
                "metrics": out["metrics"]}
        torch.cuda.empty_cache()
        text = json.dumps(line)
        print(text, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(text + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
