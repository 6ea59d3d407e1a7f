"""Find the knee of an open-loop engine cell: the highest offered rate at
which the engine keeps no growing backlog.

    python3 perfbench/sweep.py --workload a-engine-open \
        --rates 20,40,60,80 --seconds 15 --seed 7 [--out build/perfbench/knee.json]

One set-up; then, for each rate in turn, the cell's own arrivals at that
rate for ``--seconds`` seconds, waited out (the runner's ``offered``). A rate keeps up when the requests in
the system (due and not yet back), averaged over the last third of its
window, are no more than 1.15 times those over the middle third plus half
a burst, and none failed. Prints a line a rate and the knee: the highest
rate at and below which every rate kept up.
"""

from __future__ import annotations

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def in_system(run: dict, t: float) -> int:
    """Requests due by ``t`` (s from the start) and not back by then."""
    return sum(1 for due, _, _, fin in run["done"]
               if due <= t < fin - run["start"])


def keeps_up(run: dict, seconds: float, burst: int) -> tuple:
    steps = [seconds * i / 300 for i in range(300)]
    mid = [in_system(run, t) for t in steps[100:200]]
    last = [in_system(run, t) for t in steps[200:]]
    m2, m3 = sum(mid) / len(mid), sum(last) / len(last)
    failed = sum(isinstance(r, Exception) for _, _, r, _ in run["done"])
    return (m3 <= 1.15 * m2 + burst / 2 and not failed), m2, m3, failed


def main(argv=None) -> int:
    import argparse
    import json

    from perfbench import core

    core.checkout_caches(ROOT)
    import torch

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", default="a-engine-open")
    ap.add_argument("--rates", required=True)
    ap.add_argument("--seconds", type=float, default=15.0)
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("sweep: needs a CUDA card", file=sys.stderr)
        return 1
    bench = core.load_json(os.path.join(ROOT, "BENCHMARK.json"))
    cell = core.Cell(bench, args.workload, args.seed, args.seconds, False,
                     ROOT, device=torch.device("cuda", 0))
    drv = core.plugin("runners", cell.mix["runner"]).Runner(cell)
    drv.setup()
    rows, knee = [], None
    for rate in (float(r) for r in args.rates.split(",")):
        got = drv.offered(rate, args.seconds)
        run, t = got["run"], got["tally"]
        ok, m2, m3, failed = keeps_up(run, args.seconds,
                                      cell.mix["burst_size"])
        back = sum(1 for _, _, r, fin in run["done"]
                   if not isinstance(r, Exception)
                   and fin - run["start"] <= args.seconds)
        row = {"rate_per_s": rate, "requests": len(run["done"]),
               "keeps_up": ok,
               "in_system_mid": m2, "in_system_last": m3, "failed": failed,
               "back_per_s": back / args.seconds,
               "request_ms_p50": core.percentile(t["lat"], 50),
               "request_ms_p95": core.percentile(t["lat"], 95),
               "gen_tokens_per_s": t["tokens"] / args.seconds}
        rows.append(row)
        print(json.dumps(row), flush=True)
    drv.release()
    for row in sorted(rows, key=lambda r: r["rate_per_s"]):
        if not row["keeps_up"]:
            break
        knee = row["rate_per_s"]
    result = {"workload": args.workload, "seconds": args.seconds,
              "knee_per_s": knee, "rows": rows}
    print(json.dumps({"knee_per_s": knee}), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
