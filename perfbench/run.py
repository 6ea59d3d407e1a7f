"""Run one cell of the benchmark of ``eamg_tpu_torch`` on this machine's card.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

From the root of a checkout. It sets up the cell (``perfbench/core.py``),
measures for ``--seconds`` seconds, and prints one JSON line last on
standard output: with ``--trace 0`` the cell's end-to-end metrics, with
``--trace 1`` its per-layer metrics (the window is run untraced first,
then a short segment under the profiler). The numbers compared with the
plain reference are the last lines on standard error, each beside its
limit. It exits with 1, printing no result, when CUDA is absent or has
fewer cards than the cell asks for, and when a module of JAX or of the
JAX package is loaded once the window has closed.
"""

from __future__ import annotations

import os
import sys
import time

T0 = time.perf_counter()
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def _log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def main(argv=None) -> int:
    import argparse
    import json
    import math
    import subprocess

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)

    from perfbench import core

    core.checkout_caches(ROOT)
    import torch

    bench = core.load_json(os.path.join(ROOT, "BENCHMARK.json"))
    cell = core.Cell(bench, args.workload, args.seed, args.seconds,
                     bool(args.trace), ROOT)
    if not torch.cuda.is_available() \
            or torch.cuda.device_count() < cell.chips:
        _log(f"[perfbench] needs {cell.chips} CUDA card(s); "
             f"torch.cuda.is_available() = {torch.cuda.is_available()}, "
             f"device_count() = {torch.cuda.device_count()}")
        return 1
    cell.device = torch.device("cuda", 0)
    torch.cuda.set_device(cell.device)
    try:
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        card = "nvidia-smi gave nothing"
    _log(f"[perfbench] card: {card}; torch {torch.__version__}, CUDA "
         f"{torch.version.cuda}; peaks 989 TFLOP/s bf16, 67 TFLOP/s f32, "
         "3.35 TB/s")
    out = core.run_cell(cell, T0, log=_log)
    loaded = core.forbidden_loaded()
    if loaded:
        _log(f"[perfbench] modules of JAX or the JAX package were loaded: "
             f"{loaded}")
        return 1
    for name in list(out["metrics"]):
        if not math.isfinite(out["metrics"][name]["value"]):
            _log(f"[perfbench] {name} is not finite (a request never "
                 "came); left out of the line")
            del out["metrics"][name]
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
