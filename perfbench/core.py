"""The harness: one cell of ``BENCHMARK.json``, found and run by name.

A cell names a configuration (``perfbench/configs/<config>.json``) and a
traffic mix (``perfbench/traffic/<traffic>.json``). The mix names its
runner (``perfbench/runners/<runner>.py``), which sets up the program,
warms up every shape the mix uses, runs the measured window and returns
its counts and times, runs a traced segment when asked, and compares what
the window produced with the plain reference. A per-layer metric
``<family>.<suffix>`` (or ``<family>``) is read by
``perfbench/metrics/<family>.py``. So a configuration, a mix, a runner or
a metric is added as a file, with its entry in ``BENCHMARK.json``, and no
file here changes.
"""

from __future__ import annotations

import importlib.util
import json
import math
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
# the top-level module names a run may not hold (compared whole)
FORBIDDEN = ("jax", "jaxlib", "flax", "eamg_tpu")
# every build and kernel cache at a fixed path inside the checkout (the
# port's own kernels build under build/eamg_tpu_torch, ops/_build.py)
CACHES = (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
          ("TRITON_CACHE_DIR", "triton"),
          ("PYTORCH_KERNEL_CACHE_PATH", "torch_kernels"),
          ("CUDA_CACHE_PATH", "cuda_cache"))


def checkout_caches(root: str) -> None:
    """Point the caches at ``root/build/perfbench`` and keep libraries
    that can load JAX by themselves from doing so; call before torch is
    imported."""
    for var, sub in CACHES:
        os.environ[var] = os.path.join(root, "build", "perfbench", sub)
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def load_json(path: str) -> dict:
    with open(path, encoding="utf-8") as f:
        return json.load(f)


def _safe(name: str) -> str:
    if not name or any(not (c.isalnum() or c in "_-.") for c in name):
        raise ValueError(f"not a plain name: {name!r}")
    return name


def plugin(kind: str, name: str, base: str = HERE):
    """The module ``<kind>/<name>.py`` under ``base``, else under this
    directory (dots and dashes in the name become underscores in the
    file's name)."""
    fname = _safe(name).replace(".", "_").replace("-", "_")
    path = os.path.join(base, kind, fname + ".py")
    if not os.path.exists(path):
        path = os.path.join(HERE, kind, fname + ".py")
    spec = importlib.util.spec_from_file_location(
        f"perfbench_{kind}_{fname}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metric_family(name: str) -> str:
    """``mfu.serve`` -> ``mfu``: the reader's name."""
    return name.rsplit(".", 1)[0] if "." in name else name


def percentile(values, q: float) -> float:
    """The q-th percentile (0..100), linear between ranks; a value of
    ``math.inf`` (a request that never came) counts as the slowest."""
    v = sorted(values)
    if not v:
        return math.nan
    at = (len(v) - 1) * q / 100.0
    lo, hi = int(math.floor(at)), int(math.ceil(at))
    if v[hi] == math.inf:
        return math.inf
    return v[lo] + (v[hi] - v[lo]) * (at - lo)


class Cell:
    """A cell's entries: ``bench`` (BENCHMARK.json), ``entry`` (its
    workload), ``config`` and ``mix`` (their files), and the run's
    arguments."""

    def __init__(self, bench: dict, name: str, seed: int, seconds: float,
                 trace: bool, root: str, device=None, base: str = HERE):
        self.bench, self.root, self.base = bench, root, base
        found = [w for w in bench["workloads"] if w["name"] == name]
        if not found:
            raise SystemExit(f"no workload named {name!r} in BENCHMARK.json")
        self.entry = found[0]
        self.name = name
        cfg = [c for c in bench["configs"]
               if c["name"] == self.entry["config"]][0]
        self.config = load_json(os.path.join(root, cfg["file"]))
        self.mix = load_json(os.path.join(
            base, "traffic", _safe(self.entry["traffic"]) + ".json"))
        self.seed, self.seconds, self.trace = int(seed), seconds, trace
        self.device = device
        self.chips = int(self.entry.get("chips", 1))
        # a fault planted under the timed path, or the control in its
        # place (tests, calibrate.py)
        self.fault = None

    def model(self) -> dict:
        """The configuration's model, in the mix's dtype where it says."""
        m = dict(self.config["model"])
        if "dtype" in self.mix:
            m["dtype"] = self.mix["dtype"]
        return m

    def end_to_end(self) -> list:
        return [m for m in self.bench["end_to_end"]
                if self.name in m.get("workloads", [self.name])]

    def per_layer(self) -> list:
        e2e = {m["name"] for m in self.end_to_end()}
        return [m for m in self.bench["per_layer"]
                if (self.name in m["workloads"] if "workloads" in m
                    else m["moves"] in e2e)]


def forbidden_loaded() -> list:
    return sorted(n for n in list(sys.modules)
                  if n.split(".", 1)[0] in FORBIDDEN)


def run_cell(cell: Cell, t0: float, log=print) -> dict:
    """Set up, warm up, measure, trace and check one cell -> the result
    line's dict. ``t0``: the host clock when the process began its work."""
    import torch

    from .trace import Trace

    runner = plugin("runners", cell.mix["runner"], cell.base).Runner(cell)
    runner.setup()
    if cell.device.type == "cuda":
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    log(f"[perfbench] {cell.name}: set-up {setup_s:.3f} s; window "
        f"{cell.seconds} s")
    window = runner.window(cell.seconds)
    tr, traced = None, None
    if cell.trace:
        tr = Trace()
        traced = tr.run(runner.traced)
    peak = (torch.cuda.max_memory_allocated(cell.device)
            if cell.device.type == "cuda" else 0)
    runner.release()
    checks = runner.check(window)
    correct = all(c["value"] <= c["limit"] for c in checks)
    metrics = {}
    if cell.trace:
        for m in cell.per_layer():
            reader = plugin("metrics", metric_family(m["name"]), cell.base)
            value = reader.read(cell, window, traced, tr)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        values = dict(window["e2e"], setup_s=setup_s)
        for m in cell.end_to_end():
            if m["name"] in values:
                metrics[m["name"]] = {"value": values[m["name"]],
                                      "unit": m["unit"]}
    device = {"platform": "gpu" if cell.device.type == "cuda"
              else cell.device.type,
              "kind": (torch.cuda.get_device_name(cell.device)
                       if cell.device.type == "cuda" else "cpu"),
              "count": cell.chips, "memory_peak_bytes": int(peak)}
    out = {"correct": bool(correct), "attempted": int(window["attempted"]),
           "failed": int(window["failed"]), "metrics": metrics,
           "device": device}
    if tr is not None:
        device["busy_s"] = tr.busy_s
        device["window_s"] = tr.window_s
        out["breakdown"] = {"device_ops": tr.top_ops(),
                            "idle_gaps": tr.idle_gaps()}
    for c in checks:
        log(f"[check] {c['name']} {c['value']!r} limit {c['limit']!r}")
    out["checks"] = {c["name"]: {"value": c["value"], "limit": c["limit"]}
                     for c in checks}
    return out
