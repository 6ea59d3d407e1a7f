"""Nothing the benchmark runs imports JAX or the JAX package (top-level
module names compared whole: ``eamg_tpu_torch`` is the port and allowed
in the harness), and the reference imports nothing of the port."""

import ast
import json
import os
import subprocess
import sys

from perfbench.tests import tiny

PB = os.path.join(tiny.ROOT, "perfbench")
FORBIDDEN = {"jax", "jaxlib", "flax", "eamg_tpu"}


def _py(code: str) -> dict:
    out = subprocess.run([sys.executable, "-c", code], cwd=tiny.ROOT,
                         capture_output=True, text=True, timeout=600,
                         env={**os.environ, "PYTHONPATH": tiny.ROOT})
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_a_run_loads_no_jax(tmp_path):
    got = _py(f"""
import json, sys, time, glob, os, torch
torch.set_num_threads(2)
from perfbench import core
from perfbench.tests import tiny
bench = tiny.write({str(tmp_path)!r})
for kind in ("runners", "metrics"):
    for f in sorted(glob.glob(os.path.join(core.HERE, kind, "*.py"))):
        core.plugin(kind, os.path.basename(f)[:-3])
import perfbench.run, perfbench.sweep, perfbench.calibrate
for name in ("t-batch", "t-train"):
    cell = core.Cell(bench, name, 7, 0.5, name == "t-batch", tiny.ROOT,
                     device=torch.device("cpu"), base={str(tmp_path)!r})
    core.run_cell(cell, time.perf_counter(), log=lambda m: None)
print(json.dumps(sorted({{n.split(".")[0] for n in sys.modules}})))
""")
    assert not FORBIDDEN & set(got)
    assert "eamg_tpu_torch" in got


def test_reference_loads_nothing_of_the_program():
    got = _py("""
import json, sys
import perfbench.reference.gpt_plain, perfbench.reference.served
import perfbench.reference.train_plain
print(json.dumps(sorted({n.split(".")[0] for n in sys.modules})))
""")
    assert not (FORBIDDEN | {"eamg_tpu_torch"}) & set(got)


def test_reference_sources_import_only_plain_modules():
    for f in sorted(os.listdir(os.path.join(PB, "reference"))):
        if not f.endswith(".py"):
            continue
        tree = ast.parse(open(os.path.join(PB, "reference", f)).read())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""] if node.level == 0 else []
            else:
                continue
            for n in names:
                assert n.split(".")[0] in {"__future__", "math", "pickle",
                                           "numpy", "torch"}, (f, n)
