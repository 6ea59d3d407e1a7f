"""The PyTorch port stands alone: no JAX, nothing of the JAX package, and
the card by default.

- importing every module of eamg_tpu_torch (in a subprocess: torch stays
  out of this process) loads neither ``jax``, ``optax`` nor any
  ``eamg_tpu`` module;
- no source of the port, nor chip_smoke.py or chip_sweep.py, imports
  ``jax``, ``optax`` or ``eamg_tpu``;
- the entry points (the library's, ``cli generate`` and the bench module
  among them) raise on a host without CUDA when no device is given,
  instead of carrying on on the CPU.
"""

from __future__ import annotations

import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
PORT = REPO / "eamg_tpu_torch"
PORT_SOURCES = sorted(PORT.rglob("*.py"))

_PROBE = r"""
import importlib, json, pkgutil, sys
import eamg_tpu_torch
mods = [m.name for m in pkgutil.walk_packages(eamg_tpu_torch.__path__,
                                              "eamg_tpu_torch.")]
for m in mods:
    importlib.import_module(m)
leaked = sorted(m for m in sys.modules
                if m in ("jax", "optax", "eamg_tpu")
                or m.startswith(("jax.", "jaxlib", "optax.", "eamg_tpu.")))
import torch
raised = {}
if not torch.cuda.is_available():
    from eamg_tpu_torch import bench, cli
    from eamg_tpu_torch.decode import Generator
    from eamg_tpu_torch.emotion import EmotionClassifier
    from eamg_tpu_torch.models.gpt import GPTConfig
    from eamg_tpu_torch.serve import pipeline_from_checkpoint
    from eamg_tpu_torch.tokenizer import Vocab
    from eamg_tpu_torch.tools.medusa import probe_heads_for_checkpoint
    from eamg_tpu_torch.audio import Sf2Renderer
    from eamg_tpu_torch.emotion import default_classifier
    from eamg_tpu_torch.serve import demo_pipeline
    from eamg_tpu_torch.tools.ablation import run_ablation
    from eamg_tpu_torch.tools.feed_bench import run_feed_bench
    cfg = GPTConfig(vocab_size=3, seq_len=8, d_model=16, n_head=2, n_layer=1)
    calls = {
        "Generator": lambda: Generator({}, cfg, Vocab({"a": 0})),
        "pipeline_from_checkpoint": lambda: pipeline_from_checkpoint(),
        "EmotionClassifier": lambda: EmotionClassifier(),
        "cli generate": lambda: cli.main(["generate"]),
        "bench": lambda: bench.main([]),
        "probe_heads_for_checkpoint": lambda: probe_heads_for_checkpoint(
            {"cfg": cfg}, {"blocks": []}),
        "demo_pipeline": lambda: demo_pipeline(),
        "Sf2Renderer": lambda: Sf2Renderer("/nonexistent.sf2"),
        "run_ablation": lambda: run_ablation(),
        "run_feed_bench": lambda: run_feed_bench(),
        "default_classifier": lambda: default_classifier(),
        "cli emotion": lambda: cli.main(["emotion", "--text", "so happy"]),
        "cli train --experts": lambda: cli.main(
            ["train", "--experts", "4", "--moe-every", "2",
             "--synthetic", "8"]),
        "cli gqa-recover": lambda: cli.main(["gqa-recover", "--rows", "8"]),
    }
    for name, fn in calls.items():
        try:
            fn()
            raised[name] = None
        except RuntimeError as e:
            raised[name] = str(e)
print(json.dumps({"modules": mods, "leaked": leaked, "raised": raised,
                  "cuda": torch.cuda.is_available()}))
"""


@pytest.fixture(scope="module")
def probe():
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("XLA_", "JAX_"))}
    env["PYTHONPATH"] = str(REPO)
    r = subprocess.run([sys.executable, "-c", _PROBE], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-4000:]
    return json.loads(r.stdout.strip().splitlines()[-1])


def test_every_port_module_imports_without_jax(probe):
    assert len(probe["modules"]) >= 30, probe["modules"]
    for new in ("eamg_tpu_torch.bench", "eamg_tpu_torch.tokenizer.scheme_b",
                "eamg_tpu_torch.decode.medusa_tree",
                "eamg_tpu_torch.parallel.moe", "eamg_tpu_torch.models.quant",
                "eamg_tpu_torch.tools.gqa_recover"):
        assert new in probe["modules"]
    assert probe["leaked"] == []


def _imports(path: Path) -> list[str]:
    names = []
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.append(node.module or "")
    return names


@pytest.mark.parametrize("path", PORT_SOURCES + [REPO / "chip_smoke.py",
                                                 REPO / "chip_sweep.py"],
                         ids=lambda p: str(p.relative_to(REPO)))
def test_source_imports_no_jax_and_no_jax_package(path):
    bad = [n for n in _imports(path)
           if n in ("jax", "optax", "eamg_tpu")
           or n.startswith(("jax.", "jaxlib", "optax.", "eamg_tpu."))]
    assert bad == [], f"{path}: {bad}"


@pytest.mark.parametrize("entry", ["Generator", "pipeline_from_checkpoint",
                                   "EmotionClassifier", "cli generate",
                                   "bench", "probe_heads_for_checkpoint",
                                   "demo_pipeline", "Sf2Renderer",
                                   "run_ablation", "run_feed_bench",
                                   "default_classifier", "cli emotion",
                                   "cli train --experts",
                                   "cli gqa-recover"])
def test_entry_points_want_cuda_by_default(probe, entry):
    """On this CUDA-less host, no device argument means an error."""
    assert not probe["cuda"], "this check is for hosts without CUDA"
    msg = probe["raised"][entry]
    assert msg is not None and "device='cpu'" in msg
