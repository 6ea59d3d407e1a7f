"""Helpers for the port's parity tests (no torch here: torch runs only in
the subprocess, tests/torch_port_worker.py)."""

from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[1]
WORKER = Path(__file__).resolve().parent / "torch_port_worker.py"


def flatten(tree, prefix: str) -> dict:
    """Nested dicts/lists of arrays -> {"prefix/a/0/b": np.ndarray}. bf16
    leaves travel as their uint16 bit patterns."""
    out = {}

    def walk(node, path):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, f"{path}/{k}")
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                walk(v, f"{path}/{i}")
        else:
            a = np.asarray(node)
            out[path] = a.view(np.uint16) if a.dtype.name == "bfloat16" \
                else a

    walk(tree, prefix)
    return out


def cfg_json(cfg) -> np.ndarray:
    import dataclasses

    return np.asarray(json.dumps(dataclasses.asdict(cfg)))


def run_worker(task: str, inputs: dict, tmp_dir: Path,
               timeout: int = 600) -> dict:
    """Run the torch side of ``task`` in a subprocess; returns its arrays."""
    return start_worker(task, inputs, tmp_dir, timeout)()


def start_worker(task: str, inputs: dict, tmp_dir: Path,
                 timeout: int = 600):
    """Start the torch side of ``task`` in a subprocess -> a function that
    waits for it and returns its arrays (the caller computes JAX's side
    meanwhile)."""
    src, dst = tmp_dir / f"{task}_in.npz", tmp_dir / f"{task}_out.npz"
    np.savez(src, **inputs)
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("XLA_", "JAX_"))}
    env["PYTHONPATH"] = str(REPO)
    env["OMP_NUM_THREADS"] = "2"
    proc = subprocess.Popen([sys.executable, str(WORKER), task, str(src),
                             str(dst)], cwd=REPO, env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)

    def result() -> dict:
        try:
            out, err = proc.communicate(timeout=timeout)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.communicate()
            raise
        assert proc.returncode == 0, (
            f"torch worker {task} failed:\n{out[-3000:]}\n{err[-6000:]}")
        with np.load(dst, allow_pickle=False) as z:
            return {k: z[k] for k in z.files}

    return result


def perturbed_params(cfg, rng, key: int = 7):
    """JAX ``init_params`` as a numpy tree, with the position table and the
    LayerNorm parameters perturbed (the JAX init leaves them at zero and at
    identity), so that positions and LN parameters matter."""
    import jax

    from eamg_tpu.models.gpt import init_params

    params = jax.tree.map(np.asarray,
                          init_params(jax.random.PRNGKey(key), cfg))
    params["pos"] = (0.5 * rng.standard_normal(params["pos"].shape)
                     ).astype(np.float32)
    for lp in params["layers"]:
        for ln in ("ln1", "ln2"):
            lp[ln]["g"] = (1 + 0.1 * rng.standard_normal(
                lp[ln]["g"].shape)).astype(np.float32)
            lp[ln]["b"] = (0.1 * rng.standard_normal(
                lp[ln]["b"].shape)).astype(np.float32)
    return params


def token_names(n: int) -> dict:
    """A Scheme-A-shaped vocabulary of n tokens, every grammar class in it:
    [PAD] 0, [START_SEQUENCE] 1, [END_SEQUENCE] 2, [BPM] 3-5,
    [KEY_SIGNATURE] 6-8, [INSTRUMENT] 9-29, [NOTE] 30 to n - 11, and ten
    tokens of no class."""
    names = {0: "[PAD]", 1: "[START_SEQUENCE]", 2: "[END_SEQUENCE]"}
    for i in range(3, n):
        names[i] = (f"[BPM] {60 + 10 * i}" if i < 6
                    else f"[KEY_SIGNATURE] K{i}" if i < 9
                    else f"[INSTRUMENT] I{i}" if i < 30
                    else f"[NOTE] N{i}" if i < n - 10 else f"x{i}")
    return {t: i for i, t in names.items()}
