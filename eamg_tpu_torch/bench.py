"""Batched offline decode benchmark of the port, on one CUDA card.

    python -m eamg_tpu_torch.bench                       # every attn_impl
    python -m eamg_tpu_torch.bench --attn-impl sp fold   # some of them

The counterpart of the JAX package's ``bench.py``: the ``large2`` trainer
geometry (d512, h8, MHA, L6, FF 2048, 511 positions) with the Scheme-B2
vocabulary (8,324 tokens), causal, bf16, random weights from a seed; batch
8, the prompt ``[1, 2, 3]`` in a 16-slot bucket, decoded to the end of the
positional table (``max_len`` = ``n_pos`` = 511) with temperature 1, top-k
50, no EOS (``eos_id=-1``) and ``refeed_last_prompt=False``, through
``generate_kv``. For each ``attn_impl`` (``models.gpt.ATTN_IMPLS``) it
runs one warm-up generation (which captures its CUDA graph,
``decode/graphs.py``) and a few timed ones, each timed to the fetch of the
tokens to the host, and prints one JSON line: tokens/s from the fastest
run, ms per decode step, and the kernel launches per step by wrapper (the
graphs run whole blocks of ``decode/graphs.py::BLOCK`` steps, so the steps
past the end of the last block are launched, and counted, too). The card's name and power limit are printed first. The module
takes no option that cuts the size: every line it prints is the full
configuration's (a cut size, as the CPU tests run, goes through
:func:`large2_config` and :func:`bench_impl`).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
import time

import torch

from .decode.loop import generate_kv
from .models.gpt import ATTN_IMPLS, GPTConfig, init_params, preset
from .ops import _build
from .tokenizer import SchemeB2
from .utils import prng
from .utils.device import resolve_device

BATCH, PROMPT, BUCKET = 8, (1, 2, 3), 16


def large2_config(n_layer: int | None = None,
                  dtype: str = "bfloat16") -> GPTConfig:
    """``preset("large2")`` over the Scheme-B2 vocabulary, causal, in
    ``dtype``; ``n_layer`` cuts the depth (None: the preset's 6)."""
    cfg = preset("large2", vocab_size=len(SchemeB2().vocab))
    cfg = dataclasses.replace(cfg, dtype=dtype, causal=True)
    return cfg if n_layer is None else dataclasses.replace(cfg,
                                                           n_layer=n_layer)


def make_params(cfg: GPTConfig, seed: int, device) -> dict:
    """Random weights from ``seed``, stored in the model's dtype (bf16
    halves what a decode step reads), on ``device``."""
    params = init_params(torch.Generator().manual_seed(seed), cfg)

    def cast(tree):
        if isinstance(tree, dict):
            return {k: cast(v) for k, v in tree.items()}
        if isinstance(tree, list):
            return [cast(v) for v in tree]
        return tree.to(cfg.torch_dtype).to(device)

    return cast(params)


def bench_prompt(device, batch: int = BATCH) -> torch.Tensor:
    prompt = torch.zeros((batch, BUCKET), dtype=torch.int64)
    prompt[:, :len(PROMPT)] = torch.tensor(PROMPT)
    return prompt.to(device)


def run_once(params: dict, cfg: GPTConfig, prompt: torch.Tensor, seed: int,
             max_len: int, attn_impl: str):
    """One generation -> (tokens [B, max_len] on the host, n_tokens)."""
    buf, pos = generate_kv(params, prompt, len(PROMPT), prng.PRNGKey(seed),
                           cfg, max_len, temperature=1.0, top_k=50,
                           eos_id=-1, pad_id=0, refeed_last_prompt=False,
                           attn_impl=attn_impl)
    return buf.cpu(), pos


def bench_impl(params: dict, cfg: GPTConfig, prompt: torch.Tensor,
               max_len: int, attn_impl: str, runs: int = 3) -> dict:
    """Warm up once, time ``runs`` generations; -> the result line."""
    run_once(params, cfg, prompt, 0, max_len, attn_impl)
    times, counts = [], {}
    for i in range(1, runs + 1):
        _build.reset_launch_counts()
        t0 = time.perf_counter()
        buf, pos = run_once(params, cfg, prompt, i, max_len, attn_impl)
        times.append(time.perf_counter() - t0)
        counts = _build.launch_counts()
    assert pos == max_len and buf.shape == (prompt.shape[0], max_len)
    best = min(times)
    steps = max_len - len(PROMPT) - 1     # the first token is the prefill's
    n_tokens = (max_len - len(PROMPT)) * prompt.shape[0]
    return {"attn_impl": attn_impl, "tokens_per_s": n_tokens / best,
            "ms_per_step": best / max(steps, 1) * 1e3,
            "seconds": times, "n_tokens": n_tokens, "steps": steps,
            "launches_per_step": {k: v / max(steps, 1)
                                  for k, v in sorted(counts.items())},
            "device": str(prompt.device)}


def card_line() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60)
        return out.stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        return "no card (nvidia-smi gave nothing)"


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="eamg_tpu_torch.bench",
                                     description=__doc__.splitlines()[0])
    parser.add_argument("--device", default=None,
                        help="torch device (default cuda; 'cpu' runs the "
                             "plain versions of the kernels, slowly)")
    parser.add_argument("--attn-impl", nargs="*", default=list(ATTN_IMPLS),
                        choices=ATTN_IMPLS)
    args = parser.parse_args(argv)
    device = resolve_device(args.device)
    cfg = large2_config()
    max_len = cfg.n_pos
    print(f"[card] {card_line()}; torch {torch.__version__}; {cfg.dtype} "
          f"d{cfg.d_model} h{cfg.n_head} L{cfg.n_layer} V{cfg.vocab_size}, "
          f"batch {BATCH}, max_len {max_len}", flush=True)
    params = make_params(cfg, 0, device)
    prompt = bench_prompt(device)
    for impl in args.attn_impl:
        print(json.dumps(bench_impl(params, cfg, prompt, max_len, impl)),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
