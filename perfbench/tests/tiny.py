"""Tiny cells defined by data files alone, in a directory of their own,
for the CPU tests: a Scheme-A engine cell, a batch decode cell and a
training cell over one-layer models, with the shipped mixes' parameters
cut to what a CPU run can hold."""

from __future__ import annotations

import json
import os

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
TRAFFIC = os.path.join(ROOT, "perfbench", "traffic")
# the tiny cells' limits, from their own readings on the CPU (seeds 11, 12
# and 2**31 + 4242): float32 program on the float32 reference 0 (served
# and top-k gaps), losses 1.2e-7, gradients 2.2e-7, changes 7.4e-6; the
# float8 control 0.027-0.070, the TF32 control 2.5e-6, 4.4e-5, 1.0e-2
SERVED_LIMITS = {"unanswered_or_malformed": 0, "served_gap": 1e-3,
                 "topk_gap": 1e-3}
TRAIN_LIMITS = {"loss_gap": 1e-6, "grad_gap": 1e-5, "delta_gap": 1e-3,
                "late_loss_gap": 1e-6, "late_grad_gap": 1e-5,
                "late_delta_gap": 1e-3}


def _model(vocab: int) -> dict:
    return {"vocab_size": vocab, "seq_len": 64, "d_model": 32, "n_head": 4,
            "n_kv_heads": 2, "n_layer": 1, "d_ff": 64, "causal": True,
            "ln_placement": "post", "activation": "relu", "ln_eps": 1e-5,
            "dtype": "float32", "kernels": "xla"}


def _mix(name: str, **changes) -> dict:
    with open(os.path.join(TRAFFIC, name + ".json")) as f:
        mix = json.load(f)
    mix.update(changes, dtype="float32")
    return mix


def write(base: str) -> dict:
    """Write the tiny cells' files under ``base`` -> their BENCHMARK dict."""
    files = {
        "configs/tiny-a.json": {
            "name": "tiny-a", "source": "tiny", "model": _model(8892),
            "weights": {"seed": True},
            "vocab": "eamg_tpu/serve/demo_ckpt_a/vocab.json", "reduced": []},
        "configs/tiny-l.json": {
            "name": "tiny-l", "source": "tiny", "model": _model(8324),
            "weights": {"seed": True}, "reduced": []},
        "traffic/tiny-open.json": _mix(
            "engine-open-knee0.8", slots=4, chunk=8, rate_per_s=6.0,
            burst_size=3, burst_every_s=1.0, warm_requests=6,
            trace_seconds=0.5, check_requests=3, check_sampled=50,
            greedy_share=0.5, limits=SERVED_LIMITS),
        "traffic/tiny-batch.json": _mix(
            "batch32-to-511", rows=4, max_len=40, trace_generations=1,
            check_rows=8, greedy_every=2, limits=SERVED_LIMITS),
        "traffic/tiny-train.json": _mix(
            "train-mb16-rows511", micro_batch=4, width=33, song_min=40,
            song_max=80, trace_steps=2, loss_chunk=8, limits=TRAIN_LIMITS),
    }
    for rel, body in files.items():
        path = os.path.join(base, rel)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "w") as f:
            json.dump(body, f)
    cells = (("t-open", "tiny-a", "tiny-open", "request_ms_p95"),
             ("t-batch", "tiny-l", "tiny-batch", "gen_tokens_per_s"),
             ("t-train", "tiny-l", "tiny-train", "train_tokens_per_s"))
    return {
        "configs": [{"name": c, "source": "tiny",
                     "file": os.path.join(base, "configs", c + ".json"),
                     "reduced": [], "why": "tiny"}
                    for c in ("tiny-a", "tiny-l")],
        "workloads": [{"name": n, "config": c, "traffic": t, "chips": 1,
                       "why": "tiny"} for n, c, t, _ in cells],
        "end_to_end": [
            {"name": "request_ms_p95", "unit": "ms", "workloads": ["t-open"]},
            {"name": "gen_tokens_per_s", "unit": "tokens/s",
             "workloads": ["t-open", "t-batch"]},
            {"name": "train_tokens_per_s", "unit": "tokens/s",
             "workloads": ["t-train"]},
            {"name": "setup_s", "unit": "s"}],
        "per_layer": [{"name": "mfu." + n, "unit": "%", "moves": m,
                       "workloads": [n]} for n, _, _, m in cells]}
