"""Offline batch generation through ``decode/loop.py::generate_kv``.

Generations of ``rows`` rows run back to back from one caller, as the
port's ``bench.py`` runs them: each row's prompt is the first
``prompt_len`` tokens of its own Scheme-B2 song (``perfbench/gen``), padded
to a ``bucket``-slot bucket, decoded to position ``max_len`` with no EOS,
top-k ``top_k`` at ``temperature``, ``refeed_last_prompt=False``, at the
mix's ``attn_impl``; every generation has its own prompts and key, drawn
from the seed, and ends in the fetch of its tokens to the host. Every
``greedy_every``-th generation (the second, then every ``greedy_every``;
each one when it is 1)
runs at ``greedy_temperature``. The reference judges both kinds
(``perfbench/reference/served.py``): rows of the greedy generations
against its best logit (``served_gap``), rows of the sampled ones against
its ``top_k``-th (``topk_gap``: the top-k mask and the sampler's set).
The window runs whole generations until ``--seconds`` have passed; the
rate is all their tokens over all that time.
"""

from __future__ import annotations

import sys
import time

import numpy as np
import torch

from perfbench import inputs, work
from perfbench.gen import b2_songs
from perfbench.reference import gpt_plain, served


def _log(msg):
    print(msg, file=sys.stderr, flush=True)


class Runner:
    def __init__(self, cell):
        self.cell, self.mix, self.m = cell, cell.mix, cell.model()
        self.g = work.geometry({"model": self.m})
        self.dtype = torch.bfloat16 if self.m["dtype"] == "bfloat16" \
            else torch.float32
        self.count = 0

    def _prompt(self, rng: np.random.Generator) -> torch.Tensor:
        mix = self.mix
        p = np.zeros((mix["rows"], mix["bucket"]), np.int64)
        for r in range(mix["rows"]):
            p[r, :mix["prompt_len"]] = b2_songs.song(
                rng, 4 * mix["prompt_len"])[:mix["prompt_len"]]
        return torch.from_numpy(p).to(self.cell.device)

    def _generate(self, rng: np.random.Generator, index: int) -> dict:
        from eamg_tpu_torch.decode.loop import generate_kv
        from eamg_tpu_torch.utils import prng

        mix = self.mix
        every = mix["greedy_every"]
        greedy = index % every == 1 % every
        prompt = self._prompt(rng)
        buf, pos = generate_kv(
            self.w, prompt, mix["prompt_len"],
            prng.PRNGKey(int(rng.integers(2**31))), self.cfg,
            mix["max_len"], temperature=float(
                mix["greedy_temperature"] if greedy else mix["temperature"]),
            top_k=mix["top_k"], eos_id=-1, pad_id=0,
            refeed_last_prompt=False, attn_impl=mix["attn_impl"])
        return {"buf": buf.cpu(), "pos": int(pos), "greedy": greedy}

    def setup(self):
        cell = self.cell
        self.w = inputs.weights(cell, cell.device, self.dtype)
        self.cfg = inputs.gpt_config(self.m)
        warm = np.random.default_rng(0)
        for i in range(2):        # a sampled and a greedy generation
            self._generate(warm, i)
        self.rng = np.random.default_rng(cell.seed)

    def window(self, seconds: float) -> dict:
        mix = self.mix
        P, rows = mix["prompt_len"], mix["rows"]
        self.kept, tokens, flops, gens = [], 0, 0, 0
        start = time.perf_counter()
        while time.perf_counter() - start < seconds:
            out = self._generate(self.rng, self.count)
            self.count += 1
            gens += 1
            tokens += (out["pos"] - P) * rows
            flops += rows * work.request_flops(self.g, P, out["pos"])
            self.kept.append(out)
        wall = time.perf_counter() - start
        _log(f"[batch_decode] {gens} generations of {rows} rows in "
             f"{wall:.3f} s")
        return {"attempted": gens, "failed": 0,
                "e2e": {"gen_tokens_per_s": tokens / wall},
                "units": tokens, "wall_s": wall, "flops": flops,
                "dtype": self.m["dtype"]}

    def traced(self) -> dict:
        mix = self.mix
        P, rows = mix["prompt_len"], mix["rows"]
        tokens = attn = ffn_rows = flops = 0
        for _ in range(mix["trace_generations"]):
            out = self._generate(self.rng, self.count)
            self.count += 1
            n = out["pos"]
            tokens += (n - P) * rows
            flops += rows * work.request_flops(self.g, P, n)
            attn += rows * work.decode_attn_bytes(self.g, P, n,
                                                  self.m["dtype"])
            ffn_rows += rows * (P + max(n - P - 1, 0))
        return {"units": tokens, "flops": flops, "decode_attn_bytes": attn,
                "ffn_rows": ffn_rows}

    def release(self):
        del self.w
        if self.cell.device.type == "cuda":
            torch.cuda.empty_cache()

    def check(self, window: dict) -> list:
        mix = self.mix
        P, V = mix["prompt_len"], self.m["vocab_size"]
        bad, seqs = 0, {True: [], False: []}
        for out in self.kept:
            buf, n = out["buf"], out["pos"]
            if n != mix["max_len"] or buf.shape != (mix["rows"],
                                                    mix["max_len"]):
                bad += 1
                continue
            if bool(((buf < 0) | (buf >= V)).any()):
                bad += 1
            seqs[out["greedy"]] += [(P, buf[r, :n].tolist())
                                    for r in range(mix["rows"])]
        rng = np.random.default_rng(self.cell.seed ^ 0x5EED)
        pick = {}
        for greedy in (True, False):
            got = seqs[greedy]
            at = rng.choice(len(got), min(mix["check_rows"], len(got)),
                            replace=False) if got else []
            pick[greedy] = [got[i] for i in at]
        dev = self.cell.device
        w32 = gpt_plain.as_dtype(inputs.weights(self.cell, dev, self.dtype),
                                 torch.float32, dev)
        # the control (calibrate.py --fault control): the float8 reference
        # in the program's place
        low = (gpt_plain.fp8_weights(w32) if self.cell.fault == "control"
               else None)
        gaps = served.served_gaps(w32, self.m, pick[True], dev, w_low=low)
        topk = served.served_gaps(w32, self.m, pick[False], dev,
                                  top_k=mix["top_k"], w_low=low)
        _log(f"[batch_decode] reference over {len(pick[True])} greedy rows "
             f"and {len(pick[False])} sampled rows of {len(self.kept)} "
             "generations")
        limits = mix["limits"]
        return [{"name": "malformed_generations", "value": bad,
                 "limit": 0},
                {"name": "empty_sample",
                 "value": int(not pick[True] or not pick[False]),
                 "limit": 0},
                {"name": "served_gap", "value": max(gaps, default=0.0),
                 "limit": limits["served_gap"]},
                {"name": "topk_gap", "value": max(topk, default=0.0),
                 "limit": limits["topk_gap"]}]
