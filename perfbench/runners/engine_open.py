"""Open-loop load on the continuous engine, as ``serve --coalesce`` runs it.

The engine is ``serve/continuous.py::ContinuousBatcher`` on a
``Generator`` over the configuration's weights, with the mix's slots,
chunk and top-k; the window drives ``ContinuousBatcher.submit`` directly,
one thread a request in flight. Arrivals are an open loop: Poisson
arrivals (a fixed count, ``rate`` less the bursts' share times the
window, at uniform times, which is a Poisson process given its count)
plus ``burst_size`` requests at once every ``burst_every_s`` seconds,
half a period in. Each request is a GoEmotions label drawn Zipf over the
28 labels in an order fixed by the seed, its EATS mapping and control
tokens (``perfbench/gen/emotion.py``), its own seed, and temperature
``temperature``; a share ``greedy_share`` of them, drawn from the seed,
runs at ``greedy_temperature`` (so low that the top logit wins by any gap
above a thousandth). The reference judges both kinds
(``perfbench/reference/served.py``): the greedy requests' tokens against
its best logit (``served_gap``), the sampled requests' against its
``top_k``-th (``topk_gap``: the top-k mask and the sampler's set).

A request is timed from when it was due until its ids are back; one that
fails or never comes counts as the slowest. The generator's lateness is
printed. ``gen_tokens_per_s`` counts the tokens of the requests completed
within the window over the window.
"""

from __future__ import annotations

import concurrent.futures as cf
import math
import os
import random
import sys
import time

import torch

from perfbench import core, inputs, work
from perfbench.gen import emotion
from perfbench.reference import gpt_plain, served


def _log(msg):
    print(msg, file=sys.stderr, flush=True)


class Runner:
    def __init__(self, cell):
        self.cell, self.mix, self.m = cell, cell.mix, cell.model()
        self.g = work.geometry({"model": self.m})
        self.dtype = torch.bfloat16 if self.m["dtype"] == "bfloat16" \
            else torch.float32

    # ------------------------------------------------------------ requests

    def _requests(self, rng: random.Random, labels, n: int) -> list:
        out = []
        for _ in range(n):
            mapping = emotion.music_params(self.table, labels(rng),
                                           rng.randrange(2**31))
            ids = [self.tok2id[t]
                   for t in emotion.prompt_tokens(self.tok2id, mapping)]
            out.append({"ids": ids, "seed": rng.randrange(2**31),
                        "temp": float(self.mix["temperature"]),
                        "greedy": False})
        for i in rng.sample(range(n), round(self.mix["greedy_share"] * n)):
            out[i]["temp"] = float(self.mix["greedy_temperature"])
            out[i]["greedy"] = True
        return out

    def _schedule(self, rng: random.Random, seconds: float, bursts: bool,
                  rate: float | None = None) -> list:
        """Due times (s from the start) in order, at the mix's rate or at
        ``rate`` a second (bursts included)."""
        size, every = self.mix["burst_size"], self.mix["burst_every_s"]
        burst_times = [every * (k + 0.5) for k in range(int(seconds / every)
                                                        + 1)
                       if bursts and every * (k + 0.5) < seconds]
        poisson = (rate or self.mix["rate_per_s"]) - size / every
        times = [rng.uniform(0, seconds)
                 for _ in range(round(poisson * seconds))]
        times += [t for t in burst_times for _ in range(size)]
        return sorted(times)

    # --------------------------------------------------------------- setup

    def setup(self):
        from eamg_tpu_torch.decode import Generator
        from eamg_tpu_torch.serve.continuous import ContinuousBatcher
        from eamg_tpu_torch.tokenizer import Vocab

        cell, mix = self.cell, self.mix
        self.tok2id = core.load_json(os.path.join(
            cell.root, cell.config["vocab"]))
        self.table = emotion.load_table()
        w = inputs.weights(cell, cell.device, self.dtype)
        self.gen = Generator(w, inputs.gpt_config(self.m),
                             Vocab(self.tok2id), device=cell.device)
        self.engine = ContinuousBatcher(
            self.gen, slots=mix["slots"], chunk=mix["chunk"],
            top_k=mix["top_k"])
        self.max_len = self.engine.max_len
        self.pool = cf.ThreadPoolExecutor(max_workers=mix["max_in_flight"])
        # warm-up: the same requests every run, all at once (fills every
        # slot, captures the chunk's graph, prefills every prompt length)
        warm_rng = random.Random(0)
        warm = self._requests(warm_rng, emotion.LabelDraw(
            self.table, warm_rng, mix["zipf_s"]), mix["warm_requests"])
        self._drive([0.0] * len(warm), warm, wait_s=600)
        rng = random.Random(cell.seed)
        self.rng = rng
        self.labels = emotion.LabelDraw(self.table, rng, mix["zipf_s"])

    # -------------------------------------------------------------- window

    def _one(self, req: dict):
        try:
            ids = self.engine.submit(req["ids"], temperature=req["temp"],
                                     seed=req["seed"],
                                     timeout=self.mix["late_wait_s"] + 600)
            return ids, time.perf_counter()
        except Exception as exc:  # noqa: BLE001 - a failed request counts
            return exc, time.perf_counter()

    def _drive(self, times: list, reqs: list, wait_s: float) -> dict:
        """Send ``reqs`` at ``times`` from now, then wait for them (at
        most ``wait_s`` past the last due time). -> start, lateness (s),
        [(due, request, result or exception, finish)]."""
        start = time.perf_counter()
        late, futs = [], []
        for due, req in zip(times, reqs):
            delay = start + due - time.perf_counter()
            if delay > 0:
                time.sleep(delay)
            late.append(time.perf_counter() - start - due)
            futs.append((due, req, self.pool.submit(self._one, req)))
        deadline = start + (times[-1] if times else 0) + wait_s
        done = []
        for due, req, fut in futs:
            try:
                res, fin = fut.result(timeout=max(deadline
                                                  - time.perf_counter(), 0))
            except cf.TimeoutError:
                res, fin = TimeoutError("never came"), math.inf
            done.append((due, req, res, fin))
        return {"start": start, "late": late, "done": done}

    def _tally(self, run: dict, close: float) -> dict:
        """Latencies, tokens and work of a driven schedule; ``close`` is
        the window's end (s from the start)."""
        lat, failed, tokens, flops = [], 0, 0, 0
        for due, req, res, fin in run["done"]:
            if isinstance(res, Exception):
                failed += 1
                lat.append(math.inf)
                continue
            lat.append((fin - run["start"] - due) * 1000)
            if fin - run["start"] <= close:
                p, n = len(req["ids"]), len(res)
                tokens += n - p
                flops += work.request_flops(self.g, p, n)
        return {"lat": lat, "failed": failed, "tokens": tokens,
                "flops": flops}

    def offered(self, rate: float, seconds: float) -> dict:
        """The mix's arrivals at ``rate`` a second (bursts included) for
        ``seconds``, on the set-up engine, waited out -> the driven run
        (``_drive``) and its tally (``_tally``)."""
        times = self._schedule(self.rng, seconds, bursts=True, rate=rate)
        reqs = self._requests(self.rng, self.labels, len(times))
        run = self._drive(times, reqs, wait_s=self.mix["late_wait_s"])
        return {"run": run, "tally": self._tally(run, seconds)}

    def window(self, seconds: float) -> dict:
        times = self._schedule(self.rng, seconds, bursts=True)
        reqs = self._requests(self.rng, self.labels, len(times))
        self.engine.stats["join_delay_ms"].clear()
        run = self._drive(times, reqs, wait_s=self.mix["late_wait_s"])
        joins = list(self.engine.stats["join_delay_ms"])
        t = self._tally(run, seconds)
        late = sorted(run["late"])
        if late:
            _log(f"[engine_open] {len(times)} requests due in {seconds} s; "
                 f"the generator ran late by p50 "
                 f"{1000 * late[len(late) // 2]:.3f} ms, max "
                 f"{1000 * late[-1]:.3f} ms")
        self.window_run = run
        out = {"attempted": len(times), "failed": t["failed"],
               "e2e": {"request_ms_p95": core.percentile(t["lat"], 95),
                       "gen_tokens_per_s": t["tokens"] / seconds},
               "units": t["tokens"], "wall_s": seconds,
               "flops": t["flops"], "join_delay_ms": joins,
               "dtype": self.m["dtype"]}
        if self.cell.trace:
            # the traced segment's twin, untraced: a stretch of the same
            # arrivals (no burst) on the idle engine, waited out; its wall
            # a token is what the traced busy time a token is set against
            secs = self.mix["trace_seconds"]
            times = self._schedule(self.rng, secs, bursts=False)
            self.segment = (times, self._requests(self.rng, self.labels,
                                                  len(times)))
            twin = self._drive(*self.segment,
                               wait_s=self.mix["late_wait_s"])
            done = [(req, res, fin) for _, req, res, fin in twin["done"]
                    if not isinstance(res, Exception)]
            out["idle_units"] = sum(len(res) - len(req["ids"])
                                    for req, res, _ in done)
            out["idle_wall_s"] = max((fin for _, _, fin in done),
                                     default=twin["start"]) - twin["start"]
        return out

    def traced(self) -> dict:
        """The segment :meth:`window` ran untraced (the same arrivals and
        requests), again: every kernel in the trace is these requests'."""
        run = self._drive(*self.segment, wait_s=self.mix["late_wait_s"])
        tokens = attn = rows = flops = 0
        for _, req, res, _ in run["done"]:
            if isinstance(res, Exception):
                continue
            p, n = len(req["ids"]), len(res)
            tokens += n - p
            flops += work.request_flops(self.g, p, n)
            attn += work.decode_attn_bytes(self.g, p, n, self.m["dtype"])
            rows += p + max(n - p - 1, 0)
        return {"units": tokens, "flops": flops, "decode_attn_bytes": attn,
                "ffn_rows": rows}

    # --------------------------------------------------------------- check

    def release(self):
        self.engine.close()
        self.pool.shutdown(wait=True, cancel_futures=True)
        del self.engine, self.gen
        if self.cell.device.type == "cuda":
            torch.cuda.empty_cache()

    def check(self, window: dict) -> list:
        run, mix = self.window_run, self.mix
        V = self.m["vocab_size"]
        bad = window["failed"]
        greedy, sampled = [], []
        for _, req, res, _ in run["done"]:
            if isinstance(res, Exception):
                continue
            p = len(req["ids"])
            if (res[:p] != req["ids"] or len(res) > self.max_len
                    or any(not 0 <= t < V for t in res)):
                bad += 1
            elif len(res) > p:
                (greedy if req["greedy"] else sampled).append((p, list(res)))
        rng = random.Random(self.cell.seed ^ 0x5EED)
        pick_g = _sample(greedy, mix["check_requests"], rng)
        pick_s = _sample(sampled, mix["check_sampled"], rng)
        dev = self.cell.device
        w32 = gpt_plain.as_dtype(inputs.weights(self.cell, dev, self.dtype),
                                 torch.float32, dev)
        # the control (calibrate.py --fault control): the float8 reference
        # in the program's place
        low = (gpt_plain.fp8_weights(w32) if self.cell.fault == "control"
               else None)
        gaps = served.served_gaps(w32, self.m, pick_g, dev, w_low=low)
        topk = served.served_gaps(w32, self.m, pick_s, dev,
                                  top_k=mix["top_k"], w_low=low)
        n_tok = sum(len(s) - p for p, s in pick_g + pick_s)
        _log(f"[engine_open] reference over {len(pick_g)} greedy requests "
             f"of {len(greedy)} and {len(pick_s)} sampled of {len(sampled)} "
             f"({n_tok} served tokens)")
        limits = mix["limits"]
        return [{"name": "unanswered_or_malformed", "value": bad,
                 "limit": limits["unanswered_or_malformed"]},
                {"name": "empty_sample",
                 "value": int(not pick_g or not pick_s), "limit": 0},
                {"name": "served_gap", "value": max(gaps, default=0.0),
                 "limit": limits["served_gap"]},
                {"name": "topk_gap", "value": max(topk, default=0.0),
                 "limit": limits["topk_gap"]}]


def _sample(seqs: list, k: int, rng: random.Random) -> list:
    """The longest of ``seqs`` and ``k - 1`` more drawn by ``rng``."""
    if not seqs:
        return []
    seqs = sorted(seqs, key=lambda s: -len(s[1]))
    return seqs[:1] + rng.sample(seqs[1:], min(k - 1, len(seqs) - 1))
