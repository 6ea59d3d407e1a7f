"""The PyTorch side of tests/test_torch_tracing.py, run in a SUBPROCESS
(torch stays out of the pytest process, tests/conftest.py):

    python tests/torch_port_tracing.py OUT.json

Runs the port's spans (``eamg_tpu_torch/utils/logging.py``) on the CPU,
with and without a ``torch.profiler`` session, over a tiny engine, a tiny
solo decode and a tiny training step, and writes what it saw as JSON.
"""

from __future__ import annotations

import json
import os
import sys
import tempfile
import threading
import time
import types

import torch
from torch.profiler import ProfilerActivity, profile, record_function

from eamg_tpu_torch.decode import Generator
from eamg_tpu_torch.models.gpt import GPTConfig, init_params
from eamg_tpu_torch.serve.continuous import ContinuousBatcher
from eamg_tpu_torch.serve.pipeline import Pipeline
from eamg_tpu_torch.tokenizer import Vocab
from eamg_tpu_torch.train.prefetch import PrefetchIterator
from eamg_tpu_torch.train.trainer import TrainConfig, Trainer
from eamg_tpu_torch.utils.logging import profiler_trace, span, spans

CFG = GPTConfig(vocab_size=64, seq_len=48, d_model=32, n_head=4, n_layer=1,
                n_kv_heads=2, causal=True)
SLOTS, CHUNK, MAX_LEN = 3, 4, 32
PROMPTS = [[10 + i, 20 + i, 30] for i in range(5)]
WAIT = 120


def _session():
    return profile(activities=[ProfilerActivity.CPU])


def _generator(params):
    vocab = Vocab({f"t{i}": i for i in range(CFG.vocab_size)})
    return Generator(params, CFG, vocab, eos_token="t5", pad_token="t0",
                     device="cpu")


def _engine_work(eng) -> dict:
    """The PROMPTS submitted at once from threads of their own -> {index:
    ids}."""
    res = {}

    def hit(i):
        res[i] = eng.submit(PROMPTS[i], seed=i, timeout=WAIT)

    threads = [threading.Thread(target=hit, args=(i,))
               for i in range(len(PROMPTS))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(WAIT)
    assert not any(t.is_alive() for t in threads), "a request hung"
    return res


def _train_step(trainer):
    g = torch.Generator().manual_seed(5)
    x = torch.randint(1, CFG.vocab_size, (2, 1, 2, 16), generator=g)
    y = torch.randint(1, CFG.vocab_size, (2, 1, 2, 16), generator=g)
    for xb, yb in PrefetchIterator(zip(x, y), depth=1):
        trainer.train_step(xb, yb, sync=False)


def _record(s) -> dict:
    return {"name": s.name, "start": s.start_ns, "end": s.end_ns,
            "tid": s.tid, "parent": s.parent, "rid": s.rid,
            "counts": s.counts}


def main(out_path: str) -> None:
    torch.manual_seed(0)
    out = {}
    params = init_params(torch.Generator().manual_seed(0), CFG)
    gen = _generator(params)
    trainer = Trainer(CFG, TrainConfig(micro_batch=2), params, device="cpu")

    # --- no session: the same work leaves nothing, and ms is written
    eng = ContinuousBatcher(gen, slots=SLOTS, chunk=CHUNK, max_len=MAX_LEN,
                            top_k=10)
    ms = {}
    with span("t.outer", ms=ms):
        _engine_work(eng)
        gen.generate_ids(PROMPTS[0], max_len=24, seed=2, top_k=10)
        _train_step(trainer)
    with span("t.outer", ms=ms):
        pass
    out["off"] = {"spans": len(spans()), "ms": ms}

    # --- a thread started before the session, bracketed by the main one
    go, done = threading.Event(), threading.Event()
    seen = {}

    def worker():
        go.wait(WAIT)
        seen["tid"] = threading.get_native_id()
        with span("t.outer"):
            with span("t.work", rid=7, n=3):
                time.sleep(0.002)
        done.set()

    thread = threading.Thread(target=worker)
    thread.start()
    with _session() as prof:
        with record_function("t.bracket"):
            go.set()
            done.wait(WAIT)
    thread.join(WAIT)
    bracket = [e for e in prof.profiler.kineto_results.events()
               if e.name() == "t.bracket"][0]
    out["thread"] = {"tid": seen["tid"],
                     "bracket": [bracket.start_ns(),
                                 bracket.start_ns() + bracket.duration_ns()],
                     "spans": [_record(s) for s in spans()]}

    # --- the engine under a session
    assert eng.drain(WAIT), "the engine did not go idle"
    for k in ("row_steps", "live_row_steps", "row_tokens"):
        eng.stats[k] = 0
    chunks0 = eng.stats["chunks"]
    with _session():
        res = _engine_work(eng)
        eng.drain(WAIT)
    eng.close()
    out["engine"] = {
        "spans": [_record(s) for s in spans()],
        "served_tokens": sum(len(res[i]) - len(PROMPTS[i]) for i in res),
        "requests": len(res), "chunks": eng.stats["chunks"] - chunks0,
        "chunk": CHUNK, "slots": SLOTS, "row_steps": eng.stats["row_steps"],
        "stats": {k: v for k, v in eng.stats.items()
                  if isinstance(v, int)}}

    # --- the solo decode and a training step under a session
    with _session():
        gen.generate_ids(PROMPTS[0], max_len=CFG.seq_len, seed=2,
                         top_k=10)
        _train_step(trainer)
        with Pipeline._locked(types.SimpleNamespace(
                _lock=threading.Lock())):
            pass
    out["solo_train"] = [_record(s) for s in spans()]

    # --- /profile's trace holds the spans of a thread it does not trace
    go.clear()
    done.clear()
    thread = threading.Thread(target=worker)
    thread.start()
    with tempfile.TemporaryDirectory() as tmp:
        with profiler_trace(tmp):
            go.set()
            done.wait(WAIT)
        thread.join(WAIT)
        with open(os.path.join(tmp, "trace.json"), encoding="utf-8") as f:
            events = json.load(f)["traceEvents"]
    out["profile"] = {"tid": seen["tid"], "events": [
        e for e in events if e.get("cat") == "span"]}

    with open(out_path, "w", encoding="utf-8") as f:
        json.dump(out, f)


if __name__ == "__main__":
    main(sys.argv[1])
