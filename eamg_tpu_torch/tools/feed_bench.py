"""Host data-pipeline feed rate at corpus scale: does the host feed the
card as fast as the trainer consumes?

Port of ``eamg_tpu/tools/feed_bench.py``. Three numbers:

1. ``host_tokens_per_s``: the C++ loader's CSV -> exploded -> padded id
   rate over the whole synthetic corpus (``tools/native_loader.py``), and
   the Python tokenizer's on a slice (``python_tokens_per_s``);
2. ``device_tokens_per_s``: the trainer's demand, target tokens a step
   over the flagship geometry's step time on ``device`` (bf16, the
   trainer's chunked CE), best of three 40-step windows;
3. ``streamed_step_ms``: steps fed by ``train/prefetch.py``'s thread
   exploding shard k+1 while the card trains on shard k
   (``overlap_overhead_pct`` is its cost over the resident batch).

The corpus is written once under the temporary directory and reused.
"""

from __future__ import annotations

import os
import tempfile
import time

from ..models.gpt import GPTConfig, init_params
from ..tokenizer import SchemeB2
from ..train.data import write_synthetic_csv
from ..train.prefetch import PrefetchIterator, to_device
from ..train.trainer import TrainConfig, Trainer
from ..utils import prng
from ..utils.device import resolve_device
from .native_loader import explode_csv, native_available


def _ensure_corpus(rows: int, notes: int, shards: int,
                   base: str | None = None) -> list[str]:
    """``shards`` CSV files of rows/shards songs each (cached)."""
    base = base or os.path.join(tempfile.gettempdir(), "eamg_torch_feed")
    paths = []
    per = rows // shards
    for s in range(shards):
        p = f"{base}_{rows}x{notes}_{s:02d}of{shards}.csv"
        if not os.path.exists(p):
            tmp = f"{p}.{os.getpid()}.tmp"
            write_synthetic_csv(tmp, per, seed=s, n_notes=notes)
            os.replace(tmp, p)
        paths.append(p)
    return paths


def run_feed_bench(rows: int = 100_000, notes: int = 126,
                   seq_len: int = 512, micro_batch: int = 16,
                   steps: int = 200, shards: int = 16,
                   loss_chunk: int | None = 73, d_model: int = 512,
                   n_head: int = 8, n_layer: int = 6, device=None) -> dict:
    device = resolve_device(device)
    sch = SchemeB2(seq_len=seq_len)
    paths = _ensure_corpus(rows, notes, shards)
    csv_bytes = sum(os.path.getsize(p) for p in paths)

    # ---- 1. host rate: native explode over the whole corpus ----------
    t0 = time.perf_counter()
    shard_ids = []
    total_tokens = 0
    for p in paths:
        ids, lens = explode_csv(p, scheme="b2", seq_len=seq_len)
        total_tokens += int(lens.sum())
        shard_ids.append(ids)
    host_s = time.perf_counter() - t0
    host_rate = total_tokens / host_s

    # the Python tokenizer's rate on one shard (the native speed-up)
    from ..train.data import iter_csv_tokens

    t0 = time.perf_counter()
    py_tokens = 0
    for js in iter_csv_tokens(paths[0], max_rows=2000):
        py_tokens += len(sch.explode(js))
    py_rate = py_tokens / (time.perf_counter() - t0)

    # ---- 2. the card's demand: the step time on a resident batch -----
    cfg = GPTConfig(vocab_size=len(sch.vocab), seq_len=seq_len,
                    d_model=d_model, n_head=n_head, n_layer=n_layer,
                    causal=True, dtype="bfloat16")
    tcfg = TrainConfig(micro_batch=micro_batch, epochs=1,
                       pad_id=sch.vocab.pad_id, loss_chunk=loss_chunk)
    trainer = Trainer(cfg, tcfg, init_params(prng.PRNGKey(0), cfg,
                                             device=device), device=device)
    ids0 = shard_ids[0][:micro_batch]
    # Trainer.train_step takes [accum, micro, T] batches (accum = 1)
    x0 = to_device(ids0[None, :, :-1], device)
    y0 = to_device(ids0[None, :, 1:], device)
    trainer.train_step(x0, y0, sync=True)          # build, warm up
    windows = []
    for _ in range(3):
        t0 = time.perf_counter()
        for _ in range(40):
            m = trainer.train_step(x0, y0, sync=False)
        _ = float(m["loss"])                       # drain the stream
        windows.append((time.perf_counter() - t0) / 40 * 1000)
    dev_step_ms = min(windows)
    tokens_per_step = micro_batch * (seq_len - 1)
    dev_rate = tokens_per_step / (dev_step_ms / 1000)

    # ---- 3. overlap: stream shards through the prefetch thread -------
    def host_stream():
        """The host's work a shard: CSV parse, explode and pad, then the
        per-batch shift and split, as train/run.py does."""
        s = 0
        while True:
            ids, _ = explode_csv(paths[s % shards], scheme="b2",
                                 seq_len=seq_len)
            for b in range(0, len(ids) - micro_batch + 1, micro_batch):
                chunk = ids[b:b + micro_batch]
                yield chunk[None, :, :-1], chunk[None, :, 1:]
            s += 1

    it = PrefetchIterator(host_stream(), depth=2, device=device)
    for _ in range(3):                             # fill the queue
        x, y = next(it)
        trainer.train_step(x, y, sync=False)
    t0 = time.perf_counter()
    for _ in range(steps):
        x, y = next(it)
        m = trainer.train_step(x, y, sync=False)
    _ = float(m["loss"])
    stream_step_ms = (time.perf_counter() - t0) / steps * 1000

    return {
        "rows": rows, "csv_mb": round(csv_bytes / 1e6, 1),
        "corpus_tokens": total_tokens,
        "native_loader": native_available(),
        "host_tokens_per_s": round(host_rate),
        "python_tokens_per_s": round(py_rate),
        "device_step_ms": round(dev_step_ms, 2),
        "device_tokens_per_s": round(dev_rate),
        "host_over_demand": round(host_rate / dev_rate, 2),
        "streamed_step_ms": round(stream_step_ms, 2),
        "overlap_overhead_pct": round(
            (stream_step_ms / dev_step_ms - 1) * 100, 1),
    }
