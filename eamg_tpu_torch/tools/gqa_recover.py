"""GQA conversion and recovery: what pooling the K/V heads costs in
held-out perplexity, and how much a short uptraining buys back.

Port of ``eamg_tpu/tools/gqa_recover.py``, composed of the port's parts:

1. the held-out perplexity of the MHA checkpoint (``replay.perplexity``:
   K1, K2) and its decode rate (``generate_kv`` at batch 8: K1, K3, K4);
2. the K/V head groups mean-pooled (``models/gqa_convert.py``), the same
   two measures of the converted model;
3. a short uptraining (``train/trainer.py::Trainer``) on the Scheme-B3
   synthetic corpus the packaged demo was trained on, then the perplexity
   again.

``cli gqa-recover`` runs it on the packaged B3 demo or any Scheme-B3
checkpoint and prints the returned dict as JSON, under JAX's keys.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class RecoveryConfig:
    ckpt_dir: str
    kv_heads: int = 2
    out_dir: str | None = None       # save the recovered checkpoint here
    rows: int = 2000                 # synthetic corpus size
    # False is the packaged demo's training distribution
    tempo_locked: bool = False
    seed: int = 0
    eval_frac: float = 0.05
    steps: int = 200                 # uptraining steps
    lr: float = 1e-4
    micro_batch: int = 16
    bench_batch: int = 8             # decode-rate measurement
    bench_iters: int = 3
    log_fn: object = print


def _decode_toks_per_sec(params, cfg, rcfg, n_gen, device) -> float:
    """Tokens a second of batch ``bench_batch`` decoding ``n_gen`` tokens
    after a 3-token prompt (the best of ``bench_iters`` timed runs after
    one that captures the graphs)."""
    from ..decode.loop import generate_kv
    from ..utils import prng

    prompt = np.zeros((rcfg.bench_batch, 4), np.int64)
    prompt[:, :3] = [[1, 5, 9]]
    pt = torch.from_numpy(prompt).to(device)

    def run(seed):
        buf, _ = generate_kv(params, pt, 3, prng.PRNGKey(seed), cfg,
                             3 + n_gen, temperature=1.0, top_k=50,
                             eos_id=-1, pad_id=0, refeed_last_prompt=False)
        buf.cpu()  # the fetch waits for the decode

    run(0)
    ts = []
    for i in range(rcfg.bench_iters):
        t0 = time.perf_counter()
        run(i + 1)
        ts.append(time.perf_counter() - t0)
    return rcfg.bench_batch * n_gen / min(ts)


def run_gqa_recovery(rcfg: RecoveryConfig, device=None) -> dict:
    """The workflow above on ``device`` (None: the card) -> {"kv_heads",
    "ppl_mha", "ppl_converted", "ppl_recovered", "decode_tok_s_mha",
    "decode_tok_s_gqa", "speedup", "uptrain_steps"}."""
    from ..decode.replay import perplexity
    from ..models.gqa_convert import convert_mha_to_gqa
    from ..train.data import batches, pad_rows, synthetic_corpus
    from ..train.run import encode_corpus
    from ..train.trainer import TrainConfig, Trainer, tree_map
    from ..utils.checkpoint import load_checkpoint, save_checkpoint
    from ..utils.device import resolve_device

    device = resolve_device(device)
    log = rcfg.log_fn
    ckpt = load_checkpoint(rcfg.ckpt_dir)
    cfg, vocab_tok2id = ckpt["cfg"], ckpt["vocab"]
    params = tree_map(lambda p: p.to(device), ckpt["params"])

    rows = synthetic_corpus(rcfg.rows, seed=rcfg.seed,
                            tempo_locked=rcfg.tempo_locked)
    encoded, vocab = encode_corpus(rows, "b3", cfg.seq_len)
    if len(vocab) != cfg.vocab_size:
        raise ValueError(
            f"checkpoint vocab {cfg.vocab_size} != Scheme-B3 {len(vocab)}: "
            "gqa-recover targets Scheme-B3 checkpoints (the packaged demo)")
    n_eval = max(1, int(len(encoded) * rcfg.eval_frac))
    train_ids, eval_ids = encoded[n_eval:], encoded[:n_eval]
    eval_padded = pad_rows(eval_ids, cfg.seq_len, vocab.pad_id)

    n_gen = cfg.n_pos - 3
    ppl_mha = perplexity(params, cfg, eval_padded, pad_id=vocab.pad_id)
    tok_s_mha = _decode_toks_per_sec(params, cfg, rcfg, n_gen, device)
    log(f"[gqa] MHA ({cfg.n_head} KV heads): PPL {ppl_mha:.3f}, "
        f"decode {tok_s_mha:,.0f} tok/s (batch {rcfg.bench_batch})")

    gqa_params, gqa_cfg = convert_mha_to_gqa(params, cfg, rcfg.kv_heads)
    ppl_conv = perplexity(gqa_params, gqa_cfg, eval_padded,
                          pad_id=vocab.pad_id)
    tok_s_gqa = _decode_toks_per_sec(gqa_params, gqa_cfg, rcfg, n_gen,
                                     device)
    log(f"[gqa] converted GQA-{rcfg.kv_heads} (mean-pooled): "
        f"PPL {ppl_conv:.3f}, decode {tok_s_gqa:,.0f} tok/s")

    tcfg = TrainConfig(lr=rcfg.lr, micro_batch=rcfg.micro_batch,
                       pad_id=vocab.pad_id)
    trainer = Trainer(gqa_cfg, tcfg, gqa_params, device=device)
    loss = float("nan")
    epoch = 0
    while trainer.step < rcfg.steps:
        for x, y in batches(train_ids, gqa_cfg.seq_len, vocab.pad_id,
                            tcfg.micro_batch, drop_last=False,
                            shuffle_seed=rcfg.seed + epoch):
            loss = trainer.train_step(x, y, sync=False)["loss"]
            if trainer.step >= rcfg.steps:
                break
        epoch += 1
    loss = float(loss)
    ppl_ft = perplexity(trainer.params, gqa_cfg, eval_padded,
                        pad_id=vocab.pad_id)
    log(f"[gqa] after {trainer.step} uptraining steps (lr {rcfg.lr}): "
        f"PPL {ppl_ft:.3f} (final loss {loss:.3f})")

    if rcfg.out_dir:
        save_checkpoint(rcfg.out_dir, trainer.params, vocab_tok2id,
                        gqa_cfg, step=trainer.step,
                        extra={"gqa_recovered_from": rcfg.ckpt_dir,
                               "uptrain_steps": trainer.step})
        log(f"[gqa] recovered checkpoint -> {rcfg.out_dir}")

    return {
        "kv_heads": rcfg.kv_heads,
        "ppl_mha": round(ppl_mha, 4),
        "ppl_converted": round(ppl_conv, 4),
        "ppl_recovered": round(ppl_ft, 4),
        "decode_tok_s_mha": round(tok_s_mha, 1),
        "decode_tok_s_gqa": round(tok_s_gqa, 1),
        "speedup": round(tok_s_gqa / tok_s_mha, 3),
        "uptrain_steps": trainer.step,
    }
