"""The paper's §10.4 ablation table (PPL / MSE-Tune / ms a token), one
command.

Port of ``eamg_tpu/tools/ablation.py``. Three variants are trained with
the port's trainer on the synthetic tempo-locked corpus (or a Lakh CSV
given as ``csv_path``), and four rows evaluated: held-out teacher-forced
perplexity (``decode/replay.py::perplexity``) and the tempo-conditioning
error of sampled songs (``tools/metrics.py``, through
``Generator.generate_ids``):

- **full**: Scheme-B3 (50 ms bins, BPM/KEY control tokens), cached decode;
- **- KV cache**: the same model decoded by the uncached loop
  (``use_cache=False``): the same PPL by construction, the cost is in
  ms/token;
- **- emotion tokens**: retrained with the control prefix stripped
  (unconditioned generation);
- **- fine bins**: retrained at 200 ms onset/duration buckets.

Everything runs on ``device`` (None means CUDA).
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field


@dataclass
class AblationRow:
    name: str
    ppl: float
    mse_tune: float
    ms_per_token: float
    train_steps: int = 0
    final_loss: float = float("nan")
    notes: str = ""


@dataclass
class AblationConfig:
    # data
    csv_path: str | None = None        # real Lakh corpus (paper scale)
    n_rows: int = 384                  # synthetic rows when csv_path absent
    max_rows: int | None = None        # cap on CSV rows
    eval_frac: float = 0.125
    # Gaussian micro-timing on synthetic onsets/offsets (ms); 0 keeps the
    # grid-pure corpus
    jitter_ms: float = 0.0
    # BPM set of the synthetic corpus (None = uniform 60..180)
    bpm_set: tuple | None = None
    # the motif-structured corpus (train/data.py::grid_song)
    motif_corpus: bool = False
    # model geometry (small by default; paper scale = large2 geometry)
    seq_len: int = 96
    d_model: int = 128
    n_head: int = 4
    n_layer: int = 2
    # training
    epochs: int = 4
    micro_batch: int = 16
    lr: float = 3e-4
    seed: int = 0
    # MSE-Tune generation
    bpm_targets: tuple = (70, 90, 110, 130, 150, 180)
    gen_batch: int = 4
    dtype: str = "float32"
    log_fn: object = field(default=print)


def _train_variant(rows, scheme, strip_controls, acfg: AblationConfig,
                   device):
    """Train one model variant; returns (params, cfg, vocab, eval_ids,
    steps, final_loss)."""
    from ..models.gpt import GPTConfig, init_params
    from ..tokenizer.scheme_b import SchemeB2
    from ..train.data import batches, pad_rows
    from ..train.trainer import TrainConfig, Trainer
    from ..utils import prng

    explode = (lambda js: SchemeB2.explode(scheme, js)) if strip_controls \
        else scheme.explode
    encoded = [explode(js) for js in rows]
    n_eval = max(1, int(len(encoded) * acfg.eval_frac))
    train_ids, eval_ids = encoded[n_eval:], encoded[:n_eval]

    vocab = scheme.vocab
    cfg = GPTConfig(vocab_size=len(vocab), seq_len=acfg.seq_len,
                    d_model=acfg.d_model, n_head=acfg.n_head,
                    n_layer=acfg.n_layer, causal=True, dtype=acfg.dtype)
    tcfg = TrainConfig(lr=acfg.lr, micro_batch=acfg.micro_batch,
                       epochs=acfg.epochs, pad_id=vocab.pad_id)
    params = init_params(prng.PRNGKey(acfg.seed), cfg, device=device)
    trainer = Trainer(cfg, tcfg, params, device=device)
    loss = float("nan")
    for epoch in range(tcfg.epochs):
        for x, y in batches(train_ids, cfg.seq_len, vocab.pad_id,
                            tcfg.micro_batch, drop_last=False,
                            shuffle_seed=acfg.seed + epoch):
            loss = trainer.train_step(x, y, sync=False)["loss"]
    loss = float(loss)

    eval_padded = pad_rows(eval_ids, cfg.seq_len, vocab.pad_id)
    return trainer.params, cfg, vocab, eval_padded, trainer.step, loss


def _mse_and_speed(params, cfg, scheme, acfg: AblationConfig,
                   conditioned: bool, use_cache: bool, device):
    """Generate at each target BPM; returns (mse_tune, ms_per_token)."""
    from ..decode.api import Generator
    from ..tokenizer.scheme_b import key_to_idx
    from .metrics import estimate_bpm, tempo_mse

    gen = Generator(params, cfg, scheme.vocab, eos_token="[END_SEQ]",
                    device=device)
    key_idx = key_to_idx("C major")
    pairs, total_tokens, total_s = [], 0, 0.0
    for bi, bpm in enumerate(acfg.bpm_targets):
        if conditioned:
            prompt = scheme.control_prefix(bpm, key_idx)
        else:
            prompt = [scheme.vocab.tok2id["[START_SEQ]"]]
        kwargs = dict(temperature=1.0, top_k=50, seed=acfg.seed + bi,
                      batch=acfg.gen_batch, use_cache=use_cache)
        if bi == 0:
            gen.generate_ids(prompt, **kwargs)  # build outside the clock
        t0 = time.perf_counter()
        out = gen.generate_ids(prompt, **kwargs)
        dt = time.perf_counter() - t0
        total_s += dt
        total_tokens += out.shape[0] * max(out.shape[1] - len(prompt), 1)
        for row in out:
            song = scheme.decode_to_song(row)
            pairs.append((float(bpm), estimate_bpm(song)))
    ms_per_token = 1000.0 * total_s / max(total_tokens, 1)
    return tempo_mse(pairs), ms_per_token


def _corpus(acfg: AblationConfig) -> list:
    from ..train.data import iter_csv_tokens, synthetic_corpus

    if acfg.csv_path:
        return list(iter_csv_tokens(acfg.csv_path, max_rows=acfg.max_rows))
    if acfg.motif_corpus:
        import json
        import random

        from ..train.data import grid_song, motif_library

        rng = random.Random(acfg.seed)
        lib = motif_library(40, seed=7)
        bpms = acfg.bpm_set or (60, 75, 100, 120, 150)
        return [json.dumps(grid_song(rng, lib, bpm=float(rng.choice(bpms)),
                                     max_units=40))
                for _ in range(acfg.n_rows)]
    return synthetic_corpus(acfg.n_rows, seed=acfg.seed, tempo_locked=True,
                            jitter_ms=acfg.jitter_ms, bpm_set=acfg.bpm_set)


def run_ablation(acfg: AblationConfig | None = None,
                 device=None) -> list[AblationRow]:
    """Train the three variants and evaluate the four rows on ``device``
    (None means CUDA)."""
    from ..decode.replay import perplexity
    from ..tokenizer.scheme_b import SchemeB3
    from ..utils.device import resolve_device

    acfg = acfg or AblationConfig()
    device = resolve_device(device)
    log = acfg.log_fn
    rows = _corpus(acfg)
    kind = ("csv" if acfg.csv_path else
            "synthetic motif-grid" if acfg.motif_corpus else
            "synthetic tempo-locked")
    log(f"[ablate] corpus: {len(rows)} rows ({kind}"
        f"{f', jitter {acfg.jitter_ms:g} ms' if acfg.jitter_ms else ''})")

    variants = {
        "full": (SchemeB3(seq_len=acfg.seq_len, res_ms=50), False),
        "- emotion tokens": (SchemeB3(seq_len=acfg.seq_len, res_ms=50),
                             True),
        "- fine bins": (SchemeB3(seq_len=acfg.seq_len, res_ms=200), False),
    }
    trained = {}
    for name, (scheme, strip) in variants.items():
        t0 = time.perf_counter()
        trained[name] = _train_variant(rows, scheme, strip, acfg, device)
        log(f"[ablate] trained {name!r}: {trained[name][4]} steps, "
            f"loss {trained[name][5]:.3f} "
            f"({time.perf_counter() - t0:.0f}s)")

    out = []
    for name, use_cache, src in (("full", True, "full"),
                                 ("- KV cache", False, "full"),
                                 ("- emotion tokens", True,
                                  "- emotion tokens"),
                                 ("- fine bins", True, "- fine bins")):
        params, cfg, vocab, eval_ids, steps, loss = trained[src]
        scheme, strip = variants[src]
        ppl = perplexity(params, cfg, eval_ids, pad_id=vocab.pad_id)
        mse, ms_tok = _mse_and_speed(params, cfg, scheme, acfg,
                                     conditioned=not strip,
                                     use_cache=use_cache, device=device)
        note = {"full": "KV-cache decode",
                "- KV cache": "same model, uncached O(T²) decode",
                "- emotion tokens": "no BPM/KEY controls (unconditioned)",
                "- fine bins": "200 ms buckets (vs 50 ms)"}[name]
        row = AblationRow(name=name, ppl=ppl, mse_tune=mse,
                          ms_per_token=ms_tok, train_steps=steps,
                          final_loss=loss, notes=note)
        log(f"[ablate] {name}: PPL {ppl:.3f}  MSE-Tune {mse:.4f}  "
            f"{ms_tok:.3f} ms/token")
        out.append(row)
    return out


def markdown_table(rows: list[AblationRow]) -> str:
    """Paper-§10.4-shaped table (MOS omitted: it needs human raters)."""
    lines = ["| Model | PPL ↓ | MSE-Tune ↓ | ms/token ↓ | notes |",
             "|---|---|---|---|---|"]
    for r in rows:
        lines.append(f"| {r.name} | {r.ppl:.3f} | {r.mse_tune:.4f} | "
                     f"{r.ms_per_token:.3f} | {r.notes} |")
    return "\n".join(lines)
