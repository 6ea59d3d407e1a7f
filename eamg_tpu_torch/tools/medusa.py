"""Medusa heads: training on a frozen checkpoint, the heads file, its
acceptance probe and the batch-1 timing.

Port of ``eamg_tpu/tools/medusa.py``. A heads file is a plain pickle:
``{"blocks": [{"w": [D, D], "b": [D]}, ...], "n_heads", "ckpt",
"final_loss", "train_seconds", "probe"}`` of numpy float32 arrays, the
probe being the acceptance estimate made at training time (a dict of
floats), so JAX's ``load_medusa_heads`` reads what the port writes and the
other way round. :func:`probe_heads_for_checkpoint` makes a probe for a
heads file without one, as the serving pipeline does: a teacher-forced
forward over held-out rows of the checkpoint's own synthetic distribution.

:func:`train_medusa_heads` trains the heads on the base's hidden states
(``forward_hidden`` under ``no_grad``: the base never changes): per head
the gathered NLL of the token 1 + k ahead, summed over the valid positions
of every head and divided by their count, optax's AdamW with its defaults
(``train/trainer.py::AdamW``), batches in numpy's permutation order of the
seed. The hidden state is promoted to f32 before the heads' product, as
JAX promotes bf16 against the f32 heads. :func:`measure` and
:func:`measure_tree` time plain decoding against linear Medusa (and the
tree verify) at batch 1, as JAX's do.
"""

from __future__ import annotations

import dataclasses
import json
import os
import pickle
import time

import numpy as np
import torch

from ..models.gpt import GPTConfig, _head, forward_hidden
from ..utils.device import resolve_device

@dataclasses.dataclass(frozen=True)
class MedusaSpec:
    n_heads: int = 4
    rows: int = 4000
    epochs: int = 4
    batch: int = 32
    lr: float = 1e-3
    seed: int = 0


# A gamma-4 linear verify step costs about 1.5 plain decode steps on the
# TPU the JAX package measured (its DESIGN.md section 3.9): heads whose
# measured tokens a verify sit under this floor lose throughput there.
VERIFY_PREMIUM_FLOOR = 1.5
# Admission threshold on the probe's estimate: the JAX package's choice,
# between the two shipped artifacts' probes (1.25 flagship, 1.45 B3).
PROBE_WIN_THRESHOLD = 1.35


def load_medusa_heads(path: str) -> dict:
    """A heads pickle -> {"blocks": [{"w", "b"} as f32 CPU tensors]} and,
    when the file carries one, its ``"probe"`` dict."""
    with open(path, "rb") as f:
        raw = pickle.load(f)
    out = {"blocks": [{k: torch.from_numpy(np.asarray(v, np.float32))
                       for k, v in b.items()} for b in raw["blocks"]]}
    if "probe" in raw:
        out["probe"] = raw["probe"]
    return out


@torch.no_grad()
def probe_acceptance(params: dict, cfg: GPTConfig, heads: dict,
                     ids: np.ndarray, pad_id: int) -> dict:
    """Teacher-forced acceptance probe over id rows [N, T]: the base
    head's top-1 rate, each head's, the greedy chain length a verify step
    would accept (tokens a verify = 1 + E[chain]) and the sampled
    estimate from each head's mean Leviathan acceptance sum_y min(p, q)
    against the base distribution k positions on (independence
    approximation). Rows go 8 at a time on the params' device."""
    blocks = heads["blocks"]
    K = len(blocks)
    dev = params["tok_emb"].device
    ids = np.asarray(ids, np.int32)

    def probe(ids_t):
        x = ids_t[:, :-1]
        h = forward_hidden(params, x, cfg)
        base_logits = _head(params, h)                       # [B, T, V]
        base_p = torch.softmax(base_logits, -1)
        y0 = ids_t[:, 1:]
        valid0 = y0 != pad_id
        base_hits = ((base_logits.argmax(-1) == y0) & valid0).sum()
        T = x.shape[1]
        pos = torch.arange(T, device=dev)[None]
        full = (pos < T - K) & (torch.roll(ids_t, -(1 + K), 1)[:, :-1]
                                != pad_id)
        accs, overlaps = [], []
        chain_ok = torch.ones(x.shape, dtype=torch.bool, device=dev)
        chain_sum = 0
        for k, blk in enumerate(blocks, start=1):
            w, b = blk["w"].to(dev), blk["b"].to(dev)
            hf = h.float()
            head_logits = _head(params, hf + torch.nn.functional.silu(
                hf @ w.T + b))
            y = torch.roll(ids_t, -(1 + k), 1)[:, :-1]
            valid = (pos < T - k) & (y != pad_id)
            hit = (head_logits.argmax(-1) == y) & valid
            accs.append((int(hit.sum()), int(valid.sum())))
            chain_ok = chain_ok & hit
            chain_sum += int((chain_ok & full).sum())
            q = torch.softmax(head_logits, -1)
            ov = torch.minimum(torch.roll(base_p, -k, 1), q).sum(-1)
            overlaps.append(float(torch.where(full, ov, 0.0).sum()))
        return (int(base_hits), int(valid0.sum()), accs, chain_sum,
                int(full.sum()), overlaps)

    chunk = max(1, min(8, ids.shape[0]))
    ids = ids[:(ids.shape[0] // chunk) * chunk]
    base_hits = base_n = chain_sum = full_n = 0.0
    head_hits, head_ns, ov_sums = np.zeros(K), np.zeros(K), np.zeros(K)
    for s in range(0, ids.shape[0], chunk):
        bh, bn, ha, cs, fn, ovs = probe(torch.from_numpy(
            ids[s:s + chunk]).long().to(dev))
        base_hits += bh
        base_n += bn
        chain_sum += cs
        full_n += fn
        for i, (hh, hn) in enumerate(ha):
            head_hits[i] += hh
            head_ns[i] += hn
        ov_sums += np.asarray(ovs)
    base_top1 = base_hits / max(base_n, 1.0)
    accs = ov_sums / max(full_n, 1.0)
    run, tpv = 1.0, 1.0
    for a in accs:
        run *= float(a)
        tpv += run
    return {
        "base_top1": round(base_top1, 4),
        "head_top1": [round(h / max(n, 1.0), 4)
                      for h, n in zip(head_hits, head_ns)],
        "head_accept_sampled": [round(float(a), 4) for a in accs],
        "tok_per_verify_est": round(tpv, 3),
        "tok_per_verify_greedy_est": round(
            1.0 + chain_sum / max(full_n, 1.0), 3),
        "oracle_tok_per_verify": round(1.0 / max(1.0 - base_top1, 1e-3), 2),
        "verify_premium_floor": VERIFY_PREMIUM_FLOOR,
        "probe_win_threshold": PROBE_WIN_THRESHOLD,
        "likely_win": bool(tpv >= PROBE_WIN_THRESHOLD),
        "rows": int(ids.shape[0]),
    }


def _corpus_for(ckpt: dict, rows: int, seed: int):
    """Encoded id rows of the checkpoint's scheme (the demo checkpoints'
    own synthetic distributions) and its vocabulary."""
    from ..tokenizer import SchemeB3, Vocab, detect_scheme
    from ..train.data import grid_corpus, synthetic_corpus

    vocab = Vocab(ckpt["vocab"])
    seq_len = ckpt["cfg"].seq_len
    if detect_scheme(vocab) == "b3":
        b3 = SchemeB3(seq_len=seq_len)
        raw = synthetic_corpus(rows, seed=seed, tempo_locked=True)
        return [b3.explode(js) for js in raw], vocab
    enc = []
    for js in grid_corpus(rows, seed=seed):
        toks = [t for t in json.loads(js) if t in vocab][:seq_len]
        enc.append(vocab.encode(toks))
    return enc, vocab


def probe_heads_for_checkpoint(ckpt: dict, heads: dict, rows: int = 24,
                               seed: int = 98765, device=None) -> dict:
    """:func:`probe_acceptance` on fresh rows of the checkpoint's scheme
    (held out from the heads' training by the seed), for a heads file
    without a ``probe``. ``ckpt`` is ``utils.checkpoint.load_checkpoint``'s
    dict; the forward runs on ``device`` (None: the card, or an error on a
    host without one)."""
    from ..decode.api import _to_device
    from ..train.data import pad_rows

    dev = resolve_device(device)
    cfg: GPTConfig = ckpt["cfg"]
    encoded, vocab = _corpus_for(ckpt, rows, seed)
    ids = pad_rows(encoded, cfg.seq_len, vocab.pad_id)
    return probe_acceptance(_to_device(ckpt["params"], dev), cfg, heads, ids,
                            vocab.pad_id)


def medusa_head_loss(base: dict, blocks: list, batch_ids: torch.Tensor,
                     cfg: GPTConfig, pad_id: int) -> torch.Tensor:
    """JAX's ``loss_fn`` of the heads on one [B, T] batch of ids: head k
    at position t predicts ids[t + 1 + k]; the gathered NLL (logsumexp
    less the target's logit) over the valid positions of every head,
    divided by their count. Differentiable in ``blocks`` only: the base's
    hidden states come from ``forward_hidden`` without a graph."""
    x = batch_ids[:, :-1]
    h = forward_hidden(base, x, cfg).float()              # [B, T, D] frozen
    T = x.shape[1]
    pos = torch.arange(T, device=x.device)[None]
    total = count = 0.0
    for k, blk in enumerate(blocks, start=1):
        hk = h + torch.nn.functional.silu(h @ blk["w"].T + blk["b"])
        logits = _head(base, hk)                          # [B, T, V] f32
        y = torch.roll(batch_ids, -(1 + k), 1)[:, :-1].long()
        valid = ((pos < T - k) & (y != pad_id)).to(torch.float32)
        nll = torch.logsumexp(logits, -1) - logits.gather(
            -1, y[..., None])[..., 0]
        total = total + (nll * valid).sum()
        count = count + valid.sum()
    return total / torch.clamp(count, min=1.0)


def head_optimizer(spec: MedusaSpec):
    """optax.adamw(spec.lr) with its defaults (b1 0.9, b2 0.999, eps 1e-8,
    weight decay 1e-4 on every leaf)."""
    from ..train.trainer import AdamW, TrainConfig

    return AdamW(TrainConfig(lr=spec.lr, b1=0.9, b2=0.999,
                             weight_decay=1e-4))


def heads_leaves(blocks: list) -> list:
    return [t for blk in blocks for t in (blk["w"], blk["b"])]


def head_step(base: dict, blocks: list, opt, opt_state: dict,
              batch_ids: torch.Tensor, cfg: GPTConfig,
              pad_id: int) -> torch.Tensor:
    """One AdamW step of the heads on a batch, in place -> the batch's
    loss before the step (a device scalar)."""
    leaves = heads_leaves(blocks)
    for t in leaves:
        t.requires_grad_(True)
    with torch.enable_grad():
        loss = medusa_head_loss(base, blocks, batch_ids, cfg, pad_id)
        grads = torch.autograd.grad(loss, leaves)
    for t in leaves:
        t.requires_grad_(False)
    opt.update(list(grads), opt_state, leaves)
    return loss.detach()


def train_medusa_heads(ckpt_dir: str, out_path: str,
                       spec: MedusaSpec = MedusaSpec(), log_fn=print,
                       device=None) -> dict:
    """Train heads for the checkpoint at ``ckpt_dir`` on ``device`` (None:
    the card) and write JAX's pickle to ``out_path``; -> the pickle's
    dict."""
    from ..decode.api import _to_device
    from ..decode.medusa import init_medusa_heads
    from ..train.data import pad_rows
    from ..utils.checkpoint import load_checkpoint

    t0 = time.time()
    dev = resolve_device(device)
    ckpt = load_checkpoint(ckpt_dir)
    cfg: GPTConfig = ckpt["cfg"]
    assert cfg.causal, "medusa needs the corrected causal architecture"
    base = _to_device(ckpt["params"], dev)
    encoded, vocab = _corpus_for(ckpt, spec.rows, spec.seed)
    ids = pad_rows(encoded, cfg.seq_len, vocab.pad_id)
    blocks = [{k: v.to(dev) for k, v in blk.items()} for blk in
              init_medusa_heads(None, cfg, spec.n_heads)["blocks"]]
    opt = head_optimizer(spec)
    opt_state = opt.init(heads_leaves(blocks))
    rng = np.random.default_rng(spec.seed)
    n = ids.shape[0]
    loss = torch.tensor(float("nan"))
    for epoch in range(spec.epochs):
        order = rng.permutation(n)
        for s in range(0, n - spec.batch + 1, spec.batch):
            batch = torch.from_numpy(ids[order[s:s + spec.batch]]).to(dev)
            loss = head_step(base, blocks, opt, opt_state, batch, cfg,
                             vocab.pad_id)
        log_fn(f"[medusa] epoch {epoch + 1}/{spec.epochs}: "
               f"head_loss={float(loss):.4f}")
    out = {"blocks": [{k: v.cpu().numpy() for k, v in blk.items()}
                      for blk in blocks],
           "n_heads": spec.n_heads, "ckpt": os.path.abspath(ckpt_dir),
           "final_loss": float(loss),
           "train_seconds": round(time.time() - t0, 1)}
    # the acceptance probe on held-out rows (a fresh seed) travels with
    # the heads, so serving can say at start-up whether medusa wins
    probe_rows, _ = _corpus_for(ckpt, min(32, spec.rows), spec.seed + 1)
    out["probe"] = probe_acceptance(
        base, cfg, {"blocks": blocks},
        pad_rows(probe_rows, cfg.seq_len, vocab.pad_id), vocab.pad_id)
    log_fn(f"[medusa] probe: {json.dumps(out['probe'])}")
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    with open(out_path, "wb") as f:
        pickle.dump(out, f)
    log_fn(f"[medusa] saved {spec.n_heads} heads -> {out_path}")
    return out


def _measure_setup(ckpt_dir: str, heads_path: str, device):
    """(params on the device, cfg, heads, vocab, prompt ids, the [1, P]
    prompt): the B3 control prefix of 120 BPM and key 0, or Scheme A's
    start token, as JAX's measure takes them."""
    from ..decode.api import _to_device
    from ..tokenizer import SchemeB3, Vocab, detect_scheme
    from ..utils.checkpoint import load_checkpoint

    dev = resolve_device(device)
    ckpt = load_checkpoint(ckpt_dir)
    cfg: GPTConfig = ckpt["cfg"]
    vocab = Vocab(ckpt["vocab"])
    if detect_scheme(vocab) == "b3":
        prompt_ids = SchemeB3(seq_len=cfg.seq_len).control_prefix(120, 0)
    else:
        prompt_ids = [vocab.tok2id[t] for t in ["[START_SEQUENCE]"]
                      if t in vocab.tok2id]
    prompt = torch.tensor([prompt_ids], dtype=torch.int64, device=dev)
    return (_to_device(ckpt["params"], dev), cfg,
            load_medusa_heads(heads_path), vocab, prompt_ids, prompt)


def measure(ckpt_dir: str, heads_path: str, max_len: int = 256,
            gamma: int = 4, greedy: bool = True, seed: int = 0,
            reps: int = 3, log_fn=print, device=None) -> dict:
    """Batch-1 latency A/B: the plain cached decode against Medusa on the
    same checkpoint and prompt, EOS off on both (fixed-length generations,
    a fair per-token comparison): best-of-``reps`` rates, the speedup and
    tokens a verify step."""
    from ..decode.loop import generate_kv
    from ..decode.medusa import generate_medusa
    from ..utils import prng

    params, cfg, heads, vocab, prompt_ids, prompt = _measure_setup(
        ckpt_dir, heads_path, device)
    plen, rng = len(prompt_ids), prng.PRNGKey(seed)

    def run_plain():
        _, pos = generate_kv(params, prompt, plen, rng, cfg, max_len,
                             greedy=greedy, eos_id=-1, pad_id=vocab.pad_id,
                             refeed_last_prompt=False)
        return int(pos)

    def run_medusa():
        _, pos, n_steps = generate_medusa(
            params, heads, prompt, plen, rng, cfg, max_len, gamma=gamma,
            greedy=greedy, eos_id=-1, pad_id=vocab.pad_id)
        return int(pos), int(n_steps)

    run_plain()
    run_medusa()                                   # builds and captures
    t_plain = min(_timed(run_plain) for _ in range(reps))
    t_med = min(_timed(run_medusa) for _ in range(reps))
    pos_p = run_plain()
    pos_m, n_steps = run_medusa()
    gen_m = pos_m - plen
    out = {
        "plain_tok_s": round((pos_p - plen) / t_plain, 1),
        "medusa_tok_s": round(gen_m / t_med, 1),
        "speedup": round(t_plain / t_med * gen_m / max(pos_p - plen, 1), 3),
        "tokens_per_verify": round(gen_m / max(n_steps, 1), 3),
        "gamma": gamma, "max_len": max_len, "greedy": greedy,
    }
    log_fn(f"[medusa] {json.dumps(out)}")
    return out


def measure_tree(ckpt_dir: str, heads_path: str, max_len: int = 256,
                 tree=None, seed: int = 0, reps: int = 5, log_fn=print,
                 device=None) -> dict:
    """Greedy batch-1 three-way interleaved A/B: the plain cached decode,
    linear Medusa (gamma = the tree's depth) and tree verification, each
    replaying its graphs; reps alternate plain, linear, tree, best of reps
    a side."""
    from ..decode.loop import generate_kv
    from ..decode.medusa import generate_medusa
    from ..decode.medusa_tree import (DEFAULT_TREE, generate_medusa_tree,
                                      tree_tables)
    from ..utils import prng

    tree = tuple(tree) if tree is not None else DEFAULT_TREE
    tb = tree_tables(tree)
    params, cfg, heads, vocab, prompt_ids, prompt = _measure_setup(
        ckpt_dir, heads_path, device)
    plen, rng, gamma = len(prompt_ids), prng.PRNGKey(seed), tb["gamma"]

    def run_plain():
        _, pos = generate_kv(params, prompt, plen, rng, cfg, max_len,
                             greedy=True, eos_id=-1, pad_id=vocab.pad_id,
                             refeed_last_prompt=False)
        return int(pos), 0

    def run_linear():
        _, pos, n = generate_medusa(params, heads, prompt, plen, rng, cfg,
                                    max_len, gamma=gamma, greedy=True,
                                    eos_id=-1, pad_id=vocab.pad_id)
        return int(pos), int(n)

    def run_tree():
        _, pos, n = generate_medusa_tree(params, heads, prompt, plen, cfg,
                                         max_len, tree=tree, eos_id=-1,
                                         pad_id=vocab.pad_id)
        return int(pos), int(n)

    sides = {"plain": run_plain, "linear": run_linear, "tree": run_tree}
    for fn in sides.values():                      # builds and captures
        fn()
    times = {k: [] for k in sides}
    for _ in range(reps):                          # interleaved A/B/C
        for k, fn in sides.items():
            times[k].append(_timed(fn))
    best = {k: min(v) for k, v in times.items()}
    pos_p, _ = run_plain()
    pos_l, steps_l = run_linear()
    pos_t, steps_t = run_tree()
    gen = pos_p - plen
    out = {
        "plain_tok_s": round(gen / best["plain"], 1),
        "linear_tok_s": round((pos_l - plen) / best["linear"], 1),
        "tree_tok_s": round((pos_t - plen) / best["tree"], 1),
        "linear_tokens_per_verify": round((pos_l - plen) / max(steps_l, 1),
                                          3),
        "tree_tokens_per_verify": round((pos_t - plen) / max(steps_t, 1), 3),
        "linear_speedup": round(best["plain"] / best["linear"], 3),
        "tree_speedup": round(best["plain"] / best["tree"], 3),
        # verify-step premium: the tree step's time over the plain step's
        "tree_step_premium": round((best["tree"] / max(steps_t, 1))
                                   / (best["plain"] / max(gen, 1)), 3),
        "tree_nodes": tb["N"], "gamma": gamma, "max_len": max_len,
        "reps": reps,
        "spread_ms": {k: [round(t * 1000, 1) for t in v]
                      for k, v in times.items()},
    }
    log_fn(f"[medusa-tree] {json.dumps(out)}")
    return out


def _timed(fn) -> float:
    """Seconds of ``fn()``, whose result is read on the host (the decodes
    return host values, so the device is done when it returns)."""
    t0 = time.perf_counter()
    fn()
    return time.perf_counter() - t0
