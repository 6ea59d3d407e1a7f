"""Medusa heads: the loader of a heads file and its acceptance probe.

Port of the serving half of ``eamg_tpu/tools/medusa.py``. A heads file is
a plain pickle: ``{"blocks": [{"w": [D, D], "b": [D]}, ...], "n_heads",
...}`` of numpy float32 arrays, and, when the heads were trained with one,
``"probe"``: the acceptance estimate made at training time (a dict of
floats). :func:`probe_heads_for_checkpoint` makes one for a heads file
without it, as the serving pipeline does: a teacher-forced forward over
held-out rows of the checkpoint's own synthetic distribution. Training the
heads and the batch-1 timing (``train_medusa_heads``, ``measure``) are
not in the port yet.
"""

from __future__ import annotations

import json
import pickle

import numpy as np
import torch

from ..models.gpt import GPTConfig, _head, forward_hidden

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
                               seed: int = 98765, device="cpu") -> dict:
    """:func:`probe_acceptance` on fresh rows of the checkpoint's scheme
    (held out from the heads' training by the seed), for a heads file
    without a ``probe``. ``ckpt`` is ``utils.checkpoint.load_checkpoint``'s
    dict; the forward runs on ``device``."""
    from ..decode.api import _to_device
    from ..train.data import pad_rows

    cfg: GPTConfig = ckpt["cfg"]
    encoded, vocab = _corpus_for(ckpt, rows, seed)
    ids = pad_rows(encoded, cfg.seq_len, vocab.pad_id)
    return probe_acceptance(_to_device(ckpt["params"], torch.device(device)),
                            cfg, heads, ids, vocab.pad_id)
