"""Train the product-path neural emotion classifier from scratch.

Port of ``eamg_tpu/emotion/train_scratch.py``: the same recipe
(``ScratchSpec``, JAX's defaults), corpus, vocabulary, random streams and
loss, under autograd on one device:

- ``classifier_loss``: label-smoothed cross entropy; with pool "max" and
  ``cue_suppress`` > 0, plus the squared hinge on non-cue tokens'
  positive non-neutral logits;
- ``mlm_loss``: the masked tokens' NLL through the tied ``word_emb``;
- ``mlm_pretrain`` and ``distill_classifier``: optax's ``adamw`` over
  ``warmup_cosine_decay_schedule`` (``train/trainer.py::AdamW`` and
  ``lr_schedule``), the tail batch dropped, each epoch re-encoded on the
  host with piece dropout;
- the output directory of JAX's layout: ``params.pkl`` (a float16 numpy
  tree), ``config.pkl``, ``vocab.txt`` and ``metrics.json`` (non-finite
  values as null), which either package's ``EmotionClassifier`` reads.

A step reads nothing back from the device; the steps come from
``make_classifier_step`` and ``make_mlm_step``.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import pickle
import random
import time

import numpy as np
import torch
import torch.nn.functional as F

from ..models import distilbert as db
from ..train.trainer import (AdamW, TrainConfig, tree_leaves, tree_map,
                             tree_unflatten)
from ..utils import prng
from ..utils.device import resolve_device
from .config import ID2LABEL
from .distill_data import OOD_EVAL, build_wordpiece_vocab, make_corpus, \
    tokenizer_corpus
from .lexicon import predict_label as lexicon_predict

NEUTRAL_ID = {v: k for k, v in ID2LABEL.items()}["neutral"]


@dataclasses.dataclass(frozen=True)
class ScratchSpec:
    dim: int = 192
    n_layers: int = 3
    n_heads: int = 4
    hidden_dim: int = 512
    max_length: int = 64
    lr: float = 3e-4
    weight_decay: float = 0.01
    batch: int = 64
    epochs: int = 12
    seed: int = 42
    n_per_label: int = 1200   # rows a label
    label_smoothing: float = 0.05
    pool: str = "cls"
    piece_dropout: float = 0.15  # P(word -> random stem split) in training
    # pool "max" only: weight of the penalty on non-cue tokens' positive
    # non-neutral logits (0 disables)
    cue_suppress: float = 0.0
    # MLM pretraining epochs of the trunk on the train split (0 disables)
    pretrain_epochs: int = 0
    mask_prob: float = 0.15
    # situation-generator training rows a label (None: n_per_label // 2)
    gen_per_label: int | None = 0


def _encode_all(tok, texts, max_length, rng=None, piece_dropout=0.0,
                cues=None):
    enc = [tok.encode(t, max_length, rng=rng, piece_dropout=piece_dropout,
                      cue=cues[i] if cues is not None else None)
           for i, t in enumerate(texts)]
    out = (np.stack([e["input_ids"] for e in enc]),
           np.stack([e["attention_mask"] for e in enc]))
    if cues is not None:
        return out + (np.stack([e["cue_mask"] for e in enc]),)
    return out


def _device_of(params) -> torch.device:
    return tree_leaves(params)[0].device


def _accuracy(params, cfg, tok, texts, labels, max_length, batch=256,
              top_k=1):
    if not texts:     # e.g. eval_gen_schemas with gen_per_label=0
        return float("nan")
    dev = _device_of(params)
    ids, mask = _encode_all(tok, texts, max_length)
    hits = 0
    for s in range(0, len(texts), batch):
        logits = db.forward(params,
                            torch.from_numpy(ids[s:s + batch]).to(dev),
                            torch.from_numpy(mask[s:s + batch]).to(dev),
                            cfg)
        y = torch.from_numpy(np.asarray(labels[s:s + batch],
                                        np.int64)).to(dev)
        if top_k == 1:
            hits += int((logits.argmax(-1) == y).sum())
        else:
            # lax.top_k puts the lower index first among ties
            idx = torch.sort(logits, dim=-1, descending=True,
                             stable=True).indices[:, :top_k]
            hits += int((idx == y[:, None]).any(-1).sum())
    return hits / max(len(texts), 1)


def _lexicon_accuracy(texts, labels):
    return sum(lexicon_predict(t) == ID2LABEL[l]
               for t, l in zip(texts, labels)) / max(len(texts), 1)


def classifier_loss(params, ids, mask, labels, cue_mask, cfg,
                    label_smoothing: float, suppress: float):
    """-> (loss, accuracy) of one batch: label-smoothed CE of the pooled
    logits, plus ``suppress`` x the mean over non-cue real tokens of the
    squared positive part of their non-neutral per-token logits (pool
    "max" only; neutral is exempt)."""
    if suppress:
        tok = db.forward_token_logits(params, ids, mask, cfg)
        logits = db.masked_max(tok, mask)
    else:
        logits = db.forward_train(params, ids, mask, cfg)
    labels = labels.long()
    logp = F.log_softmax(logits, dim=-1)
    onehot = F.one_hot(labels, cfg.num_labels).to(logp.dtype)
    target = onehot * (1 - label_smoothing) + \
        label_smoothing / cfg.num_labels
    loss = -torch.mean(torch.sum(target * logp, dim=-1))
    acc = (logits.argmax(-1) == labels).float().mean()
    if suppress:
        non_cue = ((mask > 0) & (cue_mask == 0)).to(tok.dtype)
        cls_w = torch.ones(cfg.num_labels, dtype=tok.dtype,
                           device=tok.device)
        cls_w[NEUTRAL_ID] = 0.0
        pen = torch.square(torch.relu(tok)) * cls_w
        pen = torch.sum(pen * non_cue[..., None]) / \
            torch.clamp(non_cue.sum(), min=1)
        loss = loss + suppress * pen
    return loss, acc


def mlm_loss(params, ids, mask, targets, loss_mask, cfg):
    """Mean NLL of the masked tokens, predicted through the tied
    embedding (hidden @ word_emb.T, no head of its own)."""
    h = db.forward_hidden(params, ids, mask, cfg)               # [B, T, D]
    logp = F.log_softmax(db.matmul(h, params["word_emb"].T), dim=-1)
    nll = -torch.gather(logp, -1, targets.long()[..., None])[..., 0]
    return torch.sum(nll * loss_mask) / torch.clamp(loss_mask.sum(), min=1.0)


def scratch_optimizer(spec: ScratchSpec, warmup: int, total: int) -> AdamW:
    """optax.adamw(warmup_cosine_decay_schedule(0, lr, warmup, total),
    weight_decay) with its other defaults."""
    return AdamW(TrainConfig(lr=spec.lr, weight_decay=spec.weight_decay,
                             b1=0.9, b2=0.999, warmup_steps=warmup,
                             total_steps=total, schedule="warmup_cosine"))


def make_step(loss_fn, optimizer: AdamW):
    """-> step(params, opt_state, *batch) -> the tuple ``loss_fn(params,
    *batch)`` returns, loss first, as device tensors; ``params`` and
    ``opt_state`` are updated in place."""
    def step(params, opt_state, *batch):
        leaves = tree_leaves(params)
        live = [p.detach().requires_grad_() for p in leaves]
        out = loss_fn(tree_unflatten(params, live), *batch)
        # a leaf the loss does not read (the heads, under MLM) gets a zero
        # gradient, so that Adam and the weight decay still step it
        grads = torch.autograd.grad(out[0], live, materialize_grads=True)
        optimizer.update(list(grads), opt_state, leaves)
        return tuple(o.detach() for o in out)

    return step


def make_classifier_step(cfg, spec: ScratchSpec, optimizer: AdamW):
    """step(params, opt_state, ids, mask, labels, cue_mask) -> (loss,
    acc): one AdamW step of ``classifier_loss``."""
    suppress = spec.cue_suppress if spec.pool == "max" else 0.0
    return make_step(
        lambda p, ids, mask, labels, cue: classifier_loss(
            p, ids, mask, labels, cue, cfg, spec.label_smoothing, suppress),
        optimizer)


def make_mlm_step(cfg, optimizer: AdamW):
    """step(params, opt_state, ids, mask, targets, loss_mask) -> (loss,):
    one AdamW step of ``mlm_loss``."""
    return make_step(
        lambda p, ids, mask, targets, lm: (mlm_loss(p, ids, mask, targets,
                                                    lm, cfg),),
        optimizer)


def mlm_pretrain(params, cfg, tok, texts, spec: ScratchSpec,
                 log_fn=print):
    """BERT-style masked-language-model pretraining of the trunk, in
    place on ``params`` (a tree of tensors on the training device).

    Masks ``spec.mask_prob`` of real tokens a sentence (80% -> [MASK],
    10% -> a random id, 10% kept), drawn on the host each epoch, and
    predicts them through the tied embedding."""
    dev = _device_of(params)
    mask_id = tok.vocab["[MASK]"]
    special = np.zeros(cfg.vocab_size, bool)
    for t in ("[PAD]", "[CLS]", "[SEP]", "[MASK]", "[UNK]"):
        special[tok.vocab[t]] = True

    total_steps = max(spec.pretrain_epochs * (len(texts) // spec.batch), 2)
    optimizer = scratch_optimizer(
        spec, max(1, min(200, total_steps // 10)), total_steps)
    opt_state = optimizer.init(tree_leaves(params))
    step = make_mlm_step(cfg, optimizer)

    rng = np.random.default_rng(spec.seed + 7)
    enc_rng = random.Random(spec.seed + 8)
    n = len(texts)
    loss = torch.zeros(())
    for epoch in range(spec.pretrain_epochs):
        ids_all, mask_all = _encode_all(
            tok, texts, spec.max_length, rng=enc_rng,
            piece_dropout=spec.piece_dropout)
        maskable = (mask_all > 0) & ~special[ids_all]
        u = rng.random(ids_all.shape)
        chosen = maskable & (u < spec.mask_prob)
        v = rng.random(ids_all.shape)
        corrupted = np.where(
            chosen & (v < 0.8), mask_id,
            np.where(chosen & (v >= 0.9),
                     rng.integers(0, cfg.vocab_size, ids_all.shape),
                     ids_all)).astype(np.int32)
        order = torch.from_numpy(rng.permutation(n)).to(dev)
        corrupted_d, mask_d, ids_d, chosen_d = (
            torch.from_numpy(a).to(dev) for a in
            (corrupted, mask_all, ids_all, chosen.astype(np.float32)))
        for s in range(0, n - spec.batch + 1, spec.batch):
            sel = order[s:s + spec.batch]
            loss, = step(params, opt_state, corrupted_d[sel], mask_d[sel],
                         ids_d[sel], chosen_d[sel])
        log_fn(f"[mlm] epoch {epoch + 1}/{spec.pretrain_epochs}: "
               f"masked_nll={float(loss):.4f}")
    return params


def numpy_tree(tree, dtype=None):
    """A tree of tensors -> nested dicts (keys sorted, as JAX's tree.map
    leaves them) and lists of numpy arrays, cast to ``dtype`` if given."""
    if isinstance(tree, dict):
        return {k: numpy_tree(tree[k], dtype) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return [numpy_tree(v, dtype) for v in tree]
    a = tree.detach().cpu().numpy()
    return a.astype(dtype) if dtype is not None else a


def distill_classifier(out_dir: str, spec: ScratchSpec = ScratchSpec(),
                       log_fn=print, device=None) -> dict:
    """Generate the corpus, train on ``device`` (None: the card), evaluate
    against the lexicon and write the checkpoint directory ({params.pkl
    (f16), config.pkl, vocab.txt, metrics.json}) -> the metrics."""
    dev = resolve_device(device)
    t_start = time.time()
    data = make_corpus(n_per_label=spec.n_per_label, seed=spec.seed,
                       gen_per_label=spec.gen_per_label)
    train_x, train_y = data["train"]
    vocab = build_wordpiece_vocab(tokenizer_corpus(train_x))
    tok = db.WordPieceTokenizer(vocab)
    cfg = db.DistilBertConfig(
        vocab_size=len(vocab), max_position_embeddings=spec.max_length,
        dim=spec.dim, n_layers=spec.n_layers, n_heads=spec.n_heads,
        hidden_dim=spec.hidden_dim, num_labels=len(ID2LABEL),
        pool=spec.pool)
    log_fn(f"[distill] corpus {len(train_x)} train / "
           f"{len(data['eval'][0])} eval, vocab {len(vocab)}, "
           f"model d{cfg.dim} L{cfg.n_layers}")

    params = db.init_params(prng.PRNGKey(spec.seed), cfg, device=dev)
    if spec.pretrain_epochs > 0:
        params = mlm_pretrain(params, cfg, tok, train_x, spec,
                              log_fn=log_fn)
    steps_per_epoch = max(len(train_x) // spec.batch, 1)
    optimizer = scratch_optimizer(spec, steps_per_epoch,
                                  spec.epochs * steps_per_epoch)
    opt_state = optimizer.init(tree_leaves(params))
    step = make_classifier_step(cfg, spec, optimizer)

    suppress = spec.cue_suppress if spec.pool == "max" else 0.0
    labels = torch.from_numpy(np.asarray(train_y, np.int64)).to(dev)
    rng = np.random.default_rng(spec.seed)
    enc_rng = random.Random(spec.seed + 1)
    n = len(train_x)
    loss = acc = torch.zeros(())
    cues = data.get("train_cues") if suppress else None
    for epoch in range(spec.epochs):
        # re-encode each epoch: piece_dropout re-samples stem splits
        enc = _encode_all(tok, train_x, spec.max_length, rng=enc_rng,
                          piece_dropout=spec.piece_dropout, cues=cues)
        ids = torch.from_numpy(enc[0]).to(dev)
        mask = torch.from_numpy(enc[1]).to(dev)
        cue_m = torch.from_numpy(enc[2]).to(dev) if cues is not None \
            else torch.zeros_like(mask)
        order = torch.from_numpy(rng.permutation(n)).to(dev)
        for s in range(0, n - spec.batch + 1, spec.batch):
            sel = order[s:s + spec.batch]
            loss, acc = step(params, opt_state, ids[sel], mask[sel],
                             labels[sel], cue_m[sel])
        ev = _accuracy(params, cfg, tok, *data["eval"], spec.max_length)
        log_fn(f"[distill] epoch {epoch + 1}/{spec.epochs}: "
               f"train_loss={float(loss):.4f} "
               f"train_acc={float(acc):.3f} eval_acc={ev:.3f}")

    def accuracy(split, top_k=1, texts=None, labels_=None):
        x, y = data[split]
        return _accuracy(params, cfg, tok, x if texts is None else texts,
                         y if labels_ is None else labels_, spec.max_length,
                         top_k=top_k)

    n56 = len(OOD_EVAL)
    ood_x, ood_y = data["ood"]
    metrics = {
        "train_seconds": round(time.time() - t_start, 1),
        "eval_acc_distilbert": accuracy("eval"),
        "eval_acc_lexicon": _lexicon_accuracy(*data["eval"]),
        "unseen_forms_acc_distilbert": accuracy("eval_unseen_forms"),
        "unseen_forms_acc_lexicon": _lexicon_accuracy(
            *data["eval_unseen_forms"]),
        "ood_acc_distilbert": accuracy("ood"),
        "ood_top3_distilbert": accuracy("ood", top_k=3),
        "ood_acc_lexicon": _lexicon_accuracy(*data["ood"]),
        "ood_acc_56_r2_metric": round(accuracy(
            "ood", texts=ood_x[:n56], labels_=ood_y[:n56]), 4),
        "ood_top3_56_r2_metric": round(accuracy(
            "ood", top_k=3, texts=ood_x[:n56], labels_=ood_y[:n56]), 4),
        "eval_situations_acc": accuracy("eval_situations"),
        "eval_situations_lexicon": _lexicon_accuracy(
            *data["eval_situations"]),
        "eval_gen_schemas_acc": accuracy("eval_gen_schemas"),
        "frozen_exam_acc": accuracy("frozen_exam"),
        "frozen_exam_top3": accuracy("frozen_exam", top_k=3),
        "frozen_exam_lexicon": _lexicon_accuracy(*data["frozen_exam"]),
        "ood_implicit_acc": accuracy("ood_implicit"),
        "ood_implicit_top3": accuracy("ood_implicit", top_k=3),
        "n_train": n, "vocab_size": len(vocab),
        "pretrain_epochs": spec.pretrain_epochs,
        "params": int(sum(p.numel() for p in tree_leaves(params))),
    }

    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "params.pkl"), "wb") as f:
        pickle.dump(numpy_tree(params, np.float16), f)
    with open(os.path.join(out_dir, "config.pkl"), "wb") as f:
        pickle.dump(dataclasses.asdict(cfg), f)
    with open(os.path.join(out_dir, "vocab.txt"), "w",
              encoding="utf-8") as f:
        f.write("\n".join(vocab) + "\n")
    # RFC 8259 has no NaN: an empty split's nan is written as null
    metrics_json = {k: (None if isinstance(v, float) and not math.isfinite(v)
                        else v)
                    for k, v in metrics.items()}
    with open(os.path.join(out_dir, "metrics.json"), "w") as f:
        json.dump(metrics_json, f, indent=1, allow_nan=False)
        f.write("\n")
    log_fn(f"[distill] saved -> {out_dir}: {json.dumps(metrics)}")
    return metrics


def params_to_device(tree, device) -> dict:
    """A tree of numpy arrays or tensors -> tensors on ``device``, each
    leaf's dtype kept."""
    return tree_map(lambda a: torch.as_tensor(a).to(device), tree)
