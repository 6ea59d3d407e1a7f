"""LoRA finetuning of the emotion classifier.

Port of ``eamg_tpu/emotion/finetune.py``: LoRA adapters (r 8, alpha 16,
on q_lin and v_lin) and the two classification heads are the only
trainable leaves; the trunk is frozen. The defaults are HF Trainer's
recipe (AdamW lr 5e-4, weight decay 0.01, batch 16, 3 epochs, seed 42),
through optax's ``adamw`` at a constant rate (``train/trainer.py::AdamW``).

Each leaf keeps its dtype, as in JAX: on a float16 base (the shipped
classifier's pickle) the heads and their Adam moments stay f16 while the
LoRA factors are f32, and the forward computes in f32 from the first
LoRA product on. Data comes from a local "text<TAB>label_id" file
(``load_label_tsv``) or any (texts, labels) pair.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
import torch.nn.functional as F

from ..models import distilbert as db
from ..train.trainer import AdamW, TrainConfig, tree_leaves
from ..utils import prng
from ..utils.device import resolve_device
from .train_scratch import make_step, params_to_device


@dataclasses.dataclass(frozen=True)
class LoraSpec:
    r: int = 8
    alpha: float = 16.0
    # the reference recipe's LoRA dropout: JAX's step never applies it,
    # and neither does the port's
    dropout: float = 0.1
    lr: float = 5e-4
    weight_decay: float = 0.01
    batch: int = 16
    epochs: int = 3
    seed: int = 42
    max_length: int = 128

    @property
    def scale(self) -> float:
        return self.alpha / self.r


def init_lora(rng, cfg: db.DistilBertConfig, spec: LoraSpec,
              device=None) -> dict:
    """PEFT-style init from a threefry key: A ~ kaiming-uniform (JAX's
    bits), B = zeros (the adapter starts as the identity); f32."""
    dev = torch.device(device or "cpu")
    keys = prng.split(rng, cfg.n_layers * 2)
    bound = math.sqrt(6.0 / cfg.dim)  # kaiming-uniform a=sqrt(5) on [r, dim]

    def factor(key):
        return {"A": prng.uniform(key, (spec.r, cfg.dim), -bound, bound,
                                  device=dev),
                "B": torch.zeros((cfg.dim, spec.r), device=dev)}

    return {"layers": [{"q": factor(keys[2 * i]), "v": factor(keys[2 * i + 1])}
                       for i in range(cfg.n_layers)]}


def merge_lora(params: dict, lora: dict, spec: LoraSpec) -> dict:
    """W + (alpha/r) B@A folded into q and v (the serving form); the
    merged weights take the promoted dtype, as in JAX."""
    merged = dict(params)
    layers = []
    for p, lp in zip(params["layers"], lora["layers"]):
        p2 = dict(p)
        for name in ("q", "v"):
            delta = db.matmul(spec.scale * lp[name]["B"], lp[name]["A"])
            p2[name] = {"w": p[name]["w"] + delta, "b": p[name]["b"]}
        layers.append(p2)
    merged["layers"] = layers
    return merged


def _logits(trainable, frozen, ids, mask, cfg, spec, grad=True):
    params = dict(frozen)
    params["pre_classifier"] = trainable["pre_classifier"]
    params["classifier"] = trainable["classifier"]
    fwd = db.forward_train if grad else db.forward
    return fwd(params, ids, mask, cfg, lora=trainable["lora"],
               lora_scale=spec.scale)


def _nll_acc(logits, labels):
    labels = labels.long()
    logp = F.log_softmax(logits, dim=-1)
    nll = -torch.gather(logp, 1, labels[:, None])[:, 0]
    return nll.mean(), (logits.argmax(-1) == labels).float().mean()


def make_finetune_step(cfg: db.DistilBertConfig, spec: LoraSpec,
                       optimizer=None):
    """-> (step, optimizer): step(trainable, frozen, opt_state, ids, mask,
    labels) -> (trainable, opt_state, {"loss", "accuracy"}), updating
    ``trainable`` ({"lora", "pre_classifier", "classifier"}) and
    ``opt_state`` in place; the metrics are device tensors."""
    optimizer = optimizer or AdamW(TrainConfig(
        lr=spec.lr, weight_decay=spec.weight_decay, b1=0.9, b2=0.999))
    inner = make_step(
        lambda t, frozen, ids, mask, labels: _nll_acc(
            _logits(t, frozen, ids, mask, cfg, spec), labels), optimizer)

    def step(trainable, frozen, opt_state, ids, mask, labels):
        loss, acc = inner(trainable, opt_state, frozen, ids, mask, labels)
        return trainable, opt_state, {"loss": loss, "accuracy": acc}

    return step, optimizer


def finetune(params: dict, cfg: db.DistilBertConfig, tokenizer,
             texts: list[str], labels: list[int],
             spec: LoraSpec = LoraSpec(), eval_fraction: float = 0.0,
             log_every: int = 0, log_fn=print, device=None):
    """The finetune loop on ``device`` (None: the card); ``params`` a
    tree of numpy arrays or tensors, left unchanged. Returns
    (merged_params, trainable, history) as tensors on the device."""
    dev = resolve_device(device)
    rng = np.random.default_rng(spec.seed)
    enc = [tokenizer.encode(t, spec.max_length) for t in texts]
    ids = torch.from_numpy(np.stack([e["input_ids"] for e in enc])).to(dev)
    mask = torch.from_numpy(
        np.stack([e["attention_mask"] for e in enc])).to(dev)
    labels = torch.from_numpy(np.asarray(labels, np.int64)).to(dev)

    n_eval = int(len(texts) * eval_fraction)
    order = rng.permutation(len(texts))
    eval_idx, train_idx = order[:n_eval], order[n_eval:]

    params = params_to_device(params, dev)
    trainable = {
        "lora": init_lora(prng.PRNGKey(spec.seed), cfg, spec, device=dev),
        "pre_classifier": {k: v.clone()
                           for k, v in params["pre_classifier"].items()},
        "classifier": {k: v.clone()
                       for k, v in params["classifier"].items()},
    }
    step, optimizer = make_finetune_step(cfg, spec)
    opt_state = optimizer.init(tree_leaves(trainable))

    def evaluate(trainable):
        """Loss and accuracy over the held-out split, one batch."""
        sel = torch.from_numpy(eval_idx).to(dev)
        logits = _logits(trainable, params, ids[sel], mask[sel], cfg, spec,
                         grad=False)
        loss, acc = _nll_acc(logits, labels[sel])
        return {"eval_loss": float(loss), "eval_accuracy": float(acc)}

    history = []
    it = 0
    for epoch in range(spec.epochs):
        rng.shuffle(train_idx)
        order_d = torch.from_numpy(train_idx).to(dev)
        for s in range(0, len(train_idx) - spec.batch + 1, spec.batch):
            sel = order_d[s:s + spec.batch]
            trainable, opt_state, m = step(trainable, params, opt_state,
                                           ids[sel], mask[sel], labels[sel])
            it += 1
            m = {k: float(v) for k, v in m.items()}
            if log_every and it % log_every == 0:
                log_fn(f"epoch {epoch + 1} step {it}: "
                       f"loss={m['loss']:.4f} acc={m['accuracy']:.3f}")
            history.append(m)
        if n_eval:
            ev = evaluate(trainable)
            history.append(ev)
            if log_every:
                log_fn(f"epoch {epoch + 1}: eval_loss="
                       f"{ev['eval_loss']:.4f} "
                       f"eval_acc={ev['eval_accuracy']:.3f}")

    merged = merge_lora(params, trainable["lora"], spec)
    merged["pre_classifier"] = trainable["pre_classifier"]
    merged["classifier"] = trainable["classifier"]
    return merged, trainable, history


def first_label(labels) -> int:
    """Multi-label GoEmotions row -> first label (notebook cell 3)."""
    if isinstance(labels, (list, tuple, np.ndarray)):
        return int(labels[0])
    return int(labels)


def load_label_tsv(path: str) -> tuple[list[str], list[int]]:
    """'text<TAB>label_id[,label_id...]' rows (the GoEmotions raw format)."""
    texts, labels = [], []
    with open(path, encoding="utf-8") as f:
        for line in f:
            line = line.rstrip("\n")
            if not line:
                continue
            parts = line.split("\t")
            texts.append(parts[0])
            labels.append(first_label(parts[1].split(",")))
    return texts, labels
