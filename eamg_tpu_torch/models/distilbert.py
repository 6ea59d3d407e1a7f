"""DistilBERT sequence classifier, in PyTorch, over the JAX package's
checkpoint (float16 pickles, computed in f32).

Port of ``eamg_tpu/models/distilbert.py``: ``forward`` with ``pool`` in
{cls, mean, max} and ``WordPieceTokenizer``. LoRA adapters and the
training-only tokenizer options are not in the port.
"""

from __future__ import annotations

import dataclasses
import math
import re

import numpy as np
import torch
import torch.nn.functional as F


@dataclasses.dataclass(frozen=True)
class DistilBertConfig:
    vocab_size: int = 30522
    max_position_embeddings: int = 512
    dim: int = 768
    n_layers: int = 6
    n_heads: int = 12
    hidden_dim: int = 3072
    num_labels: int = 28
    pad_token_id: int = 0
    ln_eps: float = 1e-12
    pool: str = "cls"

    @property
    def head_dim(self) -> int:
        return self.dim // self.n_heads


def _ln(x, p, eps):
    return F.layer_norm(x, (x.shape[-1],), p["g"], p["b"], eps)


def _lin(x, p):
    return torch.matmul(x, p["w"].T) + p["b"]


def _trunk(params, ids, attention_mask, cfg):
    B, T = ids.shape
    x = params["word_emb"][ids] + params["pos_emb"][:T][None]
    x = _ln(x, params["emb_ln"], cfg.ln_eps)
    neg = torch.finfo(x.dtype).min
    key_mask = torch.where(attention_mask[:, None, None, :] > 0, 0.0, neg)

    def heads(y):
        return y.reshape(B, T, cfg.n_heads, cfg.head_dim).transpose(1, 2)

    for p in params["layers"]:
        q = heads(_lin(x, p["q"])) / math.sqrt(cfg.head_dim)
        k = heads(_lin(x, p["k"]))
        v = heads(_lin(x, p["v"]))
        scores = torch.matmul(q, k.transpose(-1, -2)) + key_mask
        probs = torch.softmax(scores, dim=-1)
        ctx = torch.matmul(probs, v).transpose(1, 2).reshape(B, T, cfg.dim)
        x = _ln(x + _lin(ctx, p["out"]), p["sa_ln"], cfg.ln_eps)
        h = F.gelu(_lin(x, p["lin1"]))
        x = _ln(x + _lin(h, p["lin2"]), p["out_ln"], cfg.ln_eps)
    return x


@torch.no_grad()
def forward(params: dict, ids: torch.Tensor, attention_mask: torch.Tensor,
            cfg: DistilBertConfig) -> torch.Tensor:
    """[B, T] ids + [B, T] 0/1 mask -> [B, num_labels] f32 logits."""
    x = _trunk(params, ids, attention_mask, cfg)
    if cfg.pool == "max":
        # per-token label logits, masked max over positions
        h = torch.relu(_lin(x, params["pre_classifier"]))
        tok_logits = _lin(h, params["classifier"])            # [B, T, L]
        neg = torch.finfo(tok_logits.dtype).min
        m = attention_mask[..., None] > 0
        return torch.where(m, tok_logits, neg).max(dim=1).values
    if cfg.pool == "mean":
        w = attention_mask[..., None].to(x.dtype)
        pooled = (x * w).sum(dim=1) / torch.clamp(w.sum(dim=1), min=1.0)
    else:
        pooled = x[:, 0]
    pooled = torch.relu(_lin(pooled, params["pre_classifier"]))
    return _lin(pooled, params["classifier"])


class WordPieceTokenizer:
    """BERT-style WordPiece tokenizer (lowercasing + punctuation split +
    greedy longest-match subwords), as in the JAX package."""

    def __init__(self, vocab, unk="[UNK]", cls="[CLS]", sep="[SEP]",
                 pad="[PAD]", max_input_chars_per_word=100):
        if isinstance(vocab, (str, bytes)):
            with open(vocab, encoding="utf-8") as f:
                vocab = [line.rstrip("\n") for line in f]
        self.vocab = {t: i for i, t in enumerate(vocab)}
        self.unk, self.cls, self.sep, self.pad = unk, cls, sep, pad
        self.max_chars = max_input_chars_per_word

    @staticmethod
    def _basic(text: str) -> list[str]:
        text = text.lower()
        text = re.sub(r"\s+", " ", text).strip()
        out, buf = [], []
        for ch in text:
            if ch.isalnum():
                buf.append(ch)
            else:
                if buf:
                    out.append("".join(buf))
                    buf = []
                if not ch.isspace():
                    out.append(ch)
        if buf:
            out.append("".join(buf))
        return out

    def _wordpiece(self, word: str) -> list[str]:
        if len(word) > self.max_chars:
            return [self.unk]
        pieces, start = [], 0
        while start < len(word):
            end = len(word)
            cur = None
            while start < end:
                sub = word[start:end]
                if start > 0:
                    sub = "##" + sub
                if sub in self.vocab:
                    cur = sub
                    break
                end -= 1
            if cur is None:
                return [self.unk]
            pieces.append(cur)
            start = end
        return pieces

    def tokenize(self, text: str) -> list[str]:
        out = []
        for word in self._basic(text):
            out.extend(self._wordpiece(word))
        return out

    def encode(self, text: str, max_length: int = 128) -> dict:
        """-> {"input_ids": [T], "attention_mask": [T]} int32, padded to
        max_length, truncated with [CLS]/[SEP] kept."""
        toks = [self.cls] + self.tokenize(text)[:max_length - 2] + [self.sep]
        ids = [self.vocab.get(t, self.vocab.get(self.unk, 0)) for t in toks]
        mask = [1] * len(ids)
        pad_id = self.vocab.get(self.pad, 0)
        ids += [pad_id] * (max_length - len(ids))
        mask += [0] * (max_length - len(mask))
        return {"input_ids": np.asarray(ids, np.int32),
                "attention_mask": np.asarray(mask, np.int32)}
