"""DistilBERT sequence classifier in PyTorch, with LoRA: served over the
JAX package's checkpoint (float16 pickles, computed in f32) and trained.

Port of ``eamg_tpu/models/distilbert.py``:
- ``forward`` (served, under ``no_grad``) and ``forward_train`` (under
  autograd), with ``pool`` in {cls, mean, max} and an optional unmerged
  LoRA adapter on q_lin and v_lin; ``forward_token_logits`` (pool max:
  the per-token logits before the masked max) and ``forward_hidden``
  (the trunk alone), which the trainers read;
- ``init_params`` from a threefry key, drawn in JAX's order;
- ``import_hf_state_dict``: an HF (+PEFT LoRA) state dict -> the param
  tree as numpy, LoRA merged;
- ``WordPieceTokenizer`` with the trainers' options: piece dropout
  through a random stem split and the cue-span mask, drawing from a
  ``random.Random`` exactly as JAX's does.

Mixed float dtypes are computed as JAX promotes them (an f16 tree with
f32 LoRA factors computes in f32 from the first LoRA product on); a
product casts both sides to the promoted dtype, since ``torch.matmul``
refuses mixed ones.
"""

from __future__ import annotations

import dataclasses
import math
import re

import numpy as np
import torch


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


def matmul(x, w):
    """x @ w in the dtype JAX promotes the two to."""
    dt = torch.promote_types(x.dtype, w.dtype)
    return torch.matmul(x.to(dt), w.to(dt))


def _ln(x, p, eps):
    # JAX's op sequence, so that an f16 input rounds where XLA's does: an
    # f16 rsqrt is the reciprocal of the rounded square root, and the
    # scale and shift are one multiply-add
    mean = x.mean(dim=-1, keepdim=True)
    var = torch.square(x - mean).mean(dim=-1, keepdim=True)
    return torch.addcmul(p["b"], (x - mean) * (1 / torch.sqrt(var + eps)),
                         p["g"])


def _lin(x, p):
    return matmul(x, p["w"].T) + p["b"]


def _lora_delta(x, lp, scale):
    """x @ (scale * B@A)^T computed low-rank: (x @ A^T) @ B^T * scale."""
    return matmul(matmul(x, lp["A"].T), lp["B"].T) * scale


def _neg(dtype, device):
    return torch.tensor(torch.finfo(dtype).min, dtype=dtype, device=device)


def _trunk(params, ids, attention_mask, cfg, lora=None, lora_scale=2.0):
    B, T = ids.shape
    # positions past the table take its last row, as JAX's gather clamps
    pos = torch.arange(T, device=ids.device).clamp(
        max=params["pos_emb"].shape[0] - 1)
    x = params["word_emb"][ids.long()] + params["pos_emb"][pos][None]
    x = _ln(x, params["emb_ln"], cfg.ln_eps)
    key_mask = torch.where(attention_mask[:, None, None, :] > 0,
                           torch.zeros((), dtype=x.dtype, device=x.device),
                           _neg(x.dtype, x.device))

    def heads(y):
        return y.reshape(B, T, cfg.n_heads, cfg.head_dim).transpose(1, 2)

    for li, p in enumerate(params["layers"]):
        lq = lora["layers"][li] if lora is not None else None
        q_full = _lin(x, p["q"])
        v_full = _lin(x, p["v"])
        if lq:
            q_full = q_full + _lora_delta(x, lq["q"], lora_scale)
            v_full = v_full + _lora_delta(x, lq["v"], lora_scale)
        q = heads(q_full) / math.sqrt(cfg.head_dim)
        k = heads(_lin(x, p["k"]))
        v = heads(v_full)
        scores = matmul(q, k.transpose(-1, -2)) + key_mask
        probs = torch.softmax(scores, dim=-1)
        ctx = matmul(probs, v).transpose(1, 2).reshape(B, T, cfg.dim)
        x = _ln(x + _lin(ctx, p["out"]), p["sa_ln"], cfg.ln_eps)
        h = torch.nn.functional.gelu(_lin(x, p["lin1"]))
        x = _ln(x + _lin(h, p["lin2"]), p["out_ln"], cfg.ln_eps)
    return x


def _token_logits(params, x):
    return _lin(torch.relu(_lin(x, params["pre_classifier"])),
                params["classifier"])


def masked_max(tok_logits, attention_mask):
    """[B, T, L] per-token logits -> [B, L], the max over real tokens.
    ``amax`` splits the gradient among tied maxima, as JAX's max does."""
    m = attention_mask[..., None] > 0
    return torch.amax(torch.where(m, tok_logits,
                                  _neg(tok_logits.dtype, tok_logits.device)),
                      dim=1)


def forward_train(params: dict, ids: torch.Tensor,
                  attention_mask: torch.Tensor, cfg: DistilBertConfig,
                  lora: dict | None = None,
                  lora_scale: float = 2.0) -> torch.Tensor:
    """[B, T] ids + [B, T] 0/1 mask -> [B, num_labels] logits, under
    autograd. ``lora``: an unmerged adapter {"layers": [{"q": {A, B},
    "v": {A, B}}, ...]} added to q_lin and v_lin as low-rank deltas;
    ``lora_scale`` = alpha / r."""
    x = _trunk(params, ids, attention_mask, cfg, lora, lora_scale)
    if cfg.pool == "max":
        return masked_max(_token_logits(params, x), attention_mask)
    if cfg.pool == "mean":
        w = attention_mask[..., None].to(x.dtype)
        pooled = (x * w).sum(dim=1) / torch.clamp(w.sum(dim=1), min=1.0)
    else:
        pooled = x[:, 0]
    pooled = torch.relu(_lin(pooled, params["pre_classifier"]))
    return _lin(pooled, params["classifier"])


@torch.no_grad()
def forward(params: dict, ids: torch.Tensor, attention_mask: torch.Tensor,
            cfg: DistilBertConfig, lora: dict | None = None,
            lora_scale: float = 2.0) -> torch.Tensor:
    """:func:`forward_train` without autograd: what the classifier
    serves (its params f32)."""
    return forward_train(params, ids, attention_mask, cfg, lora,
                         lora_scale)


def forward_token_logits(params: dict, ids: torch.Tensor,
                         attention_mask: torch.Tensor,
                         cfg: DistilBertConfig) -> torch.Tensor:
    """[B, T, num_labels] per-token label logits (pool "max" only: the
    head before the masked max), which the cue-span suppression reads."""
    assert cfg.pool == "max"
    return _token_logits(params, _trunk(params, ids, attention_mask, cfg))


def forward_hidden(params: dict, ids: torch.Tensor,
                   attention_mask: torch.Tensor,
                   cfg: DistilBertConfig) -> torch.Tensor:
    """[B, T, dim] final-layer hidden states, no head (the MLM
    pretrainer ties them to ``word_emb``)."""
    return _trunk(params, ids, attention_mask, cfg)


# ----------------------------------------------------------------- import

def _np(x):
    if hasattr(x, "detach"):
        x = x.detach().cpu().numpy()
    return np.asarray(x)


def _strip_prefixes(sd: dict) -> dict:
    """Drop PEFT wrappers: base_model.model., .base_layer, modules_to_save."""
    out = {}
    for k, v in sd.items():
        k = k.replace("base_model.model.", "")
        k = k.replace(".base_layer", "")
        k = k.replace(".modules_to_save.default", "")
        k = k.replace(".original_module", "")
        out[k] = v
    return out


def import_hf_state_dict(sd: dict, cfg: DistilBertConfig,
                         lora_alpha: float = 16.0) -> dict:
    """HF DistilBertForSequenceClassification state dict (optionally with
    PEFT LoRA keys) -> the param tree as f32 numpy arrays, LoRA merged as
    ``W + (alpha / r) B @ A``."""
    sd = _strip_prefixes(sd)

    def f32(name):
        return _np(sd[name]).astype(np.float32)

    def lin(name):
        w = f32(f"{name}.weight")
        b = f32(f"{name}.bias")
        la, lb = f"{name}.lora_A.default.weight", \
            f"{name}.lora_B.default.weight"
        if la in sd:
            A = f32(la)   # [r, in]
            Bm = f32(lb)  # [out, r]
            w = w + (lora_alpha / A.shape[0]) * (Bm @ A)
        return {"w": w, "b": b}

    layers = []
    for i in range(cfg.n_layers):
        pre = f"distilbert.transformer.layer.{i}"
        layers.append({
            "q": lin(f"{pre}.attention.q_lin"),
            "k": lin(f"{pre}.attention.k_lin"),
            "v": lin(f"{pre}.attention.v_lin"),
            "out": lin(f"{pre}.attention.out_lin"),
            "sa_ln": {"g": f32(f"{pre}.sa_layer_norm.weight"),
                      "b": f32(f"{pre}.sa_layer_norm.bias")},
            "lin1": lin(f"{pre}.ffn.lin1"),
            "lin2": lin(f"{pre}.ffn.lin2"),
            "out_ln": {"g": f32(f"{pre}.output_layer_norm.weight"),
                       "b": f32(f"{pre}.output_layer_norm.bias")},
        })
    return {
        "word_emb": f32("distilbert.embeddings.word_embeddings.weight"),
        "pos_emb": f32("distilbert.embeddings.position_embeddings.weight"),
        "emb_ln": {"g": f32("distilbert.embeddings.LayerNorm.weight"),
                   "b": f32("distilbert.embeddings.LayerNorm.bias")},
        "layers": layers,
        "pre_classifier": lin("pre_classifier"),
        "classifier": lin("classifier"),
    }


def init_params(rng, cfg: DistilBertConfig, device=None) -> dict:
    """Random init (N(0, 0.02) matrices and embeddings, zero biases, unit
    LayerNorms), f32 on ``device`` (default the CPU), from a threefry key
    (``utils.prng.PRNGKey``) split as JAX splits it: 8 + 6 L keys, taken
    by each layer's q, k, v, out, lin1, lin2, then word_emb, pos_emb,
    pre_classifier and classifier."""
    from ..utils import prng
    from .gpt import normal_f32

    dev = torch.device(device or "cpu")
    keys = iter(prng.split(rng, 8 + 6 * cfg.n_layers))

    def normal(shape):
        return 0.02 * normal_f32(next(keys), shape, device=dev)

    def lin(fan_out, fan_in):
        return {"w": normal((fan_out, fan_in)),
                "b": torch.zeros((fan_out,), device=dev)}

    def ln(d):
        return {"g": torch.ones((d,), device=dev),
                "b": torch.zeros((d,), device=dev)}

    D, FF = cfg.dim, cfg.hidden_dim
    layers = [{
        "q": lin(D, D), "k": lin(D, D), "v": lin(D, D), "out": lin(D, D),
        "sa_ln": ln(D), "lin1": lin(FF, D), "lin2": lin(D, FF),
        "out_ln": ln(D),
    } for _ in range(cfg.n_layers)]
    return {
        "word_emb": normal((cfg.vocab_size, D)),
        "pos_emb": normal((cfg.max_position_embeddings, D)),
        "emb_ln": ln(D),
        "layers": layers,
        "pre_classifier": lin(D, D),
        "classifier": lin(cfg.num_labels, D),
    }


# ------------------------------------------------------------- tokenizer

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

    def _random_split(self, word: str, rng) -> list[str]:
        """Decompose a whole-vocab word at a random valid stem boundary
        (stem + greedy ##pieces): training-time subword regularization,
        so that stem pieces get gradient."""
        splits = [s for s in range(4, len(word))
                  if word[:s] in self.vocab]
        if not splits:
            return [word]
        s = splits[rng.randrange(len(splits))]
        stem, rest = word[:s], word[s:]
        pieces, start = [stem], 0
        while start < len(rest):
            end = len(rest)
            cur = None
            while start < end:
                sub = "##" + rest[start:end]
                if sub in self.vocab:
                    cur = sub
                    break
                end -= 1
            if cur is None:
                return [word]
            pieces.append(cur)
            start = end
        return pieces

    def _pieces(self, word: str, rng, p: float) -> list[str]:
        if len(word) >= 5 and word in self.vocab and rng.random() < p:
            return self._random_split(word, rng)
        return self._wordpiece(word)

    def tokenize_dropout(self, text: str, rng, p: float = 0.1) -> list[str]:
        """tokenize() with each in-vocab word of 5+ characters split at a
        random stem with probability p (rng: a ``random.Random``)."""
        return [t for word in self._basic(text)
                for t in self._pieces(word, rng, p)]

    def encode(self, text: str, max_length: int = 128, rng=None,
               piece_dropout: float = 0.0, cue: str | None = None) -> dict:
        """-> {"input_ids": [T], "attention_mask": [T][, "cue_mask"]}
        int32, padded to max_length, truncated with [CLS]/[SEP] kept.
        ``rng`` with ``piece_dropout`` > 0 enables the random stem splits;
        ``cue`` (a space-separated word span) adds a 0/1 "cue_mask" over
        the pieces of the cue's words."""
        if cue is None:
            toks = (self.tokenize_dropout(text, rng, piece_dropout)
                    if rng is not None and piece_dropout > 0
                    else self.tokenize(text))[:max_length - 2]
            flags = None
        else:
            protected = {w for cw in cue.split() for w in self._basic(cw)}
            toks, flags = [], []
            for word in self._basic(text):
                pieces = (self._pieces(word, rng, piece_dropout)
                          if rng is not None and piece_dropout > 0
                          else self._wordpiece(word))
                toks.extend(pieces)
                flags.extend([word in protected] * len(pieces))
            toks = toks[:max_length - 2]
            flags = [False] + flags[:max_length - 2] + [False]
        toks = [self.cls] + toks + [self.sep]
        ids = [self.vocab.get(t, self.vocab.get(self.unk, 0)) for t in toks]
        mask = [1] * len(ids)
        pad_id = self.vocab.get(self.pad, 0)
        ids += [pad_id] * (max_length - len(ids))
        mask += [0] * (max_length - len(mask))
        out = {"input_ids": np.asarray(ids, np.int32),
               "attention_mask": np.asarray(mask, np.int32)}
        if flags is not None:
            flags = flags + [False] * (max_length - len(flags))
            out["cue_mask"] = np.asarray(flags[:max_length], np.int32)
        return out
