"""The plain reference of the GPT that both configurations run.

Plain PyTorch, float32 with TF32 off, no kernel, cache or batching: token
and position embedding, then ``n_layer`` post-LN blocks (fused Q/K/V
projection, causal softmax attention with K/V heads shared by groups of
``n_head // n_kv_heads`` query heads, out projection, residual, LayerNorm,
ReLU FFN, residual, LayerNorm), then the vocabulary head. Weights are a
tree of tensors in the layout of the shipped checkpoints (``tok_emb``
[V, D], ``pos`` [n_pos, D], per layer ``attn`` {in_w [D + 2 kvd, D],
in_b, out_w, out_b}, ``ln1``/``ln2`` {g, b}, ``mlp`` {w1 [FF, D], b1, w2
[D, FF], b2}, ``head`` {w [V, D], b}).

It imports nothing of the program. ``load_pickle`` reads a shipped
``params.pkl`` itself. The controls: ``fp8_weights``, the same weights
rounded through float8 e4m3 (one scale a tensor), run in bfloat16; and
``forward(..., tf32=True)``, every matmul on operands rounded to TF32
(``tf32_matmul``), forward and backward, emulated so that it reads alike
on the CPU and on the card.
"""

from __future__ import annotations

import math
import pickle

import numpy as np
import torch
import torch.nn.functional as F


class _Unpickler(pickle.Unpickler):
    """bf16 leaves (``ml_dtypes.bfloat16``) arrive as their uint16 bits."""

    def find_class(self, module, name):
        if module == "ml_dtypes" and name == "bfloat16":
            return np.uint16
        return super().find_class(module, name)


def _leaf(a: np.ndarray) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype == np.uint16:
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(a, copy=True))


def tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_map(fn, v) for v in tree]
    return fn(tree)


def load_pickle(path: str) -> dict:
    """A checkpoint's ``params.pkl`` -> the tree of CPU tensors, in the
    dtypes it was saved in."""
    with open(path, "rb") as f:
        return tree_map(_leaf, _Unpickler(f).load())


def _ln(x, p, eps):
    return F.layer_norm(x, (x.shape[-1],), p["g"].to(x.dtype),
                        p["b"].to(x.dtype), eps)


def tf32(t: torch.Tensor) -> torch.Tensor:
    """float32 ``t`` rounded to TF32: 10 mantissa bits, to nearest, ties
    away from zero (the tensor cores' operand rounding)."""
    bits = t.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


class _TF32MatMul(torch.autograd.Function):
    """``a @ b`` (broadcast) on TF32 operands, summed in float32; its
    gradients likewise on TF32 operands."""

    @staticmethod
    def forward(ctx, a, b):
        a, b = tf32(a), tf32(b)
        ctx.save_for_backward(a, b)
        return a @ b

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        g = tf32(g)
        return ((g @ b.transpose(-1, -2)).sum_to_size(a.shape),
                (a.transpose(-1, -2) @ g).sum_to_size(b.shape))


def tf32_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return _TF32MatMul.apply(a, b)


def _lin(x, w, b, mm):
    return mm(x, w.to(x.dtype).T) + b.to(x.dtype)


@torch.no_grad()
def logits(w: dict, ids: torch.Tensor, m: dict,
           dtype=torch.float32) -> torch.Tensor:
    """[B, T] ids -> [B, T, V] float32 logits of the causal model ``m`` (a
    configuration file's ``model``), computed in ``dtype``."""
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        return _logits(w, ids, m, dtype)
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = prev


def forward(w: dict, ids: torch.Tensor, m: dict, dtype=torch.float32,
            tf32: bool = False) -> torch.Tensor:
    """:func:`logits` under autograd (the training reference), or with
    ``tf32`` its control: every matmul through :func:`tf32_matmul`."""
    return _logits(w, ids, m, dtype, tf32_matmul if tf32 else torch.matmul)


def _logits(w, ids, m, dtype, mm=torch.matmul):
    B, T = ids.shape
    D, H = m["d_model"], m["n_head"]
    Hkv = m.get("n_kv_heads") or H
    Dh = D // H
    eps = m.get("ln_eps", 1e-5)
    x = (w["tok_emb"][ids].to(dtype) + w["pos"][:T].to(dtype))
    causal = torch.ones(T, T, dtype=torch.bool, device=ids.device).tril()
    for p in w["layers"]:
        a = p["attn"]
        qkv = _lin(x, a["in_w"], a["in_b"], mm)
        q = qkv[..., :D].reshape(B, T, Hkv, H // Hkv, Dh).permute(0, 2, 3, 1, 4)
        k = qkv[..., D:D + Hkv * Dh].reshape(B, T, Hkv, Dh).transpose(1, 2)
        v = qkv[..., D + Hkv * Dh:].reshape(B, T, Hkv, Dh).transpose(1, 2)
        s = mm(q, k[:, :, None].transpose(-1, -2)) / math.sqrt(Dh)
        s = s.float().masked_fill(~causal, -math.inf)
        pr = torch.softmax(s, -1).to(dtype)
        o = mm(pr, v[:, :, None])
        o = o.permute(0, 3, 1, 2, 4).reshape(B, T, D)
        x = _ln(x + _lin(o, a["out_w"], a["out_b"], mm), p["ln1"],
                eps)
        f = p["mlp"]
        h = torch.relu(_lin(x, f["w1"], f["b1"], mm))
        x = _ln(x + _lin(h, f["w2"], f["b2"], mm), p["ln2"], eps)
    return _lin(x.float(), w["head"]["w"].float(), w["head"]["b"].float(),
                mm)


def as_dtype(w: dict, dtype, device) -> dict:
    return tree_map(lambda t: t.to(device=device, dtype=dtype), w)


def _fp8(t: torch.Tensor) -> torch.Tensor:
    """A weight rounded through float8 e4m3, one scale for the tensor."""
    if t.dim() < 2:
        return t.to(torch.bfloat16)
    t = t.float()
    scale = t.abs().amax().clamp(min=1e-30) / 448.0
    q = (t / scale).to(torch.float8_e4m3fn).float()
    return (q * scale).to(torch.bfloat16)


def fp8_weights(w: dict) -> dict:
    """The control's weights: every matrix (embeddings and head too)
    through float8 e4m3, vectors in bfloat16."""
    return tree_map(_fp8, w)
