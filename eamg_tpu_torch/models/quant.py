"""Int8 weight-only quantization for serving.

Port of ``eamg_tpu/models/quant.py``. A quantized weight is a
``{"q": int8 [out, in], "s": float32 [out]}`` leaf: symmetric per output
channel, ``s = max|W_j| / 127`` (at least 1e-12), ``q = round(W / s)``
clipped to +-127, rounding half to even. ``_linear`` and ``_split_qkv`` in
``models/gpt.py`` take such leaves wherever they take a weight, so every
forward and decode route runs a quantized tree. Embeddings, the position
table, LayerNorms and biases stay float.

The arithmetic is done in the weight's dtype, as JAX does it (a bf16
weight gives a bf16 scale, rounded once the quotient and once the clip,
before the f32 cast). Both divisions take a tensor divisor: CUDA turns a
division by a host float into a multiply by its reciprocal, which rounds
elsewhere, so ``q`` and ``s`` made on the card equal the host's and
JAX's bit for bit.
"""

from __future__ import annotations

import torch


def quantize_weight(w: torch.Tensor) -> dict:
    """[out, in] float -> {"q": int8 [out, in], "s": float32 [out]}."""
    amax = w.abs().amax(dim=1, keepdim=True)
    s = amax / torch.full_like(amax, 127.0)
    s = torch.maximum(s, torch.full_like(s, 1e-12))
    q = torch.clamp(torch.round(w / s), -127, 127).to(torch.int8)
    return {"q": q, "s": s[:, 0].float()}


def dequantize_weight(wq: dict) -> torch.Tensor:
    return wq["q"].float() * wq["s"][:, None]


def quantize_params(params: dict) -> dict:
    """Quantize every large product weight of a dense GPT tree (the
    fused in_proj, the out-projection, both FFN weights and the head);
    biases, norms, the embedding and the position table stay float."""
    layers = []
    for p in params["layers"]:
        layers.append({
            "attn": {"in_w": quantize_weight(p["attn"]["in_w"]),
                     "in_b": p["attn"]["in_b"],
                     "out_w": quantize_weight(p["attn"]["out_w"]),
                     "out_b": p["attn"]["out_b"]},
            "ln1": p["ln1"], "ln2": p["ln2"],
            "mlp": {"w1": quantize_weight(p["mlp"]["w1"]),
                    "b1": p["mlp"]["b1"],
                    "w2": quantize_weight(p["mlp"]["w2"]),
                    "b2": p["mlp"]["b2"]},
        })
    return {"tok_emb": params["tok_emb"], "pos": params["pos"],
            "layers": layers,
            "head": {"w": quantize_weight(params["head"]["w"]),
                     "b": params["head"]["b"]}}


def quantization_error(params: dict, qparams: dict) -> float:
    """The largest relative Frobenius error over the quantized weights."""
    errs = []

    def norm(a):
        # jnp.linalg.norm compiled: the squares and their sum in f32, the
        # sum and the root rounded to a's dtype
        dt = a.dtype
        return (a.float().square().sum().to(dt).float().sqrt().to(dt)
                .clamp(min=1e-9).float())

    def walk(a, b):
        if isinstance(b, dict) and "q" in b and "s" in b:
            d = norm(a.float() - dequantize_weight(b))
            errs.append(float(d / norm(a)))
        elif isinstance(b, dict):
            for k in b:
                walk(a[k], b[k])
        elif isinstance(b, list):
            for x, y in zip(a, b):
                walk(x, y)

    walk(params, qparams)
    return max(errs)
