"""MHA -> GQA checkpoint conversion: each group of K/V heads mean-pooled.

Port of ``eamg_tpu/models/gqa_convert.py``. ``in_w`` [3D, D] becomes
[D + 2 KVD, D] (the fused in_proj's Q rows unchanged, each K and V block's
heads averaged over their group) and ``in_b`` the same; everything else
carries over. A short finetune afterwards recovers quality
(``tools/gqa_recover.py``). If a group's heads are equal the conversion is
exact.

The JAX package averages numpy arrays, whose ``mean`` over the group axis
adds the heads one at a time in the array's dtype, rounding after each
add (a bf16 array in bf16), then divides by the group size. torch's bf16
``mean`` adds in f32 and rounds once, so the pooling here adds the heads
one at a time as tensors of the weight's dtype, then divides by a tensor
(never a host float, which CUDA would turn into a multiply by its
reciprocal): the converted arrays equal JAX's bit for bit.
"""

from __future__ import annotations

import dataclasses

import torch

from .gpt import GPTConfig


def _pool_rows(w: torch.Tensor, n_kv_heads: int, group: int,
               head_dim: int) -> torch.Tensor:
    """A [H Dh, ...] K or V block -> [n_kv_heads Dh, ...], the mean over
    each group of ``group`` heads."""
    tail = tuple(w.shape[1:])
    r = w.reshape(n_kv_heads, group, head_dim, *tail)
    acc = r[:, 0]
    for i in range(1, group):
        acc = acc + r[:, i]
    return (acc / torch.full_like(acc, group)).reshape(n_kv_heads * head_dim,
                                                        *tail)


def convert_mha_to_gqa(params: dict, cfg: GPTConfig,
                       n_kv_heads: int) -> tuple[dict, GPTConfig]:
    """An MHA parameter tree -> (the GQA tree with ``n_kv_heads`` K/V heads,
    its config). Raises ValueError unless the source is MHA and n_head
    divides by ``n_kv_heads``."""
    if cfg.kv_heads != cfg.n_head:
        raise ValueError(f"source must be MHA (has n_kv_heads="
                         f"{cfg.n_kv_heads})")
    H, Dh, D = cfg.n_head, cfg.head_dim, cfg.d_model
    if H % n_kv_heads:
        raise ValueError(f"n_head={H} not divisible by n_kv_heads="
                         f"{n_kv_heads}")
    g = H // n_kv_heads

    def pool(w):
        return _pool_rows(w, n_kv_heads, g, Dh)

    layers = []
    for layer in params["layers"]:
        attn = layer["attn"]
        in_w, in_b = attn["in_w"], attn["in_b"]
        layers.append({**layer, "attn": {
            **attn,
            "in_w": torch.cat([in_w[:D], pool(in_w[D:2 * D]),
                               pool(in_w[2 * D:])]),
            "in_b": torch.cat([in_b[:D], pool(in_b[D:2 * D]),
                               pool(in_b[2 * D:])])}})
    return ({**params, "layers": layers},
            dataclasses.replace(cfg, n_kv_heads=n_kv_heads))


def convert_checkpoint_dir(src: str, dst: str, n_kv_heads: int) -> None:
    """An MHA checkpoint directory -> a GQA one. The optimizer state is
    dropped (its K/V slots no longer match); the step, the RNG key, the
    vocabulary and ``extra`` carry over, with ``gqa_converted_from``."""
    from ..utils.checkpoint import load_checkpoint, save_checkpoint

    ckpt = load_checkpoint(src)
    params, cfg = convert_mha_to_gqa(ckpt["params"], ckpt["cfg"],
                                     n_kv_heads)
    save_checkpoint(dst, params, ckpt["vocab"], cfg, step=ckpt["step"],
                    rng_key=ckpt["rng_key"],
                    extra={**ckpt["extra"],
                           "gqa_converted_from": f"mha-{ckpt['cfg'].n_head}h"})
