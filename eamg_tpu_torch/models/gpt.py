"""The GPT decoder, in PyTorch: ``forward``, ``prefill``, ``decode_step``.

Port of ``eamg_tpu/models/gpt.py`` with the same parameter tree (torch
layout, fused ``in_proj``) and the same quirk flags: post-/pre-LN,
relu/exact gelu, ``causal``, ``pos_broadcast_bug``, GQA (``n_kv_heads``)
and, in ``forward``, ``batch_first_bug``.

Numerics follow the JAX model: LayerNorm in f32 cast back; weights cast to
the activation dtype; the head in f32. The QKV, out-projection and head
products stay ``torch.matmul`` (XLA computed them outside any Pallas
kernel). Attention, the FFN and cached decode attention go through the
wrappers in ``eamg_tpu_torch/ops``: on CUDA tensors they always launch
the hand-written kernels, on CPU tensors they run the plain versions,
which follow the JAX model's XLA path (masks filled with ``finfo.min``).
The checkpoint's ``kernels`` field is carried but selects nothing.

Not yet ported: ``decode_block``, ``decode_tree``, MoE layers, int8
weights, ``attn_block`` and packed ``seg`` rows.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from ..ops.attention import flash_attention
from ..ops.decode_attention import flash_decode
from ..ops.ffn import fused_ffn


@dataclasses.dataclass(frozen=True)
class GPTConfig:
    vocab_size: int
    seq_len: int
    d_model: int
    n_head: int
    n_layer: int
    d_ff: int | None = None
    causal: bool = False
    ln_placement: str = "post"
    activation: str = "relu"
    pos_rows: int | None = None
    batch_first_bug: bool = False
    pos_broadcast_bug: bool = False
    ln_eps: float = 1e-5
    dtype: str = "float32"
    kernels: str = "xla"
    n_kv_heads: int | None = None
    attn_block: int | None = None
    n_experts: int | None = None
    moe_top_k: int = 2
    moe_every: int = 1
    moe_capacity_factor: float = 2.0

    @property
    def ff(self) -> int:
        return self.d_ff if self.d_ff is not None else 4 * self.d_model

    @property
    def n_pos(self) -> int:
        return self.pos_rows if self.pos_rows is not None else self.seq_len - 1

    @property
    def head_dim(self) -> int:
        assert self.d_model % self.n_head == 0
        return self.d_model // self.n_head

    @property
    def kv_heads(self) -> int:
        h = self.n_kv_heads if self.n_kv_heads is not None else self.n_head
        assert self.n_head % h == 0, "n_head must divide by n_kv_heads"
        return h

    @property
    def kv_dim(self) -> int:
        return self.kv_heads * self.head_dim

    @property
    def torch_dtype(self) -> torch.dtype:
        return torch.bfloat16 if self.dtype == "bfloat16" else torch.float32


def preset(name: str, vocab_size: int) -> GPTConfig:
    """The JAX package's reference presets (models/gpt.py:114-134)."""
    presets = {
        "mini": dict(seq_len=512, d_model=256, n_head=4, n_layer=2,
                     pos_rows=512, batch_first_bug=True),
        "large": dict(seq_len=256, d_model=256, n_head=8, n_layer=4),
        "large2": dict(seq_len=512, d_model=512, n_head=8, n_layer=6),
        "no_inst": dict(seq_len=512, d_model=512, n_head=8, n_layer=6),
        "kv_server": dict(seq_len=512, d_model=512, n_head=8, n_layer=6,
                          pos_rows=512, ln_placement="pre",
                          activation="gelu", pos_broadcast_bug=True),
        "longform": dict(seq_len=2048, d_model=512, n_head=8, n_layer=6,
                         causal=True),
    }
    return GPTConfig(vocab_size=vocab_size, **presets[name])


def _check_supported(cfg: GPTConfig) -> None:
    if cfg.n_experts:
        raise NotImplementedError("MoE layers are not in the port yet")
    if cfg.attn_block is not None:
        raise NotImplementedError("attn_block is not in the port yet")


# ---------------------------------------------------------------- compute

def _layer_norm(x, g, b, eps):
    """LayerNorm in float32, output in the input dtype."""
    return F.layer_norm(x.float(), (x.shape[-1],), g.float(), b.float(),
                        eps).to(x.dtype)


def _linear(x, w, b):
    """torch layout (w [out, in]); weights cast to the activation dtype."""
    return torch.matmul(x, w.to(x.dtype).T) + b.to(x.dtype)


def _split_qkv(p):
    w = p["in_w"]
    D = w.shape[1]
    kvd = (w.shape[0] - D) // 2
    return ((w[:D], p["in_b"][:D]),
            (w[D:D + kvd], p["in_b"][D:D + kvd]),
            (w[D + kvd:], p["in_b"][D + kvd:]))


def _heads(x, n_head):
    B, T, D = x.shape
    return x.reshape(B, T, n_head, D // n_head).transpose(1, 2).contiguous()


def _unheads(x):
    B, H, T, Dh = x.shape
    return x.transpose(1, 2).reshape(B, T, H * Dh)


def attention(p_attn: dict, x, cfg: GPTConfig, causal: bool = False,
              valid_len=None):
    """Self-attention with the fused in_proj (q = k = v input)."""
    (wq, bq), (wk, bk), (wv, bv) = _split_qkv(p_attn)
    q = _heads(_linear(x, wq, bq), cfg.n_head)
    k = _heads(_linear(x, wk, bk), cfg.kv_heads)
    v = _heads(_linear(x, wv, bv), cfg.kv_heads)
    out = _unheads(flash_attention(q, k, v, valid_len=valid_len,
                                   causal=causal))
    return _linear(out, p_attn["out_w"], p_attn["out_b"]), k, v


def _mlp(p, x, cfg: GPTConfig):
    return fused_ffn(x, p["w1"], p["b1"], p["w2"], p["b2"],
                     activation=cfg.activation)


def _attn_input(p: dict, x, cfg: GPTConfig):
    if cfg.ln_placement == "post":
        return x
    return _layer_norm(x, p["ln1"]["g"], p["ln1"]["b"], cfg.ln_eps)


def _finish_block(p: dict, x, attn_out, cfg: GPTConfig):
    eps = cfg.ln_eps
    if cfg.ln_placement == "post":
        x = _layer_norm(x + attn_out, p["ln1"]["g"], p["ln1"]["b"], eps)
        return _layer_norm(x + _mlp(p["mlp"], x, cfg),
                           p["ln2"]["g"], p["ln2"]["b"], eps)
    x = x + attn_out
    return x + _mlp(p["mlp"],
                    _layer_norm(x, p["ln2"]["g"], p["ln2"]["b"], eps), cfg)


def block(p: dict, x, cfg: GPTConfig, causal: bool = False, valid_len=None):
    """One transformer block -> (x, k, v); k/v are the block's projected
    keys and values [B, Hkv, T, Dh] (prefill stores them in the cache)."""
    attn_out, k, v = attention(p["attn"], _attn_input(p, x, cfg), cfg,
                               causal, valid_len)
    return _finish_block(p, x, attn_out, cfg), k, v


def _embed(params, ids, pos_rows, dt):
    """Token + position embedding in f32, then cast to the activation
    dtype. XLA keeps the sum of two bf16 tables in f32 when the result is
    cast to f32 anyway (excess precision), and rounds it once when cast to
    bf16; adding in f32 gives both."""
    return (params["tok_emb"][ids].float() + pos_rows.float()).to(dt)


def _head(params, x):
    return _linear(x.float(), params["head"]["w"], params["head"]["b"])


@torch.no_grad()
def forward(params: dict, ids: torch.Tensor, cfg: GPTConfig) -> torch.Tensor:
    """Full-sequence forward: [B, T] ids -> [B, T, V] f32 logits."""
    _check_supported(cfg)
    T = ids.shape[1]
    x = _embed(params, ids, params["pos"][:T], cfg.torch_dtype)
    if cfg.batch_first_bug:
        # the reference encoder read [B, T, C] as [T, B, C]
        x = x.transpose(0, 1).contiguous()
    for p in params["layers"]:
        x, _, _ = block(p, x, cfg, causal=cfg.causal)
    if cfg.batch_first_bug:
        x = x.transpose(0, 1)
    return _head(params, x)


# ------------------------------------------------------------ KV decoding

def init_kv_cache(cfg: GPTConfig, batch: int, max_len: int | None = None,
                  device=None) -> dict:
    """Per-layer [B, Hkv, max_len, Dh] key and value caches; ``length`` is
    a host int (the decode loop runs on the host)."""
    max_len = max_len or cfg.seq_len
    shape = (batch, cfg.kv_heads, max_len, cfg.head_dim)
    dt = cfg.torch_dtype
    return {"k": [torch.zeros(shape, dtype=dt, device=device)
                  for _ in range(cfg.n_layer)],
            "v": [torch.zeros(shape, dtype=dt, device=device)
                  for _ in range(cfg.n_layer)],
            "length": 0}


@torch.no_grad()
def prefill(params: dict, ids: torch.Tensor, cfg: GPTConfig, cache: dict,
            prompt_len: int | None = None):
    """Warm-up pass over the [B, P] prompt bucket -> ([B, P, V] logits,
    cache). Keys past ``prompt_len`` are masked, but K/V of all P slots,
    pads included, are written to the cache (as the JAX model does); decode
    then overwrites slot t. Updates the cache in place."""
    _check_supported(cfg)
    B, T = ids.shape
    plen = prompt_len if prompt_len is not None else T
    x = _embed(params, ids, params["pos"][:T], cfg.torch_dtype)
    valid = torch.full((B,), plen, dtype=torch.int32, device=ids.device)
    for li, p in enumerate(params["layers"]):
        x, k, v = block(p, x, cfg, causal=cfg.causal, valid_len=valid)
        cache["k"][li][:, :, :T] = k
        cache["v"][li][:, :, :T] = v
    cache["length"] = int(plen)
    return _head(params, x), cache


@torch.no_grad()
def decode_step(params: dict, last_ids: torch.Tensor, cache: dict,
                cfg: GPTConfig):
    """One cached step: [B, 1] ids + cache -> ([B, V] f32 logits, cache).
    The new token's K/V go to slot t = cache["length"] and its query
    attends to slots 0..t. Updates the cache in place."""
    B = last_ids.shape[0]
    dt = cfg.torch_dtype
    t = cache["length"]
    pos_idx = 0 if cfg.pos_broadcast_bug else t
    x = _embed(params, last_ids, params["pos"][pos_idx:pos_idx + 1], dt)
    D, KVD = cfg.d_model, cfg.kv_dim
    t_rows = torch.full((B,), t, dtype=torch.int32, device=last_ids.device)
    for li, p in enumerate(params["layers"]):
        attn_in = _attn_input(p, x, cfg)
        qkv = _linear(attn_in, p["attn"]["in_w"], p["attn"]["in_b"])
        q = _heads(qkv[..., :D], cfg.n_head)                 # [B,H,1,Dh]
        cache["k"][li][:, :, t] = qkv[:, 0, D:D + KVD].reshape(
            B, cfg.kv_heads, cfg.head_dim)
        cache["v"][li][:, :, t] = qkv[:, 0, D + KVD:].reshape(
            B, cfg.kv_heads, cfg.head_dim)
        attn_out = _unheads(flash_decode(q, cache["k"][li], cache["v"][li],
                                         t_rows))
        attn_out = _linear(attn_out, p["attn"]["out_w"], p["attn"]["out_b"])
        x = _finish_block(p, x, attn_out, cfg)
    cache["length"] = t + 1
    return _head(params, x)[:, 0], cache
