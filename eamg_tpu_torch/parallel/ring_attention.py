"""Ring attention: sequence-parallel exact attention over a group of ranks.

Port of ``eamg_tpu/parallel/ring_attention.py`` on ``torch.distributed``.
The TIME axis is split over the group: each rank holds the queries, keys
and values of its block of positions, and the K/V blocks travel the ring
(``parallel/collectives.py::rotate``, a point-to-point exchange whose
backward rotates the gradient the other way) while every rank folds each
passing block into an online softmax of its own queries: N ranks, N - 1
rotations, the exact result, O(T / N) memory a rank.

The arithmetic is JAX's, in its order: scores of the block's queries and
keys accumulated in f32 and scaled, the causal mask at -inf by global
position, the running max, the f32 denominator and accumulator with p
rounded to the values' dtype before its product; the resident block
first, then N - 1 rotations of K and V (the owner of the block that
arrives is ``rank - i`` after i rotations, which JAX rotates alongside).
The block products are ``torch.einsum``: JAX computes them outside any
Pallas kernel.

- :func:`ring_attend`: a rank's accumulation over its local blocks;
- :func:`ring_attention`: [B, H, T, Dh] q, k, v (the same on every rank)
  -> this rank's block of the output, [B, H, T / N, Dh];
- :func:`forward_seq_parallel`: the GPT forward with the time axis split:
  [B, T] ids -> this rank's block of the logits, [B, T / N, V]; its
  positions are the rank's rows of the table, GQA's K/V heads are
  repeated to the query heads (``repeat_interleave``, as ``jnp.repeat``),
  and it is differentiable: :func:`seq_parallel_loss` is the masked CE of
  the whole sequence, and the gradients of the (replicated) params are
  summed over the group (``collectives.all_reduce_``) before a step.
"""

from __future__ import annotations

import math

import torch
import torch.distributed as dist
import torch.nn.functional as F

from .collectives import reduce_from_region, rotate


def _block_attend(q, k, v, q_start: int, k_start: int, causal: bool,
                  sm_scale: float, acc, m_prev, l_prev):
    """The online-softmax update of local queries against one K/V block
    (q [B, H, Tq, Dh], k/v [B, H, Tk, Dh]; the starts are global
    positions)."""
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * sm_scale
    if causal:
        Tq, Tk = q.shape[2], k.shape[2]
        qpos = q_start + torch.arange(Tq, device=q.device)[:, None]
        kpos = k_start + torch.arange(Tk, device=q.device)[None, :]
        s = torch.where((kpos <= qpos)[None, None], s, -math.inf)
    m_cur = torch.maximum(m_prev, s.amax(dim=-1, keepdim=True))
    # fully masked rows keep m = -inf; exp(s - m) would be NaN
    m_safe = torch.where(torch.isfinite(m_cur), m_cur, 0.0)
    p = torch.exp(s - m_safe)
    p = torch.where(torch.isfinite(s), p, 0.0)
    alpha = torch.where(torch.isfinite(m_prev), torch.exp(m_prev - m_safe),
                        0.0)
    l_cur = alpha * l_prev + p.sum(dim=-1, keepdim=True)
    acc = acc * alpha + torch.einsum("bhqk,bhkd->bhqd",
                                     p.to(v.dtype).float(), v.float())
    return acc, m_cur, l_cur


def ring_attend(q, k, v, group, causal: bool, sm_scale: float):
    """This rank's Tq queries against every rank's K/V block as the blocks
    rotate through: q, k, v the rank's blocks [B, H, Tq, Dh]; the resident
    block first, then N - 1 rotations."""
    n, idx = dist.get_world_size(group), dist.get_rank(group)
    B, H, Tq, Dh = q.shape
    acc = torch.zeros((B, H, Tq, Dh), device=q.device)
    m = torch.full((B, H, Tq, 1), -math.inf, device=q.device)
    l = torch.zeros((B, H, Tq, 1), device=q.device)
    acc, m, l = _block_attend(q, k, v, idx * Tq, idx * Tq, causal, sm_scale,
                              acc, m, l)
    for i in range(1, n):
        k, v = rotate(k, group), rotate(v, group)
        owner = (idx - i) % n
        acc, m, l = _block_attend(q, k, v, idx * Tq, owner * Tq, causal,
                                  sm_scale, acc, m, l)
    return (acc / torch.clamp(l, min=1e-30)).to(q.dtype)


def _block_of(t: torch.Tensor, dim: int, group) -> torch.Tensor:
    n, idx = dist.get_world_size(group), dist.get_rank(group)
    T = t.shape[dim]
    if T % n:
        raise ValueError(f"T={T} not divisible by seq={n}")
    return t.narrow(dim, idx * (T // n), T // n)


def ring_attention(q, k, v, group, causal: bool = True) -> torch.Tensor:
    """Exact sequence-parallel attention: q/k/v [B, H, T, Dh] (T a multiple
    of the group's size) -> this rank's block of the output,
    [B, H, T / N, Dh], equal to the masked softmax attention of the whole
    sequence to f32-accumulation tolerance."""
    sm_scale = 1.0 / math.sqrt(q.shape[-1])
    return ring_attend(_block_of(q, 2, group), _block_of(k, 2, group),
                       _block_of(v, 2, group), group, causal, sm_scale)


def forward_seq_parallel(params: dict, ids: torch.Tensor, cfg,
                         group) -> torch.Tensor:
    """The GPT forward with the time axis split over ``group``: [B, T] ids
    (the same on every rank) -> this rank's block of the f32 logits,
    [B, T / N, V]. The corrected causal architecture only; T a multiple of
    N and at most the positional table."""
    from ..models.gpt import (_attn_input, _finish_block, _head, _heads,
                              _linear, _mlp_train, _unheads)

    if not cfg.causal or cfg.batch_first_bug:
        raise ValueError("sequence-parallel forward supports the corrected "
                         "causal architecture")
    n, idx = dist.get_world_size(group), dist.get_rank(group)
    B, T = ids.shape
    if T % n:
        raise ValueError(f"T={T} not divisible by seq={n}")
    if T > cfg.n_pos:
        raise ValueError(f"T={T} exceeds the positional table (n_pos="
                         f"{cfg.n_pos}); the last shard's positions would "
                         "clamp")
    Tl = T // n
    sm_scale = 1.0 / math.sqrt(cfg.head_dim)
    D, KVD = cfg.d_model, cfg.kv_dim
    g = cfg.n_head // cfg.kv_heads
    ids_local = ids[:, idx * Tl:(idx + 1) * Tl].long()
    pos = params["pos"][idx * Tl:(idx + 1) * Tl]
    x = (F.embedding(ids_local, params["tok_emb"]) + pos).to(
        cfg.torch_dtype)
    for p in params["layers"]:
        xn = _attn_input(p, x, cfg)
        qkv = _linear(xn, p["attn"]["in_w"], p["attn"]["in_b"])
        q = _heads(qkv[..., :D], cfg.n_head)
        k = _heads(qkv[..., D:D + KVD], cfg.kv_heads)
        v = _heads(qkv[..., D + KVD:], cfg.kv_heads)
        if g > 1:   # ring_attend is head-aligned: expand the K/V groups
            k = k.repeat_interleave(g, dim=1)
            v = v.repeat_interleave(g, dim=1)
        attn = ring_attend(q, k, v, group, True, sm_scale)
        attn_out = _linear(_unheads(attn), p["attn"]["out_w"],
                           p["attn"]["out_b"])
        x = _finish_block(p, x, attn_out, cfg, mlp=_mlp_train)
    return _head(params, x)


def seq_parallel_loss(params: dict, x: torch.Tensor, y: torch.Tensor, cfg,
                      group, pad_id: int) -> tuple:
    """The PAD-masked next-token CE of the whole [B, T] batch through
    :func:`forward_seq_parallel` -> (loss, count), the same on every rank.
    Each rank's backward reaches its own positions' share of the params'
    gradient; sum those over ``group`` before a step."""
    from ..train.trainer import masked_ce_sums

    logits = forward_seq_parallel(params, x, cfg, group)
    total, _ = masked_ce_sums(logits, _block_of(y, 1, group), pad_id)
    total = reduce_from_region(total, group)
    count = (y != pad_id).sum().clamp(min=1)
    return total / count, count
