"""The mixture-of-experts FFN on one device: routing, the capacity-bounded
dispatch of training and the no-drop pointwise path of inference.

Port of the single-device part of ``eamg_tpu/parallel/moe.py`` (the
expert-parallel ``moe_mlp_ep`` and ``shard_moe_params`` belong to the
parallel modes). The math is JAX's:

- routing: top-k over E experts of the f32 router logits, the lowest index
  first on ties (``lax.top_k``'s order; here a stable descending sort, as
  ``torch.topk`` promises no order on ties); the gates are the softmax of
  the k selected logits for k >= 2, and the full-softmax probability of
  the winner for k == 1;
- training (:func:`moe_mlp_dense`): one-hot dispatch and combine tensors
  [k, N, E, C]; each expert takes at most C = ceil(k T / E x capacity
  factor) tokens of a row, claimed in token order (a token's first choice
  before its second), so drops are causal and rows independent;
- inference (:func:`moe_mlp_pointwise`): no capacity, every expert run on
  every token in chunks of 256 and the k selected outputs combined, so a
  token's output depends on that token alone: a full forward, a cached
  decode step and any batch of rows agree.

The expert products run in f32 as in JAX (an f32 activation against bf16
weights promotes there; torch's einsum takes one dtype, so the weights are
cast). They stay ``torch.einsum``: JAX computes them outside any Pallas
kernel. The one-hot tensors are comparisons with an ``arange``, and the
ranking a sort, so a decode step holding an MoE layer reads nothing back
to the host and a CUDA graph can hold it.
"""

from __future__ import annotations

import dataclasses
import math

import torch


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    d_model: int
    d_ff: int                 # width of each expert's hidden layer
    n_experts: int
    top_k: int = 2
    capacity_factor: float = 1.25
    activation: str = "gelu"


def init_moe_params(key, cfg: MoEConfig, device=None) -> dict:
    """The router and the stacked experts ([out, in] a expert), f32, from a
    threefry ``key`` split in JAX's order: every leaf equals JAX's
    ``init_moe_params`` bit for bit."""
    from ..utils import prng

    kr, k1, k2, kb1, kb2 = prng.split(key, 5)
    D, FF, E = cfg.d_model, cfg.d_ff, cfg.n_experts
    bw1 = math.sqrt(6.0 / (6 * D))
    bw2 = math.sqrt(6.0 / (6 * FF))

    def uniform(k, shape, bound):
        return prng.uniform(k, shape, -bound, bound, device=device)

    return {"router": uniform(kr, (E, D), bw1),
            "w1": uniform(k1, (E, FF, D), bw1),
            "b1": uniform(kb1, (E, FF), 1 / math.sqrt(D)),
            "w2": uniform(k2, (E, D, FF), bw2),
            "b2": uniform(kb2, (E, D), 1 / math.sqrt(FF))}


def _act(h, cfg: MoEConfig):
    if cfg.activation == "gelu":
        from ..models.gpt import _gelu_exact

        return _gelu_exact(h)
    return torch.relu(h)


def _one_hot(idx, n: int) -> torch.Tensor:
    """f32 one-hot of ``idx`` over ``n`` classes, by comparison (no check
    that reads the indices back)."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).float()


def _router_logits(params, x) -> torch.Tensor:
    return torch.einsum("nd,ed->ne", x.float(), params["router"].float())


def _top_k_indices(logits, k: int) -> torch.Tensor:
    """[N, E] -> [N, k] indices of the k largest, in ``lax.top_k``'s
    order: descending, the lower index first among equal values."""
    return torch.sort(logits, dim=-1, descending=True,
                      stable=True).indices[:, :k]


def _gates(params, x, cfg: MoEConfig):
    """x [N, D] -> (gates [k, N] f32, expert ids [k, N])."""
    logits = _router_logits(params, x)
    idx = _top_k_indices(logits, cfg.top_k)
    if cfg.top_k == 1:
        gates = torch.softmax(logits, dim=-1).gather(-1, idx)
    else:
        gates = torch.softmax(logits.gather(-1, idx), dim=-1)
    return gates.T, idx.T


def _dispatch_tensors(eidx, cfg: MoEConfig, capacity: int):
    """expert ids [R, k, N] (R rows) -> one-hot dispatch [R, k, N, E, C]:
    a row's (token, choice) pairs claim their expert's slots in token-major
    order; a pair past the capacity gets an all-zero one-hot."""
    R, k, N = eidx.shape
    E = cfg.n_experts
    order = eidx.transpose(1, 2).reshape(R, N * k)          # (n, j)-major
    disp = _one_hot(order, E)                               # [R, Nk, E]
    pos = disp.long().cumsum(1) - 1                         # slot in expert
    disp = disp * (pos < capacity).float()
    posh = _one_hot(pos.clamp(0, capacity - 1), capacity)  # [R, Nk, E, C]
    dispatch = disp[..., None] * posh
    return dispatch.reshape(R, N, k, E, capacity).transpose(1, 2)


def load_balance_loss(params: dict, x, cfg: MoEConfig) -> torch.Tensor:
    """The Switch-Transformer auxiliary loss E x sum_e f_e P_e (f_e the
    share of routed slots that expert e takes, P_e its mean full-softmax
    probability) over tokens x [N, D]; 1 at uniform routing."""
    logits = _router_logits(params, x)
    probs = torch.softmax(logits, dim=-1)
    f = _one_hot(_top_k_indices(logits, cfg.top_k),
                 cfg.n_experts).mean(dim=(0, 1))
    return cfg.n_experts * torch.sum(f * probs.mean(dim=0))


def _moe_rows(params, xr, cfg: MoEConfig, capacity: int):
    """Capacity-bounded MoE over rows of tokens xr [R, N, D] -> [R, N, D]
    f32 (JAX's ``_moe_row`` under ``vmap``)."""
    R, N, D = xr.shape
    gates, eidx = _gates(params, xr.reshape(R * N, D), cfg)   # [k, R N]
    k = cfg.top_k
    gates = gates.reshape(k, R, N).transpose(0, 1)            # [R, k, N]
    dispatch = _dispatch_tensors(eidx.reshape(k, R, N).transpose(0, 1), cfg,
                                 capacity)                    # [R,k,N,E,C]
    xin = torch.einsum("rknec,rnd->recd", dispatch, xr.float())
    h = _act(torch.einsum("recd,efd->recf", xin, params["w1"].float())
             + params["b1"].float()[None, :, None], cfg)
    out = torch.einsum("recf,edf->recd", h, params["w2"].float()) \
        + params["b2"].float()[None, :, None]
    combine = dispatch * gates[..., None, None]
    return torch.einsum("rknec,recd->rnd", combine, out)


def moe_mlp_dense(params: dict, x, cfg: MoEConfig,
                  capacity: int | None = None) -> torch.Tensor:
    """The training semantics: [.., D] -> [.., D] in x's dtype, capacity
    counted a row (a leading-axis element of a [B, T, D] x; a [N, D] x is
    one row), so tokens compete only with earlier tokens of their own
    sequence."""
    shape = x.shape
    xr = x.reshape(1, -1, shape[-1]) if x.ndim <= 2 else \
        x.reshape(-1, shape[-2], shape[-1])
    n_row = xr.shape[1]
    capacity = capacity or max(1, int(math.ceil(
        cfg.top_k * n_row / cfg.n_experts * cfg.capacity_factor)))
    return _moe_rows(params, xr, cfg, capacity).reshape(shape).to(x.dtype)


def moe_mlp_pointwise(params: dict, x, cfg: MoEConfig,
                      chunk: int = 256) -> torch.Tensor:
    """The inference semantics: [.., D] -> [.., D] in x's dtype, every token
    through all of its k experts (no capacity). All E experts run on every
    token, ``chunk`` tokens at a time, bounding the [chunk, E, FF]
    activation; a token's output depends on that token alone."""
    shape = x.shape
    xf = x.reshape(-1, cfg.d_model)
    N = xf.shape[0]
    gates, eidx = _gates(params, xf, cfg)                      # [k, N]
    chunk = max(1, min(chunk, N))
    w1, w2 = params["w1"].float(), params["w2"].float()
    b1, b2 = params["b1"].float()[None], params["b2"].float()[None]
    outs = []
    for s in range(0, N, chunk):
        xc = xf[s:s + chunk].float()
        h = _act(torch.einsum("nd,efd->nef", xc, w1) + b1, cfg)
        out = torch.einsum("nef,edf->ned", h, w2) + b2          # [C, E, D]
        sel = _one_hot(eidx[:, s:s + chunk], cfg.n_experts)     # [k, C, E]
        outs.append(torch.einsum("kne,kn,ned->nd", sel,
                                 gates[:, s:s + chunk], out))
    y = outs[0] if len(outs) == 1 else torch.cat(outs)
    return y.reshape(shape).to(x.dtype)
