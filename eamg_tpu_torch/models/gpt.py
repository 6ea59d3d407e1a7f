"""The GPT decoder, in PyTorch: ``init_params``, ``forward``,
``forward_hidden``, ``forward_masked``, ``prefill``, ``decode_step``,
``decode_block``, and the training forward ``forward_hidden_train``.

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
The checkpoint's ``kernels`` field names where the FFN rounds, as in the
JAX model: ``"xla"`` (every shipped demo) rounds as ``_linear`` -> act ->
``_linear`` does, ``"pallas"`` as the fused kernel does
(``ops/ffn.py::ffn_plain``); K2 runs either way.

The KV cache has two layouts. ``"head"`` is the JAX model's: per layer
``k`` and ``v`` ``[B, Hkv, M, Dh]``. ``"fused"`` is position-major,
``kv [B, M, 2 * KVD]`` per layer: a cache row is the tail of the fused
QKV projection, so a decode step writes one contiguous slice per layer
(``ops/decode_fold.py``); the ragged decode keeps its cache the same way
and shares the layer code below. ``decode_step(..., attn_impl=...)`` names
the decode attention kernel, each under the name of the JAX function it
replaces (:data:`ATTN_IMPLS`); every one computes the same function.

``decode_block`` is the verify step of the speculative decoders: G tokens
from the cache position t, each attending to the cached prefix and
causally within the block; ``decode_tree`` is the Medusa-2 one, N nodes of
a candidate tree, each seeing the prefix and its ancestors. JAX computes
their attention in XLA, outside any Pallas kernel, so it stays plain
products here too, rounded as JAX rounds them; their FFN goes through K2
at G (N) rows.

``forward_hidden_train`` is the differentiable forward of the trainer. It
follows the JAX model's ``kernels="xla"`` branches, which JAX's training
step runs (no Pallas kernel of the JAX package has a backward rule):
per-segment positions and block-diagonal attention for packed ``seg``
rows, the ``batch_first_bug`` swap, dense attention (grouped scores in the
activation dtype, masks at ``finfo(dt).min``, softmax in f32, probabilities
cast to the values' dtype) or, with ``attn_block``, the blockwise online
softmax, and the FFN as ``_linear`` -> activation -> ``_linear``. It is
plain PyTorch under autograd and never reaches a kernel wrapper (they
refuse inputs that require grad). A checkpoint trained with
``attn_block`` is served through K1, which computes the same function.

int8 weights (``models/quant.py``): a ``{"q", "s"}`` leaf takes the place
of any product weight. ``_linear`` computes JAX's ``x @ q.T`` in the
activation dtype, then ``y * s + b``, a plain ``torch.matmul`` on every
route (JAX computes it outside any Pallas kernel); an int8 FFN therefore
runs ``_linear`` -> activation -> ``_linear`` and not K2, as JAX's XLA
route does. Float layers keep K2.

MoE layers (``n_experts``): every ``moe_every``-th layer, counting from
the ``moe_every - 1``-th, holds a router and E experts in place of its MLP
(``parallel/moe.py``). Inference and every decode route use the pointwise
no-drop path, so a decode step, a full forward and an engine row agree;
the training forward with a loss sink (``forward_hidden_with_aux``) uses
the capacity-bounded dispatch and collects each MoE layer's load-balance
loss, as JAX's trainer does. Dense layers of such a model stay on K2.

Every inference function takes ``tp=``: a ``parallel.collectives.
TensorParallel`` and ``params`` this rank's blocks
(``parallel/mesh.py::shard_params(tp=True)``). A layer then runs this
rank's query and K/V heads (a cache of its K/V heads), its FF columns
and its vocabulary rows; the out-projection and K2's partial sums are
summed over the model group and the logits gathered, so the hidden states
and the logits are whole on every rank. ``tp=None`` issues no collective.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.attention import flash_attention
from ..ops.decode_attention import (flash_decode, flash_decode_sp,
                                    flash_decode_vmem)
from ..ops.decode_fold import (flash_decode_fold, flash_decode_fold2,
                               flash_decode_fold3, flash_decode_fold3_sp,
                               flash_decode_fold_sp)
from ..ops.ffn import fused_ffn
from ..parallel.moe import (MoEConfig, init_moe_params, load_balance_loss,
                            moe_mlp_dense, moe_mlp_pointwise)

# decode_step's attention kernels by cache layout: name -> wrapper.
# "dma" and "vmem" are the JAX package's flash_decode (manual copies of
# 256-key blocks) and flash_decode_vmem (the whole cache in fast memory):
# MHA and a uniform batch only.
HEAD_IMPLS = {"sp": flash_decode_sp, "dma": flash_decode,
              "vmem": flash_decode_vmem}
def _fold2(q, kv, t, n_head):
    """flash_decode_fold2 with as many of its 4 rows per block as divide
    the batch (its result does not depend on them)."""
    return flash_decode_fold2(q, kv, t, n_head, rows=math.gcd(q.shape[0], 4))


FOLD_IMPLS = {"fold": flash_decode_fold, "fold2": _fold2,
              "fold3": flash_decode_fold3, "fold_sp": flash_decode_fold_sp,
              "fold3_sp": flash_decode_fold3_sp}
ATTN_IMPLS = (*HEAD_IMPLS, *FOLD_IMPLS)
# attn_impl -> the kernel wrapper it launches (the name of its launch count)
IMPL_KERNEL = {"sp": "flash_decode_sp", "dma": "flash_decode",
               "vmem": "flash_decode_vmem",
               **{impl: "flash_decode_" + impl for impl in FOLD_IMPLS}}


def cache_layout(attn_impl: str, cfg: GPTConfig) -> str:
    """The cache layout ``attn_impl`` reads; raises on an unknown name and
    on ``"dma"`` / ``"vmem"`` for a GQA model."""
    if attn_impl in HEAD_IMPLS:
        if attn_impl != "sp" and cfg.kv_heads != cfg.n_head:
            raise ValueError(f"attn_impl {attn_impl!r} takes MHA caches "
                             f"only; the model has {cfg.kv_heads} KV heads "
                             f"for {cfg.n_head} query heads")
        return "head"
    if attn_impl in FOLD_IMPLS:
        return "fused"
    raise ValueError(f"attn_impl {attn_impl!r}: one of {ATTN_IMPLS}")


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


def is_moe_layer(cfg: GPTConfig, li: int) -> bool:
    return bool(cfg.n_experts) and li % cfg.moe_every == cfg.moe_every - 1


def _moe_cfg(cfg: GPTConfig) -> MoEConfig:
    return MoEConfig(d_model=cfg.d_model, d_ff=cfg.ff,
                     n_experts=cfg.n_experts, top_k=cfg.moe_top_k,
                     capacity_factor=cfg.moe_capacity_factor,
                     activation=cfg.activation)


# ------------------------------------------------------------------- init

def init_params(rng, cfg: GPTConfig, device=None) -> dict:
    """Random parameters in the tree and with the distributions of the JAX
    package's ``init_params`` (torch's default initialisers: embedding
    N(0, 1), zero positions, Xavier-uniform ``in_proj``, Kaiming-uniform
    linears with fan-in bias bounds), f32, drawn in JAX's order.

    ``rng`` is a threefry key (``utils.prng.PRNGKey(seed)``): every uniform
    leaf then equals JAX's bit for bit and the N(0, 1) ``tok_emb`` is drawn
    through XLA's f32 ``erf_inv`` (:func:`erf_inv_f32`), on ``device``
    (default the CPU); an MoE layer's router and experts take one key, as
    in JAX. ``rng`` may also be a ``torch.Generator`` for a dense model:
    the values are then that generator's, on its device (``bench.py``'s
    weights)."""
    if isinstance(rng, torch.Generator):
        if cfg.n_experts:
            raise ValueError("MoE weights are drawn from a threefry key "
                             "(utils.prng.PRNGKey), as JAX draws them")
        dev = rng.device

        def uniform(shape, bound):
            return (torch.rand(shape, generator=rng, device=dev) * 2 - 1) \
                * bound

        def normal(shape):
            return torch.randn(shape, generator=rng, device=dev)
    else:
        from ..utils import prng

        dev = torch.device(device or "cpu")
        keys = iter(prng.split(rng, 6 + 12 * cfg.n_layer))

        def uniform(shape, bound):
            return prng.uniform(next(keys), shape, -bound, bound, device=dev)

        def normal(shape):
            return normal_f32(next(keys), shape, device=dev)

    D, FF, V = cfg.d_model, cfg.ff, cfg.vocab_size

    def kaiming(fan_out, fan_in):
        w = uniform((fan_out, fan_in), math.sqrt(6.0 / ((1 + 5) * fan_in)))
        return w, uniform((fan_out,), 1.0 / math.sqrt(fan_in))

    in_rows = D + 2 * cfg.kv_dim
    layers = []
    for li in range(cfg.n_layer):
        # attention first, then the MLP, whose kaiming draws of w1 and w2
        # consume a bias draw each, unused (JAX's order)
        in_w = uniform((in_rows, D), math.sqrt(6.0 / (3 * D + D)))
        out_w, out_b = kaiming(D, D)
        if is_moe_layer(cfg, li):
            # one key, split five ways (JAX's init_moe_params)
            mlp = init_moe_params(next(keys), _moe_cfg(cfg), device=dev)
        else:
            w1, _ = kaiming(FF, D)
            b1 = uniform((FF,), 1.0 / math.sqrt(D))
            w2, _ = kaiming(D, FF)
            b2 = uniform((D,), 1.0 / math.sqrt(FF))
            mlp = {"w1": w1, "b1": b1, "w2": w2, "b2": b2}
        layers.append({
            "attn": {"in_w": in_w, "in_b": torch.zeros(in_rows, device=dev),
                     "out_w": out_w, "out_b": out_b},
            "ln1": {"g": torch.ones(D, device=dev),
                    "b": torch.zeros(D, device=dev)},
            "ln2": {"g": torch.ones(D, device=dev),
                    "b": torch.zeros(D, device=dev)},
            "mlp": mlp,
        })
    head_w, head_b = kaiming(V, D)
    return {"tok_emb": normal((V, D)),
            "pos": torch.zeros((cfg.n_pos, D), device=dev),
            "layers": layers, "head": {"w": head_w, "b": head_b}}


# XLA's f32 erf_inv (Giles' single-precision polynomial in w = -log1p(-x^2),
# one set of coefficients for w < 5 and one for the tails)
_ERF_INV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
                -4.39150654e-06, 0.00021858087, -0.00125372503,
                -0.00417768164, 0.246640727, 1.50140941)
_ERF_INV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322,
                -0.00367342844, 0.00573950773, -0.0076224613,
                0.00943887047, 1.00167406, 2.83297682)


def normal_f32(key, shape, device=None) -> torch.Tensor:
    """``jax.random.normal(key, shape)`` in f32: sqrt(2) erf_inv(u), u
    uniform on [nextafter(-1, 0), 1), through :func:`erf_inv_f32`."""
    from ..utils import prng

    lo = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
    return float(np.float32(math.sqrt(2.0))) * erf_inv_f32(
        prng.uniform(key, shape, lo, 1.0, device=device))


def erf_inv_f32(x: torch.Tensor) -> torch.Tensor:
    """erf^-1 of f32 ``x`` as XLA computes it in f32: the polynomial's
    multiply-adds fused (a product of two f32 values is exact in f64, so an
    f64 sum rounded to f32 is the fused result), log1p in f64 rounded to
    f32, and +-inf at +-1. Against XLA:CPU's ``lax.erf_inv`` it differs by
    at most 2 ulps on ~1% of uniform inputs (XLA:CPU's log1p rounds
    elsewhere); the card and the host differ on a few in a million (f64
    log1p), by at most 2 ulps."""
    w = (-torch.log1p(-(x * x).double())).float()
    lt = w < 5.0
    w = torch.where(lt, w - 2.5, torch.sqrt(w) - 3.0).double()

    def coef(i):
        return torch.where(lt, float(np.float32(_ERF_INV_LT5[i])),
                           float(np.float32(_ERF_INV_GE5[i]))).double()

    p = coef(0)
    for i in range(1, len(_ERF_INV_LT5)):
        p = (coef(i) + p * w).float().double()
    r = p.float() * x
    return torch.where(x.abs() == 1.0, x * torch.finfo(torch.float32).max, r)


# ---------------------------------------------------------------- compute

def _layer_norm(x, g, b, eps):
    """LayerNorm in float32, output in the input dtype."""
    return F.layer_norm(x.float(), (x.shape[-1],), g.float(), b.float(),
                        eps).to(x.dtype)


def _linear(x, w, b):
    """torch layout (w [out, in]); weights cast to the activation dtype. An
    int8 ``{"q", "s"}`` weight: ``x @ q.T`` in the activation dtype, then
    the scale and the bias (JAX's order)."""
    if isinstance(w, dict):
        y = torch.matmul(x, w["q"].to(x.dtype).T)
        return y * w["s"].to(x.dtype) + b.to(x.dtype)
    return torch.matmul(x, w.to(x.dtype).T) + b.to(x.dtype)


def _split_qkv(p, qd: int | None = None):
    """The fused in_proj's Q, K and V rows (K and V kv_dim rows each), a
    float or an int8 weight. ``qd``: the Q rows (a tensor-parallel block
    holds its heads' rows: :func:`_qkv_dims`), else d_model."""
    w = p["in_w"]
    q = w["q"] if isinstance(w, dict) else w
    D = qd or q.shape[1]
    kvd = (q.shape[0] - D) // 2

    def rows(a, b):
        if isinstance(w, dict):
            return {"q": w["q"][a:b], "s": w["s"][a:b]}
        return w[a:b]

    return ((rows(0, D), p["in_b"][:D]),
            (rows(D, D + kvd), p["in_b"][D:D + kvd]),
            (rows(D + kvd, D + 2 * kvd), p["in_b"][D + kvd:]))


def _qkv_dims(cfg: GPTConfig, tp=None) -> tuple:
    """(query heads, K/V heads) of this rank: the model's, or the share of
    a ``parallel.collectives.TensorParallel``."""
    return (tp.n_head, tp.kv_heads) if tp is not None else \
        (cfg.n_head, cfg.kv_heads)


def _row_linear(x, w, b, tp=None):
    """``_linear`` of a row-parallel product under ``tp``: this rank's
    partial product, summed over the model group, then the bias once."""
    if tp is None:
        return _linear(x, w, b)
    if isinstance(w, dict):
        raise ValueError("tensor parallelism takes float weights")
    return tp.reduce(torch.matmul(x, w.to(x.dtype).T)) + b.to(x.dtype)


def _heads(x, n_head):
    B, T, D = x.shape
    return x.reshape(B, T, n_head, D // n_head).transpose(1, 2).contiguous()


def _unheads(x):
    B, H, T, Dh = x.shape
    return x.transpose(1, 2).reshape(B, T, H * Dh)


def attention(p_attn: dict, x, cfg: GPTConfig, causal: bool = False,
              valid_len=None, tp=None):
    """Self-attention with the fused in_proj (q = k = v input); under
    ``tp`` on this rank's heads, the out-projection summed over the model
    group."""
    H, Hkv = _qkv_dims(cfg, tp)
    (wq, bq), (wk, bk), (wv, bv) = _split_qkv(p_attn, H * cfg.head_dim)
    q = _heads(_linear(x, wq, bq), H)
    k = _heads(_linear(x, wk, bk), Hkv)
    v = _heads(_linear(x, wv, bv), Hkv)
    out = _unheads(flash_attention(q, k, v, valid_len=valid_len,
                                   causal=causal))
    return _row_linear(out, p_attn["out_w"], p_attn["out_b"], tp), k, v


def _mlp(p, x, cfg: GPTConfig, tp=None):
    """The FFN of inference and decoding: an MoE layer's pointwise experts,
    an int8 layer's ``_linear`` route, else K2. Under ``tp``, K2 runs this
    rank's FF columns with a zero ``b2``, and ``b2`` is added once, after
    the sum over the model group."""
    if "router" in p:
        return moe_mlp_pointwise(p, x, _moe_cfg(cfg), tp=tp)
    if isinstance(p["w1"], dict):
        return _mlp_train(p, x, cfg, tp=tp)
    if tp is None:
        return fused_ffn(x, p["w1"], p["b1"], p["w2"], p["b2"],
                         activation=cfg.activation, order=cfg.kernels)
    part = fused_ffn(x, p["w1"], p["b1"], p["w2"], torch.zeros_like(p["b2"]),
                     activation=cfg.activation, order=cfg.kernels)
    return tp.reduce(part) + p["b2"].to(x.dtype)


def _mlp_for(tp):
    """K2's wrapper as :func:`_finish_block` takes it, on this rank's FF
    columns under ``tp``."""
    return _mlp if tp is None else (lambda q, h, c: _mlp(q, h, c, tp=tp))


def _attn_input(p: dict, x, cfg: GPTConfig):
    if cfg.ln_placement == "post":
        return x
    return _layer_norm(x, p["ln1"]["g"], p["ln1"]["b"], cfg.ln_eps)


def _finish_block(p: dict, x, attn_out, cfg: GPTConfig, mlp=_mlp):
    """Residual + FFN wiring after attention, for both LN placements;
    ``mlp`` is K2's wrapper, or the training forward's plain FFN."""
    eps = cfg.ln_eps
    if cfg.ln_placement == "post":
        x = _layer_norm(x + attn_out, p["ln1"]["g"], p["ln1"]["b"], eps)
        return _layer_norm(x + mlp(p["mlp"], x, cfg),
                           p["ln2"]["g"], p["ln2"]["b"], eps)
    x = x + attn_out
    return x + mlp(p["mlp"],
                   _layer_norm(x, p["ln2"]["g"], p["ln2"]["b"], eps), cfg)


def block(p: dict, x, cfg: GPTConfig, causal: bool = False, valid_len=None,
          tp=None):
    """One transformer block -> (x, k, v); k/v are the block's projected
    keys and values [B, Hkv, T, Dh] (prefill stores them in the cache)."""
    attn_out, k, v = attention(p["attn"], _attn_input(p, x, cfg), cfg,
                               causal, valid_len, tp)
    return _finish_block(p, x, attn_out, cfg, mlp=_mlp_for(tp)), k, v


def _embed(params, ids, pos_rows, dt):
    """Token + position embedding in f32, then cast to the activation
    dtype. XLA keeps the sum of two bf16 tables in f32 when the result is
    cast to f32 anyway (excess precision), and rounds it once when cast to
    bf16; adding in f32 gives both."""
    return (params["tok_emb"][ids].float() + pos_rows.float()).to(dt)


def _head(params, x, tp=None):
    """f32 logits; under ``tp`` this rank's rows of the vocabulary,
    gathered over the model group (the whole row on every rank)."""
    if tp is None:
        return _linear(x.float(), params["head"]["w"], params["head"]["b"])
    return tp.gather(_linear(tp.copy(x.float()), params["head"]["w"],
                             params["head"]["b"]), -1)


@torch.no_grad()
def forward(params: dict, ids: torch.Tensor, cfg: GPTConfig,
            tp=None) -> torch.Tensor:
    """Full-sequence forward: [B, T] ids -> [B, T, V] f32 logits. ``tp``:
    this rank's heads, FF columns and vocabulary rows (:func:`block`,
    :func:`_head`), the logits whole on every rank."""
    return _head(params, forward_hidden(params, ids, cfg, tp=tp), tp)


@torch.no_grad()
def forward_hidden(params: dict, ids: torch.Tensor, cfg: GPTConfig,
                   valid_len=None, tp=None) -> torch.Tensor:
    """The transformer stack without the head: [B, T] ids -> [B, T, D]
    states in the activation dtype (the Medusa probe applies the heads to
    them), whole on every rank under ``tp``. ``valid_len`` ([B] int32):
    keys at or past it are masked for every query."""
    T = ids.shape[1]
    x = _embed(params, ids, params["pos"][:T], cfg.torch_dtype)
    if cfg.batch_first_bug:
        # the reference encoder read [B, T, C] as [T, B, C]
        x = x.transpose(0, 1).contiguous()
    for p in params["layers"]:
        x, _, _ = block(p, x, cfg, causal=cfg.causal, valid_len=valid_len,
                        tp=tp)
    if cfg.batch_first_bug:
        x = x.transpose(0, 1)
    return x


@torch.no_grad()
def forward_masked(params: dict, ids: torch.Tensor, cfg: GPTConfig,
                   valid_len: int, tp=None) -> torch.Tensor:
    """:func:`forward` with only the first ``valid_len`` positions present:
    keys past them are masked for every query, as if ``ids[:, :valid_len]``
    had been given. The uncached loop calls it at one shape for every
    prefix length. With ``batch_first_bug`` it is plain :func:`forward`, as
    in the JAX package."""
    if cfg.batch_first_bug:
        return forward(params, ids, cfg, tp=tp)
    valid = torch.full((ids.shape[0],), int(valid_len), dtype=torch.int32,
                       device=ids.device)
    return _head(params, forward_hidden(params, ids, cfg, valid, tp), tp)


# ------------------------------------------------------- training forward

def _in_dtype(value: float, dt: torch.dtype) -> float:
    """A Python scalar rounded to ``dt``, as XLA rounds a weakly typed
    constant to the array it multiplies."""
    return float(torch.tensor(value, dtype=dt))


def _gqa_scores(q, k, sm_scale: float):
    """q [B, H, T, Dh] x k [B, Hkv, M, Dh] -> [B, H, T, M] in the
    activation dtype, the K/V heads shared by groups of H // Hkv queries."""
    B, H, T, Dh = q.shape
    Hkv = k.shape[1]
    s = torch.einsum("bkgqd,bkmd->bkgqm", q.reshape(B, Hkv, H // Hkv, T, Dh),
                     k)
    return (s * _in_dtype(sm_scale, s.dtype)).reshape(B, H, T, k.shape[2])


def _gqa_values(probs, v):
    """probs [B, H, T, M] x v [B, Hkv, M, Dh] -> [B, H, T, Dh]."""
    B, H, T, M = probs.shape
    Hkv = v.shape[1]
    out = torch.einsum("bkgqm,bkmd->bkgqd",
                       probs.reshape(B, Hkv, H // Hkv, T, M), v)
    return out.reshape(B, H, T, v.shape[3])


def _blockwise_attention(q, k, v, sm_scale: float, causal: bool,
                         block: int):
    """JAX's ``_blockwise_attention``: the online softmax over key blocks
    of ``block`` (a Python loop, as JAX unrolls it), a running f32 row
    max, denominator and accumulator; masked scores at -inf, all-masked
    rows shifted by 0; p rounded to the values' dtype before its product,
    which accumulates in f32."""
    B, H, T, Dh = q.shape
    Hkv = v.shape[1]
    T_k = k.shape[2]
    nb = -(-T_k // block)
    pad = nb * block - T_k
    if pad:
        k = F.pad(k, (0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, pad))
    qg = q.reshape(B, Hkv, H // Hkv, T, Dh)
    rows = torch.arange(T, device=q.device)[:, None]
    m = torch.full((B, Hkv, H // Hkv, T), -math.inf, device=q.device)
    l = torch.zeros((B, Hkv, H // Hkv, T), device=q.device)
    acc = torch.zeros((B, Hkv, H // Hkv, T, Dh), device=q.device)
    scale = _in_dtype(sm_scale, q.dtype)
    for b in range(nb):
        kblk = k[:, :, b * block:(b + 1) * block]
        vblk = v[:, :, b * block:(b + 1) * block]
        s = (torch.einsum("bkgqd,bkmd->bkgqm", qg, kblk) * scale).float()
        cols = b * block + torch.arange(block, device=q.device)[None, :]
        mask = cols < T_k
        if causal:
            mask = mask & (cols <= rows)
        s = torch.where(mask, s, -math.inf)
        m_new = torch.maximum(m, torch.amax(s, dim=-1))
        # all-masked rows keep m == -inf; shift by 0 there
        shift = torch.where(torch.isfinite(m_new), m_new, 0.0)
        p = torch.exp(s - shift[..., None])
        corr = torch.exp(torch.where(torch.isfinite(m), m - shift,
                                     -math.inf))
        l = l * corr + p.sum(-1)
        pv = torch.einsum("bkgqm,bkmd->bkgqd", p.to(vblk.dtype).float(),
                          vblk.float())
        acc = acc * corr[..., None] + pv
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.reshape(B, H, T, Dh).to(v.dtype)


def _attention_train(p_attn: dict, x, cfg: GPTConfig, causal: bool,
                     seg=None, tp=None):
    """Self-attention as JAX's XLA branch computes it (``attention`` with
    ``kernels="xla"``): dense, or blockwise with ``attn_block`` (not with
    ``seg``, as in JAX). Under ``tp`` (Megatron): x enters the model group's
    region, this rank's heads attend, and the out-projection's partial
    products are summed over the group before ``out_b``."""
    if tp is not None:
        x = tp.copy(x)
    H, Hkv = _qkv_dims(cfg, tp)
    (wq, bq), (wk, bk), (wv, bv) = _split_qkv(p_attn, H * cfg.head_dim)
    q = _heads(_linear(x, wq, bq), H)
    k = _heads(_linear(x, wk, bk), Hkv)
    v = _heads(_linear(x, wv, bv), Hkv)
    sm_scale = 1.0 / math.sqrt(cfg.head_dim)
    if cfg.attn_block is not None and seg is None:
        out = _blockwise_attention(q, k, v, sm_scale, causal, cfg.attn_block)
        return _row_linear(_unheads(out), p_attn["out_w"], p_attn["out_b"],
                           tp)
    scores = _gqa_scores(q, k, sm_scale)
    T_q, T_k = scores.shape[-2], scores.shape[-1]
    if causal or seg is not None:
        mask = torch.ones((T_q, T_k), dtype=torch.bool, device=x.device)
        if causal:
            mask = torch.tril(mask)
        mask = mask[None, None]
        if seg is not None:
            mask = mask & (seg[:, None, :, None] == seg[:, None, None, :])
        scores = torch.where(mask, scores, torch.finfo(scores.dtype).min)
    probs = torch.softmax(scores.float(), dim=-1).to(v.dtype)
    out = _unheads(_gqa_values(probs, v))
    return _row_linear(out, p_attn["out_w"], p_attn["out_b"], tp)


def _gelu_exact(h):
    """``jax.nn.gelu(h, approximate=False)`` in h's dtype:
    ``0.5 h * erfc(-h sqrt(1/2))``, the constant rounded to that dtype."""
    c = _in_dtype(math.sqrt(0.5), h.dtype)
    e = torch.special.erfc(-h.float() * c).to(h.dtype).float()
    return ((0.5 * h.float()) * e).to(h.dtype)


def _mlp_train(p, x, cfg: GPTConfig, sink=None, tp=None):
    """The FFN of JAX's XLA branch: ``_linear`` -> activation ->
    ``_linear``, each product and bias add rounded to the activation
    dtype. An MoE layer takes the capacity-bounded dispatch and appends its
    load-balance loss when ``sink`` (a list) is given, the pointwise path
    when not (JAX's ``_mlp``). Under ``tp``: this rank's FF rows of ``w1``
    and columns of ``w2`` (an MoE layer: its experts), the partial sums
    summed over the model group before ``b2``."""
    if "router" in p:
        if sink is None:
            return moe_mlp_pointwise(p, x, _moe_cfg(cfg), tp=tp)
        sink.append(load_balance_loss(p, x.reshape(-1, cfg.d_model),
                                      _moe_cfg(cfg),
                                      getattr(sink, "group", None)))
        return moe_mlp_dense(p, x, _moe_cfg(cfg), tp=tp)
    if tp is not None:
        x = tp.copy(x)
    h = _linear(x, p["w1"], p["b1"])
    h = _gelu_exact(h) if cfg.activation == "gelu" else torch.relu(h)
    return _row_linear(h, p["w2"], p["b2"], tp)


class _GroupSink(list):
    """A loss sink whose load-balance losses span a data group's tokens."""

    def __init__(self, group):
        super().__init__()
        self.group = group


def _pos_from_seg(seg: torch.Tensor) -> torch.Tensor:
    """[B, T] segment ids -> [B, T] positions that restart at 0 at each
    segment boundary (a running max of boundary-stamped indices)."""
    B, T = seg.shape
    ar = torch.arange(T, device=seg.device)[None, :].expand(B, T)
    boundary = torch.cat([torch.ones((B, 1), dtype=torch.bool,
                                     device=seg.device),
                          seg[:, 1:] != seg[:, :-1]], dim=1)
    starts = torch.cummax(torch.where(boundary, ar, 0), dim=1).values
    return ar - starts


def forward_hidden_train(params: dict, ids: torch.Tensor, cfg: GPTConfig,
                         seg: torch.Tensor | None = None,
                         sink: list | None = None, tp=None) -> torch.Tensor:
    """The differentiable transformer stack of the trainer: [B, T] ids ->
    [B, T, D] states in the activation dtype (JAX's
    ``_forward_hidden_impl`` on its XLA branches). ``seg`` ([B, T] segment
    ids, 0 = pad) runs packed rows: per-segment positions and
    block-diagonal attention, on the corrected causal configuration only.
    The gathers are ``F.embedding``, whose backward sums a row's
    gradients in a fixed order on the card. ``sink``: a list that collects
    the MoE layers' load-balance losses (their capacity-bounded path).
    ``tp``: a ``parallel.collectives.TensorParallel``, and ``params`` this
    rank's blocks (``parallel/mesh.py``): the Megatron forward, the states
    whole on every rank of the model group."""
    ids = ids.long()
    T = ids.shape[1]
    if seg is None:
        pos = params["pos"][:T]
    else:
        if not cfg.causal or cfg.batch_first_bug:
            raise ValueError("packed training requires causal=True without "
                             "batch_first_bug")
        pos = F.embedding(_pos_from_seg(seg), params["pos"])
    x = (F.embedding(ids, params["tok_emb"]) + pos).to(cfg.torch_dtype)
    if cfg.batch_first_bug:
        # the reference encoder read [B, T, C] as [T, B, C]: attention
        # runs across the batch at every time position
        x = x.transpose(0, 1)
    for p in params["layers"]:
        x = train_block(p, x, cfg, seg, sink, tp)
    if cfg.batch_first_bug:
        x = x.transpose(0, 1)
    return x


def train_block(p: dict, x, cfg: GPTConfig, seg=None, sink=None, tp=None):
    """One layer of :func:`forward_hidden_train` (the pipeline's stages
    apply their layers with it)."""
    attn_out = _attention_train(p["attn"], _attn_input(p, x, cfg), cfg,
                                cfg.causal, seg, tp)
    return _finish_block(p, x, attn_out, cfg,
                         mlp=lambda q, h, c: _mlp_train(q, h, c, sink, tp))


def forward_hidden_with_aux(params: dict, ids: torch.Tensor, cfg: GPTConfig,
                            tp=None, dp=None):
    """:func:`forward_hidden_train` -> (states, the mean load-balance loss
    over the MoE layers, 0 for a dense model). ``dp``: a data group whose
    ranks hold the other rows of the batch; the load-balance loss is then
    taken over all of their tokens (``load_balance_loss(group=)``)."""
    sink: list = [] if dp is None else _GroupSink(dp)
    x = forward_hidden_train(params, ids, cfg, sink=sink, tp=tp)
    aux = sum(sink) / len(sink) if sink else torch.zeros((), device=x.device)
    return x, aux


# ------------------------------------------------------------ KV decoding

def init_kv_cache(cfg: GPTConfig, batch: int, max_len: int | None = None,
                  device=None, layout: str = "head", tp=None) -> dict:
    """``layout="head"``: per-layer [B, Hkv, max_len, Dh] key and value
    caches ``k``, ``v``. ``layout="fused"``: per-layer position-major
    ``kv`` [B, max_len, 2 * KVD]. ``length`` is a [1] int32 tensor on the
    cache's device, read and advanced there: a decode step reads no host
    value, so a CUDA graph can hold it (``decode/graphs.py``). Under
    ``tp`` either layout holds this rank's K/V heads (Hkv of
    :func:`_qkv_dims`; a fused row is then [2 * Hkv_r * Dh], the tail of
    the rank's QKV projection)."""
    max_len = max_len or cfg.seq_len
    dt = cfg.torch_dtype
    length = torch.zeros((1,), dtype=torch.int32, device=device)
    Hkv = _qkv_dims(cfg, tp)[1]
    if layout == "fused":
        shape = (batch, max_len, 2 * Hkv * cfg.head_dim)
        return {"kv": [torch.zeros(shape, dtype=dt, device=device)
                       for _ in range(cfg.n_layer)],
                "length": length}
    if layout != "head":
        raise ValueError(f"layout {layout!r}: 'head' or 'fused'")
    shape = (batch, Hkv, max_len, cfg.head_dim)
    return {"k": [torch.zeros(shape, dtype=dt, device=device)
                  for _ in range(cfg.n_layer)],
            "v": [torch.zeros(shape, dtype=dt, device=device)
                  for _ in range(cfg.n_layer)],
            "length": length}


@torch.no_grad()
def prefill(params: dict, ids: torch.Tensor, cfg: GPTConfig, cache: dict,
            prompt_len: int | None = None, tp=None):
    """Warm-up pass over the [B, P] prompt bucket -> ([B, P, V] logits,
    cache). Keys past ``prompt_len`` are masked, but K/V of all P slots,
    pads included, are written to the cache (as the JAX model does); decode
    then overwrites slot t. Updates the cache in place, in the layout it
    was made with; ``length`` is set in place. ``tp``: this rank's heads
    and FF columns (:func:`block`), the logits gathered whole."""
    B, T = ids.shape
    plen = prompt_len if prompt_len is not None else T
    valid = torch.full((B,), plen, dtype=torch.int32, device=ids.device)
    if "kv" in cache:
        logits = prefill_fused(params, ids, valid, cfg, cache["kv"], tp)
        cache["length"].fill_(int(plen))
        return logits, cache
    x = _embed(params, ids, params["pos"][:T], cfg.torch_dtype)
    for li, p in enumerate(params["layers"]):
        x, k, v = block(p, x, cfg, causal=cfg.causal, valid_len=valid, tp=tp)
        cache["k"][li][:, :, :T] = k
        cache["v"][li][:, :, :T] = v
    cache["length"].fill_(int(plen))
    return _head(params, x, tp), cache


def prefill_fused(params: dict, ids: torch.Tensor, valid: torch.Tensor,
                  cfg: GPTConfig, kv: list, tp=None) -> torch.Tensor:
    """Prefill over the fused position-major cache ``kv`` (per layer
    [B, M, 2 * KVD], written in place): the rows of the [B, T] prompt
    bucket are the tail of the fused QKV projection and go straight into
    it, pads included; keys at or past ``valid[b]`` are masked. The uniform
    and the ragged decode share it. ``tp``: this rank's heads (its cache
    rows are the tail of its own projection), FF columns and vocabulary
    rows, the out-projection and the FFN summed over the model group.
    -> [B, T, V] f32 logits, whole on every rank."""
    T = ids.shape[1]
    H, Hkv = _qkv_dims(cfg, tp)
    D, KVD = H * cfg.head_dim, Hkv * cfg.head_dim
    mlp = _mlp_for(tp)
    x = _embed(params, ids, params["pos"][:T], cfg.torch_dtype)
    for li, p in enumerate(params["layers"]):
        qkv = _linear(_attn_input(p, x, cfg), p["attn"]["in_w"],
                      p["attn"]["in_b"])
        kv[li][:, :T] = qkv[..., D:]
        out = flash_attention(_heads(qkv[..., :D], H),
                              _heads(qkv[..., D:D + KVD], Hkv),
                              _heads(qkv[..., D + KVD:], Hkv),
                              valid_len=valid, causal=cfg.causal)
        attn_out = _row_linear(_unheads(out), p["attn"]["out_w"],
                               p["attn"]["out_b"], tp)
        x = _finish_block(p, x, attn_out, cfg, mlp=mlp)
    return _head(params, x, tp)


def decode_layers_fused(params: dict, x: torch.Tensor, kv: list, slot,
                        t_rows: torch.Tensor, cfg: GPTConfig,
                        fold, tp=None) -> torch.Tensor:
    """The layers of one decode step over the fused cache: each layer
    writes the tail of its QKV projection to position ``slot`` of its
    cache rows and attends through ``fold(q, kv, t_rows, n_head)`` with q
    the projection's head, uncopied. ``slot`` is tensors only: a [1] int64
    position for all rows, or a pair ([B] rows, [B] positions). ``tp``:
    this rank's heads (``n_head`` = its query heads) and FF columns, the
    out-projection and the FFN summed over the model group. x [B, 1, D]
    -> [B, 1, D]."""
    H = _qkv_dims(cfg, tp)[0]
    D = H * cfg.head_dim
    mlp = _mlp_for(tp)
    for li, p in enumerate(params["layers"]):
        qkv = _linear(_attn_input(p, x, cfg), p["attn"]["in_w"],
                      p["attn"]["in_b"])                     # [B, 1, D+2KVD]
        if isinstance(slot, tuple):
            kv[li][slot] = qkv[:, 0, D:]
        else:
            kv[li].index_copy_(1, slot, qkv[:, :, D:])
        attn_out = _row_linear(fold(qkv[..., :D], kv[li], t_rows, H),
                               p["attn"]["out_w"], p["attn"]["out_b"], tp)
        x = _finish_block(p, x, attn_out, cfg, mlp=mlp)
    return x


@torch.no_grad()
def decode_step(params: dict, last_ids: torch.Tensor, cache: dict,
                cfg: GPTConfig, attn_impl: str = "sp", tp=None):
    """One cached step: [B, 1] ids + cache -> ([B, V] f32 logits, cache).
    The new token's K/V go to slot t = cache["length"] and its query
    attends to slots 0..t through the kernel ``attn_impl`` names
    (:data:`ATTN_IMPLS`; the cache must have that kernel's layout).
    Updates the cache in place, ``length`` included. t is read on the
    device only (the position row by ``index_select``, the cache writes by
    ``index_copy_``, the kernels through a pointer), so a CUDA graph can
    hold the step. A step past the cache or the positional table clamps
    to its last slot and row, as XLA's dynamic slices do; the decode loops
    run such steps only after a request has ended, and drop them. ``tp``:
    this rank's heads (a cache of them, in either layout) and FF columns,
    the out-projection and the FFN summed over the model group, the logits
    gathered whole."""
    layout = cache_layout(attn_impl, cfg)
    if ("kv" in cache) != (layout == "fused"):
        raise ValueError(f"attn_impl {attn_impl!r} reads a {layout!r} cache; "
                         "make it with init_kv_cache(..., layout=...)")
    B = last_ids.shape[0]
    dt = cfg.torch_dtype
    t = cache["length"]                                      # [1] int32
    M = (cache["kv"] if layout == "fused" else cache["k"])[0].shape[
        1 if layout == "fused" else 2]
    n_pos = params["pos"].shape[0]
    slot = t.clamp(max=M - 1).long()
    pos_row = params["pos"][:1] if cfg.pos_broadcast_bug else \
        params["pos"].index_select(0, slot if M <= n_pos
                                   else t.clamp(max=n_pos - 1))
    x = _embed(params, last_ids, pos_row, dt)
    H, Hkv = _qkv_dims(cfg, tp)
    D, KVD = H * cfg.head_dim, Hkv * cfg.head_dim
    # one [B] tensor of positions per step, not per layer
    t_rows = t.expand(B).contiguous()
    if layout == "fused":
        x = decode_layers_fused(params, x, cache["kv"], slot, t_rows, cfg,
                                FOLD_IMPLS[attn_impl], tp)
        cache["length"].add_(1)
        return _head(params, x, tp)[:, 0], cache
    attend = HEAD_IMPLS[attn_impl]
    t_arg = t_rows if attn_impl == "sp" else t
    mlp = _mlp_for(tp)
    for li, p in enumerate(params["layers"]):
        attn_in = _attn_input(p, x, cfg)
        qkv = _linear(attn_in, p["attn"]["in_w"], p["attn"]["in_b"])
        q = _heads(qkv[..., :D], H)                          # [B,H,1,Dh]
        cache["k"][li].index_copy_(2, slot, qkv[:, :, D:D + KVD].reshape(
            B, Hkv, 1, cfg.head_dim))
        cache["v"][li].index_copy_(2, slot, qkv[:, :, D + KVD:].reshape(
            B, Hkv, 1, cfg.head_dim))
        attn_out = _unheads(attend(q, cache["k"][li], cache["v"][li], t_arg))
        attn_out = _row_linear(attn_out, p["attn"]["out_w"],
                               p["attn"]["out_b"], tp)
        x = _finish_block(p, x, attn_out, cfg, mlp=mlp)
    cache["length"].add_(1)
    return _head(params, x, tp)[:, 0], cache


def _masked_attention(q, k_cache, v_cache, valid):
    """Cached attention of G queries, query g seeing the keys where
    ``valid`` [G, M] is true. JAX's XLA math (models/gpt.py ``_gqa_scores``
    / ``_gqa_values``): grouped scores in the cache dtype, scaled after the
    product, masked keys at ``finfo(dt).min``, softmax in f32 cast back,
    grouped values.

    q [B, H, G, Dh], caches [B, Hkv, M, Dh] -> [B, H, G, Dh]."""
    B, H, G, Dh = q.shape
    Hkv = k_cache.shape[1]
    qg = q.reshape(B, Hkv, H // Hkv, G, Dh)
    s = torch.einsum("bkgqd,bkmd->bkgqm", qg, k_cache) * (1.0 / math.sqrt(Dh))
    s = torch.where(valid, s, torch.finfo(s.dtype).min)
    probs = torch.softmax(s.float(), dim=-1).to(v_cache.dtype)
    out = torch.einsum("bkgqm,bkmd->bkgqd", probs, v_cache)
    return out.reshape(B, H, G, Dh)


def _block_layers(params: dict, x: torch.Tensor, cache: dict, slots, valid,
                  cfg: GPTConfig, tp=None) -> torch.Tensor:
    """The layers of a cached block of G queries (:func:`decode_block`,
    :func:`decode_tree`): each writes the block's K/V to ``slots`` ([G], on
    the device) of its head-major cache and attends where ``valid`` [G, M]
    is true. ``tp``: this rank's heads (a cache of them) and FF columns,
    the out-projection and K2's partial sums summed over the model group,
    so x stays whole on every rank. x [B, G, D] -> [B, G, D]."""
    H, Hkv = _qkv_dims(cfg, tp)
    D, KVD = H * cfg.head_dim, Hkv * cfg.head_dim
    mlp = _mlp_for(tp)
    for li, p in enumerate(params["layers"]):
        qkv = _linear(_attn_input(p, x, cfg), p["attn"]["in_w"],
                      p["attn"]["in_b"])
        q = _heads(qkv[..., :D], H)                          # [B,H,G,Dh]
        cache["k"][li].index_copy_(2, slots, _heads(qkv[..., D:D + KVD], Hkv))
        cache["v"][li].index_copy_(2, slots, _heads(qkv[..., D + KVD:], Hkv))
        attn_out = _unheads(_masked_attention(q, cache["k"][li],
                                              cache["v"][li], valid))
        attn_out = _row_linear(attn_out, p["attn"]["out_w"],
                               p["attn"]["out_b"], tp)
        x = _finish_block(p, x, attn_out, cfg, mlp=mlp)
    return x


@torch.no_grad()
def decode_block(params: dict, ids: torch.Tensor, cache: dict,
                 cfg: GPTConfig, return_hidden: bool = False, tp=None):
    """Multi-token cached decode: [B, G] ids from cache position t =
    ``cache["length"]`` -> ([B, G, V] f32 logits, cache with length t + G),
    or with ``return_hidden`` ([B, G, V] logits, [B, G, D] final hidden
    states, cache). The verify step of the speculative decoders: each of
    the G tokens attends to the cached prefix and to the block up to
    itself. The block's K/V go to slots t..t+G-1 by ``index_copy_`` and
    its position rows by ``index_select``, both at device positions, so a
    CUDA graph can hold the step; the cache is updated in place. ``tp``:
    this rank's heads (a cache of its K/V heads), FF columns and
    vocabulary rows (:func:`_block_layers`); the hidden states are taken
    after the sums and the logits gathered, both whole on every rank.

    The start of the position rows and of the cache write clamps as XLA's
    dynamic slices clamp theirs (to n_pos - G and M - G). The speculative
    decoders cut ``max_len`` to n_pos - gamma and size the cache max_len +
    gamma + 1, so an iteration that runs (pos < max_len, t = pos - 1, G =
    gamma + 1) reads rows up to t + G - 1 <= n_pos - 2 and writes slots up
    to max_len + gamma - 1: neither clamps. Requires the corrected causal
    configuration and the head-major cache."""
    assert cfg.causal and not cfg.pos_broadcast_bug, \
        "decode_block requires the corrected causal configuration"
    B, G = ids.shape
    t = cache["length"].long()                               # [1]
    M = cache["k"][0].shape[2]
    offs = torch.arange(G, device=ids.device)
    n_pos = params["pos"].shape[0]
    x = _embed(params, ids, params["pos"].index_select(
        0, t.clamp(max=n_pos - G) + offs), cfg.torch_dtype)
    # query g sees the keys at or before its position t + g
    valid = torch.arange(M, device=ids.device)[None, :] <= (t + offs)[:, None]
    x = _block_layers(params, x, cache, t.clamp(max=M - G) + offs, valid,
                      cfg, tp)
    cache["length"].add_(G)
    logits = _head(params, x, tp)
    if return_hidden:
        return logits, x, cache
    return logits, cache


@torch.no_grad()
def decode_tree(params: dict, ids: torch.Tensor, depths: torch.Tensor,
                anc: torch.Tensor, cache: dict, cfg: GPTConfig, tp=None):
    """Tree-attention cached decode, the Medusa-2 verify step
    (``decode/medusa_tree.py``): [1, N] candidate tokens arranged as a tree
    over the cache position t = ``cache["length"]`` -> ([1, N, V] f32
    logits, [1, N, D] final hidden states, the cache with the N staged
    entries written at slots t..t+N-1 and ``length`` unchanged: the caller
    commits the accepted path). ``tp`` as in :func:`decode_block`.

    ``depths`` [N]: node depths (root 0), so a node sits at position t +
    depth and siblings share a position (rows past the positional table
    read its last row, as JAX's clamped gather does). ``anc`` [N, N] bool:
    anc[q, j] is true when node j is q or an ancestor of q, the block's
    visibility; every node sees the whole cached prefix. Both on the
    cache's device. The writes go by ``index_copy_`` and the positions by
    ``index_select`` at device positions, as in :func:`decode_block`, so a
    CUDA graph can hold it; the write's start clamps to M - N as XLA's
    dynamic slice does."""
    assert cfg.causal and not cfg.pos_broadcast_bug
    B, N = ids.shape
    assert B == 1, "tree verify is a batch-1 latency optimization"
    t = cache["length"].long()                               # [1]
    M = cache["k"][0].shape[2]
    n_pos = params["pos"].shape[0]
    x = _embed(params, ids, params["pos"].index_select(
        0, (t + depths).clamp(max=n_pos - 1)), cfg.torch_dtype)
    offs = torch.arange(N, device=ids.device)
    key_pos = torch.arange(M, device=ids.device)
    block_idx = key_pos - t                                  # [M]
    in_block = (block_idx >= 0) & (block_idx < N)
    valid = (key_pos[None, :] < t) | (
        in_block[None, :] & anc.index_select(1, block_idx.clamp(0, N - 1)))
    x = _block_layers(params, x, cache, t.clamp(max=M - N) + offs, valid,
                      cfg, tp)
    return _head(params, x, tp), x, cache
