"""The trainer: next-token CE with PAD masked, gradient accumulation and
AdamW with optax's arithmetic.

Port of ``eamg_tpu/train/trainer.py``, on one device or on a
(data, model) mesh of ranks (``parallel/mesh.py``):
- ``TrainConfig`` and ``reference_preset``: the four reference trainers'
  recipes and the paper's (AdamW beta2 0.95, clip 1.0, warmup + cosine);
- the losses: ``masked_ce_sums`` (sums, so micro-batches accumulate before
  the division), ``loss_fn``, ``loss_fn_packed``, ``loss_fn_moe`` (CE plus
  the MoE load-balance loss) and ``loss_fn_chunked``
  (the head and the CE a time chunk at a time under
  ``torch.utils.checkpoint``, so the [B, T, V] logits never exist at once;
  T is padded to a multiple of the chunk with PAD targets);
- ``make_optimizer``: optax's ``chain(clip_by_global_norm, adamw)``
  written out (:class:`AdamW`), not ``torch.optim.AdamW``, which decays
  before the step and folds the bias corrections elsewhere;
- ``make_train_step`` / ``Trainer``: JAX's ``lax.scan`` over micro-batches
  becomes a loop that adds ``grad * count`` and divides by the total
  count, so the step equals one batch of all the rows; the update is in
  place (JAX donates the buffers) and ``train_step(sync=False)`` returns
  device tensors without waiting for the device;
- the mesh modes (``Trainer(..., mesh=)``, JAX's ``TrainConfig.tp`` and
  ``fsdp``): every rank reads the same global batch and takes its rows of
  each micro-batch (DP); its loss is its CE sum over the micro-batch's
  GLOBAL count of non-PAD targets, and the step's gradient is summed over
  the data group with one all_reduce before the division by the global
  count, as JAX's single fused all-reduce. ``tp``: the Megatron forward on
  this rank's heads, FF columns, experts and vocabulary rows
  (``models/gpt.py``, ``tp=``). ``fsdp``: params and both moments stay
  split over the data group as ``param_pspecs(fsdp_data=)`` says; the
  weights are gathered for the step (one all_gather), the gradients
  reduce-scattered, and Adam runs on the block. The clip's norm counts
  each block once (``ShardPlan.global_norm``). At world size 1 the mesh
  step runs the plain step's arithmetic: its losses and params are
  bit-equal to ``Trainer(mesh=None)``'s.

The forward is ``models/gpt.py::forward_hidden_train`` (JAX's XLA
branches, plain PyTorch under autograd); it never reaches a kernel.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..models.gpt import (GPTConfig, _head, forward_hidden_train,
                          forward_hidden_with_aux)
from ..utils.device import resolve_device
from ..utils.logging import span
from .prefetch import to_device


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    lr: float = 3e-4
    accum_steps: int = 1
    micro_batch: int = 8          # per-step batch BEFORE accumulation
    epochs: int = 6
    pad_id: int = 0
    b1: float = 0.9
    b2: float = 0.999             # torch AdamW default (reference)
    weight_decay: float = 0.01    # torch AdamW default
    clip_norm: float | None = None
    warmup_steps: int = 0
    total_steps: int | None = None  # for cosine decay
    schedule: str = "constant"    # "constant" | "warmup_cosine"
    tp: bool = False              # tensor-parallel params over 'model'
    # ZeRO/FSDP: params and Adam moments split over 'data' too
    fsdp: bool = False
    # head + CE per ``loss_chunk`` positions (None = all positions at once)
    loss_chunk: int | None = None
    # weight of the MoE load-balance loss
    moe_aux_weight: float = 0.01
    # packed rows (data.packed_batches) with their segment ids
    pack: bool = False


def reference_preset(name: str) -> TrainConfig:
    """Presets mirroring the four reference trainers + the paper recipe."""
    presets = {
        # train/train_mini.py: batch 8, 5 epochs, AdamW 3e-4
        "mini": TrainConfig(micro_batch=8, epochs=5),
        # train/train_large.py: phys batch 8 x accum 8 = logical 64, 6 epochs
        "large": TrainConfig(micro_batch=8, accum_steps=8, epochs=6),
        # train/train_large2.py: batch 16, 6 epochs
        "large2": TrainConfig(micro_batch=16, epochs=6),
        # train/train_no_inst.py: same as large2
        "no_inst": TrainConfig(micro_batch=16, epochs=6),
        # paper §10.1-10.2 Table 5: β2=0.95, clip 1.0, warmup+cosine, ~200k
        "paper": TrainConfig(micro_batch=16, epochs=6, b2=0.95,
                             clip_norm=1.0, warmup_steps=2000,
                             total_steps=200_000,
                             schedule="warmup_cosine"),
    }
    return presets[name]


# ------------------------------------------------------------- pytrees

def tree_leaves(tree) -> list:
    """The leaves of nested dicts and lists, dict keys sorted (JAX's
    flattening order: the global norm sums the leaves in it)."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [leaf for v in tree for leaf in tree_leaves(v)]
    return [tree]


def tree_unflatten(like, leaves) -> dict:
    """Leaves in :func:`tree_leaves` order -> a tree shaped like ``like``."""
    it = iter(leaves)

    def build(node):
        if isinstance(node, dict):
            built = {k: build(node[k]) for k in sorted(node)}
            return {k: built[k] for k in node}
        if isinstance(node, (list, tuple)):
            return [build(v) for v in node]
        return next(it)

    return build(like)


def tree_map(fn, tree):
    return tree_unflatten(tree, [fn(leaf) for leaf in tree_leaves(tree)])


# ------------------------------------------------------------ optimizer

def global_norm(grads: list) -> torch.Tensor:
    """The L2 norm of all the leaves together, as optax's
    ``clip_by_global_norm`` takes it (a device scalar)."""
    return torch.stack(torch._foreach_norm(grads)).square().sum().sqrt()


def _f32(x) -> float:
    return float(np.float32(x))


def lr_schedule(tcfg: TrainConfig):
    """count -> learning rate, as optax computes it in f32: constant, or
    ``warmup_cosine_decay_schedule(0, lr, max(warmup, 1), total or
    100000)`` (a linear rise over the warmup, then a cosine to 0 over the
    remaining steps)."""
    lr = _f32(tcfg.lr)
    if tcfg.schedule != "warmup_cosine":
        return lambda count: lr
    warmup = max(tcfg.warmup_steps, 1)
    decay = tcfg.total_steps or 100_000
    if decay - warmup <= 0:
        raise ValueError("warmup_cosine needs total_steps > warmup_steps")
    f = np.float32

    def schedule(count: int) -> float:
        if count < warmup:
            frac = f(1) - f(min(max(count, 0), warmup)) / f(warmup)
            return float(f(f(0) - f(lr)) * frac + f(lr))
        c = f(min(count - warmup, decay - warmup))
        cos = f(0.5) * (f(1) + f(np.cos(f(np.pi) * c / f(decay - warmup))))
        return float(f(lr) * (f(1) * cos + f(0)))

    return schedule


class AdamW:
    """optax's ``chain(clip_by_global_norm(clip), adamw(lr, b1, b2,
    weight_decay=wd))`` on lists of float leaves, updated in place:

    1. clip (when set): g = g / norm * clip where the global norm is at
       least ``clip`` (no epsilon, unlike ``clip_grad_norm_``);
    2. ``scale_by_adam``: mu = (1 - b1) g + b1 mu, nu = (1 - b2) g^2 +
       b2 nu, count + 1, u = mu_hat / (sqrt(nu_hat) + 1e-8) with
       mu_hat = mu / (1 - b1^count), nu_hat = nu / (1 - b2^count);
    3. ``add_decayed_weights``: u + wd p, on every leaf (optax's default
       mask is none);
    4. p = p + (-lr(count before the increment)) u.

    A leaf keeps its dtype, moments included, and its arithmetic rounds
    as optax's does under XLA: each constant (the betas, the bias
    corrections, the epsilon, the decay and the rate) is rounded to the
    leaf's dtype first, then each operation, a multiply-add once. In f16
    the epsilon is 0 and (1 - b2) g^2 underflows for |g| < ~2.4e-4, so
    such a leaf's step is inf or NaN, as it is in JAX.

    The state is ``{"count": int, "mu": [...], "nu": [...]}``; the count
    is the host's, so a step reads nothing back from the device."""

    EPS = 1e-8

    def __init__(self, tcfg: TrainConfig):
        self.tcfg = tcfg
        self.schedule = lr_schedule(tcfg)

    def init(self, leaves: list) -> dict:
        return {"count": 0, "mu": [torch.zeros_like(p) for p in leaves],
                "nu": [torch.zeros_like(p) for p in leaves]}

    @torch.no_grad()
    def update(self, grads: list, state: dict, params: list,
               norm_fn=global_norm) -> dict:
        """One step on ``params`` and ``state`` in place -> metrics (the
        global norm as a device scalar when clipping; ``norm_fn`` takes the
        gradient's blocks to it on a mesh)."""
        t = self.tcfg
        metrics = {}
        if t.clip_norm:
            norm = norm_fn(grads)
            keep = norm < t.clip_norm
            grads = [torch.where(keep, g, g / norm * t.clip_norm)
                     for g in grads]
            metrics["grad_norm"] = norm
        lr = self.schedule(state["count"])
        state["count"] += 1
        c = state["count"]
        bc1 = _f32(np.float32(1) - np.float32(t.b1) ** np.float32(c))
        bc2 = _f32(np.float32(1) - np.float32(t.b2) ** np.float32(c))
        by_dtype: dict = {}
        for i, p in enumerate(params):
            by_dtype.setdefault(p.dtype, []).append(i)
        for dt, idx in by_dtype.items():
            self._step([grads[i] for i in idx],
                       [state["mu"][i] for i in idx],
                       [state["nu"][i] for i in idx],
                       [params[i] for i in idx], dt, lr, bc1, bc2)
        metrics["lr"] = lr
        return metrics

    def _step(self, grads, mu, nu, params, dtype, lr, bc1, bc2) -> None:
        t = self.tcfg

        def r(v: float) -> float:
            return float(torch.tensor(v, dtype=dtype))

        # a * x + y is one multiply-add (one rounding), as XLA fuses it
        torch._foreach_mul_(mu, r(t.b1))
        torch._foreach_add_(mu, grads, alpha=r(1 - t.b1))
        torch._foreach_mul_(nu, r(t.b2))
        torch._foreach_add_(nu, torch._foreach_mul(grads, grads),
                            alpha=r(1 - t.b2))
        den = torch._foreach_sqrt(torch._foreach_div(nu, r(bc2)))
        mu_hat = torch._foreach_div(mu, r(bc1))
        if r(self.EPS):
            torch._foreach_add_(den, r(self.EPS))
            u = torch._foreach_div(mu_hat, den)
        else:
            # the epsilon is 0 in f16: XLA drops it and takes m / sqrt(v)
            # as m * rsqrt(v), the reciprocal of the rounded square root
            u = torch._foreach_mul(mu_hat, torch._foreach_reciprocal(den))
        if t.weight_decay:
            torch._foreach_add_(u, params, alpha=r(t.weight_decay))
        torch._foreach_add_(params, u, alpha=r(-lr))


def make_optimizer(tcfg: TrainConfig) -> AdamW:
    return AdamW(tcfg)


# ---------------------------------------------------------------- losses

def masked_ce_sums(logits: torch.Tensor, y: torch.Tensor, pad_id: int):
    """PAD-masked next-token CE (CrossEntropyLoss(ignore_index=PAD)) as
    SUMS: (total nll in f32, count of non-PAD targets)."""
    total = F.cross_entropy(logits.float().reshape(-1, logits.shape[-1]),
                            y.reshape(-1).long(), ignore_index=pad_id,
                            reduction="sum")
    return total, (y != pad_id).sum()


def _mean(total, count, y, pad_id, global_count=None):
    """-> (total / count, count): the count of non-PAD targets (the
    micro-batch's global one on a mesh), at least 1, as JAX returns it:
    an all-PAD micro-batch weighs 1 in the step's accumulation, with a
    loss and a gradient of 0."""
    count = (count if global_count is None else global_count).clamp(min=1)
    return total / count, count


def loss_fn(params: dict, x, y, cfg: GPTConfig, pad_id: int, tp=None,
            count=None):
    """Next-token CE, PAD-masked -> (mean loss, count). On a mesh ``tp``
    is the model group's share and ``count`` the micro-batch's global
    count (this rank's rows' CE sum over it)."""
    total, local = masked_ce_sums(
        _head(params, forward_hidden_train(params, x, cfg, tp=tp), tp), y,
        pad_id)
    return _mean(total, local, y, pad_id, count)


def loss_fn_packed(params: dict, x, y, seg, cfg: GPTConfig, pad_id: int,
                   tp=None, count=None):
    """CE over packed rows: block-diagonal attention and per-segment
    positions from ``seg``; boundary targets arrive masked to PAD."""
    h = forward_hidden_train(params, x, cfg, seg=seg, tp=tp)
    total, local = masked_ce_sums(_head(params, h, tp), y, pad_id)
    return _mean(total, local, y, pad_id, count)


def _ce_chunk(w, b, hc, yc, pad_id, tp=None):
    return masked_ce_sums(_head({"head": {"w": w, "b": b}}, hc, tp), yc,
                          pad_id)[0]


def loss_fn_chunked(params: dict, x, y, cfg: GPTConfig, pad_id: int,
                    chunk: int, seg=None, tp=None, count=None):
    """The same CE with the head and log-softmax run ``chunk`` positions at
    a time, each chunk recomputed in the backward pass
    (``torch.utils.checkpoint``, as ``jax.checkpoint`` over JAX's scan):
    the logits of one chunk exist at a time. T is padded to a multiple of
    the chunk with PAD targets."""
    h = forward_hidden_train(params, x, cfg, seg=seg, tp=tp)  # [B, T, D]
    T = h.shape[1]
    pad = (-T) % chunk
    y = y.long()
    if pad:
        h = F.pad(h, (0, 0, 0, pad))
        y = F.pad(y, (0, pad), value=pad_id)
    w, b = params["head"]["w"], params["head"]["b"]
    total = torch.zeros((), device=h.device)
    for s in range(0, T + pad, chunk):
        total = total + checkpoint(_ce_chunk, w, b, h[:, s:s + chunk],
                                   y[:, s:s + chunk], pad_id, tp,
                                   use_reentrant=False)
    return _mean(total, (y != pad_id).sum(), y, pad_id, count)


def loss_fn_moe(params: dict, x, y, cfg: GPTConfig, pad_id: int,
                aux_weight: float, tp=None, count=None, dp=None):
    """CE plus ``aux_weight`` x the MoE layers' mean load-balance loss
    (their capacity-bounded dispatch) -> (loss, count). ``dp``: the data
    group of a mesh, over whose tokens the load-balance loss is taken."""
    h, aux = forward_hidden_with_aux(params, x, cfg, tp=tp, dp=dp)
    total, local = masked_ce_sums(_head(params, h, tp), y, pad_id)
    loss, count = _mean(total, local, y, pad_id, count)
    return loss + aux_weight * aux, count


def _loss_for(cfg: GPTConfig, tcfg: TrainConfig, tp=None, dp=None):
    """The loss of JAX's step: with MoE layers and a positive aux weight
    ``loss_fn_moe`` (neither the chunked head nor packed rows with it, as
    in JAX); an MoE model with weight 0 trains through the pointwise path
    of the plain losses."""
    moe = bool(cfg.n_experts) and tcfg.moe_aux_weight > 0
    if moe and tcfg.loss_chunk:
        raise ValueError("loss_chunk with the MoE aux loss is unsupported: "
                         "set moe_aux_weight=0 or chunk off")
    if moe and tcfg.pack:
        raise ValueError("packed rows with the MoE aux loss are unsupported")
    if moe:
        return lambda p, x, y, s, c: loss_fn_moe(
            p, x, y, cfg, tcfg.pad_id, tcfg.moe_aux_weight, tp, c, dp)
    if tcfg.loss_chunk:
        return lambda p, x, y, s, c: loss_fn_chunked(
            p, x, y, cfg, tcfg.pad_id, tcfg.loss_chunk, seg=s, tp=tp,
            count=c)
    if tcfg.pack:
        return lambda p, x, y, s, c: loss_fn_packed(p, x, y, s, cfg,
                                                    tcfg.pad_id, tp, c)
    return lambda p, x, y, s, c: loss_fn(p, x, y, cfg, tcfg.pad_id, tp, c)


def make_train_step(cfg: GPTConfig, tcfg: TrainConfig, optimizer=None,
                    plan=None, tp=None):
    """-> step(params, opt_state, x, y, seg=None) -> metrics, updating
    ``params`` (a tree of tensors) and ``opt_state`` in place.

    x, y (and seg): [accum_steps, micro_batch, T] tensors on the params'
    device. Each micro-batch's gradient is weighted by its count of
    non-PAD targets (at least 1, as JAX counts them) and the sum divided
    by the total count, so the step equals one batch of accum * micro
    rows; metrics are device tensors: {"loss", "tokens"} (and "grad_norm"
    when clipping).

    On a mesh (``plan``, a ``parallel.mesh.ShardPlan``; ``tp`` the model
    group's ``TensorParallel`` under ``tcfg.tp``) ``params`` are this
    rank's blocks and x, y the GLOBAL batch: the same loop runs on this
    rank's rows with the global counts, then ``plan`` sums the gradient
    and the loss over the data group before the division. Spans (under a
    profiler session): ``train.forward`` (the loss), ``train.backward``
    (``autograd.grad``) and ``train.optimizer`` (the update)."""
    optimizer = optimizer or make_optimizer(tcfg)
    dp = plan.data_group if plan is not None and plan.d > 1 else None
    lfn = _loss_for(cfg, tcfg, tp, dp)

    def step(params, opt_state, x, y, seg=None):
        leaves = tree_leaves(params)
        work = leaves if plan is None else plan.gather_step(leaves)
        live = [p.detach().requires_grad_() for p in work]
        tree = tree_unflatten(params, live)
        counts = None
        if plan is not None:
            counts = (y != tcfg.pad_id).sum(dim=(1, 2))
            x, y, seg = plan.rows(x), plan.rows(y), plan.rows(seg)
        acc = None
        loss_sum = torch.zeros((), device=x.device)
        count_sum = torch.zeros((), dtype=torch.int64, device=x.device)
        for i in range(x.shape[0]):
            with span("train.forward"):
                loss, count = lfn(tree, x[i], y[i],
                                  None if seg is None else seg[i],
                                  None if counts is None else counts[i])
            with span("train.backward"):
                grads = torch.autograd.grad(loss, live)
            with torch.no_grad():
                weighted = torch._foreach_mul(list(grads), count.float())
                if acc is None:
                    acc = weighted
                else:
                    torch._foreach_add_(acc, weighted)
                loss_sum = loss_sum + loss.detach() * count
                count_sum = count_sum + count
        with torch.no_grad():
            norm_fn = global_norm
            if plan is not None:
                acc, loss_sum = plan.reduce_grads(acc, loss_sum[None])
                loss_sum, norm_fn = loss_sum[0], plan.global_norm
            grads = torch._foreach_div(acc, count_sum.float())
        with span("train.optimizer"):
            metrics = optimizer.update(grads, opt_state, leaves, norm_fn)
        metrics.update(loss=loss_sum / count_sum, tokens=count_sum)
        return metrics

    return step


class Trainer:
    """Owns params (f32 leaves, updated in place) and the optimizer state;
    feeds [accum, micro, T] batches to the step. ``device`` None means the
    card (raises without one). ``mesh``: a (data, model) ``DeviceMesh``
    (``parallel.mesh.make_mesh``); the params are then this rank's blocks
    (``tcfg.tp``, ``tcfg.fsdp``), every rank feeds the same global batch,
    and :meth:`export_params` / :meth:`opt_state_tree` assemble the whole
    trees (collectives: every rank calls them). Without a mesh ``tp`` and
    ``fsdp`` change nothing, as in JAX."""

    def __init__(self, cfg: GPTConfig, tcfg: TrainConfig, params: dict,
                 device=None, mesh=None):
        self.cfg, self.tcfg = cfg, tcfg
        self.device = resolve_device(device)
        self.optimizer = make_optimizer(tcfg)
        self.mesh, self.plan, self.tp = mesh, None, None
        # a copy of the caller's tree: the step updates it in place
        self.params = tree_map(
            lambda p: torch.as_tensor(p).detach().to(self.device).clone(),
            params)
        if mesh is not None:
            from ..parallel.collectives import tensor_parallel
            from ..parallel.mesh import ShardPlan

            self.plan = ShardPlan(self.params, mesh, tp=tcfg.tp,
                                  fsdp=tcfg.fsdp,
                                  heads=(cfg.n_head, cfg.kv_heads))
            self.params = self.plan.shard(self.params)
            if tcfg.tp:
                self.tp = tensor_parallel(cfg, self.plan.model_group)
        self.opt_state = self.optimizer.init(tree_leaves(self.params))
        self.step_fn = make_train_step(cfg, tcfg, self.optimizer, self.plan,
                                       self.tp)
        self.step = 0

    def _blocks(self, tree) -> list:
        """This rank's blocks of the leaves of a whole tree, on the device."""
        tree = tree_map(lambda a: torch.as_tensor(a).to(self.device), tree)
        if self.plan is not None:
            tree = self.plan.shard(tree)
        return [t.clone() for t in tree_leaves(tree)]

    def load_opt_state(self, state: dict) -> None:
        """Take an optimizer state ``{"count", "mu", "nu"}`` whose moments
        are whole trees shaped like the params (``utils/checkpoint.py``);
        on a mesh each rank keeps its blocks."""
        self.opt_state = {"count": int(state["count"]),
                          "mu": self._blocks(state["mu"]),
                          "nu": self._blocks(state["nu"])}

    def _whole(self, trees: list) -> list:
        if self.plan is None:
            return trees
        return self.plan.assemble(trees)

    def export_params(self) -> dict:
        """The whole params tree (JAX's layout; on a mesh assembled from
        every rank's blocks, on the CPU)."""
        return self._whole([self.params])[0]

    def opt_state_tree(self) -> dict:
        """The optimizer state with its moments as whole trees shaped like
        the params (what a checkpoint stores)."""
        return self.checkpoint_trees()[1]

    def checkpoint_trees(self) -> tuple:
        """(whole params, whole optimizer state tree), on a mesh in one
        gather: what a checkpoint of this trainer stores."""
        mu = tree_unflatten(self.params, self.opt_state["mu"])
        nu = tree_unflatten(self.params, self.opt_state["nu"])
        params, mu, nu = self._whole([self.params, mu, nu])
        return params, {"count": self.opt_state["count"], "mu": mu,
                        "nu": nu}

    def train_step(self, x, y, seg=None, sync: bool = True):
        """x, y (and seg with TrainConfig.pack): [accum, micro, T] int
        arrays (host or device). ``sync=False`` returns the metrics as
        device tensors without waiting for the step. Its span,
        ``train.step``, counts the batch's target positions (``tokens``)."""
        if (seg is not None) != bool(self.tcfg.pack):
            raise ValueError("TrainConfig.pack and the seg operand must "
                             "agree (use data.packed_batches for packed "
                             "training)")
        with span("train.step", tokens=int(np.prod(y.shape))):
            x, y = to_device(x, self.device), to_device(y, self.device)
            if seg is not None:
                seg = to_device(seg, self.device)
            metrics = self.step_fn(self.params, self.opt_state, x, y, seg)
        self.step += 1
        if sync:
            return {k: float(v) for k, v in metrics.items()}
        return metrics

