"""Pipeline parallelism: GPipe over a ``stage`` axis of ranks.

Port of ``eamg_tpu/parallel/pipeline.py`` on ``torch.distributed``. The
transformer stack splits into contiguous stages, one per rank of the
``stage`` axis; micro-batches stream through the stages, their
activations hop stage to stage by point-to-point sends, and the backward
pass runs by hand in reverse, each stage sending the gradient of its input
upstream (JAX gets that backward from ``jax.grad`` through ``ppermute``).

- :func:`make_pp_mesh`: a (data, stage[, model]) ``DeviceMesh``: DP x PP,
  and with ``model > 1`` Megatron tensor parallelism inside each stage.
- :func:`stack_layers` / :func:`unstack_layers`: the per-layer list as
  ``[n_stages, layers_per_stage, ...]`` leaves and back; :func:`pp_pspecs`
  JAX's specs as tuples; :func:`shard_pp_params` this rank's
  ``[1, layers_per_stage, ...]`` block (its stage, and its model rank's
  block of each weight).
- The schedule is JAX's: ``n_micro + S - 1`` ticks, stage s working on
  micro-batch t - s at tick t (GPipe's fill and drain bubbles). The
  embedding and the head stay outside the stages, replicated: stage 0
  embeds, the last stage applies the head and the PAD-masked CE, and the
  loss is ``masked_ce_sums`` over all micro-batches divided by the
  batch's global count of targets.
- :func:`pipeline_forward` (logits), :func:`make_pp_train_step` and
  :class:`PipelineTrainer` (AdamW, optax's arithmetic; ``export_params``
  gives JAX's per-layer tree). With a ``data`` axis each micro-batch's
  rows split over it; replicated gradients (the stage's layers over
  ``data``, the embedding and head over every rank) are summed.

JAX's assertions are kept as ``ValueError``: ``n_layer % stages``, mixed
MLP structures, ``B % n_micro``, the micro-batch over the data axis and
``batch_first_bug``.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from ..models.gpt import GPTConfig, _head, train_block
from ..train.trainer import tree_unflatten
from .mesh import ShardPlan, _coord, _group, _spec_tree, _walk, mesh_shape


def make_pp_mesh(stages: int, data: int = 1, model: int = 1, device=None):
    """A (data, stage) ``DeviceMesh`` (model 1) or (data, stage, model),
    over the whole process group."""
    from torch.distributed.device_mesh import init_device_mesh

    if not dist.is_initialized():
        raise RuntimeError("make_pp_mesh needs the process group: call "
                           "parallel.multihost.init_distributed first")
    n = data * stages * model
    world = dist.get_world_size()
    if n != world:
        raise ValueError(f"mesh {data}x{stages}x{model} > {world} devices"
                         if n > world else
                         f"mesh {data}x{stages}x{model} leaves ranks of the "
                         f"{world} out")
    dev = "cuda" if dist.get_backend() == "nccl" else "cpu"
    if device is not None:
        dev = torch.device(device).type
    if model == 1:
        return init_device_mesh(dev, (data, stages),
                                mesh_dim_names=("data", "stage"))
    return init_device_mesh(dev, (data, stages, model),
                            mesh_dim_names=("data", "stage", "model"))


def _check_layers(layers: list, n_stages: int) -> None:
    L = len(layers)
    if L % n_stages:
        raise ValueError(f"n_layer={L} not divisible by {n_stages} stages")
    structures = {tuple(sorted(layer["mlp"])) for layer in layers}
    if len(structures) != 1:
        raise ValueError(
            "stack_layers needs structurally identical layers; got mixed MLP "
            f"structures {structures} (GPTConfig.moe_every > 1 interleaves "
            "dense and MoE layers — pipeline parallelism requires moe_every"
            "=1 or a dense model)")


def _stack(trees: list):
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(trees)


def _index(tree, i):
    if isinstance(tree, dict):
        return {k: _index(v, i) for k, v in tree.items()}
    return tree[i]


def stack_layers(params: dict, n_stages: int) -> dict:
    """The per-layer list as stage-major stacked leaves
    ``[n_stages, layers_per_stage, ...]``; the embedding, positions and
    head pass through."""
    layers = params["layers"]
    _check_layers(layers, n_stages)
    lps = len(layers) // n_stages
    stacked = _stack([_stack(layers[s * lps:(s + 1) * lps])
                      for s in range(n_stages)])
    return {**{k: v for k, v in params.items() if k != "layers"},
            "layers": stacked}


def unstack_layers(params: dict) -> dict:
    """Inverse of :func:`stack_layers`."""
    st = params["layers"]
    S, lps = next(leaf for _, leaf in _walk(st)).shape[:2]
    layers = [_index(_index(st, s), i) for s in range(S) for i in range(lps)]
    return {**{k: v for k, v in params.items() if k != "layers"},
            "layers": layers}


def _layer_specs(tp: bool) -> dict:
    return _spec_tree({"layers": [{"mlp": {"w1": None}}]}, tp)["layers"][0]


def pp_pspecs(params_stacked: dict, tp: bool = False) -> dict:
    """JAX's specs (tuples): stage-stacked layers on the leading ``stage``
    axis; with ``tp`` each stage's weights also over ``model``, the
    Megatron layout shifted by the two leading axes; the rest replicated."""
    if tp:
        layer = _layer_specs(True)

        def shift(spec):
            return ("stage", None) + tuple(spec)
        layers = {k: {n: shift(s) for n, s in v.items()}
                  for k, v in layer.items()}
    else:
        layers = {k: {n: ("stage",) for n in v}
                  for k, v in params_stacked["layers"].items()}
    return {"tok_emb": (), "pos": (), "layers": layers,
            "head": {"w": (), "b": ()}}


def _stage_plan(layers: list, mesh, tp: bool, heads) -> ShardPlan:
    """The model-axis storage of one stage's layers."""
    specs = {"layers": _spec_tree({"layers": layers}, tp)["layers"]}
    return ShardPlan({"layers": layers}, mesh, tp=tp, heads=heads,
                     specs=specs)


def shard_pp_params(params_stacked: dict, mesh, tp: bool = False,
                    cfg: GPTConfig | None = None) -> dict:
    """This rank's block of the stacked tree: its stage's layers as
    ``[1, layers_per_stage, ...]`` leaves (with ``tp`` its model rank's
    block of each weight; ``cfg`` gives the heads); the rest whole."""
    si = _coord(mesh, "stage")
    flat = unstack_layers(params_stacked)["layers"]
    S = mesh_shape(mesh)["stage"]
    lps = len(flat) // S
    mine = flat[si * lps:(si + 1) * lps]
    heads = (cfg.n_head, cfg.kv_heads) if cfg is not None else None
    blocks = _stage_plan(mine, mesh, tp, heads).shard(
        {"layers": mine})["layers"]
    return {**{k: v for k, v in params_stacked.items() if k != "layers"},
            "layers": _stack([_stack(blocks)])}


class _Stages:
    """This rank's place in a pipeline mesh: its stage, its data and model
    ranks, their groups, and the global ranks of its neighbours."""

    def __init__(self, mesh, cfg: GPTConfig):
        shape = mesh_shape(mesh)
        self.S, self.d = shape["stage"], shape.get("data", 1)
        self.m = shape.get("model", 1)
        self.si = _coord(mesh, "stage")
        self.di, self.mi = _coord(mesh, "data"), _coord(mesh, "model")
        self.stage_group = _group(mesh, "stage")
        self.data_group = _group(mesh, "data")
        self.tp = None
        if self.m > 1:
            from .collectives import tensor_parallel

            self.tp = tensor_parallel(cfg, _group(mesh, "model"))

    def peer(self, stage: int) -> int:
        return dist.get_global_rank(self.stage_group, stage)


def _micro_rows(x: torch.Tensor, n_micro: int, d: int, di: int):
    """[B, ...] -> [n_micro, B / n_micro / d, ...]: each micro-batch's rows
    of data rank ``di``."""
    B = x.shape[0]
    if B % n_micro:
        raise ValueError(f"B={B} not divisible by n_micro={n_micro}")
    Bm = B // n_micro
    if Bm % d:
        raise ValueError(
            f"microbatch size B/n_micro={Bm} not divisible by the data "
            f"axis ({d}); pick n_micro so each microbatch DP-shards evenly")
    r = Bm // d
    return x.reshape((n_micro, Bm) + tuple(x.shape[1:]))[:, di * r:(di + 1)
                                                          * r]


def _check_cfg(cfg: GPTConfig) -> None:
    if cfg.batch_first_bug:
        raise ValueError(
            "pipeline parallelism supports the corrected architectures "
            "(batch_first_bug attention crosses the batch, which microbatch "
            "splitting would change)")


def _embed(shared: dict, ids, cfg: GPTConfig):
    import torch.nn.functional as F

    T = ids.shape[1]
    return (F.embedding(ids.long(), shared["tok_emb"])
            + shared["pos"][:T]).to(cfg.torch_dtype)


def _run_schedule(st: _Stages, layers: list, shared: dict, xs, cfg,
                  last_fn, grad: bool) -> list:
    """The GPipe ticks of this rank's stage: at tick t it works on
    micro-batch t - stage, taking its input from the previous stage
    (stage 0: the embedding) and sending its output on. -> per micro-batch
    (input, output, ``last_fn(j, output)`` on the last stage)."""
    n_micro = xs.shape[0]
    kept = [None] * n_micro
    for t in range(n_micro + st.S - 1):
        j = t - st.si
        if not 0 <= j < n_micro:
            continue
        if st.si == 0:
            h = _embed(shared, xs[j], cfg)
        else:
            h = torch.empty(xs[j].shape + (cfg.d_model,),
                            dtype=cfg.torch_dtype, device=xs.device)
            dist.recv(h, st.peer(st.si - 1))
            h.requires_grad_(grad)
        out = h
        for p in layers:
            out = train_block(p, out, cfg, tp=st.tp)
        if st.si < st.S - 1:
            dist.send(out.detach().contiguous(), st.peer(st.si + 1))
            kept[j] = (h, out, None)
        else:
            kept[j] = (h, out, last_fn(j, out))
    return kept


@torch.no_grad()
def pipeline_forward(params_local: dict, ids: torch.Tensor, cfg: GPTConfig,
                     mesh, n_micro: int) -> torch.Tensor:
    """Pipelined GPT forward: [B, T] ids (the same on every rank) ->
    [B, T, V] f32 logits on every rank, equal to ``models/gpt.py``'s
    training forward. ``params_local``: this rank's stage as per-layer
    blocks (:class:`PipelineTrainer`'s ``params``)."""
    _check_cfg(cfg)
    st = _Stages(mesh, cfg)
    xs = _micro_rows(ids, n_micro, st.d, st.di)
    kept = _run_schedule(st, params_local["layers"], params_local, xs, cfg,
                         lambda j, out: _head(params_local, out), False)
    B, T = ids.shape
    logits = torch.zeros((n_micro, st.d, xs.shape[1], T, cfg.vocab_size),
                         device=ids.device)
    if st.si == st.S - 1 and st.mi == 0:
        logits[:, st.di] = torch.stack([k[2] for k in kept])
    dist.all_reduce(logits)
    return logits.reshape(B, T, cfg.vocab_size)


def make_pp_train_step(cfg: GPTConfig, tcfg, mesh, n_micro: int,
                       optimizer=None, plan: ShardPlan | None = None):
    """-> step(params, opt_state, x, y) -> metrics on plain [B, T] batches
    (the same on every rank), with the trainer's loss contract: the
    PAD-masked CE of the whole batch over its global count (at least 1).
    ``params``: this rank's tree (its stage's layer blocks, the embedding
    and head whole), updated in place; ``plan``: the stage's layer storage
    (:func:`shard_pp_params`' layout)."""
    from ..train.trainer import masked_ce_sums, make_optimizer, tree_leaves

    _check_cfg(cfg)
    optimizer = optimizer or make_optimizer(tcfg)
    st = _Stages(mesh, cfg)

    def step(params, opt_state, x, y):
        leaves = tree_leaves(params)
        live = [p.detach().requires_grad_() for p in leaves]
        tree = tree_unflatten(params, live)
        xs = _micro_rows(x, n_micro, st.d, st.di)
        ys = _micro_rows(y, n_micro, st.d, st.di)
        count = (y != tcfg.pad_id).sum().clamp(min=1)
        sums = []

        def last(j, out):
            total = masked_ce_sums(_head(tree, out), ys[j], tcfg.pad_id)[0]
            sums.append(total.detach())
            return total / count

        kept = _run_schedule(st, tree["layers"], tree, xs, cfg, last, True)
        for j in reversed(range(n_micro)):
            h, out, loss = kept[j]
            if loss is not None:
                loss.backward()
            else:
                g = torch.empty_like(out)
                dist.recv(g, st.peer(st.si + 1))
                out.backward(g)
            if st.si > 0:
                dist.send(h.grad.contiguous(), st.peer(st.si - 1))
        grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                 for p in live]
        with torch.no_grad():
            loss_sum = torch.stack(sums).sum() if sums and st.mi == 0 \
                else torch.zeros((), device=x.device)
            grads, loss_sum = _reduce(st, plan, params, grads, loss_sum)
            metrics = optimizer.update(
                grads, opt_state, leaves,
                lambda g: _global_norm(st, plan, params, g))
        metrics.update(loss=loss_sum / count, tokens=count)
        return metrics

    return step


def _split(params: dict, leaves: list) -> tuple:
    """Leaves in tree order -> (the stage's layer leaves, the shared ones
    (embedding, positions, head)), as index lists."""
    from ..train.trainer import tree_leaves

    n_layer = len(tree_leaves(params["layers"]))
    keys = sorted(params)
    out, i = ([], []), 0
    for k in keys:
        n = n_layer if k == "layers" else len(tree_leaves(params[k]))
        (out[0] if k == "layers" else out[1]).extend(range(i, i + n))
        i += n
    return out


def _reduce(st: _Stages, plan, params, grads: list, loss_sum):
    """Sum the gradients: the shared leaves and the loss over the stages
    (one all_reduce), then everything over the data axis (one all_reduce);
    the K/V rows a model group shares over it (``plan.sync_kv``)."""
    layer_idx, shared_idx = _split(params, grads)
    if plan is not None:
        layer_grads = [grads[i] for i in layer_idx]
        plan.sync_kv(layer_grads)
        for i, g in zip(layer_idx, layer_grads):
            grads[i] = g
    flat = torch.cat([grads[i].reshape(-1) for i in shared_idx]
                     + [loss_sum.reshape(1)])
    if st.S > 1:
        dist.all_reduce(flat, group=st.stage_group)
    flat = torch.cat([grads[i].reshape(-1) for i in layer_idx] + [flat])
    if st.d > 1:
        dist.all_reduce(flat, group=st.data_group)
    out, off = list(grads), 0
    for i in layer_idx + shared_idx:
        out[i] = flat[off:off + grads[i].numel()].view_as(grads[i])
        off += grads[i].numel()
    return out, flat[off]


def _global_norm(st: _Stages, plan, params, grads: list) -> torch.Tensor:
    """The whole gradient's norm: the shared leaves (the same on every
    rank) once, each stage's layer blocks once (summed over the world,
    each weighted by 1 / the ranks of its stage that hold it)."""
    layer_idx, shared_idx = _split(params, grads)
    shared = torch.stack(torch._foreach_norm(
        [grads[i] for i in shared_idx])).square().sum()
    layers = plan.weighted_sq([grads[i] for i in layer_idx])
    if st.S * st.d * st.m > 1:
        dist.all_reduce(layers)
    return (layers + shared).sqrt()


class PipelineTrainer:
    """The trainer of the pipelined stack: this rank's stage of layers
    (its model rank's blocks under a ``model`` axis), the embedding and
    head whole, and the optimizer state, on a (data, stage[, model]) mesh.
    ``train_step(x, y)`` takes plain [B, T] batches, the same on every
    rank; ``export_params()`` returns JAX's per-layer tree (a collective)."""

    def __init__(self, cfg: GPTConfig, tcfg, params: dict, mesh,
                 n_micro: int, device=None):
        from ..train.trainer import make_optimizer, tree_leaves, tree_map
        from ..utils.device import resolve_device

        _check_cfg(cfg)
        self.cfg, self.tcfg, self.mesh = cfg, tcfg, mesh
        self.n_micro = n_micro
        self.device = resolve_device(device)
        self.optimizer = make_optimizer(tcfg)
        st = _Stages(mesh, cfg)
        _check_layers(params["layers"], st.S)
        params = tree_map(lambda p: torch.as_tensor(p).detach()
                          .to(self.device).clone(), params)
        lps = len(params["layers"]) // st.S
        mine = params["layers"][st.si * lps:(st.si + 1) * lps]
        self.plan = _stage_plan(mine, mesh, st.m > 1,
                                (cfg.n_head, cfg.kv_heads))
        self.n_layer = len(params["layers"])
        self.params = {"tok_emb": params["tok_emb"], "pos": params["pos"],
                       "layers": self.plan.shard({"layers": mine})["layers"],
                       "head": params["head"]}
        self.opt_state = self.optimizer.init(tree_leaves(self.params))
        self.step_fn = make_pp_train_step(cfg, tcfg, mesh, n_micro,
                                          self.optimizer, self.plan)
        self.st = st
        self.step = 0

    def train_step(self, x, y, sync: bool = True):
        x = torch.as_tensor(x).to(self.device)
        y = torch.as_tensor(y).to(self.device)
        metrics = self.step_fn(self.params, self.opt_state, x, y)
        self.step += 1
        if sync:
            return {k: float(v) for k, v in metrics.items()}
        return metrics

    def export_params(self) -> dict:
        """JAX's per-layer tree, whole, on the CPU (every rank calls it)."""
        st = self.st
        mine = [leaf.detach().cpu() for _, leaf in
                _walk({"layers": self.params["layers"]})]
        everyone = [None] * dist.get_world_size()
        dist.all_gather_object(everyone, (st.si, st.di, st.mi, mine))
        like = [leaf for _, leaf in _walk(self.plan.like)]
        layers = []
        for s in range(st.S):
            by_coord = {(di, mi): blocks for si, di, mi, blocks in everyone
                        if si == s}
            whole = self.plan.assemble_leaves(by_coord, like)
            layers += tree_unflatten(self.plan.like, whole)["layers"]
        return {"tok_emb": self.params["tok_emb"].detach().cpu(),
                "pos": self.params["pos"].detach().cpu(),
                "layers": layers,
                "head": {k: v.detach().cpu()
                         for k, v in self.params["head"].items()}}
