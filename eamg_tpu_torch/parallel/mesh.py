"""The (data, model) mesh and the sharding rules of the parallel modes.

Port of ``eamg_tpu/parallel/mesh.py`` on ``torch.distributed``: one process
a rank (a card, or a gloo rank on the CPU), and a ``DeviceMesh`` of them
with dims ``("data", "model")``.

- :func:`make_mesh` builds the mesh; ``data=None`` takes every rank left,
  and a mesh larger than the world fails with JAX's message.
- :func:`param_pspecs` / :func:`_with_fsdp` are pure: for every leaf they
  return JAX's ``PartitionSpec`` entries as a tuple (``()`` replicated,
  ``("model", None)`` rows over the model axis, ...): the Megatron column
  and row layout under ``tp``, the MoE experts over ``model``, and FSDP's
  "largest unsharded divisible dim" over ``data``.
- :class:`ShardPlan` (and :func:`shard_params`) stores each leaf as its
  spec says, this rank's block of it, and assembles JAX's whole tree back
  from the ranks' blocks. A leaf JAX keeps replicated stays whole on every
  rank. The model axis splits the fused QKV projection (``in_w``,
  ``in_b``, spec ``("model", None)``) by head: rank r holds the Q rows of
  its heads and the K and V rows of its K/V heads, which is a row split
  of the same size (a permutation of JAX's contiguous row blocks; GSPMD
  reshards those to heads, tests/test_collectives.py); where the model
  axis is larger than the K/V heads, a K/V head's rows are held by the
  ``kv_share`` ranks whose query heads read it.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

from ..train.trainer import tree_unflatten
from .collectives import tp_shares


def make_mesh(data: int | None = None, model: int = 1, device=None):
    """A (data, model) ``DeviceMesh`` over the process group (which must be
    joined: ``multihost.init_distributed``). ``data=None`` uses every rank
    left; the mesh must cover the world. ``device``: "cuda" or "cpu" (None:
    the backend's, NCCL -> cuda)."""
    from torch.distributed.device_mesh import init_device_mesh

    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs the process group: call "
                           "parallel.multihost.init_distributed first")
    n = dist.get_world_size()
    if data is None:
        if n % model:
            raise ValueError(f"{n} devices not divisible by model={model}")
        data = n // model
    if data * model > n:
        raise ValueError(f"mesh {data}x{model} > {n} devices")
    if data * model < n:
        raise ValueError(f"mesh {data}x{model} leaves ranks of the {n} "
                         "out: one process a rank, every rank in the mesh")
    dev = "cuda" if dist.get_backend() == "nccl" else "cpu"
    if device is not None:
        dev = torch.device(device).type
    return init_device_mesh(dev, (data, model),
                            mesh_dim_names=("data", "model"))


def mesh_shape(mesh) -> dict:
    """{dim name: size} of a DeviceMesh (absent names: 1)."""
    return dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))


# ------------------------------------------------------------------ specs

def _spec_tree(params: dict, tp: bool) -> dict:
    def mlp_spec(mlp):
        if "router" in mlp:
            if not tp:
                return {k: () for k in mlp}
            return {"router": (), "w1": ("model",), "b1": ("model",),
                    "w2": ("model",), "b2": ("model",)}
        if not tp:
            return {"w1": (), "b1": (), "w2": (), "b2": ()}
        return {"w1": ("model", None), "b1": ("model",),
                "w2": (None, "model"), "b2": ()}

    def layer_spec(layer):
        attn = ({"in_w": ("model", None), "in_b": ("model",),
                 "out_w": (None, "model"), "out_b": ()} if tp else
                {"in_w": (), "in_b": (), "out_w": (), "out_b": ()})
        return {"attn": attn, "ln1": {"g": (), "b": ()},
                "ln2": {"g": (), "b": ()}, "mlp": mlp_spec(layer["mlp"])}

    return {"tok_emb": (), "pos": (),
            "layers": [layer_spec(la) for la in params["layers"]],
            "head": {"w": ("model", None), "b": ("model",)} if tp else
            {"w": (), "b": ()}}


def _map2(fn, a, b):
    """fn over the leaves of ``a`` beside the matching nodes of ``b`` (a's
    structure; b's leaves are spec tuples)."""
    if isinstance(a, dict):
        return {k: _map2(fn, a[k], b[k]) for k in a}
    if isinstance(a, list):
        return [_map2(fn, x, y) for x, y in zip(a, b)]
    return fn(a, b)


def param_pspecs(params: dict, tp: bool, fsdp_data: int | None = None) -> dict:
    """JAX's PartitionSpec tree of a GPT param tree, each spec as a tuple of
    its entries. ``tp``: the Megatron layout (QKV and FFN-in over rows,
    attention-out and FFN-out over columns, the head over the vocabulary,
    MoE experts over ``model``). ``fsdp_data`` (the data axis's size, > 1):
    every leaf also gets ``"data"`` on :func:`_with_fsdp`'s dim."""
    specs = _spec_tree(params, tp)
    if fsdp_data and fsdp_data > 1:
        specs = _map2(lambda leaf, s: _with_fsdp(leaf, s, fsdp_data),
                      params, specs)
    return specs


def _with_fsdp(leaf, spec: tuple, data: int) -> tuple:
    """``"data"`` on the largest unsharded dim divisible by the data axis
    (the entries padded to the leaf's rank, as JAX pads them); a leaf with
    no such dim stays as it was (padded)."""
    shape = tuple(getattr(leaf, "shape", ()))
    entries = list(spec) + [None] * (len(shape) - len(spec))
    best, best_dim = None, 0
    for i, e in enumerate(entries):
        if e is None and shape[i] > best_dim and shape[i] % data == 0:
            best, best_dim = i, shape[i]
    if best is not None:
        entries[best] = "data"
    return tuple(entries)


# ---------------------------------------------------------------- storage

@dataclasses.dataclass(frozen=True)
class Layout:
    """How one leaf is stored: the dim split over the model axis and the
    one split over the data axis (None: whole), and for the fused QKV
    projection its heads (n_head, kv_heads, head_dim)."""
    model_dim: int | None
    data_dim: int | None
    qkv: tuple | None = None


def _qkv_rows(qkv: tuple, rank: int, size: int) -> torch.Tensor:
    """The rows of the fused in_proj that model rank ``rank`` of ``size``
    holds: the Q rows of its query heads, then the K and the V rows of its
    K/V heads."""
    H, Hkv, Dh = qkv
    h, kv, _ = tp_shares(H, Hkv, size)
    q0 = rank * h
    kv0 = q0 // (H // Hkv)
    D, KVD = H * Dh, Hkv * Dh
    q = torch.arange(q0 * Dh, (q0 + h) * Dh)
    k = D + torch.arange(kv0 * Dh, (kv0 + kv) * Dh)
    return torch.cat([q, k, k + KVD])


def _model_index(lay: Layout, n: int, rank: int, size: int) -> torch.Tensor:
    if lay.qkv is not None:
        return _qkv_rows(lay.qkv, rank, size)
    if n % size:
        raise ValueError(f"a dim of {n} does not split over a model axis "
                         f"of {size}")
    step = n // size
    return torch.arange(rank * step, (rank + 1) * step)


def _walk(tree, path=""):
    """(path, leaf) pairs in JAX's flattening order (dict keys sorted)."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _walk(tree[k], f"{path}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _walk(v, f"{path}/{i}")
    else:
        yield path, tree


def _coord(mesh, name: str, rank: int | None = None) -> int:
    """The coordinate of a world rank (this one: None) on dim ``name`` of
    ``mesh`` (0 where the mesh has no such dim)."""
    names = mesh.mesh_dim_names
    if name not in names:
        return 0
    if rank is None:
        return mesh.get_coordinate()[names.index(name)]
    where = (mesh.mesh == rank).nonzero()[0]
    return int(where[names.index(name)])


def _group(mesh, name: str):
    return mesh.get_group(name) if name in mesh.mesh_dim_names else None


class ShardPlan:
    """The storage of a GPT param tree on a mesh with dims ``data`` and
    ``model`` (and ``stage``, see ``parallel/pipeline.py``): each leaf's
    :class:`Layout` from :func:`param_pspecs` (or from ``specs``), this
    rank's coordinates, and the shard / assemble maps. ``heads`` =
    (n_head, kv_heads) of the model (needed under ``tp`` for the QKV
    split)."""

    def __init__(self, params: dict, mesh, tp: bool = False,
                 fsdp: bool = False, heads: tuple | None = None,
                 specs: dict | None = None):
        shape = mesh_shape(mesh)
        self.mesh = mesh
        self.d, self.m = shape.get("data", 1), shape.get("model", 1)
        self.di, self.mi = _coord(mesh, "data"), _coord(mesh, "model")
        self.tp, self.fsdp = bool(tp), bool(fsdp)
        self.data_group = _group(mesh, "data")
        self.model_group = _group(mesh, "model")
        self.specs = specs if specs is not None else param_pspecs(
            params, tp, self.d if fsdp else None)
        if tp and heads is None:
            raise ValueError("tensor-parallel sharding needs the model's "
                             "heads (n_head, kv_heads)")
        self.heads = heads
        self.like = params
        layouts = []
        for (path, leaf), (_, spec) in zip(_walk(params),
                                           _walk_specs(self.specs)):
            md = spec.index("model") if "model" in spec else None
            dd = spec.index("data") if "data" in spec else None
            qkv = None
            if md is not None and path.endswith(("/attn/in_w",
                                                 "/attn/in_b")):
                H, Hkv = heads
                qkv = (H, Hkv, leaf.shape[0] // (H + 2 * Hkv))
            layouts.append(Layout(md if self.m > 1 else None,
                                  dd if self.d > 1 else None, qkv))
        self.layouts = layouts

    # a K/V head's rows under tp > kv_heads are held by kv_share ranks
    def kv_share(self) -> int:
        if not self.tp or self.m == 1:
            return 1
        return tp_shares(self.heads[0], self.heads[1], self.m)[2]

    def shard_leaf(self, full: torch.Tensor, lay: Layout,
                   di: int | None = None, mi: int | None = None):
        di = self.di if di is None else di
        mi = self.mi if mi is None else mi
        x = full
        if lay.model_dim is not None:
            idx = _model_index(lay, full.shape[lay.model_dim], mi, self.m)
            x = x.index_select(lay.model_dim, idx.to(x.device))
        if lay.data_dim is not None:
            x = x.chunk(self.d, lay.data_dim)[di]
        return x.contiguous()

    def shard(self, params: dict) -> dict:
        """This rank's block of every leaf of the whole tree ``params``."""
        leaves = [self.shard_leaf(leaf, lay).clone()
                  for (_, leaf), lay in zip(_walk(params), self.layouts)]
        return tree_unflatten(params, leaves)

    def assemble_leaves(self, by_coord: dict, like: list) -> list:
        """{(data rank, model rank): [its blocks]} -> the whole leaves
        (``like``: leaves of the whole shapes)."""
        out = []
        for i, (lay, ref) in enumerate(zip(self.layouts, like)):
            per_model = []
            for mi in range(self.m if lay.model_dim is not None else 1):
                pieces = [by_coord[(di, mi)][i] for di in range(self.d)]
                per_model.append(pieces[0] if lay.data_dim is None
                                 else torch.cat(pieces, lay.data_dim))
            if lay.model_dim is None:
                out.append(per_model[0])
                continue
            full = torch.empty(tuple(ref.shape), dtype=per_model[0].dtype)
            for mi, piece in enumerate(per_model):
                idx = _model_index(lay, ref.shape[lay.model_dim], mi, self.m)
                full.index_copy_(lay.model_dim, idx, piece)
            out.append(full)
        return out

    def assemble(self, local_trees: list) -> list:
        """Whole trees (on the CPU, on every rank) from this rank's
        blocks of each tree in ``local_trees`` (trees shaped like the
        params): one gather of every rank's blocks over the world."""
        mine = [[leaf.detach().cpu() for _, leaf in _walk(t)]
                for t in local_trees]
        everyone = [None] * dist.get_world_size()
        dist.all_gather_object(everyone, mine)
        like = [leaf for _, leaf in _walk(self.like)]
        coords = {g: (_coord(self.mesh, "data", g),
                      _coord(self.mesh, "model", g))
                  for g in range(len(everyone))}
        return [tree_unflatten(self.like, self.assemble_leaves(
            {coords[g]: everyone[g][k] for g in coords}, like))
            for k in range(len(local_trees))]


    # ------------------------------------------------ the training step

    def rows(self, t):
        """This data rank's rows of each micro-batch of a global
        [accum, micro, T] batch (JAX's ``P(None, "data", None)``)."""
        if t is None or self.d == 1:
            return t
        M = t.shape[1]
        if M % self.d:
            raise ValueError(f"micro_batch={M} not divisible by the data "
                             f"axis ({self.d})")
        step = M // self.d
        return t[:, self.di * step:(self.di + 1) * step]

    def gather_step(self, leaves: list) -> list:
        """The model-rank block of every leaf from this rank's FSDP pieces:
        ONE all_gather over the data group of all pieces (a buffer a
        dtype); leaves not split over data pass as they are."""
        idx = [i for i, lay in enumerate(self.layouts)
               if lay.data_dim is not None]
        out = list(leaves)
        for dt in {leaves[i].dtype for i in idx}:
            part = [i for i in idx if leaves[i].dtype == dt]
            flat = torch.cat([leaves[i].reshape(-1) for i in part])
            got = torch.empty(self.d * flat.numel(), dtype=dt,
                              device=flat.device)
            dist.all_gather_into_tensor(got, flat, group=self.data_group)
            got = got.view(self.d, -1)
            off = 0
            for i in part:
                n = leaves[i].numel()
                out[i] = torch.cat([got[r, off:off + n].view_as(leaves[i])
                                    for r in range(self.d)],
                                   self.layouts[i].data_dim)
                off += n
        return out

    def _kv_rows(self, i: int, rows: int) -> slice | None:
        """The K/V rows of leaf ``i``'s model block where ``kv_share``
        ranks hold them, else None."""
        lay = self.layouts[i]
        if lay.qkv is None or self.kv_share() == 1:
            return None
        H, Hkv, Dh = lay.qkv
        return slice(H // self.m * Dh, rows)

    def sync_kv(self, grads: list) -> None:
        """Sum the gradients of the K/V rows over the ranks that share them
        (tp > kv_heads), in place: ONE all_reduce over the model group of a
        [kv_heads, ...] buffer in which each rank fills its head's slot."""
        share = self.kv_share()
        if share == 1:
            return
        parts = [(i, self._kv_rows(i, grads[i].shape[0]))
                 for i in range(len(grads))]
        parts = [(i, sl) for i, sl in parts if sl is not None]
        flat = torch.cat([grads[i][sl].reshape(-1) for i, sl in parts])
        Hkv = self.heads[1]
        buf = torch.zeros((Hkv, flat.numel()), dtype=flat.dtype,
                          device=flat.device)
        buf[self.mi // share] = flat
        dist.all_reduce(buf, group=self.model_group)
        flat = buf[self.mi // share]
        off = 0
        for i, sl in parts:
            g = grads[i][sl]
            g.copy_(flat[off:off + g.numel()].view_as(g))
            off += g.numel()

    def reduce_grads(self, grads: list, extra: torch.Tensor) -> tuple:
        """Sum the step's gradients (model-rank blocks, whole over data) and
        ``extra`` (a 1-D f32 tensor: the loss sum) over the data group: the
        leaves split over data by ONE reduce_scatter, the others and
        ``extra`` by ONE all_reduce. -> (this rank's gradient blocks,
        ``extra`` summed)."""
        self.sync_kv(grads)
        split = [i for i, lay in enumerate(self.layouts)
                 if lay.data_dim is not None]
        out = list(grads)
        if split:
            flat = torch.cat([torch.cat([grads[i].chunk(
                self.d, self.layouts[i].data_dim)[r].reshape(-1)
                for i in split]) for r in range(self.d)])
            mine = torch.empty(flat.numel() // self.d, dtype=flat.dtype,
                               device=flat.device)
            dist.reduce_scatter_tensor(mine, flat, group=self.data_group)
            off = 0
            for i in split:
                shape = grads[i].chunk(self.d, self.layouts[i].data_dim)[
                    self.di].shape
                n = shape.numel()
                out[i] = mine[off:off + n].view(shape)
                off += n
        rest = [i for i in range(len(grads)) if i not in set(split)]
        whole = [grads[i].reshape(-1) for i in rest] + [extra.reshape(-1)]
        flat = torch.cat(whole)
        dist.all_reduce(flat, group=self.data_group)
        off = 0
        for i in rest:
            out[i] = flat[off:off + grads[i].numel()].view_as(grads[i])
            off += grads[i].numel()
        return out, flat[off:]

    def global_norm(self, grads: list) -> torch.Tensor:
        """The global L2 norm of the whole gradient from this rank's blocks:
        :meth:`weighted_sq` summed over the world; no collective when every
        block is whole on every rank."""
        if all(lay.data_dim is None and lay.model_dim is None
               for lay in self.layouts):
            return torch.stack(torch._foreach_norm(grads)).square().sum() \
                .sqrt()
        total = self.weighted_sq(grads)
        dist.all_reduce(total)
        return total.sqrt()

    def weighted_sq(self, grads: list) -> torch.Tensor:
        """This rank's share of the squared norm of the whole gradient:
        each block's squared norm weighted by 1 / the ranks of the (data,
        model) mesh holding the same block (a K/V row shared by
        ``kv_share`` ranks once)."""
        reps, pieces = [], []
        share = self.kv_share()
        for i, (g, lay) in enumerate(zip(grads, self.layouts)):
            rep = (self.d if lay.data_dim is None else 1) * \
                (self.m if lay.model_dim is None else 1)
            kv = self._kv_rows(i, g.shape[0])
            if kv is None:
                pieces.append(g)
                reps.append(rep)
            else:
                pieces += [g[:kv.start], g[kv]]
                reps += [rep, rep * share]
        norms = torch.stack(torch._foreach_norm(pieces)).square()
        w = torch.tensor([1.0 / r for r in reps], dtype=norms.dtype,
                         device=norms.device)
        return (norms * w).sum()


def _walk_specs(specs):
    if isinstance(specs, dict):
        for k in sorted(specs):
            yield from _walk_specs(specs[k])
    elif isinstance(specs, list):
        for i, v in enumerate(specs):
            yield from _walk_specs(v)
    else:
        yield None, specs


def shard_params(params: dict, mesh, tp: bool = False, fsdp: bool = False,
                 cfg=None) -> dict:
    """This rank's block of every leaf of ``params`` on ``mesh``, as
    :func:`param_pspecs` places it (``cfg``, a ``GPTConfig``, gives the
    heads of the QKV split under ``tp``)."""
    heads = (cfg.n_head, cfg.kv_heads) if cfg is not None else None
    return ShardPlan(params, mesh, tp, fsdp, heads).shard(params)
