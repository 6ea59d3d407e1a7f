"""The collectives of the parallel modes that carry a gradient, and the
tensor-parallel context the model's functions take.

Each differentiable collective is a ``torch.autograd.Function`` whose
backward is the transposed collective, as JAX transposes ``psum``,
``ppermute`` and ``all_to_all`` under ``jax.grad``:

- :func:`copy_to_region` (identity; backward all_reduce) and
  :func:`reduce_from_region` (all_reduce; backward identity): Megatron's
  pair around a column-parallel and a row-parallel product, the psums that
  GSPMD inserts for ``parallel/mesh.py::param_pspecs``' layout;
- :func:`gather_from_region`: an all_gather along a dim (backward: this
  rank's slice), for the vocabulary-parallel head;
- :func:`rotate`: a ring step (send to the next rank, receive from the
  previous; backward rotates the other way), ``lax.ppermute`` with the
  ring permutation;
- :func:`all_to_all`: ``all_to_all_single`` over equal splits of dim 0,
  which is its own transpose.

:class:`TensorParallel` holds a model group and the rank's share of the
heads: ``models/gpt.py`` takes it as ``tp=`` on its training and inference
functions. Every function here runs on gloo (CPU tensors) and NCCL (CUDA
tensors) alike.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist


def _size(group) -> int:
    return dist.get_world_size(group)


def _all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    out = x.contiguous().clone()
    dist.all_reduce(out, group=group)
    return out


def _all_gather(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """[.., n, ..] on each of the group's ranks -> [.., size * n, ..], the
    ranks' pieces in rank order along ``dim``."""
    n = _size(group)
    xt = x.movedim(dim, 0).contiguous()
    out = torch.empty((n * xt.shape[0],) + tuple(xt.shape[1:]),
                      dtype=x.dtype, device=x.device)
    dist.all_gather_into_tensor(out, xt, group=group)
    return out.movedim(0, dim).contiguous()


class _CopyToRegion(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None


class _ReduceFromRegion(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _ReduceEverywhere(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None


def reduce_everywhere(x: torch.Tensor, group) -> torch.Tensor:
    """all_reduce (sum) over ``group`` whose backward all_reduces too: a
    sum that every rank's loss reads, each rank's gradient reaching every
    rank's inputs."""
    return _ReduceEverywhere.apply(x, group)


class _GatherFromRegion(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim, ctx.n = group, dim, x.shape[dim]
        ctx.rank = dist.get_rank(group)
        return _all_gather(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return (g.narrow(ctx.dim, ctx.rank * ctx.n, ctx.n).contiguous(),
                None, None)


def copy_to_region(x: torch.Tensor, group) -> torch.Tensor:
    """Identity forward; the backward all_reduces the gradient over
    ``group`` (the input of a column-parallel product)."""
    return _CopyToRegion.apply(x, group)


def reduce_from_region(x: torch.Tensor, group) -> torch.Tensor:
    """all_reduce (sum) over ``group``; the backward passes the gradient
    through (the output of a row-parallel product)."""
    return _ReduceFromRegion.apply(x, group)


def gather_from_region(x: torch.Tensor, group, dim: int = -1):
    """The group's pieces concatenated along ``dim`` in rank order; the
    backward keeps this rank's slice of the gradient."""
    return _GatherFromRegion.apply(x, group, dim % x.dim())


def _exchange(x: torch.Tensor, group, send_to: int, recv_from: int):
    """Send ``x`` to group rank ``send_to`` and receive a tensor like it
    from ``recv_from`` (both at once: ``batch_isend_irecv``)."""
    x = x.contiguous()
    out = torch.empty_like(x)
    ops = [dist.P2POp(dist.isend, x, dist.get_global_rank(group, send_to),
                      group),
           dist.P2POp(dist.irecv, out,
                      dist.get_global_rank(group, recv_from), group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return out


class _Rotate(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, shift):
        n, r = _size(group), dist.get_rank(group)
        ctx.group, ctx.shift = group, shift
        return _exchange(x, group, (r + shift) % n, (r - shift) % n)

    @staticmethod
    def backward(ctx, g):
        n, r = _size(ctx.group), dist.get_rank(ctx.group)
        return (_exchange(g, ctx.group, (r - ctx.shift) % n,
                          (r + ctx.shift) % n), None, None)


def rotate(x: torch.Tensor, group, shift: int = 1) -> torch.Tensor:
    """One step of a ring: rank r sends ``x`` to rank r + shift and returns
    what rank r - shift sent (``lax.ppermute`` with ``(i, i + shift)``
    pairs); the backward rotates the gradient the other way. A group of
    one returns ``x``."""
    if _size(group) == 1:
        return x
    return _Rotate.apply(x, group, shift)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        x = x.contiguous()
        out = torch.empty_like(x)
        dist.all_to_all_single(out, x, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous()
        out = torch.empty_like(g)
        dist.all_to_all_single(out, g, group=ctx.group)
        return out, None


def all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    """x [n, ...] (n the group's size): slice j goes to rank j, and slice j
    of the result came from rank j (``lax.all_to_all(x, axis, 0, 0)``);
    the backward is the same exchange."""
    return _AllToAll.apply(x, group)


def all_reduce_(tensors: list, group) -> None:
    """Sum each tensor in place over ``group`` with ONE all_reduce: the
    tensors (one dtype) are flattened into one buffer and back."""
    if not tensors:
        return
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat, group=group)
    off = 0
    for t in tensors:
        t.copy_(flat[off:off + t.numel()].view_as(t))
        off += t.numel()


@dataclasses.dataclass(frozen=True, eq=False)
class TensorParallel:
    """A model group and this rank's share of the model: ``n_head`` query
    heads and ``kv_heads`` K/V heads of the attention (one K/V head, held
    by several ranks, when the group is larger than the model's K/V
    heads), the rank's FFN columns and experts (by its ``rank`` in the
    group) and its rows of the vocabulary."""
    group: object
    rank: int
    size: int
    n_head: int
    kv_heads: int

    # a group of one takes none of them: its step is the plain step's
    # arithmetic, autograd's order of sums included
    def copy(self, x):
        return x if self.size == 1 else copy_to_region(x, self.group)

    def reduce(self, x):
        return x if self.size == 1 else reduce_from_region(x, self.group)

    def gather(self, x, dim: int = -1):
        return x if self.size == 1 else \
            gather_from_region(x, self.group, dim)


def tp_shares(n_head: int, kv_heads: int, size: int) -> tuple:
    """-> (query heads, K/V heads, ranks a K/V head) of one rank of a model
    group of ``size``; raises where the heads do not split."""
    if n_head % size:
        raise ValueError(f"n_head={n_head} does not split over a model "
                         f"axis of {size}")
    if kv_heads % size == 0:
        return n_head // size, kv_heads // size, 1
    if size % kv_heads:
        raise ValueError(f"kv_heads={kv_heads} and a model axis of {size}: "
                         "one must divide the other")
    return n_head // size, 1, size // kv_heads


def tensor_parallel(cfg, group) -> TensorParallel:
    """The :class:`TensorParallel` of ``cfg`` (a ``GPTConfig``) over the
    process group ``group``."""
    size = _size(group)
    h, kv, _ = tp_shares(cfg.n_head, cfg.kv_heads, size)
    return TensorParallel(group, dist.get_rank(group), size, h, kv)
