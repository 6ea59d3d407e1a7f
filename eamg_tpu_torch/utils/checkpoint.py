"""Checkpoint I/O: the JAX package's pickle + json directory, read without
JAX or ``ml_dtypes``.

A checkpoint directory holds ``params.pkl`` (a tree of numpy arrays; bf16
leaves are ``ml_dtypes.bfloat16`` arrays), ``meta.json`` (the GPT config)
and ``vocab.json``. The unpickler maps ``ml_dtypes``' bfloat16 dtype to
``np.uint16``: numpy reconstructs the array from its raw bytes, so each
bf16 leaf arrives as its bit pattern and becomes a ``torch.bfloat16``
tensor by a view, with no rounding.
"""

from __future__ import annotations

import json
import os
import pickle

import numpy as np
import torch

from ..models.gpt import GPTConfig


class _NoMlDtypesUnpickler(pickle.Unpickler):
    def find_class(self, module, name):
        if module == "ml_dtypes" and name == "bfloat16":
            return np.uint16
        return super().find_class(module, name)


def _leaf_to_torch(a) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype == np.uint16 or a.dtype.name == "bfloat16":
        return torch.from_numpy(np.ascontiguousarray(a).view(np.uint16)
                                .copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(a, copy=True))


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_tree_map(fn, v) for v in tree]
    return fn(tree)


def params_from_jax(tree) -> dict:
    """A JAX parameter tree of numpy arrays -> the same tree of CPU torch
    tensors. Leaves are float32, float16, or bf16 given either as
    ``ml_dtypes.bfloat16`` or as raw uint16 bit patterns (a GPT parameter
    tree holds no real uint16 data)."""
    return _tree_map(_leaf_to_torch, tree)


def load_checkpoint(path: str) -> dict:
    """-> {"params" (CPU tensors), "vocab" (tok2id), "cfg", "step"}."""
    with open(os.path.join(path, "params.pkl"), "rb") as f:
        raw = _NoMlDtypesUnpickler(f).load()
    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)
    if meta.get("format") == "orbax":
        raise NotImplementedError(
            "orbax checkpoints are not read by the port yet")
    with open(os.path.join(path, "vocab.json")) as f:
        vocab = json.load(f)
    # the unpickler turned bf16 leaves into their uint16 bit patterns
    return {"params": params_from_jax(raw), "vocab": vocab,
            "cfg": GPTConfig(**meta["cfg"]), "step": meta.get("step", 0)}


def _fused_layers(cache: dict) -> list:
    """``k``, ``v`` per layer [B, Hkv, M, Dh] as numpy -> per layer
    [B, M, 2 * KVD] CPU tensors: heads merged in head order, K then V."""
    def fuse(k, v):
        k, v = _leaf_to_torch(k), _leaf_to_torch(v)
        B, Hkv, M, Dh = k.shape
        return torch.cat([k.permute(0, 2, 1, 3).reshape(B, M, Hkv * Dh),
                          v.permute(0, 2, 1, 3).reshape(B, M, Hkv * Dh)],
                         dim=-1).contiguous()

    return [fuse(k, v) for k, v in zip(cache["k"], cache["v"])]


def ragged_cache_from_jax(cache: dict) -> dict:
    """A JAX ragged cache as numpy (``k``, ``v``: per layer
    [B, Hkv, M, Dh]; ``lengths`` [B]) -> the port's position-major fused
    layout ``{"kv": [per layer [B, M, 2 * KVD]], "lengths": [B] int32}``
    of CPU tensors."""
    return {"kv": _fused_layers(cache),
            "lengths": torch.from_numpy(
                np.asarray(cache["lengths"]).astype(np.int32))}


def fused_cache_from_jax(cache: dict) -> dict:
    """A JAX uniform cache as numpy (``k``, ``v`` as above; ``length`` a
    scalar) -> the port's ``layout="fused"`` cache ``{"kv": [...],
    "length": int}``."""
    return {"kv": _fused_layers(cache), "length": int(cache["length"])}


def ragged_cache_to_jax(cache: dict, kv_heads: int) -> dict:
    """The way back: the port's fused ragged cache -> numpy ``k``/``v``
    per layer [B, Hkv, M, Dh] (bf16 as float32) and ``lengths``."""
    ks, vs = [], []
    for kv in cache["kv"]:
        B, M, W = kv.shape
        halves = kv.float().cpu().reshape(B, M, 2, kv_heads,
                                          W // (2 * kv_heads))
        ks.append(halves[:, :, 0].permute(0, 2, 1, 3).numpy())
        vs.append(halves[:, :, 1].permute(0, 2, 1, 3).numpy())
    return {"k": ks, "v": vs, "lengths": cache["lengths"].cpu().numpy()}
