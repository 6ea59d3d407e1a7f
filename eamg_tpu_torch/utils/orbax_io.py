"""Orbax checkpoints, read and written without orbax.

Port of ``eamg_tpu/utils/orbax_io.py``. The JAX package's Orbax directory
holds ``meta.json`` (the GPT config, the step, extra fields and
``"format": "orbax"``), ``vocab.json``, ``params/`` (the parameter tree)
and, for a training run, ``opt_state/`` (``{"leaves": [...]}``: the
optax state's leaves in JAX's flattening order, which
:func:`coerce_opt_state` puts back into a template's structure). Each of
``params/`` and ``opt_state/`` is what ``orbax.checkpoint.
PyTreeCheckpointer`` writes: ``_METADATA`` (the tree's key paths and
their kinds), ``_CHECKPOINT_METADATA`` and an OCDBT store of zarr v2
arrays named by the dot-joined key path (``utils/ocdbt.py``). The port
reads them, and writes them so that orbax restores them; no orbax,
tensorstore or zstd module is needed.

The loader returns what ``utils/checkpoint.py::load_checkpoint`` returns
(CPU tensors, bf16 leaves as ``torch.bfloat16`` from their bits, and the
optimizer state as the port's ``{"count", "mu", "nu"}``), so the server
and the trainer take either format.
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
import time

import numpy as np
import torch

from ..models.gpt import GPTConfig
from . import ocdbt
from .checkpoint import _OptaxState, load_checkpoint, optax_state

_HANDLER = ("orbax.checkpoint._src.handlers.pytree_checkpoint_handler."
            "PyTreeCheckpointHandler")
# numpy's little-endian dtype string -> zarr's (the same but bfloat16)
_ZARR_OF = {np.dtype(v).str: k for k, v in ocdbt.DTYPES.items()
            if k != "bfloat16"}


def _walk(tree, path=()):
    """(key path, leaf) pairs in JAX's flattening order: dict keys sorted,
    sequences and optax states in order, empty states holding nothing."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _walk(tree[k], path + (str(k),))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _walk(v, path + (str(i),))
    else:
        yield path, tree


def _to_numpy(leaf) -> tuple:
    """A leaf -> (numpy array, its zarr dtype string)."""
    if isinstance(leaf, torch.Tensor):
        leaf = leaf.detach().cpu()
        if leaf.dtype == torch.bfloat16:
            return leaf.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        leaf = leaf.numpy()
    a = np.asarray(leaf)
    if a.dtype.name == "bfloat16":
        return a.view(np.uint16), "bfloat16"
    return a, _ZARR_OF[a.dtype.newbyteorder("<").str]


def _to_torch(a: np.ndarray, dtype: str) -> torch.Tensor:
    t = torch.from_numpy(np.array(a, copy=True))
    return t.view(torch.bfloat16) if dtype == "bfloat16" else t


def save_tree(path: str, tree) -> None:
    """``tree`` (nested dicts and sequences of tensors or arrays) as
    ``PyTreeCheckpointer.save(path, tree)`` writes it, replacing what was
    there."""
    if os.path.isdir(path):
        shutil.rmtree(path)
    t0 = time.time_ns()
    values, meta = {}, {}
    for keys, leaf in _walk(tree):
        arr, dtype = _to_numpy(leaf)
        values.update(ocdbt.array_values(".".join(keys), arr, dtype))
        kinds = _key_kinds(tree, keys)
        meta[str(keys)] = {
            "key_metadata": [{"key": k, "key_type": kind}
                             for k, kind in zip(keys, kinds)],
            "value_metadata": {"value_type": "np.ndarray",
                               "skip_deserialize": False}}
    ocdbt.write_store(path, values)
    with open(os.path.join(path, "_METADATA"), "w") as f:
        json.dump({"tree_metadata": meta, "use_ocdbt": True,
                   "use_zarr3": False,
                   "store_array_data_equal_to_fill_value": True,
                   "custom_metadata": None}, f)
    with open(os.path.join(path, "_CHECKPOINT_METADATA"), "w") as f:
        json.dump({"item_handlers": _HANDLER, "metrics": {},
                   "performance_metrics": {}, "init_timestamp_nsecs": t0,
                   "commit_timestamp_nsecs": time.time_ns(),
                   "custom_metadata": {}}, f)


def _key_kinds(tree, keys: tuple) -> list:
    """Orbax's key types along a path: 2 a dict key, 1 a sequence
    index."""
    kinds, node = [], tree
    for k in keys:
        if isinstance(node, dict):
            kinds.append(2)
            node = node[k]
        else:
            kinds.append(1)
            node = node[int(k)]
    return kinds


def load_tree(path: str):
    """A ``PyTreeCheckpointer`` directory -> its tree, dicts and lists of
    CPU tensors (bf16 from their bits)."""
    with open(os.path.join(path, "_METADATA")) as f:
        meta = json.load(f)
    if not meta.get("use_ocdbt", False) or meta.get("use_zarr3", False):
        raise ValueError(f"{path}: an OCDBT tree of zarr v2 arrays only")
    store = ocdbt.Store(path)
    root: dict = {}
    for entry in meta["tree_metadata"].values():
        keys = [m["key"] for m in entry["key_metadata"]]
        kinds = [m["key_type"] for m in entry["key_metadata"]]
        arr, dtype = ocdbt.read_array(store, ".".join(keys))
        node = root
        for i, (k, kind) in enumerate(zip(keys, kinds)):
            nxt_kind = kinds[i + 1] if i + 1 < len(keys) else None
            last = i + 1 == len(keys)
            key = int(k) if kind == 1 else k
            value = _to_torch(arr, dtype) if last else \
                ([] if nxt_kind == 1 else {})
            if kind == 1:
                while len(node) <= key:
                    node.append(None)
                if node[key] is None:
                    node[key] = value
                node = node[key]
            else:
                node = node.setdefault(key, value)
    return root


def save_checkpoint_orbax(path: str, params: dict, vocab_tok2id: dict,
                          cfg: GPTConfig, opt_state: dict | None = None,
                          step: int = 0, extra: dict | None = None,
                          tcfg=None) -> None:
    """Write the JAX package's Orbax checkpoint directory: ``params/``,
    ``opt_state/`` when ``opt_state`` ({"count", "mu", "nu"}) is given, as
    the leaves of the optax state of ``tcfg``'s ``make_optimizer``
    (``utils/checkpoint.py::optax_state``), ``meta.json`` and
    ``vocab.json``."""
    path = os.path.abspath(path)
    os.makedirs(path, exist_ok=True)
    save_tree(os.path.join(path, "params"), params)
    if opt_state is not None:
        leaves = [leaf for _, leaf in _walk(optax_state(opt_state, tcfg))]
        save_tree(os.path.join(path, "opt_state"), {"leaves": leaves})
    with open(os.path.join(path, "meta.json"), "w") as f:
        json.dump({"cfg": dataclasses.asdict(cfg), "step": int(step),
                   "extra": extra or {}, "format": "orbax"}, f)
    with open(os.path.join(path, "vocab.json"), "w") as f:
        json.dump(vocab_tok2id, f, ensure_ascii=False)


def coerce_opt_state(restored, template):
    """The leaves of a restored opt_state (``{"leaves": [...]}``, or a
    tree with the same leaf order) in ``template``'s structure (nested
    dicts, lists, tuples and the port's optax stand-ins, as
    ``utils/checkpoint.py::optax_state`` builds them)."""
    if isinstance(restored, dict) and set(restored) == {"leaves"}:
        leaves = restored["leaves"]
        if isinstance(leaves, dict):
            leaves = [leaves[k] for k in sorted(leaves, key=int)]
    else:
        leaves = [leaf for _, leaf in _walk(restored)]
    it = iter(leaves)

    def build(node):
        if isinstance(node, dict):
            return {k: build(node[k]) for k in sorted(node)}
        if isinstance(node, _OptaxState):
            return type(node)(*(build(v) for v in node))
        if isinstance(node, (list, tuple)):
            return type(node)(build(v) for v in node)
        return next(it)

    out = build(template)
    if next(it, None) is not None:
        raise ValueError("the restored state has more leaves than the "
                         "template")
    return out


def load_checkpoint_orbax(path: str) -> dict:
    """-> what ``utils/checkpoint.py::load_checkpoint`` returns: {"params"
    (CPU tensors), "vocab", "cfg", "opt_state" ({"count", "mu", "nu"} of
    the adam state, or None), "step", "rng_key" (None: Orbax keeps none),
    "extra"}."""
    path = os.path.abspath(path)
    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)
    with open(os.path.join(path, "vocab.json")) as f:
        vocab = json.load(f)
    params = load_tree(os.path.join(path, "params"))
    opt_state = None
    if os.path.isdir(os.path.join(path, "opt_state")):
        restored = load_tree(os.path.join(path, "opt_state"))
        # the adam state's (count, mu, nu) lead the leaves; an empty state
        # holds none, a schedule's count follows them
        n = 1 + 2 * sum(1 for _ in _walk(params))
        adam = coerce_opt_state({"leaves": restored["leaves"][:n]},
                                {"count": 0, "mu": params, "nu": params})
        if adam["count"].dim() != 0 or any(
                m.shape != p.shape for part in ("mu", "nu")
                for (_, m), (_, p) in zip(_walk(adam[part]),
                                          _walk(params))):
            raise ValueError(f"{path}: opt_state is not an adam state of "
                             "these params")
        opt_state = {"count": int(adam["count"]), "mu": adam["mu"],
                     "nu": adam["nu"]}
    return {"params": params, "vocab": vocab,
            "cfg": GPTConfig(**meta["cfg"]), "opt_state": opt_state,
            "step": meta.get("step", 0), "rng_key": None,
            "extra": meta.get("extra", {})}


# JAX's dispatcher: ``load_checkpoint`` reads ``meta.json`` first and hands
# an Orbax directory to :func:`load_checkpoint_orbax`
load_any_checkpoint = load_checkpoint
