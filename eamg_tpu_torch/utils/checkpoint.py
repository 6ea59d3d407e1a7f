"""Checkpoint I/O: the JAX package's pickle + json directory, read and
written without JAX, optax or ``ml_dtypes``.

A checkpoint directory holds ``params.pkl`` (a tree of numpy arrays; bf16
leaves are ``ml_dtypes.bfloat16`` arrays), ``meta.json`` (the GPT config,
the step, the RNG key and extra fields), ``vocab.json`` and, for a
training run, ``opt_state.pkl``. The unpickler maps ``ml_dtypes``'
bfloat16 dtype to ``np.uint16``: numpy reconstructs the array from its raw
bytes, so each bf16 leaf arrives as its bit pattern and becomes a
``torch.bfloat16`` tensor by a view, with no rounding. The writer does the
reverse: a bf16 tensor's bits go out under the ``ml_dtypes.bfloat16``
dtype, so the JAX package's ``load_checkpoint`` reads JAX's own arrays.

``opt_state.pkl`` is the tree of optax state namedtuples that the JAX
package's ``make_optimizer`` builds for the run's ``TrainConfig``: a
leading ``EmptyState()`` when ``clip_norm`` is set, then adamw's
``(ScaleByAdamState(count, mu, nu), EmptyState(), ScaleByScheduleState(
count) or EmptyState())``. The writer pickles stand-ins under optax's
module and class names (NEWOBJ with the fields, as a namedtuple pickles),
so the JAX package resumes from a checkpoint the port trained, and the
port never imports optax. The unpickler stands in for optax's classes and
the loader takes the count and the moments of the ``ScaleByAdamState``;
it also reads the plain dict (``{"count", "mu", "nu"}``) that earlier
versions of the port wrote.
"""

from __future__ import annotations

import copyreg
import dataclasses
import json
import os
import pickle
import time

import numpy as np
import torch

from ..models.gpt import GPTConfig


class _NoMlDtypesUnpickler(pickle.Unpickler):
    def find_class(self, module, name):
        if module == "ml_dtypes" and name == "bfloat16":
            return np.uint16
        if module == "optax" or module.startswith("optax."):
            return _optax_stand_in(name)
        return super().find_class(module, name)


def _optax_stand_in(name: str) -> type:
    """A tuple class named as optax's state class ``name``: optax's states
    are namedtuples, pickled as the class and its fields."""
    return type(name, (tuple,), {
        "__new__": lambda cls, *fields: tuple.__new__(cls, fields)})


def _adam_state(tree):
    """The ``ScaleByAdamState`` (count, mu, nu) inside an unpickled optax
    chain state, or None."""
    if type(tree).__name__ == "ScaleByAdamState":
        return tree
    if isinstance(tree, (tuple, list)):
        for sub in tree:
            found = _adam_state(sub)
            if found is not None:
                return found
    return None


def _leaf_to_torch(a) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype == np.uint16 or a.dtype.name == "bfloat16":
        return torch.from_numpy(np.ascontiguousarray(a).view(np.uint16)
                                .copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(a, copy=True))


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, _OptaxState):
        return type(tree)(*(_tree_map(fn, v) for v in tree))
    if isinstance(tree, tuple):
        return tuple(_tree_map(fn, v) for v in tree)
    if isinstance(tree, list):
        return [_tree_map(fn, v) for v in tree]
    return fn(tree)


def params_from_jax(tree) -> dict:
    """A JAX parameter tree of numpy arrays -> the same tree of CPU torch
    tensors. Leaves are float32, float16, or bf16 given either as
    ``ml_dtypes.bfloat16`` or as raw uint16 bit patterns (a GPT parameter
    tree holds no real uint16 data)."""
    return _tree_map(_leaf_to_torch, tree)


def _load_opt_state(path: str):
    """``opt_state.pkl`` -> {"count": int, "mu": tree, "nu": tree} of CPU
    tensors, from the port's dict or JAX's optax chain state; None
    without the file."""
    if not os.path.exists(path):
        return None
    with open(path, "rb") as f:
        raw = _NoMlDtypesUnpickler(f).load()
    if isinstance(raw, dict):
        count, mu, nu = raw["count"], raw["mu"], raw["nu"]
    else:
        adam = _adam_state(raw)
        if adam is None:
            raise ValueError(f"{path}: no adam state in the optimizer state")
        count, mu, nu = adam
    return {"count": int(np.asarray(count)), "mu": params_from_jax(mu),
            "nu": params_from_jax(nu)}


def load_checkpoint(path: str) -> dict:
    """-> {"params" (CPU tensors), "vocab" (tok2id), "cfg", "opt_state"
    (:func:`_load_opt_state`, or None), "step", "rng_key", "extra"}."""
    with open(os.path.join(path, "params.pkl"), "rb") as f:
        raw = _NoMlDtypesUnpickler(f).load()
    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)
    if meta.get("format") == "orbax":
        raise NotImplementedError(
            "orbax checkpoints are not read by the port yet")
    with open(os.path.join(path, "vocab.json")) as f:
        vocab = json.load(f)
    rng = meta.get("rng_key")
    # the unpickler turned bf16 leaves into their uint16 bit patterns
    return {"params": params_from_jax(raw), "vocab": vocab,
            "cfg": GPTConfig(**meta["cfg"]),
            "opt_state": _load_opt_state(os.path.join(path,
                                                      "opt_state.pkl")),
            "step": meta.get("step", 0),
            "rng_key": (np.asarray(rng, np.uint32) if rng is not None
                        else None),
            "extra": meta.get("extra", {})}


class _Bf16Bits:
    """A bf16 leaf on its way out: its bits as a uint16 array."""

    def __init__(self, bits: np.ndarray):
        self.bits = bits


class _MlDtypesBfloat16:
    """Stands for the global ``ml_dtypes.bfloat16`` in a written pickle."""


_BF16_DTYPE = object()   # stands for np.dtype(ml_dtypes.bfloat16)
# numpy's array reconstructor, wherever this numpy keeps it
_RECONSTRUCT = np.zeros(0).__reduce__()[0]


class _OptaxState(tuple):
    """An optax state namedtuple on its way out: pickled as its class (by
    optax's module and name) and its fields, as a namedtuple is."""

    module = name = ""

    def __new__(cls, *fields):
        return tuple.__new__(cls, fields)


class _EmptyState(_OptaxState):
    module, name = "optax._src.base", "EmptyState"


class _ScaleByAdamState(_OptaxState):
    module, name = "optax._src.transform", "ScaleByAdamState"


class _ScaleByScheduleState(_OptaxState):
    module, name = "optax._src.transform", "ScaleByScheduleState"


def optax_state(opt_state: dict, tcfg=None) -> tuple:
    """``{"count", "mu", "nu"}`` -> the state tree of the JAX package's
    ``make_optimizer(tcfg)`` (``tcfg`` None: the default ``TrainConfig``,
    constant rate and no clip), with an int32 count."""
    count = np.asarray(opt_state["count"], np.int32)
    schedule = (_ScaleByScheduleState(count)
                if getattr(tcfg, "schedule", "constant") == "warmup_cosine"
                else _EmptyState())
    adamw = (_ScaleByAdamState(count, opt_state["mu"], opt_state["nu"]),
             _EmptyState(), schedule)
    return (_EmptyState(), adamw) if getattr(tcfg, "clip_norm", None) \
        else (adamw,)


class _CheckpointPickler(pickle._Pickler):
    """Writes a bf16 leaf as numpy pickles an ``ml_dtypes.bfloat16`` array
    (the reconstructor, the dtype ``np.dtype(ml_dtypes.bfloat16, False,
    True)`` with its state, the raw bytes), without importing
    ``ml_dtypes``; and an optax state as optax's namedtuple."""

    def reducer_override(self, obj):
        if isinstance(obj, _OptaxState):
            return (copyreg.__newobj__, (type(obj), *obj))
        if isinstance(obj, _Bf16Bits):
            return (_RECONSTRUCT, (np.ndarray, (0,), b"b"),
                    (1, obj.bits.shape, _BF16_DTYPE, False,
                     np.ascontiguousarray(obj.bits).tobytes()))
        if obj is _BF16_DTYPE:
            return (np.dtype, (_MlDtypesBfloat16, False, True),
                    (3, "<", None, None, None, 2, 2, 64))
        return NotImplemented

    def save_global(self, obj, name=None):
        if obj is _MlDtypesBfloat16:
            self._stack_global(obj, "ml_dtypes", "bfloat16")
            return
        if isinstance(obj, type) and issubclass(obj, _OptaxState):
            self._stack_global(obj, obj.module, obj.name)
            return
        super().save_global(obj, name)

    def _stack_global(self, obj, module: str, name: str) -> None:
        self.save(module)
        self.save(name)
        self.write(pickle.STACK_GLOBAL)
        self.memoize(obj)


def _leaf_to_numpy(t):
    if isinstance(t, torch.Tensor):
        t = t.detach().cpu()
        if t.dtype == torch.bfloat16:
            return _Bf16Bits(t.view(torch.int16).numpy().view(np.uint16))
        return t.numpy()
    return np.asarray(t)


def _dump(path: str, tree) -> None:
    with open(path, "wb") as f:
        _CheckpointPickler(f, protocol=4).dump(_tree_map(_leaf_to_numpy,
                                                         tree))


def save_checkpoint(path: str, params: dict, vocab_tok2id: dict,
                    cfg: GPTConfig, opt_state: dict | None = None,
                    step: int = 0, rng_key=None,
                    extra: dict | None = None, tcfg=None) -> None:
    """Write a self-contained checkpoint directory in the JAX package's
    format: ``params.pkl`` (numpy leaves; bf16 ones as
    ``ml_dtypes.bfloat16`` arrays), ``meta.json`` with exactly JAX's
    ``GPTConfig`` fields, ``vocab.json``, and ``opt_state.pkl`` when
    ``opt_state`` ({"count", "mu", "nu"}, moments as trees) is given, as
    the optax state tree of the run's ``TrainConfig`` ``tcfg``
    (:func:`optax_state`)."""
    os.makedirs(path, exist_ok=True)
    _dump(os.path.join(path, "params.pkl"), params)
    if opt_state is not None:
        _dump(os.path.join(path, "opt_state.pkl"),
              optax_state(opt_state, tcfg))
    meta = {
        "cfg": dataclasses.asdict(cfg),
        "step": int(step),
        "rng_key": (np.asarray(rng_key).tolist()
                    if rng_key is not None else None),
        "extra": extra or {},
    }
    with open(os.path.join(path, "meta.json"), "w") as f:
        json.dump(meta, f)
    with open(os.path.join(path, "vocab.json"), "w") as f:
        json.dump(vocab_tok2id, f, ensure_ascii=False)


class CheckpointCadence:
    """step-interval + wall-clock cadence tracker (reference flavors)."""

    def __init__(self, every_steps: int | None = None,
                 every_hours: float | None = None):
        self.every_steps = every_steps
        self.every_secs = every_hours * 3600 if every_hours else None
        self._last_wall = time.time()

    def should_save(self, step: int) -> bool:
        hit = False
        if self.every_steps and step > 0 and step % self.every_steps == 0:
            hit = True
        if self.every_secs and time.time() - self._last_wall >= \
                self.every_secs:
            hit = True
        if hit:
            self._last_wall = time.time()
        return hit


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
