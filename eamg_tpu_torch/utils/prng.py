"""JAX's threefry PRNG, bit for bit, in plain integer PyTorch ops.

Sampled token streams and the additive synth's drum noise can only match
the JAX package if the random bits match. This module reproduces
``jax.random`` as jax 0.9.0 runs it with ``jax_threefry_partitionable=True``
(its default): ``PRNGKey``, ``split``, ``bits``, ``uniform``, ``gumbel`` and
``categorical``.

A key is a pair of Python ints (two uint32 words). The key schedule is
cheap scalar work and stays on the host; only the bit arrays are torch
tensors, made on the device that asks for them. ``_threefry2x32`` is
written with plain operators so the same code serves Python ints, int64
numpy arrays and int64 tensors (each word kept masked to 32 bits).

Batches of keys, one per row of a ragged batch or per slot of the
continuous engine, are ``[N, 2]`` uint32 numpy arrays on the host
(:func:`key_rows`, :func:`split_rows`, :func:`split_rows_chain`: what
``jax.vmap(jax.random.split)`` gives). A row's key chain depends on its
seed and its step count alone, so it is advanced on the host, vectorised
over the rows, and only the sampling keys of a whole chunk of steps go to
the device, where :func:`bits_keys` draws all their noise in one batch
(inside the decode block's CUDA graph, from a static key buffer).

Partitionable mode, as in ``jax/_src/prng.py``:
- ``split(key, n)[i] = threefry(key, (hi(i), lo(i)))``, both output words;
- ``bits(key, shape)[i] = x0 ^ x1`` of ``threefry(key, (hi(i), lo(i)))``
  over the row-major flat index ``i``.
"""

from __future__ import annotations

import math

import numpy as np
import torch

_M = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))
F32_TINY = 1.1754943508222875e-38   # np.finfo(np.float32).tiny


def _rotl(x, r: int):
    return ((x << r) & _M) | (x >> (32 - r))


def _threefry2x32(k0, k1, x0, x1):
    """Threefry-2x32, 20 rounds (jax ``_threefry2x32_lowering``). Keys and
    counts may be Python ints or int64 tensors holding uint32 values."""
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]) & _M
    x1 = (x1 + ks[1]) & _M
    for i in range(5):
        for r in _ROT[i % 2]:
            x0 = (x0 + x1) & _M
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _M
    return x0, x1


def PRNGKey(seed: int) -> tuple[int, int]:  # noqa: N802  (jax's name)
    """``jax.random.PRNGKey`` with 64-bit types off: the seed's low 32
    bits, high word 0."""
    return (0, int(seed) & _M)


def split(key: tuple[int, int], num: int = 2) -> list[tuple[int, int]]:
    """``jax.random.split`` (partitionable): key ``i`` is the threefry of
    counter ``i``."""
    return [_threefry2x32(key[0], key[1], i >> 32, i & _M)
            for i in range(num)]


def split_range(key: tuple[int, int], start: int,
                stop: int) -> list[tuple[int, int]]:
    """``split(key, n)[start:stop]`` for any n >= stop: in partitionable
    mode a key of ``split`` depends on its index alone, so a block of them
    is drawn without the others."""
    return [_threefry2x32(key[0], key[1], i >> 32, i & _M)
            for i in range(start, stop)]


def fold_in(key: tuple[int, int], data: int) -> tuple[int, int]:
    """``jax.random.fold_in``: the threefry of the 32-bit ``data`` (high
    count word 0) under ``key``."""
    return _threefry2x32(key[0], key[1], 0, int(data) & _M)


def key_rows(seeds) -> np.ndarray:
    """``jax.vmap(jax.random.PRNGKey)(seeds)`` as [N, 2] uint32."""
    out = np.zeros((len(seeds), 2), np.uint32)
    out[:, 1] = np.asarray([int(s) & _M for s in seeds], np.uint32)
    return out


def split_rows(keys: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """``jax.vmap(jax.random.split)(keys)`` for [N, 2] uint32 keys ->
    (keys[:, 0], keys[:, 1]), each [N, 2] uint32: every row's key split in
    two at once."""
    k = np.asarray(keys).astype(np.int64)
    count = np.broadcast_to(np.asarray([0, 1], np.int64), (len(k), 2))
    x0, x1 = _threefry2x32(k[:, 0:1], k[:, 1:2], np.zeros_like(count), count)
    both = np.stack([x0, x1], axis=-1).astype(np.uint32)   # [N, which, word]
    return both[:, 0], both[:, 1]


def split_rows_n(keys: np.ndarray, num: int) -> np.ndarray:
    """``jax.vmap(lambda k: jax.random.split(k, num))(keys)`` for [N, 2]
    uint32 keys -> [N, num, 2] uint32."""
    k = np.asarray(keys).astype(np.int64)
    count = np.broadcast_to(np.arange(num, dtype=np.int64), (len(k), num))
    x0, x1 = _threefry2x32(k[:, 0:1], k[:, 1:2], np.zeros_like(count), count)
    return np.stack([x0, x1], axis=-1).astype(np.uint32)


def split_rows_chain(keys: np.ndarray, steps: int):
    """``steps`` successive :func:`split_rows`: -> (the running keys after
    the last step [N, 2], the sampling keys of every step [steps, N, 2])."""
    subs = np.empty((steps, len(keys), 2), np.uint32)
    for i in range(steps):
        keys, subs[i] = split_rows(keys)
    return keys, subs


def bits(key, shape, device=None) -> torch.Tensor:
    """``jax.random.bits(key, shape, uint32)`` as an int64 tensor of uint32
    values. ``key`` may also be S keys, as a list of pairs or an [S, 2]
    array (or an [S, 2] int64 tensor, :func:`bits_keys`): the result is
    then ``[S, *shape]``, row s drawn with key s."""
    if isinstance(key, torch.Tensor):
        return bits_keys(key, shape)
    if isinstance(key, (list, np.ndarray)):
        kt = torch.as_tensor(np.asarray(key).astype(np.int64)).to(device)
        return bits_keys(kt, shape)
    shape = tuple(shape)
    count = torch.arange(math.prod(shape), dtype=torch.int64, device=device)
    x0, x1 = _threefry2x32(key[0], key[1], count >> 32, count & _M)
    return (x0 ^ x1).reshape(shape)


def bits_keys(keys: torch.Tensor, shape) -> torch.Tensor:
    """:func:`bits` of S keys that are already an [S, 2] int64 tensor of
    uint32 words, on their device -> [S, *shape]. It reads no host value
    and copies nothing to the device, so a CUDA graph can hold it: the
    decode loops draw a block's noise inside its graph from a static key
    buffer (``decode/graphs.py``)."""
    shape = tuple(shape)
    count = torch.arange(math.prod(shape), dtype=torch.int64,
                         device=keys.device)
    x0, x1 = _threefry2x32(keys[:, 0:1], keys[:, 1:2], count >> 32,
                           count & _M)
    return (x0 ^ x1).reshape(keys.shape[0], *shape)


def bits_rows(key, n_cols: int, rows: torch.Tensor) -> torch.Tensor:
    """Rows ``rows`` of ``bits(key, (N, n_cols))`` without drawing the
    others: in partitionable mode element (r, c) is counter
    ``r * n_cols + c``, independent of every other element."""
    cols = torch.arange(n_cols, dtype=torch.int64, device=rows.device)
    count = rows.to(torch.int64)[:, None] * n_cols + cols[None, :]
    x0, x1 = _threefry2x32(key[0], key[1], count >> 32, count & _M)
    return x0 ^ x1


def _bits_to_unit_f32(b: torch.Tensor) -> torch.Tensor:
    """uint32 bits -> float32 in [0, 1): a random mantissa under exponent
    0, minus one (jax ``_uniform``)."""
    fb = (b >> 9) | 0x3F800000
    return fb.to(torch.int32).view(torch.float32) - 1.0


def uniform_from_bits(b: torch.Tensor, minval: float = 0.0,
                      maxval: float = 1.0) -> torch.Tensor:
    """[0, 1) floats scaled to [minval, maxval). XLA fuses the scale and
    shift into one multiply-add with a single rounding; the product of two
    f32 values and the sum are exact in f64 here (the unit floats are
    multiples of 2^-23), so f64 then one rounding to f32 gives its bits.
    The f32 bounds and their f32 difference are host scalars (numpy's
    float32 rounds as the card's does), so nothing is copied to the
    device."""
    lo = np.float32(minval)
    span = float(np.float32(maxval) - lo)
    scaled = (_bits_to_unit_f32(b).double() * span + float(lo)).float()
    return torch.clamp(scaled, min=float(lo))


def uniform(key, shape, minval: float = 0.0, maxval: float = 1.0,
            device=None) -> torch.Tensor:
    """``jax.random.uniform(key, shape, float32, minval, maxval)``."""
    return uniform_from_bits(bits(key, shape, device), minval, maxval)


def gumbel(key, shape, device=None) -> torch.Tensor:
    """``jax.random.gumbel`` in its default "low" mode, float32.
    ``key`` may be a list of keys or an [S, 2] int64 tensor of them (see
    :func:`bits`)."""
    u = uniform_from_bits(bits(key, shape, device), F32_TINY, 1.0)
    return -torch.log(-torch.log(u))


def categorical(key, logits: torch.Tensor) -> torch.Tensor:
    """``jax.random.categorical(key, logits, axis=-1)`` for float32
    logits: the Gumbel-max trick, first index on ties."""
    g = gumbel(key, logits.shape, logits.device)
    return torch.argmax(g + logits, dim=-1)
