"""Zstandard frames (RFC 8878) without a zstd module: a decoder of what
tensorstore and numcodecs write, and a writer of frames of raw blocks.

Orbax stores every array chunk, and every OCDBT node and manifest, as a
zstd frame (``utils/ocdbt.py``). Neither the card host nor the port has a
zstd module, so the format is read here, by a decoder in C++
(``csrc/zstd_host.cpp``, built with g++ at first use into ``build/``
through ``utils/native.py``):

- frames with or without a content size, skippable frames skipped, the
  optional checksum skipped, dictionaries refused;
- raw, RLE and compressed blocks;
- literals raw, RLE, Huffman-coded (weights direct or FSE-coded, 1 or 4
  streams) and treeless (the block before's table);
- sequences with predefined, RLE, FSE-coded and repeated tables, repeat
  offsets, matches that reach into earlier blocks of the frame.

:func:`compress_raw` writes frames of raw blocks (the data uncompressed, a
content size in the header), which every zstd decoder reads: the port
writes Orbax trees whose ``.zarray`` says ``zstd`` without compressing.
"""

from __future__ import annotations

import ctypes
import functools
import os
import struct

from .native import load_library

MAGIC = 0xFD2FB528
BLOCK_MAX = 1 << 17

_SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "csrc", "zstd_host.cpp")
_BUILD = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "build", "eamg_tpu_torch_host")


class ZstdError(ValueError):
    """Bytes that are not a zstd frame this decoder reads."""


@functools.cache
def _lib() -> ctypes.CDLL:
    """The C++ decoder (``native.NativeUnavailable`` where g++ fails)."""
    lib = load_library("zstd_host", src=_SRC, build_dir=_BUILD)
    lib.eamg_zstd_decompress.argtypes = [
        ctypes.c_char_p, ctypes.c_size_t, ctypes.c_void_p, ctypes.c_size_t,
        ctypes.POINTER(ctypes.c_size_t)]
    lib.eamg_zstd_decompress.restype = ctypes.c_int
    return lib


def decompress(data: bytes, size_hint: int | None = None) -> bytes:
    """Every frame of ``data`` -> the bytes they hold. ``size_hint``: the
    bytes expected, the first buffer's size (it grows until the frames
    fit)."""
    lib = _lib()
    data = bytes(data)
    cap = size_hint if size_hint is not None else 4 * len(data) + 64
    while True:
        buf = ctypes.create_string_buffer(max(cap, 1))
        n = ctypes.c_size_t(0)
        err = lib.eamg_zstd_decompress(data, len(data), buf, cap,
                                       ctypes.byref(n))
        if err == 0:
            return buf.raw[:n.value]
        if err != 1:                                  # 1: buffer too small
            raise ZstdError(f"zstd frame refused by the decoder ({err})")
        cap = max(2 * cap, n.value)


# ---------------------------------------------------------------- writer

def compress_raw(data: bytes) -> bytes:
    """One frame of raw blocks holding ``data``: a single-segment header
    with an 8-byte content size, blocks of at most 128 KiB, no
    checksum."""
    data = bytes(data)
    out = [struct.pack("<IBQ", MAGIC, 0xE0, len(data))]
    pos = 0
    while True:
        n = min(BLOCK_MAX, len(data) - pos)
        last = pos + n == len(data)
        out.append((n << 3 | int(last)).to_bytes(3, "little"))
        out.append(data[pos:pos + n])
        pos += n
        if last:
            return b"".join(out)
