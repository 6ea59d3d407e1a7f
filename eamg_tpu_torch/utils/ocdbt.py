"""tensorstore's OCDBT key-value store and zarr v2 arrays in it, read and
written without tensorstore: the storage of an Orbax ``PyTreeCheckpointer``
directory (``use_ocdbt: true``, ``use_zarr3: false``).

A store is a directory with ``manifest.ocdbt`` and data files under
``d/`` (Orbax's own writes keep the nodes and values of each process under
``ocdbt.process_<i>/`` and merge them into the root manifest, whose paths
reach there). Every manifest and B-tree node file is a header (a magic
number big-endian, its length, a version and a compression varint), a body
(a zstd frame, ``utils/zstd.py``) and a CRC32C of all that precedes it.
Varints are LEB128; arrays of fields are stored column by column:

- manifest body: the config (a 16-byte uuid, manifest kind, max inline
  value bytes, max decoded node bytes, version tree arity log2 as a byte,
  compression method and, for zstd, an int32 level), a data file table,
  then the versions held inline: count, generation numbers, root heights
  (bytes), the roots' file ids, offsets and lengths, key counts, tree
  bytes, indirect value bytes, commit times (uint64); older versions sit
  in version tree nodes, which the latest version never needs;
- data file table: count, the prefix each path shares with the one before
  (count - 1), suffix lengths, base path lengths, the suffixes;
- B-tree node body: height (a byte), a data file table, the entry count,
  the keys (prefix lengths, suffix lengths, and in an interior node the
  length of the prefix its subtree's keys leave out, then the suffixes);
  a leaf then has value lengths, value kinds (0 inline, 1 in a data file),
  the file ids and offsets of the indirect values, the inline values; an
  interior node its children's file ids, offsets, lengths, key counts,
  tree bytes and indirect value bytes.

An array ``name`` is a zarr v2 array under the keys ``name/.zarray``
(JSON: shape, chunks, dtype, compressor zstd, C order) and
``name/<i>.<j>...`` (``0`` for a 0-d array), each chunk a zstd frame of
the chunk's C-order bytes, edge chunks padded to the chunk shape.
:func:`write_store` writes one version with one leaf node: values up to
1024 bytes inline, the rest in one data file; its nodes and chunks are
zstd frames of raw blocks.
"""

from __future__ import annotations

import json
import math
import os
import struct
import time
import uuid

import numpy as np

from . import zstd

MANIFEST_MAGIC = 0x0CDB3A2A
NODE_MAGIC = 0x0CDB20DE
MAX_INLINE = 1024
MAX_NODE_BYTES = 100_000_000

# zarr v2 dtype strings -> numpy; bfloat16 arrays travel as their bits
DTYPES = {"<f4": np.float32, "<f8": np.float64, "<f2": np.float16,
          "<i8": np.int64, "<i4": np.int32, "<i2": np.int16, "|i1": np.int8,
          "<u8": np.uint64, "<u4": np.uint32, "<u2": np.uint16,
          "|u1": np.uint8, "|b1": np.bool_, "bfloat16": np.uint16}


class OcdbtError(ValueError):
    """A file that is not the OCDBT this module reads."""


def _crc_table() -> list:
    table = []
    for i in range(256):
        c = i
        for _ in range(8):
            c = (c >> 1) ^ 0x82F63B78 if c & 1 else c >> 1
        table.append(c)
    return table


_CRC = _crc_table()


def crc32c(data: bytes) -> int:
    c = 0xFFFFFFFF
    for b in data:
        c = _CRC[(c ^ b) & 0xFF] ^ (c >> 8)
    return c ^ 0xFFFFFFFF


# ---------------------------------------------------------------- reading

class _Body:
    """A cursor over a decoded body."""

    def __init__(self, data: bytes):
        self.data, self.pos = data, 0

    def varint(self) -> int:
        out = shift = 0
        while True:
            b = self.data[self.pos]
            self.pos += 1
            out |= (b & 0x7F) << shift
            shift += 7
            if b < 0x80:
                return out

    def varints(self, n: int) -> list:
        return [self.varint() for _ in range(n)]

    def take(self, n: int) -> bytes:
        out = self.data[self.pos:self.pos + n]
        if len(out) != n:
            raise OcdbtError("body ends early")
        self.pos += n
        return out

    def u8s(self, n: int) -> list:
        return list(self.take(n))


def _decode(blob: bytes, magic: int, what: str) -> bytes:
    """A manifest or node file's bytes -> its body, checked."""
    if len(blob) < 18 or struct.unpack(">I", blob[:4])[0] != magic:
        raise OcdbtError(f"{what}: not an OCDBT {what}")
    if struct.unpack("<Q", blob[4:12])[0] != len(blob):
        raise OcdbtError(f"{what}: length field disagrees with the file")
    if struct.unpack("<I", blob[-4:])[0] != crc32c(blob[:-4]):
        raise OcdbtError(f"{what}: CRC32C mismatch")
    head = _Body(blob[12:-4])
    version, method = head.varint(), head.varint()
    if version != 0 or method not in (0, 1):
        raise OcdbtError(f"{what}: version {version}, compression {method}")
    body = blob[12 + head.pos:-4]
    return zstd.decompress(body) if method == 1 else body


def _file_table(b: _Body) -> list:
    n = b.varint()
    prefix = b.varints(max(n - 1, 0))
    suffix = b.varints(n)
    b.varints(n)                              # base path lengths
    out, prev = [], b""
    for i in range(n):
        path = prev[:prefix[i - 1] if i else 0] + b.take(suffix[i])
        out.append(path.decode())
        prev = path
    return out


def _keys(b: _Body, n: int, interior: bool) -> tuple:
    prefix = b.varints(max(n - 1, 0))
    suffix = b.varints(n)
    elided = b.varints(n) if interior else [0] * n
    keys, prev = [], b""
    for i in range(n):
        key = prev[:prefix[i - 1] if i else 0] + b.take(suffix[i])
        keys.append(key)
        prev = key
    return keys, elided


class Store:
    """The latest version of the OCDBT store at ``path``: :attr:`entries`
    maps each key (str) to its value, bytes held inline or a (data file,
    offset, length) reference; :meth:`read` returns the bytes."""

    def __init__(self, path: str):
        self.path = path
        with open(os.path.join(path, "manifest.ocdbt"), "rb") as f:
            b = _Body(_decode(f.read(), MANIFEST_MAGIC, "manifest"))
        b.take(16)                                 # uuid
        kind = b.varint()
        if kind != 0:
            raise OcdbtError("numbered manifests are not read")
        b.varint(), b.varint(), b.u8s(1)           # limits, arity log2
        if b.varint() == 1:
            b.take(4)                              # zstd level
        files = _file_table(b)
        n = b.varint()
        gens, heights = b.varints(n), b.u8s(n)
        ids, offs, lens = b.varints(n), b.varints(n), b.varints(n)
        self.entries: dict = {}
        if n == 0:
            return
        last = max(range(n), key=lambda i: gens[i])
        self._walk(files[ids[last]], offs[last], lens[last], heights[last],
                   b"")

    def _walk(self, file: str, offset: int, length: int, height: int,
              prefix: bytes) -> None:
        with open(os.path.join(self.path, file), "rb") as f:
            f.seek(offset)
            b = _Body(_decode(f.read(length), NODE_MAGIC, "node"))
        if b.u8s(1)[0] != height:
            raise OcdbtError("a node's height disagrees with its parent")
        files = _file_table(b)
        n = b.varint()
        keys, elided = _keys(b, n, height > 0)
        if height > 0:
            ids, offs, lens = b.varints(n), b.varints(n), b.varints(n)
            for i in range(n):
                self._walk(files[ids[i]], offs[i], lens[i], height - 1,
                           prefix + keys[i][:elided[i]])
            return
        sizes, kinds = b.varints(n), b.varints(n)
        n_ref = sum(kinds)
        ref_ids, ref_offs = b.varints(n_ref), b.varints(n_ref)
        r = 0
        for key, size, kind in zip(keys, sizes, kinds):
            name = (prefix + key).decode()
            if kind:
                self.entries[name] = (files[ref_ids[r]], ref_offs[r], size)
                r += 1
            else:
                self.entries[name] = b.take(size)

    def read(self, key: str) -> bytes:
        value = self.entries[key]
        if isinstance(value, bytes):
            return value
        file, offset, length = value
        with open(os.path.join(self.path, file), "rb") as f:
            f.seek(offset)
            out = f.read(length)
        if len(out) != length:
            raise OcdbtError(f"{key}: data file {file} ends early")
        return out


def read_array(store: Store, name: str) -> tuple:
    """The zarr v2 array ``name`` -> (numpy array, its zarr dtype string);
    a bfloat16 array comes back as its uint16 bits. Chunks the store does
    not hold read as zeros."""
    meta = json.loads(store.read(f"{name}/.zarray"))
    if meta.get("zarr_format") != 2 or meta.get("order", "C") != "C" \
            or meta.get("filters"):
        raise OcdbtError(f"{name}: zarr v2 in C order without filters only")
    comp = meta.get("compressor")
    if comp is not None and comp.get("id") != "zstd":
        raise OcdbtError(f"{name}: compressor {comp.get('id')}")
    dt = np.dtype(DTYPES[meta["dtype"]])
    shape, chunks = tuple(meta["shape"]), tuple(meta["chunks"])
    sep = meta.get("dimension_separator", ".")
    out = np.zeros(shape, dt)
    grid = [math.ceil(s / c) if c else 1 for s, c in zip(shape, chunks)]
    for idx in np.ndindex(*grid):
        key = f"{name}/" + (sep.join(str(i) for i in idx) if idx else "0")
        if key not in store.entries:
            continue
        raw = store.read(key)
        if comp is not None:
            raw = zstd.decompress(raw, math.prod(chunks) * dt.itemsize)
        block = np.frombuffer(raw, dt).reshape(chunks)
        sl = tuple(slice(i * c, min((i + 1) * c, s))
                   for i, c, s in zip(idx, chunks, shape))
        out[sl] = block[tuple(slice(0, s.stop - s.start) for s in sl)]
    return out, meta["dtype"]


# ---------------------------------------------------------------- writing

def _varint(v: int) -> bytes:
    out = bytearray()
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _varints(values) -> bytes:
    return b"".join(_varint(v) for v in values)


def _encode(body: bytes, magic: int) -> bytes:
    """A body -> a manifest or node file: header, the body as a zstd frame
    of raw blocks, CRC32C."""
    frame = zstd.compress_raw(body)
    head_len = 4 + 8 + 2
    total = head_len + len(frame) + 4
    blob = struct.pack(">I", magic) + struct.pack("<Q", total) + \
        b"\x00\x01" + frame
    return blob + struct.pack("<I", crc32c(blob))


def _prefix_coded(names: list) -> tuple:
    """Sorted byte strings -> (the count and each one's prefix shared with
    the one before, the suffix lengths, the suffixes), as keys and data
    file paths are stored."""
    shared = [len(os.path.commonprefix([names[i - 1], names[i]]))
              for i in range(1, len(names))]
    cut = [0] + shared
    return (_varint(len(names)) + _varints(shared),
            _varints(len(n) - c for n, c in zip(names, cut)),
            b"".join(n[c:] for n, c in zip(names, cut)))


def _table(paths: list) -> bytes:
    """A data file table of paths relative to the store, no base path."""
    head, sizes, suffixes = _prefix_coded([p.encode() for p in paths])
    return head + sizes + _varints([0] * len(paths)) + suffixes


def write_store(path: str, values: dict) -> None:
    """A new OCDBT store at ``path`` holding ``values`` (str key -> bytes):
    one version, one leaf node."""
    os.makedirs(os.path.join(path, "d"), exist_ok=True)
    keys = sorted(values, key=lambda k: k.encode())
    data_name = f"d/{uuid.uuid4().hex}"
    node_name = f"d/{uuid.uuid4().hex}"
    refs, blob_off = {}, 0
    with open(os.path.join(path, data_name), "wb") as f:
        for k in keys:
            if len(values[k]) > MAX_INLINE:
                refs[k] = blob_off
                f.write(values[k])
                blob_off += len(values[k])
    files = [data_name] if refs else []
    node = bytearray(b"\x00")                       # height 0
    node += _table(files)
    node += b"".join(_prefix_coded([k.encode() for k in keys]))
    node += _varints(len(values[k]) for k in keys)
    node += _varints(int(k in refs) for k in keys)
    node += _varints(0 for k in keys if k in refs)
    node += _varints(refs[k] for k in keys if k in refs)
    node += b"".join(values[k] for k in keys if k not in refs)
    node_file = _encode(bytes(node), NODE_MAGIC)
    with open(os.path.join(path, node_name), "wb") as f:
        f.write(node_file)
    if not refs:
        os.remove(os.path.join(path, data_name))
    manifest = bytearray(os.urandom(16))
    manifest += _varint(0) + _varint(MAX_INLINE) + _varint(MAX_NODE_BYTES)
    manifest += bytes([4]) + _varint(1) + struct.pack("<i", 0)
    manifest += _table([node_name])
    manifest += _varint(1) + _varint(1) + bytes([0])   # generation 1, leaf
    manifest += _varints([0, 0, len(node_file), len(keys), len(node_file),
                          blob_off])
    manifest += struct.pack("<Q", time.time_ns()) + _varint(0)
    tmp = os.path.join(path, "manifest.ocdbt.tmp")
    with open(tmp, "wb") as f:
        f.write(_encode(bytes(manifest), MANIFEST_MAGIC))
    os.replace(tmp, os.path.join(path, "manifest.ocdbt"))


def array_values(name: str, arr: np.ndarray, dtype: str) -> dict:
    """The keys of the zarr v2 array ``name`` holding ``arr`` (one chunk,
    the whole array; ``dtype`` its zarr string, "bfloat16" for bits in a
    uint16 array)."""
    arr = np.asarray(arr, order="C")         # 0-d stays 0-d
    meta = {"chunks": list(arr.shape),
            "compressor": {"id": "zstd", "level": 1},
            "dimension_separator": ".", "dtype": dtype, "fill_value": None,
            "filters": None, "order": "C", "shape": list(arr.shape),
            "zarr_format": 2}
    chunk = ".".join("0" for _ in arr.shape) or "0"
    data = arr.astype(arr.dtype.newbyteorder("<"), copy=False).tobytes()
    return {f"{name}/.zarray": json.dumps(
        meta, separators=(",", ":")).encode(),
            f"{name}/{chunk}": zstd.compress_raw(data)}
