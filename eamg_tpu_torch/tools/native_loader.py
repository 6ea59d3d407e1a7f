"""ctypes bindings of the C++ corpus loader (``native/eamg_native.cpp``).

Port of ``eamg_tpu/tools/native_loader.py`` (a host data path):
``explode_csv_native`` streams a corpus CSV into Scheme-B2/B3 id rows,
PAD-padded, bit-identical to the Python tokenizer; ``explode_csv`` falls
back to the Python tokenizer on a host without g++. The library is built
on first use (``utils/native.py``).
"""

from __future__ import annotations

import ctypes
import threading

import numpy as np

from ..utils.native import NativeUnavailable, load_library

_lib = None
_lib_lock = threading.Lock()


def load_native():
    """The native library (built if needed); raises NativeUnavailable when
    the host has no toolchain."""
    global _lib
    with _lib_lock:
        if _lib is not None:
            return _lib
        lib = load_library("eamg_native")
        lib.eamg_explode_csv.restype = ctypes.c_int
        lib.eamg_explode_csv.argtypes = [
            ctypes.c_char_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int,
            ctypes.POINTER(ctypes.POINTER(ctypes.c_int32)),
            ctypes.POINTER(ctypes.POINTER(ctypes.c_int32)),
        ]
        lib.eamg_free.argtypes = [ctypes.c_void_p]
        _lib = lib
        return _lib


def native_available() -> bool:
    try:
        load_native()
        return True
    except NativeUnavailable:
        return False


def explode_csv_native(path: str, scheme: str = "b2",
                       max_rows: int | None = None, seq_len: int = 512,
                       res_ms: int = 50, max_tick: int = 4095,
                       strict_parity: bool = True, min_bpm: int = 20,
                       max_bpm: int = 250
                       ) -> tuple[np.ndarray, np.ndarray]:
    """-> (ids [rows, seq_len] int32 PAD-padded, lengths [rows] int32)."""
    lib = load_native()
    data_p = ctypes.POINTER(ctypes.c_int32)()
    lens_p = ctypes.POINTER(ctypes.c_int32)()
    rows = lib.eamg_explode_csv(
        path.encode(), -1 if max_rows is None else max_rows, seq_len,
        res_ms, max_tick, {"b2": 2, "b3": 3}[scheme],
        1 if strict_parity else 0, min_bpm, max_bpm,
        ctypes.byref(data_p), ctypes.byref(lens_p))
    if rows < 0:
        raise RuntimeError(f"native explode failed for {path}")
    try:
        ids = np.ctypeslib.as_array(data_p, (rows, seq_len)).copy() \
            if rows else np.zeros((0, seq_len), np.int32)
        lens = np.ctypeslib.as_array(lens_p, (rows,)).copy() \
            if rows else np.zeros((0,), np.int32)
    finally:
        lib.eamg_free(data_p)
        lib.eamg_free(lens_p)
    return ids, lens


def explode_csv_python(path: str, scheme: str = "b2", **kw):
    """The Python tokenizer's rows, in the native loader's form."""
    from ..tokenizer import SchemeB2, SchemeB3
    from ..train.data import iter_csv_tokens

    seq_len = kw.get("seq_len", 512)
    cls = SchemeB3 if scheme == "b3" else SchemeB2
    sch = cls(seq_len=seq_len, strict_parity=kw.get("strict_parity", True))
    rows, lens = [], []
    for js in iter_csv_tokens(path, max_rows=kw.get("max_rows")):
        ids = sch.explode(js)
        lens.append(len(ids))
        rows.append(ids + [sch.vocab.pad_id] * (seq_len - len(ids)))
    return np.asarray(rows, np.int32), np.asarray(lens, np.int32)


def explode_csv(path: str, scheme: str = "b2", **kw):
    """Native loader with transparent Python fallback."""
    try:
        return explode_csv_native(path, scheme=scheme, **kw)
    except NativeUnavailable:
        return explode_csv_python(path, scheme=scheme, **kw)
