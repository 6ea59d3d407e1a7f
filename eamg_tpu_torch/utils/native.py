"""Build and load C++ host libraries with g++: the repository's
(``native/``, as the JAX package's ctypes bindings do, into
``native/build/``) and the port's own (``eamg_tpu_torch/csrc/*.cpp``,
into the build directory their caller names).

The port's builds carry names of their own (``lib<name>_torch.so``) and
land by an atomic rename, so a build never overwrites a library another
process has loaded or is building (the JAX package builds
``native/build/lib<name>.so`` from the same sources)."""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading

NATIVE_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "native")

_lock = threading.Lock()


class NativeUnavailable(RuntimeError):
    """No C++ toolchain, or the source is missing."""


def load_library(name: str, src: str | None = None,
                 build_dir: str | None = None) -> ctypes.CDLL:
    """``src`` (by default ``native/<name>.cpp``) -> the loaded library
    ``<build_dir>/lib<name>_torch.so`` (by default in ``native/build/``),
    built when missing or older than its source."""
    src = src or os.path.join(NATIVE_DIR, f"{name}.cpp")
    so = os.path.join(build_dir or os.path.join(NATIVE_DIR, "build"),
                      f"lib{name}_torch.so")
    with _lock:
        if not os.path.exists(src):
            raise NativeUnavailable(f"missing {src}")
        if not os.path.exists(so) or \
                os.path.getmtime(src) > os.path.getmtime(so):
            os.makedirs(os.path.dirname(so), exist_ok=True)
            tmp = f"{so}.{os.getpid()}.tmp"
            cmd = ["g++", "-O3", "-std=c++17", "-fPIC", "-Wall", "-shared",
                   "-o", tmp, src]
            try:
                subprocess.run(cmd, check=True, capture_output=True,
                               timeout=300)
            except (subprocess.CalledProcessError, FileNotFoundError,
                    subprocess.TimeoutExpired) as exc:
                detail = getattr(exc, "stderr", b"") or b""
                raise NativeUnavailable(
                    f"g++ build of {src} failed: {exc}: "
                    f"{detail.decode(errors='replace')}") from exc
            os.replace(tmp, so)
        return ctypes.CDLL(so)
