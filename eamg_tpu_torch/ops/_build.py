"""Build the CUDA sources in ``eamg_tpu_torch/csrc`` and bind them.

Each ``csrc/<name>.cu`` is compiled by its own ``nvcc`` process into
``build/eamg_tpu_torch/<digest>/lib<name>.so`` at the repository root
(listed in ``.gitignore``), where ``<digest>`` hashes the sources and the
flags, so an edited kernel is rebuilt and an unchanged one is reused. The
libraries have a plain C interface and are loaded with ``ctypes``; nothing
here includes PyTorch's headers, so a build takes seconds. Nothing is
built when a module is imported: the first launch, or :func:`build_all`,
builds. :data:`VARIANTS` builds a source once more under extra flags, into
a library of its own name.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "eamg_tpu_torch"
SOURCES = ("attention", "ffn", "decode_attention", "topk", "decode_fold",
           "stream_reduce")
# library name -> (source, extra nvcc flags): the cluster fold kernel and
# rows 8 and 11's, K2, the decode cluster kernel (K3, rows 5 and 6), K1, K4
# and the stream-reduce probe with their phase stamps, and the empty
# launches that time their floor, loaded by chip_smoke.py alone
VARIANTS = {"decode_fold_timed": ("decode_fold", ("-DEAMG_PHASE_TIMING",)),
            "ffn_timed": ("ffn", ("-DEAMG_PHASE_TIMING",)),
            "decode_attention_timed": ("decode_attention",
                                       ("-DEAMG_PHASE_TIMING",)),
            "attention_timed": ("attention", ("-DEAMG_PHASE_TIMING",)),
            "topk_timed": ("topk", ("-DEAMG_PHASE_TIMING",)),
            "stream_reduce_timed": ("stream_reduce",
                                    ("-DEAMG_PHASE_TIMING",))}
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-lineinfo")

# dtype codes, mirrored by csrc/common.cuh
DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}

# launches per kernel wrapper, by the wrapper's name; under a lock, so the
# counts stay exact when the engine's worker and the HTTP threads launch at
# the same time
_count_lock = threading.Lock()
_launch_counts: dict[str, int] = {}
# the part of the counts that graph replays launched
_replayed_counts: dict[str, int] = {}
# a thread that captures a CUDA graph records its wrappers' calls here
# instead: a captured call launches nothing until the graph is replayed
_recording = threading.local()


def count_launch(name: str) -> None:
    """One more launch of wrapper ``name``: called where a wrapper has
    launched its kernel (or, while the calling thread captures a graph,
    recorded the launch into it), and nowhere else."""
    rec = getattr(_recording, "counts", None)
    if rec is not None:
        rec[name] = rec.get(name, 0) + 1
        return
    with _count_lock:
        _launch_counts[name] = _launch_counts.get(name, 0) + 1


@contextlib.contextmanager
def recording_launches():
    """Within the block, the calling thread's wrapper calls go into the
    dict it yields and not into the launch counts: what a graph captured
    there launches at each replay (:func:`add_launches`)."""
    prev = getattr(_recording, "counts", None)
    _recording.counts = {}
    try:
        yield _recording.counts
    finally:
        _recording.counts = prev


def add_launches(counts: dict, times: int = 1) -> None:
    """``times`` more launches of each wrapper in ``counts``: a captured
    graph's launches, once for each replay."""
    with _count_lock:
        for name, n in counts.items():
            _launch_counts[name] = _launch_counts.get(name, 0) + n * times
            _replayed_counts[name] = _replayed_counts.get(name, 0) + n * times


def reset_launch_counts() -> None:
    with _count_lock:
        _launch_counts.clear()
        _replayed_counts.clear()


def launch_counts() -> dict[str, int]:
    """Launches by wrapper since the last reset, issued from Python and
    replayed from graphs together."""
    with _count_lock:
        return dict(_launch_counts)


def replayed_counts() -> dict[str, int]:
    """The part of :func:`launch_counts` that graph replays launched."""
    with _count_lock:
        return dict(_replayed_counts)


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    cand = os.path.join(home, "bin", "nvcc")
    found = cand if os.path.exists(cand) else shutil.which("nvcc")
    if not found:
        raise RuntimeError("nvcc not found: the kernels need the CUDA "
                           "toolkit (set CUDA_HOME)")
    return found


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    h.update(repr(sorted(VARIANTS.items())).encode())
    for p in sorted(CSRC.iterdir()):
        if p.suffix in (".cu", ".cuh"):
            h.update(p.name.encode())
            h.update(p.read_bytes())
    return h.hexdigest()[:16]


def lib_path(name: str) -> Path:
    return BUILD_ROOT / _digest() / f"lib{name}.so"


def build_all(names=(*SOURCES, *VARIANTS)) -> dict:
    """Compile every missing library, one ``nvcc`` per library, all started
    together. Returns {name: seconds} for what was built."""
    out_dir = BUILD_ROOT / _digest()
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    t0 = time.perf_counter()
    for name in names:
        target = out_dir / f"lib{name}.so"
        if target.exists():
            continue
        tmp = out_dir / f".lib{name}.{os.getpid()}.so"
        src, flags = VARIANTS.get(name, (name, ()))
        cmd = [_nvcc(), *NVCC_FLAGS, *flags, "-o", str(tmp),
               str(CSRC / f"{src}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, target)
    times, errors = {}, []
    for name, (proc, tmp, target) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            errors.append(f"nvcc failed for lib{name}:\n{log}")
            continue
        os.replace(tmp, target)
        times[name] = time.perf_counter() - t0
    if errors:
        raise RuntimeError("\n".join(errors))
    return times


def library(name: str) -> ctypes.CDLL:
    """The loaded library ``name`` (``csrc/<name>.cu``, or a build of
    :data:`VARIANTS`), built on first use."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    with _lock:
        if name not in _libs:
            path = lib_path(name)
            if not path.exists():
                build_all([name])
            _libs[name] = ctypes.CDLL(str(path))
        return _libs[name]


def bind(name: str, fn: str, argtypes: list) -> ctypes._CFuncPtr:
    f = getattr(library(name), fn)
    f.argtypes = argtypes
    f.restype = ctypes.c_int
    return f


INVALID_VALUE = 1   # cudaErrorInvalidValue


def check(err: int, what: str, smem: str | None = None) -> None:
    """Raise on a launch CUDA refused (the kernel never ran). ``smem``
    names the sizes that a block's shared memory grows with, for the
    launchers that return ``cudaErrorInvalidValue`` when a block would need
    more than the card allows (``EAMG_MAX_SMEM`` in csrc/common.cuh, the
    one place that computes it)."""
    if err == INVALID_VALUE and smem is not None:
        raise RuntimeError(f"{what}: the launcher refused {smem}: a block "
                           "would need more shared memory than the card "
                           "allows (227 KB); nothing was computed")
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} "
                           f"({torch.cuda.get_device_name()})")


def refuse_grad(what: str, *tensors) -> None:
    """Raise when autograd is recording and an input requires grad, on any
    device: a kernel launched through raw pointers into a fresh output
    leaves no ``grad_fn``, so every gradient upstream of it would be
    dropped without an error. Training runs its own differentiable
    forward (``models/gpt.py::forward_hidden_train``) and never reaches a
    wrapper."""
    if torch.is_grad_enabled() and any(
            isinstance(t, torch.Tensor) and t.requires_grad
            for t in tensors):
        raise RuntimeError(f"{what}: an input requires grad, and the kernel "
                           "has no backward; call it under torch.no_grad() "
                           "or train through forward_hidden_train")


def require_cuda(what: str, t: torch.Tensor) -> None:
    """Raise unless ``t`` lies on a CUDA device: a wrapper launches its
    kernel on CUDA tensors only (on CPU tensors it takes its plain
    version)."""
    if t.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {t.device}")


def stream_ptr(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


P = ctypes.c_void_p
I = ctypes.c_int
F = ctypes.c_float
