"""Multi-process helpers: one process a rank, on ``torch.distributed``.

Port of ``eamg_tpu/parallel/multihost.py``. JAX runs one process a host
over its devices; the port runs one process a rank (one card, or one CPU
rank), the PyTorch idiom:

- :func:`init_distributed` joins the process group (a no-op when it is
  already joined, or when no address is given and none is in the
  environment). The address, the world size and the rank come from the
  arguments, else from torchrun's ``MASTER_ADDR``/``MASTER_PORT``/
  ``WORLD_SIZE``/``RANK``, else from JAX's ``JAX_COORDINATOR_ADDRESS``/
  ``JAX_NUM_PROCESSES``/``JAX_PROCESS_ID``. The backend is NCCL on a CUDA
  device and gloo on the CPU;
- :func:`is_main_process` gates logging and saving on rank 0;
- :func:`broadcast_bytes` sends a byte blob from rank 0 to every rank
  (the reference broadcast its vocabulary this way; the port's
  vocabularies are deterministic and need no broadcast).
"""

from __future__ import annotations

import datetime
import os

import numpy as np
import torch
import torch.distributed as dist

# every group of the port waits at most this long in a collective, so a
# rank that raised fails its peers instead of hanging them
TIMEOUT = datetime.timedelta(seconds=int(os.environ.get(
    "EAMG_DIST_TIMEOUT", "600")))


def _env_address() -> str | None:
    if os.environ.get("MASTER_ADDR") and os.environ.get("MASTER_PORT"):
        return f"{os.environ['MASTER_ADDR']}:{os.environ['MASTER_PORT']}"
    return os.environ.get("JAX_COORDINATOR_ADDRESS")


def _env_int(*names) -> int:
    for name in names:
        if os.environ.get(name) is not None:
            return int(os.environ[name])
    raise ValueError(f"none of {names} is set")


def backend_for(device) -> str:
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def init_distributed(coordinator_address: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None,
                     device=None, init_method: str | None = None) -> None:
    """Join the process group (no-op if joined, or single-process: no
    address given and none in the environment). ``coordinator_address``
    is ``host:port`` of rank 0; ``init_method`` (e.g. ``file://...``)
    takes its place. ``device`` picks the backend (None: NCCL when CUDA is
    available)."""
    if dist.is_initialized():
        return
    if init_method is None:
        address = coordinator_address or _env_address()
        if address is None:
            return
        init_method = address if "://" in address else f"tcp://{address}"
    world = num_processes if num_processes is not None else _env_int(
        "WORLD_SIZE", "JAX_NUM_PROCESSES")
    rank = process_id if process_id is not None else _env_int(
        "RANK", "JAX_PROCESS_ID")
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev.index if dev.index is not None
                              else rank % torch.cuda.device_count())
    dist.init_process_group(backend_for(dev), init_method=init_method,
                            world_size=world, rank=rank, timeout=TIMEOUT)


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def is_main_process() -> bool:
    return rank() == 0


def _buffer_device() -> torch.device:
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def broadcast_bytes(data: bytes | None, max_len: int = 1 << 20) -> bytes:
    """Rank 0's ``data`` on every rank, through one broadcast of a
    [max_len + 8] byte buffer (an 8-byte length, then the bytes)."""
    if world_size() == 1:
        return data or b""
    buf = np.zeros(max_len + 8, np.uint8)
    if is_main_process():
        assert data is not None and len(data) <= max_len
        buf[:8] = np.frombuffer(np.uint64(len(data)).tobytes(), np.uint8)
        buf[8:8 + len(data)] = np.frombuffer(data, np.uint8)
    t = torch.from_numpy(buf).to(_buffer_device())
    dist.broadcast(t, src=0)
    out = t.cpu().numpy()
    n = int(np.frombuffer(out[:8].tobytes(), np.uint64)[0])
    return out[8:8 + n].tobytes()
