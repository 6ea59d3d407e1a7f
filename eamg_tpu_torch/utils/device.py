"""Device selection shared by every entry point of the port."""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means the card: raise when there is none, rather than carry
    on quietly on the CPU. Pass ``device="cpu"`` to run the plain
    PyTorch versions of the kernels on the host."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "eamg_tpu_torch runs on a CUDA device by default and none is "
                "available; pass device='cpu' to run on the host")
        return torch.device("cuda")
    return torch.device(device)


def bind_thread_to(device: torch.device) -> None:
    """Make ``device`` the calling thread's current CUDA device (a new
    thread starts on device 0, whatever its creator had set). A device
    without an index means the current one, and needs nothing."""
    if device.type == "cuda" and device.index is not None:
        torch.cuda.set_device(device.index)
