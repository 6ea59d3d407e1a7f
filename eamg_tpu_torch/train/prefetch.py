"""Host -> device input pipeline: background prefetch.

Port of ``eamg_tpu/train/prefetch.py``: a daemon thread keeps a bounded
queue of batches staged on the device ahead of the training loop, so the
host's batch preparation overlaps the device's step. Staging a numpy
array is a pinned host copy and a ``non_blocking`` copy to the card; an
exception in the worker is raised in the consumer.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterable, Iterator

import numpy as np
import torch

from ..utils.device import bind_thread_to


def to_device(a, device: torch.device) -> torch.Tensor:
    """A host array (numpy or a CPU tensor) -> a tensor on ``device``:
    pinned and copied without waiting when it is a card; a tensor already
    there passes through."""
    t = a if isinstance(a, torch.Tensor) else torch.from_numpy(
        np.ascontiguousarray(a))
    if t.device == device:
        return t
    if device.type == "cuda" and t.device.type == "cpu":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def stage(batch, device: torch.device) -> tuple:
    """A batch (a tuple of arrays, None entries kept) -> the same tuple of
    tensors on ``device``."""
    return tuple(None if a is None else to_device(a, device) for a in batch)


class PrefetchIterator:
    """Wrap a host batch iterator; stage up to ``depth`` batches on
    ``device`` ahead of consumption. Exceptions propagate to the
    consumer."""

    _DONE = object()

    def __init__(self, it: Iterable, depth: int = 2, device=None):
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._device = torch.device(device or "cpu")
        self._err = None
        self._thread = threading.Thread(target=self._work, args=(iter(it),),
                                        daemon=True)
        self._thread.start()

    def _work(self, it: Iterator):
        bind_thread_to(self._device)
        try:
            for batch in it:
                self._q.put(stage(batch, self._device))
        except Exception as exc:  # propagate to consumer
            self._err = exc
        finally:
            self._q.put(self._DONE)

    def __iter__(self):
        return self

    def __next__(self):
        item = self._q.get()
        if item is self._DONE:
            if self._err is not None:
                raise self._err
            raise StopIteration
        return item
