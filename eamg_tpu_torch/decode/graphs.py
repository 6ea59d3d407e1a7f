"""Decode blocks replayed from CUDA graphs: the port's ``lax.while_loop`` /
``lax.scan``.

The JAX package runs a request's decode as one compiled program: the solo
loop and the ragged decode as a ``lax.while_loop`` whose predicate runs on
the device (``eamg_tpu/decode/loop.py``, ``decode/ragged.py``), an engine
chunk as one ``lax.scan`` (``serve/continuous.py``). The port gets the
same from CUDA graphs. A decode state lives on the card at fixed
addresses (cache, token buffer, positions, flags, the sampling values of
the request, a buffer of step keys), and a step reads no host value, so
:class:`BlockGraph` can capture a block of steps once and replay it for
every block of every later request with the same key. The host then
issues one graph launch (and one copy of the block's keys) a block, where
it issued every kernel of every step; it looks at the state once a block.

A graph is keyed as JAX's ``jit`` is: by what fixes the shapes and the
code of a step (batch, ``max_len``, ``attn_impl``, ``top_k``, greedy, which
filters are on, the dtype), never by the values a request fills in
(:func:`state_for`). The streamed decode (``decode/stream.py``) keys a
solo state of its own, as JAX's ``_decode_chunk`` is a program of its own:
its graph is one chunk of steps over a cache of ``max_len + chunk`` slots,
and a stream holds its state while its consumer reads, so streams take
their states from a pool (:func:`pooled`). On the CPU the same block
function runs eagerly, so
the CPU tests run the code that the card captures. No environment variable
and no fallback turns the graphs off: ``eager=True`` (a keyword the
served paths never pass) runs a block eagerly on the card too, for a
comparison of the two.
"""

from __future__ import annotations

import contextlib
import threading
from collections import OrderedDict

import numpy as np
import torch

from ..ops import _build

# Decode steps a graph of the solo and the ragged decode replays. The host
# looks at the rows' flags once a block, and after the last row's EOS the
# rest of its block runs inert: 32 took the least time a solo request on
# an H100 (chip_sweep.py blocks; CHANGES.md). The engine's graph is
# one chunk, of the engine's own length.
BLOCK = 32
# decode states (each with its graphs) kept at once, the least recently
# used dropped first; the free states a pooled key keeps
MAX_STATES = 32
MAX_POOL = 4
_states: OrderedDict = OrderedDict()
_states_lock = threading.Lock()
# graphs captured and replays run in this process, with the capture modes
_tally = {"captures": 0, "replays": 0, "global_captures": 0}
_tally_lock = threading.Lock()


def tally() -> dict[str, int]:
    """Graphs captured (and how many of them in ``"global"`` mode) and
    replays run in this process."""
    with _tally_lock:
        return dict(_tally)


def _add(**counts) -> None:
    with _tally_lock:
        for k, n in counts.items():
            _tally[k] += n


class BlockGraph:
    """One block of decode steps over a static state, ``block_fn()``,
    which writes its results into that state in place.

    On the CPU, and with ``eager``, :meth:`run` calls it. On the card the
    first :meth:`run` is the warm-up: it runs the block eagerly on a side
    stream (this call's block: it advances the state), then captures one
    more call into a CUDA graph on that stream, which launches nothing;
    every later :meth:`run` replays the graph on the current stream.
    ``capture_error_mode`` is ``torch.cuda.graph``'s: ``"thread_local"``
    (the default) lets other threads issue work while this one captures,
    ``"global"`` makes any host sync anywhere fail the capture.

    Launch counts stay true: a wrapper called while the graph is captured
    launches nothing, so its count goes into :attr:`launches` (the block's
    launches by wrapper), which each replay adds to ``ops/_build``'s
    counts once."""

    def __init__(self, block_fn, device, eager: bool = False,
                 capture_error_mode: str = "thread_local"):
        self._fn = block_fn
        self.device = torch.device(device)
        self.eager = bool(eager) or self.device.type != "cuda"
        self.capture_error_mode = capture_error_mode
        self.graph = None
        self.launches: dict[str, int] = {}
        self.replays = 0

    def run(self) -> None:
        if self.eager:
            self._fn()
        elif self.graph is None:
            self._warm_up_and_capture()
        else:
            self.graph.replay()
            self.replays += 1
            _build.add_launches(self.launches)
            _add(replays=1)

    def _warm_up_and_capture(self) -> None:
        cur = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(cur)
        with torch.cuda.stream(side):
            self._fn()
        cur.wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with _build.recording_launches() as launches:
            with torch.cuda.graph(graph, stream=side,
                                  capture_error_mode=self.capture_error_mode):
                self._fn()
        self.graph, self.launches = graph, dict(launches)
        _add(captures=1,
             global_captures=int(self.capture_error_mode == "global"))


def on_group(*groups) -> bool:
    """Whether one of ``groups`` (``parallel.collectives.TensorParallel``
    or None) has more than one rank. A decode on it issues its steps from
    the host, since no collective goes inside a captured graph; a group of
    one takes no collective and keeps its graphs."""
    return any(tp is not None and tp.size > 1 for tp in groups)


def state_for(key: tuple, make):
    """The decode state cached under ``key`` (made by ``make()`` the first
    time), moved to the most recently used end; at most
    :data:`MAX_STATES` are kept. A state holds the objects its graphs
    read (the parameters among them), so a key never outlives them."""
    with _states_lock:
        st = _states.get(key)
        if st is None:
            st = _states[key] = make()
            while len(_states) > MAX_STATES:
                _states.popitem(last=False)
        _states.move_to_end(key)
        return st


@contextlib.contextmanager
def pooled(key: tuple, make):
    """A decode state of ``key`` for the caller alone while the block
    runs: a free one of the key's, or a new one (``make()``, whose graph is
    captured at its first run) when every one is held. A streamed decode
    holds its state while its consumer reads the tokens, so two streams of
    one key never wait for each other, however slowly either is read. At
    most :data:`MAX_POOL` free states are kept a key, and the keys count
    towards :data:`MAX_STATES` as :func:`state_for`'s do."""
    with _states_lock:
        free = _pool(key)
        st = free.pop() if free else None
    if st is None:
        st = make()
    try:
        yield st
    finally:
        with _states_lock:
            free = _pool(key)
            if len(free) < MAX_POOL:
                free.append(st)


def _pool(key: tuple) -> list:
    """The free states of a pooled key, most recently used; under
    ``_states_lock``."""
    free = _states.get(("pool", key))
    if free is None:
        free = _states[("pool", key)] = []
        while len(_states) > MAX_STATES:
            _states.popitem(last=False)
    _states.move_to_end(("pool", key))
    return free


def side_stream(device):
    """A CUDA stream of a decode state's own on the card, None on the
    CPU: the work of one issuer (a request's decode, the engine's worker)
    goes there, so a host wait of one waits for nothing of another."""
    device = torch.device(device)
    return torch.cuda.Stream(device) if device.type == "cuda" else None


@contextlib.contextmanager
def on_stream(stream):
    """``torch.cuda.stream(stream)``, ordered after the current stream's
    work (the inputs made there), and the current stream ordered after it
    on the way out (the results it made); nothing on the CPU."""
    if stream is None:
        yield
        return
    cur = torch.cuda.current_stream(stream.device)
    stream.wait_stream(cur)
    with torch.cuda.stream(stream):
        yield
    cur.wait_stream(stream)


def load_keys(dst: torch.Tensor, keys: np.ndarray) -> None:
    """Copy a block's step keys (uint32, ``dst``'s shape, fewer leading
    rows allowed: the rest keep their old values, steps after the end) into
    the static key buffer ``dst`` (int64), on the card from pinned memory
    without blocking, before the block's replay and outside its graph."""
    src = torch.from_numpy(np.ascontiguousarray(keys, dtype=np.int64))
    if dst.device.type == "cuda":
        src = src.pin_memory()
    dst[:src.shape[0]].copy_(src, non_blocking=True)
