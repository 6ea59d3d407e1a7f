"""Synthetic songs in the Scheme-B2 vocabulary, from a seed.

The fixed 8,324-token vocabulary of the reference's
``train/train_large2.py``: ``[PAD]`` 0, ``[START_SEQ]`` 1, ``[END_SEQ]`` 2,
``[NOTE]`` 3, then ``P_0..127``, ``T_0..4095`` and ``DUR_0..4095`` (50 ms
ticks). A song is ``[START_SEQ]``, notes of four tokens each (``[NOTE]``,
a pitch, an onset tick, a duration tick) in onset order, and
``[END_SEQ]``. Pitches walk a scale around a centre, onsets advance by a
few ticks and durations are short, so the token mix is a song's and not
uniform noise.
"""

from __future__ import annotations

import numpy as np

PAD, START, END, NOTE = 0, 1, 2, 3
P0, T0, D0 = 4, 132, 4228
VOCAB = 8324
_SCALE = (0, 2, 4, 5, 7, 9, 11)


def song(rng: np.random.Generator, n_tokens: int) -> np.ndarray:
    """One song of about ``n_tokens`` tokens (a whole number of notes)."""
    n_notes = max(1, (n_tokens - 2) // 4)
    centre = int(rng.integers(48, 72))
    degree = rng.integers(-3, 4, n_notes).cumsum() % 14
    pitch = centre + np.take(_SCALE, degree % 7) + 12 * (degree // 7) - 12
    onset = np.minimum(rng.integers(0, 6, n_notes).cumsum(), 4095)
    dur = rng.integers(1, 16, n_notes)
    notes = np.stack([np.full(n_notes, NOTE), P0 + np.clip(pitch, 0, 127),
                      T0 + onset, D0 + dur], 1).reshape(-1)
    return np.concatenate([[START], notes, [END]]).astype(np.int64)


def windows(rng: np.random.Generator, rows: int, width: int,
            min_len: int, max_len: int) -> np.ndarray:
    """[rows, width] windows, each cut at a random offset from its own song
    of ``min_len``..``max_len`` tokens (at least ``width`` long)."""
    out = np.empty((rows, width), np.int64)
    for r in range(rows):
        s = song(rng, int(rng.integers(max(min_len, width + 2),
                                       max_len + 1)))
        at = int(rng.integers(0, len(s) - width + 1))
        out[r] = s[at:at + width]
    return out
