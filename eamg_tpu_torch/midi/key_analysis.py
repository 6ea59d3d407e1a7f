"""Krumhansl–Schmuckler key finding.

Replaces ``music21.converter.parse(...).analyze('key')``
(reference midi_test/midi_extract.py:10-12) with a self-contained
implementation: a duration-weighted pitch-class histogram correlated against
the Krumhansl–Kessler major/minor key profiles (public psychoacoustics data).

Output string format follows music21's ``str(Key)``: tonic spelled with the
conventional circle-of-fifths accidental ('-' for flat, '#' for sharp),
capitalized for major and lowercase for minor, e.g. ``"B- major"``,
``"f# minor"`` — exactly the strings the Scheme-A ``[KEY_SIGNATURE]`` tokens
carry (midi_test/midi_tokenization.py:7) and ``normalize_key_signature``
consumes (api_cache.py:145-151).
"""

from __future__ import annotations

import numpy as np

from .smf import MidiSong

# Krumhansl–Kessler probe-tone profiles.
_MAJOR_PROFILE = np.array([6.35, 2.23, 3.48, 2.33, 4.38, 4.09, 2.52, 5.19,
                           2.39, 3.66, 2.29, 2.88])
_MINOR_PROFILE = np.array([6.33, 2.68, 3.52, 5.38, 2.60, 3.53, 2.54, 4.75,
                           3.98, 2.69, 3.34, 3.17])

# Conventional key spellings by pitch class (music21-style, '-' = flat).
_MAJOR_TONICS = ["C", "D-", "D", "E-", "E", "F", "F#", "G", "A-", "A", "B-",
                 "B"]
_MINOR_TONICS = ["c", "c#", "d", "e-", "e", "f", "f#", "g", "g#", "a", "b-",
                 "b"]


def pitch_class_histogram(song: MidiSong) -> np.ndarray:
    """Duration-weighted pitch-class distribution over all non-drum notes."""
    hist = np.zeros(12)
    for inst in song.instruments:
        if inst.is_drum:
            continue
        for note in inst.notes:
            hist[note.pitch % 12] += max(note.duration, 1e-3)
    return hist


def _correlate(hist: np.ndarray, profile: np.ndarray) -> np.ndarray:
    """Pearson correlation of hist against the 12 rotations of profile."""
    scores = np.empty(12)
    hc = hist - hist.mean()
    hn = np.linalg.norm(hc) or 1.0
    for rot in range(12):
        p = np.roll(profile, rot)
        pc = p - p.mean()
        scores[rot] = float(hc @ pc) / (hn * np.linalg.norm(pc))
    return scores


def analyze_key(song: MidiSong) -> str:
    """Return e.g. ``"B- major"`` or ``"a minor"`` for the song."""
    hist = pitch_class_histogram(song)
    if hist.sum() <= 0:
        return "C major"
    major = _correlate(hist, _MAJOR_PROFILE)
    minor = _correlate(hist, _MINOR_PROFILE)
    if major.max() >= minor.max():
        return f"{_MAJOR_TONICS[int(major.argmax())]} major"
    return f"{_MINOR_TONICS[int(minor.argmax())]} minor"


def key_name_to_index(key: str) -> int:
    """Key string -> 0..23 (0-11 major by pitch class, 12-23 minor).

    Same contract as the reference's ``key_to_idx``
    (train/train_no_inst.py:43-50); shared with Scheme-B-v3 tokens.
    """
    import re

    m = re.match(r"([A-Ga-g])([#♯b♭\-]?)[\s_-]*(major|minor)", key.strip(),
                 re.IGNORECASE)
    if not m:
        return 0
    letter, acc, mode = m.groups()
    base = {"C": 0, "D": 2, "E": 4, "F": 5, "G": 7, "A": 9, "B": 11}
    pc = base[letter.upper()]
    if acc in ("#", "♯"):
        pc += 1
    elif acc in ("b", "♭", "-"):
        pc -= 1
    return (pc % 12) + (12 if mode.lower() == "minor" else 0)
