"""Host data pipeline: corpus CSV streaming, padded/shifted id batches,
packed rows, and the synthetic corpora.

The port's copy of ``eamg_tpu/train/data.py`` (host numpy, no torch):
- ``iter_csv_tokens`` streams the JSON ``tokens`` column of a corpus CSV;
- ``pad_and_shift`` pads an id row to ``seq_len`` and shifts it by one
  (x = full[:-1], y = full[1:]), and ``batches`` groups such rows into
  [accum_steps, micro_batch, seq_len - 1] steps, shuffled per epoch with
  ``random.Random(shuffle_seed)`` exactly as the JAX package shuffles, the
  last step filled with all-PAD rows when ``drop_last`` is False;
- ``pack_rows`` / ``packed_batches`` put several whole songs in one row,
  with 1-based segment ids and the targets that cross a song boundary
  masked to PAD;
- ``synthetic_song`` / ``synthetic_corpus`` (the tempo-locked songs the
  Scheme-B3 demo was trained on) and ``grid_song`` / ``grid_corpus`` (the
  quantized-grid songs of the Scheme-A flagship), with the same random
  streams, so a seed gives the same rows; ``write_synthetic_csv`` writes
  them with the reference corpus schema; ``pad_rows`` pads evaluation rows.
"""

from __future__ import annotations

import csv
import json
import random
from typing import Iterable, Iterator

import numpy as np


def iter_csv_tokens(path: str, max_rows: int | None = None,
                    column: str = "tokens") -> Iterator[str]:
    """Stream the JSON-encoded token column of a corpus CSV."""
    with open(path, newline="", encoding="utf-8") as f:
        reader = csv.DictReader(f)
        for i, row in enumerate(reader):
            if max_rows is not None and i >= max_rows:
                return
            yield row[column]


def pad_and_shift(ids: list[int], seq_len: int, pad_id: int
                  ) -> tuple[np.ndarray, np.ndarray]:
    """ids -> (x [seq_len-1], y [seq_len-1]): pad to seq_len, shift by one."""
    full = list(ids[:seq_len])
    full.extend([pad_id] * (seq_len - len(full)))
    arr = np.asarray(full, np.int32)
    return arr[:-1], arr[1:]


def pad_rows(encoded: Iterable[list[int]], seq_len: int,
             pad_id: int) -> np.ndarray:
    """Truncate/right-pad each id row to seq_len -> [N, seq_len] int32
    (the teacher-forced evaluation rows)."""
    return np.stack([np.asarray(
        (list(ids[:seq_len]) + [pad_id] * (seq_len - len(ids)))[:seq_len],
        np.int32) for ids in encoded])


def batches(encoded: Iterable[list[int]], seq_len: int, pad_id: int,
            micro_batch: int, accum_steps: int = 1, drop_last: bool = True,
            shuffle_seed: int | None = None
            ) -> Iterator[tuple[np.ndarray, np.ndarray]]:
    """Yield (x, y) of shape [accum_steps, micro_batch, seq_len-1]."""
    rows = list(encoded)
    if shuffle_seed is not None:
        random.Random(shuffle_seed).shuffle(rows)
    per_step = micro_batch * accum_steps
    xs, ys = [], []
    for ids in rows:
        x, y = pad_and_shift(ids, seq_len, pad_id)
        xs.append(x)
        ys.append(y)
        if len(xs) == per_step:
            yield (np.stack(xs).reshape(accum_steps, micro_batch, -1),
                   np.stack(ys).reshape(accum_steps, micro_batch, -1))
            xs, ys = [], []
    if xs and not drop_last:
        while len(xs) < per_step:  # pad out the final step with PAD rows
            xs.append(np.full_like(xs[0], pad_id))
            ys.append(np.full_like(ys[0], pad_id))
        yield (np.stack(xs).reshape(accum_steps, micro_batch, -1),
               np.stack(ys).reshape(accum_steps, micro_batch, -1))


def pack_rows(encoded: Iterable[list[int]], seq_len: int, pad_id: int
              ) -> tuple[np.ndarray, np.ndarray]:
    """Greedy in-order packing of whole token streams into fixed rows:
    consecutive songs are concatenated into [N, seq_len] rows with 1-based
    segment ids per position (0 = trailing pad). Songs longer than seq_len
    are truncated; a song that does not fit the current row starts the
    next one, so rows never split a song.
    Returns (rows [N, seq_len] int32, segs [N, seq_len] int32)."""
    rows, segs = [], []
    cur: list[int] = []
    cseg: list[int] = []
    k = 0

    def flush():
        pad = seq_len - len(cur)
        rows.append(cur + [pad_id] * pad)
        segs.append(cseg + [0] * pad)

    for ids in encoded:
        ids = list(ids[:seq_len])
        if not ids:
            continue
        if len(cur) + len(ids) > seq_len:
            flush()
            cur, cseg, k = [], [], 0
        k += 1
        cur.extend(ids)
        cseg.extend([k] * len(ids))
    if cur:
        flush()
    return (np.asarray(rows, np.int32), np.asarray(segs, np.int32))


def packed_batches(encoded: Iterable[list[int]], seq_len: int, pad_id: int,
                   micro_batch: int, accum_steps: int = 1,
                   drop_last: bool = True,
                   shuffle_seed: int | None = None
                   ) -> Iterator[tuple[np.ndarray, np.ndarray, np.ndarray]]:
    """Packed twin of :func:`batches`: yields (x, y, seg), each
    [accum_steps, micro_batch, seq_len-1]. Targets whose source and
    destination lie in different segments (a song's last token predicting
    the next song's first, and pad tails) are masked to ``pad_id``;
    ``shuffle_seed`` shuffles songs before packing."""
    rows_in = list(encoded)
    if shuffle_seed is not None:
        random.Random(shuffle_seed).shuffle(rows_in)
    rows, segs = pack_rows(rows_in, seq_len, pad_id)
    x_all, y_all = rows[:, :-1], rows[:, 1:].copy()
    seg_all = segs[:, :-1]
    y_all[segs[:, 1:] != seg_all] = pad_id          # boundary + pad targets
    per_step = micro_batch * accum_steps
    T = seq_len - 1
    for i in range(0, len(rows), per_step):
        xs, ys, ss = (a[i:i + per_step] for a in (x_all, y_all, seg_all))
        if len(xs) < per_step:
            if drop_last:
                return
            fill = per_step - len(xs)
            xs = np.concatenate(
                [xs, np.full((fill, T), pad_id, np.int32)])
            ys = np.concatenate(
                [ys, np.full((fill, T), pad_id, np.int32)])
            ss = np.concatenate([ss, np.zeros((fill, T), np.int32)])
        yield (xs.reshape(accum_steps, micro_batch, T),
               ys.reshape(accum_steps, micro_batch, T),
               ss.reshape(accum_steps, micro_batch, T))


# ------------------------------------------------------- synthetic corpus

_PITCHES = ["C3", "D3", "E3", "F3", "G3", "A3", "B3", "C4", "D4", "E4",
            "F4", "G4", "A4", "B4", "C5"]
# the normalized forms of every key in emotion/lookup_table.csv, so a
# synthetic-vocab model can serve any EATS mapping
# (normalize_key_signature output dialect: '-' flats, lowercased mode)
_KEYS = ["C major", "D major", "E major", "F major", "G major", "A major",
         "B- major", "E- major", "A minor", "B minor", "D minor", "E minor",
         "F minor", "G minor", "C# minor", "F# minor", "G# minor"]
_INSTRUMENTS = ["Violin", "Acoustic Grand Piano", "Flute"]


def synthetic_song(rng: random.Random, n_notes: int = 24,
                   key: str | None = None,
                   tempo_locked: bool = False,
                   jitter_ms: float = 0.0,
                   bpm_set: tuple | None = None) -> list[str]:
    """One fake Scheme-A token sequence with the exact string grammar.

    tempo_locked=True makes note timing an actual function of the BPM token
    (inter-onset intervals are beat fractions) so models trained on the
    corpus can *learn* tempo conditioning — required for the MSE-Tune
    metric (paper §10.4) to be meaningful on synthetic data.

    jitter_ms > 0 adds Gaussian micro-timing to every onset/offset —
    the structure real Lakh data has (performance MIDI, not quantized
    scores). Without it the corpus is grid-pure and COARSE time buckets
    trivially win the §10.4 ablation (fewer distinguishable outcomes =
    lower entropy); with human-scale jitter (~20-30 ms), 50 ms bins
    absorb the noise while 200 ms bins turn boundary-adjacent onsets
    into irreducible coin flips — the paper's −fine-bins degradation.
    """
    bpm = rng.choice(list(bpm_set)) if bpm_set else rng.randint(60, 180)
    toks = ["[START_SEQUENCE]",
            f"[BPM] {float(bpm)}",
            f"[KEY_SIGNATURE] {key or rng.choice(_KEYS)}"]
    beat = 60.0 / bpm
    jit = jitter_ms / 1000.0
    for inst in rng.sample(_INSTRUMENTS, rng.randint(1, 2)):
        toks.append(f"[INSTRUMENT] {inst}")
        t = 0.0
        for _ in range(n_notes):
            if tempo_locked:
                dur = beat * rng.choice([0.5, 0.5, 1.0, 1.0, 1.0, 2.0])
            else:
                dur = rng.choice([0.125, 0.25, 0.5, 1.0])
            j0 = rng.gauss(0.0, jit) if jit else 0.0
            j1 = rng.gauss(0.0, jit) if jit else 0.0
            start = round(max(t + j0, 0.0), 3)
            end = round(max(t + dur + j1, start + 0.01), 3)
            toks.append(
                f"[NOTE] [PITCH:{rng.choice(_PITCHES)}] [START:{start}] "
                f"[END:{end}] [DURATION:{round(end - start, 3)}]")
            t += dur
    toks.append("[END_SEQUENCE]")
    return toks


def synthetic_corpus(n_rows: int, seed: int = 0, n_notes: int = 24,
                     tempo_locked: bool = False,
                     jitter_ms: float = 0.0,
                     bpm_set: tuple | None = None) -> list[str]:
    """JSON-encoded rows shaped like the lmd CSV 'tokens' column."""
    rng = random.Random(seed)
    # the first len(_KEYS) rows cycle through every key so a vocabulary
    # built from the corpus can encode any EATS mapping
    return [json.dumps(synthetic_song(
        rng, n_notes, key=_KEYS[i % len(_KEYS)] if i < len(_KEYS) else None,
        tempo_locked=tempo_locked, jitter_ms=jitter_ms,
        bpm_set=bpm_set))
        for i in range(n_rows)]


# --------------------------------------- grid corpus (generalizing demo)
#
# The tempo-locked generator above accumulates FLOAT onsets, so every
# `[NOTE] ... [START:t] ...` string is nearly unique — a Scheme-A model
# trained on it can only memorize (round-2 demo: train PPL 1.33, held-out
# 1747). Real Lakh Scheme-A corpora recur note strings because times are
# 3-dp roundings of quantized musical grids (midi_test/midi_extract.py:
# 22-27: start/end/duration rounded to 3 decimals). This generator makes
# that structure explicit: a small BPM set, onsets on a half-beat integer
# grid, and a GLOBAL motif library shared by every song — so the exact
# note strings recur corpus-wide and held-out songs are (almost) fully
# in-vocabulary, the precondition for a generalizing Scheme-A demo.

# beat lengths round to clean 3-dp values; the 17 EATS keys stay _KEYS
_GRID_BPMS = [60.0, 75.0, 90.0, 120.0, 150.0]
_SHARP_NAMES = ["C", "C#", "D", "D#", "E", "F", "F#", "G", "G#", "A",
                "A#", "B"]
_MAJOR = [0, 2, 4, 5, 7, 9, 11]
_MINOR = [0, 2, 3, 5, 7, 8, 10]


def key_scale_pitches(key: str, degrees: int = 10,
                      base_octave: int = 3) -> list[str]:
    """Pitch names (sharp spelling, the pretty_midi note-name dialect) of
    ``degrees`` scale steps of ``key`` starting at ``base_octave``.
    ``key`` uses the normalized dialect ('-' flats, lowercase mode)."""
    tonic, mode = key.rsplit(" ", 1)
    flat = tonic.endswith("-")
    pc = _SHARP_NAMES.index(tonic[0])
    if flat:
        pc = (pc - 1) % 12
    elif tonic.endswith("#"):
        pc = (pc + 1) % 12
    steps = _MAJOR if mode == "major" else _MINOR
    out = []
    for d in range(degrees):
        semis = pc + steps[d % 7] + 12 * (d // 7)
        out.append(f"{_SHARP_NAMES[semis % 12]}{base_octave + semis // 12}")
    return out


def motif_library(n_motifs: int = 40, seed: int = 7) -> list[list[tuple]]:
    """The global motif pool every song draws from. A motif is a list of
    (scale_degree, duration_units) steps; units are half-beats. Seeded
    independently of the per-song RNG so train and held-out corpora share
    the exact same library (motifs recur corpus-wide by construction)."""
    rng = random.Random(seed)
    lib = []
    for _ in range(n_motifs):
        deg = rng.randint(0, 6)
        motif = []
        for _ in range(rng.randint(4, 7)):
            motif.append((deg, rng.choice([1, 1, 2, 2, 2, 4])))
            deg = min(9, max(0, deg + rng.choice([-3, -2, -1, 1, 1, 2, 3])))
        lib.append(motif)
    return lib


def grid_song(rng: random.Random, lib: list[list[tuple]],
              key: str | None = None, bpm: float | None = None,
              max_units: int = 28,
              n_chains: tuple[int, int] | None = None) -> list[str]:
    """One Scheme-A song on the quantized grid: header + per-instrument
    motif chains. Onsets/durations are half-beat integers scaled by the
    BPM's beat length and rounded to 3 dp (the midi_extract.py:22-27
    convention), so identical (pitch, slot, duration, bpm) draws produce
    byte-identical note strings across songs.

    ``n_chains=(lo, hi)`` draws that many instrument chains WITH
    replacement (several tracks of one GM program is normal in real
    Lakh MIDI — pretty_midi keeps them separate instruments,
    midi_extract.py:16). Each chain restarts its clock at t=0, so the
    onset vocabulary stays the compact max_units grid no matter how
    long the song gets — the flagship 512-token corpus reuses the
    exact note-string vocabulary of the compact demo. None keeps the
    original 1-2 distinct-instrument draw (and its RNG stream)."""
    bpm = bpm if bpm is not None else rng.choice(_GRID_BPMS)
    key = key or rng.choice(_KEYS)
    pitches = key_scale_pitches(key)
    half_beat = 60.0 / bpm / 2.0
    toks = ["[START_SEQUENCE]", f"[BPM] {bpm}", f"[KEY_SIGNATURE] {key}"]
    if n_chains is None:
        chains = rng.sample(_INSTRUMENTS, rng.randint(1, 2))
    else:
        chains = [rng.choice(_INSTRUMENTS)
                  for _ in range(rng.randint(*n_chains))]
    for inst in chains:
        toks.append(f"[INSTRUMENT] {inst}")
        t_units = 0
        while t_units < max_units:
            for deg, dur in rng.choice(lib):
                if t_units + dur > max_units:
                    break
                start = round(t_units * half_beat, 3)
                end = round((t_units + dur) * half_beat, 3)
                toks.append(
                    f"[NOTE] [PITCH:{pitches[deg]}] [START:{start}] "
                    f"[END:{end}] [DURATION:{round(dur * half_beat, 3)}]")
                t_units += dur
            else:
                continue
            break
    toks.append("[END_SEQUENCE]")
    return toks


def grid_corpus(n_rows: int, seed: int = 0, n_motifs: int = 40,
                motif_seed: int = 7, max_units: int = 28,
                n_chains: tuple[int, int] | None = None) -> list[str]:
    """JSON-encoded grid songs (lmd CSV 'tokens' column shape). Different
    ``seed`` values give disjoint song COMPOSITIONS over the same motif
    library — the held-out split for the generalization metric. The first
    len(_KEYS) rows cycle every key so a vocab built from any prefix of
    the corpus can encode any EATS mapping. ``n_chains`` grows songs to
    flagship length (see grid_song) without growing the vocabulary."""
    rng = random.Random(seed)
    lib = motif_library(n_motifs, seed=motif_seed)
    return [json.dumps(grid_song(
        rng, lib, key=_KEYS[i % len(_KEYS)] if i < len(_KEYS) else None,
        max_units=max_units, n_chains=n_chains))
        for i in range(n_rows)]


def write_synthetic_csv(path: str, n_rows: int, seed: int = 0,
                        n_notes: int = 24) -> None:
    """Write a corpus CSV with the reference schema (file, key, tokens)."""
    with open(path, "w", newline="", encoding="utf-8") as f:
        w = csv.writer(f)
        w.writerow(["file", "key_signature", "tokens"])
        for i, js in enumerate(synthetic_corpus(n_rows, seed, n_notes)):
            w.writerow([f"synthetic_{i}.mid", "C major", js])
