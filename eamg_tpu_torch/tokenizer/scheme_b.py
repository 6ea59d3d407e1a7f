"""Scheme B — compact/exploded token vocabularies (the training-path schemes).
The port's own copy of the JAX package's ``tokenizer/scheme_b.py``.

Three sub-variants, matching the reference trainers exactly (SURVEY.md §1):

- **V1** (train/train_large.py:36-55): NOTE strings exploded into atomic
  *text* subtokens at 10 ms ticks; vocabulary is data-dependent.
- **V2** (train/train_large2.py:19-65): fixed 8,324-token id vocabulary
  ``[PAD],[START_SEQ],[END_SEQ],[NOTE]`` + ``P_0..127`` + ``T_0..4095`` +
  ``DUR_0..4095`` at 50 ms resolution (paper §9.1 Table 4).
- **V3** (train/train_no_inst.py:22-79): V2 plus ``BPM_20..250`` and
  ``KEY_0..23`` control tokens inserted right after ``[START_SEQ]``.

``explode`` consumes either a JSON-encoded Scheme-A token list (the corpus
CSV ``tokens`` column format) or an already-decoded list of token strings.
A decoder (ids -> MidiSong) is provided for serving Scheme-B models — the
reference never closed that loop; we do.
"""

from __future__ import annotations

import json
import re

from ..midi import Instrument, MidiSong, Note
from .vocab import Vocab

NOTE_BASE = dict(C=0, D=2, E=4, F=5, G=7, A=9, B=11)

_PITCH_RE = re.compile(r"([A-Ga-g])([#b\-♯♭]?)(-?\d+)$")
_KEY_RE = re.compile(r"([A-Ga-g])([#b\-♯♭]?)[\s_-]*(major|minor)", re.I)

# Exact regex contract from train/train_large.py:36-40.
NOTE_PAT_SECS = re.compile(
    r"\[NOTE\] \[PITCH:(.+?)\] "
    r"\[START:(.+?)\] \[END:(.+?)\] \[DURATION:(.+?)\]")


def pitch_to_midi(txt: str) -> int:
    """Note-name text -> MIDI number; falls back to middle C on no-match
    (train/train_large2.py:34-43). Note: here '-' is a *flat*, matching the
    reference's explode parser, unlike the pretty_midi pitch dialect."""
    m = _PITCH_RE.match(txt.strip())
    if not m:
        return 60
    root, acc, octv = m.groups()
    semitone = NOTE_BASE[root.upper()]
    if acc in {"#", "♯"}:
        semitone += 1
    elif acc in {"b", "-", "♭"}:
        semitone -= 1
    midi = (int(octv) + 1) * 12 + semitone
    return max(0, min(127, midi))


def key_to_idx(txt: str) -> int:
    """Key text -> 0-23 (0-11 major, 12-23 minor); 0 on no-match
    (train/train_no_inst.py:43-50)."""
    m = _KEY_RE.match(txt.strip())
    if not m:
        return 0
    root, acc, mode = m.groups()
    s = NOTE_BASE[root.upper()]
    if acc in {"#", "♯"}:
        s += 1
    elif acc in {"b", "-", "♭"}:
        s -= 1
    return (s % 12) + (12 if mode.lower() == "minor" else 0)


def _as_token_list(js) -> list[str]:
    return json.loads(js) if isinstance(js, str) else list(js)


class SchemeB1:
    """Exploded *text* subtokens at 10 ms ticks, data-dependent vocab
    (train/train_large.py:36-55)."""

    TICK_MS = 10

    def __init__(self, seq_len: int = 256):
        self.seq_len = seq_len

    def to_tick(self, s) -> int:
        return int(round(float(s) * 1000 / self.TICK_MS))

    def explode(self, js) -> list[str]:
        out: list[str] = []
        for tok in _as_token_list(js):
            m = NOTE_PAT_SECS.match(tok)
            if not m:
                out.append(tok)
                continue
            p, s, e, d = m.groups()
            out.extend(("[NOTE]", "[PITCH]", p,
                        "[START_T]", str(self.to_tick(s)),
                        "[END_T]", str(self.to_tick(e)),
                        "[DUR_T]", str(self.to_tick(d))))
        return out[:self.seq_len]

    def build_vocab(self, corpus) -> Vocab:
        return Vocab.from_sequences((self.explode(js) for js in corpus),
                                    pad_last=False)


class SchemeB2:
    """Fixed 8,324-token vocabulary at 50 ms resolution
    (train/train_large2.py:19-65; paper §9.1 Table 4)."""

    SPECIAL = ["[PAD]", "[START_SEQ]", "[END_SEQ]", "[NOTE]"]

    def __init__(self, seq_len: int = 512, res_ms: int = 50,
                 max_tick: int = 4095, strict_parity: bool = True):
        self.seq_len = seq_len
        self.res_ms = res_ms
        self.max_tick = max_tick
        # strict_parity reproduces a reference bug: train_large2.py:52 parses
        # duration as `parts[4].split(":")[1][:-2]`, which strips the closing
        # ']' AND the final digit ("0.38]" -> "0.3"). False parses correctly.
        self.strict_parity = strict_parity
        tokens = (list(self.SPECIAL)
                  + [f"P_{i}" for i in range(128)]
                  + [f"T_{i}" for i in range(max_tick + 1)]
                  + [f"DUR_{i}" for i in range(max_tick + 1)])
        self.vocab = Vocab.from_list(tokens)

    def bucket(self, ms: float) -> int:
        return min(self.max_tick, int(round(ms / self.res_ms)))

    def explode(self, js) -> list[int]:
        t2i = self.vocab.tok2id
        seq = [t2i["[START_SEQ]"]]
        for tok in _as_token_list(js):
            if not tok.startswith("[NOTE]"):
                continue
            parts = tok.split()
            pitch_s = parts[1].split(":")[1][:-1]
            start = float(parts[2].split(":")[1][:-1])
            dur_s = parts[4].split(":")[1]
            dur = float(dur_s[:-2] or 0) if self.strict_parity \
                else float(dur_s.rstrip("]"))
            seq += [t2i["[NOTE]"],
                    t2i[f"P_{pitch_to_midi(pitch_s)}"],
                    t2i[f"T_{self.bucket(start * 1000)}"],
                    t2i[f"DUR_{self.bucket(dur * 1000)}"]]
        seq.append(t2i["[END_SEQ]"])
        return seq[:self.seq_len]

    def decode_to_song(self, ids, program: int = 0,
                       tempo: float = 120.0) -> MidiSong:
        """ids -> MidiSong. Scans for [NOTE] P_x T_y DUR_z triples; onset and
        duration are ticks of ``res_ms``. Not in the reference (its serving
        checkpoints are Scheme A); needed to serve Scheme-B models."""
        i2t = self.vocab.id2tok
        song = MidiSong(initial_tempo=tempo)
        inst = Instrument(program=program)
        toks = [i2t.get(int(i), "[PAD]") for i in ids]
        bpm = key = None
        k = 0
        while k < len(toks):
            t = toks[k]
            if t.startswith("BPM_"):
                bpm = int(t[4:])
            elif t.startswith("KEY_"):
                key = int(t[4:])
            elif (t == "[NOTE]" and k + 3 < len(toks)
                    and toks[k + 1].startswith("P_")
                    and toks[k + 2].startswith("T_")
                    and toks[k + 3].startswith("DUR_")):
                pitch = int(toks[k + 1][2:])
                start = int(toks[k + 2][2:]) * self.res_ms / 1000.0
                dur = int(toks[k + 3][4:]) * self.res_ms / 1000.0
                inst.notes.append(Note(100, pitch, start,
                                       start + max(dur, self.res_ms / 1000)))
                k += 4
                continue
            k += 1
        if bpm is not None:
            song._tempi[0] = float(bpm)
        song.key_index = key  # annotation only
        if inst.notes:
            song.instruments.append(inst)
        return song


class SchemeB3(SchemeB2):
    """V2 + BPM/KEY control tokens (train/train_no_inst.py:22-79)."""

    def __init__(self, seq_len: int = 512, res_ms: int = 50,
                 max_tick: int = 4095, min_bpm: int = 20, max_bpm: int = 250,
                 strict_parity: bool = True):
        self.seq_len = seq_len
        self.res_ms = res_ms
        self.max_tick = max_tick
        self.min_bpm = min_bpm
        self.max_bpm = max_bpm
        self.strict_parity = strict_parity
        tokens = (list(self.SPECIAL)
                  + [f"BPM_{i}" for i in range(min_bpm, max_bpm + 1)]
                  + [f"KEY_{i}" for i in range(24)]
                  + [f"P_{i}" for i in range(128)]
                  + [f"T_{i}" for i in range(max_tick + 1)]
                  + [f"DUR_{i}" for i in range(max_tick + 1)])
        self.vocab = Vocab.from_list(tokens)

    def explode(self, js) -> list[int]:
        t2i = self.vocab.tok2id
        bpm_tok = key_tok = None
        seq = [t2i["[START_SEQ]"]]
        for t in _as_token_list(js):
            if t.startswith("[BPM]"):
                bpm = int(round(float(t.split()[-1])))
                bpm = max(self.min_bpm, min(self.max_bpm, bpm))
                bpm_tok = t2i[f"BPM_{bpm}"]
            elif t.startswith("[KEY_SIGNATURE]"):
                key_tok = t2i[f"KEY_{key_to_idx(' '.join(t.split()[1:]))}"]
            elif t.startswith("[NOTE]"):
                parts = t.split()
                p = pitch_to_midi(parts[1].split(":")[1][:-1])
                s = float(parts[2].split(":")[1][:-1])
                d_s = parts[4].split(":")[1]
                d = float(d_s[:-2] or 0) if self.strict_parity \
                    else float(d_s.rstrip("]"))
                seq += [t2i["[NOTE]"], t2i[f"P_{p}"],
                        t2i[f"T_{self.bucket(s * 1000)}"],
                        t2i[f"DUR_{self.bucket(d * 1000)}"]]
        if bpm_tok is not None:
            seq.insert(1, bpm_tok)
        if key_tok is not None:
            seq.insert(2 if bpm_tok is not None else 1, key_tok)
        seq.append(t2i["[END_SEQ]"])
        return seq[:self.seq_len]

    def control_prefix(self, bpm: int, key: str | int) -> list[int]:
        """Prompt prefix [START_SEQ, BPM_x, KEY_y] for conditioned decoding."""
        t2i = self.vocab.tok2id
        bpm = max(self.min_bpm, min(self.max_bpm, int(round(bpm))))
        key_idx = key if isinstance(key, int) else key_to_idx(key)
        return [t2i["[START_SEQ]"], t2i[f"BPM_{bpm}"], t2i[f"KEY_{key_idx}"]]


def detect_scheme(vocab) -> str:
    """Infer the token scheme a checkpoint was trained with from its
    vocabulary — checkpoints carry {vocab, params, cfg} but no scheme tag
    (reference layout, train/train_large2.py:100-110). 'b3' = fixed vocab
    with BPM/KEY controls (train_no_inst.py:22-29), 'b2' = fixed 8,324
    vocab (train_large2.py:23-29), 'b1' = data-dependent exploded subtokens
    (train_large.py:39-55), 'a' = text tokens (the serving checkpoints)."""
    if "BPM_20" in vocab and "KEY_0" in vocab:
        return "b3"
    if "P_0" in vocab and "T_0" in vocab:
        return "b2"
    if "[START_T]" in vocab or "[DUR_T]" in vocab:
        return "b1"
    return "a"
