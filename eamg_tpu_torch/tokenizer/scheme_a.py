"""Scheme A — "text tokens": the serving-path token grammar.

Re-implements the reference's MIDI feature extraction and tokenization
(midi_test/midi_extract.py:5-43, midi_test/midi_tokenization.py:2-19) on top
of our own SMF codec, and the token->song detokenizer used by every serving
path (api_cache.py:208-221).

Grammar (exact string forms — the vocab, prompt assembly and the detokenizer
regex all key off these):

    [START_SEQUENCE]
    [BPM] <float>
    [KEY_SIGNATURE] <tonic> <mode>
    [INSTRUMENT] <name>
    [NOTE] [PITCH:<name>] [START:<s>] [END:<s>] [DURATION:<s>]
    [END_SEQUENCE]

Two reference bugs are fixed here (and documented, per SURVEY.md §2.1):
- midi_extract.py:10 analyzed a *hardcoded filename* instead of its argument;
  we analyze the actual file.
- midi_tokenization.py:17 had its ``return`` commented out (function returned
  None); ours returns the token list.
"""

from __future__ import annotations

import re

from ..midi import (INSTRUMENT_MAP, Instrument, MidiSong, Note, analyze_key,
                    instrument_name_to_program, note_name_to_number,
                    note_number_to_name)

START = "[START_SEQUENCE]"
END = "[END_SEQUENCE]"
PAD = "[PAD]"

# Exact regex contract from api_cache.py:157.
NOTE_RE = re.compile(
    r"\[NOTE\] \[PITCH:(.+?)\] \[START:(.+?)\] \[END:(.+?)\] "
    r"\[DURATION:(.+?)\]")


def extract_data(midi_file) -> dict:
    """MIDI file -> {BPM, Key Signature, Instruments} feature dict.

    Same output shape as reference midi_test/midi_extract.py:5-43; the key is
    analyzed from the *given* file (reference bug fixed).
    """
    song = MidiSong(midi_file)
    _, tempi = song.get_tempo_changes()
    bpm = float(tempi[0])
    key_signature = analyze_key(song)

    instruments: dict[str, list[dict]] = {}
    for inst in song.instruments:
        name = song.instrument_display_name(inst)
        note_infos = [{
            "name": note_number_to_name(n.pitch),
            "start": round(n.start, 3),
            "end": round(n.end, 3),
            "duration": round(n.end - n.start, 3),
        } for n in inst.notes]
        instruments.setdefault(name, []).extend(note_infos)

    return {"BPM": bpm, "Key Signature": key_signature,
            "Instruments": instruments}


def midi_tokenize(midi_file) -> list[str]:
    """MIDI file -> Scheme-A token list (reference's no-return bug fixed)."""
    data = extract_data(midi_file)
    tokens = [START,
              f"[BPM] {data['BPM']}",
              f"[KEY_SIGNATURE] {data['Key Signature']}"]
    for instrument, notes in data["Instruments"].items():
        tokens.append(f"[INSTRUMENT] {instrument}")
        for n in notes:
            tokens.append(
                f"[NOTE] [PITCH:{n['name']}] [START:{n['start']}] "
                f"[END:{n['end']}] [DURATION:{n['duration']}]")
    tokens.append(END)
    return tokens


def tokens_to_song(tokens: list[str], velocity: int = 100,
                   initial_tempo: float | None = None) -> MidiSong:
    """Detokenize a Scheme-A stream into a :class:`MidiSong`.

    Reproduces the serving loop at api_cache.py:208-221 exactly:
    - ``[INSTRUMENT] name`` opens a new instrument; unknown GM names get
      program 0 but keep their name;
    - NOTE tokens before any instrument are dropped;
    - velocity is fixed at 100.
    ``[BPM]`` tokens additionally set the song tempo (used by the renderer;
    the reference ignored them at this stage).
    """
    tempo = initial_tempo
    for tok in tokens:
        if tempo is None and tok.startswith("[BPM]"):
            try:
                tempo = float(tok.split()[-1])
            except ValueError:
                pass
    song = MidiSong(initial_tempo=tempo or 120.0)
    current: Instrument | None = None
    for tok in tokens:
        if tok.startswith("[INSTRUMENT]"):
            name = tok.split("]", 1)[1].strip()
            prog = (instrument_name_to_program(name)
                    if name in INSTRUMENT_MAP else 0)
            current = Instrument(program=prog, name=name)
            song.instruments.append(current)
        elif (m := NOTE_RE.match(tok)) and current is not None:
            pitch = note_name_to_number(m.group(1))
            start, end = float(m.group(2)), float(m.group(3))
            current.notes.append(
                Note(velocity=velocity, pitch=pitch, start=start, end=end))
    return song
