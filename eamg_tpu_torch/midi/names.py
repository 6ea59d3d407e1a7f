"""Note-name and General MIDI instrument tables.

Replaces the reference's use of ``pretty_midi.note_number_to_name`` /
``note_name_to_number`` / ``instrument_name_to_program`` / ``INSTRUMENT_MAP``
(consumed at reference api_cache.py:212-217, midi_test/midi_extract.py:18-21).
The tables are the public General MIDI Level 1 instrument set.
"""

from __future__ import annotations

import re

# General MIDI program names, index = program number 0..127.
GM_INSTRUMENT_NAMES: list[str] = [
    "Acoustic Grand Piano", "Bright Acoustic Piano", "Electric Grand Piano",
    "Honky-tonk Piano", "Electric Piano 1", "Electric Piano 2", "Harpsichord",
    "Clavinet", "Celesta", "Glockenspiel", "Music Box", "Vibraphone",
    "Marimba", "Xylophone", "Tubular Bells", "Dulcimer", "Drawbar Organ",
    "Percussive Organ", "Rock Organ", "Church Organ", "Reed Organ",
    "Accordion", "Harmonica", "Tango Accordion", "Acoustic Guitar (nylon)",
    "Acoustic Guitar (steel)", "Electric Guitar (jazz)",
    "Electric Guitar (clean)", "Electric Guitar (muted)", "Overdriven Guitar",
    "Distortion Guitar", "Guitar Harmonics", "Acoustic Bass",
    "Electric Bass (finger)", "Electric Bass (pick)", "Fretless Bass",
    "Slap Bass 1", "Slap Bass 2", "Synth Bass 1", "Synth Bass 2", "Violin",
    "Viola", "Cello", "Contrabass", "Tremolo Strings", "Pizzicato Strings",
    "Orchestral Harp", "Timpani", "String Ensemble 1", "String Ensemble 2",
    "Synth Strings 1", "Synth Strings 2", "Choir Aahs", "Voice Oohs",
    "Synth Choir", "Orchestra Hit", "Trumpet", "Trombone", "Tuba",
    "Muted Trumpet", "French Horn", "Brass Section", "Synth Brass 1",
    "Synth Brass 2", "Soprano Sax", "Alto Sax", "Tenor Sax", "Baritone Sax",
    "Oboe", "English Horn", "Bassoon", "Clarinet", "Piccolo", "Flute",
    "Recorder", "Pan Flute", "Blown Bottle", "Shakuhachi", "Whistle",
    "Ocarina", "Lead 1 (square)", "Lead 2 (sawtooth)", "Lead 3 (calliope)",
    "Lead 4 (chiff)", "Lead 5 (charang)", "Lead 6 (voice)", "Lead 7 (fifths)",
    "Lead 8 (bass + lead)", "Pad 1 (new age)", "Pad 2 (warm)",
    "Pad 3 (polysynth)", "Pad 4 (choir)", "Pad 5 (bowed)", "Pad 6 (metallic)",
    "Pad 7 (halo)", "Pad 8 (sweep)", "FX 1 (rain)", "FX 2 (soundtrack)",
    "FX 3 (crystal)", "FX 4 (atmosphere)", "FX 5 (brightness)",
    "FX 6 (goblins)", "FX 7 (echoes)", "FX 8 (sci-fi)", "Sitar", "Banjo",
    "Shamisen", "Koto", "Kalimba", "Bagpipe", "Fiddle", "Shanai",
    "Tinkle Bell", "Agogo", "Steel Drums", "Woodblock", "Taiko Drum",
    "Melodic Tom", "Synth Drum", "Reverse Cymbal", "Guitar Fret Noise",
    "Breath Noise", "Seashore", "Bird Tweet", "Telephone Ring", "Helicopter",
    "Applause", "Gunshot",
]

# Name -> program lookup (the reference gates on membership in
# pretty_midi.INSTRUMENT_MAP before calling instrument_name_to_program,
# api_cache.py:212-213; INSTRUMENT_MAP here plays the same role).
INSTRUMENT_MAP = GM_INSTRUMENT_NAMES
_NAME_TO_PROGRAM = {n.lower(): p for p, n in enumerate(GM_INSTRUMENT_NAMES)}

# GM instrument family for each bank of 8 programs (program // 8 indexes this).
GM_FAMILY_NAMES: list[str] = [
    "Piano", "Chromatic Percussion", "Organ", "Guitar", "Bass", "Strings",
    "Ensemble", "Brass", "Reed", "Pipe", "Synth Lead", "Synth Pad",
    "Synth Effects", "Ethnic", "Percussive", "Sound Effects",
]

_PC_TO_SHARP_NAME = ["C", "C#", "D", "D#", "E", "F", "F#", "G", "G#", "A",
                     "A#", "B"]
_LETTER_TO_PC = {"C": 0, "D": 2, "E": 4, "F": 5, "G": 7, "A": 9, "B": 11}

# '-' binds to the octave (C-1 == MIDI 0), matching pretty_midi's dialect;
# flats are spelled 'b', '♭' or '!'.
_NOTE_NAME_RE = re.compile(r"^([A-Ga-g])([#♯b♭!]*)(-?\d+)$")


def note_number_to_name(number: int) -> str:
    """MIDI note number -> name, sharp spelling, C4 = 60 (pretty_midi dialect).

    Mirrors pretty_midi's convention so Scheme-A ``[PITCH:...]`` strings match
    the reference corpus (midi_test/midi_extract.py:19).
    """
    number = int(round(number))
    return f"{_PC_TO_SHARP_NAME[number % 12]}{number // 12 - 1}"


def note_name_to_number(name: str) -> int:
    """Note name -> MIDI number. Accepts '#', '♯' sharps; 'b', '♭', '-', '!' flats.

    Inverse of :func:`note_number_to_name`; consumed by the detokenizer
    (reference api_cache.py:217).
    """
    m = _NOTE_NAME_RE.match(name.strip())
    if not m:
        raise ValueError(f"Improper note format: {name!r}")
    letter, accidentals, octave = m.groups()
    pitch = _LETTER_TO_PC[letter.upper()]
    for acc in accidentals:
        if acc in "#♯":
            pitch += 1
        elif acc in "b♭!":
            pitch -= 1
    return pitch + 12 * (int(octave) + 1)


def instrument_name_to_program(name: str) -> int:
    """GM instrument name -> program number (case-insensitive)."""
    try:
        return _NAME_TO_PROGRAM[name.strip().lower()]
    except KeyError:
        raise ValueError(f"{name!r} is not a General MIDI instrument") from None


def program_to_instrument_name(program: int) -> str:
    """GM program number -> canonical name."""
    if not 0 <= int(program) <= 127:
        raise ValueError(f"program must be in [0, 127], got {program}")
    return GM_INSTRUMENT_NAMES[int(program)]


def program_to_family_name(program: int) -> str:
    """GM program number -> instrument family name (bank of 8)."""
    if not 0 <= int(program) <= 127:
        raise ValueError(f"program must be in [0, 127], got {program}")
    return GM_FAMILY_NAMES[int(program) // 8]
