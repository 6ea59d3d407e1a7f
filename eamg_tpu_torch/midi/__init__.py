"""Host-side MIDI layer: SMF codec, GM tables, key analysis."""

from .names import (GM_FAMILY_NAMES, GM_INSTRUMENT_NAMES, INSTRUMENT_MAP,
                    instrument_name_to_program, note_name_to_number,
                    note_number_to_name, program_to_family_name,
                    program_to_instrument_name)
from .smf import Instrument, MidiSong, Note
from .key_analysis import analyze_key, key_name_to_index

__all__ = [
    "GM_FAMILY_NAMES", "GM_INSTRUMENT_NAMES", "INSTRUMENT_MAP", "Instrument",
    "MidiSong", "Note", "analyze_key", "instrument_name_to_program",
    "key_name_to_index", "note_name_to_number", "note_number_to_name",
    "program_to_family_name", "program_to_instrument_name",
]
