"""Host-side token layers (copied from the JAX package): Scheme A (text)
and Scheme B v1/v2/v3 (compact)."""

from .vocab import Vocab
from .scheme_a import (END, NOTE_RE, PAD, START, extract_data, midi_tokenize,
                       tokens_to_song)
from .scheme_b import (NOTE_PAT_SECS, SchemeB1, SchemeB2, SchemeB3,
                       detect_scheme, key_to_idx, pitch_to_midi)
from .prompts import (FAMILY_TO_INSTRUMENTS, FULL_FAMILY_TO_INSTRUMENTS,
                      assemble_prompt, closest_bpm_token,
                      instruments_for_families, normalize_key_signature)

__all__ = [
    "END", "FAMILY_TO_INSTRUMENTS", "FULL_FAMILY_TO_INSTRUMENTS", "NOTE_RE",
    "NOTE_PAT_SECS", "PAD", "START", "SchemeB1", "SchemeB2", "SchemeB3",
    "Vocab", "assemble_prompt", "closest_bpm_token", "detect_scheme",
    "extract_data", "instruments_for_families", "key_to_idx",
    "midi_tokenize", "normalize_key_signature", "pitch_to_midi",
    "tokens_to_song",
]
