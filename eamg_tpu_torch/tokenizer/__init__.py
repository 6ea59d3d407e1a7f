"""Host-side Scheme-A token layer (copied from the JAX package)."""

from .vocab import Vocab
from .scheme_a import (END, NOTE_RE, PAD, START, extract_data, midi_tokenize,
                       tokens_to_song)
from .prompts import (FAMILY_TO_INSTRUMENTS, FULL_FAMILY_TO_INSTRUMENTS,
                      assemble_prompt, closest_bpm_token,
                      instruments_for_families, normalize_key_signature)

__all__ = [
    "END", "FAMILY_TO_INSTRUMENTS", "FULL_FAMILY_TO_INSTRUMENTS", "NOTE_RE",
    "PAD", "START", "Vocab", "assemble_prompt", "closest_bpm_token",
    "detect_scheme", "extract_data", "instruments_for_families",
    "midi_tokenize", "normalize_key_signature", "tokens_to_song",
]


def detect_scheme(vocab) -> str:
    """The token scheme a checkpoint was trained with, from its vocabulary
    (same rules as the JAX package's tokenizer/scheme_b.py). Only Scheme A
    is served by the port so far."""
    if "BPM_20" in vocab and "KEY_0" in vocab:
        return "b3"
    if "P_0" in vocab and "T_0" in vocab:
        return "b2"
    if "[START_T]" in vocab or "[DUR_T]" in vocab:
        return "b1"
    return "a"
