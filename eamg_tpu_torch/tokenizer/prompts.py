"""Prompt construction: EATS mapping -> Scheme-A control-token prompt.

Reproduces api_cache.py:140-156 and :194-203 — ``closest_bpm_token``,
``normalize_key_signature`` (♭->'-', ♯->'#', lowercased mode) and the
family->instrument restriction. The reference maps only three families
(everything else silently dropped, api_cache.py:152-156); that behavior is
the default here, with a complete GM family map available behind
``full_gm=True``.
"""

from __future__ import annotations

from .vocab import Vocab

START = "[START_SEQUENCE]"

# Exact reference mapping (api_cache.py:152-156).
FAMILY_TO_INSTRUMENTS: dict[str, list[str]] = {
    "Strings": ["Violin"],
    "Piano": ["Acoustic Grand Piano"],
    "Woodwind": ["Flute"],
}

# Complete mapping covering every family that appears in lookup_table.csv
# (opt-in; the reference dropped these on the floor).
FULL_FAMILY_TO_INSTRUMENTS: dict[str, list[str]] = {
    "Strings": ["Violin"],
    "Piano": ["Acoustic Grand Piano"],
    "Woodwind": ["Flute"],
    "Drums": ["Taiko Drum"],
    "Guitar": ["Acoustic Guitar (nylon)"],
    "Brass": ["Trumpet"],
    "Bass": ["Acoustic Bass"],
    "Synth": ["Lead 2 (sawtooth)"],
    "Chromatic Percussion": ["Vibraphone"],
    # lookup_table.csv spells this family with a non-breaking space
    "Chromatic Percussion": ["Vibraphone"],
}


def closest_bpm_token(vocab: Vocab, val: float) -> str:
    """Nearest ``[BPM] x`` token in the vocabulary (api_cache.py:142-144)."""
    bpm_toks = [t for t in vocab.tok2id if t.startswith("[BPM]")]
    if not bpm_toks:
        raise ValueError("vocabulary has no [BPM] tokens")
    return min(bpm_toks, key=lambda s: abs(float(s.split()[-1]) - val))


def normalize_key_signature(key_string: str) -> str:
    """``"E♭ Major"`` -> ``"[KEY_SIGNATURE] E- major"`` (api_cache.py:145-151)."""
    key_string = key_string.replace("♭", "-").replace("♯", "#")
    parts = key_string.strip().split()
    if len(parts) == 2:
        key, scale = parts
        return f"[KEY_SIGNATURE] {key} {scale.lower()}"
    return f"[KEY_SIGNATURE] {key_string}"


def instruments_for_families(families: list[str],
                             full_gm: bool = False) -> list[str]:
    table = FULL_FAMILY_TO_INSTRUMENTS if full_gm else FAMILY_TO_INSTRUMENTS
    out: list[str] = []
    for fam in families:
        out.extend(table.get(fam, []))
    return out


def assemble_prompt(vocab: Vocab, mapping: dict,
                    full_gm: bool = False) -> list[str]:
    """EATS mapping dict -> Scheme-A prompt token list (api_cache.py:194-203).

    ``mapping`` is the dict produced by ``eamg_tpu_torch.emotion.eats``:
    {"bpm", "key", "all_families", ...}.
    """
    bpm_tok = closest_bpm_token(vocab, mapping["bpm"])
    key_tok = normalize_key_signature(mapping["key"])
    instruments = instruments_for_families(mapping["all_families"], full_gm)
    return [START, bpm_tok, key_tok] + [f"[INSTRUMENT] {i}"
                                        for i in instruments]
