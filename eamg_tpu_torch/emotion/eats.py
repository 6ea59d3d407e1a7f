"""EATS — Emotion-Adaptive Theory mapping: emotion label -> music params.

Re-implements reference emotion_analysis/EATS.py:10-42 on the same
``lookup_table.csv`` (28 emotions x {bpm_min, bpm_max, key, scale_type,
instrument_families}); the table's quirks — '♭' unicode in keys, U+00A0 in
"Chromatic Percussion" — are preserved because the prompt-assembly layer
keys off them (api_cache.py:145-156).

Unlike the reference (module-global unseeded ``random``, EATS.py:27-28), the
BPM draw and family choice take an explicit seedable RNG so serving runs are
reproducible; the draw semantics (``randint`` inclusive bounds, uniform
family choice) are identical.
"""

from __future__ import annotations

import csv
import json
import os
import random
from typing import Union

LOOKUP_PATH = os.path.join(os.path.dirname(__file__), "lookup_table.csv")


def load_table(path: str = LOOKUP_PATH) -> dict:
    table = {}
    with open(path, newline="", encoding="utf-8") as f:
        for row in csv.DictReader(f):
            table[row["emotion"]] = {
                "bpm_min": int(row["bpm_min"]),
                "bpm_max": int(row["bpm_max"]),
                "key": row["key"],
                "scale_type": row["scale_type"],
                "instrument_families": json.loads(
                    row["instrument_families"]),
            }
    return table


EATS = load_table()

_default_rng = random.Random()


def _params_for_label(label: str, rng: random.Random | None = None) -> dict:
    rng = rng or _default_rng
    label_lc = label.lower()
    if label_lc not in EATS:
        raise ValueError(f"Emotion '{label}' not in lookup table")
    entry = EATS[label_lc]
    bpm = rng.randint(entry["bpm_min"], entry["bpm_max"])
    inst_family = rng.choice(entry["instrument_families"])
    return {
        "emotion": label_lc,
        "bpm": bpm,
        "key": entry["key"],
        "scale_type": entry["scale_type"],
        "inst_family": inst_family,
        "all_families": entry["instrument_families"],
    }


def get_music_params(emotions: Union[str, list, tuple],
                     seed: int | None = None):
    """str or list of labels -> mapping dict(s) (EATS.py:39-42 contract)."""
    rng = random.Random(seed) if seed is not None else _default_rng
    if isinstance(emotions, str):
        return _params_for_label(emotions, rng)
    return [_params_for_label(lab, rng) for lab in emotions]
