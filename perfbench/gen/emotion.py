"""Scheme-A requests as the page makes them: a GoEmotions label, its EATS
mapping and the control tokens assembled from it.

A frozen copy of the program's ``emotion/eats.py`` (``lookup_table.csv``
is copied beside it under ``perfbench/data/``) and ``tokenizer/prompts.py``
(``assemble_prompt`` with the reference's three-family instrument map), so
that a later change to the program cannot move the traffic.
"""

from __future__ import annotations

import csv
import json
import os
import random

LOOKUP = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "data", "lookup_table.csv")

START = "[START_SEQUENCE]"
FAMILY_TO_INSTRUMENTS = {"Strings": ["Violin"],
                         "Piano": ["Acoustic Grand Piano"],
                         "Woodwind": ["Flute"]}


def load_table(path: str = LOOKUP) -> dict:
    table = {}
    with open(path, newline="", encoding="utf-8") as f:
        for row in csv.DictReader(f):
            table[row["emotion"]] = {
                "bpm_min": int(row["bpm_min"]),
                "bpm_max": int(row["bpm_max"]),
                "key": row["key"],
                "instrument_families": json.loads(
                    row["instrument_families"])}
    return table


def music_params(table: dict, label: str, seed: int) -> dict:
    """EATS: the label's BPM drawn in its range and its families."""
    rng = random.Random(seed)
    e = table[label]
    bpm = rng.randint(e["bpm_min"], e["bpm_max"])
    rng.choice(e["instrument_families"])
    return {"bpm": bpm, "key": e["key"],
            "all_families": e["instrument_families"]}


def _key_token(key: str) -> str:
    key = key.replace("♭", "-").replace("♯", "#")
    parts = key.strip().split()
    if len(parts) == 2:
        return f"[KEY_SIGNATURE] {parts[0]} {parts[1].lower()}"
    return f"[KEY_SIGNATURE] {key}"


def prompt_tokens(tok2id: dict, mapping: dict) -> list:
    """The assembled control tokens that the vocabulary holds."""
    bpms = [t for t in tok2id if t.startswith("[BPM]")]
    bpm = min(bpms, key=lambda s: abs(float(s.split()[-1]) - mapping["bpm"]))
    inst = [f"[INSTRUMENT] {i}" for fam in mapping["all_families"]
            for i in FAMILY_TO_INSTRUMENTS.get(fam, [])]
    return [t for t in [START, bpm, _key_token(mapping["key"]), *inst]
            if t in tok2id]


class LabelDraw:
    """GoEmotions labels drawn Zipf (exponent ``s``) over the table's 28
    labels, ranked in an order fixed by the seed."""

    def __init__(self, table: dict, rng: random.Random, s: float = 1.0):
        self.labels = sorted(table)
        rng.shuffle(self.labels)
        self.weights = [1.0 / (k + 1) ** s for k in range(len(self.labels))]

    def __call__(self, rng: random.Random) -> str:
        return rng.choices(self.labels, weights=self.weights)[0]
