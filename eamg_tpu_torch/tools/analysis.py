"""Corpus analysis: the key-signature and instrument histograms of a
corpus CSV's ``tokens`` column (the paper's Tables 1-2), and their report.

Port of ``eamg_tpu/tools/analysis.py`` (host code).
"""

from __future__ import annotations

import collections
import json

from ..train.data import iter_csv_tokens


def analyze_corpus(csv_path: str, max_rows: int | None = 20_000) -> dict:
    key_counts: collections.Counter = collections.Counter()
    inst_counts: collections.Counter = collections.Counter()
    rows = 0
    for js in iter_csv_tokens(csv_path, max_rows=max_rows):
        rows += 1
        for tok in json.loads(js):
            if tok.startswith("[KEY_SIGNATURE]"):
                key_counts[tok.split("]", 1)[1].strip()] += 1
            elif tok.startswith("[INSTRUMENT]"):
                inst_counts[tok.split("]", 1)[1].strip()] += 1
    return {"rows": rows, "key_signatures": dict(key_counts),
            "instruments": dict(inst_counts)}


def write_report(stats: dict, out_path: str) -> None:
    with open(out_path, "w", encoding="utf-8") as f:
        f.write(f"rows analyzed: {stats['rows']}\n\n")
        f.write("Key Signature Counts:\n")
        for k, c in sorted(stats["key_signatures"].items(),
                           key=lambda kv: -kv[1]):
            f.write(f"  {k}: {c}\n")
        f.write("\nInstrument Counts:\n")
        for k, c in sorted(stats["instruments"].items(),
                           key=lambda kv: -kv[1]):
            f.write(f"  {k}: {c}\n")
