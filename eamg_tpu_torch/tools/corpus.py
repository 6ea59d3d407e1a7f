"""The corpus tool: a directory of .mid files -> the training CSV
(``file, key_signature, tokens``), each file through the Scheme-A
tokenizer.

Port of ``eamg_tpu/tools/corpus.py`` (host code).
"""

from __future__ import annotations

import csv
import json
import os
from pathlib import Path

from ..tokenizer import midi_tokenize


def build_corpus_csv(midi_dir: str, out_csv: str,
                     max_files: int | None = None,
                     on_error: str = "skip", log_fn=None) -> dict:
    """Returns {"written": n, "failed": m}."""
    paths = sorted(Path(midi_dir).rglob("*.mid")) + \
        sorted(Path(midi_dir).rglob("*.midi"))
    if max_files is not None:
        paths = paths[:max_files]
    written = failed = 0
    with open(out_csv, "w", newline="", encoding="utf-8") as f:
        w = csv.writer(f)
        w.writerow(["file", "key_signature", "tokens"])
        for p in paths:
            try:
                tokens = midi_tokenize(str(p))
                key = next((t.split("]", 1)[1].strip() for t in tokens
                            if t.startswith("[KEY_SIGNATURE]")), "")
                w.writerow([os.path.basename(p), key, json.dumps(tokens)])
                written += 1
                if log_fn and written % 100 == 0:
                    log_fn(f"[corpus] {written}/{len(paths)}")
            except Exception as exc:
                failed += 1
                if on_error == "raise":
                    raise
                if log_fn:
                    log_fn(f"[corpus] skip {p}: {exc}")
    return {"written": written, "failed": failed}
