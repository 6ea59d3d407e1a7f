"""Sentence segmentation — rule-based, no runtime downloads.

Replaces the reference's NLTK punkt use, which downloaded the model at call
time inside the request path (emotion_analysis/data_preprocessing.py:5-11).
A compiled-regex splitter handles the common abbreviation / decimal /
ellipsis cases; same list-of-sentences contract.
"""

from __future__ import annotations

import re

_ABBREVIATIONS = {
    "mr", "mrs", "ms", "dr", "prof", "sr", "jr", "st", "vs", "etc", "e.g",
    "i.e", "inc", "ltd", "co", "corp", "dept", "fig", "al", "approx",
}

_BOUNDARY = re.compile(r"([.!?]+)(\s+|$)")


def segment_text(text: str) -> list[str]:
    """Break text into sentences. Same contract as the reference's
    ``segment_text`` (data_preprocessing.py:5-11)."""
    text = text.strip()
    if not text:
        return []
    sentences: list[str] = []
    start = 0
    for m in _BOUNDARY.finditer(text):
        end = m.end(1)
        candidate = text[start:end].strip()
        # don't split after known abbreviations or single initials
        last_word = candidate.rsplit(" ", 1)[-1].rstrip(".!?").lower()
        if m.group(1) == "." and (last_word in _ABBREVIATIONS
                                  or len(last_word) == 1):
            continue
        # don't split inside decimals like 3.14
        if (m.group(1) == "." and m.end() < len(text)
                and text[m.end() - len(m.group(2))].isdigit()):
            continue
        if candidate:
            sentences.append(candidate)
        start = m.end()
    tail = text[start:].strip()
    if tail:
        sentences.append(tail)
    return sentences
