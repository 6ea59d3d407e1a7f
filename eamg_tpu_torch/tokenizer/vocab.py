"""Vocabulary container shared by all token schemes.

The reference persists vocabularies as a plain ``tok2id`` dict inside each
checkpoint (train/train_mini.py:82, train/train_large.py:156-161). Two
construction dialects exist and both are reproduced here:

- ``from_sequences(..., pad_last=True)`` — train_mini dialect: sorted unique
  tokens from data, then ``[PAD]`` appended *after* with id == len(vocab)
  (train/train_mini.py:26-31).
- ``from_sequences(..., pad_last=False)`` — train_large dialect: ``[PAD]``
  is a member of the set before sorting, so it lands at its sorted position
  (train/train_large.py:61-77).
"""

from __future__ import annotations

from dataclasses import dataclass, field


@dataclass
class Vocab:
    tok2id: dict[str, int]
    id2tok: dict[int, str] = field(default=None)

    def __post_init__(self):
        if self.id2tok is None:
            self.id2tok = {i: t for t, i in self.tok2id.items()}

    def __len__(self) -> int:
        return len(self.tok2id)

    def __contains__(self, token: str) -> bool:
        return token in self.tok2id

    def encode(self, tokens: list[str]) -> list[int]:
        return [self.tok2id[t] for t in tokens]

    def decode(self, ids) -> list[str]:
        return [self.id2tok[int(i)] for i in ids]

    def get(self, token: str, default: int = -1) -> int:
        return self.tok2id.get(token, default)

    @property
    def pad_id(self) -> int:
        return self.tok2id["[PAD]"]

    @classmethod
    def from_sequences(cls, sequences, pad_last: bool = False) -> "Vocab":
        """Build a data-dependent vocabulary (Scheme A / Scheme B v1).

        pad_last=True reproduces train_mini.py:26-31 (PAD appended after the
        sort); pad_last=False reproduces train_large.py:61-77 (PAD sorted in).
        """
        tokens = set()
        for seq in sequences:
            tokens.update(seq)
        if pad_last:
            tok2id = {t: i for i, t in enumerate(sorted(tokens))}
            tok2id["[PAD]"] = len(tok2id)
        else:
            tokens.add("[PAD]")
            tok2id = {t: i for i, t in enumerate(sorted(tokens))}
        return cls(tok2id)

    @classmethod
    def from_list(cls, tokens: list[str]) -> "Vocab":
        """Fixed-order vocabulary (Scheme B v2/v3, train_large2.py:23-29)."""
        return cls({t: i for i, t in enumerate(tokens)})
