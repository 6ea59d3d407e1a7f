"""Emotion inference: the reference's four prediction modes plus
segment-wise transition analysis, backed by the DistilBERT checkpoint the
JAX package ships (read by path) or, when none is found, the deterministic
lexicon.

Port of ``eamg_tpu/emotion/infer.py``: ``EmotionClassifier``, with its
per-text memo of probabilities, and the module-level ``default_classifier``
and ``predict`` (the reference's ``inference.predict``), one classifier a
device.
"""

from __future__ import annotations

import os
import pickle
import threading
from pathlib import Path

import numpy as np
import torch

from ..models import distilbert as db
from ..utils.device import resolve_device
from .config import ID2LABEL
from .lexicon import predict_label as _lex_predict, scores as _lex_scores
from .segment import segment_text

# the JAX package's shipped classifier, read as data (never imported)
PACKAGED_CKPT = (Path(__file__).resolve().parents[2] / "eamg_tpu"
                 / "emotion" / "ckpt_distilbert")


def _packaged_ckpt_dir() -> str:
    d = PACKAGED_CKPT
    return str(d) if (d / "params.pkl").is_file() else ""


def _tree_to_f32(tree, device):
    if isinstance(tree, dict):
        return {k: _tree_to_f32(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_tree_to_f32(v, device) for v in tree]
    a = np.asarray(tree)
    t = torch.from_numpy(np.array(a, copy=True))
    if np.issubdtype(a.dtype, np.floating):
        t = t.float()
    return t.to(device)


class EmotionClassifier:
    """predict / predict_all_labels / predict_top_k_labels /
    predict_labels_above_threshold / analyze_emotion_transitions.
    ``device`` None means CUDA (raises without a card)."""

    def __init__(self, backend: str = "auto",
                 checkpoint_dir: str | None = None, max_length: int = 128,
                 device=None):
        self.device = resolve_device(device)
        self.max_length = max_length
        checkpoint_dir = (checkpoint_dir
                          or os.environ.get("EAMG_EMOTION_CKPT", "")
                          or _packaged_ckpt_dir())
        self.backend = backend
        self._params = self._cfg = self._tok = None
        self._probs_cache: dict[str, np.ndarray] = {}
        self._lock = threading.Lock()
        if backend in ("auto", "distilbert") and checkpoint_dir and \
                os.path.isdir(checkpoint_dir):
            self._load_distilbert(checkpoint_dir)
            self.backend = "distilbert"
        elif backend == "distilbert":
            raise FileNotFoundError(
                "distilbert backend requested but no checkpoint dir found")
        else:
            self.backend = "lexicon"

    def _load_distilbert(self, ckpt_dir: str) -> None:
        with open(os.path.join(ckpt_dir, "config.pkl"), "rb") as f:
            self._cfg = db.DistilBertConfig(**pickle.load(f))
        with open(os.path.join(ckpt_dir, "params.pkl"), "rb") as f:
            raw = pickle.load(f)
        # stored f16 to stay small; computed in f32
        self._params = _tree_to_f32(raw, self.device)
        self._tok = db.WordPieceTokenizer(
            os.path.join(ckpt_dir, "vocab.txt"))
        self.max_length = min(self.max_length,
                              self._cfg.max_position_embeddings)

    def _probs(self, text: str) -> np.ndarray:
        if self.backend == "lexicon":
            sc = _lex_scores(text)
            return np.asarray([sc[ID2LABEL[i]] for i in range(len(ID2LABEL))])
        cached = self._probs_cache.get(text)
        if cached is not None:
            return cached
        enc = self._tok.encode(text, self.max_length)
        ids = torch.from_numpy(enc["input_ids"]).long()[None].to(self.device)
        mask = torch.from_numpy(enc["attention_mask"])[None].to(self.device)
        logits = db.forward(self._params, ids, mask, self._cfg)
        probs = torch.softmax(logits[0], dim=-1).cpu().numpy()
        with self._lock:   # bounded FIFO memo, shared by server threads
            if len(self._probs_cache) >= 512:
                self._probs_cache.pop(next(iter(self._probs_cache)))
            self._probs_cache[text] = probs
        return probs

    def predict(self, text: str) -> str:
        """Argmax label (inference.py:12-22)."""
        if self.backend == "lexicon":
            return _lex_predict(text)
        return ID2LABEL[int(np.argmax(self._probs(text)))]

    def predict_all_labels(self, text: str) -> dict:
        """{label: score rounded 4dp} (inference.py:26-38)."""
        probs = self._probs(text)
        return {ID2LABEL[i]: round(float(p), 4) for i, p in enumerate(probs)}

    def predict_top_k_labels(self, text: str, k: int = 3) -> list:
        """[(label, score)] top-k, descending (inference.py:41-60)."""
        probs = self._probs(text)
        idx = np.argsort(-probs, kind="stable")[:k]
        return [(ID2LABEL[int(i)], round(float(probs[i]), 4)) for i in idx]

    def predict_labels_above_threshold(self, text: str,
                                       threshold: float = 0.2) -> list:
        """[(label, score)] with score > threshold, in id order
        (inference.py:62-80)."""
        probs = self._probs(text)
        return [(ID2LABEL[i], round(float(p), 4))
                for i, p in enumerate(probs) if float(p) > threshold]

    def analyze_emotion_transitions(self, text: str) -> list:
        """[(segment, label)] per sentence (inference.py:83-94)."""
        return [(seg, self.predict(seg)) for seg in segment_text(text)]


_defaults: dict = {}
_defaults_lock = threading.Lock()


def default_classifier(device=None) -> EmotionClassifier:
    """The process's classifier on ``device`` (None means CUDA), made at
    its first use."""
    dev = resolve_device(device)
    with _defaults_lock:
        if dev not in _defaults:
            _defaults[dev] = EmotionClassifier(device=dev)
        return _defaults[dev]


def predict(text: str, device=None) -> str:
    """Module-level convenience mirroring ``inference.predict``."""
    return default_classifier(device).predict(text)
