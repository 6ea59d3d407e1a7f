"""Emotion layer: classification + EATS music-parameter mapping."""

from .config import ID2LABEL, LABEL2ID, NUM_LABELS
from .eats import EATS, get_music_params, load_table
from .infer import EmotionClassifier
from .segment import segment_text

__all__ = ["EATS", "EmotionClassifier", "ID2LABEL", "LABEL2ID", "NUM_LABELS",
           "get_music_params", "load_table", "segment_text"]
