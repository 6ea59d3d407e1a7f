"""Emotion layer: classification + EATS music-parameter mapping."""

from .config import ID2LABEL, LABEL2ID, NUM_LABELS
from .eats import EATS, get_music_params, load_table
from .infer import EmotionClassifier, default_classifier, predict
from .segment import segment_text

__all__ = ["EATS", "EmotionClassifier", "ID2LABEL", "LABEL2ID", "NUM_LABELS",
           "default_classifier", "get_music_params", "load_table", "predict",
           "segment_text"]
