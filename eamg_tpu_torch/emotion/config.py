"""Emotion label space: the 28 GoEmotions labels.

Same id->label table as reference emotion_analysis/config.py:5-36 (the label
order is the GoEmotions dataset contract, which trained checkpoints depend
on).
"""

ID2LABEL = {
    0: "admiration", 1: "amusement", 2: "anger", 3: "annoyance",
    4: "approval", 5: "caring", 6: "confusion", 7: "curiosity", 8: "desire",
    9: "disappointment", 10: "disapproval", 11: "disgust",
    12: "embarrassment", 13: "excitement", 14: "fear", 15: "gratitude",
    16: "grief", 17: "joy", 18: "love", 19: "nervousness", 20: "optimism",
    21: "pride", 22: "realization", 23: "relief", 24: "remorse",
    25: "sadness", 26: "surprise", 27: "neutral",
}

LABEL2ID = {v: k for k, v in ID2LABEL.items()}
NUM_LABELS = 28
