"""Deterministic lexicon fallback classifier over the 28 GoEmotions labels.

The reference serves a LoRA-finetuned DistilBERT pulled from the HF Hub at
import time (emotion_analysis/modeling.py:14-21) — a network dependency in
the request path. In environments without the checkpoint this keyword
scorer keeps the full pipeline functional and deterministic; when weights
are available the Flax DistilBERT (models/distilbert.py) is used instead.

Scoring: bag-of-words keyword hits per label, normalized; softmax-shaped
scores so the same predict_* API surface works.
"""

from __future__ import annotations

import math
import re

from .config import ID2LABEL

_LEXICON: dict[str, list[str]] = {
    "admiration": ["admire", "impressive", "amazing", "wonderful", "brilliant",
                   "respect", "awesome", "incredible"],
    "amusement": ["funny", "hilarious", "lol", "haha", "amusing", "joke",
                  "laugh", "comedy"],
    "anger": ["angry", "furious", "rage", "mad", "hate", "outraged",
              "infuriating", "livid"],
    "annoyance": ["annoying", "irritating", "bothers", "annoyed", "ugh",
                  "frustrating", "nuisance"],
    "approval": ["agree", "approve", "right", "correct", "good idea", "yes",
                 "endorse", "support"],
    "caring": ["care", "caring", "comfort", "support you", "here for you",
               "look after", "tender", "gentle"],
    "confusion": ["confused", "confusing", "don't understand", "puzzled",
                  "unclear", "baffled", "lost"],
    "curiosity": ["curious", "wonder", "interesting", "intrigued", "why",
                  "how does", "what if"],
    "desire": ["want", "wish", "crave", "desire", "longing", "yearn",
               "hope for"],
    "disappointment": ["disappointed", "letdown", "let down", "expected more",
                       "underwhelming", "shame"],
    "disapproval": ["disapprove", "disagree", "wrong", "shouldn't",
                    "unacceptable", "object"],
    "disgust": ["disgusting", "gross", "revolting", "nasty", "sickening",
                "repulsive", "vile"],
    "embarrassment": ["embarrassed", "embarrassing", "awkward", "cringe",
                      "humiliated", "blush"],
    "excitement": ["excited", "thrilled", "can't wait", "exciting", "pumped",
                   "stoked", "hyped"],
    "fear": ["afraid", "scared", "terrified", "fear", "frightened", "horror",
             "dread", "panic", "scary", "scare"],
    "gratitude": ["thank", "thanks", "grateful", "gratitude", "appreciate",
                  "thankful"],
    "grief": ["grief", "mourning", "passed away", "loss", "funeral",
              "bereaved", "died"],
    "joy": ["happy", "joy", "delighted", "glad", "cheerful", "great day",
            "sunny", "wonderful day"],
    "love": ["love", "adore", "beloved", "in love", "cherish", "romantic",
             "sweetheart"],
    "nervousness": ["nervous", "anxious", "worried", "uneasy", "jittery",
                    "tense", "on edge"],
    "optimism": ["optimistic", "hopeful", "looking forward", "bright future",
                 "things will", "better days"],
    "pride": ["proud", "pride", "accomplished", "achievement", "triumph"],
    "realization": ["realized", "realize", "it turns out", "now i see",
                    "suddenly understood", "dawned on"],
    "relief": ["relieved", "relief", "finally over", "phew", "at ease",
               "weight off"],
    "remorse": ["sorry", "regret", "remorse", "apologize", "my fault",
                "guilt", "ashamed"],
    "sadness": ["sad", "unhappy", "depressed", "crying", "tears", "miserable",
                "heartbroken", "lonely"],
    "surprise": ["surprised", "unexpected", "wow", "can't believe",
                 "astonished", "shocking", "out of nowhere"],
    "neutral": [],
}

_WORD_RE = re.compile(r"[a-z']+")


def scores(text: str) -> dict[str, float]:
    """Softmax-shaped label scores from keyword hits; uniform-ish prior on
    'neutral' so empty hits resolve there."""
    low = text.lower()
    words = set(_WORD_RE.findall(low))
    raw = {}
    for label, keys in _LEXICON.items():
        s = 0.0
        for k in keys:
            if " " in k or "'" in k:
                if k in low:
                    s += 2.0
            elif k in words:
                s += 2.0
            elif any(w.startswith(k) for w in words):
                s += 1.0
        raw[label] = s
    raw["neutral"] = 0.5  # prior
    z = [raw[ID2LABEL[i]] for i in range(len(ID2LABEL))]
    m = max(z)
    exps = [math.exp(v - m) for v in z]
    total = sum(exps)
    return {ID2LABEL[i]: exps[i] / total for i in range(len(ID2LABEL))}


def predict_label(text: str) -> str:
    sc = scores(text)
    # deterministic argmax with label-id tie-break (matches torch.argmax's
    # first-max behavior over the id ordering)
    best = max(range(len(ID2LABEL)),
               key=lambda i: (sc[ID2LABEL[i]], -i))
    return ID2LABEL[best]
