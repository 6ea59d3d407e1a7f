"""Evaluation metrics of the paper's §10.4 table.

Port of ``eamg_tpu/tools/metrics.py`` (host code): ``estimate_bpm`` (the
modal inter-onset interval, folded into [40, 250] BPM; where newer numpy
refuses to bin a range of a few ulps, the median interval, which older
numpy's zero-width bins give too), ``tempo_mse``
(the mean squared relative tempo error, beat/half/double time folded out;
"MSE-Tune") and ``classification_accuracy``. Perplexity is
``decode/replay.py::perplexity``.
"""

from __future__ import annotations

import numpy as np

from ..midi.smf import MidiSong


def estimate_bpm(song: MidiSong, min_bpm: float = 40.0,
                 max_bpm: float = 250.0) -> float | None:
    """Estimate tempo from note onsets: the dominant inter-onset interval
    (mode of quantized IOIs) is taken as the beat or an integer
    subdivision; folded into [min_bpm, max_bpm]."""
    onsets = sorted({round(n.start, 3) for inst in song.instruments
                     for n in inst.notes})
    if len(onsets) < 4:
        return None
    iois = np.diff(onsets)
    iois = iois[(iois > 0.02) & (iois < 4.0)]
    if len(iois) == 0:
        return None
    # histogram over log-spaced bins; pick the modal interval
    try:
        hist, edges = np.histogram(iois, bins=48)
        mode = (edges[hist.argmax()] + edges[hist.argmax() + 1]) / 2
    except ValueError:
        # newer numpy refuses 48 bins over a range of a few ulps (all
        # intervals equal but for rounding), where older numpy returns
        # bins of width ~0: the mode is then that interval
        mode = float(np.median(iois))
    bpm = 60.0 / mode
    while bpm > max_bpm:
        bpm /= 2.0
    while bpm < min_bpm:
        bpm *= 2.0
    return float(bpm)


def tempo_mse(pairs: list[tuple[float, float | None]]) -> float:
    """Mean squared *relative* tempo error over (target_bpm,
    estimated_bpm) pairs; beat/half/double-time ambiguity folded out.
    Pairs with no estimate are skipped."""
    errs = []
    for target, est in pairs:
        if est is None:
            continue
        candidates = [est, est * 2, est / 2]
        rel = min(abs(c - target) / target for c in candidates)
        errs.append(rel ** 2)
    return float(np.mean(errs)) if errs else float("nan")


def classification_accuracy(predict_fn, texts: list[str],
                            labels: list[int], id2label: dict) -> float:
    hits = sum(predict_fn(t) == id2label[l]
               for t, l in zip(texts, labels))
    return hits / max(len(texts), 1)
