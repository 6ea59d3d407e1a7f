"""Per-section emotion-adaptivity metric: does each generated section obey
its own section's controls?

Port of ``eamg_tpu/tools/section_metrics.py``. For every multi-emotion
prompt, each sentence is classified, mapped (EATS, a seed per section) and
decoded with its own (BPM, key) by the pipeline's decode
(``Pipeline._decode``, JAX's ``_decode_for_mapping``), and its notes are
scored:

- ``bpm_obedience``: the share of the section's onsets on its prompted
  BPM's half-beat grid;
- ``key_obedience``: the share of its pitches inside the prompted key;
- ``bpm_discrimination``: over section pairs of a prompt whose grids are
  not nested, how often a section fits its own grid strictly better than
  its sibling's;
- ``key_discrimination``: the same over pairs with different key scales;
- ``classifier_intended_acc``: how often the classifier gave the label the
  sentence was drawn for.
"""

from __future__ import annotations

import random

from ..emotion.segment import segment_text
from ..tokenizer.scheme_a import NOTE_RE
from ..train.data import key_scale_pitches

# multi-emotion prompt material: short sentences with STRONG per-label
# cues (the metric measures music-obeys-controls; classifier hits are
# reported separately). Drawn per prompt with distinct labels.
_SENTENCES = {
    "joy": "we are so happy and overjoyed today.",
    "sadness": "i feel so sad and heartbroken tonight.",
    "anger": "i am furious and enraged about this.",
    "fear": "i am terrified and scared of the dark.",
    "excitement": "this is so exciting, i am thrilled!",
    "relief": "what a relief, i can relax now.",
    "love": "i love you with all my heart.",
    "gratitude": "thank you so much, i am deeply grateful.",
    "surprise": "wow, what a surprise, i did not expect that!",
    "nervousness": "i am anxious and nervous about tomorrow.",
}


def _grid_fit(tokens: list[str], bpm: float, key: str,
              tol: float = 2e-3) -> tuple[float, float, int]:
    """(on-grid fraction, in-key fraction, n_notes) for one section."""
    half_beat = 60.0 / bpm / 2.0
    scale = {p[:-1] for p in key_scale_pitches(key, degrees=14)}
    on_grid = in_key = n = 0
    for tok in tokens:
        m = NOTE_RE.match(tok)
        if not m:
            continue
        n += 1
        start = float(m.group(2))
        frac = start / half_beat
        if abs(frac - round(frac)) * half_beat < tol:
            on_grid += 1
        if m.group(1)[:-1] in scale:
            in_key += 1
    if n == 0:
        return 0.0, 0.0, 0
    return on_grid / n, in_key / n, n


def _prompted_controls(gen_prompt: list[str]) -> tuple[float, str]:
    """(bpm, key) actually in the section's prompt tokens."""
    bpm, key = 120.0, "C major"
    for t in gen_prompt:
        if t.startswith("[BPM] "):
            bpm = float(t.split(" ", 1)[1])
        elif t.startswith("[KEY_SIGNATURE] "):
            key = t.split(" ", 1)[1]
    return bpm, key


def _grids_nested(bpm_a: float, bpm_b: float) -> bool:
    """True when one BPM's half-beat grid contains the other's (every
    onset of the coarser grid lies on the finer grid) — such pairs
    cannot discriminate."""
    r = max(bpm_a, bpm_b) / min(bpm_a, bpm_b)
    return abs(r - round(r)) < 1e-9


def measure_section_obedience(pipe, n_prompts: int = 50, seed: int = 0,
                              sentences_per_prompt: tuple = (2, 3),
                              temperature: float = 1.0,
                              top_k: int = 50) -> dict:
    """Run ``n_prompts`` multi-emotion prompts through the pipeline's
    per-section decode and score every section against its own controls.
    Sections are decoded exactly as generate_sections does (same
    classifier, EATS seed discipline, and ``Pipeline._decode``), but kept
    separate so each is scored against its own mapping."""
    from ..emotion import get_music_params

    rng = random.Random(seed)
    labels_pool = sorted(_SENTENCES)
    per_section = []
    pair_bpm_hits = pair_bpm_total = 0
    pair_key_hits = pair_key_total = 0
    label_hits = label_total = 0
    for pi in range(n_prompts):
        k = rng.randint(*sentences_per_prompt)
        intended = rng.sample(labels_pool, k)
        prompt_text = " ".join(_SENTENCES[l] for l in intended)
        segments = segment_text(prompt_text)
        secs = []
        for i, seg in enumerate(segments):
            label = pipe.classifier.predict(seg)
            if i < len(intended):
                label_total += 1
                label_hits += int(label == intended[i])
            mapping = get_music_params(label, seed=seed * 1000 + pi * 10
                                       + i)
            run_seed = seed * 1000 + pi * 10 + i
            gp, tokens, _song, _drop = pipe._decode(
                mapping, temperature, top_k, run_seed, 1.0, 0.0)
            bpm, key = _prompted_controls(gp)
            g, ky, n = _grid_fit(tokens, bpm, key)
            secs.append({"label": label, "bpm": bpm, "key": key,
                         "grid": g, "in_key": ky, "n_notes": n,
                         "tokens": tokens})
        for i, a in enumerate(secs):
            if a["n_notes"] == 0:
                continue
            per_section.append({k: v for k, v in a.items()
                                if k != "tokens"})
            for b in secs[i + 1:]:
                if a["bpm"] != b["bpm"] \
                        and not _grids_nested(a["bpm"], b["bpm"]):
                    # a's notes must fit a's grid strictly better than
                    # b's grid (and symmetrically)
                    ga_own = a["grid"]
                    ga_other = _grid_fit(a["tokens"], b["bpm"],
                                         a["key"])[0]
                    pair_bpm_total += 1
                    pair_bpm_hits += int(ga_own > ga_other)
                if a["key"] != b["key"]:
                    scale_a = set(key_scale_pitches(a["key"], degrees=14))
                    scale_b = set(key_scale_pitches(b["key"], degrees=14))
                    if scale_a != scale_b:
                        ka_own = a["in_key"]
                        ka_other = _grid_fit(a["tokens"], a["bpm"],
                                             b["key"])[1]
                        pair_key_total += 1
                        pair_key_hits += int(ka_own >= ka_other)
    n = max(len(per_section), 1)
    return {
        "n_prompts": n_prompts,
        "n_sections": len(per_section),
        "bpm_obedience": round(
            sum(s["grid"] for s in per_section) / n, 4),
        "key_obedience": round(
            sum(s["in_key"] for s in per_section) / n, 4),
        "bpm_discrimination": round(
            pair_bpm_hits / pair_bpm_total, 4) if pair_bpm_total else None,
        "bpm_discrimination_pairs": pair_bpm_total,
        "key_discrimination": round(
            pair_key_hits / pair_key_total, 4) if pair_key_total else None,
        "key_discrimination_pairs": pair_key_total,
        "classifier_intended_acc": round(label_hits / label_total, 4)
        if label_total else None,
        "mean_notes_per_section": round(
            sum(s["n_notes"] for s in per_section) / n, 1),
    }
