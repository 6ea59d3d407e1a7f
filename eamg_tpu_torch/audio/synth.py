"""MIDI -> waveform: the additive synthesizer, on the device.

Port of ``eamg_tpu/audio/synth.py``: every note is a bank of up to 8
harmonics under an ADSR envelope, rendered as a [notes, D] tile and added
onto the timeline; drums are shaped noise drawn from the threefry port
with the JAX package's keys (one ``split`` per chunk of 256 notes), so the
waveform matches the JAX render.

Two things differ from the JAX program, neither in its values: padded note
slots (silent in JAX) are not rendered, and drum noise is drawn only for
drum rows (in partitionable threefry each element's bits depend on its
own index alone). Tiles are added onto the timeline note by note, in a
fixed order, so a render is deterministic on the card (an atomic
scatter-add would not be).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..midi.smf import MidiSong
from ..utils import prng
from ..utils.device import resolve_device

SAMPLE_RATE = 22050
MAX_NOTE_SECONDS = 3.0
MAX_HARMONICS = 8
NOTES_PER_CHUNK = 256

# family index = GM program // 8: (harmonic amps[8], attack_s, decay_s,
# sustain_level, release_s) — the JAX package's table
_FAMILY_TIMBRES = {
    0: ([1.0, 0.55, 0.32, 0.2, 0.12, 0.07, 0.04, 0.02], 0.004, 0.9, 0.12,
        0.15),
    1: ([1.0, 0.0, 0.45, 0.0, 0.25, 0.0, 0.1, 0.0], 0.002, 0.6, 0.05, 0.2),
    2: ([0.9, 0.6, 0.5, 0.4, 0.3, 0.25, 0.2, 0.15], 0.02, 0.05, 0.9, 0.08),
    3: ([1.0, 0.6, 0.35, 0.22, 0.12, 0.07, 0.03, 0.02], 0.003, 0.7, 0.1,
        0.12),
    4: ([1.0, 0.5, 0.2, 0.08, 0.03, 0.01, 0.0, 0.0], 0.005, 0.5, 0.3, 0.1),
    5: ([1.0, 0.75, 0.55, 0.4, 0.3, 0.22, 0.15, 0.1], 0.08, 0.15, 0.8,
        0.25),
    6: ([1.0, 0.7, 0.5, 0.38, 0.28, 0.2, 0.14, 0.1], 0.12, 0.2, 0.85, 0.3),
    7: ([0.9, 1.0, 0.8, 0.6, 0.45, 0.3, 0.2, 0.12], 0.05, 0.1, 0.8, 0.15),
    8: ([1.0, 0.4, 0.7, 0.3, 0.45, 0.2, 0.25, 0.1], 0.04, 0.1, 0.8, 0.12),
    9: ([1.0, 0.25, 0.08, 0.03, 0.01, 0.0, 0.0, 0.0], 0.05, 0.1, 0.85,
        0.15),
    10: ([1.0, 0.9, 0.75, 0.6, 0.5, 0.4, 0.32, 0.25], 0.01, 0.05, 0.9,
         0.08),
    11: ([1.0, 0.7, 0.5, 0.35, 0.25, 0.18, 0.12, 0.08], 0.25, 0.3, 0.85,
         0.4),
    12: ([0.8, 0.5, 0.9, 0.3, 0.6, 0.2, 0.4, 0.1], 0.1, 0.2, 0.7, 0.3),
    13: ([1.0, 0.55, 0.4, 0.3, 0.2, 0.12, 0.08, 0.05], 0.01, 0.4, 0.3, 0.2),
    14: ([1.0, 0.4, 0.6, 0.25, 0.35, 0.15, 0.2, 0.08], 0.002, 0.3, 0.05,
         0.1),
    15: ([0.6, 0.4, 0.5, 0.3, 0.4, 0.25, 0.3, 0.2], 0.05, 0.3, 0.4, 0.2),
}

_TIMBRE_AMPS = np.stack([np.asarray(_FAMILY_TIMBRES[i][0], np.float32)
                         for i in range(16)])
_TIMBRE_ADSR = np.stack([np.asarray(_FAMILY_TIMBRES[i][1:], np.float32)
                         for i in range(16)])

# 2 * pi as the f32 the JAX program multiplies by (a Python float, so
# torch keeps the tensors' f32)
_TWO_PI = float(np.float32(2.0 * math.pi))
_INV_RATE = float(np.float32(1.0) / np.float32(SAMPLE_RATE))
_INV_127 = float(np.float32(1.0) / np.float32(127.0))


def _render_tiles(freqs, durs, vels, families, is_drum, d_samples, key):
    """[N] note params (f32 / int64 / bool tensors on one device) ->
    [N, D] tiles, the JAX ``_render_notes`` arithmetic in f32."""
    dev = freqs.device
    # XLA turns a division by a constant into a multiply by its f32
    # reciprocal; so does the port, for the same bits
    t = torch.arange(d_samples, dtype=torch.float32, device=dev) \
        * _INV_RATE
    amps = torch.from_numpy(_TIMBRE_AMPS).to(dev)[families]        # [N, 8]
    adsr = torch.from_numpy(_TIMBRE_ADSR).to(dev)[families]        # [N, 4]
    attack, decay, sustain, release = (adsr[:, 0:1], adsr[:, 1:2],
                                       adsr[:, 2:3], adsr[:, 3:4])
    durs_c = torch.clamp(durs[:, None], min=0.02)

    tt = t[None, :]
    env_a = torch.clamp(tt / torch.clamp(attack, min=1e-4), max=1.0)
    env_d = 1.0 - (1.0 - sustain) * torch.clamp(
        torch.clamp(tt - attack, min=0.0) / torch.clamp(decay, min=1e-4),
        max=1.0)
    env = torch.minimum(env_a, env_d)
    rel = torch.clamp(tt - durs_c, min=0.0)
    env = env * torch.clamp(1.0 - rel / torch.clamp(release, min=1e-4),
                            min=0.0)
    env = env * (tt < durs_c + release)

    base_phase = _TWO_PI * freqs[:, None] * tt                    # [N, D]
    tone = torch.zeros_like(base_phase)
    for hi in range(MAX_HARMONICS):
        h = float(hi + 1)
        alias = (freqs * h < SAMPLE_RATE / 2.0).float()
        tone = tone + torch.sin(base_phase * h) * (amps[:, hi]
                                                   * alias)[:, None]
    wave = tone
    drum_rows = torch.nonzero(is_drum).flatten()
    if drum_rows.numel():
        noise = prng.uniform_from_bits(
            prng.bits_rows(key, d_samples, drum_rows), -1.0, 1.0)
        wave = wave.index_copy(0, drum_rows, noise)
    gains = (vels[:, None] * _INV_127) * 0.2
    return wave * env * gains


def render_song(song: MidiSong, sample_rate: int = SAMPLE_RATE,
                tail: float = 0.5, seed: int = 0, device=None) -> np.ndarray:
    """MidiSong -> float32 waveform in [-1, 1], rendered on ``device``
    (None means CUDA)."""
    assert sample_rate == SAMPLE_RATE, "fixed-rate synthesizer"
    dev = resolve_device(device)
    notes = []
    for inst in song.instruments:
        fam = int(inst.program) // 8
        for n in inst.notes:
            freq = 440.0 * 2.0 ** ((n.pitch - 69) / 12.0)
            notes.append((freq, n.start, min(n.duration, MAX_NOTE_SECONDS),
                          n.velocity, fam, inst.is_drum))
    end_time = song.get_end_time() + tail
    n_exact = max(int(np.ceil(end_time * SAMPLE_RATE)), SAMPLE_RATE // 4)
    if not notes:
        return np.zeros(n_exact, np.float32)
    bucket = 5 * SAMPLE_RATE
    n_total = ((n_exact + bucket - 1) // bucket) * bucket
    d_samples = min(int((MAX_NOTE_SECONDS + 0.5) * SAMPLE_RATE), n_total)
    out = torch.zeros(n_total, dtype=torch.float32, device=dev)
    rng = prng.PRNGKey(seed)
    for c in range(0, len(notes), NOTES_PER_CHUNK):
        chunk = notes[c:c + NOTES_PER_CHUNK]
        rng, sub = prng.split(rng)
        arr = torch.tensor([(f, s, d, v) for f, s, d, v, _, _ in chunk],
                           dtype=torch.float32)
        fams = torch.tensor([fa for *_, fa, _ in chunk], dtype=torch.int64)
        drums = torch.tensor([dr for *_, dr in chunk], dtype=torch.bool)
        tiles = _render_tiles(arr[:, 0].to(dev), arr[:, 2].to(dev),
                              arr[:, 3].to(dev), fams.to(dev), drums.to(dev),
                              d_samples, sub)
        starts = torch.round(arr[:, 1] * SAMPLE_RATE).to(torch.int64)
        for i, s0 in enumerate(starts.tolist()):
            # JAX clips every index into [0, n_total): the part of a tile
            # past the end lands on the last sample
            s0 = min(max(s0, 0), n_total - 1)
            n_in = min(d_samples, n_total - s0)
            out[s0:s0 + n_in] += tiles[i, :n_in]
            if n_in < d_samples:
                out[n_total - 1] += tiles[i, n_in:].sum()
    wave = out[:n_exact].cpu().numpy()
    peak = float(np.abs(wave).max())
    if peak > 1.0:
        wave = wave / peak * 0.97
    return wave


def write_wav(path_or_file, wave_f32: np.ndarray,
              sample_rate: int = SAMPLE_RATE) -> None:
    """float32 [-1,1] -> 16-bit PCM WAV (stdlib wave module)."""
    import wave as wave_mod

    pcm = np.clip(wave_f32, -1.0, 1.0)
    pcm = (pcm * 32767.0).astype(np.int16)
    w = wave_mod.open(path_or_file, "wb")
    try:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sample_rate)
        w.writeframes(pcm.tobytes())
    finally:
        w.close()


def render_to_wav(song: MidiSong, path_or_file, seed: int = 0,
                  device=None) -> None:
    """MIDI song -> WAV file, rendered on ``device``."""
    write_wav(path_or_file, render_song(song, seed=seed, device=device))
