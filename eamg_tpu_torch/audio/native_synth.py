"""ctypes bindings of the C++ host synthesizer (``native/eamg_synth.cpp``).

Port of ``eamg_tpu/audio/native_synth.py``: ``render_song_native`` is the
additive synth's algorithm on the host (drum noise from another PRNG, so
drums match in energy, not in samples); ``sf2_voice_native`` is an
independent C++ twin of one sampler voice (unfiltered), the oracle that
cut ``tests/golden/cpp_twin_fixture.wav``; the two modulator helpers are
the C++ forms of ``sf2.vel_to_atten_cb`` and ``sf2.vel_to_fc_cents``. The
library is built with g++ on first use (``utils/native.py``).
"""

from __future__ import annotations

import ctypes
import threading

import numpy as np

from ..midi.smf import MidiSong
from ..utils.native import NativeUnavailable, load_library
from .synth import MAX_NOTE_SECONDS, SAMPLE_RATE

_lib = None
_lock = threading.Lock()


def load_native():
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = load_library("eamg_synth")
        d = ctypes.POINTER(ctypes.c_double)
        lib.eamg_render.restype = ctypes.c_int
        lib.eamg_render.argtypes = [
            d, d, d, d, ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.POINTER(ctypes.c_float)]
        cd = ctypes.c_double
        lib.eamg_vel2att_gain.restype = cd
        lib.eamg_vel2att_gain.argtypes = [cd, cd]
        lib.eamg_vel2fc_hz.restype = cd
        lib.eamg_vel2fc_hz.argtypes = [cd, cd, cd]
        lib.eamg_sf2_voice.restype = ctypes.c_int
        # (bank, bank_len, pos0, end, loop_s, loop_e, loops[int],
        #  ratio, t_start, dur, gain, delay, attack, hold, decay,
        #  sustain, release, vib_cents, vib_hz, vib_delay,
        #  n_total, d_samples, out)
        lib.eamg_sf2_voice.argtypes = (
            [ctypes.POINTER(ctypes.c_float), ctypes.c_int64]
            + [cd] * 4 + [ctypes.c_int] + [cd] * 13
            + [ctypes.c_int, ctypes.c_int,
               ctypes.POINTER(ctypes.c_float)])
        _lib = lib
        return _lib


def native_synth_available() -> bool:
    try:
        load_native()
        return True
    except NativeUnavailable:
        return False


def render_song_native(song: MidiSong, tail: float = 0.5,
                       seed: int = 0) -> np.ndarray:
    """MidiSong -> float32 waveform in [-1, 1] (C++ renderer)."""
    lib = load_native()
    freqs, starts, durs, vels, fams, drums = [], [], [], [], [], []
    for inst in song.instruments:
        fam = int(inst.program) // 8
        for n in inst.notes:
            freqs.append(440.0 * 2.0 ** ((n.pitch - 69) / 12.0))
            starts.append(n.start)
            durs.append(min(n.duration, MAX_NOTE_SECONDS))
            vels.append(float(n.velocity))
            fams.append(fam)
            drums.append(1 if inst.is_drum else 0)
    n_total = max(int(np.ceil((song.get_end_time() + tail) * SAMPLE_RATE)),
                  SAMPLE_RATE // 4)
    out = np.zeros(n_total, np.float32)
    if freqs:
        def arr(x, dt):
            return np.ascontiguousarray(np.asarray(x, dt))

        dp = ctypes.POINTER(ctypes.c_double)
        f, s, d, v = (arr(x, np.float64) for x in (freqs, starts, durs, vels))
        fa = arr(fams, np.int32)
        dr = arr(drums, np.uint8)
        rc = lib.eamg_render(
            f.ctypes.data_as(dp), s.ctypes.data_as(dp),
            d.ctypes.data_as(dp), v.ctypes.data_as(dp),
            fa.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            dr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            len(freqs), n_total, seed,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
        if rc != 0:
            raise RuntimeError(f"eamg_render failed: {rc}")
    peak = float(np.abs(out).max())
    if peak > 1.0:
        out = out / peak * 0.97
    return out


def vel2att_gain_native(vel: float, amount_cb: float) -> float:
    """C++ twin of sf2.vel_to_atten_cb composed with _cb_to_gain."""
    return float(load_native().eamg_vel2att_gain(float(vel),
                                                 float(amount_cb)))


def vel2fc_hz_native(fc_cents: float, vel: float,
                     amount_cents: float) -> float:
    """C++ twin of sf2.vel_to_fc_cents folded into the Hz conversion."""
    return float(load_native().eamg_vel2fc_hz(
        float(fc_cents), float(vel), float(amount_cents)))


def sf2_voice_native(bank: np.ndarray, row, n_total: int,
                     d_samples: int) -> np.ndarray:
    """C++ twin of one sampler voice (unfiltered path). ``row`` is the
    sampler's 20-field tuple; fields 15/16 (fc_hz, q_cb) are ignored."""
    lib = load_native()
    bank = np.ascontiguousarray(np.asarray(bank, np.float32))
    out = np.zeros(int(n_total), np.float32)
    (start, end, loop_s, loop_e, loops, ratio, t_start, dur, gain,
     delay, attack, hold, decay, sustain, release, _fc, _q,
     vib_cents, vib_hz, vib_delay) = [float(x) for x in row]
    rc = lib.eamg_sf2_voice(
        bank.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        ctypes.c_int64(bank.shape[0]), start, end, loop_s, loop_e,
        int(loops > 0.5), ratio, t_start, dur, gain, delay, attack,
        hold, decay, sustain, release, vib_cents, vib_hz, vib_delay,
        int(n_total), int(d_samples),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
    if rc != 0:
        raise RuntimeError(f"eamg_sf2_voice failed: {rc}")
    return out
