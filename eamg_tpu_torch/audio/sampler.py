"""SoundFont sample playback on the device: MIDI -> waveform with the
timbre of a parsed .sf2, no host synth.

Port of ``eamg_tpu/audio/sampler.py``. Each (note x matched voice) is a
row of 20 f32 parameters (``Sf2Renderer._voices_for``, host code copied
exactly, so its Python floats round to JAX's rows); a chunk of up to 128
rows renders as one [rows, D] tile tensor on the renderer's device:

- a fractional read position (pitch ratio x output clock, plus the
  vibrato's analytic offset) gathers linearly interpolated PCM from the
  flat sample bank, loop-wrapped for sustained zones;
- the zone's DAHDSS+R envelope, the gain, and (when any voice of the chunk
  has its filter below 19 kHz) the zero-phase low-pass as an rfft
  magnitude multiply;
- the tiles are added onto a zeroed timeline voice by voice, in voice
  order, as XLA:CPU's scatter-add adds them (no atomics on the card, so two
  renders of one song give the same bytes); samples past the timeline's
  end land on its last sample, as JAX's clipped indices put them.

Four arithmetic details follow XLA:CPU rather than torch, because the
read position is sensitive to them (one ulp of it at 40 000 samples is
0.004 samples, 1.7e-4 of a 440 Hz sine's amplitude, and a loop wrap can
move a sample to the other end of the loop):
- ``jnp.mod`` is ``fmod`` plus ``b`` where the signs differ
  (``torch.remainder`` rounds otherwise);
- a division by a constant is a multiply by its f32 reciprocal;
- where XLA contracts a product and a sum into one fused multiply-add, the
  port computes that sum in f64 and rounds once (:func:`_fma`);
- the vibrato's cosine is glibc's ``cosf``, which XLA:CPU calls
  (:func:`_cosf`: its double-precision reduction and polynomials, written
  as f64 tensor ops, so the card computes the same bits as the host).

The bank is uploaded once per renderer. Notes no preset of the font
matches (a percussion-less font's drums) render through the additive
synth (``audio/synth.py``) on the same device.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..midi.smf import Instrument, MidiSong
from ..utils.device import resolve_device
from .sf2 import SoundFont, load_sf2
from .synth import MAX_NOTE_SECONDS, SAMPLE_RATE
from .synth import render_song as _render_additive

CHUNK = 128                     # voices per chunk of the render
_MASTER_GAIN = 0.35
_N_FIELDS = 20
_INV_RATE = float(np.float32(1.0) / np.float32(SAMPLE_RATE))
_TWO_PI = float(np.float32(2.0 * math.pi))
# jnp.log(2.0) / 1200.0 in f32
_VIB_SCALE = float(np.float32(np.float32(math.log(2.0)) / np.float32(1200.0)))
_INV_200 = float(np.float32(1.0) / np.float32(200.0))


def _xla_mod(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``jnp.mod`` as XLA computes it: ``fmod``, then ``+ b`` where the
    remainder is non-zero and its sign differs from ``b``'s."""
    r = torch.fmod(a, b)
    fix = (r != 0) & ((r < 0) != (b < 0))
    return torch.where(fix, r + b, r)


def _fma(a, b, c) -> torch.Tensor:
    """a * b + c rounded once to f32, as XLA:CPU's fused multiply-add (the
    f64 product of two f32 values is exact)."""
    a = a.double() if isinstance(a, torch.Tensor) else a
    b = b.double() if isinstance(b, torch.Tensor) else b
    return (a * b + c.double() if isinstance(c, torch.Tensor)
            else a * b + c).to(torch.float32)


# glibc's cosf (sysdeps/ieee754/flt-32/s_cosf.c, x86-64 FMA build): the
# cosine polynomial's coefficients, the sine's, 2/pi scaled by 2^24 and
# pi/2 split for an exact reduction, and 2/pi's bits in 32-bit windows 8
# bits apart for arguments of 120 and more
_COS_C = (1.0, float.fromhex("-0x1.ffffffd0c621cp-2"),
          float.fromhex("0x1.55553e1068f19p-5"),
          float.fromhex("-0x1.6c087e89a359dp-10"),
          float.fromhex("0x1.99343027bf8c3p-16"))
_SIN_S = (float.fromhex("-0x1.555545995a603p-3"),
          float.fromhex("0x1.1107605230bc4p-7"),
          float.fromhex("-0x1.994eb3774cf24p-13"))
_HPI_INV = float.fromhex("0x1.45f306dc9c883p+23")
_HPI_HI = float.fromhex("0x1.921fb54000000p0")
_HPI_LO = float.fromhex("0x1.921fb54442d18p0") - _HPI_HI
_PI63 = float.fromhex("0x1.921fb54442d18p-62")
_INV_PIO4 = (
    0xa2, 0xa2f9, 0xa2f983, 0xa2f9836e, 0xf9836e4e, 0x836e4e44, 0x6e4e4415,
    0x4e441529, 0x441529fc, 0x1529fc27, 0x29fc2757, 0xfc2757d1, 0x2757d1f5,
    0x57d1f534, 0xd1f534dd, 0xf534ddc0, 0x34ddc0db, 0xddc0db62, 0xc0db6295,
    0xdb629599, 0x6295993c, 0x95993c43, 0x993c4390, 0x3c439041)
# the top 12 bits of pi/4, 120 and 2^-12 as f32 (glibc's abstop12)
_TOP_PIO4, _TOP_120, _TOP_TINY = 1012, 1071, 920


def _cosf_poly(x, x2, cos_rows, negate):
    """glibc's ``sinf_poly``: the cosine polynomial where ``cos_rows``,
    else the sine's; ``negate`` flips the cosine's coefficients (its second
    table)."""
    sgn = torch.where(negate, -1.0, 1.0).double()
    c = [sgn * k for k in _COS_C]
    x4 = x2 * x2
    cos = (c[0] + x2 * c[1]) + x4 * c[2] + (x4 * x2) * (c[3] + x2 * c[4])
    x3 = x * x2
    sin = (x + x3 * _SIN_S[0]) + (x3 * x2) * (_SIN_S[1] + x2 * _SIN_S[2])
    return torch.where(cos_rows, cos, sin)


def _cosf(y: torch.Tensor) -> torch.Tensor:
    """cos of an f32 tensor with glibc's ``cosf``'s bits (double-precision
    argument reduction: one multiply-subtract below 120, 2/pi's bits by
    integer products above; a degree-4/3 polynomial in the reduced
    argument)."""
    x = y.double()
    bits = y.view(torch.int32).to(torch.int64) & 0xffffffff
    top = (bits >> 20) & 0x7ff
    signs = torch.tensor([1.0, -1.0, -1.0, 1.0], dtype=torch.float64,
                         device=y.device)
    true = torch.ones_like(y, dtype=torch.bool)
    small = _cosf_poly(x, x * x, true, ~true)
    # |y| < 120: n = the nearest quadrant, from 2/pi * 2^24
    n = (((x * _HPI_INV).to(torch.int32) + 0x800000) >> 24).to(torch.int64)
    xr = (x - n.double() * _HPI_HI) - n.double() * _HPI_LO
    fast = _cosf_poly(xr * signs[n & 3], xr * xr, (n & 1) == 0,
                      (n & 2) != 0)
    # |y| >= 120: a 64-bit fixed-point product with 2/pi's bits, in 32-bit
    # halves (int64 without overflow)
    table = torch.tensor(_INV_PIO4, dtype=torch.int64, device=y.device)
    base = (bits >> 26) & 15
    m = ((bits & 0xffffff) | 0x800000) << ((bits >> 23) & 7)
    res0 = (m * table[base]) & 0xffffffff
    res1, res2 = m * table[base + 4], m * table[base + 8]
    lo = (res2 >> 32) + (res1 & 0xffffffff)
    hi = (res0 + (res1 >> 32) + (lo >> 32)) & 0xffffffff
    nl = ((hi + (1 << 29)) & 0xffffffff) >> 30
    hi = (hi - (nl << 30)) & 0xffffffff
    hi = torch.where(hi >= (1 << 31), hi - (1 << 32), hi)
    xl = (hi.double() * 4294967296.0 + (lo & 0xffffffff).double()) * _PI63
    q = nl + (bits >> 31)
    large = _cosf_poly(xl * signs[q & 3], xl * xl, (nl & 1) == 0,
                       (q & 2) != 0)
    out = torch.where(top < _TOP_PIO4, small,
                      torch.where(top < _TOP_120, fast, large))
    return torch.where(top < _TOP_TINY, torch.ones_like(out),
                       out).to(torch.float32)


def _tiles(bank: torch.Tensor, rows: torch.Tensor, d_samples: int,
           use_filter: bool) -> torch.Tensor:
    """[V, 20] voice rows (f32, on the bank's device) -> [V, D] tiles, the
    arithmetic of JAX's ``_render_voices`` before its scatter-add."""
    (pos0, end, loop_s, loop_e, loops, ratio, _t_start, dur, gain, delay,
     attack, hold, decay, sustain, release, fc_hz, q_cb, vib_cents, vib_hz,
     vib_delay) = [rows[:, i:i + 1] for i in range(_N_FIELDS)]
    dev = bank.device
    ramp = torch.arange(d_samples, dtype=torch.float32, device=dev)[None]
    tt = ramp * _INV_RATE

    # vibrato: the read position's analytic integral of the LFO, on the
    # rows that have one (elsewhere it is 0 * (...) / w = 0, and
    # fma(0, rate, ramp) = ramp)
    vib = torch.nonzero(vib_cents[:, 0] != 0).flatten()
    clock = ramp.expand(rows.shape[0], d_samples)
    if vib.numel():
        w = _TWO_PI * torch.clamp(vib_hz[vib], min=1e-3)
        t_act = torch.clamp(tt - vib_delay[vib], min=0.0)
        vib_amp = vib_cents[vib] * _VIB_SCALE
        vib_pos = vib_amp * (1.0 - _cosf(w * t_act)) / w
        clock = clock.index_copy(0, vib, _fma(vib_pos, float(SAMPLE_RATE),
                                              ramp))
    sp = _fma(clock, ratio, pos0)
    lw = torch.clamp(loop_e - loop_s, min=1.0)
    wrapped = loop_s + _xla_mod(sp - loop_s, lw)
    sp = torch.where((loops > 0.5) & (sp >= loop_e), wrapped, sp)
    in_data = sp < (end - 1.0)
    sp = torch.clamp(sp, 0.0, float(bank.shape[0] - 2))
    i0 = torch.floor(sp).to(torch.int64)
    frac = sp - i0.to(torch.float32)
    pcm = _fma(bank[i0], 1.0 - frac, bank[i0 + 1] * frac)

    # DAHDSS envelope on the output clock, then the release
    t1 = delay
    t2 = t1 + attack
    t3 = t2 + hold
    env = torch.clamp((tt - t1) / torch.clamp(attack, min=1e-4), 0.0, 1.0)
    dec = torch.clamp((tt - t3) / torch.clamp(decay, min=1e-4), 0.0, 1.0)
    env = torch.where(tt > t3, _fma(sustain - 1.0, dec, 1.0), env)
    env = torch.where((tt > t2) & (tt <= t3), torch.ones_like(env), env)
    durc = torch.clamp(dur, min=1e-3)
    rel = torch.clamp(tt - durc, min=0.0)
    env = env * torch.clamp(1.0 - rel / torch.clamp(release, min=1e-4),
                            0.0, 1.0)

    tiles = pcm * env * gain * in_data
    if use_filter:
        # initialFilterFc/Q as a zero-phase magnitude filter: |H(f)| =
        # 1/sqrt((1-x^2)^2 + (x/Q)^2), x = f/fc, capped at Q; voices with
        # fc >= 19 kHz pass (the round trip of the FFT still rounds them)
        n_f = d_samples // 2 + 1
        freqs = torch.arange(n_f, dtype=torch.float32, device=dev) \
            / float(np.float32(d_samples / SAMPLE_RATE))
        x = freqs[None] / torch.clamp(fc_hz, min=1.0)
        q_lin = torch.clamp(torch.pow(10.0, q_cb * _INV_200), 0.5, 100.0)
        xq = x / q_lin
        one_m = _fma(-x, x, 1.0)
        mag = torch.rsqrt(_fma(one_m, one_m, xq * xq))
        mag = torch.minimum(mag, q_lin)
        mag = torch.where(fc_hz >= 19000.0, torch.ones_like(mag), mag)
        tiles = torch.fft.irfft(torch.fft.rfft(tiles, dim=1) * mag,
                                n=d_samples, dim=1).to(torch.float32)
    return tiles


def render_voices(bank: torch.Tensor, rows: torch.Tensor, n_total: int,
                  d_samples: int, use_filter: bool = False) -> torch.Tensor:
    """One chunk: [V, 20] voice rows -> the [n_total] timeline they sum to
    from zeros, each voice's tile added in voice order (samples past the
    end onto the last one, in sample order)."""
    tiles = _tiles(bank, rows, d_samples, use_filter)
    starts = torch.round(rows[:, 6] * float(SAMPLE_RATE)).to(torch.int64)
    out = torch.zeros(n_total, dtype=torch.float32, device=bank.device)
    for v, s0 in enumerate(starts.tolist()):
        s0 = min(max(s0, 0), n_total - 1)
        n_in = min(d_samples, n_total - s0)
        out[s0:s0 + n_in] += tiles[v, :n_in]
        if n_in < d_samples:
            # JAX clips every index into [0, n_total): the rest of the tile
            # lands on the last sample, one sample at a time
            out[n_total - 1:] = torch.cumsum(
                torch.cat([out[n_total - 1:], tiles[v, n_in:]]), 0)[-1:]
    return out


class Sf2Renderer:
    """Plays a parsed SoundFont on ``device`` (None means CUDA). The
    sample bank is uploaded once, at construction; a render is host-side
    voice resolution and one device call a chunk of 128 voices."""

    def __init__(self, sf: SoundFont | str, device=None):
        self.device = resolve_device(device)
        self.sf = load_sf2(sf) if isinstance(sf, str) else sf
        # +2 guard samples so the i0 + 1 gathers stay in bounds
        self.bank = torch.from_numpy(np.concatenate(
            [self.sf.samples.astype(np.float32),
             np.zeros(2, np.float32)])).to(self.device)

    def _voices_for(self, song: MidiSong):
        """(matched [per-voice param rows], [unmatched notes' Instrument
        clones]) — host-side preset/zone resolution."""
        from .sf2 import (_abs_cents_to_hz, _cb_to_gain, vel_to_atten_cb,
                          vel_to_fc_cents)

        rows = []
        leftovers: list[Instrument] = []
        for inst in song.instruments:
            bank_n = 128 if inst.is_drum else 0
            missing = None
            # §8.4.3 pitch-wheel -> pitch at the GM default ±2-semitone
            # range, applied statically per note (the bend value in
            # effect at note onset; the render path has no mid-note CC
            # stream). No bends (the detokenizer never emits them) = 0.
            bends = sorted((b.time, b.pitch)
                           for b in getattr(inst, "pitch_bends", []))
            b_times = [t for t, _ in bends]
            for n in inst.notes:
                bend_semis = 0.0
                if bends:
                    import bisect

                    k = bisect.bisect_right(b_times, n.start) - 1
                    if k >= 0:
                        bend_semis = bends[k][1] / 8192.0 * 2.0
                vs = self.sf.lookup(bank_n, int(inst.program),
                                    int(n.pitch), int(n.velocity))
                if not vs:
                    if missing is None:
                        missing = Instrument(inst.program, inst.is_drum,
                                             inst.name)
                        leftovers.append(missing)
                    missing.notes.append(n)
                    continue
                for v in vs:
                    # drum zones ignore note-off (one-shot); melodic dur
                    # is the held time, capped to the tile
                    dur = MAX_NOTE_SECONDS if inst.is_drum else min(
                        n.duration, MAX_NOTE_SECONDS)
                    semis = (int(n.pitch) - v.root_key) \
                        * (v.scale_tuning / 100.0) + bend_semis
                    ratio = (2.0 ** (semis / 12.0 + v.tune_cents / 1200.0)
                             * v.src_rate / SAMPLE_RATE)
                    # §8.4.1: velocity through the concave curve to
                    # attenuation (the font's amount; 960 cB default is
                    # exactly the old (vel/127)**2 gain)
                    vel_gain = _cb_to_gain(
                        vel_to_atten_cb(n.velocity, v.vel2att_cb))
                    # §8.4.2: velocity closes the low-pass — quiet notes
                    # lose brightness (the FluidR3 velocity dynamic)
                    fc_hz = min(_abs_cents_to_hz(
                        v.fc_cents
                        + vel_to_fc_cents(n.velocity, v.vel2fc_cents)),
                        20000.0)
                    rows.append((
                        float(v.start), float(v.end), float(v.loop_start),
                        float(v.loop_end), float(v.loops), float(ratio),
                        float(n.start), float(dur),
                        float(v.gain * vel_gain * _MASTER_GAIN),
                        float(v.delay), float(min(v.attack, 4.0)),
                        float(min(v.hold, 4.0)), float(min(v.decay, 8.0)),
                        float(v.sustain), float(min(v.release, 4.0)),
                        float(fc_hz), float(v.filter_q_cb),
                        float(v.vib_cents), float(v.vib_hz),
                        float(v.vib_delay)))
        return rows, leftovers

    def render_song(self, song: MidiSong, tail: float = 0.5,
                    seed: int = 0) -> np.ndarray:
        """MidiSong -> float32 waveform in [-1, 1]."""
        rows, leftovers = self._voices_for(song)
        end_time = song.get_end_time() + tail
        n_exact = max(int(np.ceil(end_time * SAMPLE_RATE)),
                      SAMPLE_RATE // 4)
        bucket = 5 * SAMPLE_RATE
        n_total = ((n_exact + bucket - 1) // bucket) * bucket
        d_samples = min(int((MAX_NOTE_SECONDS + 0.5) * SAMPLE_RATE),
                        n_total)
        total = torch.zeros(n_total, dtype=torch.float32, device=self.device)
        for c in range(0, len(rows), CHUNK):
            arr = np.asarray(rows[c:c + CHUNK], np.float32)
            # the chunk's static gate: a chunk whose filters are all open
            # skips the FFT (JAX's padding voices are open too)
            use_filter = bool((arr[:, 15] < 19000.0).any())
            total += render_voices(self.bank,
                                   torch.from_numpy(arr).to(self.device),
                                   n_total, d_samples, use_filter)
        out = total.cpu().numpy()
        if leftovers:
            fallback = MidiSong()
            fallback.instruments = leftovers
            add = _render_additive(fallback, seed=seed, device=self.device)
            out[:len(add)] += add[:n_total]
        out = out[:n_exact]
        peak = float(np.abs(out).max())
        if peak > 1.0:
            out = out / peak * 0.97
        return out

    def render_to_wav(self, song: MidiSong, path_or_file,
                      seed: int = 0) -> None:
        from .synth import write_wav

        write_wav(path_or_file, self.render_song(song, seed=seed))
