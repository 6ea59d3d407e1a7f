"""SoundFont 2 (.sf2) parser: the presets, zones and samples that decide
which PCM a note plays and how.

Port of ``eamg_tpu/audio/sf2.py`` (host code: stdlib and numpy), kept
line for line so the rows the sampler renders are the JAX package's:

- RIFF structure: ``sfbk`` -> LIST INFO / LIST sdta(smpl) / LIST pdta
  (phdr, pbag, pmod, pgen, inst, ibag, imod, igen, shdr);
- the preset -> zone -> instrument -> zone -> sample chain, with GLOBAL
  zones (a first zone with no terminal generator gives the rest their
  defaults, spec 7.2/7.6);
- generators: key/vel ranges (preset x instrument), sample offsets, the
  DAHDSS+R volume envelope, initialAttenuation, tuning, sampleModes,
  overridingRootKey, initialFilterFc/Q and the vibrato LFO triple;
  preset-level generators add to instrument-level ones (spec 9.4);
- the default modulators of spec 8.4.1 (velocity -> attenuation, 960 cB
  concave) and 8.4.2 (velocity -> filter cutoff, -2400 cents linear),
  which a font's pmod/imod records supersede (instrument) or add to
  (preset); other modulators are counted (``SoundFont.n_mods_other``) and
  skipped. Pitch-wheel (8.4.3) is applied by the sampler.
"""

from __future__ import annotations

import dataclasses
import math
import struct

import numpy as np

# generator opers (SF2.04 §8.1.2)
G_START_OFF = 0
G_END_OFF = 1
G_STARTLOOP_OFF = 2
G_ENDLOOP_OFF = 3
G_START_COARSE = 4
G_VIB_LFO_TO_PITCH = 6
G_INIT_FILTER_FC = 8
G_INIT_FILTER_Q = 9
G_DELAY_VIB_LFO = 23
G_FREQ_VIB_LFO = 24
G_DELAY_ENV = 33
G_ATTACK_ENV = 34
G_HOLD_ENV = 35
G_DECAY_ENV = 36
G_SUSTAIN_ENV = 37
G_RELEASE_ENV = 38
G_INSTRUMENT = 41
G_KEY_RANGE = 43
G_VEL_RANGE = 44
G_STARTLOOP_COARSE = 45
G_INIT_ATTEN = 48
G_ENDLOOP_COARSE = 50
G_COARSE_TUNE = 51
G_FINE_TUNE = 52
G_SAMPLE_ID = 53
G_SAMPLE_MODES = 54
G_SCALE_TUNING = 56
G_ROOT_KEY = 58

# instrument-zone defaults (spec 8.1.3); envelope times in timecents
# (-12000 tc = ~1 ms, the spec's "instant")
_DEFAULTS = {
    G_DELAY_ENV: -12000, G_ATTACK_ENV: -12000, G_HOLD_ENV: -12000,
    G_DECAY_ENV: -12000, G_SUSTAIN_ENV: 0, G_RELEASE_ENV: -12000,
    G_INIT_ATTEN: 0, G_COARSE_TUNE: 0, G_FINE_TUNE: 0,
    G_SCALE_TUNING: 100, G_SAMPLE_MODES: 0, G_ROOT_KEY: -1,
    G_START_OFF: 0, G_END_OFF: 0, G_STARTLOOP_OFF: 0, G_ENDLOOP_OFF: 0,
    G_START_COARSE: 0, G_STARTLOOP_COARSE: 0, G_ENDLOOP_COARSE: 0,
    # low-pass filter (spec 8.1.3: 13500 abs cents ~= 19.9 kHz = open,
    # Q = 0 cB) and vibrato LFO (0 cents depth, 0 tc -> 8.176 Hz,
    # -12000 tc delay = instant)
    G_INIT_FILTER_FC: 13500, G_INIT_FILTER_Q: 0,
    G_VIB_LFO_TO_PITCH: 0, G_DELAY_VIB_LFO: -12000, G_FREQ_VIB_LFO: 0,
}
# generators whose value is one of these is ignored at preset level
_INST_ONLY = {G_SAMPLE_MODES, G_ROOT_KEY, G_SAMPLE_ID, G_INSTRUMENT,
              G_START_OFF, G_END_OFF, G_STARTLOOP_OFF, G_ENDLOOP_OFF,
              G_START_COARSE, G_STARTLOOP_COARSE, G_ENDLOOP_COARSE}


def _timecents_to_s(tc: float) -> float:
    return float(2.0 ** (tc / 1200.0))


def _abs_cents_to_hz(c: float) -> float:
    """Absolute cents -> Hz (spec 8.1.2: 0 abs cents = 8.176 Hz)."""
    return float(8.176 * 2.0 ** (c / 1200.0))


def _cb_to_gain(cb: float) -> float:
    """Centibels of attenuation -> linear gain (10 cB = 1 dB)."""
    return float(10.0 ** (-max(cb, 0.0) / 200.0))


# default-modulator identities: (srcOper, destOper, amtSrcOper, transOper).
# srcOper bit layout (spec 8.2): index | CC<<7 | D<<8 | P<<9 | type<<10.
MOD_VEL_TO_ATTEN = (0x0502, G_INIT_ATTEN, 0x0, 0)   # §8.4.1: concave, neg
MOD_VEL_TO_FC = (0x0102, G_INIT_FILTER_FC, 0x0, 0)  # §8.4.2: linear, neg
_DEFAULT_MOD_AMOUNTS = {MOD_VEL_TO_ATTEN: 960.0, MOD_VEL_TO_FC: -2400.0}


def vel_to_atten_cb(vel: float, amount_cb: float = 960.0) -> float:
    """§8.4.1: note-on velocity through the negative-direction concave
    curve to initialAttenuation, in centibels. Closed form of the spec's
    curve (page-73 figure; FluidSynth's fluid_concave table):
    amount * (40/96) * log10(127/vel). At the default 960 cB amount this
    is EXACTLY linear gain = (vel/127)**2."""
    v = min(max(float(vel), 1.0), 127.0)
    return float(amount_cb) * (40.0 / 96.0) * math.log10(127.0 / v)


def vel_to_fc_cents(vel: float, amount_cents: float = -2400.0) -> float:
    """§8.4.2: velocity through the negative linear unipolar curve to
    initialFilterFc, in relative cents: amount * (127-vel)/128 (0 at
    full velocity, ~2 octaves of cutoff drop at vel->0 by default)."""
    v = min(max(float(vel), 0.0), 127.0)
    return float(amount_cents) * (127.0 - v) / 128.0


@dataclasses.dataclass(frozen=True)
class Voice:
    """One fully-resolved (preset x instrument) zone: everything the
    renderer needs to play a note that matched its key/vel range."""
    key_lo: int
    key_hi: int
    vel_lo: int
    vel_hi: int
    # sample coordinates into SoundFont.samples (frames)
    start: int
    end: int
    loop_start: int
    loop_end: int
    loops: bool                  # sampleModes 1 or 3
    src_rate: int
    root_key: int
    tune_cents: float            # coarse*100 + fine + pitch correction
    scale_tuning: int            # cents per keynumber (100 = normal)
    gain: float                  # from initialAttenuation
    # DAHDSS+R volume envelope, seconds / linear sustain level
    delay: float
    attack: float
    hold: float
    decay: float
    sustain: float
    release: float
    # low-pass filter (initialFilterFc/Q): cutoff Hz (>= 19 kHz = open)
    # and resonance in centibels
    fc_hz: float = 20000.0
    filter_q_cb: float = 0.0
    # vibrato LFO (vibLfoToPitch / freqVibLFO / delayVibLFO)
    vib_cents: float = 0.0
    vib_hz: float = 8.176
    vib_delay: float = 0.0
    # raw initialFilterFc in absolute cents (fc_hz is its no-velocity
    # Hz form) — the renderer adds the §8.4.2 velocity offset in cents
    fc_cents: float = 13500.0
    # effective default-modulator amounts after pmod/imod supersede/add
    # (spec 9.5): §8.4.1 velocity->attenuation (cB over the concave
    # curve) and §8.4.2 velocity->filterFc (cents, linear negative)
    vel2att_cb: float = 960.0
    vel2fc_cents: float = -2400.0


class SoundFont:
    """Parsed soundfont: 16-bit PCM as float32 plus resolved voices per
    (bank, program)."""

    def __init__(self, samples: np.ndarray,
                 presets: dict[tuple[int, int], list[Voice]],
                 info: dict[str, str]):
        self.samples = samples          # float32 [-1, 1], all sample data
        self.presets = presets          # (bank, program) -> [Voice]
        self.info = info
        # pmod/imod records seen that are NOT one of the implemented
        # default-modulator identities (controller routes the render
        # path never varies) — parsed, counted, skipped
        self.n_mods_other = 0

    def lookup(self, bank: int, program: int, key: int,
               vel: int) -> list[Voice]:
        """Voices sounding for (bank, program, key, vel). GM fallbacks:
        a missing melodic bank falls back to bank 0 (FluidSynth's
        behavior); percussion (bank 128) has no melodic fallback."""
        zones = self.presets.get((bank, program))
        if zones is None and bank != 128:
            zones = self.presets.get((0, program))
        if zones is None:
            return []
        return [v for v in zones
                if v.key_lo <= key <= v.key_hi
                and v.vel_lo <= vel <= v.vel_hi]


def _read_riff(data: bytes) -> dict:
    """RIFF sfbk -> {'smpl': bytes, 'phdr': bytes, ..., 'INAM': str}."""
    if data[:4] != b"RIFF" or data[8:12] != b"sfbk":
        raise ValueError("not an SF2 file (missing RIFF/sfbk header)")
    out: dict = {}

    def walk(buf: bytes, pos: int, end: int):
        while pos + 8 <= end:
            cid = buf[pos:pos + 4]
            size = struct.unpack_from("<I", buf, pos + 4)[0]
            body = pos + 8
            if cid == b"LIST":
                walk(buf, body + 4, body + size)   # skip the list type id
            else:
                out[cid.decode("latin1").strip()] = buf[body:body + size]
            pos = body + size + (size & 1)          # chunks are word-aligned

    walk(data, 12, len(data))
    return out


def _records(buf: bytes, fmt: str, names: tuple[str, ...]) -> list[dict]:
    size = struct.calcsize(fmt)
    n = len(buf) // size
    return [dict(zip(names, struct.unpack_from(fmt, buf, i * size)))
            for i in range(n)]


def _mod_dict(mods, lo: int, hi: int) -> dict[tuple, float]:
    """Modulator records [lo, hi) -> {identity: amount}; identity =
    (src, dest, amt_src, trans). Later records with the same identity
    supersede earlier ones (spec 9.5.1)."""
    out: dict[tuple, float] = {}
    for mi in range(lo, min(hi, len(mods))):
        m = mods[mi]
        out[(m["src"], m["dst"], m["amt_src"], m["trans"])] = \
            float(m["amount"])
    return out


def _zone_gens(bags, gens, bag_lo, bag_hi, terminal_oper, mods=()):
    """Expand bag records [bag_lo, bag_hi) into per-zone generator dicts.
    Returns (global_gens, [(terminal_value, gens, zone_mods), ...]). A
    first zone whose last generator is not the terminal oper is the
    GLOBAL zone. ``zone_mods`` is the zone's {identity: amount} dict,
    global-zone modulators included (local identity supersedes global,
    spec 9.5.1)."""
    glob: dict[int, int] = {}
    glob_mods: dict[tuple, float] = {}
    zones = []
    for zi in range(bag_lo, bag_hi):
        g_lo, g_hi = bags[zi]["gen"], bags[zi + 1]["gen"]
        zg: dict[int, int] = {}
        for gi in range(g_lo, g_hi):
            zg[gens[gi]["oper"]] = gens[gi]["amount"]
        zm = _mod_dict(mods, bags[zi]["mod"], bags[zi + 1]["mod"]) \
            if mods else {}
        if terminal_oper in zg:
            zones.append((zg[terminal_oper], zg, {**glob_mods, **zm}))
        elif zi == bag_lo and not zones:
            glob, glob_mods = zg, zm
    return glob, zones


def _range(amount: int) -> tuple[int, int]:
    lo, hi = amount & 0xFF, (amount >> 8) & 0xFF
    return (lo, hi) if lo <= hi else (hi, lo)


def _signed(v: int) -> int:
    return v - 0x10000 if v >= 0x8000 else v


def parse_sf2(data: bytes) -> SoundFont:
    chunks = _read_riff(data)
    for req in ("smpl", "phdr", "pbag", "pgen", "inst", "ibag", "igen",
                "shdr"):
        if req not in chunks:
            raise ValueError(f"SF2 missing required chunk {req!r}")

    samples = (np.frombuffer(chunks["smpl"], dtype="<i2")
               .astype(np.float32) / 32768.0)

    shdr = _records(chunks["shdr"], "<20sIIIIIBbHH",
                    ("name", "start", "end", "loop_start", "loop_end",
                     "rate", "root", "corr", "link", "type"))[:-1]  # EOS
    phdr = _records(chunks["phdr"], "<20sHHHIII",
                    ("name", "preset", "bank", "bag", "lib", "genre",
                     "morph"))
    pbag = _records(chunks["pbag"], "<HH", ("gen", "mod"))
    pgen = _records(chunks["pgen"], "<HH", ("oper", "amount"))
    inst = _records(chunks["inst"], "<20sH", ("name", "bag"))
    ibag = _records(chunks["ibag"], "<HH", ("gen", "mod"))
    igen = _records(chunks["igen"], "<HH", ("oper", "amount"))
    mod_fields = ("src", "dst", "amount", "amt_src", "trans")
    pmod = _records(chunks.get("pmod", b""), "<HHhHH", mod_fields)
    imod = _records(chunks.get("imod", b""), "<HHhHH", mod_fields)

    # pre-resolve every instrument -> [(gens-with-globals + mods)]
    inst_zones: list[list[tuple[dict[int, int], dict[tuple, float]]]] = []
    for ii in range(len(inst) - 1):                    # last is EOI
        glob, zones = _zone_gens(ibag, igen, inst[ii]["bag"],
                                 inst[ii + 1]["bag"], G_SAMPLE_ID,
                                 mods=imod)
        resolved = []
        for sid, zg, zm in zones:
            eff = dict(glob)
            eff.update(zg)
            eff[G_SAMPLE_ID] = sid
            resolved.append((eff, zm))
        inst_zones.append(resolved)

    n_mods_other = 0
    presets: dict[tuple[int, int], list[Voice]] = {}
    for pi in range(len(phdr) - 1):                    # last is EOP
        glob, zones = _zone_gens(pbag, pgen, phdr[pi]["bag"],
                                 phdr[pi + 1]["bag"], G_INSTRUMENT,
                                 mods=pmod)
        voices: list[Voice] = []
        for inst_id, pz, pzm in zones:
            if inst_id >= len(inst_zones):
                continue
            peff = dict(glob)
            peff.update(pz)
            p_key = _range(peff[G_KEY_RANGE]) if G_KEY_RANGE in peff \
                else (0, 127)
            p_vel = _range(peff[G_VEL_RANGE]) if G_VEL_RANGE in peff \
                else (0, 127)
            for ieff, izm in inst_zones[inst_id]:
                n_mods_other += sum(
                    1 for ident in (*izm, *pzm)
                    if ident not in _DEFAULT_MOD_AMOUNTS)
                v = _make_voice(ieff, peff, p_key, p_vel, shdr,
                                imods=izm, pmods=pzm)
                if v is not None:
                    voices.append(v)
        key = (phdr[pi]["bank"], phdr[pi]["preset"])
        presets.setdefault(key, []).extend(voices)

    info = {}
    for k in ("INAM", "isng", "IENG", "ICOP", "ISFT"):
        if k in chunks:
            info[k] = chunks[k].split(b"\0")[0].decode("latin1",
                                                       "replace")
    sf = SoundFont(samples, presets, info)
    sf.n_mods_other = n_mods_other
    return sf


def _gen(ieff: dict, peff: dict, oper: int) -> float:
    """Effective generator: instrument value (or default) + preset offset
    (spec 9.4: preset generators are relative). Zone dicts hold the raw
    unsigned words from the gen records; sign-convert here."""
    base = _signed(ieff[oper]) if oper in ieff else _DEFAULTS[oper]
    if oper not in _INST_ONLY and oper in peff:
        base += _signed(peff[oper])
    return base


def _make_voice(ieff, peff, p_key, p_vel, shdr,
                imods=None, pmods=None) -> Voice | None:
    sid = ieff[G_SAMPLE_ID]
    if sid >= len(shdr):
        return None
    sh = shdr[sid]
    if sh["type"] & 0x8000:                      # ROM sample: unplayable
        return None
    i_key = _range(ieff[G_KEY_RANGE]) if G_KEY_RANGE in ieff else (0, 127)
    i_vel = _range(ieff[G_VEL_RANGE]) if G_VEL_RANGE in ieff else (0, 127)
    key_lo, key_hi = max(i_key[0], p_key[0]), min(i_key[1], p_key[1])
    vel_lo, vel_hi = max(i_vel[0], p_vel[0]), min(i_vel[1], p_vel[1])
    if key_lo > key_hi or vel_lo > vel_hi:
        return None

    def s(oper):
        return _signed(ieff.get(oper, _DEFAULTS[oper]))

    start = sh["start"] + s(G_START_OFF) + 32768 * s(G_START_COARSE)
    end = sh["end"] + s(G_END_OFF)
    loop_s = (sh["loop_start"] + s(G_STARTLOOP_OFF)
              + 32768 * s(G_STARTLOOP_COARSE))
    loop_e = (sh["loop_end"] + s(G_ENDLOOP_OFF)
              + 32768 * s(G_ENDLOOP_COARSE))
    modes = ieff.get(G_SAMPLE_MODES, 0) & 3
    loops = modes in (1, 3) and loop_e > loop_s
    root = ieff.get(G_ROOT_KEY, -1)
    if not 0 <= root <= 127:
        root = sh["root"] if sh["root"] < 128 else 60

    sus_cb = max(0.0, float(_gen(ieff, peff, G_SUSTAIN_ENV)))
    # default-modulator amounts: an instrument-zone modulator with the
    # same identity SUPERSEDES the spec default; a preset-zone one ADDS
    # (spec 9.5). A font can thus retune or zero either velocity mod.
    imods, pmods = imods or {}, pmods or {}
    vel2att = (imods.get(MOD_VEL_TO_ATTEN,
                         _DEFAULT_MOD_AMOUNTS[MOD_VEL_TO_ATTEN])
               + pmods.get(MOD_VEL_TO_ATTEN, 0.0))
    vel2fc = (imods.get(MOD_VEL_TO_FC,
                        _DEFAULT_MOD_AMOUNTS[MOD_VEL_TO_FC])
              + pmods.get(MOD_VEL_TO_FC, 0.0))
    fc_cents = float(_gen(ieff, peff, G_INIT_FILTER_FC))
    return Voice(
        key_lo=key_lo, key_hi=key_hi, vel_lo=vel_lo, vel_hi=vel_hi,
        start=int(start), end=int(max(end, start + 1)),
        loop_start=int(loop_s), loop_end=int(loop_e), loops=bool(loops),
        src_rate=int(sh["rate"]) or 44100, root_key=int(root),
        tune_cents=(100.0 * _gen(ieff, peff, G_COARSE_TUNE)
                    + _gen(ieff, peff, G_FINE_TUNE) + sh["corr"]),
        scale_tuning=int(_gen(ieff, peff, G_SCALE_TUNING)),
        gain=_cb_to_gain(float(_gen(ieff, peff, G_INIT_ATTEN))),
        delay=_timecents_to_s(_gen(ieff, peff, G_DELAY_ENV)),
        attack=_timecents_to_s(_gen(ieff, peff, G_ATTACK_ENV)),
        hold=_timecents_to_s(_gen(ieff, peff, G_HOLD_ENV)),
        decay=_timecents_to_s(_gen(ieff, peff, G_DECAY_ENV)),
        sustain=_cb_to_gain(sus_cb),
        release=_timecents_to_s(_gen(ieff, peff, G_RELEASE_ENV)),
        fc_hz=min(_abs_cents_to_hz(fc_cents), 20000.0),
        filter_q_cb=max(0.0, float(_gen(ieff, peff, G_INIT_FILTER_Q))),
        vib_cents=float(_gen(ieff, peff, G_VIB_LFO_TO_PITCH)),
        vib_hz=_abs_cents_to_hz(_gen(ieff, peff, G_FREQ_VIB_LFO)),
        vib_delay=_timecents_to_s(_gen(ieff, peff, G_DELAY_VIB_LFO)),
        fc_cents=fc_cents, vel2att_cb=float(vel2att),
        vel2fc_cents=float(vel2fc))


def load_sf2(path: str) -> SoundFont:
    with open(path, "rb") as f:
        return parse_sf2(f.read())
