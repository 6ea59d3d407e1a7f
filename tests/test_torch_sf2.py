"""The port's SoundFont rung (eamg_tpu_torch/audio/sf2.py, sampler.py,
fluidsynth.py rung 2, native_synth.py) against the JAX package on the CPU,
on the fixture font of tests/sf2_fixture.py.

The torch side runs in one subprocess (tests/torch_port_tools.py, task
"sf2"). Tolerances:
- parse_sf2: every preset's voices equal field for field, the samples
  bit-equal;
- the voice rows of each song: equal (host code, the same Python floats);
- each render: max |port - JAX| <= 1e-5 on the f32 waveform, and the int16
  PCM of the WAV within 1 LSB, with the same length and header;
- render_to_wav_auto: the same rung as JAX's (sampler with a soundfont and
  no binary, the additive synth with EAMG_NO_SF2 or an unparseable font),
  PCM within 1 LSB of JAX's bytes;
- the fixture song's band-energy profile correlates > 0.7 with the
  committed C++-twin golden, the bound tests/test_sf2.py holds JAX to;
- one voice of the port against native_synth.sf2_voice_native (the C++
  twin): max error / peak < 2e-3, the bound tests/test_native_synth.py
  holds JAX's kernel to; the modulator helpers within 1e-12.
"""

from __future__ import annotations

import dataclasses
import io
import json
import os
import wave as wavemod

import numpy as np
import pytest

from eamg_tpu.audio import fluidsynth as jfs
from eamg_tpu.audio.sampler import Sf2Renderer
from eamg_tpu.audio.sf2 import parse_sf2
from eamg_tpu.audio.synth import write_wav
from eamg_tpu.midi.smf import Instrument, MidiSong, Note, PitchBend

from port_harness import run_worker
from sf2_fixture import RATE, build_test_sf2

WAVE_ATOL = 1e-5
PCM_LSB = 1

_SINE_NOTES = [[40 + (7 * i) % 88, 48 + (5 * i) % 36, 0.02 * i,
                0.02 * i + 0.3 + 0.01 * (i % 9)] for i in range(140)]

# name -> (song spec, tail, seed); a spec is [[program, is_drum, notes
# [[vel, pitch, start, end]], bends [[value, time]]], ...]
CASES = {
    # the sine's loop ends at 0.23 s: a 1.6 s note wraps (jnp.mod)
    "loop_wrap": ([[0, False, [[100, 69, 0.1, 1.7]], []]], 0.5, 0),
    # the 1 kHz low-pass, loud and quiet (velocity closes the filter)
    "filter": ([[41, False, [[127, 60, 0.1, 1.1], [40, 64, 0.3, 0.9]], []]],
               0.5, 0),
    "vibrato": ([[42, False, [[100, 69, 0.1, 2.1]], []]], 0.5, 0),
    "pitch_bend": ([[0, False, [[100, 69, 0.1, 0.9]], [[8191, 0.0]]],
                    [40, False, [[90, 60, 0.2, 0.8]], [[-4096, 0.1]]]],
                   0.5, 0),
    # the timeline ends while the note sounds: the tile's rest lands on
    # the last sample (JAX's clipped scatter index)
    "past_end": ([[0, False, [[110, 69, 3.0, 5.2]], []]], -0.2, 0),
    # no percussion bank in the font: drums go to the additive synth
    "drum": ([[0, True, [[100, 40, 0.0, 0.4], [90, 42, 0.25, 0.5]], []],
              [0, False, [[100, 69, 0.1, 0.6]], []]], 0.5, 5),
    # program 7 has no preset: additive leftovers beside sampled notes
    "unmatched": ([[7, False, [[100, 60, 0.0, 0.5], [80, 67, 0.3, 0.9]],
                    []],
                   [43, False, [[30, 69, 0.1, 0.7]], []]], 0.5, 2),
    # 140 + 10 voices: two chunks, the first with a filtered voice
    "two_chunks": ([[0, False, _SINE_NOTES, []],
                    [41, False, [[100, 60, 0.5, 1.5]], []],
                    [44, False, [[70 + i, 62 + i, 1.0 + 0.1 * i,
                                  1.4 + 0.1 * i] for i in range(9)], []]],
                   0.5, 0),
}
AUTO_SONG = [[0, False, [[100, 69, 0.1, 0.9]], []],
             [0, True, [[100, 38, 0.2, 0.5]], []]]
# tests/sf2_fixture.py::fixture_song, as a spec
GOLDEN_SONG = [[p, False, [[100, k, 0.1, 1.2]], []]
               for p, k in ((0, 69), (40, 60), (41, 64), (42, 72))]
NATIVE_SONGS = [[[0, False, [[100, 69, 0.1, 0.8]], []]],
                [[40, False, [[45, 60, 0.1, 1.0]], []]],
                [[42, False, [[120, 69, 0.1, 1.3]], []]]]
NATIVE_SIZES = (int(2.5 * RATE), int(2.2 * RATE))


def jax_song(spec) -> MidiSong:
    song = MidiSong()
    for prog, drum, notes, bends in spec:
        inst = Instrument(program=prog, is_drum=drum)
        inst.notes.extend(Note(v, p, s, e) for v, p, s, e in notes)
        inst.pitch_bends.extend(PitchBend(pitch=b, time=t) for b, t in bends)
        song.instruments.append(inst)
    return song


def _wav(fn) -> bytes:
    buf = io.BytesIO()
    fn(buf)
    return buf.getvalue()


def _pcm(data) -> np.ndarray:
    with wavemod.open(io.BytesIO(bytes(data)), "rb") as w:
        return np.frombuffer(w.readframes(w.getnframes()), "<i2")


def _jax_auto(tmp_path, monkeypatch, song) -> dict:
    font = tmp_path / "jax_fixture.sf2"
    font.write_bytes(build_test_sf2())
    monkeypatch.setenv("EAMG_SOUNDFONT", str(font))
    monkeypatch.setenv("EAMG_FLUIDSYNTH", "/nonexistent/fluidsynth")
    monkeypatch.delenv("EAMG_NO_SF2", raising=False)
    monkeypatch.delenv("EAMG_NO_FLUIDSYNTH", raising=False)
    jfs._sf2_renderers.clear()
    out = {"sf2": _wav(lambda f: jfs.render_to_wav_auto(song, f, seed=3)),
           "renderers": len(jfs._sf2_renderers)}
    monkeypatch.setenv("EAMG_NO_SF2", "1")
    out["no_sf2"] = _wav(lambda f: jfs.render_to_wav_auto(song, f, seed=3))
    monkeypatch.delenv("EAMG_NO_SF2")
    bad = tmp_path / "bad.sf2"
    bad.write_bytes(b"RIFF\0\0\0\0notafont")
    monkeypatch.setenv("EAMG_SOUNDFONT", str(bad))
    out["bad_font"] = _wav(lambda f: jfs.render_to_wav_auto(song, f,
                                                            seed=3))
    jfs._sf2_renderers.clear()
    return out


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("sf2")
    font = build_test_sf2()
    inp = {"font": np.frombuffer(font, np.uint8),
           "cases": np.asarray(json.dumps({
               k: {"song": s, "tail": t, "seed": sd}
               for k, (s, t, sd) in CASES.items()})),
           "auto/song": np.asarray(json.dumps(AUTO_SONG)),
           "golden/song": np.asarray(json.dumps(GOLDEN_SONG)),
           "native/songs": np.asarray(json.dumps(NATIVE_SONGS)),
           "native/sizes": np.asarray(NATIVE_SIZES)}
    got = run_worker("sf2", inp, tmp)
    sf = parse_sf2(font)
    renderer = Sf2Renderer(sf)
    ref = {"sf": sf}
    for name, (spec, tail, seed) in CASES.items():
        song = jax_song(spec)
        ref[name] = (renderer._voices_for(song),
                     renderer.render_song(song, tail=tail, seed=seed))
    ref["method"] = _wav(lambda f: renderer.render_to_wav(
        jax_song(AUTO_SONG), f, seed=3))
    return got, ref


def test_parse_sf2_equals_jax(results):
    got, ref = results
    sf = ref["sf"]
    want = json.loads(json.dumps({
        "presets": {f"{b}/{p}": [dataclasses.asdict(v) for v in vs]
                    for (b, p), vs in sorted(sf.presets.items())},
        "info": sf.info, "n_mods_other": sf.n_mods_other}))
    assert json.loads(str(got["parse/json"])) == want
    np.testing.assert_array_equal(got["parse/samples"], sf.samples)
    assert bool(got["parse/load_equal"])
    assert str(got["parse/bad"]).startswith("ValueError: not an SF2 file")


@pytest.mark.parametrize("name", list(CASES))
def test_render_song_equals_jax(results, name):
    got, ref = results
    (rows, leftovers), want = ref[name]
    np.testing.assert_array_equal(
        got[f"case/{name}/rows"],
        np.asarray(rows, np.float64).reshape(-1, 20))
    assert int(got[f"case/{name}/leftovers"]) == sum(
        len(i.notes) for i in leftovers)
    wave = got[f"case/{name}/wave"]
    assert wave.shape == want.shape and wave.dtype == np.float32
    assert float(np.abs(want).max()) > 0.01
    np.testing.assert_allclose(wave, want, rtol=0, atol=WAVE_ATOL)
    pcm_got = _pcm(got[f"case/{name}/wav"])
    pcm_want = _pcm(_wav(lambda f: write_wav(f, want)))
    assert pcm_got.shape == pcm_want.shape
    assert int(np.abs(pcm_got.astype(np.int32) - pcm_want).max()) <= PCM_LSB


def test_case_shapes_reach_their_paths(results):
    """Each case exercises what it is named for, on JAX's side too."""
    _, ref = results
    assert len(ref["two_chunks"][0][0]) > 128
    assert ref["drum"][0][1] and ref["unmatched"][0][1]
    assert any(r[15] < 19000.0 for r in ref["filter"][0][0])
    assert any(r[17] != 0.0 for r in ref["vibrato"][0][0])
    # past_end: n_exact is the whole 5 s bucket, so the last sample shows
    assert ref["past_end"][1].shape[0] % (5 * RATE) == 0


def test_render_to_wav_auto_takes_the_rung_jax_takes(results, tmp_path,
                                                     monkeypatch):
    got, ref = results
    want = _jax_auto(tmp_path, monkeypatch, jax_song(AUTO_SONG))
    assert int(got["auto/renderers"]) == want["renderers"] == 1
    for rung in ("sf2", "no_sf2", "bad_font"):
        a, b = bytes(got[f"auto/{rung}"]), want[rung]
        assert a[:44] == b[:44], rung
        d = np.abs(_pcm(a).astype(np.int32) - _pcm(b)).max()
        assert int(d) <= PCM_LSB, rung
    # rung 2 is the sampler, not the synth
    assert bytes(got["auto/sf2"]) != bytes(got["auto/no_sf2"])
    assert bytes(got["auto/bad_font"])[44:] == bytes(got["auto/no_sf2"])[44:]
    d = np.abs(_pcm(got["method/wav"]).astype(np.int32)
               - _pcm(ref["method"])).max()
    assert int(d) <= PCM_LSB


def _band_energy(wave, lo_hz, hi_hz, rate=RATE):
    spec = np.abs(np.fft.rfft(wave)) ** 2
    freqs = np.fft.rfftfreq(len(wave), 1.0 / rate)
    sel = (freqs >= lo_hz) & (freqs < hi_hz)
    return float(spec[sel].sum())


def test_spectral_similarity_vs_committed_golden(results):
    got, _ = results
    golden = os.path.join(os.path.dirname(__file__), "golden",
                          "cpp_twin_fixture.wav")
    with wavemod.open(golden, "rb") as w:
        raw = np.frombuffer(w.readframes(w.getnframes()), "<i2")
        theirs = raw.reshape(-1, w.getnchannels()).mean(1) / 32768.0
    ours = got["golden/wave"]
    n = min(len(ours), len(theirs))
    bands = np.geomspace(60, RATE / 2 - 1, 25)

    def prof(w):
        return np.log10(np.asarray(
            [_band_energy(w[:n], lo, hi) for lo, hi in
             zip(bands[:-1], bands[1:])]) + 1e-12)

    r = np.corrcoef(prof(ours), prof(theirs))[0, 1]
    assert r > 0.7, f"band-energy correlation {r:.3f}"


def test_one_voice_against_the_cpp_twin(results):
    got, _ = results
    if not bool(got["native/available"]):
        pytest.skip("no C++ toolchain")
    for i in range(len(NATIVE_SONGS)):
        port, cpp = got[f"native/{i}/port"], got[f"native/{i}/cpp"]
        peak = max(float(np.abs(port).max()), 1e-9)
        assert peak > 0.01
        assert float(np.abs(port - cpp).max()) / peak < 2e-3, i
    h = got["native/helpers"]
    np.testing.assert_allclose(h[:, 0], h[:, 1], rtol=1e-12, atol=1e-12)
