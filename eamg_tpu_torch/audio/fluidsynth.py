"""WAV rendering in fidelity order: the host's fluidsynth CLI with a
soundfont when both exist, else the additive synthesizer on the device.

Port of ``eamg_tpu/audio/fluidsynth.py``. The JAX package has a middle
rung, its SoundFont sample renderer (audio/sampler.py) for hosts with a
soundfont but no binary; that renderer is not in the port yet, and the
port says so once when it skips the rung.
"""

from __future__ import annotations

import os
import shutil
import subprocess
import tempfile

from ..midi.smf import MidiSong
from .synth import SAMPLE_RATE, render_to_wav as _render_additive

_SF2_CANDIDATE_DIRS = (
    "generate_music",
    "/usr/share/sounds/sf2",
    "/usr/share/soundfonts",
    "/usr/local/share/soundfonts",
)

_said_sf2_skip = False


def find_soundfont() -> str | None:
    """Path to a .sf2 on this host: ``EAMG_SOUNDFONT``, the reference's
    own location, then common system soundfont dirs."""
    sf2 = os.environ.get("EAMG_SOUNDFONT", "")
    if sf2 and os.path.isfile(sf2):
        return sf2
    for d in _SF2_CANDIDATE_DIRS:
        if not os.path.isdir(d):
            continue
        for name in sorted(os.listdir(d)):
            if name.lower().endswith(".sf2"):
                return os.path.join(d, name)
    return None


def find_fluidsynth() -> tuple[str, str] | None:
    """(binary, soundfont) when both are present on this host, else None."""
    binary = os.environ.get("EAMG_FLUIDSYNTH") or shutil.which("fluidsynth")
    if not binary or not os.path.exists(binary):
        return None
    sf2 = find_soundfont()
    return (binary, sf2) if sf2 else None


def render_to_wav_fluidsynth(song: MidiSong, path_or_file,
                             binary: str, soundfont: str,
                             sample_rate: int = SAMPLE_RATE) -> None:
    """The reference's midi2audio call: temp .mid in, .wav out."""
    with tempfile.TemporaryDirectory() as td:
        mid = os.path.join(td, "in.mid")
        wav = os.path.join(td, "out.wav")
        with open(mid, "wb") as f:
            song.write(f)
        subprocess.run(
            [binary, "-ni", soundfont, mid, "-F", wav,
             "-r", str(sample_rate)],
            check=True, capture_output=True, timeout=120)
        with open(wav, "rb") as f:
            data = f.read()
    if isinstance(path_or_file, (str, os.PathLike)):
        with open(path_or_file, "wb") as f:
            f.write(data)
    else:
        path_or_file.write(data)


def render_to_wav_auto(song: MidiSong, path_or_file, seed: int = 0,
                       device=None) -> None:
    """1. the fluidsynth CLI + a soundfont; 2. (the SoundFont sampler, not
    in the port yet); 3. the additive synthesizer on ``device``.
    ``EAMG_NO_FLUIDSYNTH=1`` skips 1."""
    global _said_sf2_skip
    if not os.environ.get("EAMG_NO_FLUIDSYNTH"):
        found = find_fluidsynth()
        if found is not None:
            try:
                render_to_wav_fluidsynth(song, path_or_file, *found)
                return
            except (subprocess.SubprocessError, OSError):
                pass  # broken host install: fall back
    if not _said_sf2_skip and find_soundfont() is not None:
        _said_sf2_skip = True
        print("[audio] a soundfont was found but the SoundFont sampler is "
              "not in the port yet; rendering with the additive synth")
    _render_additive(song, path_or_file, seed=seed, device=device)
