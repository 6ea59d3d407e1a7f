"""WAV rendering in fidelity order: the host's fluidsynth CLI with a
soundfont when both exist; a soundfont without the binary through the
SoundFont sampler on the device (``audio/sampler.py``); else the additive
synthesizer on the device.

Port of ``eamg_tpu/audio/fluidsynth.py``. The soundfont is
``EAMG_SOUNDFONT``, else the first ``.sf2`` of the reference's
``generate_music`` directory or of the system soundfont directories.
``EAMG_NO_FLUIDSYNTH=1`` skips the binary and ``EAMG_NO_SF2=1`` the
sampler, as in the JAX package.
"""

from __future__ import annotations

import os
import shutil
import subprocess
import tempfile

from ..midi.smf import MidiSong
from ..utils.device import resolve_device
from .synth import SAMPLE_RATE, render_to_wav as _render_additive

_SF2_CANDIDATE_DIRS = (
    "generate_music",
    "/usr/share/sounds/sf2",
    "/usr/share/soundfonts",
    "/usr/local/share/soundfonts",
)

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


_sf2_renderers: dict = {}  # (path, device) -> Sf2Renderer (bank on it)


def render_to_wav_auto(song: MidiSong, path_or_file, seed: int = 0,
                       device=None) -> None:
    """1. the fluidsynth CLI + a soundfont; 2. a soundfont without the
    binary: the SoundFont sampler on ``device``; 3. neither: the additive
    synthesizer on ``device``. ``EAMG_NO_FLUIDSYNTH=1`` skips 1,
    ``EAMG_NO_SF2=1`` skips 2. A font the parser refuses (``ValueError``,
    ``OSError``) falls through to 3, as in JAX; any other error, a device's
    included, propagates."""
    if not os.environ.get("EAMG_NO_FLUIDSYNTH"):
        found = find_fluidsynth()
        if found is not None:
            try:
                render_to_wav_fluidsynth(song, path_or_file, *found)
                return
            except (subprocess.SubprocessError, OSError):
                pass  # broken host install: fall back
    if not os.environ.get("EAMG_NO_SF2"):
        sf2 = find_soundfont()
        if sf2 is not None:
            dev = resolve_device(device)
            try:
                key = (sf2, str(dev))
                if key not in _sf2_renderers:
                    from .sampler import Sf2Renderer

                    _sf2_renderers[key] = Sf2Renderer(sf2, device=dev)
                _sf2_renderers[key].render_to_wav(song, path_or_file,
                                                  seed=seed)
                return
            except (ValueError, OSError):
                pass  # unparseable soundfont: fall back
    _render_additive(song, path_or_file, seed=seed, device=device)
