"""Audio rendering, in fidelity order: the fluidsynth CLI when the host
has it with a soundfont; a soundfont without the binary through the
SoundFont sampler on the device; else the additive synthesizer on the
device."""

from .fluidsynth import (find_fluidsynth, find_soundfont,
                         render_to_wav_auto, render_to_wav_fluidsynth)
from .sampler import Sf2Renderer
from .sf2 import SoundFont, load_sf2, parse_sf2
from .synth import SAMPLE_RATE, render_song, render_to_wav, write_wav

__all__ = ["SAMPLE_RATE", "Sf2Renderer", "SoundFont", "find_fluidsynth",
           "find_soundfont", "load_sf2", "parse_sf2", "render_song",
           "render_to_wav", "render_to_wav_auto", "render_to_wav_fluidsynth",
           "write_wav"]
