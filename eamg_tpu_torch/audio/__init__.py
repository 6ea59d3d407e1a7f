"""Audio rendering: the fluidsynth CLI when the host has it, else the
additive synthesizer on the device."""

from .fluidsynth import (find_fluidsynth, find_soundfont,
                         render_to_wav_auto, render_to_wav_fluidsynth)
from .synth import SAMPLE_RATE, render_song, render_to_wav, write_wav

__all__ = ["SAMPLE_RATE", "find_fluidsynth", "find_soundfont",
           "render_song", "render_to_wav", "render_to_wav_auto",
           "render_to_wav_fluidsynth", "write_wav"]
