"""Standard MIDI File codec and in-memory song containers.

From-scratch replacement for the subset of ``pretty_midi`` the reference uses
(loading: midi_test/midi_extract.py:5-29; assembly+writing: api_cache.py:208-228).
Pure host-side Python; no third-party dependencies.

Reader: formats 0/1/2, running status, tempo map (tick->seconds conversion
honours every Set Tempo meta event), note-on/off pairing per (track, channel,
pitch) with note-on velocity 0 treated as note-off, program changes tracked
per channel, channel 10 (index 9) flagged as drums, track-name metas attached
to the instruments created in that track.

Writer: format 1, track 0 carries the tempo, one track per instrument.
"""

from __future__ import annotations

import os
import struct
from dataclasses import dataclass, field

import numpy as np

from .names import program_to_instrument_name

DEFAULT_USPB = 500_000  # 120 BPM in microseconds per beat


@dataclass
class Note:
    """A single note: velocity 0-127, pitch 0-127, start/end in seconds."""

    velocity: int
    pitch: int
    start: float
    end: float

    @property
    def duration(self) -> float:
        return self.end - self.start

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return (f"Note(velocity={self.velocity}, pitch={self.pitch}, "
                f"start={self.start:.6f}, end={self.end:.6f})")


@dataclass
class PitchBend:
    """A pitch-wheel event: ``pitch`` in -8192..8191 (center 0), time in
    seconds — the pretty_midi.PitchBend shape. Consumed by the SF2
    renderer's §8.4.3 default modulator at the GM ±2-semitone range."""

    pitch: int
    time: float


@dataclass
class Instrument:
    """A program (GM patch) with its note list."""

    program: int
    is_drum: bool = False
    name: str = ""
    notes: list[Note] = field(default_factory=list)
    pitch_bends: list[PitchBend] = field(default_factory=list)

    def get_end_time(self) -> float:
        return max((n.end for n in self.notes), default=0.0)


class MidiSong:
    """In-memory MIDI song: a tempo map plus a list of :class:`Instrument`.

    API mirrors the slice of pretty_midi.PrettyMIDI the reference relies on:
    ``instruments``, ``get_tempo_changes()`` (midi_extract.py:7),
    ``get_end_time()``, ``write()`` (api_cache.py:226-228).
    """

    def __init__(self, path_or_file=None, initial_tempo: float = 120.0,
                 resolution: int = 480):
        self.resolution = resolution
        self.instruments: list[Instrument] = []
        # Parallel arrays: tempo-change times (seconds) and tempi (BPM).
        self._tempo_times = np.array([0.0])
        self._tempi = np.array([float(initial_tempo)])
        if path_or_file is not None:
            if isinstance(path_or_file, bytes):
                data = path_or_file  # raw SMF bytes
            elif isinstance(path_or_file, (str, os.PathLike)):
                with open(path_or_file, "rb") as f:
                    data = f.read()
            else:
                data = path_or_file.read()
            self._parse(data)

    # ------------------------------------------------------------------ API

    def get_tempo_changes(self) -> tuple[np.ndarray, np.ndarray]:
        """(times_in_seconds, tempi_in_bpm) — same contract as pretty_midi."""
        return self._tempo_times.copy(), self._tempi.copy()

    def get_end_time(self) -> float:
        return max((i.get_end_time() for i in self.instruments), default=0.0)

    # -------------------------------------------------------------- parsing

    def _parse(self, data: bytes) -> None:
        if data[:4] != b"MThd":
            raise ValueError("not a Standard MIDI File (missing MThd)")
        hdr_len = struct.unpack(">I", data[4:8])[0]
        fmt, ntrks, division = struct.unpack(">HHH", data[8:14])
        if division & 0x8000:
            # SMPTE time division: frames/sec * ticks/frame.
            fps = 256 - (division >> 8)  # two's complement of high byte
            tpf = division & 0xFF
            self._smpte_sec_per_tick = 1.0 / (fps * tpf)
            self.resolution = tpf
        else:
            self._smpte_sec_per_tick = None
            self.resolution = division
        pos = 8 + hdr_len

        tracks: list[list[tuple[int, bytes, bytes]]] = []
        tempo_events: list[tuple[int, int]] = []  # (tick, us_per_beat)
        for _ in range(ntrks):
            if pos + 8 > len(data):
                break  # truncated file: keep what we have
            if data[pos:pos + 4] != b"MTrk":
                # Unknown chunk: skip it.
                clen = struct.unpack(">I", data[pos + 4:pos + 8])[0]
                pos += 8 + clen
                continue
            clen = struct.unpack(">I", data[pos + 4:pos + 8])[0]
            chunk = data[pos + 8:pos + 8 + clen]
            pos += 8 + clen
            tracks.append(self._parse_track(chunk, tempo_events))

        tempo_events.sort(key=lambda t: t[0])
        self._build_tempo_map(tempo_events)
        self._build_instruments(tracks)

    @staticmethod
    def _read_varlen(buf: bytes, i: int) -> tuple[int, int]:
        value = 0
        while True:
            b = buf[i]
            i += 1
            value = (value << 7) | (b & 0x7F)
            if not b & 0x80:
                return value, i

    def _parse_track(self, buf: bytes, tempo_events: list[tuple[int, int]]
                     ) -> list[tuple[int, bytes, bytes]]:
        """Returns [(tick, status_byte, payload)] for channel messages plus
        track-name metas encoded as status 0xFF03."""
        events: list[tuple[int, bytes, bytes]] = []
        tick, i, status = 0, 0, 0
        n = len(buf)
        while i < n:
            delta, i = self._read_varlen(buf, i)
            tick += delta
            b = buf[i]
            if b == 0xFF:  # meta
                meta_type = buf[i + 1]
                length, j = self._read_varlen(buf, i + 2)
                payload = buf[j:j + length]
                i = j + length
                if meta_type == 0x51 and length == 3:
                    uspb = (payload[0] << 16) | (payload[1] << 8) | payload[2]
                    tempo_events.append((tick, uspb))
                elif meta_type == 0x03:
                    events.append((tick, b"\xff\x03", payload))
                elif meta_type == 0x2F:
                    break  # end of track
                status = 0
            elif b in (0xF0, 0xF7):  # sysex
                length, j = self._read_varlen(buf, i + 1)
                i = j + length
                status = 0
            else:
                if b & 0x80:
                    status = b
                    i += 1
                elif status == 0:
                    raise ValueError("running status without prior status")
                kind = status & 0xF0
                if kind in (0x80, 0x90, 0xA0, 0xB0, 0xE0):
                    payload = buf[i:i + 2]
                    i += 2
                elif kind in (0xC0, 0xD0):
                    payload = buf[i:i + 1]
                    i += 1
                else:
                    raise ValueError(f"bad status byte {status:#x}")
                events.append((tick, bytes([status]), payload))
        return events

    def _build_tempo_map(self, tempo_events: list[tuple[int, int]]) -> None:
        """Convert (tick, us/beat) events into (seconds, BPM) arrays and keep
        the tick->seconds conversion table."""
        if self._smpte_sec_per_tick is not None:
            self._tick_marks = np.array([0])
            self._sec_marks = np.array([0.0])
            self._sec_per_tick = np.array([self._smpte_sec_per_tick])
            self._tempo_times = np.array([0.0])
            self._tempi = np.array([60.0 / (self._smpte_sec_per_tick
                                            * self.resolution)])
            return
        merged: list[tuple[int, int]] = []
        for tick, uspb in tempo_events:
            if merged and merged[-1][0] == tick:
                merged[-1] = (tick, uspb)
            else:
                merged.append((tick, uspb))
        if not merged or merged[0][0] != 0:
            merged.insert(0, (0, DEFAULT_USPB))
        ticks = np.array([t for t, _ in merged], dtype=np.int64)
        uspbs = np.array([u for _, u in merged], dtype=np.float64)
        spt = uspbs / (1e6 * self.resolution)  # seconds per tick per segment
        secs = np.zeros(len(merged))
        for k in range(1, len(merged)):
            secs[k] = secs[k - 1] + (ticks[k] - ticks[k - 1]) * spt[k - 1]
        self._tick_marks = ticks
        self._sec_marks = secs
        self._sec_per_tick = spt
        self._tempo_times = secs.copy()
        self._tempi = 6e7 / uspbs

    def _tick_to_time(self, tick: int) -> float:
        k = int(np.searchsorted(self._tick_marks, tick, side="right") - 1)
        return float(self._sec_marks[k]
                     + (tick - self._tick_marks[k]) * self._sec_per_tick[k])

    def _build_instruments(self, tracks) -> None:
        for events in tracks:
            track_name = ""
            # channel -> current program
            programs: dict[int, int] = {}
            # (channel, pitch) -> list of (start_tick, velocity, program)
            open_notes: dict[tuple[int, int], list[tuple[int, int, int]]] = {}
            # (program, is_drum) -> Instrument, per track
            insts: dict[tuple[int, bool], Instrument] = {}

            def get_inst(program: int, channel: int) -> Instrument:
                key = (program, channel == 9)
                if key not in insts:
                    insts[key] = Instrument(program=program,
                                            is_drum=channel == 9,
                                            name=track_name)
                return insts[key]

            for tick, status, payload in events:
                if status == b"\xff\x03":
                    track_name = payload.decode("latin1").strip("\x00")
                    for inst in insts.values():
                        if not inst.name:
                            inst.name = track_name
                    continue
                st = status[0]
                kind, channel = st & 0xF0, st & 0x0F
                if kind == 0xC0:
                    programs[channel] = payload[0]
                elif kind == 0xE0:
                    # pitch wheel: 14-bit LSB-first, center 8192 -> 0
                    get_inst(programs.get(channel, 0),
                             channel).pitch_bends.append(PitchBend(
                                 pitch=(payload[0] | (payload[1] << 7))
                                 - 8192,
                                 time=self._tick_to_time(tick)))
                elif kind == 0x90 and payload[1] > 0:
                    open_notes.setdefault((channel, payload[0]), []).append(
                        (tick, payload[1], programs.get(channel, 0)))
                elif kind == 0x80 or (kind == 0x90 and payload[1] == 0):
                    stack = open_notes.get((channel, payload[0]))
                    if stack:
                        start_tick, vel, prog = stack.pop(0)
                        if tick > start_tick:
                            get_inst(prog, channel).notes.append(Note(
                                velocity=vel, pitch=payload[0],
                                start=self._tick_to_time(start_tick),
                                end=self._tick_to_time(tick)))
            for inst in insts.values():
                if inst.notes:
                    inst.notes.sort(key=lambda n: (n.start, n.pitch))
                    self.instruments.append(inst)

    # -------------------------------------------------------------- writing

    def _time_to_tick(self, t: float) -> int:
        k = int(np.searchsorted(self._sec_marks, t, side="right") - 1)
        return int(round(self._tick_marks[k]
                         + (t - self._sec_marks[k]) / self._sec_per_tick[k]))

    def write(self, file) -> None:
        """Write a format-1 SMF to a path or binary file object."""
        if not hasattr(self, "_tick_marks"):
            uspb = 6e7 / float(self._tempi[0])
            self._tick_marks = np.array([0])
            self._sec_marks = np.array([0.0])
            self._sec_per_tick = np.array([uspb / (1e6 * self.resolution)])

        def varlen(value: int) -> bytes:
            out = [value & 0x7F]
            value >>= 7
            while value:
                out.append((value & 0x7F) | 0x80)
                value >>= 7
            return bytes(reversed(out))

        def track_chunk(events: list[tuple[int, bytes]]) -> bytes:
            events.sort(key=lambda e: e[0])
            body = bytearray()
            last = 0
            for tick, msg in events:
                body += varlen(tick - last) + msg
                last = tick
            body += varlen(0) + b"\xff\x2f\x00"
            return b"MTrk" + struct.pack(">I", len(body)) + bytes(body)

        chunks = []
        # Track 0: tempo map.
        tempo_events: list[tuple[int, bytes]] = []
        for t_sec, bpm in zip(self._tempo_times, self._tempi):
            uspb = int(round(6e7 / bpm))
            tempo_events.append((self._time_to_tick(float(t_sec)),
                                 b"\xff\x51\x03"
                                 + uspb.to_bytes(3, "big")))
        chunks.append(track_chunk(tempo_events))

        for idx, inst in enumerate(self.instruments):
            channel = 9 if inst.is_drum else [c for c in range(16)
                                              if c != 9][idx % 15]
            events: list[tuple[int, bytes]] = []
            if inst.name:
                events.append((0, b"\xff\x03" + varlen(len(inst.name))
                               + inst.name.encode("latin1", "replace")))
            events.append((0, bytes([0xC0 | channel, inst.program & 0x7F])))
            for pb in inst.pitch_bends:
                raw = max(0, min(16383, pb.pitch + 8192))
                events.append((self._time_to_tick(pb.time),
                               bytes([0xE0 | channel, raw & 0x7F,
                                      (raw >> 7) & 0x7F])))
            for note in inst.notes:
                on = self._time_to_tick(note.start)
                off = max(self._time_to_tick(note.end), on + 1)
                events.append((on, bytes([0x90 | channel, note.pitch & 0x7F,
                                          max(1, min(127, note.velocity))])))
                events.append((off, bytes([0x80 | channel, note.pitch & 0x7F,
                                           64])))
            chunks.append(track_chunk(events))

        header = b"MThd" + struct.pack(">IHHH", 6, 1, len(chunks),
                                       self.resolution)
        payload = header + b"".join(chunks)
        if isinstance(file, (str, os.PathLike)):
            with open(file, "wb") as f:
                f.write(payload)
        else:
            file.write(payload)

    # ------------------------------------------------------------- helpers

    def instrument_display_name(self, inst: Instrument) -> str:
        """Track name if present else the GM program name — the same rule the
        reference uses at midi_test/midi_extract.py:17."""
        return inst.name or program_to_instrument_name(inst.program)
