"""End-to-end request pipeline: text -> emotion -> prompt -> MIDI -> WAV.

Port of ``eamg_tpu/serve/pipeline.py``: classify, EATS-map, assemble
control tokens, decode, detokenize, render. Per-phase wall-clock timings
are returned as in the JAX package. Two token schemes are served, as
there: Scheme A (text control tokens, ``demo_ckpt_a``) and Scheme B3 (a
``[START_SEQ] BPM_x KEY_y`` prefix, an id-level decode and the id -> MIDI
detokenizer, ``demo_ckpt_b3``). B3 serves solo: the batchers are wired
for the Scheme-A flow, so ``coalesce`` is switched off for it, as in the
JAX package.

``generate_sections`` classifies each sentence of the prompt and decodes
a section for it, the sections laid end to end. ``generate_stream`` is
the incremental twin of both, a generator of the events the SSE server
sends: a ``meta`` event per section, ``tokens`` deltas as the decode's
chunks complete (the solo stream of ``decode/stream.py``, or an engine
row's ``submit_stream``), and a ``done`` event with the MIDI (and WAV)
as base64.

The decode takes one of three routes, as in the JAX package. With
``coalesce="continuous"`` requests go through the persistent engine
(``serve/continuous.py``), where they join and leave a running ragged
decode; a lone request on an idle engine is decoded detached
(``ContinuousBatcher.run_detached``: the engine's own functions on a
private state, so its bytes are those of an engine row) under a
single-permit gate, and concurrent followers join the engine. With
``coalesce="window"`` requests that arrive within 10 ms share one ragged
decode (``serve/batcher.py``). Without either, or for a request the
batcher does not accept, the solo cached decode
(``Generator.sample_kvcache``) runs. Penalties, n-gram bans and
``grammar`` (the served scheme's FSM, :meth:`Pipeline.grammar`) ride the
window batcher, and the engine when it was built for them (per-row
sampling, its n-gram size, ``coalesce_opts["grammar"]``); a request with
any of them never takes the idle engine's detached decode, whose row
carries none, but joins the engine even when it arrives alone.

The request options of the page decode solo, on either scheme and with
any ``coalesce``, as JAX's default configuration does: ``medusa`` (the
checkpoint's ``medusa_heads.pkl``, loaded and probed at start-up;
one-shot or streamed a verify chunk at a time), ``lookup`` (prompt-lookup
speculation) and ``beams`` (beam search, ranked with ``length_penalty``,
grammar-constrained with ``grammar``). With ``engine_medusa`` the
continuous engine carries the heads, and medusa requests it accepts join
it, one-shot or streamed, even alone (no detached decode: the solo Medusa
decode is another program). They refuse what JAX refuses, with
its ``ValueError``: speculation with penalties, n-gram bans or grammar,
lookup with medusa, beams with the sampling features or with speculation,
medusa without heads.

``demo_pipeline`` and ``demo_pipeline_b3`` build pipelines on randomly
initialised models (JAX's weights for the seed) for ``serve
--random-demo``; ``packaged_demo_checkpoint`` names the shipped demo that
``serve`` takes without ``--checkpoint``.

The threaded HTTP server calls ``generate`` from several threads. One lock
per pipeline serialises the solo decode and the synth; it is not held
while a request waits in the engine or the batcher, or requests would
never coalesce.
"""

from __future__ import annotations

import base64
import io
import os
import threading
import time
from dataclasses import dataclass, field

import torch

from ..audio import render_to_wav_auto
from ..decode import Generator
from ..emotion import EmotionClassifier, get_music_params, segment_text
from ..midi.smf import MidiSong, Note
from ..tokenizer import (SchemeB3, Vocab, assemble_prompt, detect_scheme,
                         tokens_to_song)
from ..utils.checkpoint import load_checkpoint
from ..utils.device import resolve_device

# the JAX package's shipped demo checkpoints, read as data
_DEMOS = os.path.join(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__)))), "eamg_tpu", "serve")
DEMO_CKPT_A = os.path.join(_DEMOS, "demo_ckpt_a")
DEMO_CKPT_B3 = os.path.join(_DEMOS, "demo_ckpt_b3")


def _merge_song(merged: MidiSong, by_track: dict, song: MidiSong,
                offset: float) -> None:
    """Append ``song``'s notes into ``merged`` shifted by ``offset``
    seconds, pooling instruments by (program, is_drum)."""
    for inst in song.instruments:
        key = (inst.program, inst.is_drum)
        tgt = by_track.get(key)
        if tgt is None:
            tgt = type(inst)(program=inst.program, is_drum=inst.is_drum,
                             name=inst.name)
            by_track[key] = tgt
            merged.instruments.append(tgt)
        tgt.notes.extend(Note(n.velocity, n.pitch, n.start + offset,
                              n.end + offset) for n in inst.notes)


class _Sections:
    """Sections' songs laid end to end on the time axis, ``gap_s`` apart,
    instruments pooled by (program, is_drum): ``song`` so far."""

    def __init__(self, gap_s: float):
        self.song, self.gap_s = MidiSong(), gap_s
        self._by_track: dict = {}
        self._offset = 0.0

    def add(self, song: MidiSong) -> None:
        _merge_song(self.song, self._by_track, song, self._offset)
        self._offset = self.song.get_end_time() + self.gap_s


@dataclass
class GenerationResult:
    label: str
    mapping: dict
    prompt_tokens: list
    tokens: list
    midi_bytes: bytes
    wav_bytes: bytes | None
    timings_ms: dict = field(default_factory=dict)
    dropped_tokens: list = field(default_factory=list)


class Pipeline:
    """scheme="a": text control tokens; solo, window-coalesced or
    continuous-engine decode. scheme="b3": the BPM/KEY control prefix,
    the id-level decode and the id -> MIDI detokenizer, solo."""

    def __init__(self, generator: Generator,
                 classifier: EmotionClassifier | None = None,
                 full_gm: bool = False, render_audio: bool = True,
                 coalesce=False, coalesce_opts: dict | None = None,
                 fast_routing: bool = False, scheme: str = "a",
                 scheme_b: SchemeB3 | None = None,
                 medusa_heads: dict | None = None,
                 engine_medusa: bool = False):
        self.generator = generator
        # Medusa heads (tools.medusa.load_medusa_heads) serve medusa=true
        # requests; None refuses them. The acceptance probe rides /stats;
        # pipeline_from_checkpoint fills both, and the reason when the
        # checkpoint's heads cannot serve.
        self.medusa_heads = medusa_heads
        self.medusa_probe = medusa_heads.get("probe") if medusa_heads \
            else None
        self.medusa_unavailable = None
        self.device = generator.device
        self.classifier = classifier or EmotionClassifier(device=self.device)
        self.full_gm = full_gm
        self.render_audio = render_audio
        self.scheme = scheme
        if scheme == "b3" and scheme_b is None:
            scheme_b = SchemeB3(seq_len=generator.cfg.seq_len)
        self.scheme_b = scheme_b
        if scheme != "a":
            # the batchers are wired for the Scheme-A flow; B3 serves solo
            coalesce = False
        self._grammar_obj = None     # built at its first use
        opts = dict(coalesce_opts or {})
        # coalesce_opts {"grammar": True} puts the scheme's FSM into the
        # batcher, so grammar requests ride the shared decode
        if opts.pop("grammar", False) and coalesce:
            opts["grammar"] = self.grammar()
        self._lock = threading.Lock()
        # coalesce=True/"window" batches requests arriving within a window
        # into one ragged decode; "continuous" runs the persistent engine.
        # Both require the corrected causal config.
        self.batcher = None
        # at most ONE in-flight request may bypass an IDLE continuous
        # engine for the detached decode; the single-permit gate keeps a
        # burst from queueing up on that serial path: followers join the
        # engine, which is what it is for
        self._solo_gate = threading.Semaphore(1)
        # fast_routing=True decodes bypassed rows through the batch-1
        # ragged decode instead: fewer rows per step, but matrix products
        # of another shape than the engine's, so on the card a near tie
        # may fall the other way and same-seed bytes may then depend on
        # the load a request ran under. Default False: run_detached.
        self.fast_routing = bool(fast_routing)
        if coalesce == "continuous":
            from .continuous import ContinuousBatcher

            # engine_medusa puts the heads into the engine, so medusa=true
            # requests join the shared decode; off by default, as in JAX
            # (whose engine Medusa measured 0.48-0.85x and taxed plain
            # rows there): medusa requests then decode solo
            if engine_medusa and medusa_heads is not None \
                    and "medusa_heads" not in opts:
                opts["medusa_heads"] = medusa_heads
            self.batcher = ContinuousBatcher(generator, **opts)
        elif coalesce:
            from .batcher import RequestBatcher

            self.batcher = RequestBatcher(generator, **opts)

    def grammar(self):
        """The served scheme's decoding FSM (``decode/grammar.py``), built
        once: the control-token grammar on B3, the instrument-section one
        on Scheme A. Its device tables are made once too, so the graphs
        that read them stay valid."""
        if self._grammar_obj is None:
            from ..decode.grammar import grammar_a, grammar_b3

            self._grammar_obj = (grammar_b3(self.scheme_b)
                                 if self.scheme == "b3"
                                 else grammar_a(self.generator.vocab))
        return self._grammar_obj

    def warmup(self) -> None:
        """Build the kernels and capture the decode's graphs before
        serving: one request through the route this pipeline serves; with a
        continuous engine, one engine row and one detached decode too (a
        streamed request rides the engine's chunk, and so do the rows with
        penalties, an n-gram ban or grammar: their options are the
        engine's, one graph); with the window batcher, one ragged decode at
        each batch size it pads a group to (with and without its grammar);
        without an engine, the first chunk of a solo stream, whose graph the
        streamed requests replay. With Medusa heads, one medusa request
        too: it captures the verify chunk's graph, which the one-shot and
        the streamed medusa requests replay alike."""
        self.generate("warm up the kernels", seed=0,
                      render_audio=self.render_audio)
        if self.medusa_heads is not None:
            self.generate("warm up the kernels", seed=0, render_audio=False,
                          medusa=True)
        from .batcher import RequestBatcher
        from .continuous import ContinuousBatcher

        start = [t for t in ("[START_SEQUENCE]",)
                 if t in self.generator.vocab]
        ids = self.generator.vocab.encode(start) if start else [1]
        if isinstance(self.batcher, ContinuousBatcher):
            # both of its graphs: the engine's chunk and the detached
            # decode's (the request above took one route); an engine with
            # Medusa rows captures its Medusa chunk too
            self.batcher.submit(ids, temperature=1.0, seed=0,
                                top_p=self.batcher.top_p)
            self.batcher.run_detached(ids, seed=0, top_p=self.batcher.top_p)
            if self.batcher.medusa:
                self.batcher.submit(ids, temperature=1.0, seed=0,
                                    top_p=self.batcher.top_p, medusa=True)
            return
        if isinstance(self.batcher, RequestBatcher):
            self.batcher.warmup(ids)
        deltas = self._stream_deltas(ids, 1.0, 50, 0)
        next(deltas, None)
        deltas.close()

    def _solo_ragged(self, prompt_ids: list, temperature: float, seed: int,
                     top_p: float, min_p: float) -> list:
        """Bypassed-row decode; the caller holds the single-permit gate.
        Default: ``ContinuousBatcher.run_detached``. fast_routing: the
        batch-1 ragged decode (see ``__init__``)."""
        b = self.batcher
        if not self.fast_routing:
            return b.run_detached(prompt_ids, temperature=temperature,
                                  seed=seed, top_p=top_p, min_p=min_p)
        import numpy as np

        from ..decode.api import _bucket
        from ..decode.ragged import generate_kv_ragged
        from ..utils import prng

        gen = self.generator
        if len(prompt_ids) >= b.max_len:
            return list(prompt_ids)       # zero steps (engine contract)
        width = min(_bucket(len(prompt_ids)), b.max_len)
        prompt = np.zeros((1, width), np.int64)
        prompt[0, :len(prompt_ids)] = prompt_ids
        buf, pos = generate_kv_ragged(
            gen.params, torch.from_numpy(prompt).to(self.device),
            [len(prompt_ids)], prng.key_rows([int(seed)]), gen.cfg,
            b.max_len, temperature=float(temperature), top_k=b.top_k,
            eos_id=gen.eos_id, pad_id=gen.pad_id, greedy=b.greedy,
            mask_value=b.mask_value, top_p=float(top_p), min_p=float(min_p))
        return buf[0, :int(pos[0])].tolist()

    def _prompt_for(self, mapping: dict) -> tuple:
        """mapping -> (prompt tokens, prompt ids, dropped tokens). B3: the
        control prefix of the mapping's BPM and key. A: the assembled
        control tokens; a data-dependent vocabulary may lack one, which
        is dropped and reported (the reference crashed with a
        KeyError)."""
        if self.scheme == "b3":
            ids = self.scheme_b.control_prefix(mapping["bpm"],
                                               mapping["key"])
            return self.scheme_b.vocab.decode(ids), ids, []
        vocab = self.generator.vocab
        gen_prompt = assemble_prompt(vocab, mapping, full_gm=self.full_gm)
        known = [t for t in gen_prompt if t in vocab]
        dropped = [t for t in gen_prompt if t not in vocab]
        return known, vocab.encode(known), dropped

    def _song(self, ids: list) -> tuple:
        """Generated ids (prompt included) -> (token strings, MidiSong)."""
        if self.scheme == "b3":
            return (self.scheme_b.vocab.decode(ids),
                    self.scheme_b.decode_to_song(ids))
        tokens = self.generator.vocab.decode(ids)
        return tokens, tokens_to_song(tokens)

    def _check_options(self, penalties, no_repeat_ngram: int, grammar: bool,
                       lookup: bool, medusa: bool, beams: int) -> None:
        """The compositions JAX's pipeline refuses, with its ValueErrors."""
        if (lookup or medusa) and (penalties is not None or no_repeat_ngram
                                   or grammar):
            raise ValueError(
                "lookup/medusa do not compose with penalties, n-gram bans "
                "or grammar constraints (history-dependent distributions "
                "break the proposal/target acceptance math)")
        if lookup and medusa:
            raise ValueError("lookup and medusa are mutually exclusive "
                             "speculation modes")
        if beams:
            if penalties is not None or no_repeat_ngram:
                raise ValueError(
                    "beams is a deterministic argmax-tree search; "
                    "penalties/n-gram transforms are sampling-path "
                    "features (grammar composes)")
            if lookup or medusa:
                raise ValueError("beams does not compose with the "
                                 "speculation modes (lookup/medusa)")
        if medusa and self.medusa_heads is None:
            raise ValueError(self.medusa_unavailable or (
                "this serving checkpoint ships no Medusa heads (train them "
                "with `cli train-medusa` and place medusa_heads.pkl next to "
                "the checkpoint)"))

    def _solo_option(self, prompt_ids: list, temperature: float, top_k: int,
                     run_seed: int, top_p: float, min_p: float, lookup: bool,
                     medusa: bool, beams: int, length_penalty: float,
                     grammar=None) -> list:
        """The ids (prompt included) of a request for medusa, lookup or
        beams (with ``grammar``, the FSM or None): a solo decode under the
        pipeline's lock, as JAX decodes them in its default
        configuration."""
        gen = self.generator
        with self._lock:
            if beams:
                return gen.generate_ids_beam(
                    prompt_ids, n_beams=beams, length_penalty=length_penalty,
                    grammar=grammar).tolist()
            sampling = dict(temperature=temperature, top_k=top_k,
                            seed=run_seed, top_p=top_p, min_p=min_p)
            if medusa:
                return gen.generate_ids_medusa(
                    self.medusa_heads, prompt_ids, **sampling)[0].tolist()
            return gen.generate_ids_lookup(prompt_ids, **sampling)[0].tolist()

    def _engine_medusa(self, top_k: int, top_p: float, min_p: float) -> bool:
        """Whether a medusa request with these values joins the engine."""
        from .continuous import ContinuousBatcher

        return isinstance(self.batcher, ContinuousBatcher) \
            and self.batcher.accepts(top_k=top_k, top_p=top_p, min_p=min_p,
                                     medusa=True)

    def _decode(self, mapping: dict, temperature: float, top_k: int,
                run_seed: int, top_p: float, min_p: float,
                penalties: tuple | None = None, no_repeat_ngram: int = 0,
                grammar: bool = False, lookup: bool = False,
                medusa: bool = False, beams: int = 0,
                length_penalty: float = 1.0):
        """mapping -> (prompt tokens, tokens, song, dropped): prompt
        assembly, decode and detokenization, shared by single-shot and
        multi-section generation."""
        self._check_options(penalties, no_repeat_ngram, grammar, lookup,
                            medusa, beams)
        gen = self.generator
        gram = self.grammar() if grammar else None
        known, prompt_ids, dropped = self._prompt_for(mapping)
        if medusa and self._engine_medusa(top_k, top_p, min_p):
            # a Medusa-capable engine serves medusa rows with its own
            # programs always, never detached
            ids = self.batcher.submit(prompt_ids, temperature=temperature,
                                      top_k=top_k, seed=run_seed,
                                      top_p=top_p, min_p=min_p, medusa=True)
        elif lookup or medusa or beams:
            ids = self._solo_option(prompt_ids, temperature, top_k, run_seed,
                                    top_p, min_p, lookup, medusa, beams,
                                    length_penalty, gram)
        if lookup or medusa or beams:
            if self.scheme == "b3":
                tokens, song = self._song(ids)
                return known, tokens, song, dropped
            tokens = gen.trim_at_eos(ids)
            return known, tokens, tokens_to_song(tokens), dropped
        if self.scheme == "b3":
            with self._lock:
                ids = gen.generate_ids(
                    prompt_ids, temperature=temperature, top_k=top_k,
                    seed=run_seed, top_p=top_p, min_p=min_p,
                    penalties=penalties, no_repeat_ngram=no_repeat_ngram,
                    grammar=gram)[0].tolist()
            tokens, song = self._song(ids)
            return known, tokens, song, dropped
        use_batcher = self.batcher is not None and self.batcher.accepts(
            top_k=top_k, top_p=top_p, min_p=min_p, penalties=penalties,
            no_repeat_ngram=no_repeat_ngram, grammar=grammar)
        # a lone request on an IDLE continuous engine would pay one harvest
        # wait per chunk alone: decode it detached; the gate sends
        # concurrent followers to the engine. The detached row carries no
        # penalties, n-gram ban or grammar, so a request with one joins the
        # engine even alone, as in JAX.
        solo_bypass = (use_batcher and penalties is None
                       and not no_repeat_ngram and not grammar
                       and getattr(self.batcher, "idle", lambda: False)()
                       and self._solo_gate.acquire(blocking=False))
        try:
            if solo_bypass:
                tokens = gen.trim_at_eos(self._solo_ragged(
                    gen.vocab.encode(known), temperature, run_seed, top_p,
                    min_p))
            elif use_batcher:
                # a continuous engine has top_k/greedy (and, outside
                # per-row mode, top_p/min_p) engine-wide; a mismatching
                # request falls through to the solo decode below
                tokens = gen.trim_at_eos(self.batcher.submit(
                    gen.vocab.encode(known), temperature=temperature,
                    top_k=top_k, seed=run_seed, top_p=top_p, min_p=min_p,
                    penalties=penalties, no_repeat_ngram=no_repeat_ngram,
                    grammar=grammar))
            else:
                with self._lock:
                    tokens = gen.sample_kvcache(
                        known, temperature=temperature, top_k=top_k,
                        seed=run_seed, top_p=top_p, min_p=min_p,
                        penalties=penalties,
                        no_repeat_ngram=no_repeat_ngram, grammar=gram)
        finally:
            if solo_bypass:
                self._solo_gate.release()
        return known, tokens, tokens_to_song(tokens), dropped

    def generate(self, prompt_text: str, temperature: float = 1.0,
                 top_k: int = 50, seed: int | None = None,
                 render_audio: bool | None = None,
                 top_p: float = 1.0, min_p: float = 0.0,
                 penalties: tuple | None = None,
                 no_repeat_ngram: int = 0, grammar: bool = False,
                 lookup: bool = False, medusa: bool = False, beams: int = 0,
                 length_penalty: float = 1.0) -> GenerationResult:
        """One song for the prompt: classify, map, decode, render.
        ``grammar`` constrains the decode to the scheme's FSM; ``lookup``,
        ``medusa`` and ``beams`` (with ``length_penalty``) pick the page's
        decode options (solo)."""
        render = self.render_audio if render_audio is None else render_audio
        timings = {}
        t0 = time.perf_counter()
        label = self.classifier.predict(prompt_text)
        timings["classify"] = (time.perf_counter() - t0) * 1000

        t0 = time.perf_counter()
        mapping = get_music_params(label, seed=seed)
        timings["map_and_prompt"] = (time.perf_counter() - t0) * 1000

        t0 = time.perf_counter()
        run_seed = seed if seed is not None else \
            int(time.time_ns() % 2**31)
        gen_prompt, tokens, song, dropped = self._decode(
            mapping, temperature, top_k, run_seed, top_p, min_p, penalties,
            no_repeat_ngram, grammar, lookup, medusa, beams, length_penalty)
        timings["decode"] = (time.perf_counter() - t0) * 1000

        midi_bytes, wav_bytes = self._finish(song, seed, render, timings)
        return GenerationResult(label=label, mapping=mapping,
                                prompt_tokens=gen_prompt, tokens=tokens,
                                midi_bytes=midi_bytes, wav_bytes=wav_bytes,
                                timings_ms=timings, dropped_tokens=dropped)

    def _section(self, i: int, text: str, seed: int | None,
                 timings: dict) -> tuple:
        """Section ``i`` of a prompt: its sentence classified (the time
        added to ``timings["classify"]``) and EATS-mapped with seed + i, and
        its decode seed. -> (label, mapping, run seed)."""
        t0 = time.perf_counter()
        label = self.classifier.predict(text)
        timings["classify"] = (timings.get("classify", 0.0)
                               + (time.perf_counter() - t0) * 1000)
        mapping = get_music_params(label,
                                   seed=None if seed is None else seed + i)
        run_seed = (seed + i) if seed is not None else \
            int(time.time_ns() % 2**31)
        return label, mapping, run_seed

    def _finish(self, song: MidiSong, seed: int | None, render: bool,
                timings: dict) -> tuple:
        """-> (the song's MIDI bytes, its WAV bytes when ``render`` else
        None), each phase timed into ``timings``."""
        t0 = time.perf_counter()
        midi_io = io.BytesIO()
        song.write(midi_io)
        timings["detokenize_midi"] = (time.perf_counter() - t0) * 1000
        wav_bytes = None
        if render:
            t0 = time.perf_counter()
            wav_bytes = self._render(song, seed)
            timings["render_wav"] = (time.perf_counter() - t0) * 1000
        return midi_io.getvalue(), wav_bytes

    def _render(self, song: MidiSong, seed: int | None) -> bytes:
        """The song's WAV bytes (FluidSynth when the host has it, the
        additive synth otherwise), under the pipeline's lock."""
        wav_io = io.BytesIO()
        with self._lock:
            render_to_wav_auto(song, wav_io, seed=seed or 0,
                               device=self.device)
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
        return wav_io.getvalue()

    def generate_sections(self, prompt_text: str, temperature: float = 1.0,
                          top_k: int = 50, seed: int | None = None,
                          render_audio: bool | None = None,
                          gap_s: float = 0.5, top_p: float = 1.0,
                          min_p: float = 0.0,
                          penalties: tuple | None = None,
                          no_repeat_ngram: int = 0, grammar: bool = False,
                          lookup: bool = False, medusa: bool = False,
                          beams: int = 0,
                          length_penalty: float = 1.0) -> GenerationResult:
        """Emotion-adaptive generation: each sentence of the prompt is
        classified on its own and drives its own conditioned section
        (seed + i for section i); the sections are laid end to end on the
        time axis, ``gap_s`` apart. A prompt of one sentence is
        :meth:`generate`."""
        options = dict(penalties=penalties, no_repeat_ngram=no_repeat_ngram,
                       grammar=grammar, lookup=lookup, medusa=medusa,
                       beams=beams, length_penalty=length_penalty)
        segments = segment_text(prompt_text)
        if len(segments) <= 1:
            return self.generate(prompt_text, temperature=temperature,
                                 top_k=top_k, seed=seed,
                                 render_audio=render_audio, top_p=top_p,
                                 min_p=min_p, **options)
        render = self.render_audio if render_audio is None else render_audio
        timings = {}
        t_all = time.perf_counter()
        labels, mappings, all_tokens, all_prompts, dropped = \
            [], [], [], [], []
        merged = _Sections(gap_s)
        for i, seg in enumerate(segments):
            label, mapping, run_seed = self._section(i, seg, seed, timings)
            gp, tokens, song, drop = self._decode(
                mapping, temperature, top_k, run_seed, top_p, min_p,
                **options)
            labels.append(label)
            mappings.append(mapping)
            all_tokens.extend(tokens)
            all_prompts.extend(gp)
            dropped.extend(drop)
            merged.add(song)
        timings["classify_map_decode_all"] = \
            (time.perf_counter() - t_all) * 1000
        midi_bytes, wav_bytes = self._finish(merged.song, seed, render,
                                             timings)
        return GenerationResult(
            label=" / ".join(labels),
            mapping={"sections": [
                {"text": s, "label": lab, **m}
                for s, lab, m in zip(segments, labels, mappings)]},
            prompt_tokens=all_prompts, tokens=all_tokens,
            midi_bytes=midi_bytes, wav_bytes=wav_bytes,
            timings_ms=timings, dropped_tokens=dropped)

    # ------------------------------------------------------------ streaming

    def _stream_deltas(self, prompt_ids: list[int], temperature: float,
                       top_k: int, run_seed: int, chunk: int = 32,
                       top_p: float = 1.0, min_p: float = 0.0,
                       penalties: tuple | None = None,
                       no_repeat_ngram: int = 0, grammar: bool = False,
                       medusa: bool = False):
        """Lists of newly generated token ids: with ``medusa`` an engine
        Medusa row's when the engine carries the heads and accepts the
        request, else the solo Medusa stream (``decode/medusa.py``: accepted
        tokens arrive a verify chunk at a time, the one-shot medusa
        decode's tokens); else an engine row's (``submit_stream``) when a
        continuous engine runs and accepts the request's sampling values
        and options, else the solo chunked stream (``decode/stream.py``);
        ``chunk`` tokens a list."""
        from ..decode.stream import stream_tokens
        from .continuous import ContinuousBatcher

        gen = self.generator
        if medusa and self._engine_medusa(top_k, top_p, min_p):
            self._check_options(penalties, no_repeat_ngram, grammar, False,
                                True, 0)
            yield from self.batcher.submit_stream(
                prompt_ids, temperature=temperature, seed=run_seed,
                top_k=top_k, top_p=top_p, min_p=min_p, medusa=True)
            return
        if medusa:
            from ..decode.medusa import stream_tokens_medusa

            self._check_options(penalties, no_repeat_ngram, grammar, False,
                                True, 0)
            tokens = stream_tokens_medusa(
                gen.params, self.medusa_heads, gen.cfg, list(prompt_ids),
                gen.max_supported_len(), temperature=temperature,
                top_k=top_k, eos_id=gen.eos_id, pad_id=gen.pad_id,
                seed=run_seed, top_p=top_p, min_p=min_p, eager=gen.eager)
        elif isinstance(self.batcher, ContinuousBatcher) \
                and self.batcher.accepts(top_k=top_k, top_p=top_p,
                                         min_p=min_p, penalties=penalties,
                                         no_repeat_ngram=no_repeat_ngram,
                                         grammar=grammar):
            yield from self.batcher.submit_stream(
                prompt_ids, temperature=temperature, seed=run_seed,
                top_k=top_k, top_p=top_p, min_p=min_p, penalties=penalties,
                no_repeat_ngram=no_repeat_ngram, grammar=grammar)
            return
        else:
            tokens = stream_tokens(
                gen.params, gen.cfg, list(prompt_ids),
                gen.max_supported_len(), chunk=chunk,
                temperature=temperature, top_k=top_k, eos_id=gen.eos_id,
                pad_id=gen.pad_id, seed=run_seed, top_p=top_p, min_p=min_p,
                penalties=penalties, no_repeat_ngram=no_repeat_ngram,
                grammar=self.grammar() if grammar else None, eager=gen.eager)
        delta = []
        for tok in tokens:
            delta.append(tok)
            if len(delta) >= chunk:
                yield delta
                delta = []
        if delta:
            yield delta

    def generate_stream(self, prompt_text: str, temperature: float = 1.0,
                        top_k: int = 50, seed: int | None = None,
                        render_audio: bool | None = None,
                        sections: bool = False, chunk: int = 32,
                        gap_s: float = 0.5, top_p: float = 1.0,
                        min_p: float = 0.0,
                        penalties: tuple | None = None,
                        no_repeat_ngram: int = 0, grammar: bool = False,
                        medusa: bool = False):
        """Incremental twin of :meth:`generate` / :meth:`generate_sections`:
        a generator of JSON-able event dicts for SSE serving.

        Events, in order: ``{"event": "meta"}`` once per section (the
        emotion label and the EATS mapping, before any decode),
        ``{"event": "tokens"}`` deltas as the decode's chunks complete,
        and a last ``{"event": "done"}`` with the whole MIDI (and the WAV
        when rendering) as base64."""
        render = self.render_audio if render_audio is None else render_audio
        segments = segment_text(prompt_text) if sections else [prompt_text]
        if not segments:
            segments = [prompt_text]
        timings: dict = {}
        t_all = time.perf_counter()
        merged = _Sections(gap_s)
        labels, all_tokens, all_prompts, dropped_all = [], [], [], []
        eos = self.generator.eos_id
        id2tok = (self.scheme_b.vocab if self.scheme == "b3"
                  else self.generator.vocab).id2tok
        for i, seg in enumerate(segments):
            label, mapping, run_seed = self._section(i, seg, seed, timings)
            gen_prompt, prompt_ids, dropped = self._prompt_for(mapping)
            labels.append(label)
            all_prompts.extend(gen_prompt)
            dropped_all.extend(dropped)
            yield {"event": "meta", "section": i,
                   "n_sections": len(segments), "text": seg, "label": label,
                   "mapping": mapping, "prompt_tokens": gen_prompt,
                   "dropped_tokens": dropped}
            ids = list(prompt_ids)
            t0 = time.perf_counter()
            hit_eos = False
            deltas = self._stream_deltas(prompt_ids, temperature, top_k,
                                         run_seed, chunk=chunk, top_p=top_p,
                                         min_p=min_p, penalties=penalties,
                                         no_repeat_ngram=no_repeat_ngram,
                                         grammar=grammar, medusa=medusa)
            try:
                for delta in deltas:
                    out = []
                    for t in delta:
                        out.append(int(t))
                        if int(t) == eos:
                            hit_eos = True
                            break
                    if not out:
                        continue
                    ids.extend(out)
                    yield {"event": "tokens", "section": i, "ids": out,
                           "texts": [id2tok[t] for t in out],
                           "n_generated": len(ids) - len(prompt_ids)}
                    if hit_eos:
                        break
            finally:
                # a consumer that closes this generator (an SSE client gone)
                # reaches the engine's stream now, which cancels its row
                deltas.close()
            timings["decode"] = (timings.get("decode", 0.0)
                                 + (time.perf_counter() - t0) * 1000)
            tokens, song = self._song(ids)
            all_tokens.extend(tokens)
            merged.add(song)

        midi_bytes, wav_bytes = self._finish(merged.song, seed, render,
                                             timings)
        wav_b64 = None if wav_bytes is None else \
            base64.b64encode(wav_bytes).decode()
        timings["total"] = (time.perf_counter() - t_all) * 1000
        yield {"event": "done", "label": " / ".join(labels),
               "n_tokens": len(all_tokens),
               "timings_ms": {k: round(v, 1) for k, v in timings.items()},
               "midi_b64": base64.b64encode(midi_bytes).decode(),
               "wav_b64": wav_b64, "dropped_tokens": dropped_all}


def pipeline_from_checkpoint(path: str = DEMO_CKPT_A, full_gm: bool = False,
                             classifier: EmotionClassifier | None = None,
                             device=None, coalesce=False,
                             coalesce_opts: dict | None = None,
                             fast_routing: bool = False,
                             eager: bool = False,
                             engine_medusa: bool = False) -> Pipeline:
    """A serving pipeline from a checkpoint directory of the JAX package's
    pickle format; the token scheme is inferred from the vocabulary
    (Scheme A, or B3 with its ``[END_SEQ]`` EOS; B1 and B2 have no control
    tokens to condition on and are refused). ``device`` None means CUDA
    (raises without a card). ``coalesce``: False, "window" (or
    True) or "continuous"; ``coalesce_opts`` go to the batcher. The decode
    replays CUDA graphs on the card; ``eager=True`` issues every step from
    the host instead, on every route, to compare the two (the CLI never
    passes it). ``engine_medusa`` puts the checkpoint's Medusa heads into
    the continuous engine."""
    device = resolve_device(device)
    if coalesce == "continuous":
        # production default of the JAX package: 128-step chunks (half the
        # harvests per song of the engine class's own default of 64, for a
        # longer worst-case join wait of about one chunk)
        coalesce_opts = {"chunk": 128, **(coalesce_opts or {})}
    if coalesce and eager:
        coalesce_opts = {**(coalesce_opts or {}), "eager": True}
    ckpt = load_checkpoint(path)
    vocab = Vocab(ckpt["vocab"])
    scheme = detect_scheme(vocab)
    if scheme in ("b1", "b2"):
        raise ValueError(
            f"Scheme-{scheme.upper()} checkpoints have no control tokens "
            "to condition on; serve a b3 (train_no_inst) or Scheme-A "
            "checkpoint")
    heads, medusa_probe, medusa_unavailable = _medusa_heads_for(
        path, ckpt, device)
    if engine_medusa and heads is None:
        print("[serve] --engine-medusa ignored: the checkpoint has no "
              "medusa heads")
    opts = dict(coalesce=coalesce, coalesce_opts=coalesce_opts,
                fast_routing=fast_routing, medusa_heads=heads,
                engine_medusa=engine_medusa)
    if scheme == "b3":
        gen = Generator(ckpt["params"], ckpt["cfg"], vocab,
                        eos_token="[END_SEQ]", device=device, eager=eager)
        pipe = Pipeline(gen, classifier, scheme="b3",
                        scheme_b=SchemeB3(seq_len=ckpt["cfg"].seq_len),
                        **opts)
    else:
        gen = Generator(ckpt["params"], ckpt["cfg"], vocab, device=device,
                        eager=eager)
        pipe = Pipeline(gen, classifier, full_gm=full_gm, **opts)
    pipe.medusa_probe = medusa_probe
    pipe.medusa_unavailable = medusa_unavailable
    return pipe


def _medusa_heads_for(path: str, ckpt: dict, device) -> tuple:
    """The checkpoint's ``medusa_heads.pkl``, as JAX's pipeline takes it
    -> (heads or None, their acceptance probe or None, why medusa cannot
    serve or None). Heads need a corrected causal checkpoint and its
    d_model; a file without a probe is probed here (a forward over
    held-out rows), and a probe that predicts a loss is printed."""
    from ..tools.medusa import (PROBE_WIN_THRESHOLD, load_medusa_heads,
                                probe_heads_for_checkpoint)

    heads_path = os.path.join(path, "medusa_heads.pkl")
    if not os.path.isfile(heads_path):
        return None, None, None
    heads, probe, unavailable = None, None, None
    D = ckpt["cfg"].d_model
    if not ckpt["cfg"].causal:
        unavailable = (
            "this checkpoint ships Medusa heads but has the reference "
            "bidirectional/pos quirks; medusa requires a corrected causal "
            "checkpoint (train --corrected)")
    else:
        heads = load_medusa_heads(heads_path)
        w0 = heads["blocks"][0]["w"]
        if tuple(w0.shape) != (D, D):
            unavailable = (
                f"the shipped medusa_heads.pkl was trained for "
                f"d_model={w0.shape[0]}, this checkpoint is d_model={D}; "
                "retrain with `cli train-medusa`")
            heads = None
        else:
            probe = heads.get("probe")
            if probe is None:
                probe = probe_heads_for_checkpoint(ckpt, heads,
                                                   device=device)
            if not probe.get("likely_win", True):
                print("[serve] medusa probe: predicted "
                      f"{probe['tok_per_verify_est']} tok/verify < "
                      f"{PROBE_WIN_THRESHOLD} admission threshold (base "
                      f"top-1 {probe['base_top1']}) — medusa=true will "
                      "likely LOSE throughput on this checkpoint; plain "
                      "decode recommended")
    if unavailable:
        print(f"[serve] medusa disabled: {unavailable}")
    return heads, probe, unavailable


def packaged_demo_checkpoints() -> dict:
    """{scheme: path} of the JAX package's shipped demo checkpoints
    (``demo_ckpt_a``, ``demo_ckpt_b3``) that are present and not empty."""
    out = {}
    for scheme, d in (("a", DEMO_CKPT_A), ("b3", DEMO_CKPT_B3)):
        if os.path.isdir(d) and os.listdir(d):
            out[scheme] = d
    return out


def packaged_demo_checkpoint() -> str:
    """The default demo: the Scheme-A flagship when shipped, else the B3
    model, else ''."""
    demos = packaged_demo_checkpoints()
    return demos.get("a") or demos.get("b3") or ""


def demo_pipeline(seq_len: int = 128, d_model: int = 128, n_head: int = 4,
                  n_layer: int = 2, seed: int = 0, corrected: bool = False,
                  coalesce=False, coalesce_opts: dict | None = None,
                  fast_routing: bool = False, device=None) -> Pipeline:
    """A pipeline with a randomly initialised Scheme-A model over the
    synthetic corpus's vocabulary, as the JAX package's ``demo_pipeline``
    builds it: the same threefry key gives JAX's weights bit for bit
    (``models/gpt.py::init_params``). ``corrected=True`` builds the causal
    architecture (coalescing needs it); otherwise the reference's
    quirks."""
    import json

    from ..models.gpt import GPTConfig, init_params
    from ..train.data import synthetic_corpus
    from ..utils import prng

    device = resolve_device(device)
    corpus = [json.loads(js) for js in synthetic_corpus(64, seed=seed)]
    vocab = Vocab.from_sequences(corpus, pad_last=False)
    cfg = GPTConfig(vocab_size=len(vocab), seq_len=seq_len, d_model=d_model,
                    n_head=n_head, n_layer=n_layer, pos_rows=seq_len,
                    causal=bool(corrected))
    params = init_params(prng.PRNGKey(seed), cfg, device=device)
    gen = Generator(params, cfg, vocab, device=device)
    return Pipeline(gen, EmotionClassifier(device=device), coalesce=coalesce,
                    coalesce_opts=coalesce_opts, fast_routing=fast_routing)


def demo_pipeline_b3(seq_len: int = 96, d_model: int = 64, n_head: int = 4,
                     n_layer: int = 2, seed: int = 0,
                     device=None) -> Pipeline:
    """The Scheme-B3 demo pipeline: a random causal model over the fixed
    8,579-token control vocabulary, solo."""
    from ..models.gpt import GPTConfig, init_params
    from ..utils import prng

    device = resolve_device(device)
    b3 = SchemeB3(seq_len=seq_len)
    cfg = GPTConfig(vocab_size=len(b3.vocab), seq_len=seq_len,
                    d_model=d_model, n_head=n_head, n_layer=n_layer,
                    pos_rows=seq_len, causal=True)
    params = init_params(prng.PRNGKey(seed), cfg, device=device)
    gen = Generator(params, cfg, b3.vocab, eos_token="[END_SEQ]",
                    device=device)
    return Pipeline(gen, EmotionClassifier(device=device), scheme="b3",
                    scheme_b=b3)
