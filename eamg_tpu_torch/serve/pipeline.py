"""End-to-end request pipeline: text -> emotion -> prompt -> MIDI -> WAV.

Port of ``eamg_tpu/serve/pipeline.py`` for the Scheme-A path: classify,
EATS-map, assemble control tokens, decode, detokenize, render. Per-phase
wall-clock timings are returned as in the JAX package.

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
(``Generator.sample_kvcache``) runs; penalties and n-gram bans are such
requests, the batchers' ``accepts`` turns them away.

The threaded HTTP server calls ``generate`` from several threads. One lock
per pipeline serialises the solo decode and the synth; it is not held
while a request waits in the engine or the batcher, or requests would
never coalesce.

Not in the port yet (requests asking for them raise ``NotInPort``): B3
checkpoints, multi-section and streamed generation, beams, the speculative
modes (lookup, medusa) and grammar constraints.
"""

from __future__ import annotations

import io
import os
import threading
import time
from dataclasses import dataclass, field

import torch

from ..audio import render_to_wav_auto
from ..decode import Generator
from ..emotion import EmotionClassifier, get_music_params
from ..tokenizer import Vocab, assemble_prompt, detect_scheme, tokens_to_song
from ..utils.checkpoint import load_checkpoint
from ..utils.device import resolve_device
from ..utils.errors import NotInPort

# the JAX package's shipped demo checkpoints, read as data
DEMO_CKPT_A = os.path.join(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__)))), "eamg_tpu", "serve",
    "demo_ckpt_a")


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
    """Scheme-A serving: text control tokens; solo, window-coalesced or
    continuous-engine decode."""

    def __init__(self, generator: Generator,
                 classifier: EmotionClassifier | None = None,
                 full_gm: bool = False, render_audio: bool = True,
                 coalesce=False, coalesce_opts: dict | None = None,
                 fast_routing: bool = False):
        self.generator = generator
        self.device = generator.device
        self.classifier = classifier or EmotionClassifier(device=self.device)
        self.full_gm = full_gm
        self.render_audio = render_audio
        self.scheme = "a"
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

            self.batcher = ContinuousBatcher(generator,
                                             **(coalesce_opts or {}))
        elif coalesce:
            from .batcher import RequestBatcher

            self.batcher = RequestBatcher(generator, **(coalesce_opts or {}))

    def warmup(self) -> None:
        """Build the kernels and capture the decode's graphs before
        serving: one request through the route this pipeline serves; with a
        continuous engine, one engine row and one detached decode too; with
        the window batcher, one ragged decode at each batch size it pads a
        group to."""
        self.generate("warm up the kernels", seed=0,
                      render_audio=self.render_audio)
        from .batcher import RequestBatcher
        from .continuous import ContinuousBatcher

        start = [t for t in ("[START_SEQUENCE]",)
                 if t in self.generator.vocab]
        ids = self.generator.vocab.encode(start) if start else [1]
        if isinstance(self.batcher, ContinuousBatcher):
            # both of its graphs: the engine's chunk and the detached
            # decode's (the request above took one route)
            self.batcher.submit(ids, temperature=1.0, seed=0,
                                top_p=self.batcher.top_p)
            self.batcher.run_detached(ids, seed=0, top_p=self.batcher.top_p)
        if isinstance(self.batcher, RequestBatcher):
            self.batcher.warmup(ids)

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

    def _decode(self, mapping: dict, temperature: float, top_k: int,
                run_seed: int, top_p: float, min_p: float,
                penalties: tuple | None = None, no_repeat_ngram: int = 0):
        gen = self.generator
        gen_prompt = assemble_prompt(gen.vocab, mapping,
                                     full_gm=self.full_gm)
        # a data-dependent vocabulary may lack a control token: drop it
        # and report it (the reference crashed with a KeyError)
        known = [t for t in gen_prompt if t in gen.vocab]
        dropped = [t for t in gen_prompt if t not in gen.vocab]
        use_batcher = self.batcher is not None and self.batcher.accepts(
            top_k=top_k, top_p=top_p, min_p=min_p, penalties=penalties,
            no_repeat_ngram=no_repeat_ngram)
        # a lone request on an IDLE continuous engine would pay one harvest
        # wait per chunk alone: decode it detached; the gate sends
        # concurrent followers to the engine
        solo_bypass = (use_batcher
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
                    top_k=top_k, seed=run_seed, top_p=top_p, min_p=min_p))
            else:
                with self._lock:
                    tokens = gen.sample_kvcache(
                        known, temperature=temperature, top_k=top_k,
                        seed=run_seed, top_p=top_p, min_p=min_p,
                        penalties=penalties,
                        no_repeat_ngram=no_repeat_ngram)
        finally:
            if solo_bypass:
                self._solo_gate.release()
        return known, tokens, tokens_to_song(tokens), dropped

    def generate(self, prompt_text: str, temperature: float = 1.0,
                 top_k: int = 50, seed: int | None = None,
                 render_audio: bool | None = None,
                 top_p: float = 1.0, min_p: float = 0.0,
                 penalties: tuple | None = None,
                 no_repeat_ngram: int = 0) -> GenerationResult:
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
            no_repeat_ngram)
        timings["decode"] = (time.perf_counter() - t0) * 1000

        t0 = time.perf_counter()
        midi_io = io.BytesIO()
        song.write(midi_io)
        timings["detokenize_midi"] = (time.perf_counter() - t0) * 1000

        wav_bytes = None
        if render:
            t0 = time.perf_counter()
            wav_io = io.BytesIO()
            with self._lock:
                render_to_wav_auto(song, wav_io, seed=seed or 0,
                                   device=self.device)
                if self.device.type == "cuda":
                    torch.cuda.synchronize(self.device)
            wav_bytes = wav_io.getvalue()
            timings["render_wav"] = (time.perf_counter() - t0) * 1000

        return GenerationResult(label=label, mapping=mapping,
                                prompt_tokens=gen_prompt, tokens=tokens,
                                midi_bytes=midi_io.getvalue(),
                                wav_bytes=wav_bytes, timings_ms=timings,
                                dropped_tokens=dropped)


def pipeline_from_checkpoint(path: str = DEMO_CKPT_A, full_gm: bool = False,
                             classifier: EmotionClassifier | None = None,
                             device=None, coalesce=False,
                             coalesce_opts: dict | None = None,
                             fast_routing: bool = False,
                             eager: bool = False) -> Pipeline:
    """A serving pipeline from a checkpoint directory of the JAX package's
    pickle format; Scheme-A vocabularies only so far. ``device`` None
    means CUDA (raises without a card). ``coalesce``: False, "window" (or
    True) or "continuous"; ``coalesce_opts`` go to the batcher. The decode
    replays CUDA graphs on the card; ``eager=True`` issues every step from
    the host instead, on every route, to compare the two (the CLI never
    passes it)."""
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
    if scheme != "a":
        raise NotInPort(f"serving Scheme-{scheme.upper()} checkpoints")
    if os.path.isfile(os.path.join(path, "medusa_heads.pkl")):
        print("[serve] medusa heads found; medusa decoding is not yet in "
              "the PyTorch port, plain decode only")
    gen = Generator(ckpt["params"], ckpt["cfg"], vocab, device=device,
                    eager=eager)
    return Pipeline(gen, classifier, full_gm=full_gm, coalesce=coalesce,
                    coalesce_opts=coalesce_opts, fast_routing=fast_routing)
