"""End-to-end request pipeline: text -> emotion -> prompt -> MIDI -> WAV.

Port of ``eamg_tpu/serve/pipeline.py`` for the Scheme-A solo path:
classify, EATS-map, assemble control tokens, cached decode
(``Generator.sample_kvcache``), detokenize, render. Per-phase wall-clock
timings are returned as in the JAX package.

Device work is serialized by one lock per pipeline: the threaded HTTP
server calls ``generate`` from several threads, and the JAX version
leaned on jit's thread safety for that.

Not in the port yet (requests asking for them raise ``NotInPort``): B3
checkpoints, request coalescing, multi-section and streamed generation,
beams, the speculative modes (lookup, medusa), penalties, n-gram bans and
grammar constraints.
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

# the JAX package's shipped demo checkpoints, read as data
DEMO_CKPT_A = os.path.join(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__)))), "eamg_tpu", "serve",
    "demo_ckpt_a")


class NotInPort(ValueError):
    """A request option the JAX package serves but the port does not yet."""

    def __init__(self, option: str):
        super().__init__(f"{option} is not yet in the PyTorch port")
        self.option = option


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
    """Scheme-A serving: text control tokens, solo cached decode."""

    def __init__(self, generator: Generator,
                 classifier: EmotionClassifier | None = None,
                 full_gm: bool = False, render_audio: bool = True):
        self.generator = generator
        self.device = generator.device
        self.classifier = classifier or EmotionClassifier(device=self.device)
        self.full_gm = full_gm
        self.render_audio = render_audio
        self.scheme = "a"
        self._lock = threading.Lock()

    def warmup(self) -> None:
        """Build the kernels and run one request before serving."""
        self.generate("warm up the kernels", seed=0,
                      render_audio=self.render_audio)

    def _decode(self, mapping: dict, temperature: float, top_k: int,
                run_seed: int, top_p: float, min_p: float):
        gen_prompt = assemble_prompt(self.generator.vocab, mapping,
                                     full_gm=self.full_gm)
        # a data-dependent vocabulary may lack a control token: drop it
        # and report it (the reference crashed with a KeyError)
        known = [t for t in gen_prompt if t in self.generator.vocab]
        dropped = [t for t in gen_prompt if t not in self.generator.vocab]
        tokens = self.generator.sample_kvcache(
            known, temperature=temperature, top_k=top_k, seed=run_seed,
            top_p=top_p, min_p=min_p)
        return known, tokens, tokens_to_song(tokens), dropped

    def generate(self, prompt_text: str, temperature: float = 1.0,
                 top_k: int = 50, seed: int | None = None,
                 render_audio: bool | None = None,
                 top_p: float = 1.0, min_p: float = 0.0) -> GenerationResult:
        render = self.render_audio if render_audio is None else render_audio
        timings = {}
        with self._lock:
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
                mapping, temperature, top_k, run_seed, top_p, min_p)
            timings["decode"] = (time.perf_counter() - t0) * 1000

            t0 = time.perf_counter()
            midi_io = io.BytesIO()
            song.write(midi_io)
            timings["detokenize_midi"] = (time.perf_counter() - t0) * 1000

            wav_bytes = None
            if render:
                t0 = time.perf_counter()
                wav_io = io.BytesIO()
                render_to_wav_auto(song, wav_io, seed=seed or 0,
                                   device=self.device)
                wav_bytes = wav_io.getvalue()
                if self.device.type == "cuda":
                    torch.cuda.synchronize(self.device)
                timings["render_wav"] = (time.perf_counter() - t0) * 1000

        return GenerationResult(label=label, mapping=mapping,
                                prompt_tokens=gen_prompt, tokens=tokens,
                                midi_bytes=midi_io.getvalue(),
                                wav_bytes=wav_bytes, timings_ms=timings,
                                dropped_tokens=dropped)


def pipeline_from_checkpoint(path: str = DEMO_CKPT_A, full_gm: bool = False,
                             classifier: EmotionClassifier | None = None,
                             device=None) -> Pipeline:
    """A serving pipeline from a checkpoint directory of the JAX package's
    pickle format; Scheme-A vocabularies only so far. ``device`` None
    means CUDA (raises without a card)."""
    device = resolve_device(device)
    ckpt = load_checkpoint(path)
    vocab = Vocab(ckpt["vocab"])
    scheme = detect_scheme(vocab)
    if scheme != "a":
        raise NotInPort(f"serving Scheme-{scheme.upper()} checkpoints")
    if os.path.isfile(os.path.join(path, "medusa_heads.pkl")):
        print("[serve] medusa heads found; medusa decoding is not yet in "
              "the PyTorch port, plain decode only")
    gen = Generator(ckpt["params"], ckpt["cfg"], vocab, device=device)
    return Pipeline(gen, classifier, full_gm=full_gm)
