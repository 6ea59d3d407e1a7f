"""Generation API: token strings in, token strings out.

Port of ``eamg_tpu/decode/api.py::Generator``: prompt buckets,
``max_supported_len``, over-length prompts returned unchanged,
``generate_ids`` (cached or uncached, any batch, with penalties, n-gram
bans and grammar constraints), the batch-1 speculative decodes
``generate_ids_lookup``, ``generate_ids_medusa`` and (with a draft
``Generator``) ``generate_ids_speculative``, beam search
(``generate_ids_beam``, ``sample_beam``, grammar-constrained too),
``sample_kvcache``, ``sample`` and ``trim_at_eos``.
"""

from __future__ import annotations

import numpy as np
import torch

from ..models.gpt import GPTConfig
from ..tokenizer.vocab import Vocab
from ..utils import prng
from ..utils.device import resolve_device
from .loop import generate_full, generate_kv
from .speculative import _padded_prompt

END_TOKEN = "[END_SEQUENCE]"


def _bucket(n: int, sizes=(16, 32, 64, 128, 256, 512, 1024, 2048)) -> int:
    for s in sizes:
        if n <= s:
            return s
    return n


def _to_device(tree, device):
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_to_device(v, device) for v in tree]
    return tree.to(device)


class Generator:
    """Owns (params, cfg, vocab) on one device; reference-shaped sampling
    calls. ``device`` None means CUDA (raises without a card)."""

    def __init__(self, params: dict, cfg: GPTConfig, vocab: Vocab,
                 eos_token: str = END_TOKEN, pad_token: str = "[PAD]",
                 device=None, eager: bool = False):
        self.device = resolve_device(device)
        # the cached decode replays CUDA graphs on the card; eager=True
        # issues its steps from the host, to compare the two (no served
        # path passes it)
        self.eager = bool(eager)
        self.params = _to_device(params, self.device)
        self.cfg = cfg
        self.vocab = vocab
        self.eos_id = vocab.get(eos_token, -1)
        self.pad_id = vocab.get(pad_token, 0)

    def max_supported_len(self, use_cache: bool = True) -> int:
        """Longest prompt + generation the positional table supports: the
        cached path reads positions up to max_len - 1, so min(seq_len,
        n_pos) (511 on trainer geometries); the uncached path re-encodes
        only the first max_len - 1 tokens, so it takes one more; the
        pos-broadcast quirk always reads row 0 during the cached decode."""
        if not use_cache:
            return self.cfg.n_pos + 1
        if self.cfg.pos_broadcast_bug:
            return self.cfg.seq_len
        return min(self.cfg.seq_len, self.cfg.n_pos)

    def generate_ids(self, prompt_ids: list[int], max_len: int | None = None,
                     temperature: float = 1.0, top_k: int = 50,
                     seed: int = 0, greedy: bool = False, batch: int = 1,
                     use_cache: bool = True,
                     refeed_last_prompt: bool = True,
                     mask_value: float = -1e10, top_p: float = 1.0,
                     min_p: float = 0.0, penalties: tuple | None = None,
                     no_repeat_ngram: int = 0, grammar=None,
                     presplit_keys: bool = False) -> np.ndarray:
        """Returns [batch, n_tokens] int32 id rows (prompt included): the
        rows of one batch share the prompt and the key and differ by their
        noise. ``use_cache=False`` runs the uncached loop. ``penalties``:
        (repetition, frequency, presence) or None; ``no_repeat_ngram``: the
        banned n-gram size; ``grammar``: a ``decode.grammar.Grammar`` (the
        scheme's FSM, with its budget rule) or None."""
        max_len = max_len or self.cfg.seq_len
        max_len = min(max_len, self.max_supported_len(use_cache))
        p = len(prompt_ids)
        if p >= max_len:
            # reference semantics: zero generation steps, prompt unchanged
            return np.tile(np.asarray(prompt_ids, np.int32)[None],
                           (batch, 1))
        bucket = min(_bucket(p), max_len)
        prompt = np.full((batch, bucket), self.pad_id, np.int64)
        prompt[:, :p] = prompt_ids
        common = dict(temperature=temperature, top_k=top_k,
                      eos_id=self.eos_id, pad_id=self.pad_id, greedy=greedy,
                      mask_value=mask_value, top_p=top_p, min_p=min_p,
                      penalties=penalties, no_repeat_ngram=no_repeat_ngram,
                      grammar=grammar)
        args = (self.params, torch.from_numpy(prompt).to(self.device), p,
                prng.PRNGKey(seed), self.cfg, max_len)
        if use_cache:
            buf, pos = generate_kv(*args, **common,
                                   refeed_last_prompt=refeed_last_prompt,
                                   presplit_keys=presplit_keys,
                                   eager=self.eager)
        else:
            buf, pos = generate_full(*args, **common)
        return buf[:, :pos].cpu().numpy().astype(np.int32)

    def _spec_prompt(self, what: str, prompt_ids: list[int], max_len,
                     gamma: int):
        """The speculative decodes' checks and cuts (JAX's): a corrected
        causal checkpoint, ``max_len`` cut to n_pos - gamma. -> (max_len,
        the prompt bucket on the device, or None when the prompt leaves no
        room to generate)."""
        if not self.cfg.causal or self.cfg.pos_broadcast_bug:
            raise ValueError(
                f"{what} requires a corrected causal checkpoint (train "
                "--corrected); this config has the reference "
                "bidirectional/pos quirks")
        max_len = min(max_len or self.cfg.seq_len, self.cfg.n_pos - gamma)
        p = len(prompt_ids)
        if p >= max_len:
            return max_len, None
        return max_len, _padded_prompt(prompt_ids, min(_bucket(p), max_len),
                                       self.pad_id, self.device)

    def generate_ids_speculative(self, draft: "Generator",
                                 prompt_ids: list[int],
                                 max_len: int | None = None,
                                 gamma: int = 4, temperature: float = 1.0,
                                 top_k: int = 50, seed: int = 0,
                                 greedy: bool = False, top_p: float = 1.0,
                                 min_p: float = 0.0) -> np.ndarray:
        """Speculative decode with ``draft`` (same vocabulary, same device)
        as the proposer (``decode/speculative.py::generate_speculative``):
        the target's output distribution, greedy output equal to its plain
        greedy decode. Batch 1, corrected causal checkpoints, as JAX
        asserts. -> [1, n] ids."""
        from .speculative import generate_speculative

        assert draft.vocab.tok2id == self.vocab.tok2id, \
            "draft and target must share a vocabulary"
        max_len = max_len or min(self.cfg.seq_len, draft.cfg.seq_len)
        p = len(prompt_ids)
        if p >= max_len:
            # zero generation steps: the prompt unchanged
            return np.asarray([list(prompt_ids)], np.int32)
        prompt = _padded_prompt(prompt_ids, min(_bucket(p), max_len),
                                self.pad_id, self.device)
        buf, pos = generate_speculative(
            self.params, draft.params, prompt, p, prng.PRNGKey(seed),
            self.cfg, draft.cfg, max_len, gamma=gamma,
            temperature=temperature, top_k=top_k, eos_id=self.eos_id,
            pad_id=self.pad_id, greedy=greedy, top_p=top_p, min_p=min_p,
            eager=self.eager)
        return buf[:, :pos].numpy().astype(np.int32)

    def generate_ids_lookup(self, prompt_ids: list[int],
                            max_len: int | None = None, gamma: int = 8,
                            ngram: int = 3, temperature: float = 1.0,
                            top_k: int = 50, seed: int = 0,
                            greedy: bool = False, top_p: float = 1.0,
                            min_p: float = 0.0) -> np.ndarray:
        """Draft-free speculative decode (prompt lookup,
        ``decode/speculative.py::generate_prompt_lookup``): the target's
        output distribution, greedy output equal to the plain greedy
        decode. Batch 1, corrected causal checkpoints. -> [1, n] ids."""
        from .speculative import generate_prompt_lookup

        max_len, prompt = self._spec_prompt(
            "prompt-lookup speculation", prompt_ids, max_len, gamma)
        if prompt is None:
            # zero generation steps: the prompt unchanged
            return np.asarray([list(prompt_ids)], np.int32)
        buf, pos, _ = generate_prompt_lookup(
            self.params, prompt, len(prompt_ids), prng.PRNGKey(seed),
            self.cfg, max_len, gamma=gamma, ngram=ngram,
            temperature=temperature, top_k=top_k, eos_id=self.eos_id,
            pad_id=self.pad_id, greedy=greedy, top_p=top_p, min_p=min_p,
            eager=self.eager)
        return buf[:, :pos].numpy().astype(np.int32)

    def generate_ids_medusa(self, heads: dict, prompt_ids: list[int],
                            max_len: int | None = None, gamma: int = 4,
                            temperature: float = 1.0, top_k: int = 50,
                            seed: int = 0, greedy: bool = False,
                            top_p: float = 1.0,
                            min_p: float = 0.0) -> np.ndarray:
        """Medusa decode (``decode/medusa.py``) with ``heads`` from
        ``tools.medusa.load_medusa_heads``: gamma proposals a verify step,
        the target's output distribution, greedy output equal to the plain
        greedy decode. Batch 1, corrected causal checkpoints. -> [1, n]
        ids."""
        from .medusa import generate_medusa

        gamma = min(gamma, len(heads["blocks"]))
        max_len, prompt = self._spec_prompt("medusa decoding", prompt_ids,
                                            max_len, gamma)
        if prompt is None:
            return np.asarray([list(prompt_ids)], np.int32)
        buf, pos, _ = generate_medusa(
            self.params, heads, prompt, len(prompt_ids), prng.PRNGKey(seed),
            self.cfg, max_len, gamma=gamma, temperature=temperature,
            top_k=top_k, eos_id=self.eos_id, pad_id=self.pad_id,
            greedy=greedy, top_p=top_p, min_p=min_p, eager=self.eager)
        return buf[:, :pos].numpy().astype(np.int32)

    def generate_ids_beam(self, prompt_ids: list[int],
                          max_len: int | None = None, n_beams: int = 4,
                          length_penalty: float = 1.0,
                          return_all: bool = False, grammar=None):
        """Deterministic beam search (``decode/beam.py``): the best
        hypothesis row (prompt included, cut to its length), or with
        ``return_all`` (rows [K, max_len], gen_lens, raw scores, normalized
        scores) ranked best first. ``grammar``: a
        ``decode.grammar.Grammar`` or None, each beam constrained by its
        own FSM state."""
        from .beam import generate_beam, rank_beams

        max_len = min(max_len or self.cfg.seq_len, self.max_supported_len())
        p = len(prompt_ids)
        if p >= max_len:
            # zero generation steps (reference semantics)
            return np.asarray([list(prompt_ids)], np.int32) if return_all \
                else np.asarray(prompt_ids, np.int32)
        prompt = _padded_prompt(prompt_ids, min(_bucket(p), max_len),
                                self.pad_id, self.device)
        buf, gen_lens, scores = generate_beam(
            self.params, prompt, p, self.cfg, max_len, n_beams=n_beams,
            eos_id=self.eos_id, pad_id=self.pad_id, grammar=grammar,
            eager=self.eager)
        buf, gen_lens, scores, norm = rank_beams(
            buf.astype(np.int32), gen_lens.astype(np.int32), scores,
            length_penalty)
        if return_all:
            return buf, gen_lens, scores, norm
        return buf[0, :p + int(gen_lens[0])]

    def sample_beam(self, prompt: list[str], max_len: int | None = None,
                    n_beams: int = 4, length_penalty: float = 1.0,
                    grammar=None) -> list[str]:
        """Token-string twin of :meth:`generate_ids_beam` (the best
        hypothesis, trimmed at EOS)."""
        ids = self.vocab.encode(prompt)
        row = self.generate_ids_beam(ids, max_len=max_len, n_beams=n_beams,
                                     length_penalty=length_penalty,
                                     grammar=grammar)
        return self.trim_at_eos(row)

    def sample_kvcache(self, prompt: list[str], max_len: int | None = None,
                       temperature: float = 1.0, top_k: int = 50,
                       seed: int = 0, greedy: bool = False,
                       top_p: float = 1.0, min_p: float = 0.0,
                       penalties: tuple | None = None,
                       no_repeat_ngram: int = 0, grammar=None,
                       use_cache: bool = True) -> list[str]:
        """Prompt token strings -> generated token strings, trimmed at the
        first [END_SEQUENCE] (inclusive), batch 1."""
        ids = self.vocab.encode(prompt)
        row = self.generate_ids(ids, max_len=max_len,
                                temperature=temperature, top_k=top_k,
                                seed=seed, greedy=greedy,
                                use_cache=use_cache, top_p=top_p,
                                min_p=min_p, penalties=penalties,
                                no_repeat_ngram=no_repeat_ngram,
                                grammar=grammar)[0]
        return self.trim_at_eos(row)

    def sample(self, prompt: list[str], **kwargs) -> list[str]:
        """The uncached path (the reference's ``sample()``):
        :meth:`sample_kvcache`'s arguments and result through
        ``generate_full``."""
        return self.sample_kvcache(prompt, use_cache=False, **kwargs)

    def trim_at_eos(self, row) -> list[str]:
        """ids -> token strings, truncated at the first EOS (inclusive)."""
        toks = []
        for i in row:
            toks.append(self.vocab.id2tok[int(i)])
            if int(i) == self.eos_id:
                break
        return toks
