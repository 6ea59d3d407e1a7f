"""Generation API: token strings in, token strings out.

Port of ``eamg_tpu/decode/api.py::Generator`` for the cached solo path:
prompt buckets, ``max_supported_len``, over-length prompts returned
unchanged, ``generate_ids``, ``sample_kvcache`` and ``trim_at_eos``. The
uncached path, beams and the speculative modes are not in the port yet.
"""

from __future__ import annotations

import numpy as np
import torch

from ..models.gpt import GPTConfig
from ..tokenizer.vocab import Vocab
from ..utils import prng
from ..utils.device import resolve_device
from .loop import generate_kv

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
                 device=None):
        self.device = resolve_device(device)
        self.params = _to_device(params, self.device)
        self.cfg = cfg
        self.vocab = vocab
        self.eos_id = vocab.get(eos_token, -1)
        self.pad_id = vocab.get(pad_token, 0)

    def max_supported_len(self) -> int:
        """Longest prompt + generation the positional table supports: the
        cached path reads positions up to max_len - 1, so min(seq_len,
        n_pos) (511 on trainer geometries); the pos-broadcast quirk always
        reads row 0."""
        if self.cfg.pos_broadcast_bug:
            return self.cfg.seq_len
        return min(self.cfg.seq_len, self.cfg.n_pos)

    def generate_ids(self, prompt_ids: list[int], max_len: int | None = None,
                     temperature: float = 1.0, top_k: int = 50,
                     seed: int = 0, greedy: bool = False, batch: int = 1,
                     refeed_last_prompt: bool = True,
                     mask_value: float = -1e10, top_p: float = 1.0,
                     min_p: float = 0.0,
                     presplit_keys: bool = False) -> np.ndarray:
        """Returns [batch, n_tokens] int32 id rows (prompt included)."""
        max_len = max_len or self.cfg.seq_len
        max_len = min(max_len, self.max_supported_len())
        p = len(prompt_ids)
        if p >= max_len:
            # reference semantics: zero generation steps, prompt unchanged
            return np.tile(np.asarray(prompt_ids, np.int32)[None],
                           (batch, 1))
        bucket = min(_bucket(p), max_len)
        prompt = np.full((batch, bucket), self.pad_id, np.int64)
        prompt[:, :p] = prompt_ids
        buf, pos = generate_kv(
            self.params, torch.from_numpy(prompt).to(self.device), p,
            prng.PRNGKey(seed), self.cfg, max_len, temperature=temperature,
            top_k=top_k, eos_id=self.eos_id, pad_id=self.pad_id,
            greedy=greedy, refeed_last_prompt=refeed_last_prompt,
            mask_value=mask_value, presplit_keys=presplit_keys,
            top_p=top_p, min_p=min_p)
        return buf[:, :pos].cpu().numpy().astype(np.int32)

    def sample_kvcache(self, prompt: list[str], max_len: int | None = None,
                       temperature: float = 1.0, top_k: int = 50,
                       seed: int = 0, greedy: bool = False,
                       top_p: float = 1.0, min_p: float = 0.0) -> list[str]:
        """Prompt token strings -> generated token strings, trimmed at the
        first [END_SEQUENCE] (inclusive), batch 1."""
        ids = self.vocab.encode(prompt)
        row = self.generate_ids(ids, max_len=max_len,
                                temperature=temperature, top_k=top_k,
                                seed=seed, greedy=greedy, top_p=top_p,
                                min_p=min_p)[0]
        return self.trim_at_eos(row)

    def trim_at_eos(self, row) -> list[str]:
        """ids -> token strings, truncated at the first EOS (inclusive)."""
        toks = []
        for i in row:
            toks.append(self.vocab.id2tok[int(i)])
            if int(i) == self.eos_id:
                break
        return toks
