"""The served-token comparison that decides a decode cell's ``correct``.

A served sequence is (p, ids): its first p ids the prompt, the rest the
tokens the program served. The reference runs once, teacher-forced, over
each whole sequence, and at every served position reads a gap below a
bar of its own float32 logits there:

- a greedy sequence: the gap of the served token's logit below the
  reference's best. It is 0 up to rounding; a wrong logit, a wrong token or
  a token out of place shows as a gap of the size of the logits' spread.
- a sampled sequence (top-k ``top_k``): the gap of the served token's
  logit below the reference's ``top_k``-th largest, none under 0. A token
  within the top k reads 0, one at its edge a rounding; a mask that lets
  more tokens in, or a sampler that draws from the wrong set, reads the
  spread of the logits beyond the k-th.

The control puts the reference in the program's place at a lower
precision (``gpt_plain.fp8_weights``): at each position of the same
sequences it takes the token the control ranks first (greedy) or
``top_k``-th (the last a top-k mask of its own lets in), and reads the
float32 reference's gap for it.
"""

from __future__ import annotations

import torch

from . import gpt_plain


def _blocks(seqs: list, rows: int):
    order = sorted(range(len(seqs)), key=lambda i: len(seqs[i][1]))
    for at in range(0, len(order), rows):
        yield [order[i] for i in range(at, min(at + rows, len(order)))]


def _ids(seqs, block, device):
    T = max(len(seqs[i][1]) for i in block)
    ids = torch.zeros((len(block), T), dtype=torch.long)
    for r, i in enumerate(block):
        ids[r, :len(seqs[i][1])] = torch.tensor(seqs[i][1])
    return ids.to(device)


def served_gaps(w32: dict, m: dict, seqs: list, device, top_k=None,
                w_low=None, rows: int = 8) -> list:
    """Each sequence's widest gap (0.0 where it served nothing): below the
    reference's best, or with ``top_k`` below its ``top_k``-th largest.
    With ``w_low`` the control's tokens are judged in place of the served
    ones."""
    out = [0.0] * len(seqs)
    for block in _blocks(seqs, rows):
        ids = _ids(seqs, block, device)
        ref = gpt_plain.logits(w32, ids, m)
        low = (gpt_plain.logits(w_low, ids, m, dtype=torch.bfloat16)
               if w_low is not None else None)
        for r, i in enumerate(block):
            p, seq = seqs[i]
            n = len(seq)
            if n <= p:
                continue
            lg = ref[r, p - 1:n - 1]
            if top_k:
                bar = lg.topk(top_k, -1).values[:, -1]
            else:
                bar = lg.max(-1).values
            if low is None:
                pick = torch.tensor(seq[p:n], device=device)[:, None]
            elif top_k:
                pick = low[r, p - 1:n - 1].topk(top_k, -1).indices[:, -1:]
            else:
                pick = low[r, p - 1:n - 1].argmax(-1, keepdim=True)
            gap = bar - lg.gather(-1, pick)[:, 0]
            out[i] = max(float(gap.max()), 0.0)
        del ref, low
    return out
