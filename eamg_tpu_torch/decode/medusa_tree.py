"""Medusa-2 tree verification: the heads' top-b candidates, one
tree-attention verify.

Port of ``eamg_tpu/decode/medusa_tree.py``. Each head contributes its
top-b candidates, arranged as a static tree of candidate paths
(:data:`DEFAULT_TREE`: 12 nodes, 4-2-1 branching early), and one forward
(``models/gpt.py::decode_tree``: siblings share a position, each node sees
the cached prefix and its ancestors) scores every path at once. The
acceptance walks the deepest path whose every node is the base argmax at
its parent, so the output is the plain greedy decode's. Greedy only and
batch 1, as in JAX.

The decode runs on the verify loop of ``decode/speculative.py``
(``SpecLoop`` with ``propose="tree"``): chunks of verify iterations, each
chunk one replay of a CUDA graph on the card and one packed read, every
write masked by whether the request still runs. The accepted path's K/V
are committed to the slots after the root's.
"""

from __future__ import annotations

import numpy as np
import torch

from ..models.gpt import GPTConfig
from . import graphs
from .speculative import K_VERIFIES, run_to_end, spec_state

# (parent_node, head_index, candidate_rank); node 0 is the root (the last
# verified token), spec entries are nodes 1..len(spec).
DEFAULT_TREE: tuple = (
    (0, 0, 0), (0, 0, 1), (0, 0, 2), (0, 0, 3),   # depth 1: top-4
    (1, 1, 0), (1, 1, 1), (2, 1, 0),              # depth 2
    (5, 2, 0), (5, 2, 1), (6, 2, 0),              # depth 3
    (8, 3, 0), (9, 3, 0),                         # depth 4
)


def tree_tables(spec: tuple = DEFAULT_TREE) -> dict:
    """Static numpy tables for a tree spec: parents, heads, ranks, depths,
    the [N, N] ancestor-or-self matrix, and the [N, gamma] path table
    (chain[i, d] = the node at depth d + 1 on root -> i)."""
    N = len(spec) + 1
    parent = np.zeros(N, np.int32)
    head = np.zeros(N, np.int32)
    rank = np.zeros(N, np.int32)
    depth = np.zeros(N, np.int32)
    for i, (p, h, r) in enumerate(spec, start=1):
        assert p < i, "parents must precede children"
        parent[i], head[i], rank[i] = p, h, r
        depth[i] = depth[p] + 1
    anc = np.zeros((N, N), bool)
    for i in range(N):
        j = i
        while True:
            anc[i, j] = True
            if j == 0:
                break
            j = int(parent[j])
    gamma = int(depth.max())
    chain = np.zeros((N, gamma), np.int32)
    for i in range(N):
        j = i
        while j != 0:
            chain[i, depth[j] - 1] = j
            j = int(parent[j])
    b_max = int(rank.max()) + 1
    n_heads = int(head[1:].max()) + 1 if N > 1 else 0
    return {"parent": parent, "head": head, "rank": rank,
            "depth": depth, "anc": anc, "chain": chain, "N": N,
            "gamma": gamma, "b_max": b_max, "n_heads": n_heads}


def _top_b(logits: torch.Tensor, b: int) -> torch.Tensor:
    """[g, V] -> [g, b]: ``b`` rounds of argmax, each subtracting inf at
    its pick (b is tiny). JAX writes the mask as ``one_hot * inf``, which
    its compiled program computes as a select of inf and 0 (the form
    here); op by op, 0 * inf would be NaN."""
    vocab = torch.arange(logits.shape[-1], device=logits.device)
    out, lg = [], logits
    for _ in range(b):
        idx = torch.argmax(lg, -1)
        out.append(idx)
        lg = lg - torch.where(vocab == idx[..., None], float("inf"), 0.0)
    return torch.stack(out, dim=1)


@torch.no_grad()
def generate_medusa_tree(params: dict, heads: dict, prompt: torch.Tensor,
                         prompt_len: int, cfg: GPTConfig, max_len: int,
                         tree: tuple = DEFAULT_TREE, eos_id: int = -1,
                         pad_id: int = 0, eager: bool = False):
    """Greedy tree-verified decode: prompt [1, P] (a bucket, on the
    params' device) -> (tokens [1, max_len] int64 on the host, n_tokens,
    n_verify_steps). The output is the plain greedy decode's; tokens a
    verify step is the gain. ``eager=True`` issues every iteration from
    the host instead of replaying graphs, to compare the two."""
    assert cfg.causal and not cfg.pos_broadcast_bug
    tb = tree_tables(tree)
    assert len(heads["blocks"]) >= tb["n_heads"]
    assert prompt.shape[0] == 1
    assert cfg.n_pos >= max_len + tb["gamma"]
    key, make = spec_state(params, cfg, "tree", max_len, tb["gamma"],
                           K_VERIFIES, 0, True, 1.0, 0.0, eos_id, pad_id,
                           prompt.device, heads=heads, eager=eager,
                           tree=tuple(tree))
    with graphs.pooled(key, make) as st:
        return run_to_end(st, prompt, prompt_len, (0, 0), 1.0, 1.0, 0.0)
