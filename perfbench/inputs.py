"""Inputs the benchmark makes and hands to both the program and the
reference: weights from the seed, or a shipped checkpoint read as data.

``seed_weights`` draws a GPT's weights on the device with one
``torch.Generator`` there, in three calls (one uniform buffer for every
uniform leaf, one normal buffer for the embeddings, one for the
positions), in the dtype they are served in. The distributions are the
port's ``init_params``: N(0, 1) token embeddings, Xavier-uniform
``in_w``, zero ``in_b``, Kaiming-uniform linears with fan-in bias bounds,
LayerNorm at 1 and 0; the positions, zero there, are N(0, 0.02) here, so
that every position of a random model attends differently.
"""

from __future__ import annotations

import math
import os

import torch

from .reference.gpt_plain import load_pickle, tree_map


def _dims(m: dict) -> tuple:
    D, H = m["d_model"], m["n_head"]
    kvd = (m.get("n_kv_heads") or H) * (D // H)
    FF = m.get("d_ff") or 4 * D
    n_pos = m.get("pos_rows") or m["seq_len"] - 1
    return D, kvd, FF, m["vocab_size"], n_pos


def seed_weights(m: dict, seed: int, device, dtype) -> dict:
    D, kvd, FF, V, n_pos = _dims(m)
    L = m["n_layer"]
    g = torch.Generator(device=device)
    g.manual_seed(int(seed))
    shapes = []        # (path, shape, bound) of every uniform leaf

    def ku(fan_in):
        return math.sqrt(6.0 / (6 * fan_in))

    for li in range(L):
        shapes += [((li, "attn", "in_w"), (D + 2 * kvd, D),
                    math.sqrt(6.0 / (4 * D))),
                   ((li, "attn", "out_w"), (D, D), ku(D)),
                   ((li, "attn", "out_b"), (D,), 1 / math.sqrt(D)),
                   ((li, "mlp", "w1"), (FF, D), ku(D)),
                   ((li, "mlp", "b1"), (FF,), 1 / math.sqrt(D)),
                   ((li, "mlp", "w2"), (D, FF), ku(FF)),
                   ((li, "mlp", "b2"), (D,), 1 / math.sqrt(FF))]
    shapes += [(("head", "w"), (V, D), ku(D)),
               (("head", "b"), (V,), 1 / math.sqrt(D))]
    total = sum(math.prod(s) for _, s, _ in shapes)
    flat = torch.rand(total, generator=g, device=device) * 2 - 1
    emb = torch.randn((V, D), generator=g, device=device)
    pos = torch.randn((n_pos, D), generator=g, device=device) * 0.02
    layers = [{"attn": {"in_b": torch.zeros(D + 2 * kvd, device=device)},
               "ln1": {"g": torch.ones(D, device=device),
                       "b": torch.zeros(D, device=device)},
               "ln2": {"g": torch.ones(D, device=device),
                       "b": torch.zeros(D, device=device)},
               "mlp": {}} for _ in range(L)]
    w = {"tok_emb": emb, "pos": pos, "layers": layers, "head": {}}
    at = 0
    for path, shape, bound in shapes:
        n = math.prod(shape)
        leaf = flat[at:at + n].view(shape) * bound
        at += n
        if path[0] == "head":
            w["head"][path[1]] = leaf
        else:
            layers[path[0]][path[1]][path[2]] = leaf
    del flat
    return tree_map(lambda t: t.to(dtype).contiguous(), w)


def weights(cell, device, dtype) -> dict:
    """The configuration's weights: its checkpoint (in the dtypes it was
    saved in), or drawn from the run's seed in ``dtype``."""
    spec = cell.config["weights"]
    if "checkpoint" in spec:
        w = load_pickle(os.path.join(cell.root, spec["checkpoint"],
                                     "params.pkl"))
        return tree_map(lambda t: t.to(device), w)
    return seed_weights(cell.model(), cell.seed, device, dtype)


def gpt_config(m: dict):
    """The program's ``GPTConfig`` for a configuration's model."""
    import dataclasses

    from eamg_tpu_torch.models.gpt import GPTConfig

    names = {f.name for f in dataclasses.fields(GPTConfig)}
    return GPTConfig(**{k: v for k, v in m.items() if k in names})
