"""Operations and bytes of the model's layers, from shapes alone.

Every ``mfu`` and ``*_roofline`` metric reads its work here, whatever kernel
implements the operation. A geometry is the dict :func:`geometry` makes
from a configuration's file. Counts are of what the inputs need: a
matrix product of [m, k] by [k, n] is 2 m k n operations; a decode step
reads each live row's keys and values at its positions once, its query
once and writes its output once; the FFN reads its weights and biases once
a call and its rows in and out once.

Positions: a request of ``n`` tokens whose first ``p`` are the prompt is
prefilled over positions 0..p-1 (the first generated token comes from the
prefill's last position); each later token at position s (p < s < n)
comes from a decode step that attends over s keys.
"""

from __future__ import annotations

PEAK_BYTES_PER_S = 3.35e12           # NVIDIA H100 SXM, HBM3
PEAK_FLOPS = {"bfloat16": 989e12,    # dense tensor-core rate
              "float32": 67e12}      # CUDA cores (TF32 off)
BYTES = {"bfloat16": 2, "float32": 4}


def geometry(config: dict) -> dict:
    """The widths of a configuration file's ``model``."""
    m = config["model"]
    H = m["n_head"]
    Hkv = m.get("n_kv_heads") or H
    D = m["d_model"]
    return {"D": D, "H": H, "Hkv": Hkv, "Dh": D // H, "kvd": Hkv * (D // H),
            "L": m["n_layer"], "FF": m.get("d_ff") or 4 * D,
            "V": m["vocab_size"]}


def linear_flops(g: dict) -> int:
    """One token through every layer's Q/K/V, out and FFN products."""
    D, kvd, FF = g["D"], g["kvd"], g["FF"]
    return 2 * g["L"] * (D * (D + 2 * kvd) + D * D + 2 * D * FF)


def head_flops(g: dict) -> int:
    return 2 * g["D"] * g["V"]


def attn_flops(g: dict, keys: int) -> int:
    """One query over ``keys`` keys in every layer: scores and values."""
    return 4 * g["L"] * g["D"] * keys


def request_flops(g: dict, p: int, n: int) -> int:
    """A request of ``n`` tokens, ``p`` of them its prompt: the prefill
    (no head but the last position's) and the decode steps."""
    if n <= p:
        return 0
    lin, head = linear_flops(g), head_flops(g)
    pre = p * lin + attn_flops(g, p * (p + 1) // 2) + head
    steps = n - p - 1
    keys = (n - 1) * n // 2 - p * (p + 1) // 2      # sum of s, p < s < n
    return pre + steps * (lin + head) + attn_flops(g, keys)


def train_row_flops(g: dict, t: int) -> int:
    """One causal training row of ``t`` positions, head at every position:
    the forward and a backward of twice its products."""
    fwd = t * (linear_flops(g) + head_flops(g)) \
        + attn_flops(g, t * (t + 1) // 2)
    return 3 * fwd


def decode_attn_bytes(g: dict, p: int, n: int, dtype: str) -> int:
    """The decode steps of a request (``p`` prompt tokens, ``n`` in all):
    each reads its row's K and V at s positions, its query, and writes its
    output, in every layer."""
    if n <= p + 1:
        return 0
    b = BYTES[dtype]
    steps = n - p - 1
    keys = (n - 1) * n // 2 - p * (p + 1) // 2
    return g["L"] * b * (2 * g["kvd"] * keys + 2 * g["D"] * steps)


def ffn_bytes(g: dict, calls: int, rows: int, dtype: str) -> int:
    """``calls`` FFN calls (a layer's, each reading W1, W2 and both biases
    once) over ``rows`` rows in all, each read and written once."""
    D, FF = g["D"], g["FF"]
    b = BYTES[dtype]
    return b * (calls * (2 * D * FF + FF + D) + rows * 2 * D)
