"""work.py's operations and bytes against counts made by hand at the
widths of demo-a (d512 h8, 2 K/V heads, L6, FF 2048, V 8892) and large2
(d512 h8 MHA, L6, FF 2048, V 8324)."""

from perfbench import core, work
from perfbench.tests import tiny

import os


def _geometry(name):
    return work.geometry(core.load_json(os.path.join(
        tiny.ROOT, "perfbench", "configs", name + ".json")))


def test_demo_a_counts():
    g = _geometry("demo-a")
    assert (g["D"], g["H"], g["Hkv"], g["Dh"], g["kvd"], g["L"], g["FF"],
            g["V"]) == (512, 8, 2, 64, 128, 6, 2048, 8892)
    # a token: 6 x 2 x (512 x (512 + 2 x 128) + 512 x 512 + 2 x 512 x 2048)
    assert work.linear_flops(g) == 33_030_144
    assert work.head_flops(g) == 2 * 512 * 8892 == 9_105_408
    assert work.attn_flops(g, 10) == 4 * 6 * 512 * 10
    # prompt 5, 8 tokens: 5 prefilled (keys 1..5), the head once, then
    # steps at s = 6, 7 over 6 + 7 keys
    assert work.request_flops(g, 5, 8) == 258_871_296
    assert work.request_flops(g, 5, 5) == 0
    # 2 steps x 6 layers x 2 bytes x (K and V of 128 at 13 keys + q, out)
    assert work.decode_attn_bytes(g, 5, 8, "bfloat16") == 64_512
    assert work.decode_attn_bytes(g, 5, 6, "bfloat16") == 0


def test_large2_counts():
    g = _geometry("large2")
    assert (g["Hkv"], g["kvd"], g["V"]) == (8, 512, 8324)
    assert work.linear_flops(g) == 37_748_736
    assert work.head_flops(g) == 8_523_776
    # 511 causal positions, head at each, forward and twice back
    assert work.train_row_flops(g, 511) == 75_758_161_920
    # 6 launches of W1, W2, b1, b2 in bf16 and 32 rows in and out
    assert work.ffn_bytes(g, 6, 32, "bfloat16") == 25_262_080
    assert work.decode_attn_bytes(g, 9, 11, "float32") \
        == 6 * 4 * (2 * 512 * 10 + 2 * 512)


def test_peaks():
    assert work.PEAK_FLOPS == {"bfloat16": 989e12, "float32": 67e12}
    assert work.PEAK_BYTES_PER_S == 3.35e12
