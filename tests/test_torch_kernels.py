"""The port's kernel modules against the JAX package, in f32 on the CPU.

On the CPU each of the port's kernel wrappers (eamg_tpu_torch/ops) runs
its plain PyTorch version; here each is held against the JAX Pallas kernel
it replaces (interpret mode, as tests/test_ops.py runs it) and against the
JAX XLA path. Inputs are made with numpy from a seed; the torch side runs
in one subprocess (tests/torch_port_worker.py). The CUDA kernels
themselves are held against these plain versions on the card by
chip_smoke.py.

Tolerances: attention, FFN, decode attention, fold decode attention and
the stream reduce 1e-5 (f32, sums in other orders); the top-k and top-p
thresholds are exact searches over integer keys, so bit-equal. The five
one-launch decode kernels are also held in bf16 against the JAX XLA path
(XLA:CPU has no bf16 x bf16 -> f32 product, so the Pallas kernels do not
run in bf16 here), to one bf16 step of an output of size 2..4 (2^-6):
both sides round the scores to bf16, the fold and fold2 plain version
rounds the probabilities unnormalised and XLA's normalised.
"""

from __future__ import annotations

import json
import math

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from eamg_tpu.ops.attention import flash_attention, xla_attention
from eamg_tpu.ops.decode_attention import (flash_decode, flash_decode_sp,
                                           flash_decode_vmem,
                                           xla_decode_attention)
from eamg_tpu.ops.decode_fold import (flash_decode_fold, flash_decode_fold2,
                                      flash_decode_fold3,
                                      flash_decode_fold3_sp,
                                      flash_decode_fold_sp, stream_reduce,
                                      xla_decode_attention_pm)
from eamg_tpu.ops.ffn import fused_ffn
from eamg_tpu.ops.topk import (kth_value_bitsearch, kth_value_pallas,
                               top_p_threshold_bitsearch)

from port_harness import flatten, run_worker

TOL = 1e-5
BF16_TOL = 2.0 ** -6

# name: (B, H, Hkv, T, Dh, causal, valid_len)
ATTN_CASES = {
    "mha_causal": (2, 4, 4, 24, 16, True, None),
    "gqa_causal_valid": (2, 4, 2, 24, 16, True, 17),
    "gqa_bidir_valid": (1, 8, 2, 20, 32, False, 13),
    # demo_ckpt_b3's head: 3 k-steps of 16
    "gqa_causal_dh48": (2, 4, 2, 24, 48, True, 19),
    "mha_bidir_dh48": (1, 2, 2, 16, 48, False, None),
}
# name: (rows shape, D, FF, activation)
FFN_CASES = {"relu": ((2, 5), 64, 256, "relu"),
             "gelu": ((7,), 64, 128, "gelu")}
DEC_TS = (0, 5, 17, 63)            # M 64 = 4 blocks of 16
DEC48_TS = (0, 17, 63)             # the same cache at Dh 48
DEC_RAGGED_M, DEC_RAGGED_T = 50, 41
TOPK_KS = (1, 50, 300)             # V = 300
TOPP_PS = (0.1, 0.5, 0.9)
# fold decode: B 3, D 64, 4 heads; name: KV heads
FOLD_HEADS = {"mha": 4, "gqa": 2}
FOLD_M = 64                        # 4 key blocks of 16
# newest valid position: a scalar for all rows, or one per row
FOLD_TS = {"t0": 0, "t17": 17, "tlast": FOLD_M - 1,
           "rows": np.asarray([0, 17, FOLD_M - 1], np.int32)}
FOLD_RAGGED_M = 50                 # no multiple of a key block
FOLD_ENTRIES = {"flash_decode_fold_sp": flash_decode_fold_sp,
                "flash_decode_fold3_sp": flash_decode_fold3_sp}
# the same at Dh 48 (demo_ckpt_b3's head): B 3, D 192, 4 heads
FOLD48_TS = {"t17": 17, "rows": np.asarray([0, 17, FOLD_M - 1], np.int32)}
STREAM_ROWS = (2, 4)               # kv [4, 16, 32]
# the two scalar-t kernels: MHA B 2, H 4, Dh 16; M 64 = 4 blocks of 16 for
# flash_decode, and M 50, which only flash_decode_vmem takes in JAX
SCALAR_T = {"flash_decode": lambda q, k, v, t: flash_decode(
                q, k, v, t, block_k=16, interpret=True),
            "flash_decode_vmem": lambda q, k, v, t: flash_decode_vmem(
                q, k, v, t, interpret=True)}
DEC1_BF16_TS = (5, 63)
# the three one-launch fold kernels: B 4, D 64, 4 heads; per-row and
# scalar t; M 64 and M 50 (they read the whole cache: any M in JAX too)
WHOLE = {"flash_decode_fold": flash_decode_fold,
         "flash_decode_fold2": flash_decode_fold2,
         "flash_decode_fold3": flash_decode_fold3}
WHOLE_MS = (64, 50)
WHOLE_TS = {"t0": 0, "t17": 17, "rows": np.asarray([0, 17, 49, 40], np.int32)}
WHOLE_ROWS = (2, 4)
# shapes at which the wrappers of the cluster kernel are held to their
# launch arguments: (B, n_head, kv_heads, M, Dh, dtype, resident clusters
# of 16 the card reports): the batch bench's, GQA, MQA, a scalar-row batch,
# a cache of one position, a card that places no cluster of 16, and
# demo_ckpt_b3's heads (Dh 48, MHA, M 256) in both dtypes
CLUSTER_LAUNCH_SHAPES = (
    (8, 8, 8, 511, 64, "bfloat16", 7), (4, 4, 2, 64, 32, "float32", 1),
    (4, 8, 1, 100, 128, "bfloat16", 3), (4, 16, 8, 4096, 64, "float32", 2),
    (4, 2, 2, 1, 64, "bfloat16", 1), (8, 8, 8, 511, 64, "bfloat16", 0),
    (8, 4, 4, 256, 48, "bfloat16", 1), (4, 4, 4, 256, 48, "float32", 0))
# the scalar-t cluster kernel of flash_decode and flash_decode_vmem: (t, M,
# C) whose key spans are checked: t 0, fewer keys than blocks, a 256-key
# boundary inside a span, the bench shape at t 300 and 510, t past the
# cache, a one-position cache, a long cache
SPAN_CASES = ((0, 511, 4), (2, 511, 4), (300, 511, 4), (510, 511, 4),
              (300, 511, 16), (255, 511, 8), (256, 511, 2), (700, 511, 4),
              (0, 1, 16), (41, 50, 1), (59999, 60000, 16), (30000, 60000, 8))
# (M, resident clusters of 16) -> the cluster size picked
SCALAR_T_SIZES = {(1, 0): 2, (511, 0): 2, (511, 9): 2, (1024, 3): 2,
                  (1025, 3): 4, (4096, 3): 4, (4097, 3): 16, (60000, 1): 16,
                  (60000, 0): 8}
# shapes at which both wrappers are held to their launch arguments: (B, H,
# M, Dh, dtype, t, resident clusters of 16): the bench shape, a long cache
# (with and without a cluster of 16), f32 at Dh 16 and 128
SCALAR_T_LAUNCH_SHAPES = (
    (8, 8, 511, 64, "bfloat16", 300, 5), (1, 8, 60000, 64, "bfloat16", 59999,
                                          2),
    (1, 8, 60000, 64, "bfloat16", 7, 0), (2, 4, 50, 16, "float32", 41, 1),
    (2, 2, 1000, 128, "float32", 999, 1))
# resident clusters of 16 blocks the card may report -> the cluster size
# picked: 16 wherever the card can place one
RESIDENT_16 = {0: 8, 1: 16, 7: 16, 14: 16}
# K3: t [B] of each case, M and C: each row's spans from its own t (a free
# slot, fewer keys than blocks, both sides of a 128-key block, the last
# slot, t past the cache)
ROW_SPAN_CASES = (((0, 15, 127, 128, 300, 510, 200, 64), 511, 4),
                  ((3, 700, 0), 511, 8), ((16383, 5), 16384, 16),
                  ((49, 0), 50, 2))
# (M, g, resident clusters of 16) -> K3's cluster size: from M and g alone
SP_SIZES = {(511, 4, 0): 8, (511, 1, 0): 2, (1024, 2, 9): 8,
            (1025, 4, 3): 16, (1025, 4, 0): 8, (4096, 8, 3): 16,
            (2048, 1, 0): 4, (16384, 1, 2): 16, (16384, 4, 0): 8}
# K1 ("attn": L = T) and K3 ("sp": L = M) on CUDA inputs through the
# mocked binder: (kind, B, H, Hkv, L, Dh, dtype, resident clusters of 16)
CARD_CASES = (("sp", 1, 8, 2, 511, 64, "bfloat16", 0),
              ("sp", 8, 8, 8, 511, 64, "bfloat16", 0),
              ("sp", 2, 8, 1, 16384, 128, "float32", 3),
              ("sp", 2, 4, 4, 511, 48, "bfloat16", 0),
              ("attn", 1, 8, 2, 16, 64, "bfloat16", 0),
              ("attn", 8, 8, 8, 16, 64, "float32", 0),
              ("attn", 2, 4, 2, 511, 48, "bfloat16", 0),
              # refused: Dh 40, 96 and 256, and g 3 for K3
              ("sp", 1, 8, 2, 511, 40, "bfloat16", 0),
              ("sp", 1, 8, 2, 511, 256, "float32", 0),
              ("sp", 1, 6, 2, 511, 64, "bfloat16", 0),
              ("attn", 1, 8, 2, 16, 96, "bfloat16", 0),
              ("attn", 1, 8, 2, 16, 40, "float32", 0))
# K3's plan at the first four cases: (by head, blocks a cluster)
SP_PLANS = {0: (1, 4), 1: (0, 2), 2: (0, 16), 3: (0, 2)}
# (M, Dh, g, dtype size, resident clusters of 16) -> K3's plan: by head
# (a cluster of g blocks) where g > 1 and a block holds every key and
# value of the KV head, else over spans (cluster_size)
SP_PLAN_CASES = {(511, 64, 4, 2, 0): (1, 4), (511, 64, 4, 4, 0): (0, 8),
                 (511, 128, 8, 2, 0): (0, 8), (200, 32, 2, 2, 0): (1, 2),
                 (16384, 64, 4, 2, 1): (0, 16), (511, 64, 1, 2, 0): (0, 2),
                 (50, 48, 4, 4, 0): (1, 4), (800, 64, 8, 2, 0): (1, 8)}
CARD_TAKES = CARD_CASES[:7]
CARD_REFUSES = CARD_CASES[7:]
# flash_decode_fold_sp and flash_decode_fold3_sp on CUDA inputs through the
# mocked binder: (B, H, Hkv, M, Dh, dtype, resident clusters of 16): the
# engine's step, the batched decode's MHA, demo_ckpt_b3's (Dh 48, MHA, M
# 256), a GQA cache too long to go by head, the engine's in f32 (a block
# cannot hold the KV head in f32); refused: Dh 40
FOLD_SP_CASES = ((8, 8, 2, 511, 64, "bfloat16", 0),
                 (8, 8, 8, 511, 64, "bfloat16", 0),
                 (8, 4, 4, 256, 48, "bfloat16", 0),
                 (2, 8, 2, 16384, 64, "bfloat16", 3),
                 (8, 8, 2, 511, 64, "float32", 0),
                 (8, 8, 2, 511, 40, "bfloat16", 0))
# K3's plan at the cases they take: (by head, blocks a cluster)
FOLD_SP_PLANS = {0: (1, 4), 1: (0, 2), 2: (0, 2), 3: (0, 16), 4: (0, 8)}
FOLD_SP_TAKES = FOLD_SP_CASES[:5]
# K2's plan (ops/ffn.py::ffn_plan): (D, FF), multiples of 64 as today's
# kernel takes them: the flagship's, one panel of the smallest, FF with a
# slice count no multiple of 8, D past one panel, a wide D
FFN_PLAN_SHAPES = ((512, 2048), (64, 64), (192, 192), (1536, 192),
                   (4096, 64), (128, 320), (768, 3072))
# what K2's argument check refuses: case -> (x shape, FF, x dtype, bias
# dtype, activation, a phrase of the error)
FFN_REFUSE = {
    "d96": ((3, 96), 64, "float32", "float32", "relu", "multiples of 64"),
    "ff100": ((3, 64), 100, "float32", "float32", "relu", "multiples of 64"),
    "d0": ((3, 0), 64, "float32", "float32", "relu", "multiples of 64"),
    "float16": ((3, 64), 64, "float16", "float16", "relu", "want float32"),
    "silu": ((3, 64), 64, "float32", "float32", "silu", "relu or gelu"),
    "w1_shape": ((3, 64), 64, "float32", "float32", "relu", "shapes"),
    "b2_shape": ((3, 64), 64, "float32", "float32", "relu", "shapes"),
}
# ... and takes: every D and FF multiple of 64, f32 or bf16, biases of any
# float dtype (the checkpoint's bf16 ones in an f32 run), relu or gelu, any
# leading shape
FFN_TAKE = {
    "flagship": ((1, 512), 2048, "bfloat16", "bfloat16", "relu"),
    "bf16_bias_in_f32": ((4, 512), 2048, "float32", "bfloat16", "relu"),
    "f16_bias_in_bf16": ((3, 64), 64, "bfloat16", "float16", "relu"),
    "batch": ((8, 16, 512), 2048, "bfloat16", "bfloat16", "relu"),
    "f32_bias_in_bf16": ((5, 1536), 192, "bfloat16", "float32", "gelu"),
    "f32": ((2, 64), 64, "float32", "float32", "gelu"),
    "wide": ((4, 4096), 128, "float32", "float32", "relu"),
    "b3": ((3, 192), 768, "bfloat16", "bfloat16", "relu"),
}


def _rng():
    return np.random.default_rng(1234)


def _repeat(a, g):
    return jnp.repeat(jnp.asarray(a), g, axis=1)


def _inputs():
    rng = _rng()
    inp, ref = {}, {}
    for name, (B, H, Hkv, T, Dh, causal, vl) in ATTN_CASES.items():
        q = rng.standard_normal((B, H, T, Dh), np.float32)
        k = rng.standard_normal((B, Hkv, T, Dh), np.float32)
        v = rng.standard_normal((B, Hkv, T, Dh), np.float32)
        a = {"q": q, "k": k, "v": v, "causal": np.asarray(causal)}
        if vl is not None:
            a["valid_len"] = np.full((B,), vl, np.int32)
        inp.update(flatten(a, f"attn/{name}"))
        g = H // Hkv
        kr, vr = _repeat(k, g), _repeat(v, g)
        ref[("attn", name, "pallas")] = np.asarray(flash_attention(
            jnp.asarray(q), kr, vr, valid_len=vl, causal=causal))
        ref[("attn", name, "xla")] = np.asarray(xla_attention(
            jnp.asarray(q), kr, vr, valid_len=vl, causal=causal))
    for name, (lead, D, FF, act) in FFN_CASES.items():
        x = rng.standard_normal((*lead, D), np.float32)
        w1 = rng.uniform(-1, 1, (FF, D)).astype(np.float32) / math.sqrt(D)
        b1 = rng.uniform(-0.1, 0.1, (FF,)).astype(np.float32)
        w2 = rng.uniform(-1, 1, (D, FF)).astype(np.float32) / math.sqrt(FF)
        b2 = rng.uniform(-0.1, 0.1, (D,)).astype(np.float32)
        inp.update(flatten({"x": x, "w1": w1, "b1": b1, "w2": w2, "b2": b2,
                            "activation": np.asarray(act)}, f"ffn/{name}"))
        ref[("ffn", name, "pallas")] = np.asarray(fused_ffn(
            jnp.asarray(x), w1, b1, w2, b2, activation=act))
        h = jnp.asarray(x) @ w1.T + b1               # models/gpt.py::_mlp
        h = jax.nn.relu(h) if act == "relu" else jax.nn.gelu(
            h, approximate=False)
        ref[("ffn", name, "xla")] = np.asarray(h @ w2.T + b2)
    B, H, Hkv, Dh = 2, 4, 2, 16
    for M, ts in ((64, DEC_TS), (DEC_RAGGED_M, (DEC_RAGGED_T,))):
        kc = rng.standard_normal((B, Hkv, M, Dh), np.float32)
        vc = rng.standard_normal((B, Hkv, M, Dh), np.float32)
        q = rng.standard_normal((B, H, 1, Dh), np.float32)
        for t in ts:
            name = f"M{M}_t{t}"
            inp.update(flatten({"q": q, "k": kc, "v": vc,
                                "t": np.full((B,), t, np.int32)},
                               f"dec/{name}"))
            kr, vr = _repeat(kc, H // Hkv), _repeat(vc, H // Hkv)
            if M % 16 == 0:
                ref[("dec", name, "pallas")] = np.asarray(flash_decode_sp(
                    jnp.asarray(q), kr, vr, t, block_k=16))
            ref[("dec", name, "xla")] = np.asarray(xla_decode_attention(
                jnp.asarray(q), kr, vr, t))
    # K3 at Dh 48, GQA-2, M 64: its own generator, so the draws after it
    # stay those of earlier versions
    r48 = np.random.default_rng(48)
    kc = r48.standard_normal((B, Hkv, 64, 48), np.float32)
    vc = r48.standard_normal((B, Hkv, 64, 48), np.float32)
    q = r48.standard_normal((B, H, 1, 48), np.float32)
    kr, vr = _repeat(kc, H // Hkv), _repeat(vc, H // Hkv)
    for t in DEC48_TS:
        name = f"M64_t{t}_dh48"
        inp.update(flatten({"q": q, "k": kc, "v": vc,
                            "t": np.full((B,), t, np.int32)}, f"dec/{name}"))
        ref[("dec", name, "pallas")] = np.asarray(flash_decode_sp(
            jnp.asarray(q), kr, vr, t, block_k=16))
        ref[("dec", name, "xla")] = np.asarray(xla_decode_attention(
            jnp.asarray(q), kr, vr, t))
    V = 300
    logits = (rng.standard_normal((3, V)) * 3).astype(np.float32)
    logits[:, 10:20] = logits[:, 3:4]              # ties
    logits[0, 40] = np.inf
    logits[1, 41:45] = -np.inf
    for k in TOPK_KS:
        name = f"k{k}"
        inp.update(flatten({"logits": logits, "k": np.asarray(k)},
                           f"topk/{name}"))
        ref[("topk", name, "pallas")] = np.asarray(kth_value_pallas(
            jnp.asarray(logits), k))
        ref[("topk", name, "xla")] = np.asarray(kth_value_bitsearch(
            jnp.asarray(logits), k))
    finite = np.where(np.isfinite(logits), logits, 0.0).astype(np.float32)
    for p in TOPP_PS:
        name = f"p{p}"
        inp.update(flatten({"logits": finite, "p": np.asarray(p)},
                           f"topp/{name}"))
        ref[("topp", name, "xla")] = np.asarray(top_p_threshold_bitsearch(
            jnp.asarray(finite), p))
    B, D, H = 3, 64, 4
    for hname, kvh in FOLD_HEADS.items():
        KVD = kvh * (D // H)
        for M, ts in ((FOLD_M, FOLD_TS),
                      (FOLD_RAGGED_M, {"rows": np.asarray([0, 41, 49],
                                                          np.int32)})):
            q = rng.standard_normal((B, 1, D), np.float32)
            kv = rng.standard_normal((B, M, 2 * KVD), np.float32)
            for tname, t in ts.items():
                name = f"{hname}_M{M}_{tname}"
                inp.update(flatten({"q": q, "kv": kv, "t": np.asarray(t),
                                    "n_head": np.asarray(H)},
                                   f"fold/{name}"))
                tj = jnp.asarray(t)
                ref[("fold", name, "xla")] = np.asarray(
                    xla_decode_attention_pm(jnp.asarray(q), jnp.asarray(kv),
                                            tj, H))
                if M % 16 == 0:
                    for entry, fn in FOLD_ENTRIES.items():
                        ref[("fold", name, entry)] = np.asarray(fn(
                            jnp.asarray(q), jnp.asarray(kv), tj, H,
                            block_k=16, interpret=True))
    # the fold entries at Dh 48: a generator of their own, so the draws
    # after it stay those of earlier versions
    r48 = np.random.default_rng(4848)
    B, D, H = 3, 192, 4
    for hname, kvh in FOLD_HEADS.items():
        KVD = kvh * (D // H)
        q = r48.standard_normal((B, 1, D), np.float32)
        kv = r48.standard_normal((B, FOLD_M, 2 * KVD), np.float32)
        for tname, t in FOLD48_TS.items():
            name = f"{hname}_M{FOLD_M}_{tname}_dh48"
            inp.update(flatten({"q": q, "kv": kv, "t": np.asarray(t),
                                "n_head": np.asarray(H)}, f"fold/{name}"))
            tj = jnp.asarray(t)
            ref[("fold", name, "xla")] = np.asarray(xla_decode_attention_pm(
                jnp.asarray(q), jnp.asarray(kv), tj, H))
            for entry, fn in FOLD_ENTRIES.items():
                ref[("fold", name, entry)] = np.asarray(fn(
                    jnp.asarray(q), jnp.asarray(kv), tj, H, block_k=16,
                    interpret=True))
    B, H, Dh = 2, 4, 16
    for M, ts in ((64, DEC_TS), (DEC_RAGGED_M, (DEC_RAGGED_T,))):
        kc = rng.standard_normal((B, H, M, Dh), np.float32)
        vc = rng.standard_normal((B, H, M, Dh), np.float32)
        q = rng.standard_normal((B, H, 1, Dh), np.float32)
        for t in ts:
            for bf in (False, True) if M == 64 and t in DEC1_BF16_TS \
                    else (False,):
                dt = jnp.bfloat16 if bf else jnp.float32
                qj, kj, vj = (jnp.asarray(a, dt) for a in (q, kc, vc))
                name = f"M{M}_t{t}" + ("_bf16" if bf else "")
                inp.update(flatten({"q": qj, "k": kj, "v": vj,
                                    "t": np.asarray(t),
                                    "bf16": np.asarray(bf)}, f"dec1/{name}"))
                ref[("dec1", name, "xla")] = np.asarray(xla_decode_attention(
                    qj, kj, vj, t).astype(jnp.float32))
                for entry, fn in SCALAR_T.items():
                    if not bf and (M % 16 == 0
                                   or entry == "flash_decode_vmem"):
                        ref[("dec1", name, entry)] = np.asarray(
                            fn(qj, kj, vj, t).astype(jnp.float32))
    inp.update(flatten({"q": q, "k": kc, "v": vc,
                        "fq": rng.standard_normal((4, 1, 64), np.float32),
                        "fkv": rng.standard_normal((4, 8, 128), np.float32)},
                       "refuse"))
    B, D, H = 4, 64, 4
    for hname, kvh in FOLD_HEADS.items():
        KVD = kvh * (D // H)
        for M in WHOLE_MS:
            q = rng.standard_normal((B, 1, D), np.float32)
            kv = rng.standard_normal((B, M, 2 * KVD), np.float32)
            for tname, t in WHOLE_TS.items():
                for bf in (False, True) if tname == "rows" else (False,):
                    dt = jnp.bfloat16 if bf else jnp.float32
                    qj, kvj = jnp.asarray(q, dt), jnp.asarray(kv, dt)
                    name = f"{hname}_M{M}_{tname}" + ("_bf16" if bf else "")
                    inp.update(flatten(
                        {"q": qj, "kv": kvj, "t": np.asarray(t),
                         "n_head": np.asarray(H), "bf16": np.asarray(bf),
                         "rows": np.asarray(WHOLE_ROWS)}, f"whole/{name}"))
                    tj = jnp.asarray(t)
                    ref[("whole", name, "xla")] = np.asarray(
                        xla_decode_attention_pm(qj, kvj, tj, H)
                        .astype(jnp.float32))
                    for entry, fn in () if bf else WHOLE.items():
                        ref[("whole", name, entry)] = np.asarray(
                            fn(qj, kvj, tj, H, interpret=True)
                            .astype(jnp.float32))
    inp["clusterlaunch/shapes"] = np.asarray(json.dumps(
        CLUSTER_LAUNCH_SHAPES))
    inp["ffnplan/shapes"] = np.asarray(FFN_PLAN_SHAPES)
    inp["ffncheck/cases"] = np.asarray(json.dumps(
        {**{f"refuse/{k}": v[:5] for k, v in FFN_REFUSE.items()},
         **{f"take/{k}": v for k, v in FFN_TAKE.items()}}))
    inp["plan/resident"] = np.asarray(list(RESIDENT_16))
    inp["spans/cases"] = np.asarray(json.dumps(SPAN_CASES))
    inp["scalartsize/cases"] = np.asarray(list(SCALAR_T_SIZES))
    inp["scalartlaunch/shapes"] = np.asarray(json.dumps(
        SCALAR_T_LAUNCH_SHAPES))
    inp["rowspans/cases"] = np.asarray(json.dumps(ROW_SPAN_CASES))
    inp["spsize/cases"] = np.asarray(list(SP_SIZES))
    inp["cardlaunch/cases"] = np.asarray(json.dumps(CARD_CASES))
    inp["foldsp/cases"] = np.asarray(json.dumps(FOLD_SP_CASES))
    inp["spplan/cases"] = np.asarray(list(SP_PLAN_CASES))
    kv = rng.standard_normal((4, 16, 32), np.float32)
    for rows in STREAM_ROWS:
        inp.update(flatten({"kv": kv, "rows": np.asarray(rows)},
                           f"stream/rows{rows}"))
        ref[("stream", rows)] = np.asarray(stream_reduce(
            jnp.asarray(kv), rows=rows, interpret=True))
    return inp, ref


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    inp, ref = _inputs()
    got = run_worker("kernels", inp, tmp_path_factory.mktemp("kernels"))
    return got, ref


@pytest.mark.parametrize("name", list(ATTN_CASES))
@pytest.mark.parametrize("against", ["pallas", "xla"])
def test_attention_plain_matches_jax(results, name, against):
    got, ref = results
    np.testing.assert_allclose(got[f"attn/{name}"],
                               ref[("attn", name, against)], rtol=TOL,
                               atol=TOL)


@pytest.mark.parametrize("name", list(FFN_CASES))
@pytest.mark.parametrize("against", ["pallas", "xla"])
def test_ffn_plain_matches_jax(results, name, against):
    got, ref = results
    np.testing.assert_allclose(got[f"ffn/{name}"],
                               ref[("ffn", name, against)], rtol=TOL,
                               atol=TOL)


@pytest.mark.parametrize("t", DEC_TS)
@pytest.mark.parametrize("against", ["pallas", "xla"])
def test_decode_attention_plain_matches_jax(results, t, against):
    got, ref = results
    name = f"M64_t{t}"
    np.testing.assert_allclose(got[f"dec/{name}"],
                               ref[("dec", name, against)], rtol=TOL,
                               atol=TOL)


def test_decode_attention_plain_takes_ragged_cache(results):
    """M = 50 is no multiple of a block (the flagship's cache is 511):
    JAX's flash_decode_sp asserts on it, the port takes it."""
    got, ref = results
    name = f"M{DEC_RAGGED_M}_t{DEC_RAGGED_T}"
    np.testing.assert_allclose(got[f"dec/{name}"], ref[("dec", name, "xla")],
                               rtol=TOL, atol=TOL)


@pytest.mark.parametrize("t", DEC48_TS)
@pytest.mark.parametrize("against", ["pallas", "xla"])
def test_decode_attention_plain_dh48_matches_jax(results, t, against):
    """K3's function at demo_ckpt_b3's Dh 48 (GQA-2, M 64) against JAX's
    flash_decode_sp (interpret mode) and XLA."""
    got, ref = results
    name = f"M64_t{t}_dh48"
    assert got[f"dec/{name}"].shape == (2, 4, 1, 48)
    np.testing.assert_allclose(got[f"dec/{name}"],
                               ref[("dec", name, against)], rtol=TOL,
                               atol=TOL)


@pytest.mark.parametrize("k", TOPK_KS)
@pytest.mark.parametrize("against", ["pallas", "xla"])
def test_kth_value_plain_bit_equal(results, k, against):
    got, ref = results
    a = got[f"topk/k{k}"]
    b = ref[("topk", f"k{k}", against)]
    assert a.shape == b.shape == (3, 1)
    np.testing.assert_array_equal(a.view(np.uint32), b.view(np.uint32))


@pytest.mark.parametrize("p", TOPP_PS)
def test_top_p_threshold_bit_equal(results, p):
    got, ref = results
    a = got[f"topp/p{p}"]
    b = ref[("topp", f"p{p}", "xla")]
    np.testing.assert_array_equal(a.view(np.uint32), b.view(np.uint32))


@pytest.mark.parametrize("entry", list(FOLD_ENTRIES))
@pytest.mark.parametrize("heads", list(FOLD_HEADS))
@pytest.mark.parametrize("tname", list(FOLD_TS))
@pytest.mark.parametrize("against", ["pallas", "xla"])
def test_fold_decode_plain_matches_jax(results, entry, heads, tname, against):
    """Each fold entry point against the Pallas kernel it replaces
    (interpret mode) and against xla_decode_attention_pm; scalar and
    per-row t, including 0 and M - 1."""
    got, ref = results
    name = f"{heads}_M{FOLD_M}_{tname}"
    want = ref[("fold", name, entry if against == "pallas" else "xla")]
    assert got[f"fold/{name}/{entry}"].shape == want.shape == (3, 1, 64)
    np.testing.assert_allclose(got[f"fold/{name}/{entry}"], want, rtol=TOL,
                               atol=TOL)


@pytest.mark.parametrize("entry", list(FOLD_ENTRIES))
@pytest.mark.parametrize("heads", list(FOLD_HEADS))
@pytest.mark.parametrize("tname", list(FOLD48_TS))
@pytest.mark.parametrize("against", ["pallas", "xla"])
def test_fold_decode_plain_dh48_matches_jax(results, entry, heads, tname,
                                            against):
    """The two fold entries at Dh 48 (demo_ckpt_b3's head, which their
    kernel takes) against the Pallas kernels they replace (interpret mode)
    and against xla_decode_attention_pm; scalar and per-row t."""
    got, ref = results
    name = f"{heads}_M{FOLD_M}_{tname}_dh48"
    want = ref[("fold", name, entry if against == "pallas" else "xla")]
    assert got[f"fold/{name}/{entry}"].shape == want.shape == (3, 1, 192)
    np.testing.assert_allclose(got[f"fold/{name}/{entry}"], want, rtol=TOL,
                               atol=TOL)


@pytest.mark.parametrize("entry", list(FOLD_ENTRIES))
@pytest.mark.parametrize("heads", list(FOLD_HEADS))
def test_fold_decode_plain_takes_ragged_cache(results, entry, heads):
    """M = 50 is no multiple of a key block (the flagship's cache is 511):
    the JAX wrappers assert on it, the port takes it."""
    got, ref = results
    name = f"{heads}_M{FOLD_RAGGED_M}_rows"
    np.testing.assert_allclose(got[f"fold/{name}/{entry}"],
                               ref[("fold", name, "xla")], rtol=TOL, atol=TOL)


@pytest.mark.parametrize("rows", STREAM_ROWS)
def test_stream_reduce_plain_matches_pallas(results, rows):
    """The last group's sum, as the Pallas kernel returns it."""
    got, ref = results
    assert got[f"stream/rows{rows}"].shape == (1, 32)
    np.testing.assert_allclose(got[f"stream/rows{rows}"],
                               ref[("stream", rows)], rtol=TOL, atol=TOL)


@pytest.mark.parametrize("entry", list(SCALAR_T))
@pytest.mark.parametrize("t", DEC_TS)
@pytest.mark.parametrize("against", ["pallas", "xla"])
def test_scalar_t_decode_plain_matches_jax(results, entry, t, against):
    """flash_decode and flash_decode_vmem (MHA caches, one scalar t) against
    the Pallas kernel of the same name (interpret mode) and against
    xla_decode_attention."""
    got, ref = results
    name = f"M64_t{t}"
    want = ref[("dec1", name, entry if against == "pallas" else "xla")]
    assert got[f"dec1/{name}/{entry}"].shape == want.shape == (2, 4, 1, 16)
    np.testing.assert_allclose(got[f"dec1/{name}/{entry}"], want, rtol=TOL,
                               atol=TOL)


@pytest.mark.parametrize("entry", list(SCALAR_T))
def test_scalar_t_decode_plain_takes_ragged_cache(results, entry):
    """M = 50 is no multiple of a key block: JAX's flash_decode asserts on
    it (flash_decode_vmem takes it), the port takes it in both."""
    got, ref = results
    name = f"M{DEC_RAGGED_M}_t{DEC_RAGGED_T}"
    for against in ("xla", "flash_decode_vmem"):
        np.testing.assert_allclose(got[f"dec1/{name}/{entry}"],
                                   ref[("dec1", name, against)], rtol=TOL,
                                   atol=TOL)


@pytest.mark.parametrize("entry", list(SCALAR_T))
@pytest.mark.parametrize("t", DEC1_BF16_TS)
def test_scalar_t_decode_plain_bf16_matches_xla(results, entry, t):
    got, ref = results
    name = f"M64_t{t}_bf16"
    np.testing.assert_allclose(got[f"dec1/{name}/{entry}"],
                               ref[("dec1", name, "xla")], rtol=0,
                               atol=BF16_TOL)


def _whole_got(got, name, entry):
    key = f"whole/{name}/{entry}"
    return got[key + f"/rows{WHOLE_ROWS[-1]}" if entry.endswith("fold2")
               else key]


@pytest.mark.parametrize("entry", list(WHOLE))
@pytest.mark.parametrize("heads", list(FOLD_HEADS))
@pytest.mark.parametrize("M", WHOLE_MS)
@pytest.mark.parametrize("tname", list(WHOLE_TS))
@pytest.mark.parametrize("against", ["pallas", "xla"])
def test_fold_whole_plain_matches_jax(results, entry, heads, M, tname,
                                      against):
    """flash_decode_fold, _fold2 (rows 4) and _fold3 against the Pallas
    kernel of the same name (interpret mode) and against
    xla_decode_attention_pm; MHA and GQA-2, scalar and per-row t, M 64 and
    M 50 (no block multiple)."""
    got, ref = results
    name = f"{heads}_M{M}_{tname}"
    want = ref[("whole", name, entry if against == "pallas" else "xla")]
    assert _whole_got(got, name, entry).shape == want.shape == (4, 1, 64)
    np.testing.assert_allclose(_whole_got(got, name, entry), want, rtol=TOL,
                               atol=TOL)


@pytest.mark.parametrize("heads", list(FOLD_HEADS))
@pytest.mark.parametrize("M", WHOLE_MS)
def test_fold2_plain_does_not_depend_on_rows(results, heads, M):
    got, _ = results
    for bf in ("", "_bf16"):
        base = f"whole/{heads}_M{M}_rows{bf}/flash_decode_fold2"
        np.testing.assert_array_equal(got[f"{base}/rows{WHOLE_ROWS[0]}"],
                                      got[f"{base}/rows{WHOLE_ROWS[1]}"])


@pytest.mark.parametrize("entry", list(WHOLE))
@pytest.mark.parametrize("heads", list(FOLD_HEADS))
@pytest.mark.parametrize("M", WHOLE_MS)
def test_fold_whole_plain_bf16_matches_xla(results, entry, heads, M):
    """In bf16 fold and fold2 round the probabilities unnormalised and
    fold3 normalised, as their Pallas kernels do; fold3's plain version is
    XLA's arithmetic."""
    got, ref = results
    name = f"{heads}_M{M}_rows_bf16"
    want = ref[("whole", name, "xla")]
    np.testing.assert_allclose(_whole_got(got, name, entry), want, rtol=0,
                               atol=0.0 if entry.endswith("fold3")
                               else BF16_TOL)


@pytest.mark.parametrize("case, says", [
    ("gqa", "MHA caches only"), ("gqa_vmem", "MHA caches only"),
    ("t_rows", "one scalar"), ("rows", "no multiple of rows")])
def test_one_launch_wrappers_refuse_what_jax_cannot_take(results, case, says):
    """As the JAX functions: flash_decode and flash_decode_vmem take MHA
    caches and one scalar t only, flash_decode_fold2 needs B % rows == 0."""
    got, _ = results
    assert str(got[f"refuse/{case}"]).startswith("ValueError")
    assert says in str(got[f"refuse/{case}"])


@pytest.mark.parametrize("active16", list(RESIDENT_16))
def test_cluster_size_takes_16_where_the_card_places_one(results,
                                                        active16):
    """Clusters of 16 where the card can keep one resident at the shape,
    else the portable 8."""
    got, _ = results
    i = list(RESIDENT_16).index(active16)
    assert int(got["plan/sizes"][i]) == RESIDENT_16[active16]


@pytest.mark.parametrize("shape", FFN_PLAN_SHAPES)
def test_ffn_plan_puts_every_ff_column_in_one_slice_in_order(results,
                                                             shape):
    """K2's phase 1: slice i holds the FF columns [16 i, 16 i + 16), so the
    slices together, in order, are 0..FF-1, each column once; D is staged
    in panels of a multiple of 64 that divides it, at most 512; the
    scratch holds a row's h, FF elements."""
    got, _ = results
    D, FF = shape
    key = f"ffnplan/{D}_{FF}"
    slices = got[f"{key}/slices"]
    cols = np.concatenate([np.arange(a, b) for a, b in slices])
    np.testing.assert_array_equal(cols, np.arange(FF))
    assert ((slices[:, 1] - slices[:, 0]) == 16).all()
    panel = int(got[f"{key}/panel"])
    assert panel % 64 == 0 and D % panel == 0 and panel <= 512
    assert panel == max(p for p in range(64, 513, 64) if D % p == 0)
    assert int(got[f"{key}/scratch"]) == FF


def test_ffn_plan_takes_no_rows(results):
    """ffn_plan takes D and FF and nothing else: the slices, the panels and
    every order of the kernel's sums cannot depend on the rows, so a row
    gets the same bits alone and inside a batch."""
    got, _ = results
    assert list(got["ffnplan/params"]) == ["D", "FF"]


@pytest.mark.parametrize("case", list(FFN_REFUSE))
def test_fused_ffn_check_refuses_what_the_kernel_does_not_take(results,
                                                              case):
    got, _ = results
    said = str(got[f"ffncheck/refuse/{case}"])
    assert said.startswith("ValueError"), said
    assert FFN_REFUSE[case][5] in said, said


@pytest.mark.parametrize("case", list(FFN_TAKE))
def test_fused_ffn_check_takes_what_todays_kernel_takes(results, case):
    got, _ = results
    assert str(got[f"ffncheck/take/{case}"]) == "none"


@pytest.mark.parametrize("shape", CLUSTER_LAUNCH_SHAPES)
def test_fold_and_fold2_launch_one_cluster_kernel_alike(results, shape):
    """flash_decode_fold and flash_decode_fold2 are one function with one
    rounding: on CUDA inputs both hand the cluster kernel the same
    arguments, down to the cluster size and the rounding flag, and
    flash_decode_fold3 differs from them in that flag alone."""
    got, _ = results
    i = CLUSTER_LAUNCH_SHAPES.index(shape)
    calls = {name: json.loads(str(got[f"clusterlaunch/{i}/{name}"]))
             for name in ("flash_decode_fold", "flash_decode_fold2",
                          "flash_decode_fold3")}
    for name, c in calls.items():
        assert len(c) == 1, (name, c)
        assert c[0][:2] == ["decode_fold", "eamg_fold_decode_cluster"], name
    fold, fold2, fold3 = (c[0][2] for c in calls.values())
    assert fold == fold2
    B, H, Hkv, M, Dh, _, active16 = shape
    assert fold[4:10] == [B, H, Hkv, M, Dh, H * Dh]
    assert fold[10] == pytest.approx(1 / math.sqrt(Dh), rel=1e-12)
    assert fold[12] == (16 if active16 else 8)
    assert fold[11] == 0 and fold3[11] == 1
    assert fold3[:11] + fold3[12:] == fold[:11] + fold[12:]


def test_cluster_kernel_wrappers_count_under_their_own_names(results):
    """Each wrapper of the cluster kernel counts its launches under its own
    name, so a path that calls flash_decode_fold shows it did."""
    got, _ = results
    n = len(CLUSTER_LAUNCH_SHAPES)
    assert json.loads(str(got["clusterlaunch/counts"])) == {
        "flash_decode_fold": n, "flash_decode_fold2": n,
        "flash_decode_fold3": n}


@pytest.mark.parametrize("case", SPAN_CASES)
def test_scalar_t_key_spans_cover_0_to_t_in_order(results, case):
    """Block rank r of a (row, head)'s cluster takes the keys [start, stop)
    that key_spans gives: disjoint and in rank order, together exactly the
    valid keys 0..min(t, M - 1), none past t, their sizes within one key of
    each other; span_blocks names exactly the 256-key blocks of each span's
    keys, the blocks whose maxima it pushes."""
    got, _ = results
    t, M, C = case
    spans = got[f"spans/{SPAN_CASES.index(case)}"]
    assert spans.shape == (C, 2)
    keys = np.concatenate([np.arange(a, b) for a, b in spans])
    np.testing.assert_array_equal(keys, np.arange(min(t, M - 1) + 1))
    sizes = spans[:, 1] - spans[:, 0]
    assert (sizes >= 0).all() and sizes.max() - sizes.min() <= 1
    assert (spans[1:, 0] == spans[:-1, 1]).all()
    blocks = json.loads(str(got[f"spans/{SPAN_CASES.index(case)}/blocks"]))
    for (a, b), bl in zip(spans, blocks):
        assert bl == sorted({j // 256 for j in range(a, b)})


@pytest.mark.parametrize("case", list(SCALAR_T_SIZES))
def test_scalar_t_cluster_size_follows_m_alone(results, case):
    """Clusters of 2 up to M 1024, 4 up to M 4096; past it 16 where the
    card places one, else 8. B is no argument, so a row gets the same bits
    at any B."""
    got, _ = results
    i = list(SCALAR_T_SIZES).index(case)
    assert int(got["scalartsize/got"][i]) == SCALAR_T_SIZES[case]


@pytest.mark.parametrize("shape", SCALAR_T_LAUNCH_SHAPES)
def test_scalar_t_wrappers_launch_one_cluster_kernel(results, shape):
    """flash_decode and flash_decode_vmem hand the one cluster kernel the
    same arguments, down to t's device pointer (the kernel reads t on the
    card, as the TPU kernel reads it from scalar memory) and the cluster
    size, and differ in the rounding flag alone (1: the running max of
    256-key blocks)."""
    got, _ = results
    i = SCALAR_T_LAUNCH_SHAPES.index(shape)
    calls = {name: json.loads(str(got[f"scalartlaunch/{i}/{name}"]))
             for name in ("flash_decode", "flash_decode_vmem")}
    for name, c in calls.items():
        assert len(c) == 1, (name, c)
        assert c[0][:2] == ["decode_attention",
                            "eamg_flash_decode_scalar_t"], name
    blocked, whole = (c[0][2] for c in calls.values())
    B, H, M, Dh, _, t, active16 = shape
    assert blocked[4:8] == [B * H, M, Dh,
                            int(got[f"scalartlaunch/{i}/tptr"])]
    assert blocked[8] == pytest.approx(1 / math.sqrt(Dh), rel=1e-12)
    assert blocked[10] == (2 if M <= 1024 else 4 if M <= 4096
                           else 16 if active16 else 8)
    assert blocked[9] == 1 and whole[9] == 0
    # all but the output (each call's own) and the rounding flag
    assert whole[:3] + whole[4:9] + whole[10:] \
        == blocked[:3] + blocked[4:9] + blocked[10:]


@pytest.mark.parametrize("shape", SCALAR_T_LAUNCH_SHAPES)
@pytest.mark.parametrize("name", ["flash_decode", "flash_decode_vmem"])
def test_scalar_t_wrappers_refuse_a_host_t_on_the_card(results, shape,
                                                       name):
    """On the card t must already be a device tensor: a Python int would
    cost a host copy a call, which no CUDA graph can hold. The wrapper says
    so before any launch (the launch counts hold one launch a call)."""
    got, _ = results
    i = SCALAR_T_LAUNCH_SHAPES.index(shape)
    said = str(got[f"scalartlaunch/{i}/{name}/host_t"])
    assert said.startswith("ValueError") and "int32 tensor" in said, said


def test_scalar_t_wrappers_count_under_their_own_names(results):
    got, _ = results
    n = len(SCALAR_T_LAUNCH_SHAPES)
    assert json.loads(str(got["scalartlaunch/counts"])) == {
        "flash_decode": n, "flash_decode_vmem": n}


@pytest.mark.parametrize("case", ROW_SPAN_CASES)
def test_sp_key_spans_cover_0_to_t_of_each_row(results, case):
    """K3's kernel reads t[b] on the card and spreads that row's keys over
    its cluster: for each row, key_spans(t[b]) gives the C blocks disjoint
    runs in rank order, together exactly 0..min(t[b], M - 1), within one
    key of each other; span_blocks names the 128-key blocks of each run."""
    got, _ = results
    ts, M, C = case
    i = ROW_SPAN_CASES.index(case)
    for b, t in enumerate(ts):
        spans = got[f"rowspans/{i}/{b}"]
        assert spans.shape == (C, 2)
        keys = np.concatenate([np.arange(a, z) for a, z in spans])
        np.testing.assert_array_equal(keys, np.arange(min(t, M - 1) + 1))
        sizes = spans[:, 1] - spans[:, 0]
        assert sizes.max() - sizes.min() <= 1
        blocks = json.loads(str(got[f"rowspans/{i}/{b}/blocks"]))
        for (a, z), bl in zip(spans, blocks):
            assert bl == sorted({j // 128 for j in range(a, z)})


@pytest.mark.parametrize("case", list(SP_SIZES))
def test_sp_cluster_size_follows_m_and_g_alone(results, case):
    """K3's cluster size over spans: MHA as rows 5 and 6 (2 up to M 1024,
    4 up to 4096); a group of g > 1 heads 8 up to M 1024; past these 16
    where the card places one, else 8. Neither B nor t is an argument, so a
    row gets the same bits at any B."""
    got, _ = results
    i = list(SP_SIZES).index(case)
    assert int(got["spsize/got"][i]) == SP_SIZES[case]


@pytest.mark.parametrize("case", CARD_TAKES)
def test_card_wrappers_launch_once_with_their_arguments(results, case):
    """On CUDA inputs K3 makes exactly one launch a call (no second launch
    merges partials), with t [B] passed as a device pointer (the inputs are
    meta tensors: no value reaches the host) and the plan of sp_plan; K1
    one launch with 4 warps a block (attention.WARPS). Both take Dh 48."""
    got, _ = results
    i = CARD_CASES.index(case)
    assert str(got[f"cardlaunch/{i}/raised"]) == "none"
    calls = json.loads(str(got[f"cardlaunch/{i}"]))
    ptrs = json.loads(str(got[f"cardlaunch/{i}/ptrs"]))
    kind, B, H, Hkv, L, Dh, dt, active16 = case
    assert len(calls) == 1, calls
    lib, fn, args = calls[0]
    assert args[:3] == [ptrs["q"], ptrs["k"], ptrs["v"]]
    if kind == "sp":
        assert [lib, fn] == ["decode_attention", "eamg_flash_decode_sp"]
        assert args[3] == ptrs["lens"]
        assert args[5:10] == [B, H, Hkv, L, Dh]
        assert args[10] == pytest.approx(1 / math.sqrt(Dh), rel=1e-12)
        assert tuple(args[11:13]) == SP_PLANS[i]
        assert args[13] == (0 if dt == "float32" else 1)
    else:
        assert [lib, fn] == ["attention", "eamg_attention_fwd"]
        assert args[4] == ptrs["lens"]
        assert args[5:11] == [B, H, Hkv, L, Dh, 1]
        assert args[11] == pytest.approx(1 / math.sqrt(Dh), rel=1e-12)
        assert args[12] == 4
        assert args[13] == (0 if dt == "float32" else 1)


@pytest.mark.parametrize("case", CARD_REFUSES)
def test_card_wrappers_refuse_what_their_kernels_do_not_take(results, case):
    """Dh outside (16, 32, 48, 64, 128), and for K3 a group size outside
    (1, 2, 4, 8): a ValueError before any launch."""
    got, _ = results
    i = CARD_CASES.index(case)
    said = str(got[f"cardlaunch/{i}/raised"])
    assert said.startswith("ValueError"), said
    assert json.loads(str(got[f"cardlaunch/{i}"])) == []


def test_card_wrappers_count_one_launch_a_call(results):
    got, _ = results
    kinds = [c[0] for c in CARD_TAKES]
    assert json.loads(str(got["cardlaunch/counts"])) == {
        "flash_decode_sp": kinds.count("sp"),
        "flash_attention": kinds.count("attn")}


@pytest.mark.parametrize("case", list(SP_PLAN_CASES))
def test_sp_plan_follows_m_dh_g_and_dtype_alone(results, case):
    """K3 by head (a cluster of g blocks, one a query head, every key and
    value multicast to all) where g > 1 and a block holds the KV head's
    keys and values; else over spans of the keys. No argument is B or t."""
    got, _ = results
    i = list(SP_PLAN_CASES).index(case)
    assert tuple(int(x) for x in got["spplan/got"][i]) == SP_PLAN_CASES[case]


def _fold_sp_calls(got, case):
    i = FOLD_SP_CASES.index(case)
    return (json.loads(str(got[f"foldsp/{i}"])),
            json.loads(str(got[f"foldsp/{i}/ptrs"])), i)


@pytest.mark.parametrize("case", FOLD_SP_TAKES)
def test_fold_sp_wrappers_hand_the_library_the_same_arguments(results, case):
    """flash_decode_fold_sp and flash_decode_fold3_sp are one function with
    one rounding: on CUDA inputs each call is one launch of the fused-layout
    kernel (no scratch, no second launch), and the two hand it the same
    arguments: q's and kv's pointers, q's row stride (the head of the fused
    QKV projection), key blocks of 128 (the TPU kernels' rounding), the
    plan; a [B] int32 t goes by its own pointer (read on the card)."""
    got, _ = results
    calls, ptrs, i = _fold_sp_calls(got, case)
    assert str(got[f"foldsp/{i}/raised"]) == "none"
    B, H, Hkv, M, Dh, dt, _ = case
    by_label = {}
    for label, lib, fn, args in calls:
        assert [lib, fn] == ["decode_fold", "eamg_fold_decode_sp"]
        assert label not in by_label, f"two launches for {label}"
        by_label[label] = args
    assert len(by_label) == 2 * 2 * 4
    for label, args in by_label.items():
        b = int(label.split("/")[0][1:])
        assert args[:2] == [ptrs[label]["q"], ptrs[label]["kv"]]
        if "/rows/" in label:
            assert args[2] == ptrs[label]["t"]
        assert args[4:10] == [b, H, Hkv, M, Dh, H * Dh + 2 * Hkv * Dh]
        assert args[10] == pytest.approx(1 / math.sqrt(Dh), rel=1e-12)
        assert args[11] == 128
        assert args[14] == (0 if dt == "float32" else 1)
        other = by_label[label.replace("fold_sp", "fold3_sp")
                         if "fold_sp" in label
                         else label.replace("fold3_sp", "fold_sp")]
        assert args[:2] + args[4:] == other[:2] + other[4:]


@pytest.mark.parametrize("case", FOLD_SP_TAKES)
def test_fold_sp_plan_follows_m_dh_g_and_dtype_alone(results, case):
    """K3's plan (by head, or over spans with C blocks), the same at B and
    at B 1 and for every t, so a row gets the same bits alone and inside
    any batch: the engine's same-seed contract rests on it."""
    got, _ = results
    calls, _, i = _fold_sp_calls(got, case)
    plans = {tuple(args[12:14]) for _, _, _, args in calls}
    assert plans == {FOLD_SP_PLANS[i]}


@pytest.mark.parametrize("case", FOLD_SP_TAKES)
def test_fold_sp_wrappers_refuse_a_host_t_on_the_card(results, case):
    """A Python int t on CUDA inputs is refused before any launch: the
    kernel reads t on the card, and a copy of a host value a call is what
    a CUDA graph of the decode step cannot hold."""
    got, _ = results
    i = FOLD_SP_CASES.index(case)
    said = str(got[f"foldsp/{i}/host_t"])
    assert said.startswith("ValueError") and "int32 tensor" in said, said


def test_fold_sp_check_refuses_dh40(results):
    """Dh outside (16, 32, 48, 64, 128): a ValueError before any launch."""
    got, _ = results
    calls, _, i = _fold_sp_calls(got, FOLD_SP_CASES[5])
    said = str(got[f"foldsp/{i}/raised"])
    assert said.startswith("ValueError") and "Dh in" in said, said
    assert calls == []


def test_fold_sp_wrappers_count_under_their_own_names(results):
    got, _ = results
    n = len(FOLD_SP_TAKES) * 2 * 4
    assert json.loads(str(got["foldsp/counts"])) == {
        "flash_decode_fold_sp": n, "flash_decode_fold3_sp": n}
