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
thresholds are exact searches over integer keys, so bit-equal.
"""

from __future__ import annotations

import math

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from eamg_tpu.ops.attention import flash_attention, xla_attention
from eamg_tpu.ops.decode_attention import (flash_decode_sp,
                                           xla_decode_attention)
from eamg_tpu.ops.decode_fold import (flash_decode_fold3_sp,
                                      flash_decode_fold_sp, stream_reduce,
                                      xla_decode_attention_pm)
from eamg_tpu.ops.ffn import fused_ffn
from eamg_tpu.ops.topk import (kth_value_bitsearch, kth_value_pallas,
                               top_p_threshold_bitsearch)

from port_harness import flatten, run_worker

TOL = 1e-5

# name: (B, H, Hkv, T, Dh, causal, valid_len)
ATTN_CASES = {
    "mha_causal": (2, 4, 4, 24, 16, True, None),
    "gqa_causal_valid": (2, 4, 2, 24, 16, True, 17),
    "gqa_bidir_valid": (1, 8, 2, 20, 32, False, 13),
}
# name: (rows shape, D, FF, activation)
FFN_CASES = {"relu": ((2, 5), 64, 256, "relu"),
             "gelu": ((7,), 64, 128, "gelu")}
DEC_TS = (0, 5, 17, 63)            # M 64 = 4 blocks of 16
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
STREAM_ROWS = (2, 4)               # kv [4, 16, 32]


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
