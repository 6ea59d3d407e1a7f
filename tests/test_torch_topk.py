"""K4's fused top-k mask and the stream-reduce probe against the JAX
package on the CPU, and their card wrappers' arguments through a mocked
binder.

On the CPU the wrappers run their plain versions: the top-k mask is held
bit for bit against JAX's ``apply_top_k`` (and against its three ops on
the interpret-mode Pallas threshold), the stream reduce against the
Pallas kernel in interpret mode at shapes the kernel reads element by
element (W 36, no multiple of the 16-byte vector in bf16) and with a
trailing batch row left unread, to 1e-6 (f32 sums in other orders). On
the card, chip_smoke.py holds the kernels against these plain versions.
The torch side runs in one subprocess (tests/torch_port_worker.py).
"""

from __future__ import annotations

import json

import numpy as np
import pytest

import jax.numpy as jnp

from eamg_tpu.decode.sampling import apply_top_k
from eamg_tpu.ops.decode_fold import stream_reduce
from eamg_tpu.ops.topk import kth_value_pallas

from port_harness import run_worker

TOPK_KS = (1, 50, 300)              # V = 300; k = V leaves the logits as
MASK_VALUES = (-1e10, float("-inf"))  # they are, in JAX and in the port
# (B, M, W, rows): W 36 (bf16 reads it element by element), B 5 with rows 2
# (batch row 4 is not read), W 32
STREAM_CASES = {"w36_rows2": (4, 16, 36, 2), "w36_rows4": (4, 16, 36, 4),
                "trailing_w36": (5, 16, 36, 2), "trailing_w32": (5, 16, 32, 2)}
STREAM_TOL = 1e-6
# [label, wrapper, shape, dtype, k or rows] on meta tensors: what each
# wrapper hands the library, or raises before any launch
WRAP_TAKES = (("mask_f32", "top_k_mask", (8, 8892), "float32", 50),
              ("mask_b1", "top_k_mask", (1, 8892), "float32", 1),
              ("mask_kv", "top_k_mask", (2, 8579), "float32", 8579),
              ("sampler_f32", "apply_top_k", (8, 8892), "float32", 50),
              ("kth_f32", "kth_value", (1, 8892), "float32", 50),
              ("kth_long", "kth_value", (2, 65537), "float32", 7),
              ("kth_bf16", "kth_value", (8, 8324), "bfloat16", 50),
              ("mask_bf16", "top_k_mask", (8, 8324), "bfloat16", 50),
              ("stream_a", "stream_reduce", (8, 511, 256), "bfloat16", 4),
              ("stream_a_again", "stream_reduce", (8, 511, 256), "bfloat16",
               4),
              ("stream_b", "stream_reduce", (5, 16, 36), "float32", 2))
WRAP_REFUSES = (("k0", "kth_value", (2, 300), "float32", 0),
                ("k_past_v", "kth_value", (2, 300), "float32", 301),
                ("mask_k0", "top_k_mask", (2, 300), "float32", 0),
                ("mask_k_past_v", "top_k_mask", (2, 300), "float32", 301),
                ("int_logits", "kth_value", (2, 300), "int32", 5),
                ("mask_int_logits", "top_k_mask", (2, 300), "int64", 5),
                ("mask_f64", "top_k_mask", (2, 300), "float64", 5),
                ("v0", "kth_value", (2, 0), "float32", 1),
                ("b0", "top_k_mask", (0, 300), "float32", 1),
                ("rows_3d", "kth_value", (2, 3, 300), "float32", 5),
                ("v_past_max", "kth_value", (1, (1 << 30) + 1), "float32",
                 5),
                ("stream_rows0", "stream_reduce", (8, 16, 32), "float32", 0),
                ("stream_rows_past_b", "stream_reduce", (3, 16, 32),
                 "float32", 4),
                ("stream_f16", "stream_reduce", (8, 16, 32), "float16", 4),
                ("stream_2d", "stream_reduce", (8, 32), "float32", 4),
                ("stream_strided", "stream_reduce", (8, 16, 32), "float32",
                 4))


def _logits(rng):
    """[3, 300] f32: ties at and around the thresholds, +-inf, signed
    zeros, small integers."""
    x = (rng.standard_normal((3, 300)) * 3).astype(np.float32)
    x[:, 10:20] = x[:, 3:4]
    x[0, 40] = np.inf
    x[0, 41:45] = -np.inf
    x[1, :150] = 0.0
    x[1, 150:250] = -0.0
    x[2] = rng.integers(-4, 5, 300).astype(np.float32)
    return x


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    rng = np.random.default_rng(9)
    logits = _logits(rng)
    inp = {"mask/logits": logits, "mask/ks": np.asarray(TOPK_KS),
           "mask/values": np.asarray(MASK_VALUES, np.float64),
           "wrap/cases": np.asarray(json.dumps(WRAP_TAKES + WRAP_REFUSES))}
    ref = {}
    x = jnp.asarray(logits)
    for k in TOPK_KS:
        for i, m in enumerate(MASK_VALUES):
            ref[("sampler", k, i)] = np.asarray(apply_top_k(x, k, m))
            ref[("three_ops", k, i)] = np.asarray(
                x + jnp.where(x >= kth_value_pallas(x, k), 0.0, m))
    for name, (B, M, W, rows) in STREAM_CASES.items():
        kv = rng.standard_normal((B, M, W)).astype(np.float32)
        if B % rows:
            kv[B - B % rows:] = np.nan        # never read
        inp[f"stream/{name}/kv"] = kv
        inp[f"stream/{name}/rows"] = np.asarray(rows)
        ref[("stream", name)] = np.asarray(stream_reduce(
            jnp.asarray(kv), rows=rows, interpret=True))
    got = run_worker("topk", inp, tmp_path_factory.mktemp("topk"))
    return got, ref


def _bits_equal(a, b):
    assert a.dtype == b.dtype == np.float32 and a.shape == b.shape
    np.testing.assert_array_equal(a.view(np.uint32), b.view(np.uint32))


@pytest.mark.parametrize("k", TOPK_KS)
@pytest.mark.parametrize("mask", range(len(MASK_VALUES)))
def test_sampler_top_k_bit_equal_to_jax_apply_top_k(results, k, mask):
    got, ref = results
    _bits_equal(got[f"mask/sampler/k{k}/m{mask}"], ref[("sampler", k, mask)])


@pytest.mark.parametrize("k", TOPK_KS)
@pytest.mark.parametrize("mask", range(len(MASK_VALUES)))
def test_top_k_mask_plain_bit_equal_to_three_ops_on_pallas_threshold(
        results, k, mask):
    """The plain version of K4's fused mask is the sampler's three ops on
    the k-th largest value, as JAX computes them on the threshold of the
    Pallas kernel (interpret mode): -0.0 + 0.0 gives +0.0, so at k = V it
    differs from the logits, which apply_top_k returns as they are."""
    got, ref = results
    _bits_equal(got[f"mask/plain/k{k}/m{mask}"], ref[("three_ops", k, mask)])


@pytest.mark.parametrize("name", list(STREAM_CASES))
def test_stream_reduce_plain_matches_pallas(results, name):
    got, ref = results
    a, b = got[f"stream/{name}"], ref[("stream", name)]
    assert a.shape == b.shape == (1, STREAM_CASES[name][2])
    assert np.isfinite(a).all()
    np.testing.assert_allclose(a, b, rtol=STREAM_TOL, atol=STREAM_TOL)


def _calls(got, label):
    return (json.loads(str(got[f"wrap/{label}"])),
            json.loads(str(got[f"wrap/{label}/ptrs"])),
            json.loads(str(got[f"wrap/{label}/out"])))


@pytest.mark.parametrize("case", WRAP_TAKES, ids=[c[0] for c in WRAP_TAKES])
def test_wrappers_hand_the_library_their_launch(results, case):
    """One launch a call. The top-k mask, and the sampler's top-k:
    eamg_top_k_mask with the logits (bf16 ones as an f32 copy), a [B, V]
    f32 output, B, V, k and mask_value -1e10. kth_value: eamg_kth_value
    (bf16 logits as an f32 copy, the result cast back). The stream reduce:
    the kv, a [1, W] output, its partials and arrival counter, groups,
    lines, W and the dtype code."""
    got, _ = results
    label, name, shape, dt, arg = case
    calls, (x_ptr, o_ptr), out = _calls(got, label)
    assert str(got[f"wrap/{label}/raised"]) == "none"
    assert len(calls) == 1, calls
    lib, fn, args = calls[0]
    if name == "stream_reduce":
        B, M, W = shape
        assert [lib, fn] == ["stream_reduce", "eamg_stream_reduce"]
        assert args[0] == x_ptr and args[1] == o_ptr
        assert args[4:9] == [B // arg, arg * M, W,
                             0 if dt == "float32" else 1, 0]
        assert out == [[1, W], f"torch.{dt}"]
        return
    B, V = shape
    assert lib == "topk" and args[2:5] == [B, V, arg]
    assert (args[0] == x_ptr) == (dt == "float32")
    if name in ("top_k_mask", "apply_top_k"):
        assert fn == "eamg_top_k_mask" and args[1] == o_ptr
        assert args[5] == pytest.approx(-1e10) and args[6:] == [0]
        assert out == [[B, V], "torch.float32"]
    else:
        assert fn == "eamg_kth_value" and args[5:] == [0]
        assert out == [[B, 1], f"torch.{dt}"]


def test_stream_reduce_keeps_its_scratch_per_shape(results):
    """The partials and the arrival counter are allocated once per shape:
    two calls of one shape hand the kernel the same two buffers, another
    shape other ones."""
    got, _ = results
    a, b, c = (_calls(got, n)[0][0][2] for n in ("stream_a", "stream_a_again",
                                                 "stream_b"))
    assert a[2:4] == b[2:4]
    assert a[2] != c[2] and a[3] != c[3]


@pytest.mark.parametrize("case", WRAP_REFUSES,
                         ids=[c[0] for c in WRAP_REFUSES])
def test_wrappers_refuse_what_their_kernels_do_not_take(results, case):
    """k outside 1..V, logits that are no float (for the top-k mask, no
    f32, bf16 or f16), V 0 or past 2^30, no [B, V] logits; rows 0 or past
    B, a dtype other than f32 and bf16, no [B, M, W] or a strided kv: a
    ValueError before any launch."""
    got, _ = results
    label = case[0]
    said = str(got[f"wrap/{label}/raised"])
    assert said.startswith("ValueError"), said
    assert _calls(got, label)[0] == []


def test_wrappers_count_under_their_own_names(results):
    """K4's entry points count under their own names, the sampler's top-k
    under the fused mask's, the stream reduce once a call."""
    got, _ = results
    names = [c[1] for c in WRAP_TAKES]
    assert json.loads(str(got["wrap/counts"])) == {
        "top_k_mask": names.count("top_k_mask") + names.count("apply_top_k"),
        "kth_value": names.count("kth_value"),
        "stream_reduce": names.count("stream_reduce")}
