"""Medusa rows in the port's continuous engine against the JAX package, on
the CPU: the cases of JAX's tests/test_continuous_medusa.py, each port
engine row held to JAX's solo decode of the same request (which JAX's
own test holds its engine rows to), and the ragged verify step.

Same inputs (numpy, from a seed) and the same weights go through the JAX
package here and through ``eamg_tpu_torch`` in one subprocess
(tests/torch_port_worker.py, task ``engine_medusa``).

Checked, with the tolerance and its reason:
- a Medusa row equals the solo ``generate_medusa`` of its request, JAX's
  and the port's: sampled (two seeds), greedy (and then the plain greedy
  engine's stream too), and with top-p 0.9 on a per-row-sampling engine;
  exact (tokens; the port draws JAX's keys and noise bit for bit);
- mixed traffic: two Medusa and two plain rows at once on four slots,
  each equal to its own solo decode (JAX's ``generate_medusa`` or
  ``generate_kv_ragged``); exact;
- ``submit_stream``'s deltas of a Medusa row equal ``submit()``'s result;
- validation: an engine without heads refuses (``accepts`` False, the
  ValueError of JAX's message); a Medusa row with penalties is refused;
- plain traffic on a Medusa-capable engine runs the plain chunk program
  (no Medusa graph is built) and equals the solo plain decode;
- ``fail_all`` keeps the state's Medusa fields, and a Medusa and a plain
  row serve after an injected failure;
- ``decode/ragged.py::decode_block_ragged`` on a ragged cache of three
  rows (lengths 0, 7, 15, a block of 4, f32): logits, hidden states and
  the written cache within 1e-5 of JAX's (f32 sums in another order); a
  fourth row at length 17 runs past the cache's 20 slots, where the port
  computes what the solo verify computes (its last query sees its own key
  in the solo cache's extra slots, JAX's ragged step drops it): its
  queries inside the cache are held to JAX's, within 1e-5.
"""

from __future__ import annotations

import json

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from eamg_tpu.decode.medusa import generate_medusa, init_medusa_heads
from eamg_tpu.decode.ragged import decode_block_ragged, generate_kv_ragged
from eamg_tpu.models import GPTConfig, init_params

from port_harness import cfg_json, flatten, perturbed_params, run_worker

CFG = GPTConfig(vocab_size=64, seq_len=48, d_model=32, n_head=4, n_layer=2,
                pos_rows=48, causal=True)
GAMMA, MAX_LEN = 3, 24
MIXED = [([1, 2, 3], 11, True), ([4, 5], 22, False),
         ([6, 7, 8, 9], 33, True), ([10], 44, False)]
RAGGED_CFG = GPTConfig(vocab_size=61, seq_len=40, d_model=32, n_head=4,
                       n_layer=2, n_kv_heads=2, causal=True)
RAGGED_M, RAGGED_W = 20, 4
RAGGED_LENGTHS = [0, 7, 15, 17]
RAGGED_TOL = 1e-5


def _heads():
    """Random (non-zero) heads, as JAX's test makes them, so proposals
    accept and reject."""
    h = init_medusa_heads(jax.random.PRNGKey(7), CFG, GAMMA)
    rng = np.random.RandomState(3)
    return {"blocks": [
        {"w": rng.normal(0, 0.05, b["w"].shape).astype(np.float32),
         "b": rng.normal(0, 0.01, b["b"].shape).astype(np.float32)}
        for b in h["blocks"]]}


def _solo_medusa(jp, jh, ids, seed, greedy=False, **kw):
    prompt = np.zeros((1, 16), np.int32)
    prompt[0, :len(ids)] = ids
    buf, pos, _ = generate_medusa(
        jp, jh, jnp.asarray(prompt), jnp.asarray(len(ids), jnp.int32),
        jax.random.PRNGKey(seed), CFG, MAX_LEN, gamma=GAMMA, top_k=50,
        eos_id=-1, pad_id=0, greedy=greedy, **kw)
    return np.asarray(buf)[0, :int(np.asarray(pos))]


def _solo_plain(jp, ids, seed):
    prompt = np.zeros((1, 16), np.int32)
    prompt[0, :len(ids)] = ids
    buf, pos = generate_kv_ragged(
        jp, jnp.asarray(prompt), jnp.asarray([len(ids)], np.int32),
        jax.random.PRNGKey(seed)[None], CFG, MAX_LEN, top_k=50, eos_id=-1,
        pad_id=0)
    return np.asarray(buf)[0, :int(np.asarray(pos)[0])]


def _ragged_case(rng, inp, ref):
    params = perturbed_params(RAGGED_CFG, rng, key=5)
    B = len(RAGGED_LENGTHS)
    shape = (B, RAGGED_CFG.kv_heads, RAGGED_M, RAGGED_CFG.head_dim)
    k = [(0.5 * rng.standard_normal(shape)).astype(np.float32)
         for _ in range(RAGGED_CFG.n_layer)]
    v = [(0.5 * rng.standard_normal(shape)).astype(np.float32)
         for _ in range(RAGGED_CFG.n_layer)]
    block = rng.integers(0, RAGGED_CFG.vocab_size,
                         (B, RAGGED_W)).astype(np.int32)
    lengths = np.asarray(RAGGED_LENGTHS, np.int32)
    cache = {"k": tuple(map(jnp.asarray, k)), "v": tuple(map(jnp.asarray, v)),
             "lengths": jnp.asarray(lengths)}
    logits, h, new = decode_block_ragged(jax.tree.map(jnp.asarray, params),
                                         jnp.asarray(block), cache,
                                         RAGGED_CFG)
    ref["ragged"] = (np.asarray(logits), np.asarray(h),
                     [np.concatenate([
                         np.asarray(a).transpose(0, 2, 1, 3).reshape(
                             B, RAGGED_M, -1),
                         np.asarray(b).transpose(0, 2, 1, 3).reshape(
                             B, RAGGED_M, -1)], axis=2)
                      for a, b in zip(new["k"], new["v"])],
                     np.asarray(new["lengths"]))
    inp.update({"ragged/cfg": cfg_json(RAGGED_CFG), "ragged/block": block,
                "ragged/lengths": lengths})
    inp.update(flatten(params, "ragged/p"))
    inp.update(flatten({"k": k, "v": v}, "ragged/cache"))


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    params = jax.tree.map(np.asarray, init_params(jax.random.PRNGKey(0),
                                                  CFG))
    heads = _heads()
    jp = jax.tree.map(jnp.asarray, params)
    jh = {"blocks": [{k: jnp.asarray(v) for k, v in b.items()}
                     for b in heads["blocks"]]}
    ref = {
        "sampled/11": _solo_medusa(jp, jh, [1, 2, 3], 11),
        "sampled/22": _solo_medusa(jp, jh, [4, 5], 22),
        "greedy": _solo_medusa(jp, jh, [3, 1, 4], 9, greedy=True),
        "top_p": _solo_medusa(jp, jh, [1, 2, 3], 13, top_p=0.9),
        "plain_only": _solo_plain(jp, [1, 2, 3], 11),
    }
    for i, (p, s, m) in enumerate(MIXED):
        ref[f"mixed/{i}"] = _solo_medusa(jp, jh, p, s) if m \
            else _solo_plain(jp, p, s)
    inp = {"model/cfg": cfg_json(CFG), "mixed": np.asarray(json.dumps(MIXED))}
    inp.update(flatten(params, "model/p"))
    inp.update(flatten(heads, "heads"))
    _ragged_case(np.random.default_rng(11), inp, ref)
    got = run_worker("engine_medusa", inp,
                     tmp_path_factory.mktemp("engine_medusa"))
    return got, ref


@pytest.mark.parametrize("seed", (11, 22))
def test_medusa_row_matches_solo_sampled(results, seed):
    got, ref = results
    assert int(got["max_len"]) == MAX_LEN
    np.testing.assert_array_equal(got[f"sampled/{seed}"],
                                  ref[f"sampled/{seed}"])
    np.testing.assert_array_equal(got[f"sampled_solo/{seed}"],
                                  ref[f"sampled/{seed}"])


def test_medusa_row_matches_solo_greedy(results):
    got, ref = results
    np.testing.assert_array_equal(got["greedy"], ref["greedy"])
    np.testing.assert_array_equal(got["greedy_solo"], ref["greedy"])
    # greedy medusa == the greedy plain stream (the acceptance's exactness)
    np.testing.assert_array_equal(got["greedy_plain"], got["greedy"])


@pytest.mark.parametrize("i", range(len(MIXED)))
def test_mixed_traffic_each_row_matches_solo(results, i):
    got, ref = results
    np.testing.assert_array_equal(got[f"mixed/{i}"], ref[f"mixed/{i}"])
    assert int(got["mixed/served"]) == len(MIXED)


def test_medusa_stream_deltas_match_submit(results):
    got, _ = results
    np.testing.assert_array_equal(
        np.concatenate([[2, 4, 6], got["stream/deltas"]]),
        got["stream/whole"])
    assert bool(got["medusa_graph"])


def test_medusa_validation(results):
    got, _ = results
    assert not bool(got["val/plain_accepts"])
    msg = str(got["val/plain_submit"])
    assert msg.startswith("ValueError") and "without medusa heads" in msg
    assert bool(got["val/row_accepts"])
    msg = str(got["val/penalties"])
    assert msg.startswith("ValueError") and "medusa rows reject" in msg


def test_plain_traffic_uses_plain_program(results):
    got, ref = results
    np.testing.assert_array_equal(got["plain_only"], ref["plain_only"])
    assert not bool(got["plain_only_graph"])


def test_medusa_row_with_top_p_matches_solo(results):
    got, ref = results
    np.testing.assert_array_equal(got["top_p"], ref["top_p"])
    np.testing.assert_array_equal(got["top_p_solo"], ref["top_p"])


def test_fail_all_preserves_medusa_state_shape(results):
    got, _ = results
    assert "injected" in str(got["fail/raised"])
    assert json.loads(str(got["fail/fields"])) == ["h_last", "med_on"]
    assert len(got["fail/medusa"]) > 2 and len(got["fail/plain"]) > 2


def test_decode_block_ragged_matches_jax(results):
    got, ref = results
    logits, hidden, kv, lengths = ref["ragged"]
    np.testing.assert_array_equal(got["ragged/lengths"], lengths)
    # queries inside the cache (position t + w < M)
    inside = (np.asarray(RAGGED_LENGTHS)[:, None]
              + np.arange(RAGGED_W)[None]) < RAGGED_M
    assert not inside.all() and inside.sum() > 10
    np.testing.assert_allclose(got["ragged/logits"][inside], logits[inside],
                               atol=RAGGED_TOL, rtol=0)
    np.testing.assert_allclose(got["ragged/hidden"][inside], hidden[inside],
                               atol=RAGGED_TOL, rtol=0)
    for li, want in enumerate(kv):
        np.testing.assert_allclose(got[f"ragged/kv/{li}"], want,
                                   atol=RAGGED_TOL, rtol=0)
