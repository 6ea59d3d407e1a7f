"""The port's ragged decode against the JAX package, in f32 on the CPU.

Same inputs (numpy, from a seed) and the same weights go through
``eamg_tpu.decode.ragged`` here and through ``eamg_tpu_torch.decode.ragged``
in one subprocess (tests/torch_port_worker.py). On the CPU the port's fold
decode attention and prefill attention run their plain versions.

Checked, with the tolerance and its reason:
- ``prefill_ragged`` and teacher-forced ``decode_step_ragged`` logits to
  1e-4 (f32 sums in other orders, over two layers), GQA and MHA; the
  port's position-major fused cache against the JAX head-major cache
  carried over by ``ragged_cache_from_jax`` to 1e-5, and back through
  ``ragged_cache_to_jax``;
- ``generate_kv_ragged`` token buffers and lengths equal: greedy, seeded
  with per-row keys, a single key fanned out with ``fold_in``, a row whose
  prompt fills the buffer, top-p and min-p on;
- row-batched key splits, key chains, ``fold_in`` and random bits bit-equal
  to ``jax.vmap`` of ``jax.random``; ``sample_rows`` tokens equal to the
  JAX engine's vmapped ``sample_token`` with per-row temperature, top-p and
  min-p.
"""

from __future__ import annotations

import json

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from eamg_tpu.decode.ragged import (decode_step_ragged, generate_kv_ragged,
                                    init_ragged_cache, prefill_ragged)
from eamg_tpu.models.gpt import GPTConfig
from eamg_tpu.serve.continuous import _sample_rows

from port_harness import cfg_json, flatten, perturbed_params, run_worker

V = 300
CFGS = {
    "gqa": GPTConfig(vocab_size=V, seq_len=64, d_model=64, n_head=4,
                     n_layer=2, n_kv_heads=2, causal=True),
    "mha": GPTConfig(vocab_size=V, seq_len=64, d_model=64, n_head=4,
                     n_layer=2, causal=True),
}
MAX_LEN = 40
LENS = [5, 16, 9]            # prompt lengths in a bucket of 16
EOS = 7
# name: (cfg, prompt width, prompt lengths, max_len, keys, options)
GEN_CASES = {
    "gqa_greedy": ("gqa", 16, LENS, MAX_LEN, "rows", dict(greedy=True)),
    "gqa_seeded": ("gqa", 16, LENS, MAX_LEN, "rows",
                   dict(temperature=0.9, top_k=20)),
    "gqa_seeded_b": ("gqa", 16, [3, 12, 16], MAX_LEN, "rows_b",
                     dict(temperature=0.9, top_k=20)),
    "gqa_fold_in": ("gqa", 16, LENS, MAX_LEN, "single",
                    dict(temperature=0.9, top_k=20)),
    "gqa_full_row": ("gqa", 32, [32, 6, 31], 32, "rows",
                     dict(temperature=0.9, top_k=20)),
    "gqa_filters": ("gqa", 16, LENS, MAX_LEN, "rows",
                    dict(temperature=0.8, top_k=30, top_p=0.9, min_p=0.05)),
    "mha_greedy": ("mha", 16, LENS, MAX_LEN, "rows", dict(greedy=True)),
    "mha_seeded": ("mha", 16, LENS, MAX_LEN, "rows",
                   dict(temperature=1.0, top_k=50)),
}
KEYSETS = {"rows": [11, 22, 33], "rows_b": [5, 2**31 - 1, 77], "single": 9}
PRNG_SEEDS = [0, 1, 42, 2**31 - 1, 2**32 + 5]


def _keys(kind):
    seeds = KEYSETS[kind]
    if isinstance(seeds, int):
        return jax.random.PRNGKey(seeds)
    return jax.vmap(jax.random.PRNGKey)(jnp.asarray(seeds, jnp.uint32))


def _np_cache(cache):
    return {"k": [np.asarray(a) for a in cache["k"]],
            "v": [np.asarray(a) for a in cache["v"]],
            "lengths": np.asarray(cache["lengths"])}


def _model_case(tag, cfg, params, rng, inp, ref):
    jp = jax.tree.map(jnp.asarray, params)
    ids = rng.integers(8, V, (3, 16)).astype(np.int32)
    lens = np.asarray(LENS, np.int32)
    forced = rng.integers(8, V, (3, 3)).astype(np.int32)     # [step, row]
    inp.update({f"{tag}/ids": ids, f"{tag}/lens": lens,
                f"{tag}/forced": forced, f"{tag}/max_len": np.asarray(MAX_LEN)})
    cache = init_ragged_cache(cfg, 3, MAX_LEN)
    logits, cache = jax.jit(prefill_ragged, static_argnums=(3,))(
        jp, jnp.asarray(ids), jnp.asarray(lens), cfg, cache)
    ref[f"{tag}/prefill"] = np.asarray(logits)
    inp.update(flatten(_np_cache(cache), f"{tag}/jax_cache0"))
    step = jax.jit(decode_step_ragged, static_argnums=(3,))
    last = jnp.asarray(ids[np.arange(3), lens - 1])
    steps = []
    for row in forced:
        lg, cache = step(jp, last, cache, cfg)
        steps.append(np.asarray(lg))
        last = jnp.asarray(row)
    ref[f"{tag}/decode"] = np.stack(steps)
    ref[f"{tag}/cache1"] = _np_cache(cache)
    inp.update(flatten(_np_cache(cache), f"{tag}/jax_cache1"))


def _gen_case(name, params_by_cfg, rng, inp, ref):
    tag, width, lens, max_len, keys, opts = GEN_CASES[name]
    prompt = rng.integers(8, V, (len(lens), width)).astype(np.int32)
    inp.update({f"gen/{name}/prompt": prompt,
                f"gen/{name}/lens": np.asarray(lens, np.int32),
                f"gen/{name}/keys": np.asarray(KEYSETS[keys]),
                f"gen/{name}/spec": np.asarray(json.dumps(
                    {"cfg": tag, "max_len": max_len, "eos": EOS, **opts}))})
    buf, n = generate_kv_ragged(
        params_by_cfg[tag], jnp.asarray(prompt),
        jnp.asarray(lens, jnp.int32), _keys(keys), CFGS[tag], max_len,
        eos_id=EOS, **opts)
    ref[f"gen/{name}/buf"] = np.asarray(buf)
    ref[f"gen/{name}/lengths"] = np.asarray(n)


def _prng_case(rng, inp, ref):
    keys = jax.vmap(jax.random.PRNGKey)(jnp.asarray(
        [s % 2**32 for s in PRNG_SEEDS], jnp.uint32))
    inp["prng/seeds"] = np.asarray(PRNG_SEEDS, np.int64)
    ref["prng/key_rows"] = np.asarray(keys)
    split = jax.vmap(lambda k: jax.random.split(k))
    two = np.asarray(split(keys))
    ref["prng/split_next"], ref["prng/split_sub"] = two[:, 0], two[:, 1]
    k, subs = keys, []
    for _ in range(5):
        kk = split(k)
        k = kk[:, 0]
        subs.append(np.asarray(kk[:, 1]))
    ref["prng/chain_keys"], ref["prng/chain_subs"] = (np.asarray(k),
                                                     np.stack(subs))
    ref["prng/fold_in"] = np.asarray(jax.vmap(
        lambda i: jax.random.fold_in(jax.random.PRNGKey(9), i))(
            jnp.arange(6)))
    ref["prng/bits"] = np.asarray(jax.vmap(
        lambda key: jax.random.bits(key, (1, V), jnp.uint32)[0])(keys))
    # the engine's per-row sampler: per-row key, temperature, top-p, min-p
    logits = (3 * rng.standard_normal((len(PRNG_SEEDS), V))
              ).astype(np.float32)
    temps = np.asarray([1.0, 0.7, 1.3, 0.9, 1.0], np.float32)
    top_ps = np.asarray([1.0, 0.9, 0.5, 1.0, 0.8], np.float32)
    min_ps = np.asarray([0.0, 0.0, 0.05, 0.1, 0.0], np.float32)
    inp.update({"prng/logits": logits, "prng/temps": temps,
                "prng/top_ps": top_ps, "prng/min_ps": min_ps})
    ref["prng/sample_rows"] = np.asarray(_sample_rows(
        keys, jnp.asarray(logits), jnp.asarray(temps), 40, -1e10, False,
        1.0))
    ref["prng/sample_rows_top_p"] = np.asarray(_sample_rows(
        keys, jnp.asarray(logits), jnp.asarray(temps), 40, -1e10, False,
        0.85))
    ref["prng/sample_rows_per_row"] = np.asarray(_sample_rows(
        keys, jnp.asarray(logits), jnp.asarray(temps), 40, -1e10, False,
        1.0, jnp.asarray(top_ps), jnp.asarray(min_ps)))


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    rng = np.random.default_rng(77)
    inp, ref, jparams = {"tags": np.asarray(json.dumps(list(CFGS))),
                         "gen_cases": np.asarray(json.dumps(
                             list(GEN_CASES)))}, {}, {}
    for tag, cfg in CFGS.items():
        params = perturbed_params(cfg, rng)
        jparams[tag] = jax.tree.map(jnp.asarray, params)
        inp.update(flatten(params, f"{tag}/p"))
        inp[f"{tag}/cfg"] = cfg_json(cfg)
        _model_case(tag, cfg, params, rng, inp, ref)
    for name in GEN_CASES:
        _gen_case(name, jparams, rng, inp, ref)
    _prng_case(rng, inp, ref)
    got = run_worker("ragged", inp, tmp_path_factory.mktemp("ragged"))
    return got, ref


@pytest.mark.parametrize("tag", list(CFGS))
@pytest.mark.parametrize("what", ["prefill", "decode"])
def test_ragged_logits_match_jax(results, tag, what):
    got, ref = results
    assert got[f"{tag}/{what}"].shape == ref[f"{tag}/{what}"].shape
    np.testing.assert_allclose(got[f"{tag}/{what}"], ref[f"{tag}/{what}"],
                               rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("tag", list(CFGS))
@pytest.mark.parametrize("when", ["cache0", "cache1"])
def test_fused_cache_matches_jax_cache(results, tag, when):
    """After prefill (cache0) and after three decode steps (cache1): the
    port's cache against the JAX cache carried into the fused layout."""
    got, _ = results
    L = CFGS[tag].n_layer
    for li in range(L):
        a, b = got[f"{tag}/{when}/kv/{li}"], got[f"{tag}/jax_{when}/kv/{li}"]
        assert a.shape == b.shape == (3, MAX_LEN, 2 * CFGS[tag].kv_dim)
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(got[f"{tag}/{when}/lengths"],
                                  got[f"{tag}/jax_{when}/lengths"])


@pytest.mark.parametrize("tag", list(CFGS))
def test_fused_cache_goes_back_to_jax_layout(results, tag):
    got, ref = results
    for li in range(CFGS[tag].n_layer):
        for kind in ("k", "v"):
            np.testing.assert_allclose(got[f"{tag}/back1/{kind}/{li}"],
                                       ref[f"{tag}/cache1"][kind][li],
                                       rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("name", list(GEN_CASES))
def test_generate_kv_ragged_streams_equal(results, name):
    got, ref = results
    np.testing.assert_array_equal(got[f"gen/{name}/lengths"],
                                  ref[f"gen/{name}/lengths"])
    np.testing.assert_array_equal(got[f"gen/{name}/buf"],
                                  ref[f"gen/{name}/buf"])


def test_full_row_keeps_its_last_prompt_token(results):
    """prompt_len == max_len: zero steps, the prompt unchanged."""
    got, _ = results
    assert got["gen/gqa_full_row/lengths"][0] == 32
    np.testing.assert_array_equal(got["gen/gqa_full_row/buf"][0],
                                  got["gen/gqa_full_row/prompt_echo"][0])


@pytest.mark.parametrize("what", ["key_rows", "split_next", "split_sub",
                                  "chain_keys", "chain_subs", "fold_in",
                                  "bits"])
def test_row_batched_threefry_bit_equal(results, what):
    got, ref = results
    a, b = got[f"prng/{what}"], ref[f"prng/{what}"]
    assert a.shape == b.shape
    np.testing.assert_array_equal(a.astype(np.uint32), b.astype(np.uint32))


@pytest.mark.parametrize("what", ["sample_rows", "sample_rows_top_p",
                                  "sample_rows_per_row"])
def test_sample_rows_equal_vmapped_sample_token(results, what):
    got, ref = results
    np.testing.assert_array_equal(got[f"prng/{what}"], ref[f"prng/{what}"])
