"""The port's decode loops as blocks over a device-resident state, against
the JAX package's compiled loops, on the CPU.

On the card ``generate_kv``, ``generate_kv_ragged`` and the engine replay
CUDA graphs of blocks of decode steps (``eamg_tpu_torch/decode/graphs.py``);
on the CPU the same block function runs eagerly, so these tests run the
code the card captures. The JAX side is ``generate_kv`` / ``generate_kv_
ragged`` (one ``while_loop`` each). The torch side runs in one subprocess
(tests/torch_port_worker.py, task ``graphs``). Checked:

- ``generate_kv`` returns JAX's ``(buf, pos)`` exactly, for an EOS id
  picked from JAX's own greedy and sampled streams so that the loop stops
  at step 5, at the last step of a block and at the first step of the
  next (the premise is checked on JAX's side), and for ``max_len`` reached
  inside a block; with ``refeed_last_prompt`` off, ``presplit_keys``,
  penalties, the n-gram ban, top-p and min-p on, one case each; at B 1 and
  3, over the head-major and the fused cache;
- ``generate_kv_ragged`` returns JAX's tokens and lengths, greedy and
  sampled, with a row's EOS at the last step of a block and at the first
  step of the next, and with rows that reach ``max_len`` inside a block;
- a second request on a cached state (its graph's key) gives the same
  result as the first, and states are keyed by what JAX's ``jit`` keys
  on: a new temperature, seed, prompt length or top-p value reuses one,
  turning top-p on makes another;
- ``decode_step`` with the cache length on the device matches JAX's
  teacher-forced decode logits (1e-4, f32 sums in other orders) over
  both cache layouts, and advances the length in place;
- the graph runner's launch bookkeeping, with CUDA's graph calls stood in
  for: the warm-up counts for real, the capture's wrapper calls go into
  the block's launches (not the counts), each replay adds them once, and
  another thread's launches during the capture count for real.
"""

from __future__ import annotations

import json

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from eamg_tpu.decode.loop import generate_kv
from eamg_tpu.decode.ragged import generate_kv_ragged
from eamg_tpu.models.gpt import (GPTConfig, decode_step, init_kv_cache,
                                 prefill)

from port_harness import cfg_json, flatten, perturbed_params, run_worker

CFG = GPTConfig(vocab_size=97, seq_len=80, d_model=32, n_head=4, n_layer=2,
                n_kv_heads=2, causal=True)
BLOCK = 32          # eamg_tpu_torch/decode/graphs.py::BLOCK
PLEN, MAX_LEN = 5, 75     # 70 steps from position 5: blocks 32, 32, 6
TOP_K = 20
# the decode step the loop must stop at (0-based from the first step)
TARGETS = {"step5": 5, "block_last": BLOCK - 1, "block_first": BLOCK}
SAMPLED = {"top_k": TOP_K}
GREEDY = {"top_k": TOP_K, "greedy": True}


def _jax_kv(jp, prompt, seed, max_len=MAX_LEN, **kw):
    if "penalties" in kw:
        kw["penalties"] = tuple(kw["penalties"])
    buf, n = generate_kv(jp, jnp.asarray(prompt), PLEN,
                         jax.random.PRNGKey(seed), CFG, max_len, **kw)
    return np.asarray(buf), int(n)


def _first_new(row, step):
    """Whether row[step] occurs at no earlier step (so as an EOS id it
    stops the row exactly there)."""
    return row[step] not in row[:step]


def _pick(jp, rng, kw, target):
    """(prompt, seed, eos) whose stream (JAX, eos off) first meets ``eos``
    at decode step ``target``: prompts and seeds drawn until one does."""
    for _ in range(200):
        prompt = np.zeros((1, 16), np.int32)
        prompt[0, :PLEN] = rng.integers(1, CFG.vocab_size, PLEN)
        seed = int(rng.integers(0, 1 << 20))
        buf, _ = _jax_kv(jp, prompt, seed, **kw)
        steps = buf[0, PLEN:]
        if _first_new(steps, target):
            return prompt, seed, int(steps[target])
    raise AssertionError(f"no stream meets a new token at step {target}")


def _cases(jp, rng):
    """name -> (spec for the worker, JAX's (buf, n))."""
    cases, ref = {}, {}

    def add(name, prompt, seed, B=1, impl="sp", **kw):
        prompt = np.repeat(prompt, B, axis=0)
        cases[name] = {"prompt": prompt.tolist(), "seed": seed,
                       "impl": impl, "kw": kw}
        ref[name] = _jax_kv(jp, prompt, seed, **kw)

    picks = {}
    for mode, kw in (("greedy", GREEDY), ("sampled", SAMPLED)):
        for where, step in TARGETS.items():
            prompt, seed, eos = _pick(jp, rng, kw, step)
            picks[mode, where] = (prompt, seed, eos)
            for impl in ("sp", "fold_sp"):
                add(f"{mode}/{where}/{impl}", prompt, seed, impl=impl,
                    eos_id=eos, **kw)
    prompt, seed, eos = picks["sampled", "block_last"]
    add("sampled/no_eos", prompt, seed, **SAMPLED)
    stream = _jax_kv(jp, prompt, seed, **SAMPLED)[0][0, PLEN:]
    add("sampled/eos_never_met", prompt, seed, eos_id=next(
        v for v in range(CFG.vocab_size) if v not in stream), **SAMPLED)
    add("sampled/norefeed", prompt, seed, eos_id=eos,
        refeed_last_prompt=False, **SAMPLED)
    add("sampled/presplit", prompt, seed, eos_id=eos, presplit_keys=True,
        **SAMPLED)
    add("sampled/penalties", prompt, seed, eos_id=eos,
        penalties=[1.3, 0.2, 0.1], **SAMPLED)
    add("sampled/ngram", prompt, seed, eos_id=eos, no_repeat_ngram=2,
        **SAMPLED)
    add("sampled/top_p", prompt, seed, eos_id=eos, top_p=0.8, **SAMPLED)
    add("sampled/min_p", prompt, seed, eos_id=eos, min_p=0.05, **SAMPLED)
    add("sampled/B3", prompt, seed, B=3, eos_id=eos, **SAMPLED)
    prompt, seed, eos = picks["greedy", "block_first"]
    add("greedy/B3", prompt, seed, B=3, impl="fold_sp", eos_id=eos, **GREEDY)
    return cases, ref, picks


RAGGED_LENS = [3, 6, 1]
RAGGED_MAX = 60


def _ragged_cases(jp, rng):
    """name -> spec, JAX's (tokens, lengths): greedy and sampled, with
    row 0's EOS first met at the last step of a block and at the first
    step of the next (when its stream has such a token), and with no EOS
    (every row reaches max_len inside a block)."""
    cases, ref = {}, {}
    prompt = np.zeros((3, 16), np.int32)
    prompt[:, :6] = rng.integers(1, CFG.vocab_size, (3, 6))
    seeds = [11, 12, 13]
    for mode, greedy in (("greedy", True), ("sampled", False)):
        def run(eos):
            buf, n = generate_kv_ragged(
                jp, jnp.asarray(prompt), jnp.asarray(RAGGED_LENS),
                jax.vmap(jax.random.PRNGKey)(jnp.asarray(seeds)), CFG,
                RAGGED_MAX, top_k=TOP_K, greedy=greedy, eos_id=eos)
            return np.asarray(buf), np.asarray(n)

        free, _ = run(-1)
        cases[f"{mode}/no_eos"] = {"greedy": greedy, "eos_id": -1}
        ref[f"{mode}/no_eos"] = (free, run(-1)[1])
        row0 = free[0, RAGGED_LENS[0]:]
        for where, step in (("block_last", BLOCK - 1), ("block_first", BLOCK)):
            hits = [s for s in range(step, len(row0)) if _first_new(row0, s)]
            eos = int(row0[hits[0]]) if hits else int(row0[step])
            cases[f"{mode}/{where}"] = {"greedy": greedy, "eos_id": eos}
            ref[f"{mode}/{where}"] = run(eos)
    return cases, ref, {"prompt": prompt.tolist(), "seeds": seeds}


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    rng = np.random.default_rng(1010)
    params = perturbed_params(CFG, rng, key=10)
    jp = jax.tree.map(jnp.asarray, params)
    cases, ref, picks = _cases(jp, rng)
    rcases, rref, rinp = _ragged_cases(jp, rng)
    # teacher-forced decode logits, JAX's head-major cache
    prompt = np.zeros((2, 16), np.int32)
    prompt[:, :PLEN] = rng.integers(1, CFG.vocab_size, (2, PLEN))
    forced = rng.integers(0, CFG.vocab_size, (6, 2)).astype(np.int32)
    cache = init_kv_cache(CFG, 2, 40)
    _, cache = jax.jit(prefill, static_argnums=(2,))(jp, jnp.asarray(prompt),
                                                     CFG, cache, PLEN)
    step = jax.jit(decode_step, static_argnums=(3,))
    last, logits = jnp.asarray(prompt)[:, PLEN - 1:PLEN], []
    for row in forced:
        lg, cache = step(jp, last, cache, CFG)
        logits.append(np.asarray(lg))
        last = jnp.asarray(row)[:, None]
    ref["tf/logits"] = np.stack(logits)
    inp = {**flatten(params, "p"), "cfg": cfg_json(CFG),
           "cases": np.asarray(json.dumps(cases)),
           "ragged": np.asarray(json.dumps({**rinp, "lens": RAGGED_LENS,
                                            "max_len": RAGGED_MAX,
                                            "top_k": TOP_K,
                                            "cases": rcases})),
           "plen": np.asarray(PLEN), "max_len": np.asarray(MAX_LEN),
           "tf/prompt": prompt, "tf/forced": forced}
    got = run_worker("graphs", inp, tmp_path_factory.mktemp("graphs"),
                     timeout=600)
    return got, ref, rref, picks


SOLO_CASES = ([f"{m}/{w}/{i}" for m in ("greedy", "sampled")
               for w in TARGETS for i in ("sp", "fold_sp")]
              + [f"sampled/{c}" for c in ("no_eos", "eos_never_met",
                                          "norefeed", "presplit",
                                          "penalties", "ngram", "top_p",
                                          "min_p", "B3")]
              + ["greedy/B3"])


@pytest.mark.parametrize("name", SOLO_CASES)
def test_generate_kv_returns_jax_buf_and_pos(results, name):
    got, ref, _, _ = results
    buf, n = ref[name]
    assert int(got[f"solo/{name}/n"]) == n
    np.testing.assert_array_equal(got[f"solo/{name}/buf"], buf[:, :n])
    # the rest of JAX's buffer is pad; the port returns the whole buffer
    np.testing.assert_array_equal(got[f"solo/{name}/tail"], buf[:, n:])


@pytest.mark.parametrize("mode", ["greedy", "sampled"])
@pytest.mark.parametrize("where", list(TARGETS))
def test_eos_cases_stop_where_they_aim(results, mode, where):
    """The premise of the EOS cases: JAX's loop stops right after the
    targeted step, inside a block, at its last step, or at the first step
    of the next block."""
    _, ref, _, _ = results
    _, n = ref[f"{mode}/{where}/sp"]
    assert n == PLEN + TARGETS[where] + 1


def test_max_len_inside_a_block(results):
    _, ref, _, _ = results
    assert (MAX_LEN - PLEN) % BLOCK != 0
    assert ref["sampled/no_eos"][1] == MAX_LEN
    assert ref["sampled/eos_never_met"][1] == MAX_LEN


RAGGED_CASES = [f"{m}/{w}" for m in ("greedy", "sampled")
                for w in ("no_eos", "block_last", "block_first")]


@pytest.mark.parametrize("name", RAGGED_CASES)
def test_generate_kv_ragged_returns_jax_tokens_and_lengths(results, name):
    got, _, rref, _ = results
    buf, n = rref[name]
    np.testing.assert_array_equal(got[f"ragged/{name}/n"], n)
    np.testing.assert_array_equal(got[f"ragged/{name}/buf"], buf)


def test_second_request_on_a_cached_state_is_the_same(results):
    got, _, _, _ = results
    for name in ("sampled/block_first/sp", "greedy/B3"):
        np.testing.assert_array_equal(got[f"again/{name}/buf"],
                                      got[f"solo/{name}/buf"])
    np.testing.assert_array_equal(got["again/ragged/buf"],
                                  got["ragged/sampled/block_last/buf"])


def test_states_are_keyed_as_jax_jit_keys(results):
    """A new temperature, seed, prompt length or top-p value reuses the
    state (one graph); turning top-p on is a new key."""
    got, _, _, _ = results
    assert int(got["keys/same"]) == 0
    assert int(got["keys/top_p_on"]) == 1


@pytest.mark.parametrize("impl", ["sp", "fold_sp"])
def test_decode_step_with_device_length_matches_jax(results, impl):
    got, ref, _, _ = results
    np.testing.assert_allclose(got[f"tf/{impl}/logits"], ref["tf/logits"],
                               rtol=1e-4, atol=1e-4)
    assert str(got[f"tf/{impl}/length"]) == "int32 [1] in place"
    assert int(got[f"tf/{impl}/length_value"]) == PLEN + 6


def test_replays_add_the_captured_launches(results):
    got, _, _, _ = results
    assert json.loads(str(got["book/block_launches"])) == {"k_a": 2,
                                                           "k_b": 1}
    # warm-up once for real, three replays; the other thread's launch in
    # the warm-up and in the capture count for real
    assert json.loads(str(got["book/counts"])) == {"k_a": 8, "k_b": 4,
                                                   "other": 2}
    assert int(got["book/replays"]) == 3
    assert str(got["book/mode"]) == "thread_local"


def test_cpu_runs_the_block_eagerly(results):
    got, _, _, _ = results
    assert json.loads(str(got["book/cpu_counts"])) == {"k_a": 6, "k_b": 3,
                                                       "other": 3}
    assert str(got["book/cpu_graph"]) == "None"
