"""The port's continuous-batching engine and window batcher against the JAX
package, in f32 on the CPU.

Same weights and requests go through ``eamg_tpu.serve.continuous`` here and
through ``eamg_tpu_torch.serve.continuous`` / ``serve.batcher`` in one
subprocess (tests/torch_port_worker.py).

Checked:
- ``admit_row`` + ``ragged_chunk``: the engine state after each call of a
  sequence (a row admitted into slot 1, a chunk, a second row admitted
  mid-decode, a row whose prompt fills its budget, two more chunks): buf,
  pos, last, done, lengths, row_max and the host key rows equal, the cache
  (through ``ragged_cache_from_jax``) to 1e-5;
- ``ContinuousBatcher`` rows token-equal to the port's solo
  ``generate_kv_ragged`` and to the JAX engine's rows for the same seeds,
  under staggered admission, more requests than slots, a chunk size that
  splits every row's life, per-row temperature, and in per-row sampling
  mode (top-p and min-p per request; a neutral row equals the default
  engine's);
- ``run_detached`` equal to the engine row, including a budget of 7 chunks
  with an early EOS, where the midpoint check stops the decode;
- ``EngineOverloaded`` at a full queue; a timed-out request is cancelled
  and its slot freed; ``_fail_all`` leaves a serving engine; window-batcher
  rows equal their solo streams;
- the row options of an engine built with per-row sampling, an n-gram ban
  of size 2 and a grammar: ``admit_row`` + ``ragged_chunk`` state after
  each call (the keys above and counts, rep_ps/freq_ps/pres_ps, ngram_on,
  gstate, gram_on; a reused slot keeps nothing of its last row), its rows
  with penalties, an n-gram ban, a grammar and all of them token-equal to
  the JAX engine's, a plain row equal to the default engine's (and its
  detached decode too); the window batcher with penalties, n-gram bans
  and its grammar groups equal requests and gives the JAX engine's rows.

Streams are compared as tokens. A CPU matrix product need not give a row of
a 3-row product the bits of the 1-row product, so a seeded stream could in
principle flip on a near tie between batch shapes; the seeds below do not.
"""

from __future__ import annotations

import json
import threading
import time

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from eamg_tpu.decode import Generator
from eamg_tpu.decode.ragged import generate_kv_ragged
from eamg_tpu.models.gpt import GPTConfig
from eamg_tpu.serve.continuous import (ContinuousBatcher, admit_row,
                                       init_state, ragged_chunk)
from eamg_tpu.tokenizer import Vocab

from eamg_tpu.decode.grammar import grammar_a

from port_harness import (cfg_json, flatten, perturbed_params, run_worker,
                          token_names)

V = 300
CFG = GPTConfig(vocab_size=V, seq_len=64, d_model=64, n_head=4, n_layer=2,
                n_kv_heads=2, causal=True)
SLOTS, CHUNK, MAX_LEN, TOP_K = 3, 4, 32, 40
# (prompt ids, seed, temperature): five requests for three slots
REQUESTS = [([11, 12, 13], 101, 1.0), ([21, 22], 202, 0.8),
            ([31, 32, 33, 34, 35, 36], 303, 1.2), ([41], 404, 1.0),
            ([51, 52, 53, 54], 505, 0.9)]
# per-row sampling mode: (request index, top_p, min_p); the first is neutral
ROW_REQUESTS = [(0, 1.0, 0.0), (1, 0.9, 0.0), (2, 0.7, 0.05), (4, 1.0, 0.1)]
EARLY = 0          # the request whose 7th generated token becomes the EOS
STATE_KEYS = ("buf", "pos", "last", "done", "lengths", "rngs", "row_max")
# the state sequence: (call, request index, slot, row budget)
SEQUENCE = [("admit", 0, 1, MAX_LEN), ("chunk",), ("admit", 2, 0, MAX_LEN),
            ("admit", 4, 2, 4), ("chunk",), ("chunk",)]
# the option engine: per-row sampling, an n-gram ban of 2, a grammar over a
# Scheme-A-shaped naming of the same ids (the generator keeps its vocab)
NGRAM = 2
OPT_ENGINE = {"per_row_sampling": True, "no_repeat_ngram": NGRAM}
OPTS = {"plain": {}, "pen": {"penalties": [1.3, 0.1, 0.4]},
        "ngram": {"no_repeat_ngram": NGRAM}, "gram": {"grammar": True},
        "all": {"penalties": [1.2, 0.0, 0.2], "no_repeat_ngram": NGRAM,
                "grammar": True, "top_p": 0.9},
        "win_a": {"penalties": [1.25, 0.0, 0.3], "no_repeat_ngram": NGRAM,
                  "grammar": True},
        "win_b": {"penalties": [2.0, 0.5, 0.5], "no_repeat_ngram": NGRAM}}
# (request index, options): the engine's rows; the last four go through
# the window batcher too, two groups of two (temperature 1.0 each)
OPT_ROWS = [(0, "plain"), (1, "pen"), (2, "ngram"), (3, "gram"), (4, "all"),
            (0, "win_a"), (3, "win_a"), (0, "win_b"), (3, "win_b")]
WINDOW_ROWS = list(range(5, 9))
OPT_KEYS = STATE_KEYS + ("counts", "rep_ps", "freq_ps", "pres_ps",
                         "ngram_on", "gstate", "gram_on")
# (call, request index, slot, row budget, options); slot 2 is reused
OPT_SEQUENCE = [("admit", 3, 1, MAX_LEN, "gram"), ("chunk",),
                ("admit", 1, 0, MAX_LEN, "all"), ("admit", 2, 2, 6, "pen"),
                ("chunk",), ("chunk",), ("admit", 4, 2, MAX_LEN, "ngram"),
                ("chunk",)]


def _prompt(ids):
    row = np.zeros((1, 16), np.int32)
    row[0, :len(ids)] = ids
    return row


def _solo(gen, ids, seed, temp, eos, top_p=1.0, min_p=0.0):
    buf, pos = generate_kv_ragged(
        gen.params, jnp.asarray(_prompt(ids)),
        jnp.asarray([len(ids)], jnp.int32), jax.random.PRNGKey(seed)[None],
        CFG, MAX_LEN, temperature=temp, top_k=TOP_K, eos_id=eos, pad_id=0,
        top_p=top_p, min_p=min_p)
    return np.asarray(buf)[0, :int(np.asarray(pos)[0])]


def _state_arrays(state):
    out = {k: np.asarray(state[k]) for k in STATE_KEYS if k != "lengths"}
    out["lengths"] = np.asarray(state["cache"]["lengths"])
    out["cache"] = {"k": [np.asarray(a) for a in state["cache"]["k"]],
                    "v": [np.asarray(a) for a in state["cache"]["v"]],
                    "lengths": out["lengths"]}
    return out


def _state_sequence(gen, inp, ref):
    state = init_state(CFG, SLOTS, MAX_LEN)
    common = dict(top_k=TOP_K, greedy=False, mask_value=-1e10,
                  eos_id=gen.eos_id, pad_id=gen.pad_id, top_p=1.0)
    for i, call in enumerate(SEQUENCE):
        if call[0] == "admit":
            ids, seed, temp = REQUESTS[call[1]]
            state = admit_row(
                gen.params, state, jnp.asarray(_prompt(ids)),
                jnp.asarray(len(ids), jnp.int32),
                jnp.asarray(call[2], jnp.int32), jax.random.PRNGKey(seed),
                jnp.asarray(call[3], jnp.int32),
                jnp.asarray(temp, jnp.float32), CFG, **common)
        else:
            state = ragged_chunk(gen.params, state, CFG, chunk=CHUNK,
                                 **common)
        arrays = _state_arrays(state)
        inp.update(flatten(arrays.pop("cache"), f"seq/{i}/jax_cache"))
        ref[f"seq/{i}"] = arrays


def _opt_kw(name):
    kw = dict(OPTS[name])
    if "penalties" in kw:
        kw["penalties"] = tuple(kw["penalties"])
    return kw


def _opt_state_sequence(gen, gram, ref):
    state = init_state(CFG, SLOTS, MAX_LEN, per_row_sampling=True,
                       no_repeat_ngram=NGRAM, grammar=True)
    common = dict(top_k=TOP_K, greedy=False, mask_value=-1e10,
                  eos_id=gen.eos_id, pad_id=gen.pad_id, top_p=1.0,
                  per_row_sampling=True, no_repeat_ngram=NGRAM,
                  grammar=gram.arrays(), use_grammar=True)
    for i, call in enumerate(OPT_SEQUENCE):
        if call[0] == "admit":
            ids, seed, temp = REQUESTS[call[1]]
            kw = _opt_kw(call[4])
            state = admit_row(
                gen.params, state, jnp.asarray(_prompt(ids)),
                jnp.asarray(len(ids), jnp.int32),
                jnp.asarray(call[2], jnp.int32), jax.random.PRNGKey(seed),
                jnp.asarray(call[3], jnp.int32),
                jnp.asarray(temp, jnp.float32), CFG,
                row_top_p=kw.get("top_p", 1.0),
                row_penalties=kw.get("penalties", (1.0, 0.0, 0.0)),
                row_ngram_on=bool(kw.get("no_repeat_ngram")),
                row_gram_on=bool(kw.get("grammar")), **common)
        else:
            state = ragged_chunk(gen.params, state, CFG, chunk=CHUNK,
                                 **common)
        arrays = _state_arrays(state)
        arrays.pop("cache")
        for key in OPT_KEYS[len(STATE_KEYS):]:
            arrays[key] = np.asarray(state[key])
        ref[f"opt_seq/{i}"] = arrays


def _engine_rows(gen, requests, **engine_opts):
    eng = ContinuousBatcher(gen, slots=SLOTS, chunk=CHUNK, max_len=MAX_LEN,
                            top_k=TOP_K, **engine_opts)
    rows = {}

    def hit(i, req, extra):
        ids, seed, temp = req
        time.sleep(0.05 * i)                      # staggered admission
        rows[i] = eng.submit(ids, temperature=temp, seed=seed, timeout=600,
                             **extra)

    try:
        threads = [threading.Thread(target=hit, args=(i, req, extra),
                                    daemon=True)
                   for i, (req, extra) in enumerate(requests)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=900)
        assert len(rows) == len(requests), "a JAX engine request timed out"
    finally:
        eng.close()
    return rows


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    rng = np.random.default_rng(99)
    params = perturbed_params(CFG, rng)
    vocab = {f"t{i}": i for i in range(V)}
    probe = Generator(params, CFG, Vocab(vocab), eos_token="none",
                      pad_token="t0")
    ids, seed, temp = REQUESTS[EARLY]
    free_run = _solo(probe, ids, seed, temp, -1)
    assert len(free_run) == MAX_LEN
    eos = int(free_run[len(ids) + 6])
    gen = Generator(params, CFG, Vocab(vocab), eos_token=f"t{eos}",
                    pad_token="t0")
    assert gen.eos_id == eos and gen.pad_id == 0
    names = token_names(V)
    gram = grammar_a(Vocab(names))

    inp = {"cfg": cfg_json(CFG), "vocab": np.asarray(json.dumps(vocab)),
           "eos": np.asarray(eos),
           "spec": np.asarray(json.dumps(
               {"slots": SLOTS, "chunk": CHUNK, "max_len": MAX_LEN,
                "top_k": TOP_K, "requests": REQUESTS,
                "row_requests": ROW_REQUESTS, "sequence": SEQUENCE,
                "early": EARLY, "ngram": NGRAM, "opts": OPTS,
                "opt_rows": OPT_ROWS, "window_rows": WINDOW_ROWS,
                "opt_sequence": OPT_SEQUENCE})),
           "names": np.asarray(json.dumps(names))}
    inp.update(flatten(params, "p"))
    ref = {}
    _state_sequence(gen, inp, ref)
    ref["solo"] = [_solo(gen, *req, eos) for req in REQUESTS]
    ref["engine"] = _engine_rows(gen, [(req, {}) for req in REQUESTS])
    ref["row_engine"] = _engine_rows(
        gen, [(REQUESTS[i], {"top_p": tp, "min_p": mp})
              for i, tp, mp in ROW_REQUESTS], per_row_sampling=True)
    ref["row_solo"] = [_solo(gen, *REQUESTS[i], eos, top_p=tp, min_p=mp)
                       for i, tp, mp in ROW_REQUESTS]
    _opt_state_sequence(gen, gram, ref)
    ref["opt_engine"] = _engine_rows(
        gen, [(REQUESTS[i], _opt_kw(name)) for i, name in OPT_ROWS],
        grammar=gram, **OPT_ENGINE)
    got = run_worker("engine", inp, tmp_path_factory.mktemp("engine"),
                     timeout=900)
    return got, ref


@pytest.mark.parametrize("i", range(len(SEQUENCE)),
                         ids=[f"{i}_{c[0]}" for i, c in enumerate(SEQUENCE)])
@pytest.mark.parametrize("key", STATE_KEYS)
def test_engine_state_equals_jax_after_each_call(results, i, key):
    got, ref = results
    a, b = got[f"seq/{i}/{key}"], ref[f"seq/{i}"][key]
    assert a.shape == b.shape
    np.testing.assert_array_equal(a.astype(np.int64), b.astype(np.int64))


@pytest.mark.parametrize("i", range(len(SEQUENCE)),
                         ids=[f"{i}_{c[0]}" for i, c in enumerate(SEQUENCE)])
def test_engine_cache_matches_jax_after_each_call(results, i):
    got, _ = results
    for li in range(CFG.n_layer):
        np.testing.assert_allclose(got[f"seq/{i}/cache/kv/{li}"],
                                   got[f"seq/{i}/jax_cache/kv/{li}"],
                                   rtol=1e-5, atol=1e-5)


def test_early_eos_stream_is_short(results):
    """The chosen EOS really cuts the early request's stream."""
    _, ref = results
    n = len(ref["solo"][EARLY])
    assert len(REQUESTS[EARLY][0]) < n <= len(REQUESTS[EARLY][0]) + 7


@pytest.mark.parametrize("i", range(len(REQUESTS)))
@pytest.mark.parametrize("route", ["solo", "engine", "detached", "window"])
def test_row_equals_jax_on_every_route(results, i, route):
    """A request's tokens through the port's solo ragged decode, its
    engine (staggered, 5 requests on 3 slots, chunks of 4), run_detached
    and the window batcher: all equal the JAX engine's row and the JAX
    solo stream."""
    got, ref = results
    want = ref["engine"][i]
    assert list(ref["solo"][i]) == want
    assert got[f"{route}/{i}"].tolist() == want


@pytest.mark.parametrize("j", range(len(ROW_REQUESTS)))
@pytest.mark.parametrize("route", ["row_engine", "row_detached"])
def test_per_row_sampling_rows_equal_jax(results, j, route):
    got, ref = results
    want = ref["row_engine"][j]
    assert list(ref["row_solo"][j]) == want
    assert got[f"{route}/{j}"].tolist() == want


def test_neutral_row_in_per_row_mode_equals_default_engine(results):
    got, ref = results
    i, tp, mp = ROW_REQUESTS[0]
    assert (tp, mp) == (1.0, 0.0)
    assert got["row_engine/0"].tolist() == ref["engine"][i]


def test_engine_counters(results):
    got, _ = results
    stats = json.loads(str(got["engine_stats"]))
    assert stats["admitted"] == stats["served"] == len(REQUESTS)
    assert stats["chunks"] >= (MAX_LEN - 7) // CHUNK
    assert stats["cancelled"] == 0 and stats["rejected"] == 0
    assert len(stats["join_delay_ms"]) == len(REQUESTS)


def test_run_detached_midpoint_check_stops_early_eos(results):
    """Budget: ceil((32 - 3 - 1) / 4) = 7 chunks, so run_detached looks at
    the done flag after chunk 3 and stops there."""
    got, _ = results
    assert int(got["detached_chunks_early"]) == 3
    assert int(got["detached_chunks_full"]) == 7


def test_engine_overloaded_at_full_queue(results):
    got, _ = results
    assert str(got["overload/raised"]) == "EngineOverloaded"
    assert int(got["overload/rejected"]) == 1
    assert bool(got["overload/others_served"])


def test_cancel_frees_the_slot(results):
    got, ref = results
    assert str(got["cancel/raised"]) == "TimeoutError"
    assert int(got["cancel/cancelled"]) == 1
    assert int(got["cancel/free_slots"]) == 1
    assert got["cancel/next"].tolist() == ref["engine"][1]


def test_fail_all_leaves_a_serving_engine(results):
    got, ref = results
    assert "injected" in str(got["fail/error"])
    assert int(got["fail/free_slots"]) == SLOTS
    assert got["fail/next"].tolist() == ref["engine"][3]


def test_window_batcher_groups_requests(results):
    got, _ = results
    stats = json.loads(str(got["window_stats"]))
    assert stats["requests"] == len(REQUESTS)
    assert stats["max_group"] >= 2


@pytest.mark.parametrize("i", range(len(OPT_SEQUENCE)),
                         ids=[f"{i}_{c[0]}" for i, c in
                              enumerate(OPT_SEQUENCE)])
@pytest.mark.parametrize("key", OPT_KEYS)
def test_option_engine_state_equals_jax_after_each_call(results, i, key):
    """Tokens, positions, flags, keys, counts (f32, equal), per-row
    penalties, the n-gram and grammar bits and the FSM states."""
    got, ref = results
    a, b = got[f"opt_seq/{i}/{key}"], ref[f"opt_seq/{i}"][key]
    assert a.shape == b.shape
    if a.dtype.kind == "f":
        np.testing.assert_array_equal(a, b)
    else:
        np.testing.assert_array_equal(a.astype(np.int64), b.astype(np.int64))


@pytest.mark.parametrize("j", range(len(OPT_ROWS)),
                         ids=[f"{j}_{n}" for j, (_, n) in enumerate(OPT_ROWS)])
def test_option_engine_rows_equal_jax(results, j):
    """Rows with penalties, an n-gram ban, the grammar and all of them, on
    an engine with all three built in, token-equal to the JAX engine's."""
    got, ref = results
    assert got[f"opt_engine/{j}"].tolist() == ref["opt_engine"][j]


def test_grammar_rows_differ_from_plain_ones(results):
    """The grammar acts: each grammar row differs from the plain stream of
    its request (penalties and bans may leave a short seeded stream as it
    was: they move only tokens already seen)."""
    _, ref = results
    for j, (i, name) in enumerate(OPT_ROWS):
        if OPTS[name].get("grammar"):
            assert ref["opt_engine"][j] != ref["engine"][i], (j, name)


@pytest.mark.parametrize("route", ["opt_engine/0", "opt_detached/0"])
def test_plain_row_in_option_engine_equals_default_engine(results, route):
    """A row that asks for nothing, in the engine with every option built
    in (and decoded detached there), gives the default engine's stream."""
    got, ref = results
    assert OPT_ROWS[0] == (0, "plain")
    assert got[route].tolist() == ref["engine"][0]


@pytest.mark.parametrize("j", WINDOW_ROWS)
def test_window_option_rows_equal_jax(results, j):
    """The window batcher with penalties, n-gram bans and its grammar: the
    JAX engine's rows (each is the request's solo stream)."""
    got, ref = results
    assert got[f"opt_window/{j}"].tolist() == ref["opt_engine"][j]


def test_window_option_requests_grouped(results):
    got, _ = results
    stats = json.loads(str(got["opt_window_stats"]))
    assert stats["requests"] == len(WINDOW_ROWS)
    assert stats["calls"] == 2 and stats["max_group"] == 2
