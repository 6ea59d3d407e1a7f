"""Serving on tensor-parallel params in the port against the JAX package,
on the CPU: the continuous engine (``serve/continuous.py``) and the ragged
decode (``decode/ragged.py::generate_kv_ragged``) on a model group.

JAX serves here with ``shard_params(tp=True)`` on a (4 data x 2 model)
mesh of virtual devices (tests/test_sharded_serving.py: GSPMD, no mesh
code in the engine) and unsharded; the port runs in one subprocess
(tests/torch_port_worker.py, task ``sharded_engine``): a model group of 1
in the subprocess itself, then spawned gloo groups of 2 and 4 ranks. Each
rank holds its heads (a K/V head shared by 2 ranks in the GQA-2 model at
4), its FF columns and its vocabulary rows; rank 0 leads the engine and
the others follow its plans (``ContinuousBatcher.serve_follower``).

Checked, exactly (f32):
- every engine row (greedy and sampled, seeds 100 + i, three requests on
  two slots, the second submitted while the first is mid-decode) equals
  JAX's sharded engine's row and the port's unsharded engine's;
- with the per-row options (top-p, penalties, the n-gram ban, the
  grammar) on, the same;
- every follower's engine state after the run (buffer, positions, done
  flags, last tokens, key rows) equals the leader's;
- ``generate_kv_ragged(tp=)`` on every rank equals JAX's ragged stream;
- a fault on a group of 2 ends every rank's part in well under the
  group's collective timeout, and fails both of the leader's requests:
  one in the leader's harvest (the follower returns at "stop"), a
  poisoned admission on every rank (the follower's loop raises it), and
  one on the follower alone, whose process then exits.

The file takes about 60 s (JAX's engines compile for each case; the
port's groups of 2 and 4 spawn their ranks).
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
from eamg_tpu.decode.grammar import grammar_a
from eamg_tpu.decode.ragged import generate_kv_ragged
from eamg_tpu.models import GPTConfig, init_params
from eamg_tpu.parallel import make_mesh, shard_params
from eamg_tpu.serve.continuous import ContinuousBatcher
from eamg_tpu.tokenizer import Vocab

from port_harness import cfg_json, flatten, start_worker, token_names

V = 96
BASE = dict(vocab_size=V, seq_len=32, d_model=32, n_head=4, n_layer=2,
            pos_rows=32, ln_placement="pre", activation="gelu", causal=True)
CASES = {"mha": {}, "gqa2": {"n_kv_heads": 2}}
WORLDS = (1, 2, 4)
SLOTS, CHUNK, MAX_LEN, TOP_K, NGRAM = 2, 4, 24, 40, 2
# (prompt ids, seed, temperature): three requests for two slots
REQUESTS = [([1, 2, 3], 100, 1.0), ([4, 5, 6, 7], 101, 0.9),
            ([8, 9], 102, 1.1)]
# the engines: (name, engine options, per-request options); "opts" runs on
# the MHA case only
OPTS = {"plain": {}, "pen": {"penalties": [1.3, 0.1, 0.4]},
        "all": {"penalties": [1.2, 0.0, 0.2], "no_repeat_ngram": NGRAM,
                "grammar": True, "top_p": 0.9},
        "gram": {"grammar": True, "no_repeat_ngram": NGRAM}}
ENGINES = {"greedy": ({"greedy": True}, ["plain"] * 3),
           "sampled": ({}, ["plain"] * 3),
           "opts": ({"per_row_sampling": True, "no_repeat_ngram": NGRAM,
                     "grammar": True}, ["pen", "all", "gram"])}
ENGINE_CASES = [(c, e) for c in CASES for e in ENGINES
                if e != "opts" or c == "mha"]
STATE_KEYS = ("buf", "pos", "done", "last", "rngs")
# the faults on a group of 2 (tests/torch_port_parallel.py::
# _engine_failures): the admission of POISON raises, on groups whose
# collectives time out after FAIL_TIMEOUT s
POISON, FAIL_TIMEOUT = [13, 13, 13], 60


def _kw(name: str) -> dict:
    kw = dict(OPTS[name])
    if "penalties" in kw:
        kw["penalties"] = tuple(kw["penalties"])
    return kw


def _jax_engine(gen, engine: str, gram) -> list:
    eng_opts, row_opts = ENGINES[engine]
    eng_opts = dict(eng_opts)
    if eng_opts.pop("grammar", False):
        eng_opts["grammar"] = gram
    eng = ContinuousBatcher(gen, slots=SLOTS, chunk=CHUNK, max_len=MAX_LEN,
                            top_k=TOP_K, **eng_opts)
    rows = {}

    def hit(i):
        ids, seed, temp = REQUESTS[i]
        time.sleep(0.05 * i)
        rows[i] = eng.submit(ids, temperature=temp, seed=seed, timeout=600,
                             **_kw(row_opts[i]))

    try:
        threads = [threading.Thread(target=hit, args=(i,), daemon=True)
                   for i in range(len(REQUESTS))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        assert len(rows) == len(REQUESTS), "a JAX engine request timed out"
    finally:
        eng.close()
    return [rows[i] for i in range(len(REQUESTS))]


def _jax_ragged(params, cfg) -> np.ndarray:
    prompt = np.zeros((len(REQUESTS), 8), np.int32)
    for i, (ids, _, _) in enumerate(REQUESTS):
        prompt[i, :len(ids)] = ids
    keys = jnp.stack([jax.random.PRNGKey(s) for _, s, _ in REQUESTS])
    buf, _ = generate_kv_ragged(
        params, jnp.asarray(prompt),
        jnp.asarray([len(r[0]) for r in REQUESTS], jnp.int32), keys, cfg,
        MAX_LEN, temperature=1.0, top_k=TOP_K, eos_id=-1, pad_id=0)
    return np.asarray(buf)


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("sharded_engine")
    vocab = {f"t{i}": i for i in range(V)}
    names = token_names(V)
    spec = {"slots": SLOTS, "chunk": CHUNK, "max_len": MAX_LEN,
            "top_k": TOP_K, "requests": REQUESTS, "opts": OPTS,
            "engines": ENGINES, "engine_cases": ENGINE_CASES,
            "cases": list(CASES), "poison": POISON,
            "fail_timeout": FAIL_TIMEOUT}
    inp = {"eng/spec": np.asarray(json.dumps(spec)),
           "eng/vocab": np.asarray(json.dumps(vocab)),
           "eng/names": np.asarray(json.dumps(names))}
    params = {}
    for i, (name, over) in enumerate(CASES.items()):
        cfg = GPTConfig(**BASE, **over)
        params[name] = (cfg, init_params(jax.random.PRNGKey(10 + i), cfg))
        inp.update(flatten(jax.tree.map(np.asarray, params[name][1]),
                           f"eng/{name}/p"))
        inp[f"eng/{name}/cfg"] = cfg_json(cfg)
    worker = start_worker("sharded_engine", inp, tmp, timeout=900)
    gram = grammar_a(Vocab(names))
    mesh = make_mesh(data=4, model=2)
    ref = {}
    for name, (cfg, p) in params.items():
        gen = Generator(shard_params(p, mesh, tp=True), cfg, Vocab(vocab),
                        eos_token="none", pad_token="t0")
        for case, engine in ENGINE_CASES:
            if case == name:
                ref[f"{name}/{engine}"] = _jax_engine(gen, engine, gram)
        ref[f"{name}/ragged"] = _jax_ragged(p, cfg)
    return worker(), ref


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("case,engine", ENGINE_CASES)
def test_engine_rows_equal_jax_sharded_and_unsharded(results, case, engine,
                                                     world):
    got, ref = results
    for i, want in enumerate(ref[f"{case}/{engine}"]):
        assert got[f"w{world}/r0/{case}/{engine}/{i}"].tolist() == want
        assert got[f"one/{case}/{engine}/{i}"].tolist() == want


@pytest.mark.parametrize("world", (2, 4))
@pytest.mark.parametrize("case,engine", ENGINE_CASES)
def test_follower_state_equals_the_leaders(results, case, engine, world):
    got, _ = results
    for r in range(1, world):
        for key in STATE_KEYS:
            np.testing.assert_array_equal(
                got[f"w{world}/r{r}/{case}/{engine}/state/{key}"],
                got[f"w{world}/r0/{case}/{engine}/state/{key}"])


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("case,engine", ENGINE_CASES)
def test_second_request_joins_a_running_engine(results, case, engine,
                                               world):
    """Request 1 was submitted after the engine's first chunk and before
    request 0 finished: its admission rode a plan into a running state."""
    got, _ = results
    at, total = got[f"w{world}/r0/{case}/{engine}/joined_at"]
    assert 1 <= at < total


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("case", list(CASES))
def test_ragged_decode_on_tp_params_equals_jax(results, case, world):
    got, ref = results
    for r in range(world):
        np.testing.assert_array_equal(got[f"w{world}/r{r}/{case}/ragged"],
                                      ref[f"{case}/ragged"])


def test_a_kv_head_is_shared_at_four_ranks(results):
    got, _ = results
    assert int(got["w4/r0/gqa2/kv_heads"]) == 1
    assert int(got["w4/r0/gqa2/n_head"]) == 1
    assert int(got["w2/r0/gqa2/kv_heads"]) == 1


@pytest.mark.parametrize("fault,follower", [
    ("leader", "none"), ("plan", "RuntimeError: poisoned admission"),
    ("follower", "RuntimeError: poisoned admission")])
def test_a_fault_on_a_group_ends_it_at_once(results, fault, follower):
    """A fault in the leader's own work, one that the plan brings to every
    rank, and one on the follower alone (whose process exits): the
    leader's requests fail, its worker ends, the follower's loop returns
    or raises as its fault says, each rank in under a third of the
    group's timeout."""
    got, _ = results
    pre = f"w2/r{{}}/fail/{fault}"
    errors = [str(e) for e in got[f"{pre.format(0)}/errors"]]
    assert all(e.startswith("RuntimeError") for e in errors), errors
    if fault == "leader":
        assert "poisoned harvest" in errors[0], errors
    if fault == "plan":
        # the poisoned request raised in its own admission: the worker
        # tells it too, not only the live and queued ones
        assert all("poisoned admission" in e for e in errors), errors
    assert str(got[f"{pre.format(1)}/follower"]) == follower
    assert bool(got[f"{pre.format(0)}/closed"])
    for r in range(2):
        assert float(got[f"{pre.format(r)}/seconds"]) < FAIL_TIMEOUT / 3, (
            r, errors)
