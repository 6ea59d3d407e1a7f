"""The port's Medusa-2 tree verification against the JAX package, on the
CPU.

Same inputs (numpy, from a seed) and the same weights go through the JAX
package here and through ``eamg_tpu_torch`` in one subprocess
(tests/torch_port_worker.py, task ``medusa_tree``).

Checked, with the tolerance and its reason:
- ``decode/medusa_tree.py::tree_tables`` of the default tree and of a
  small one: every table equal to JAX's, array for array;
- ``_top_b`` on rows with ties, -inf and a constant row: the indices of
  JAX's compiled ``_top_b`` (the form ``generate_medusa_tree`` runs it in;
  op by op JAX's ``one_hot * inf`` mask would make NaNs), exactly;
- ``models/gpt.py::decode_tree`` (L2, d64, GQA-2, f32) with a cache of
  random K/V at t 0, mid and M - N: logits, hidden states and the staged
  cache within 1e-5 of JAX's (f32 sums in another order), the length
  unchanged;
- ``generate_medusa_tree`` with non-zero heads: tokens and verify steps
  equal to JAX's, without an EOS and with an EOS token the decode emits
  inside a verify window; the eager loop's tokens equal the graphed
  loop's; the tokens equal the plain greedy decode's;
- with zero heads (``init_medusa_heads``) the tree accepts at least as
  much as linear Medusa of the tree's depth (no more verify steps for the
  same tokens).
"""

from __future__ import annotations

import json

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from eamg_tpu.decode.loop import generate_kv
from eamg_tpu.decode.medusa_tree import (DEFAULT_TREE, _top_b,
                                         generate_medusa_tree, tree_tables)
from eamg_tpu.models.gpt import GPTConfig, decode_tree

from port_harness import cfg_json, flatten, perturbed_params, run_worker

CFG = GPTConfig(vocab_size=97, seq_len=48, d_model=64, n_head=4, n_layer=2,
                n_kv_heads=2, causal=True)
MAX_LEN = 40
PROMPT = [5, 9, 13, 7]
TREES = {"default": DEFAULT_TREE,
         "small": ((0, 0, 0), (0, 0, 1), (1, 1, 0), (2, 1, 1), (3, 2, 0))}
TB = tree_tables()
SLACK = MAX_LEN + TB["N"] + 1
TREE_T = (0, 17, SLACK - TB["N"])
TREE_TOL = 1e-5


def _heads(D, rng, n=4):
    return {"blocks": [{"w": (0.3 * rng.standard_normal((D, D))
                              / np.sqrt(D)).astype(np.float32),
                        "b": (0.1 * rng.standard_normal(D)).astype(
                            np.float32)} for _ in range(n)]}


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    rng = np.random.default_rng(31)
    params = perturbed_params(CFG, rng, key=9)
    heads = _heads(CFG.d_model, rng)
    jp = jax.tree.map(jnp.asarray, params)
    jh = {"blocks": [{k: jnp.asarray(v) for k, v in b.items()}
                     for b in heads["blocks"]]}
    inp = {"model/cfg": cfg_json(CFG), "prompt": np.asarray(PROMPT),
           "max_len": np.asarray(MAX_LEN),
           "trees": np.asarray(json.dumps(TREES)),
           "n_trees": np.asarray(len(TREE_T))}
    inp.update(flatten(params, "model/p"))
    inp.update(flatten(heads, "model/heads"))
    ref = {}
    for name, spec in TREES.items():
        ref[("tables", name)] = tree_tables(spec)
    lg = rng.standard_normal((4, 30)).astype(np.float32)
    lg[1, 3] = lg[1, 7] = 9.0                      # a tie at the top
    lg[2, :20] = -np.inf
    lg[3] = 0.5                                    # a constant row
    inp["top_b/logits"], inp["top_b/b"] = lg, np.asarray(4)
    ref["top_b"] = np.asarray(jax.jit(_top_b, static_argnums=1)(
        jnp.asarray(lg), 4))
    depth, anc = jnp.asarray(TB["depth"]), jnp.asarray(TB["anc"])
    for i, t in enumerate(TREE_T):
        shape = (1, CFG.kv_heads, SLACK, CFG.head_dim)
        k = [(0.5 * rng.standard_normal(shape)).astype(np.float32)
             for _ in range(CFG.n_layer)]
        v = [(0.5 * rng.standard_normal(shape)).astype(np.float32)
             for _ in range(CFG.n_layer)]
        ids = rng.integers(0, CFG.vocab_size, (1, TB["N"])).astype(np.int32)
        cache = {"k": tuple(map(jnp.asarray, k)),
                 "v": tuple(map(jnp.asarray, v)),
                 "length": jnp.asarray(t, jnp.int32)}
        logits, h, new = decode_tree(jp, jnp.asarray(ids), depth, anc, cache,
                                     CFG)
        inp.update({f"tree/{i}/ids": ids, f"tree/{i}/t": np.asarray(t)})
        inp.update(flatten({"k": k, "v": v}, f"tree/{i}/cache"))
        ref[("tree", i)] = (np.asarray(logits), np.asarray(h),
                            [np.asarray(a) for a in new["k"] + new["v"]],
                            int(new["length"]))
    prompt = np.zeros((1, 16), np.int32)
    prompt[0, :len(PROMPT)] = PROMPT
    buf, n = generate_kv(jp, jnp.asarray(prompt), len(PROMPT),
                         jax.random.PRNGKey(0), CFG, MAX_LEN, greedy=True,
                         refeed_last_prompt=False)
    plain = np.asarray(buf)[0, :int(n)]
    ref["kv_greedy"] = plain
    # an EOS that the decode emits after a few verify windows
    runs = {"no_eos": -1, "eos": int(plain[len(PROMPT) + 9])}
    for name, eos in runs.items():
        buf, n, steps = generate_medusa_tree(jp, jh, jnp.asarray(prompt),
                                             len(PROMPT), CFG, MAX_LEN,
                                             eos_id=eos)
        ref[("run", name)] = (np.asarray(buf)[0, :int(n)], int(steps))
    inp["runs"] = np.asarray(json.dumps(runs))
    ref["eos"] = runs["eos"]
    got = run_worker("medusa_tree", inp,
                     tmp_path_factory.mktemp("medusa_tree"))
    return got, ref


@pytest.mark.parametrize("name", list(TREES))
def test_tree_tables_match_jax(results, name):
    got, ref = results
    for k, v in ref[("tables", name)].items():
        np.testing.assert_array_equal(got[f"tables/{name}/{k}"],
                                      np.asarray(v), err_msg=k)


def test_top_b_matches_jax(results):
    got, ref = results
    np.testing.assert_array_equal(got["top_b"], ref["top_b"])


@pytest.mark.parametrize("i", range(len(TREE_T)))
def test_decode_tree_matches_jax(results, i):
    got, ref = results
    logits, h, cache, length = ref[("tree", i)]
    np.testing.assert_allclose(got[f"tree/{i}/logits"], logits,
                               atol=TREE_TOL, rtol=0)
    np.testing.assert_allclose(got[f"tree/{i}/hidden"], h, atol=TREE_TOL,
                               rtol=0)
    for j, want in enumerate(cache):
        np.testing.assert_allclose(got[f"tree/{i}/cache/{j}"], want,
                                   atol=TREE_TOL, rtol=0)
    assert int(got[f"tree/{i}/length"][0]) == length == TREE_T[i]


@pytest.mark.parametrize("name", ("no_eos", "eos"))
def test_generate_medusa_tree_matches_jax(results, name):
    got, ref = results
    tokens, steps = ref[("run", name)]
    np.testing.assert_array_equal(got[f"run/{name}/tokens"], tokens)
    assert int(got[f"run/{name}/steps"]) == steps


def test_tree_equals_plain_greedy(results):
    got, ref = results
    np.testing.assert_array_equal(got["kv_greedy"], ref["kv_greedy"])
    np.testing.assert_array_equal(got["run/no_eos/tokens"],
                                  ref["kv_greedy"])
    np.testing.assert_array_equal(got["eager/tokens"], ref["kv_greedy"])


def test_eos_inside_the_window(results):
    got, ref = results
    tokens = got["run/eos/tokens"]
    assert tokens[-1] == ref["eos"] and len(tokens) < MAX_LEN
    np.testing.assert_array_equal(tokens,
                                  ref["kv_greedy"][:len(tokens)])


def test_tree_accepts_at_least_linear_with_zero_heads(results):
    got, _ = results
    (n_t, s_t), (n_l, s_l) = got["zero/tree"], got["zero/linear"]
    assert n_t == n_l == MAX_LEN
    assert s_t <= s_l
