"""The port's grammar-constrained decoding against the JAX package, in f32
on the CPU.

Same weights, prompts and seeds go through ``eamg_tpu.decode`` here and
through ``eamg_tpu_torch.decode`` in one subprocess
(tests/torch_port_worker.py, task "grammar"). Tolerances: tokens, states,
lengths and table entries equal; masked logits equal bit for bit; beam
scores to 1e-5.

Checked:
- the FSM tables (``Grammar`` fields and ``arrays()``) on the shipped
  Scheme-A vocabulary, the B3 scheme and a B2 scheme;
- ``grammar_mask`` (budgets 0 to 6, a scalar budget, none; ``row_on``
  mixes), ``grammar_step`` (active mixes) and ``scan_prompt_state``
  (malformed, well-formed and padded prompts, lengths 0 to P) on seeded
  states;
- ``generate_kv`` with a grammar, sampled and greedy, refeed on and off,
  at batch 2, composed with penalties, an n-gram ban and top-p, and at a
  budget that forces the closing path; ``stream_tokens``,
  ``generate_beam`` (K 4) and ``generate_full`` with a grammar;
  ``generate_kv_ragged`` with penalties, an n-gram ban and a grammar, and
  with the first two alone; every stream token-equal to JAX's;
- ``POST /generate`` with ``grammar=1`` on the shipped B3 demo: 200, a
  MIDI whose ids break no rule and end with the END token, one-shot and
  streamed; ``lookup=1&grammar=1`` answers JAX's 422.
"""

from __future__ import annotations

import json

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from eamg_tpu.decode.beam import generate_beam
from eamg_tpu.decode.grammar import (grammar_a, grammar_b2, grammar_b3,
                                     grammar_mask, grammar_step,
                                     scan_prompt_state)
from eamg_tpu.decode.loop import generate_full, generate_kv
from eamg_tpu.decode.ragged import generate_kv_ragged
from eamg_tpu.decode.stream import stream_tokens
from eamg_tpu.models.gpt import GPTConfig
from eamg_tpu.tokenizer import SchemeB2, SchemeB3, Vocab

from port_harness import (REPO, cfg_json, flatten, perturbed_params,
                          run_worker, token_names)

V = 300
CFG = GPTConfig(vocab_size=V, seq_len=64, d_model=32, n_head=2, n_layer=2,
                n_kv_heads=1, causal=True)
MAX_LEN = 40
EOS, PAD = 2, 0
PROMPT = [1, 4, 7, 12, 40, 41]      # START, BPM, KEY, INST, NOTE, NOTE
TABLE_FIELDS = ("tclass", "allowed", "next_state", "closing",
                "steps_to_close")
ARRAY_FIELDS = ("tclass", "allowed", "closing", "need_next", "steps",
                "next", "init")
# solo decodes: name -> generate_kv's keywords (prompt PROMPT, top_k 40)
SOLO = {
    "sampled_refeed": {"seed": 3, "batch": 2},
    "greedy_no_refeed": {"greedy": True, "refeed_last_prompt": False},
    "composed": {"seed": 5, "refeed_last_prompt": False, "top_p": 0.9,
                 "penalties": [1.3, 0.1, 0.5], "no_repeat_ngram": 2},
    "closing": {"seed": 7, "max_len": len(PROMPT) + 6},
}
STREAM = {"seed": 4, "chunk": 8, "penalties": [1.2, 0.0, 0.3]}
FULL_SEED = 6
BEAMS = 4
# the window decode: rows' prompts, seeds, and the options of each case
RAGGED_PROMPTS = [PROMPT, [1, 12, 45], [1, 3, 6, 12, 50, 51, 52, 53]]
RAGGED_SEEDS = [11, 12, 13]
RAGGED = {"all": {"penalties": [1.3, 0.0, 0.4], "no_repeat_ngram": 2,
                  "grammar": True, "temperature": 0.9},
          "history": {"penalties": [1.2, 0.2, 0.0], "no_repeat_ngram": 3}}


def _tables_case(inp, ref):
    with open(REPO / "eamg_tpu" / "serve" / "demo_ckpt_a" /
              "vocab.json") as f:
        vocab_a = Vocab(json.load(f))
    for tag, g in (("a", grammar_a(vocab_a)), ("b3", grammar_b3(SchemeB3())),
                   ("b2", grammar_b2(SchemeB2()))):
        for name in TABLE_FIELDS:
            ref[f"tables/{tag}/{name}"] = np.asarray(getattr(g, name))
        ref[f"tables/{tag}/init_state"] = np.asarray(g.init_state)
        ref[f"tables/{tag}/names"] = np.asarray(
            json.dumps([g.classes, g.states]))
        arr = g.arrays()
        for name in ARRAY_FIELDS:
            a = np.asarray(arr[name])
            ref[f"arrays/{tag}/{name}"] = a > 0.5 if a.dtype.kind == "f" \
                else a


def _functions_case(rng, inp, ref):
    g = grammar_b3(SchemeB3())
    garr = g.arrays()
    B, Vb, S = 14, len(g.tclass), g.n_states
    logits = rng.standard_normal((B, Vb)).astype(np.float32)
    gstate = rng.integers(0, S, B).astype(np.int32)
    budget = (np.arange(B) % 7).astype(np.int32)        # 0..6
    row_on = rng.random(B) < 0.5
    inp.update({"fn/logits": logits, "fn/gstate": gstate,
                "fn/budget": budget, "fn/row_on": row_on})
    lg, gs = jnp.asarray(logits), jnp.asarray(gstate)
    ref["fn/mask_plain"] = np.asarray(grammar_mask(lg, gs, garr))
    ref["fn/mask_budget"] = np.asarray(grammar_mask(
        lg, gs, garr, budget_left=jnp.asarray(budget)))
    ref["fn/mask_scalar"] = np.asarray(grammar_mask(lg, gs, garr,
                                                    budget_left=3))
    ref["fn/mask_row_on"] = np.asarray(grammar_mask(
        lg, gs, garr, budget_left=jnp.asarray(budget),
        row_on=jnp.asarray(row_on)))
    tokens = rng.integers(0, Vb, B).astype(np.int32)
    active = rng.random(B) < 0.6
    inp.update({"fn/tokens": tokens, "fn/active": active})
    ref["fn/step"] = np.asarray(grammar_step(gs, jnp.asarray(tokens), garr))
    ref["fn/step_active"] = np.asarray(grammar_step(
        gs, jnp.asarray(tokens), garr, active=jnp.asarray(active)))
    # prompts: random ids (malformed), a well-formed stream, pads
    P = 13
    prompts = rng.integers(0, Vb, (B, P)).astype(np.int32)
    b3 = SchemeB3()
    good = [b3.vocab.tok2id[t] for t in (
        "[START_SEQ]", "BPM_120", "KEY_3", "[NOTE]", "P_60", "T_4",
        "DUR_2", "[NOTE]", "P_62", "T_8", "DUR_3", "[NOTE]", "P_64")]
    prompts[0] = prompts[1] = good
    prompts[2, 5:] = b3.vocab.tok2id["[PAD]"]
    plen = np.asarray([13, 7, 5, 0, 1] + list(rng.integers(0, P + 1, B - 5)),
                      np.int32)
    inp.update({"fn/prompts": prompts, "fn/plen": plen})
    ref["fn/scan"] = np.asarray(scan_prompt_state(
        garr, jnp.asarray(prompts), jnp.asarray(plen)))
    ref["fn/scan_scalar"] = np.asarray(scan_prompt_state(
        garr, jnp.asarray(prompts), 9))


def _prompt(ids, width=16, batch=1):
    row = np.full((batch, width), PAD, np.int32)
    row[:, :len(ids)] = ids
    return row


def _decode_case(jp, gram, inp, ref):
    p = len(PROMPT)
    for name, kw in SOLO.items():
        kw = dict(kw)
        seed, batch = kw.pop("seed", 0), kw.pop("batch", 1)
        max_len = kw.pop("max_len", MAX_LEN)
        if "penalties" in kw:
            kw["penalties"] = tuple(kw["penalties"])
        prompt = jnp.asarray(_prompt(PROMPT, min(16, max_len), batch))
        buf, n = generate_kv(jp, prompt, p, jax.random.PRNGKey(seed), CFG,
                             max_len, top_k=40, eos_id=EOS, pad_id=PAD,
                             grammar=gram, **kw)
        ref[f"solo/{name}"] = np.asarray(buf)[:, :int(n)]
    kw = dict(STREAM)
    kw["penalties"] = tuple(kw["penalties"])
    ref["stream"] = np.asarray(list(stream_tokens(
        jp, CFG, PROMPT, MAX_LEN, top_k=40, eos_id=EOS, pad_id=PAD,
        grammar=gram, **kw)), np.int64)
    ref["beam/buf"], ref["beam/gen_lens"], ref["beam/scores"] = (
        np.asarray(a) for a in generate_beam(
            jp, jnp.asarray(_prompt(PROMPT)), p, CFG, MAX_LEN,
            n_beams=BEAMS, eos_id=EOS, pad_id=PAD, grammar=gram))
    buf, n = generate_full(jp, jnp.asarray(_prompt(PROMPT)), p,
                           jax.random.PRNGKey(FULL_SEED), CFG, MAX_LEN,
                           top_k=40, eos_id=EOS, pad_id=PAD, grammar=gram)
    ref["full"] = np.asarray(buf)[:, :int(n)]
    width = 16
    prompts = np.concatenate([_prompt(r, width) for r in RAGGED_PROMPTS])
    lens = np.asarray([len(r) for r in RAGGED_PROMPTS], np.int32)
    rngs = jax.vmap(jax.random.PRNGKey)(jnp.asarray(RAGGED_SEEDS))
    inp["ragged/prompts"], inp["ragged/lens"] = prompts, lens
    for name, kw in RAGGED.items():
        kw = dict(kw)
        kw["penalties"] = tuple(kw["penalties"])
        kw["grammar"] = gram if kw.get("grammar") else None
        buf, n = generate_kv_ragged(jp, jnp.asarray(prompts),
                                    jnp.asarray(lens), rngs, CFG, MAX_LEN,
                                    top_k=40, eos_id=EOS, pad_id=PAD, **kw)
        ref[f"ragged/{name}/buf"] = np.asarray(buf)
        ref[f"ragged/{name}/lengths"] = np.asarray(n)


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    rng = np.random.default_rng(1313)
    params = perturbed_params(CFG, rng)
    names = token_names(V)
    gram = grammar_a(Vocab(names))
    jp = jax.tree.map(jnp.asarray, params)
    inp = {"cfg": cfg_json(CFG), "names": np.asarray(json.dumps(names)),
           "spec": np.asarray(json.dumps(
               {"prompt": PROMPT, "max_len": MAX_LEN, "eos": EOS, "pad": PAD,
                "solo": SOLO, "stream": STREAM, "full_seed": FULL_SEED,
                "beams": BEAMS, "ragged": RAGGED,
                "ragged_seeds": RAGGED_SEEDS}))}
    inp.update(flatten(params, "p"))
    ref = {}
    _tables_case(inp, ref)
    _functions_case(rng, inp, ref)
    _decode_case(jp, gram, inp, ref)
    got = run_worker("grammar", inp, tmp_path_factory.mktemp("grammar"),
                     timeout=900)
    return got, ref, gram


@pytest.mark.parametrize("tag", ["a", "b3", "b2"])
@pytest.mark.parametrize("name", TABLE_FIELDS + ("init_state", "names"))
def test_tables_equal_jax(results, tag, name):
    got, ref, _ = results
    np.testing.assert_array_equal(got[f"tables/{tag}/{name}"],
                                  ref[f"tables/{tag}/{name}"])


@pytest.mark.parametrize("tag", ["a", "b3", "b2"])
@pytest.mark.parametrize("name", ARRAY_FIELDS)
def test_device_arrays_equal_jax(results, tag, name):
    got, ref, _ = results
    a, b = got[f"arrays/{tag}/{name}"], ref[f"arrays/{tag}/{name}"]
    assert a.shape == b.shape
    np.testing.assert_array_equal(a.astype(np.int64), b.astype(np.int64))


@pytest.mark.parametrize("name", ["mask_plain", "mask_budget", "mask_scalar",
                                  "mask_row_on", "step", "step_active",
                                  "scan", "scan_scalar"])
def test_device_functions_equal_jax(results, name):
    """Masked logits bit-equal (a row off keeps its logits, the rest are
    the logits or -1e30), states equal."""
    got, ref, _ = results
    a, b = got[f"fn/{name}"], ref[f"fn/{name}"]
    assert a.shape == b.shape
    if a.dtype.kind == "f":
        np.testing.assert_array_equal(a.view(np.int32), b.view(np.int32))
    else:
        np.testing.assert_array_equal(a.astype(np.int64), b.astype(np.int64))


def test_budgets_reach_the_closing_path(results):
    """The seeded budgets 0..6 include rows where nothing fits, which the
    closing fallback serves (the mask differs from the plain one)."""
    _, ref, _ = results
    assert not np.array_equal(ref["fn/mask_budget"], ref["fn/mask_plain"])


@pytest.mark.parametrize("name", list(SOLO))
def test_solo_decode_equals_jax(results, name):
    got, ref, gram = results
    want = ref[f"solo/{name}"]
    np.testing.assert_array_equal(got[f"solo/{name}"], want)
    for row in want:
        assert gram.violations(row.tolist()) == 0


def test_forced_closing_ends_with_the_end_token(results):
    """Six tokens of budget: the row closes its section with END."""
    _, ref, _ = results
    row = ref["solo/closing"][0]
    assert EOS in row[len(PROMPT):].tolist()


@pytest.mark.parametrize("what", ["stream", "full"])
def test_stream_and_uncached_loop_equal_jax(results, what):
    got, ref, _ = results
    np.testing.assert_array_equal(got[what], ref[what])


def test_beam_search_equals_jax(results):
    got, ref, _ = results
    np.testing.assert_array_equal(got["beam/buf"], ref["beam/buf"])
    np.testing.assert_array_equal(got["beam/gen_lens"], ref["beam/gen_lens"])
    np.testing.assert_allclose(got["beam/scores"], ref["beam/scores"],
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("name", list(RAGGED))
def test_ragged_decode_with_options_equals_jax(results, name):
    got, ref, _ = results
    np.testing.assert_array_equal(got[f"ragged/{name}/buf"],
                                  ref[f"ragged/{name}/buf"])
    np.testing.assert_array_equal(got[f"ragged/{name}/lengths"],
                                  ref[f"ragged/{name}/lengths"])


@pytest.mark.parametrize("name", ["oneshot", "stream"])
def test_http_grammar_answers_200_with_a_valid_song(results, name):
    got, _, _ = results
    assert int(got[f"http/{name}/status"]) == 200
    assert int(got[f"http/{name}/violations"]) == 0
    assert bool(got[f"http/{name}/ends_with_end"])
    assert got[f"http/{name}/midi"].tobytes()[:4] == b"MThd"


def test_http_lookup_with_grammar_answers_jax_422(results):
    got, _, _ = results
    assert int(got["http/lookup_grammar/status"]) == 422
    assert "grammar" in str(got["http/lookup_grammar/error"])
