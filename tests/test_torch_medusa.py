"""The port's Medusa decoding and its verify step against the JAX package,
on the CPU.

Same inputs (numpy, from a seed) and the same weights (JAX parameter trees
and Medusa heads as numpy arrays) go through the JAX package here and
through ``eamg_tpu_torch`` in one subprocess (tests/torch_port_worker.py,
task ``medusa``); torch never enters this process.

Checked, with the tolerance and its reason:
- ``models/gpt.py::decode_block`` (the verify step) on a small f32 model
  (L2, d64, GQA-2) with a cache of random K/V: logits, hidden states and
  the updated cache within 1e-5 of JAX's at G 1, 5 and 9 with t at 0, mid
  and ``slack - G`` (f32 sums in another order);
- ``medusa_logits`` of non-zero heads on three hidden states: within 1e-5;
- ``generate_medusa`` with non-zero heads made from a numpy seed: tokens,
  length and verify steps equal to JAX's, greedy, three sampled seeds, top-p
  0.9 and min-p 0.05, with an EOS; greedy equal to the port's greedy
  ``generate_kv`` without refeed (JAX's contract); ``stream_tokens_medusa``
  equal to the one-shot, the port's and JAX's;
- the shipped ``medusa_heads.pkl`` of both demos load with JAX's shapes and
  probe; ``probe_acceptance`` on the small model equals JAX's to 1e-3 (its
  rounded rates; sums in another order); the synthetic corpora a probe
  reads (``train/data.py``) equal JAX's row for row, and
  ``probe_heads_for_checkpoint`` (the probe of a heads file without one)
  on an f32 copy of ``demo_ckpt_b3`` with its shipped heads equals JAX's
  to 5e-3 (a near-tie argmax among ~2000 that another order of sums may
  flip moves a rate by 5e-4);
- the pipeline's medusa bytes, one-shot and streamed (done MIDI), equal
  JAX's for the same seed on ``demo_pipeline(corrected=True)`` and
  ``demo_pipeline_b3`` with heads attached;
- ``POST /generate`` with ``medusa=1``, one-shot and ``?stream=1``, on the
  B3 demo pipeline with heads: 200 and JAX's bytes; the 422 contract
  (medusa without heads, streamed with penalties, lookup or beams
  streamed, lookup with medusa, medusa with grammar), and ``/stats``
  carries ``medusa_probe``.
"""

from __future__ import annotations

import base64
import dataclasses
import json
import pickle
from pathlib import Path

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from eamg_tpu.decode.loop import generate_kv
from eamg_tpu.decode.medusa import (generate_medusa, medusa_logits,
                                    stream_tokens_medusa)
from eamg_tpu.models.gpt import GPTConfig, decode_block
from eamg_tpu.serve.pipeline import demo_pipeline, demo_pipeline_b3
from eamg_tpu.tools.medusa import (load_medusa_heads, probe_acceptance,
                                  probe_heads_for_checkpoint)
from eamg_tpu.train.data import grid_corpus, synthetic_corpus
from eamg_tpu.utils.checkpoint import load_checkpoint

from port_harness import cfg_json, flatten, perturbed_params, run_worker

REPO = Path(__file__).resolve().parents[1]
DEMOS = {"a": REPO / "eamg_tpu" / "serve" / "demo_ckpt_a",
         "b3": REPO / "eamg_tpu" / "serve" / "demo_ckpt_b3"}
CFG = GPTConfig(vocab_size=97, seq_len=48, d_model=64, n_head=4, n_layer=2,
                n_kv_heads=2, causal=True)
GAMMA, MAX_LEN, EOS = 4, 40, 3
PROMPT = [5, 9, 13, 7]
SLACK = MAX_LEN + 8 + 1
# decode_block cases: (G, t)
BLOCKS = [(g, t) for g in (1, 5, 9) for t in (0, 17, SLACK - g)]
BLOCK_TOL = 1e-5
# generate_medusa: name -> keywords
RUNS = {"greedy": dict(greedy=True),
        **{f"seed{s}": dict(seed=s, eos_id=EOS) for s in (0, 1, 2)},
        "top_p": dict(seed=4, top_p=0.9, temperature=0.8),
        "min_p": dict(seed=5, min_p=0.05, top_k=20)}
STREAMS = ("greedy", "seed1")
PROBE_TOL = 1e-3
CKPT_PROBE_TOL, CKPT_PROBE_ROWS = 5e-3, 8
CORPUS_ROWS, CORPUS_SEED = 6, 98765
TEXT = "I finally got the job, I am so happy!"
SEED = 5
PIPES = ("a", "b3")


def _heads(D: int, rng, n: int = 4) -> dict:
    """Non-zero heads, so that they propose something other than the base
    head's argmax."""
    return {"blocks": [{"w": (0.3 * rng.standard_normal((D, D))
                              / np.sqrt(D)).astype(np.float32),
                        "b": (0.1 * rng.standard_normal(D)).astype(
                            np.float32)} for _ in range(n)]}


def _jheads(heads):
    return {"blocks": [{k: jnp.asarray(v) for k, v in b.items()}
                       for b in heads["blocks"]]}


_decode_block = jax.jit(lambda p, ids, cache: decode_block(
    p, ids, cache, CFG, return_hidden=True))


def _block_cases(jp, rng, inp, ref):
    for i, (g, t) in enumerate(BLOCKS):
        shape = (1, CFG.kv_heads, SLACK, CFG.head_dim)
        k = [(0.5 * rng.standard_normal(shape)).astype(np.float32)
             for _ in range(CFG.n_layer)]
        v = [(0.5 * rng.standard_normal(shape)).astype(np.float32)
             for _ in range(CFG.n_layer)]
        ids = rng.integers(0, CFG.vocab_size, (1, g)).astype(np.int32)
        cache = {"k": tuple(map(jnp.asarray, k)),
                 "v": tuple(map(jnp.asarray, v)),
                 "length": jnp.asarray(t, jnp.int32)}
        logits, h, new = _decode_block(jp, jnp.asarray(ids), cache)
        inp.update({f"block/{i}/ids": ids, f"block/{i}/t": np.asarray(t)})
        inp.update(flatten({"k": k, "v": v}, f"block/{i}/cache"))
        ref[("block", i)] = (np.asarray(logits), np.asarray(h),
                             [np.asarray(a) for a in new["k"] + new["v"]],
                             int(new["length"]))


def _run_cases(jp, heads, inp, ref):
    jh = _jheads(heads)
    prompt = np.zeros((1, 16), np.int32)
    prompt[0, :len(PROMPT)] = PROMPT
    for name, kw in RUNS.items():
        kw = dict(kw)
        seed = kw.pop("seed", 0)
        buf, n, steps = generate_medusa(
            jp, jh, jnp.asarray(prompt), len(PROMPT),
            jax.random.PRNGKey(seed), CFG, MAX_LEN, gamma=GAMMA, **kw)
        ref[("run", name)] = (np.asarray(buf)[0, :int(n)], int(steps))
    for name in STREAMS:
        kw = dict(RUNS[name])
        seed = kw.pop("seed", 0)
        ref[("stream", name)] = np.asarray(list(stream_tokens_medusa(
            jp, jh, CFG, PROMPT, MAX_LEN, gamma=GAMMA, seed=seed, **kw)))
    buf, n = generate_kv(jp, jnp.asarray(prompt), len(PROMPT),
                         jax.random.PRNGKey(0), CFG, MAX_LEN, greedy=True,
                         refeed_last_prompt=False)
    ref["kv_greedy"] = np.asarray(buf)[0, :int(n)]
    inp["runs"] = np.asarray(json.dumps(RUNS))
    inp["streams"] = np.asarray(json.dumps(STREAMS))


def _pipe_inputs(pipe, tag, heads, inp):
    gen = pipe.generator
    inp.update(flatten(jax.tree.map(np.asarray, gen.params), f"{tag}/p"))
    inp.update(flatten(heads, f"{tag}/heads"))
    inp[f"{tag}/cfg"] = cfg_json(gen.cfg)
    inp[f"{tag}/vocab"] = np.asarray(json.dumps(gen.vocab.tok2id))


def _pipeline_cases(rng, inp, ref):
    pipes = {"a": demo_pipeline(corrected=True), "b3": demo_pipeline_b3()}
    for tag, pipe in pipes.items():
        heads = _heads(pipe.generator.cfg.d_model, rng)
        _pipe_inputs(pipe, tag, heads, inp)
        pipe.medusa_heads = _jheads(heads)
        ref[(tag, "oneshot")] = pipe.generate(
            TEXT, seed=SEED, render_audio=False, medusa=True).midi_bytes
        ev = list(pipe.generate_stream(TEXT, seed=SEED, render_audio=False,
                                       medusa=True))
        ref[(tag, "stream")] = ev


def _checkpoint_probe_cases(inp, ref):
    ref["corpus/synthetic"] = synthetic_corpus(CORPUS_ROWS, seed=CORPUS_SEED,
                                               tempo_locked=True)
    ref["corpus/grid"] = grid_corpus(CORPUS_ROWS, seed=CORPUS_SEED)
    inp["corpus"] = np.asarray(json.dumps([CORPUS_ROWS, CORPUS_SEED]))
    ck = load_checkpoint(str(DEMOS["b3"]))
    ck["params"] = jax.tree.map(lambda a: np.asarray(a, np.float32),
                                ck["params"])
    ck["cfg"] = dataclasses.replace(ck["cfg"], dtype="float32")
    heads = load_medusa_heads(str(DEMOS["b3"] / "medusa_heads.pkl"))
    heads.pop("probe")
    ref["ckpt_probe"] = probe_heads_for_checkpoint(ck, heads,
                                                   rows=CKPT_PROBE_ROWS)
    inp["ckpt_probe_rows"] = np.asarray(CKPT_PROBE_ROWS)


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    rng = np.random.default_rng(2024)
    params = perturbed_params(CFG, rng)
    heads = _heads(CFG.d_model, rng)
    jp = jax.tree.map(jnp.asarray, params)
    inp = {"model/cfg": cfg_json(CFG), "max_len": np.asarray(MAX_LEN),
           "gamma": np.asarray(GAMMA), "prompt": np.asarray(PROMPT),
           "eos": np.asarray(EOS), "n_blocks": np.asarray(len(BLOCKS))}
    inp.update(flatten(params, "model/p"))
    inp.update(flatten(heads, "model/heads"))
    ref = {}
    _block_cases(jp, rng, inp, ref)
    hs = (0.7 * rng.standard_normal((3, CFG.d_model))).astype(np.float32)
    inp["heads/h"] = hs
    ref["medusa_logits"] = np.asarray(medusa_logits(_jheads(heads), jp,
                                                    jnp.asarray(hs)))
    probe_ids = rng.integers(1, CFG.vocab_size, (8, CFG.seq_len)).astype(
        np.int32)
    probe_ids[:, -5:] = 0
    inp["probe/ids"] = probe_ids
    ref["probe"] = probe_acceptance(jp, CFG, _jheads(heads), probe_ids, 0)
    _run_cases(jp, heads, inp, ref)
    _pipeline_cases(rng, inp, ref)
    _checkpoint_probe_cases(inp, ref)
    for tag, path in DEMOS.items():
        inp[f"demo/{tag}"] = np.asarray(str(path))
    got = run_worker("medusa", inp, tmp_path_factory.mktemp("medusa"),
                     timeout=900)
    return got, ref


def _sse(body: np.ndarray) -> list:
    return [json.loads(b[len(b"data: "):])
            for b in body.tobytes().split(b"\n\n") if b]


def _ids(events):
    return [i for e in events if e["event"] == "tokens" for i in e["ids"]]


@pytest.mark.parametrize("case", range(len(BLOCKS)))
def test_decode_block_matches_jax(results, case):
    got, ref = results
    logits, h, caches, length = ref[("block", case)]
    np.testing.assert_allclose(got[f"block/{case}/logits"], logits,
                               atol=BLOCK_TOL, rtol=0)
    np.testing.assert_allclose(got[f"block/{case}/hidden"], h,
                               atol=BLOCK_TOL, rtol=0)
    for j, c in enumerate(caches):
        np.testing.assert_allclose(got[f"block/{case}/cache/{j}"], c,
                                   atol=BLOCK_TOL, rtol=0)
    assert int(got[f"block/{case}/length"][0]) == length


def test_medusa_logits_match_jax(results):
    got, ref = results
    assert got["medusa_logits"].shape == ref["medusa_logits"].shape
    np.testing.assert_allclose(got["medusa_logits"], ref["medusa_logits"],
                               atol=BLOCK_TOL, rtol=0)


@pytest.mark.parametrize("name", list(RUNS))
def test_generate_medusa_matches_jax(results, name):
    got, ref = results
    toks, steps = ref[("run", name)]
    np.testing.assert_array_equal(got[f"run/{name}/tokens"], toks)
    assert int(got[f"run/{name}/steps"]) == steps


@pytest.mark.parametrize("seed", (0, 1, 2))
def test_sampled_proposals_get_accepted(results, seed):
    """A sampled run takes fewer verify steps than it makes tokens, so the
    acceptance path is exercised, not only the residual and the bonus."""
    got, _ = results
    n = len(got[f"run/seed{seed}/tokens"]) - len(PROMPT)
    assert int(got[f"run/seed{seed}/steps"]) < n - 1


def test_greedy_medusa_equals_greedy_generate_kv(results):
    got, ref = results
    np.testing.assert_array_equal(got["run/greedy/tokens"], got["kv_greedy"])
    np.testing.assert_array_equal(got["kv_greedy"], ref["kv_greedy"])


@pytest.mark.parametrize("name", STREAMS)
def test_medusa_stream_equals_one_shot(results, name):
    got, ref = results
    one_shot = got[f"run/{name}/tokens"][len(PROMPT):]
    np.testing.assert_array_equal(got[f"stream/{name}"], one_shot)
    np.testing.assert_array_equal(got[f"stream/{name}"],
                                  ref[("stream", name)])


@pytest.mark.parametrize("tag", list(DEMOS))
def test_shipped_heads_load_as_jax(results, tag):
    got, _ = results
    want = load_medusa_heads(str(DEMOS[tag] / "medusa_heads.pkl"))
    assert int(got[f"demo/{tag}/n"]) == len(want["blocks"])
    for i, blk in enumerate(want["blocks"]):
        for k in ("w", "b"):
            a = got[f"demo/{tag}/{i}/{k}"]
            assert a.dtype == np.float32
            np.testing.assert_array_equal(a, np.asarray(blk[k]))
    assert json.loads(str(got[f"demo/{tag}/probe"])) == \
        json.loads(json.dumps(want["probe"]))


def test_probe_acceptance_matches_jax(results):
    got, ref = results
    _close_probes(json.loads(str(got["probe"])), ref["probe"], PROBE_TOL)


def _close_probes(probe: dict, want: dict, tol: float) -> None:
    assert set(probe) == set(want)
    for k, v in want.items():
        if isinstance(v, list):
            np.testing.assert_allclose(probe[k], v, atol=tol)
        elif isinstance(v, bool) or k == "rows":
            assert probe[k] == v, k
        else:
            assert abs(probe[k] - v) <= tol, (k, probe[k], v)


@pytest.mark.parametrize("kind", ("synthetic", "grid"))
def test_probe_corpora_equal_jax(results, kind):
    got, ref = results
    assert json.loads(str(got[f"corpus/{kind}"])) == ref[f"corpus/{kind}"]


def test_checkpoint_probe_matches_jax(results):
    """A heads file without a probe is probed at start-up over held-out
    rows of the checkpoint's scheme: the port's probe is JAX's."""
    got, ref = results
    _close_probes(json.loads(str(got["ckpt_probe"])), ref["ckpt_probe"],
                  CKPT_PROBE_TOL)


@pytest.mark.parametrize("tag", PIPES)
def test_pipeline_medusa_bytes_equal_jax(results, tag):
    got, ref = results
    assert got[f"pipe/{tag}/oneshot"].tobytes() == ref[(tag, "oneshot")]


@pytest.mark.parametrize("tag", PIPES)
def test_pipeline_medusa_stream_equals_jax(results, tag):
    got, ref = results
    events = json.loads(str(got[f"pipe/{tag}/stream"]))
    want = ref[(tag, "stream")]
    assert _ids(events) == _ids(want)
    assert events[-1]["midi_b64"] == want[-1]["midi_b64"]


def test_http_medusa_oneshot_and_stream(results):
    got, ref = results
    assert int(got["http/oneshot/status"]) == 200
    assert got["http/oneshot/body"].tobytes() == ref[("b3", "oneshot")]
    assert int(got["http/stream/status"]) == 200
    events = _sse(got["http/stream/body"])
    assert [e["event"] for e in events][0] == "meta"
    assert events[-1]["event"] == "done"
    done = base64.b64decode(events[-1]["midi_b64"])
    assert done == base64.b64decode(ref[("b3", "stream")][-1]["midi_b64"])


# name -> (status, what the error names)
CONTRACT = {
    "no_heads": (422, "Medusa heads"),
    "no_heads_stream": (422, "Medusa heads"),
    "stream_penalty": (422, "medusa does not compose"),
    "lookup_stream": (422, "lookup does not stream"),
    "beams_stream": (422, "beams is a whole-block"),
    "lookup_and_medusa": (422, "mutually exclusive"),
    "beams_too_many": (422, "beams must be in [0, 16]"),
    "beams_and_penalty": (422, "beams is a deterministic"),
    "grammar": (422, "grammar"),
}


@pytest.mark.parametrize("name", list(CONTRACT))
def test_http_contract(results, name):
    got, _ = results
    status, what = CONTRACT[name]
    assert int(got[f"contract/{name}/status"]) == status
    assert str(got[f"contract/{name}/type"]).startswith("application/json")
    assert what in json.loads(got[f"contract/{name}/body"].tobytes())[
        "error"]


def test_stats_carry_the_medusa_probe(results):
    got, _ = results
    stats = json.loads(got["http/stats"].tobytes())
    assert stats["medusa_probe"] == {"tok_per_verify_est": 1.5,
                                     "likely_win": True}
    assert "medusa_probe" not in json.loads(got["http/stats_none"].tobytes())


def test_heads_of_another_width_are_refused(results):
    got, _ = results
    assert "d_model=" in str(got["mismatch/unavailable"])
    assert str(got["mismatch/heads"]) == "None"
