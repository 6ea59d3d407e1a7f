"""The port's serving slice against the JAX package, on the CPU.

Same inputs (numpy, from a seed) and the same weights (JAX parameter
trees carried over as numpy arrays through ``params_from_jax``) go through
the JAX package here and through ``eamg_tpu_torch`` in one subprocess
(tests/torch_port_worker.py); torch never enters this process.

Checked, with the tolerance and its reason:
- the GPT model on three small configs (post-LN causal ReLU GQA; pre-LN
  GELU GQA with the pos-broadcast quirk; MHA with the batch-first quirk):
  f32 logits of ``forward``, ``prefill`` and teacher-forced
  ``decode_step`` to 1e-4 (f32 sums in other orders, over two layers);
  greedy and seeded sampled ``generate_kv`` streams token-equal (the
  threefry port draws the same Gumbel noise), also with top-p, min-p and
  pre-split keys;
- the threefry port: keys, splits, bits and uniforms bit-equal to
  ``jax.random``, categorical draws equal;
- the flagship ``demo_ckpt_a``: the loader (no ml_dtypes) gives JAX's
  shapes, and f32 logits of a 16-token prompt match to 1e-3 (|logit| up
  to ~30, six layers);
- the DistilBERT classifier: probabilities to 1e-5 and labels equal on
  all 168 items of emotion/frozen_exam.json; so are the lexicon
  backend's labels;
- the additive synth: the waveform of a song with drums to 1e-5;
- the pipeline on the JAX demo_pipeline geometry: same-seed MIDI bytes
  equal;
- the HTTP contract of the port's server (penalties, n-gram bans and
  ``beams`` are served, by the solo decode);
- ``cli serve --coalesce`` (a subprocess of the worker, on the CPU) on a
  checkpoint of the causal demo_pipeline geometry: concurrent same-seed
  requests return the MIDI bytes of the JAX pipeline built with
  ``coalesce="continuous"``, a request the engine does not accept (another
  top_k) is decoded solo with the JAX pipeline's bytes, ``/stats`` shows
  the engine, SIGTERM drains and exits 0; a full admission queue answers
  503 with ``Retry-After``.
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from eamg_tpu.audio.synth import render_song
from eamg_tpu.decode.loop import generate_kv
from eamg_tpu.emotion import EmotionClassifier
from eamg_tpu.midi.smf import Instrument, MidiSong, Note
from eamg_tpu.models.gpt import (GPTConfig, decode_step, forward,
                                 init_kv_cache, init_params, prefill)
from eamg_tpu.serve.pipeline import demo_pipeline
from eamg_tpu.utils.checkpoint import load_checkpoint, save_checkpoint

from port_harness import cfg_json, flatten, run_worker

REPO = Path(__file__).resolve().parents[1]
DEMO_A = REPO / "eamg_tpu" / "serve" / "demo_ckpt_a"
EXAM = REPO / "eamg_tpu" / "emotion" / "frozen_exam.json"

MODEL_CFGS = {
    "post_relu": GPTConfig(vocab_size=97, seq_len=48, d_model=64, n_head=4,
                           n_layer=2, n_kv_heads=2, causal=True),
    "pre_gelu_posbug": GPTConfig(vocab_size=97, seq_len=48, d_model=64,
                                 n_head=4, n_layer=2, n_kv_heads=2,
                                 ln_placement="pre", activation="gelu",
                                 pos_rows=48, pos_broadcast_bug=True),
    # the train_mini quirk: forward() reads [B, T, C] as [T, B, C]
    "mha_batch_first_bug": GPTConfig(vocab_size=97, seq_len=48, d_model=64,
                                     n_head=4, n_layer=2, pos_rows=48,
                                     batch_first_bug=True),
}
SEEDS = (0, 1, 2)
TOP_K, TEMPERATURE, EOS = 20, 1.0, 3
# every filter the server exposes at once, and the pre-split key schedule
FILTERS = {"seed": 4, "top_k": 30, "temperature": 0.9, "top_p": 0.9,
           "min_p": 0.05}
PRNG_SEEDS = (0, 1, 42, 2**31 - 1, -3, 2**32 + 5)
PRNG_SHAPES = [(7,), (3, 5), (2, 3, 4)]
SONG = [  # (program, is_drum, [(velocity, pitch, start, end)])
    (0, False, [(90, 60, 0.0, 0.5), (80, 64, 0.25, 1.0), (70, 67, 1.0, 4.8)]),
    (40, False, [(100, 72, 0.5, 1.5), (60, 76, 2.0, 2.25)]),
    (0, True, [(110, 36, 0.0, 0.1), (90, 38, 0.5, 0.6), (100, 42, 1.25, 1.3),
               (80, 36, 5.2, 5.4)]),
]
REQUESTS = [("I finally got the job, I am so happy!", 5),
            ("my dog died and I cannot stop crying", 9)]
# coalesced serving: (text, seed, extra form fields); the first three run
# concurrently with one seed, the last asks for a top_k the engine lacks
CO_ENGINE = {"slots": 4, "chunk": 8}
CO_REQUESTS = [("I finally got the job, I am so happy!", 5, {}),
               ("I finally got the job, I am so happy!", 5, {}),
               ("I finally got the job, I am so happy!", 5, {}),
               ("my dog died and I cannot stop crying", 9, {}),
               ("my dog died and I cannot stop crying", 9, {"top_k": 7})]
HTTP = {  # name: (status, what the body starts with or the error says)
    "wav": (200, b"RIFF"), "midi": (200, b"MThd"),
    "stream": (200, b"data: {"), "beams": (200, b"RIFF"),
    # penalties and n-gram bans decode solo
    "penalty": (200, b"RIFF"), "ngram": (200, b"MThd"),
    "bad_ngram": (422, "no_repeat_ngram"), "bad_seed": (422, "seed"),
    "no_prompt": (422, "prompt"), "healthz": (200, b"{"),
    "stats": (200, b"{"), "profile": (200, b'{"trace_dir"'),
}


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _model_case(tag, cfg, rng, inp, ref):
    params = _np_tree(init_params(jax.random.PRNGKey(7), cfg))
    # the JAX init leaves pos at zero and LayerNorms at identity: perturb
    # them so positions and LN parameters matter
    params["pos"] = (0.5 * rng.standard_normal(params["pos"].shape)
                     ).astype(np.float32)
    for lp in params["layers"]:
        for ln in ("ln1", "ln2"):
            lp[ln]["g"] = (1 + 0.1 * rng.standard_normal(
                lp[ln]["g"].shape)).astype(np.float32)
            lp[ln]["b"] = (0.1 * rng.standard_normal(
                lp[ln]["b"].shape)).astype(np.float32)
    ids = rng.integers(0, cfg.vocab_size, (2, 12)).astype(np.int32)
    plen, max_len = 9, 40
    forced = rng.integers(0, cfg.vocab_size, (3,)).astype(np.int32)
    gen_plen = 5
    gen_prompt = np.zeros((1, 16), np.int32)
    gen_prompt[0, :gen_plen] = rng.integers(4, cfg.vocab_size, gen_plen)
    inp.update(flatten(params, f"{tag}/p"))
    inp.update({f"{tag}/cfg": cfg_json(cfg), f"{tag}/ids": ids,
                f"{tag}/plen": np.asarray(plen),
                f"{tag}/max_len": np.asarray(max_len),
                f"{tag}/forced": forced, f"{tag}/gen_prompt": gen_prompt,
                f"{tag}/gen_plen": np.asarray(gen_plen),
                f"{tag}/gen_max_len": np.asarray(max_len)})
    jp = jax.tree.map(jnp.asarray, params)
    ref[f"{tag}/forward"] = np.asarray(forward(jp, jnp.asarray(ids), cfg))
    cache = init_kv_cache(cfg, 2, max_len)
    logits, cache = jax.jit(prefill, static_argnums=(2,))(
        jp, jnp.asarray(ids), cfg, cache, plen)
    ref[f"{tag}/prefill"] = np.asarray(logits)
    step = jax.jit(decode_step, static_argnums=(3,))
    last, steps = jnp.asarray(ids[:, plen - 1:plen]), []
    for tok in forced:
        lg, cache = step(jp, last, cache, cfg)
        steps.append(np.asarray(lg))
        last = jnp.full_like(last, int(tok))
    ref[f"{tag}/decode"] = np.stack(steps)
    buf, n = generate_kv(jp, jnp.asarray(gen_prompt), gen_plen,
                         jax.random.PRNGKey(0), cfg, max_len, greedy=True,
                         eos_id=EOS)
    ref[f"{tag}/greedy"] = np.asarray(buf)[:, :int(n)]
    for seed in SEEDS:
        buf, n = generate_kv(jp, jnp.asarray(gen_prompt), gen_plen,
                             jax.random.PRNGKey(seed), cfg, max_len,
                             top_k=TOP_K, temperature=TEMPERATURE,
                             eos_id=EOS)
        ref[f"{tag}/sampled{seed}"] = np.asarray(buf)[:, :int(n)]
    f = FILTERS
    buf, n = generate_kv(jp, jnp.asarray(gen_prompt), gen_plen,
                         jax.random.PRNGKey(f["seed"]), cfg, max_len,
                         top_k=f["top_k"], temperature=f["temperature"],
                         top_p=f["top_p"], min_p=f["min_p"], eos_id=EOS,
                         presplit_keys=True)
    ref[f"{tag}/filtered"] = np.asarray(buf)[:, :int(n)]


def _prng_case(rng, inp, ref):
    logits = rng.standard_normal((4, 11)).astype(np.float32)
    inp.update({"prng_seeds": np.asarray(PRNG_SEEDS, np.int64),
                "prng_shapes": np.asarray(json.dumps(PRNG_SHAPES)),
                "prng_logits": logits})
    for seed in PRNG_SEEDS:
        key = jax.random.PRNGKey(seed)
        kd = jax.random.key_data
        ref[f"prng/{seed}/key"] = np.asarray(kd(key))
        ref[f"prng/{seed}/split2"] = np.asarray(kd(jax.random.split(key)))
        ref[f"prng/{seed}/split5"] = np.asarray(kd(jax.random.split(key,
                                                                    5)))
        for i, shape in enumerate(PRNG_SHAPES):
            ref[f"prng/{seed}/bits{i}"] = np.asarray(
                jax.random.bits(key, shape, jnp.uint32))
            ref[f"prng/{seed}/uniform{i}"] = np.asarray(
                jax.random.uniform(key, shape, jnp.float32, -2.0, 3.0))
        ref[f"prng/{seed}/categorical"] = np.asarray(
            jax.random.categorical(key, jnp.asarray(logits)))


def _flagship_case(rng, inp, ref):
    ck = load_checkpoint(str(DEMO_A))
    shapes = []
    for path, leaf in jax.tree_util.tree_flatten_with_path(ck["params"])[0]:
        p = "".join(f"/{getattr(k, 'key', getattr(k, 'idx', k))}"
                    for k in path)
        shapes.append(f"{p}:{tuple(leaf.shape)}:{leaf.dtype}")
    ref["flagship/shapes"] = np.asarray(sorted(shapes))
    cfg = dataclasses.replace(ck["cfg"], dtype="float32")
    ids = rng.integers(0, cfg.vocab_size, (1, 16)).astype(np.int32)
    inp["flagship/ids"] = ids
    ref["flagship/logits"] = np.asarray(forward(
        jax.tree.map(jnp.asarray, ck["params"]), jnp.asarray(ids), cfg))


def _classifier_case(inp, ref):
    texts = [row["text"] for row in json.loads(EXAM.read_text())]
    inp["clf/texts"] = np.asarray(json.dumps(texts))
    clf = EmotionClassifier()
    ref["clf/probs"] = np.stack([clf._probs(t) for t in texts])
    ref["clf/labels"] = np.asarray([clf.predict(t) for t in texts])
    lex = EmotionClassifier(backend="lexicon")
    ref["clf/lexicon"] = np.asarray([lex.predict(t) for t in texts])


def _synth_case(inp, ref):
    song = MidiSong()
    for prog, drum, notes in SONG:
        inst = Instrument(program=prog, is_drum=drum)
        inst.notes.extend(Note(*n) for n in notes)
        song.instruments.append(inst)
    inp["synth/song"] = np.asarray(json.dumps(SONG))
    inp["synth/seed"] = np.asarray(3)
    ref["synth/wave"] = render_song(song, seed=3)


def _pipeline_case(inp, ref):
    pipe = demo_pipeline()
    gen = pipe.generator
    inp.update(flatten(_np_tree(gen.params), "pipe/p"))
    inp["pipe/cfg"] = cfg_json(gen.cfg)
    inp["pipe/vocab"] = np.asarray(json.dumps(gen.vocab.tok2id))
    inp["pipe/requests"] = np.asarray(json.dumps(REQUESTS))
    for i, (text, seed) in enumerate(REQUESTS):
        r = pipe.generate(text, seed=seed, render_audio=False)
        ref[f"pipe/{i}/midi"] = np.frombuffer(r.midi_bytes, np.uint8)
        ref[f"pipe/{i}/label"] = np.asarray(r.label)


def _coalesce_case(inp, ref, ckpt_dir):
    pipe = demo_pipeline(corrected=True, coalesce="continuous",
                         coalesce_opts=CO_ENGINE)
    try:
        gen = pipe.generator
        save_checkpoint(str(ckpt_dir), gen.params, gen.vocab.tok2id, gen.cfg)
        inp["co/ckpt"] = np.asarray(str(ckpt_dir))
        inp["co/engine"] = np.asarray(json.dumps(CO_ENGINE))
        inp["co/requests"] = np.asarray(json.dumps(CO_REQUESTS))
        for i, (text, seed, extra) in enumerate(CO_REQUESTS):
            r = pipe.generate(text, seed=seed, render_audio=False, **extra)
            ref[f"co/{i}/midi"] = np.frombuffer(r.midi_bytes, np.uint8)
    finally:
        pipe.batcher.close()


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    rng = np.random.default_rng(2024)
    inp, ref = {"seeds": np.asarray(SEEDS), "top_k": np.asarray(TOP_K),
                "filters": np.asarray(json.dumps(FILTERS)),
                "temperature": np.asarray(TEMPERATURE),
                "eos": np.asarray(EOS),
                "model_tags": np.asarray(json.dumps(list(MODEL_CFGS)))}, {}
    for tag, cfg in MODEL_CFGS.items():
        _model_case(tag, cfg, rng, inp, ref)
    _prng_case(rng, inp, ref)
    _flagship_case(rng, inp, ref)
    _classifier_case(inp, ref)
    _synth_case(inp, ref)
    _pipeline_case(inp, ref)
    _coalesce_case(inp, ref, tmp_path_factory.mktemp("co_ckpt"))
    got = run_worker("slice", inp, tmp_path_factory.mktemp("slice"),
                     timeout=900)
    return got, ref


@pytest.mark.parametrize("tag", list(MODEL_CFGS))
@pytest.mark.parametrize("what", ["forward", "prefill", "decode"])
def test_model_logits_match_jax(results, tag, what):
    got, ref = results
    np.testing.assert_allclose(got[f"{tag}/{what}"], ref[f"{tag}/{what}"],
                               rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("tag", list(MODEL_CFGS))
def test_greedy_stream_equal(results, tag):
    got, ref = results
    np.testing.assert_array_equal(got[f"{tag}/greedy"], ref[f"{tag}/greedy"])


@pytest.mark.parametrize("tag", list(MODEL_CFGS))
@pytest.mark.parametrize("seed", SEEDS)
def test_sampled_stream_equal(results, tag, seed):
    got, ref = results
    np.testing.assert_array_equal(got[f"{tag}/sampled{seed}"],
                                  ref[f"{tag}/sampled{seed}"])


@pytest.mark.parametrize("tag", list(MODEL_CFGS))
def test_filtered_presplit_stream_equal(results, tag):
    """temperature, top-k, top-p and min-p together, pre-split keys."""
    got, ref = results
    np.testing.assert_array_equal(got[f"{tag}/filtered"],
                                  ref[f"{tag}/filtered"])


@pytest.mark.parametrize("seed", PRNG_SEEDS)
@pytest.mark.parametrize("what", ["key", "split2", "split5", "bits",
                                  "uniform", "categorical"])
def test_threefry_matches_jax(results, seed, what):
    got, ref = results
    if what in ("bits", "uniform"):
        for i in range(len(PRNG_SHAPES)):
            a, b = got[f"prng/{seed}/{what}{i}"], ref[f"prng/{seed}/{what}{i}"]
            assert a.shape == b.shape
            np.testing.assert_array_equal(a.view(np.uint32),
                                          b.view(np.uint32))
        return
    np.testing.assert_array_equal(got[f"prng/{seed}/{what}"],
                                  ref[f"prng/{seed}/{what}"])


def test_flagship_loads_with_jax_shapes(results):
    got, ref = results
    assert list(got["flagship/shapes"]) == list(ref["flagship/shapes"])


def test_flagship_f32_logits_match_jax(results):
    got, ref = results
    np.testing.assert_allclose(got["flagship/logits"], ref["flagship/logits"],
                               rtol=1e-3, atol=1e-3)


def test_classifier_probs_match_jax(results):
    got, ref = results
    np.testing.assert_allclose(got["clf/probs"], ref["clf/probs"],
                               rtol=1e-5, atol=1e-5)


def test_classifier_labels_equal_on_frozen_exam(results):
    got, ref = results
    assert len(ref["clf/labels"]) == 168
    np.testing.assert_array_equal(got["clf/labels"], ref["clf/labels"])


def test_lexicon_backend_labels_equal(results):
    got, ref = results
    np.testing.assert_array_equal(got["clf/lexicon"], ref["clf/lexicon"])


def test_additive_synth_matches_jax(results):
    got, ref = results
    assert got["synth/wave"].shape == ref["synth/wave"].shape
    np.testing.assert_allclose(got["synth/wave"], ref["synth/wave"],
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("i", range(len(REQUESTS)))
def test_pipeline_same_seed_midi_bytes(results, i):
    got, ref = results
    assert str(got[f"pipe/{i}/label"]) == str(ref[f"pipe/{i}/label"])
    assert got[f"pipe/{i}/midi"].tobytes() == ref[f"pipe/{i}/midi"].tobytes()


@pytest.mark.parametrize("name", list(HTTP))
def test_server_contract(results, name):
    got, _ = results
    status, expect = HTTP[name]
    assert int(got[f"http/{name}/status"]) == status
    if isinstance(expect, bytes):
        assert got[f"http/{name}/head"].tobytes().startswith(expect)
    else:
        assert expect in str(got[f"http/{name}/error"])


@pytest.mark.parametrize("i", range(len(CO_REQUESTS)))
def test_coalesced_server_midi_bytes_equal_jax(results, i):
    """Requests 0-3 run concurrently through `cli serve --coalesce`;
    request 4's top_k is not the engine's, so it is decoded solo."""
    got, ref = results
    assert int(got[f"co/{i}/status"]) == 200
    assert got[f"co/{i}/midi"].tobytes() == ref[f"co/{i}/midi"].tobytes()


def test_coalesced_server_used_the_engine_and_drained(results):
    got, _ = results
    eng = json.loads(str(got["co/stats"]))["engine"]
    # the first lone request may take the detached bypass; the concurrent
    # followers join the engine
    assert eng["served"] >= 2 and eng["chunks"] > 0
    assert eng["served"] == eng["admitted"]
    assert "p50_join_ms" in eng and eng["free_slots"] == CO_ENGINE["slots"]
    assert int(got["co/exit_code"]) == 0
    assert "drain" in str(got["co/tail"])


def test_full_queue_answers_503_with_retry_after(results):
    got, _ = results
    statuses = got["overload/statuses"].tolist()
    assert set(statuses) <= {200, 503}
    assert 200 in statuses and 503 in statuses
    assert str(got["overload/retry_after"]) == "1"
    assert "queue full" in str(got["overload/error"])
    assert int(got["overload/rejected"]) == statuses.count(503)


# the engine options the JAX server builds from each flag (with --coalesce);
# --engine-medusa goes to the pipeline (``engine_medusa``), as in JAX
ENGINE_FLAG_OPTS = {"--engine-medusa": {},
                    "--engine-grammar": {"grammar": True},
                    "--engine-ngram": {"no_repeat_ngram": 3}}


@pytest.mark.parametrize("flag", ["--engine-medusa", "--engine-grammar",
                                  "--engine-ngram"])
def test_cli_names_engine_modes_outside_the_port(results, flag):
    """Every engine mode of the JAX server is in the port now: no flag
    exits 2. --engine-grammar and --engine-ngram 3 build the engine
    options the JAX server builds (``coalesce_opts``); --engine-medusa
    reaches the pipeline as ``engine_medusa``."""
    got, _ = results
    stderr = str(got[f"cli/{flag}/stderr"])
    assert json.loads(str(got[f"cli/{flag}/opts"])) == ENGINE_FLAG_OPTS[flag]
    assert int(got[f"cli/{flag}/code"]) == 0
    assert "not yet in the PyTorch port" not in stderr
    assert bool(got[f"cli/{flag}/engine_medusa"]) == (
        flag == "--engine-medusa")
