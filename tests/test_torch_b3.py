"""Scheme-B3 serving in the port against the JAX package, on the CPU.

Same inputs (numpy, from a seed) and the same weights go through the JAX
package here and through ``eamg_tpu_torch`` in one subprocess
(tests/torch_port_worker.py, task ``b3``); torch never enters this
process.

Checked, with the tolerance and its reason:
- the shipped ``demo_ckpt_b3`` (d192 h4, so Dh 48; MHA; V 8579; bf16,
  ``kernels="xla"``): the loader gives JAX's tree shapes; f32 logits of a
  16-token prompt match to 1e-3 (as the flagship's); its bf16
  teacher-forced logits (``prefill`` and 32 ``decode_step``) stay within
  JAX's own spread, as tests/test_torch_bf16.py holds the flagship: max
  |delta logit| <= 2 against JAX compiled as served, and at least 75% of
  the argmaxes equal (one bf16 rounding that falls the other way in a sum
  of another order moves a post-LN model's logits by up to ~1);
- in f32, the checkpoint's same-seed ``generate_ids`` from a control
  prefix: token-equal to JAX's;
- the B3 pipeline on JAX's ``demo_pipeline_b3`` geometry (f32): same-seed
  MIDI bytes of ``generate`` and ``generate_sections`` equal JAX's;
- ``pipeline_from_checkpoint`` on ``demo_ckpt_b3``: the B3 pipeline, EOS
  ``[END_SEQ]``, coalescing switched off (it serves solo, as in JAX), and
  ``POST /generate`` answers WAV and MIDI; a Scheme-B2 checkpoint is
  refused with JAX's ValueError; ``cli generate`` on B3 writes MThd and
  RIFF....WAVE from the control prefix of ``--bpm`` and ``--key`` and
  exits 2 on a B2 checkpoint;
- rows 7, 9 and 10 (``flash_decode_fold``, ``_fold2``, ``_fold3``), whose
  CUDA kernel now takes Dh 48: their plain versions at B3's heads (Dh 48,
  MHA, M 256) against JAX's Pallas kernels in interpret mode, to 1e-5.
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from eamg_tpu.decode import Generator
from eamg_tpu.models.gpt import (GPTConfig, decode_step, forward,
                                 init_kv_cache, init_params, prefill)
from eamg_tpu.ops.decode_fold import (flash_decode_fold, flash_decode_fold2,
                                      flash_decode_fold3)
from eamg_tpu.serve.pipeline import demo_pipeline_b3
from eamg_tpu.tokenizer import SchemeB2, SchemeB3, Vocab
from eamg_tpu.utils.checkpoint import load_checkpoint, save_checkpoint

from port_harness import cfg_json, flatten, run_worker

REPO = Path(__file__).resolve().parents[1]
DEMO_B3 = REPO / "eamg_tpu" / "serve" / "demo_ckpt_b3"
PROMPT, FORCED = 16, 32
TF_TOL, ARGMAX_MIN = 2.0, 0.75
LOGITS_TOL = 1e-3
# f32 generate_ids from a control prefix: (bpm, key, seed), max_len
GEN_CASES = ((120, "C major", 3), (72, "A minor", 11))
GEN_MAX_LEN = 48
TEXT = "I finally got the job, I am so happy!"
TEXT3 = ("I finally got the job, I am so happy! Then the rain came and I "
         "miss you. Why would they do that to me, I am furious.")
PIPE_REQS = ((TEXT, 5), ("my dog died and I cannot stop crying", 9))
SECTIONS_SEED = 7
# rows 7, 9 and 10 at Dh 48: B 4, MHA H 4, M 256, t a row and a scalar
FOLD48 = {"B": 4, "H": 4, "M": 256}
FOLD48_TS = {"rows": np.asarray([255, 17, 0, 130], np.int32), "t100": 100}
FOLDS = {"flash_decode_fold": flash_decode_fold,
         "flash_decode_fold2": flash_decode_fold2,
         "flash_decode_fold3": flash_decode_fold3}
FOLD_TOL = 1e-5


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _f32(tree):
    return jax.tree.map(lambda a: jnp.asarray(a, jnp.float32), tree)


def _ckpt_cases(rng, inp, ref):
    ck = load_checkpoint(str(DEMO_B3))
    cfg = ck["cfg"]
    assert (cfg.d_model, cfg.n_head, cfg.dtype, cfg.kernels) == \
        (192, 4, "bfloat16", "xla")
    shapes = []
    for path, leaf in jax.tree_util.tree_flatten_with_path(ck["params"])[0]:
        p = "".join(f"/{getattr(k, 'key', getattr(k, 'idx', k))}"
                    for k in path)
        shapes.append(f"{p}:{tuple(leaf.shape)}:{leaf.dtype}")
    ref["shapes"] = np.asarray(sorted(shapes))
    ids = rng.integers(0, cfg.vocab_size, (1, PROMPT)).astype(np.int32)
    forced = rng.integers(0, cfg.vocab_size, (FORCED,)).astype(np.int32)
    inp["tf/ids"], inp["tf/forced"] = ids, forced
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    p32 = _f32(ck["params"])
    ref["logits"] = np.asarray(forward(p32, jnp.asarray(ids), cfg32))
    params = jax.tree.map(jnp.asarray, ck["params"])
    for how, run in (("tf", jax.jit), ("tf_eager", lambda f: f)):
        cache = init_kv_cache(cfg, 1, PROMPT + FORCED)
        logits, cache = run(lambda p, i, c: prefill(p, i, cfg, c))(
            params, jnp.asarray(ids), cache)
        out = [np.asarray(logits[0], np.float32)]
        last = ids[:, -1:]
        step = run(lambda p, i, c: decode_step(p, i, c, cfg))
        for tok in forced:
            lg, cache = step(params, jnp.asarray(last), cache)
            out.append(np.asarray(lg, np.float32))
            last = np.full((1, 1), tok, np.int32)
        ref[how] = np.concatenate(out)
    b3 = SchemeB3(seq_len=cfg.seq_len)
    gen = Generator(p32, cfg32, Vocab(ck["vocab"]), eos_token="[END_SEQ]")
    for i, (bpm, key, seed) in enumerate(GEN_CASES):
        ref[("gen", i)] = np.asarray(gen.generate_ids(
            b3.control_prefix(bpm, key), max_len=GEN_MAX_LEN,
            seed=seed)[0])
    inp["gen/cases"] = np.asarray(json.dumps(GEN_CASES))
    inp["gen/max_len"] = np.asarray(GEN_MAX_LEN)


def _pipeline_cases(inp, ref):
    pipe = demo_pipeline_b3()
    gen = pipe.generator
    inp.update(flatten(_np_tree(gen.params), "b3/p"))
    inp["b3/cfg"] = cfg_json(gen.cfg)
    inp["b3/vocab"] = np.asarray(json.dumps(gen.vocab.tok2id))
    inp["pipe/requests"] = np.asarray(json.dumps(PIPE_REQS))
    for i, (text, seed) in enumerate(PIPE_REQS):
        r = pipe.generate(text, seed=seed, render_audio=False)
        ref[("pipe", i)] = r.midi_bytes
        ref[("pipe_tokens", i)] = r.tokens
    inp["pipe/text3"] = np.asarray(TEXT3)
    inp["pipe/sections_seed"] = np.asarray(SECTIONS_SEED)
    ref["sections"] = pipe.generate_sections(
        TEXT3, seed=SECTIONS_SEED, render_audio=False).midi_bytes


def _b2_checkpoint(path):
    """A tiny random Scheme-B2 model: a vocabulary with no control
    tokens."""
    vocab = SchemeB2(seq_len=32).vocab
    cfg = GPTConfig(vocab_size=len(vocab), seq_len=32, d_model=32,
                    n_head=2, n_layer=1, causal=True)
    save_checkpoint(str(path), init_params(jax.random.PRNGKey(0), cfg),
                    vocab.tok2id, cfg)


def _fold_cases(rng, inp, ref):
    B, H, M = FOLD48["B"], FOLD48["H"], FOLD48["M"]
    D = H * 48
    q = rng.standard_normal((B, 1, D), np.float32)
    kv = rng.standard_normal((B, M, 2 * D), np.float32)
    inp["fold/q"], inp["fold/kv"] = q, kv
    inp["fold/H"] = np.asarray(H)
    for tname, t in FOLD48_TS.items():
        inp[f"fold/t/{tname}"] = np.asarray(t, np.int32)
        for name, fn in FOLDS.items():
            ref[("fold", name, tname)] = np.asarray(fn(
                jnp.asarray(q), jnp.asarray(kv), jnp.asarray(t), H,
                interpret=True))


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    rng = np.random.default_rng(303)
    inp, ref = {}, {}
    _ckpt_cases(rng, inp, ref)
    _pipeline_cases(inp, ref)
    b2 = tmp_path_factory.mktemp("b2_ckpt")
    _b2_checkpoint(b2)
    inp["b2/ckpt"] = np.asarray(str(b2))
    _fold_cases(rng, inp, ref)
    got = run_worker("b3", inp, tmp_path_factory.mktemp("b3"), timeout=900)
    return got, ref


def test_demo_ckpt_b3_loads_with_jax_shapes(results):
    got, ref = results
    assert list(got["shapes"]) == list(ref["shapes"])


def test_demo_ckpt_b3_f32_logits_match_jax(results):
    got, ref = results
    np.testing.assert_allclose(got["logits"], ref["logits"],
                               rtol=LOGITS_TOL, atol=LOGITS_TOL)


def test_demo_ckpt_b3_bf16_teacher_forced_within_jax_spread(results):
    got, ref = results
    a, b = got["tf"], ref["tf"]
    assert a.shape == b.shape == (PROMPT + FORCED, 8579)
    assert np.isfinite(a).all()
    assert np.abs(a - b).max() <= TF_TOL, (
        np.abs(a - b).max(), np.abs(ref["tf_eager"] - b).max())


def test_demo_ckpt_b3_bf16_argmaxes_agree(results):
    got, ref = results
    agree = (got["tf"].argmax(-1) == ref["tf"].argmax(-1)).mean()
    assert agree >= ARGMAX_MIN, agree


@pytest.mark.parametrize("i", range(len(GEN_CASES)))
def test_demo_ckpt_b3_f32_generate_ids_equal_jax(results, i):
    got, ref = results
    np.testing.assert_array_equal(got[f"gen/{i}"], ref[("gen", i)])


@pytest.mark.parametrize("i", range(len(PIPE_REQS)))
def test_b3_pipeline_same_seed_midi_bytes(results, i):
    got, ref = results
    assert list(got[f"pipe/{i}/tokens"]) == ref[("pipe_tokens", i)]
    assert got[f"pipe/{i}/midi"].tobytes() == ref[("pipe", i)]


def test_b3_pipeline_sections_midi_bytes(results):
    got, ref = results
    assert got["sections/midi"].tobytes() == ref["sections"]


def test_pipeline_from_demo_ckpt_b3_serves_solo(results):
    got, _ = results
    info = json.loads(str(got["serve/info"]))
    assert info == {"scheme": "b3", "eos": "[END_SEQ]", "batcher": None,
                    "max_len": 255}


@pytest.mark.parametrize("fmt,head", [("wav", b"RIFF"), ("midi", b"MThd")])
def test_demo_ckpt_b3_answers_post_generate(results, fmt, head):
    got, _ = results
    assert int(got[f"serve/{fmt}/status"]) == 200
    body = got[f"serve/{fmt}/body"].tobytes()
    assert body.startswith(head)
    if fmt == "wav":
        assert body[8:12] == b"WAVE"
    assert int(got[f"serve/{fmt}/tokens"]) > 3


def test_b2_checkpoint_is_refused(results):
    got, _ = results
    err = str(got["b2/pipeline"])
    assert err.startswith("ValueError") and "Scheme-B2" in err
    assert int(got["b2/cli_code"]) == 2


def test_cli_generate_on_b3(results):
    got, _ = results
    assert int(got["cli/code"]) == 0
    assert got["cli/midi"].tobytes()[:4] == b"MThd"
    wav = got["cli/wav"].tobytes()
    assert wav[:4] == b"RIFF" and wav[8:12] == b"WAVE"
    # the control prefix of --bpm 96 --key "D minor"
    assert "'[START_SEQ]', 'BPM_96', 'KEY_14'" in str(got["cli/stdout"])


@pytest.mark.parametrize("name", list(FOLDS))
@pytest.mark.parametrize("tname", list(FOLD48_TS))
def test_fold_plain_dh48_matches_pallas(results, name, tname):
    got, ref = results
    want = ref[("fold", name, tname)]
    assert got[f"fold/{name}/{tname}"].shape == want.shape == (4, 1, 192)
    np.testing.assert_allclose(got[f"fold/{name}/{tname}"], want,
                               rtol=FOLD_TOL, atol=FOLD_TOL)
