"""The port's prompt-lookup speculation and beam search against the JAX
package, on the CPU, and the page's options through the pipeline, the
server and ``cli generate``.

Same inputs (numpy, from a seed) and the same weights go through the JAX
package here and through ``eamg_tpu_torch`` in one subprocess
(tests/torch_port_worker.py, task ``spec``); torch never enters this
process.

Checked, with the tolerance and its reason:
- ``generate_prompt_lookup`` on a small f32 model (L2, d64, GQA-2): tokens,
  length and verify steps equal to JAX's, greedy and sampled (three seeds,
  top-p 0.9, min-p 0.05), on a repetitive prompt (proposals accepted) and a
  prompt with no match (proposals of -1); greedy equal to the port's
  greedy ``generate_kv`` without refeed;
- ``generate_beam`` at K 1, 2 and 4 with an EOS: rows and lengths equal to
  JAX's, scores within 1e-4 (sums of f32 log-probabilities in another
  order), and ``rank_beams`` at ``length_penalty`` 0, 1 and 2 in JAX's
  order; a model whose EOS ends every beam early; a model with two tokens
  of identical logits (a forced tie: the lower index first, as
  ``lax.top_k``);
- the pipeline's lookup and beams (4) MIDI bytes equal JAX's for the same
  seed on ``demo_pipeline(corrected=True)`` and ``demo_pipeline_b3``; over
  HTTP (``lookup=1``, ``beams=4``) on the B3 one;
- ``cli generate --medusa PATH``, ``--lookup`` and ``--beams`` (with
  ``--length-penalty``) on a small causal checkpoint: the JAX CLI's MIDI
  bytes; more than one of them exits with the JAX CLI's message.
"""

from __future__ import annotations

import json
import pickle

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from eamg_tpu import cli as jax_cli
from eamg_tpu.decode.beam import generate_beam, rank_beams
from eamg_tpu.decode.loop import generate_kv
from eamg_tpu.decode.speculative import generate_prompt_lookup
from eamg_tpu.models.gpt import GPTConfig, init_params
from eamg_tpu.serve.pipeline import demo_pipeline, demo_pipeline_b3
from eamg_tpu.tokenizer import Vocab
from eamg_tpu.train.data import synthetic_corpus
from eamg_tpu.utils.checkpoint import save_checkpoint

from port_harness import cfg_json, flatten, perturbed_params, run_worker

CFG = GPTConfig(vocab_size=97, seq_len=48, d_model=64, n_head=4, n_layer=2,
                n_kv_heads=2, causal=True)
EOS = 3
LOOKUP_MAX, GAMMA, NGRAM = 38, 8, 3
REPETITIVE = [5, 9, 13, 7, 5, 9, 13, 7, 5, 9]
NO_MATCH = [5, 9, 13, 7]
# generate_prompt_lookup: name -> (prompt, keywords)
LOOKUPS = {
    "greedy": (REPETITIVE, dict(greedy=True)),
    "greedy_no_match": (NO_MATCH, dict(greedy=True)),
    **{f"seed{s}": (REPETITIVE, dict(seed=s, eos_id=EOS)) for s in (0, 1, 2)},
    "no_match_seed": (NO_MATCH, dict(seed=3, eos_id=EOS)),
    "top_p": (REPETITIVE, dict(seed=4, top_p=0.9, temperature=0.8)),
    "min_p": (REPETITIVE, dict(seed=5, min_p=0.05, top_k=20)),
}
BEAM_MAX = 24
BEAM_PROMPT = [5, 9, 13]
# beam searches: name -> (model, K)
BEAMS = {"k1": ("base", 1), "k2": ("base", 2), "k4": ("base", 4),
         "early": ("eos_heavy", 4), "tie": ("tie", 4)}
TIE = (40, 41)          # tokens given identical logits
PENALTIES = (0.0, 1.0, 2.0)
SCORE_TOL = 1e-4
TEXT = "I finally got the job, I am so happy!"
SEED = 5
PIPES = ("a", "b3")
OPTIONS = {"lookup": dict(lookup=True), "beams": dict(beams=4)}
# cli generate on the small causal checkpoint: name -> extra flags
CLI = {"medusa": ["--medusa", "{heads}", "--seed", "3", "--max-len", "40"],
       "lookup": ["--lookup", "--seed", "4", "--max-len", "40",
                  "--gamma", "6", "--lookup-ngram", "2"],
       "beams": ["--beams", "3", "--length-penalty", "0.5", "--max-len",
                 "32"]}


def _models(params) -> dict:
    """The base model, one whose EOS logit is raised (every beam ends
    early) and one that cannot tell the TIE tokens apart (their embedding
    and head rows shared, their logits raised so that beams take them):
    hypotheses that differ in them alone tie."""
    heavy = jax.tree.map(np.copy, params)
    heavy["head"]["b"][EOS] += 6.0
    tie = jax.tree.map(np.copy, params)
    a, b = TIE
    tie["head"]["b"][a] += 3.0
    for leaf in (tie["tok_emb"], tie["head"]["w"], tie["head"]["b"]):
        leaf[b] = leaf[a]
    return {"base": params, "eos_heavy": heavy, "tie": tie}


def _lookup_cases(jp, inp, ref):
    for name, (prompt_ids, kw) in LOOKUPS.items():
        kw = dict(kw)
        seed = kw.pop("seed", 0)
        prompt = np.zeros((1, 16), np.int32)
        prompt[0, :len(prompt_ids)] = prompt_ids
        buf, n, steps = generate_prompt_lookup(
            jp, jnp.asarray(prompt), len(prompt_ids),
            jax.random.PRNGKey(seed), CFG, LOOKUP_MAX, gamma=GAMMA,
            ngram=NGRAM, **kw)
        ref[("lookup", name)] = (np.asarray(buf)[0, :int(n)], int(steps))
    prompt = np.zeros((1, 16), np.int32)
    prompt[0, :len(REPETITIVE)] = REPETITIVE
    buf, n = generate_kv(jp, jnp.asarray(prompt), len(REPETITIVE),
                         jax.random.PRNGKey(0), CFG, LOOKUP_MAX, greedy=True,
                         refeed_last_prompt=False)
    ref["kv_greedy"] = np.asarray(buf)[0, :int(n)]
    inp["lookups"] = np.asarray(json.dumps(LOOKUPS))


def _beam_cases(models, inp, ref):
    prompt = np.zeros((1, 16), np.int32)
    prompt[0, :len(BEAM_PROMPT)] = BEAM_PROMPT
    for tag, p in models.items():
        inp.update(flatten(p, f"models/{tag}"))
    for name, (tag, K) in BEAMS.items():
        buf, gl, sc = generate_beam(
            jax.tree.map(jnp.asarray, models[tag]), jnp.asarray(prompt),
            len(BEAM_PROMPT), CFG, BEAM_MAX, n_beams=K, eos_id=EOS)
        ref[("beam", name)] = (np.asarray(buf), np.asarray(gl),
                               np.asarray(sc))
        for lp in PENALTIES:
            ref[("rank", name, lp)] = rank_beams(buf, gl, sc, lp)
    inp["beams"] = np.asarray(json.dumps(BEAMS))


def _pipeline_cases(inp, ref):
    pipes = {"a": demo_pipeline(corrected=True), "b3": demo_pipeline_b3()}
    for tag, pipe in pipes.items():
        gen = pipe.generator
        inp.update(flatten(jax.tree.map(np.asarray, gen.params), f"{tag}/p"))
        inp[f"{tag}/cfg"] = cfg_json(gen.cfg)
        inp[f"{tag}/vocab"] = np.asarray(json.dumps(gen.vocab.tok2id))
        for opt, kw in OPTIONS.items():
            ref[(tag, opt)] = pipe.generate(TEXT, seed=SEED,
                                            render_audio=False,
                                            **kw).midi_bytes


def _cli_cases(rng, inp, ref, tmp):
    corpus = [json.loads(js) for js in synthetic_corpus(64, seed=0)]
    vocab = Vocab.from_sequences(corpus, pad_last=False)
    cfg = GPTConfig(vocab_size=len(vocab), seq_len=64, d_model=64, n_head=4,
                    n_layer=2, pos_rows=64, causal=True)
    ckpt = tmp / "ckpt"
    save_checkpoint(str(ckpt), init_params(jax.random.PRNGKey(1), cfg),
                    vocab.tok2id, cfg)
    heads = tmp / "heads.pkl"
    with open(heads, "wb") as f:
        pickle.dump({"blocks": [
            {"w": (0.3 * rng.standard_normal((64, 64)) / 8).astype(
                np.float32),
             "b": (0.1 * rng.standard_normal(64)).astype(np.float32)}
            for _ in range(4)], "n_heads": 4}, f)
    runs = {k: [a.format(heads=heads) for a in v] for k, v in CLI.items()}
    inp["cli/ckpt"] = np.asarray(str(ckpt))
    inp["cli/runs"] = np.asarray(json.dumps(runs))
    for name, extra in runs.items():
        out = tmp / f"jax_{name}.mid"
        jax_cli.main(["generate", "--checkpoint", str(ckpt), "--out",
                      str(out), *extra])
        ref[("cli", name)] = out.read_bytes()


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    rng = np.random.default_rng(4242)
    params = perturbed_params(CFG, rng)
    jp = jax.tree.map(jnp.asarray, params)
    inp = {"model/cfg": cfg_json(CFG), "eos": np.asarray(EOS),
           "lookup_max": np.asarray(LOOKUP_MAX), "gamma": np.asarray(GAMMA),
           "ngram": np.asarray(NGRAM), "beam_max": np.asarray(BEAM_MAX),
           "beam_prompt": np.asarray(BEAM_PROMPT)}
    inp.update(flatten(params, "model/p"))
    ref = {}
    _lookup_cases(jp, inp, ref)
    _beam_cases(_models(params), inp, ref)
    _pipeline_cases(inp, ref)
    tmp = tmp_path_factory.mktemp("spec")
    _cli_cases(rng, inp, ref, tmp)
    got = run_worker("spec", inp, tmp, timeout=900)
    return got, ref


@pytest.mark.parametrize("name", list(LOOKUPS))
def test_prompt_lookup_matches_jax(results, name):
    got, ref = results
    toks, steps = ref[("lookup", name)]
    np.testing.assert_array_equal(got[f"lookup/{name}/tokens"], toks)
    assert int(got[f"lookup/{name}/steps"]) == steps


def test_repetitive_prompt_gets_proposals_accepted(results):
    got, _ = results
    n = len(got["lookup/greedy/tokens"]) - len(REPETITIVE)
    assert int(got["lookup/greedy/steps"]) < n - 1


def test_greedy_lookup_equals_greedy_generate_kv(results):
    got, ref = results
    np.testing.assert_array_equal(got["lookup/greedy/tokens"],
                                  got["kv_greedy"])
    np.testing.assert_array_equal(got["kv_greedy"], ref["kv_greedy"])


@pytest.mark.parametrize("name", list(BEAMS))
def test_generate_beam_matches_jax(results, name):
    got, ref = results
    buf, gl, sc = ref[("beam", name)]
    np.testing.assert_array_equal(got[f"beam/{name}/buf"], buf)
    np.testing.assert_array_equal(got[f"beam/{name}/gen_lens"], gl)
    np.testing.assert_allclose(got[f"beam/{name}/scores"], sc,
                               atol=SCORE_TOL, rtol=0)


@pytest.mark.parametrize("lp", PENALTIES)
@pytest.mark.parametrize("name", list(BEAMS))
def test_rank_beams_matches_jax(results, name, lp):
    got, ref = results
    buf, gl, sc, norm = ref[("rank", name, lp)]
    np.testing.assert_array_equal(got[f"rank/{name}/{lp}/buf"], buf)
    np.testing.assert_array_equal(got[f"rank/{name}/{lp}/gen_lens"], gl)
    np.testing.assert_allclose(got[f"rank/{name}/{lp}/norm"], norm,
                               atol=SCORE_TOL, rtol=0)


def test_eos_ends_every_beam_early(results):
    got, _ = results
    gl = got["beam/early/gen_lens"]
    assert int(gl.max()) < BEAM_MAX - len(BEAM_PROMPT)
    buf = got["beam/early/buf"]
    for row, n in zip(buf, gl):
        assert row[len(BEAM_PROMPT) + int(n) - 1] == EOS


def test_forced_tie_puts_the_lower_index_first(results):
    """Two tokens of identical logits give beams of equal scores that
    differ in that token alone: the lower token's beam ranks first, as
    ``lax.top_k`` orders equal values."""
    got, ref = results
    buf, _, sc = ref[("beam", "tie")]
    pairs = [(i, j) for i in range(len(sc)) for j in range(len(sc))
             if i < j and sc[i] == sc[j]]
    assert pairs, "no tie in the reference"
    for i, j in pairs:
        diff = np.nonzero(buf[i] != buf[j])[0]
        assert buf[i][diff[0]] < buf[j][diff[0]]
        assert got["beam/tie/scores"][i] == got["beam/tie/scores"][j]


@pytest.mark.parametrize("opt", list(OPTIONS))
@pytest.mark.parametrize("tag", PIPES)
def test_pipeline_option_bytes_equal_jax(results, tag, opt):
    got, ref = results
    assert got[f"pipe/{tag}/{opt}"].tobytes() == ref[(tag, opt)]


@pytest.mark.parametrize("opt", list(OPTIONS))
def test_http_option_bytes_equal_jax(results, opt):
    got, ref = results
    assert int(got[f"http/{opt}/status"]) == 200
    assert got[f"http/{opt}/body"].tobytes() == ref[("b3", opt)]


@pytest.mark.parametrize("name", list(CLI))
def test_cli_generate_option_bytes_equal_jax_cli(results, name):
    got, ref = results
    assert int(got[f"cli/{name}/code"]) == 0
    assert ref[("cli", name)][:4] == b"MThd"
    assert got[f"cli/{name}/midi"].tobytes() == ref[("cli", name)]


def test_cli_generate_options_exclude_each_other(results):
    got, _ = results
    assert int(got["cli/both/code"]) != 0
    assert "mutually exclusive" in str(got["cli/both/stderr"])
