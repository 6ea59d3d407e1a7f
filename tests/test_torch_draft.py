"""The port's draft-model speculative decoding against the JAX package, on
the CPU.

Same inputs (numpy, from a seed) and the same weights (JAX parameter
trees as numpy arrays) go through the JAX package here and through
``eamg_tpu_torch`` in one subprocess (tests/torch_port_worker.py, task
``draft``); torch never enters this process.

Checked, with the tolerance and its reason (every check is exact: tokens
are integers, and the port draws JAX's keys and noise bit for bit):
- ``decode/speculative.py::generate_speculative`` with a target (L2, d64,
  GQA-2) and a narrower draft (L1, d32) of one vocabulary: tokens and
  length equal to JAX's for gamma 1, 3 and 4, greedy and sampled (two
  seeds a gamma, with an EOS that stops the decode), and with top-p 0.9
  and min-p 0.05; the eager loop's tokens equal the graphed loop's; greedy
  equal to the target's plain greedy ``generate_kv`` without refeed
  (JAX's contract);
- ``Generator.generate_ids_speculative``: JAX's ids, an over-length
  prompt returned unchanged, and the assertion on a draft of another
  vocabulary;
- ``cli generate --draft`` on two corrected causal checkpoints written
  by the JAX package (Scheme A): the MIDI bytes of JAX's CLI; on two
  reference (non-causal) checkpoints the ``AssertionError`` matching
  "causal" of JAX's own test, and ``--draft`` with ``--lookup`` refused.
"""

from __future__ import annotations

import json

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from eamg_tpu.cli import main as jax_cli
from eamg_tpu.decode import Generator
from eamg_tpu.decode.loop import generate_kv
from eamg_tpu.decode.speculative import generate_speculative
from eamg_tpu.models.gpt import GPTConfig, init_params
from eamg_tpu.serve.pipeline import demo_pipeline
from eamg_tpu.tokenizer import Vocab
from eamg_tpu.utils.checkpoint import save_checkpoint

from port_harness import cfg_json, flatten, perturbed_params, run_worker

CFG_T = GPTConfig(vocab_size=97, seq_len=48, d_model=64, n_head=4,
                  n_layer=2, n_kv_heads=2, causal=True)
CFG_D = GPTConfig(vocab_size=97, seq_len=48, d_model=32, n_head=2,
                  n_layer=1, causal=True)
MAX_LEN, EOS = 40, 3
PROMPT = [5, 9, 13, 7]
# name -> (gamma, keywords)
RUNS = {
    **{f"g{g}_greedy": (g, {"greedy": True}) for g in (1, 3, 4)},
    **{f"g{g}_s{s}": (g, {"seed": s, "eos_id": EOS})
       for g in (1, 3, 4) for s in (0, 1)},
    "top_p": (3, {"seed": 4, "top_p": 0.9, "temperature": 0.8}),
    "min_p": (3, {"seed": 5, "min_p": 0.05, "top_k": 20}),
}
GEN_RUNS = {"sampled": {"prompt": PROMPT, "max_len": MAX_LEN, "gamma": 3,
                        "seed": 2},
            "greedy": {"prompt": PROMPT, "max_len": MAX_LEN, "gamma": 4,
                       "greedy": True},
            "overlength": {"prompt": PROMPT, "max_len": 4}}
CLI_SEQ, CLI_MAX = 64, "48"
CLI_ARGS = ["--bpm", "120", "--key", "C major", "--instruments", "Violin",
            "--max-len", CLI_MAX, "--seed", "3", "--gamma", "3"]


def _checkpoints(tmp_path):
    """Two Scheme-A checkpoints of one vocabulary (the demo's), a target
    and a draft, corrected causal and not."""
    vocab = demo_pipeline().generator.vocab
    out = {}
    for causal in (True, False):
        for tag, (d, h, L, key) in (("t", (32, 4, 2, 0)),
                                    ("d", (16, 2, 1, 1))):
            cfg = GPTConfig(vocab_size=len(vocab), seq_len=CLI_SEQ,
                            d_model=d, n_head=h, n_layer=L,
                            pos_rows=CLI_SEQ, causal=causal)
            path = tmp_path / f"{tag}_{causal}"
            save_checkpoint(str(path), init_params(jax.random.PRNGKey(key),
                                                   cfg), vocab.tok2id, cfg)
            out[(tag, causal)] = str(path)
    return out


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("draft")
    rng = np.random.default_rng(77)
    pt = perturbed_params(CFG_T, rng, key=3)
    pd = perturbed_params(CFG_D, rng, key=4)
    jt, jd = (jax.tree.map(jnp.asarray, p) for p in (pt, pd))
    prompt = np.zeros((1, 16), np.int32)
    prompt[0, :len(PROMPT)] = PROMPT
    ref = {}
    for name, (g, kw) in RUNS.items():
        kw = dict(kw)
        seed = kw.pop("seed", 0)
        buf, pos = generate_speculative(jt, jd, jnp.asarray(prompt),
                                        len(PROMPT), jax.random.PRNGKey(seed),
                                        CFG_T, CFG_D, MAX_LEN, gamma=g, **kw)
        ref[("run", name)] = np.asarray(buf)[0, :int(pos)]
    buf, n = generate_kv(jt, jnp.asarray(prompt), len(PROMPT),
                         jax.random.PRNGKey(0), CFG_T, MAX_LEN, greedy=True,
                         refeed_last_prompt=False)
    ref["kv_greedy"] = np.asarray(buf)[0, :int(n)]
    vocab = Vocab({str(i): i for i in range(CFG_T.vocab_size)})
    tgt = Generator(jt, CFG_T, vocab, eos_token="3", pad_token="0")
    drf = Generator(jd, CFG_D, vocab, eos_token="3", pad_token="0")
    for name, kw in GEN_RUNS.items():
        kw = dict(kw)
        p = kw.pop("prompt")
        ref[("gen", name)] = np.asarray(
            tgt.generate_ids_speculative(drf, p, **kw))[0]
    ckpts = _checkpoints(tmp)
    cli_runs = {
        "draft": ["--checkpoint", ckpts[("t", True)], "--draft",
                  ckpts[("d", True)], *CLI_ARGS],
        "noncausal": ["--checkpoint", ckpts[("t", False)], "--draft",
                      ckpts[("d", False)], *CLI_ARGS],
        "with_lookup": ["--checkpoint", ckpts[("t", True)], "--draft",
                        ckpts[("d", True)], "--lookup", *CLI_ARGS]}
    mid = tmp / "jax.mid"
    jax_cli(["generate", *cli_runs["draft"], "--out", str(mid)])
    ref["cli_midi"] = mid.read_bytes()
    with pytest.raises(AssertionError, match="causal"):
        jax_cli(["generate", *cli_runs["noncausal"],
                 "--out", str(tmp / "x.mid")])
    inp = {"t/cfg": cfg_json(CFG_T), "d/cfg": cfg_json(CFG_D),
           "prompt": np.asarray(PROMPT), "max_len": np.asarray(MAX_LEN),
           "runs": np.asarray(json.dumps(RUNS)),
           "gen_runs": np.asarray(json.dumps(GEN_RUNS)),
           "cli": np.asarray(json.dumps(cli_runs))}
    inp.update(flatten(pt, "t/p"))
    inp.update(flatten(pd, "d/p"))
    got = run_worker("draft", inp, tmp)
    return got, ref


@pytest.mark.parametrize("name", list(RUNS))
def test_generate_speculative_matches_jax(results, name):
    got, ref = results
    np.testing.assert_array_equal(got[f"run/{name}"], ref[("run", name)])


@pytest.mark.parametrize("name", [n for n in RUNS if n.endswith("_s0")])
def test_eager_loop_matches_graphed(results, name):
    got, _ = results
    np.testing.assert_array_equal(got[f"eager/{name}"], got[f"run/{name}"])


def test_eos_stops_the_decode(results):
    got, _ = results
    stopped = [n for n in RUNS if "_s" in n
               and len(got[f"run/{n}"]) < MAX_LEN]
    assert stopped, "no sampled run met the EOS"
    for n in stopped:
        assert got[f"run/{n}"][-1] == EOS


@pytest.mark.parametrize("g", (1, 3, 4))
def test_greedy_equals_plain_greedy(results, g):
    got, ref = results
    np.testing.assert_array_equal(got["kv_greedy"], ref["kv_greedy"])
    np.testing.assert_array_equal(got[f"run/g{g}_greedy"], ref["kv_greedy"])


@pytest.mark.parametrize("name", list(GEN_RUNS))
def test_generator_generate_ids_speculative(results, name):
    got, ref = results
    np.testing.assert_array_equal(got[f"gen/{name}"], ref[("gen", name)])
    if name == "overlength":
        np.testing.assert_array_equal(got["gen/overlength"], PROMPT)


def test_generator_refuses_another_vocabulary(results):
    got, _ = results
    msg = str(got["gen/vocab_mismatch"])
    assert msg.startswith("AssertionError") and "vocabulary" in msg


def test_cli_generate_draft_bytes(results):
    got, ref = results
    assert int(got["cli/draft/code"]) == 0
    assert str(got["cli/draft/raised"]) == "none"
    assert got["cli/draft/midi"].tobytes() == ref["cli_midi"]
    assert ref["cli_midi"][:4] == b"MThd"


def test_cli_generate_draft_refusals(results):
    got, _ = results
    msg = str(got["cli/noncausal/raised"])
    assert msg.startswith("AssertionError") and "causal" in msg
    msg = str(got["cli/with_lookup/raised"])
    assert msg.startswith("SystemExit") and "mutually exclusive" in msg
