"""The port's batched offline decode against the JAX package, on the CPU.

The uniform batched KV-cache decode (``generate_kv`` at B > 1 with every
``attn_impl``), the uncached loop (``generate_full``), the anti-repetition
sampling controls, ``Generator``'s new options, ``cli generate`` and
``python -m eamg_tpu_torch.bench``. JAX's weights are carried across by
``params_from_jax``; inputs are made with numpy from a seed; the torch side
runs in one subprocess (tests/torch_port_worker.py, task ``batch``).

Checked, with the tolerance and its reason:
- a small MHA model (2 layers, d64, h4) and a GQA-2 one: f32 logits of the
  fused-cache prefill and of a teacher-forced ``decode_step`` per
  ``attn_impl`` to 1e-4 (f32 sums in other orders, two layers); the fused
  cache after prefill equal to JAX's cache carried across to 1e-5;
- ``generate_kv`` at B 4, every ``attn_impl``: streams token-equal to JAX's
  ``generate_kv`` (which has one decode attention; every ``attn_impl``
  computes the same function): greedy and seeded with top-k, top-p and
  min-p, with and without ``refeed_last_prompt``, with penalties and with
  ``no_repeat_ngram``; ``generate_full`` token-equal too;
- ``token_counts``, ``no_repeat_ngram_ban`` equal; ``apply_penalties`` to
  1e-6; ``sample_token`` with counts token-equal;
- ``Generator.generate_ids`` (batch, ``use_cache``, penalties), ``sample``,
  ``sample_kvcache`` and ``max_supported_len`` equal to JAX's;
- ``cli generate`` on a small saved checkpoint: the MIDI bytes of the JAX
  CLI for the same seed and flags; of its decode modes, ``--beams`` gives
  the JAX CLI's bytes, ``--lookup`` and ``--medusa`` stop with JAX's
  ValueError on this (non-causal) checkpoint, ``--grammar`` gives the JAX
  CLI's bytes, and ``--draft`` (the checkpoint drafting for itself) stops
  with JAX's AssertionError, "speculative requires causal";
- ``Generator.generate_ids`` with a grammar token-equal to JAX's;
- the bench module's loop (``bench.bench_impl``) at a cut depth, length and
  batch gives a result line per ``attn_impl``; ``python -m
  eamg_tpu_torch.bench`` refuses to run without a card.
"""

from __future__ import annotations

import json
import pickle

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from eamg_tpu import cli as jax_cli
from eamg_tpu.decode import Generator
from eamg_tpu.decode.loop import generate_full, generate_kv
from eamg_tpu.decode.sampling import (apply_no_repeat_ngram, apply_penalties,
                                      no_repeat_ngram_ban, sample_token,
                                      token_counts)
from eamg_tpu.models.gpt import (GPTConfig, decode_step, init_kv_cache,
                                 init_params, prefill)
from eamg_tpu.tokenizer import SchemeB2, Vocab
from eamg_tpu.train.data import synthetic_corpus
from eamg_tpu.utils.checkpoint import save_checkpoint

from eamg_tpu.decode.grammar import grammar_a

from port_harness import (cfg_json, flatten, perturbed_params, run_worker,
                          token_names)

HEAD = ("sp", "dma", "vmem")
FOLD = ("fold", "fold2", "fold3", "fold_sp", "fold3_sp")
MODELS = {
    "mha": (GPTConfig(vocab_size=97, seq_len=48, d_model=64, n_head=4,
                      n_layer=2, causal=True), HEAD + FOLD),
    # dma and vmem take MHA caches only
    "gqa": (GPTConfig(vocab_size=97, seq_len=48, d_model=64, n_head=4,
                      n_layer=2, n_kv_heads=2, causal=True), ("sp",) + FOLD),
}
B, PLEN, MAX_LEN, FULL_MAX_LEN, EOS = 4, 5, 40, 22, 3
SAMPLED = {"seed": 3, "top_k": 20, "top_p": 0.9, "min_p": 0.02,
           "temperature": 0.9}
CASES = {
    "greedy_refeed": {"greedy": True, "refeed_last_prompt": True},
    "greedy_norefeed": {"greedy": True, "refeed_last_prompt": False},
    "sampled_refeed": {**SAMPLED, "refeed_last_prompt": True},
    "sampled_norefeed": {**SAMPLED, "refeed_last_prompt": False},
    "penalties": {"seed": 5, "top_k": 20, "penalties": [1.3, 0.2, 0.1],
                  "refeed_last_prompt": False},
    "ngram": {"seed": 6, "top_k": 20, "no_repeat_ngram": 2,
              "refeed_last_prompt": False},
    "greedy_penalties_ngram": {"greedy": True, "penalties": [1.5, 0.3, 0.0],
                               "no_repeat_ngram": 3,
                               "refeed_last_prompt": True},
}
GQA_CASES = ("greedy_norefeed", "sampled_refeed")
FULL_CASES = {
    "greedy": {"greedy": True},
    "sampled": {"seed": 4, "top_k": 20, "top_p": 0.9},
    "penalties_ngram": {"seed": 7, "top_k": 20, "penalties": [1.2, 0.1, 0.2],
                        "no_repeat_ngram": 2},
}
PENALTIES = {"all": [1.3, 0.4, 0.2], "repetition": [0.8, 0.0, 0.0],
             "neutral": [1.0, 0.0, 0.0]}
GEN_CALLS = {
    "batch3": {"max_len": 24, "batch": 3, "seed": 2, "top_k": 15},
    "uncached": {"max_len": 20, "batch": 2, "seed": 2, "top_k": 15,
                 "use_cache": False},
    "penalties": {"max_len": 24, "batch": 2, "seed": 3, "top_k": 15,
                  "penalties": [1.4, 0.2, 0.0], "no_repeat_ngram": 2,
                  "refeed_last_prompt": False},
    "overlong": {"max_len": 3, "batch": 2},
}
CLI_RUNS = {
    "plain": ["--seed", "3", "--bpm", "120", "--key", "C major",
              "--max-len", "48"],
    "penalties": ["--seed", "4", "--max-len", "48", "--top-k", "30",
                  "--top-p", "0.95", "--repetition-penalty", "1.3",
                  "--presence-penalty", "0.2", "--no-repeat-ngram", "3",
                  "--instruments", "Flute"],
}
# cli generate's decode modes: flag -> (its values, exit code, what stderr
# says); "{heads}" is a Medusa heads file, "{ckpt}" the saved checkpoint
CLI_MODES = {"--beams": (["4"], 0, ""),
             "--grammar": ([], 0, ""),
             "--draft": (["{ckpt}"], 1, "speculative requires causal"),
             "--lookup": ([], 1, "corrected causal checkpoint"),
             "--medusa": (["{heads}"], 1, "corrected causal checkpoint")}


def _kw(spec):
    spec = {k: v for k, v in spec.items() if k != "seed"}
    if "penalties" in spec:
        spec["penalties"] = tuple(spec["penalties"])
    return spec


def _model_case(tag, cfg, impls, rng, inp, ref):
    params = perturbed_params(cfg, rng)
    prompt = np.zeros((B, 16), np.int32)
    prompt[:, :PLEN] = rng.integers(4, cfg.vocab_size, PLEN)
    forced = rng.integers(0, cfg.vocab_size, (4, B)).astype(np.int32)
    cases = CASES if tag == "mha" else {k: CASES[k] for k in GQA_CASES}
    full_cases = FULL_CASES if tag == "mha" else {}
    inp.update(flatten(params, f"{tag}/p"))
    inp.update({f"{tag}/cfg": cfg_json(cfg), f"{tag}/prompt": prompt,
                f"{tag}/impls": np.asarray(json.dumps(impls)),
                f"{tag}/plen": np.asarray(PLEN),
                f"{tag}/max_len": np.asarray(MAX_LEN),
                f"{tag}/full_max_len": np.asarray(FULL_MAX_LEN),
                f"{tag}/forced": forced,
                f"{tag}/cases": np.asarray(json.dumps(cases)),
                f"{tag}/full_cases": np.asarray(json.dumps(full_cases))})
    jp = jax.tree.map(jnp.asarray, params)
    pj = jnp.asarray(prompt)
    cache = init_kv_cache(cfg, B, MAX_LEN)
    logits, cache = jax.jit(prefill, static_argnums=(2,))(jp, pj, cfg, cache,
                                                          PLEN)
    ref[f"{tag}/prefill"] = np.asarray(logits)
    np_cache = {"k": [np.asarray(k) for k in cache["k"]],
                "v": [np.asarray(v) for v in cache["v"]],
                "length": np.asarray(cache["length"])}
    inp.update(flatten(np_cache, f"{tag}/jax_cache0"))
    step = jax.jit(decode_step, static_argnums=(3,))
    last, steps = pj[:, PLEN - 1:PLEN], []
    for row in forced:
        lg, cache = step(jp, last, cache, cfg)
        steps.append(np.asarray(lg))
        last = jnp.asarray(row)[:, None]
    ref[f"{tag}/decode"] = np.stack(steps)
    for name, spec in cases.items():
        buf, n = generate_kv(jp, pj, PLEN,
                             jax.random.PRNGKey(spec.get("seed", 0)), cfg,
                             MAX_LEN, eos_id=EOS, **_kw(spec))
        ref[f"{tag}/{name}"] = np.asarray(buf)[:, :int(n)]
    for name, spec in full_cases.items():
        buf, n = generate_full(jp, pj, PLEN,
                               jax.random.PRNGKey(spec.get("seed", 0)), cfg,
                               FULL_MAX_LEN, eos_id=EOS, **_kw(spec))
        ref[f"{tag}/full/{name}"] = np.asarray(buf)[:, :int(n)]
    return jp


def _sampling_case(rng, inp, ref):
    V = 61
    logits = (rng.standard_normal((3, V)) * 2).astype(np.float32)
    ids = rng.integers(0, V, (3, 9)).astype(np.int32)
    valid = np.arange(9)[None, :] < np.asarray([[9], [4], [0]])
    buf = rng.integers(0, 5, (3, 14)).astype(np.int32)   # many repeats
    pos, pos_rows = 11, np.asarray([11, 2, 14], np.int32)
    inp.update({"smp/logits": logits, "smp/ids": ids, "smp/valid": valid,
                "smp/buf": buf, "smp/pos": np.asarray(pos),
                "smp/pos_rows": pos_rows, "smp/seed": np.asarray(9),
                "smp/penalties": np.asarray(json.dumps(PENALTIES))})
    counts = token_counts(jnp.asarray(ids), jnp.asarray(valid), V)
    ref["smp/counts"] = np.asarray(counts)
    for n in (1, 2, 3):
        for pname, p in (("scalar", pos), ("rows", jnp.asarray(pos_rows))):
            ref[f"smp/ban{n}/{pname}"] = np.asarray(no_repeat_ngram_ban(
                jnp.asarray(buf), p, n, V))
    ref["smp/ngram_logits"] = np.asarray(apply_no_repeat_ngram(
        jnp.asarray(logits), jnp.asarray(buf), pos, 2))
    for name, pen in PENALTIES.items():
        ref[f"smp/pen/{name}"] = np.asarray(apply_penalties(
            jnp.asarray(logits), counts, *pen))
        for greedy in (False, True):
            ref[f"smp/tok/{name}/{int(greedy)}"] = np.asarray(sample_token(
                jax.random.PRNGKey(9), jnp.asarray(logits), 0.8, 10,
                greedy=greedy, top_p=0.9, min_p=0.01, counts=counts,
                repetition_penalty=pen[0], frequency_penalty=pen[1],
                presence_penalty=pen[2]))


def _generator_case(cfg, jp, inp, ref):
    vocab = Vocab({f"t{i}": i for i in range(cfg.vocab_size)})
    gen = Generator(jp, cfg, vocab, eos_token=f"t{EOS}", pad_token="t0")
    ids = [7, 11, 13, 17]
    inp["gen/prompt_ids"] = np.asarray(ids)
    inp["gen/calls"] = np.asarray(json.dumps(GEN_CALLS))
    ref["gen/max_supported"] = np.asarray(
        [gen.max_supported_len(), gen.max_supported_len(use_cache=False)])
    for name, kw in GEN_CALLS.items():
        ref[f"gen/{name}"] = gen.generate_ids(ids, **_kw(kw),
                                              seed=kw.get("seed", 0))
    toks = [f"t{i}" for i in ids]
    ref["gen/sample"] = np.asarray(vocab.encode(
        gen.sample(toks, max_len=20, seed=2, top_k=15)))
    ref["gen/sample_kvcache"] = np.asarray(vocab.encode(
        gen.sample_kvcache(toks, max_len=20, seed=2, top_k=15,
                           penalties=(1.2, 0.0, 0.1), no_repeat_ngram=2)))
    names = token_names(cfg.vocab_size)
    inp["gen/grammar_names"] = np.asarray(json.dumps(names))
    ref["gen/grammar"] = gen.generate_ids(ids, max_len=24, seed=2, top_k=15,
                                          grammar=grammar_a(Vocab(names)))
    p0 = jax.tree.map(np.asarray, init_params(jax.random.PRNGKey(3), cfg))
    ref["init/shapes"] = np.asarray(sorted(
        f"{k}:{v.shape}:{v.dtype}" for k, v in flatten(p0, "").items()))


def _cli_case(inp, ref, tmp):
    """A small Scheme-A checkpoint; the JAX CLI's MIDI for each run."""
    corpus = [json.loads(js) for js in synthetic_corpus(64, seed=0)]
    vocab = Vocab.from_sequences(corpus, pad_last=False)
    cfg = GPTConfig(vocab_size=len(vocab), seq_len=64, d_model=64, n_head=4,
                    n_layer=2, pos_rows=64)
    ckpt = tmp / "ckpt"
    save_checkpoint(str(ckpt), init_params(jax.random.PRNGKey(1), cfg),
                    vocab.tok2id, cfg)
    inp["cli/ckpt"] = np.asarray(str(ckpt))
    inp["cli/runs"] = np.asarray(json.dumps(CLI_RUNS))
    for name, extra in CLI_RUNS.items():
        out = tmp / f"jax_{name}.mid"
        jax_cli.main(["generate", "--checkpoint", str(ckpt), "--out",
                      str(out), *extra])
        ref[f"cli/{name}/midi"] = np.frombuffer(out.read_bytes(), np.uint8)
    heads = tmp / "heads.pkl"
    with open(heads, "wb") as f:
        pickle.dump({"blocks": [{"w": np.zeros((64, 64), np.float32),
                                 "b": np.zeros(64, np.float32)}]}, f)
    modes = {flag: [a.format(heads=heads, ckpt=ckpt) for a in values]
             for flag, (values, _, _) in CLI_MODES.items()}
    inp["cli/modes"] = np.asarray(json.dumps(modes))
    out = tmp / "jax_beams.mid"
    jax_cli.main(["generate", "--checkpoint", str(ckpt), "--out", str(out),
                  "--beams", *modes["--beams"]])
    ref["cli/--beams/midi"] = np.frombuffer(out.read_bytes(), np.uint8)
    out = tmp / "jax_grammar.mid"
    jax_cli.main(["generate", "--checkpoint", str(ckpt), "--out", str(out),
                  "--grammar"])
    ref["cli/--grammar/midi"] = np.frombuffer(out.read_bytes(), np.uint8)


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    rng = np.random.default_rng(77)
    inp, ref = {"eos": np.asarray(EOS),
                "tags": np.asarray(json.dumps(list(MODELS)))}, {}
    jps = {tag: _model_case(tag, cfg, impls, rng, inp, ref)
           for tag, (cfg, impls) in MODELS.items()}
    _sampling_case(rng, inp, ref)
    _generator_case(MODELS["mha"][0], jps["mha"], inp, ref)
    _cli_case(inp, ref, tmp_path_factory.mktemp("cli"))
    got = run_worker("batch", inp, tmp_path_factory.mktemp("batch"),
                     timeout=900)
    return got, ref


IMPL_CASES = [(tag, impl) for tag, (_, impls) in MODELS.items()
              for impl in impls]


@pytest.mark.parametrize("tag, impl", IMPL_CASES)
@pytest.mark.parametrize("what", ["prefill", "decode"])
def test_logits_match_jax_per_attn_impl(results, tag, impl, what):
    got, ref = results
    np.testing.assert_allclose(got[f"{tag}/{impl}/{what}"],
                               ref[f"{tag}/{what}"], rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("tag", list(MODELS))
def test_fused_prefill_cache_equals_jax_cache(results, tag):
    """The fused position-major cache after prefill is JAX's head-major
    cache carried across by fused_cache_from_jax."""
    got, _ = results
    assert int(got[f"{tag}/jax_cache0_length"]) == PLEN
    for li in range(MODELS[tag][0].n_layer):
        np.testing.assert_allclose(got[f"{tag}/fold/cache0/{li}"],
                                   got[f"{tag}/jax_cache0/{li}"], rtol=1e-5,
                                   atol=1e-5)


@pytest.mark.parametrize("impl", HEAD + FOLD)
@pytest.mark.parametrize("case", list(CASES))
def test_generate_kv_batch_token_equal(results, case, impl):
    """B 4, every attn_impl, every case: JAX's stream."""
    got, ref = results
    want = ref[f"mha/{case}"]
    assert want.shape[0] == B and want.shape[1] > PLEN + 1
    np.testing.assert_array_equal(got[f"mha/{case}/{impl}"], want)


@pytest.mark.parametrize("impl", ("sp",) + FOLD)
@pytest.mark.parametrize("case", GQA_CASES)
def test_generate_kv_batch_token_equal_gqa(results, case, impl):
    got, ref = results
    np.testing.assert_array_equal(got[f"gqa/{case}/{impl}"],
                                  ref[f"gqa/{case}"])


def test_batch_rows_differ_by_their_noise(results):
    _, ref = results
    rows = ref["mha/sampled_norefeed"]
    assert len({tuple(r) for r in rows.tolist()}) > 1


@pytest.mark.parametrize("case", list(FULL_CASES))
def test_generate_full_token_equal(results, case):
    got, ref = results
    np.testing.assert_array_equal(got[f"mha/full/{case}"],
                                  ref[f"mha/full/{case}"])


@pytest.mark.parametrize("impl", ["dma", "vmem", "unknown"])
def test_decode_refuses_attn_impl(results, impl):
    """dma and vmem on a GQA model, and an unknown name, raise."""
    got, _ = results
    msg = str(got[f"gqa/refuse/{impl}"])
    assert msg.startswith("ValueError")
    assert ("MHA caches only" if impl != "unknown" else "one of") in msg


def test_token_counts_equal(results):
    got, ref = results
    np.testing.assert_array_equal(got["smp/counts"], ref["smp/counts"])


@pytest.mark.parametrize("n", [1, 2, 3])
@pytest.mark.parametrize("pos", ["scalar", "rows"])
def test_no_repeat_ngram_ban_equal(results, n, pos):
    got, ref = results
    assert ref[f"smp/ban{n}/{pos}"].any()
    np.testing.assert_array_equal(got[f"smp/ban{n}/{pos}"],
                                  ref[f"smp/ban{n}/{pos}"])


def test_apply_no_repeat_ngram_equal(results):
    got, ref = results
    np.testing.assert_array_equal(got["smp/ngram_logits"],
                                  ref["smp/ngram_logits"])


@pytest.mark.parametrize("name", list(PENALTIES))
def test_apply_penalties_matches_jax(results, name):
    """1e-6: XLA may contract ``x - f * c`` into one multiply-add."""
    got, ref = results
    np.testing.assert_allclose(got[f"smp/pen/{name}"], ref[f"smp/pen/{name}"],
                               rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("name", list(PENALTIES))
@pytest.mark.parametrize("greedy", [0, 1])
def test_sample_token_with_counts_equal(results, name, greedy):
    got, ref = results
    np.testing.assert_array_equal(got[f"smp/tok/{name}/{greedy}"],
                                  ref[f"smp/tok/{name}/{greedy}"])


@pytest.mark.parametrize("name", list(GEN_CALLS))
def test_generator_generate_ids_equal(results, name):
    got, ref = results
    assert got[f"gen/{name}"].dtype == np.int32
    np.testing.assert_array_equal(got[f"gen/{name}"], ref[f"gen/{name}"])


@pytest.mark.parametrize("what", ["sample", "sample_kvcache",
                                  "max_supported"])
def test_generator_methods_equal(results, what):
    got, ref = results
    np.testing.assert_array_equal(got[f"gen/{what}"], ref[f"gen/{what}"])


def test_generator_names_grammar_outside_the_port(results):
    """Grammar is in the port now: generate_ids with a grammar gives JAX's
    ids (tokens equal)."""
    got, ref = results
    np.testing.assert_array_equal(got["gen/grammar"], ref["gen/grammar"])


def test_init_params_has_jax_tree_and_distributions(results):
    got, ref = results
    assert [s.lstrip("/") for s in got["init/shapes"]] == \
        [s.lstrip("/") for s in ref["init/shapes"]]
    assert bool(got["init/same_seed"])
    std, pos_max, in_max, head_max = got["init/stats"]
    assert 0.95 < std < 1.05 and pos_max == 0.0
    assert in_max <= np.sqrt(6.0 / (4 * 64)) and head_max <= np.sqrt(1 / 64)


def test_scheme_b2_vocabulary_copied(results):
    got, _ = results
    assert int(got["tok/b2_vocab"]) == len(SchemeB2().vocab) == 8324
    assert list(got["tok/schemes"]) == ["b2", "a"]


@pytest.mark.parametrize("name", list(CLI_RUNS))
def test_cli_generate_midi_bytes_equal_jax_cli(results, name):
    got, ref = results
    assert int(got[f"cli/{name}/code"]) == 0
    assert ref[f"cli/{name}/midi"].tobytes()[:4] == b"MThd"
    assert got[f"cli/{name}/midi"].tobytes() == \
        ref[f"cli/{name}/midi"].tobytes()
    head = got[f"cli/{name}/wav_head"].tobytes()
    assert head[:4] == b"RIFF" and head[8:12] == b"WAVE"


@pytest.mark.parametrize("flag", list(CLI_MODES))
def test_cli_generate_names_modes_outside_the_port(results, flag):
    """Every mode runs as the JAX CLI runs it on this checkpoint (none is
    outside the port now): ``--beams`` and ``--grammar`` to its MIDI bytes,
    ``--lookup`` and ``--medusa`` to JAX's ValueError and ``--draft`` to
    its AssertionError (they need a causal checkpoint)."""
    got, ref = results
    _, code, says = CLI_MODES[flag]
    stderr = str(got[f"cli/{flag}/stderr"])
    assert int(got[f"cli/{flag}/code"]) == code, stderr
    assert says in stderr
    if code == 2:
        assert flag in stderr
    else:
        assert "not yet in the PyTorch port" not in stderr
    if code == 0:
        assert got[f"cli/{flag}/midi"].tobytes() == \
            ref[f"cli/{flag}/midi"].tobytes()


def test_bench_module_runs_on_the_cpu_at_a_cut_size(results):
    got, _ = results
    lines = json.loads(str(got["bench/lines"]))
    assert [ln["attn_impl"] for ln in lines] == ["sp", "fold2"]
    for ln in lines:
        assert ln["n_tokens"] == 4 * 17 and ln["steps"] == 16
        assert ln["tokens_per_s"] > 0 and ln["device"] == "cpu"


def test_bench_module_wants_cuda_by_default(results):
    got, _ = results
    assert int(got["bench/no_card_code"]) != 0
    assert "device='cpu'" in str(got["bench/no_card_stderr"])
