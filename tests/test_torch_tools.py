"""The port's tools and their subcommands, C3 and the random demos
(eamg_tpu_torch/utils/checkpoint.py, serve/pipeline.py, emotion/infer.py,
tools/{metrics,section_metrics,ablation,corpus,analysis,native_loader,
feed_bench}.py, cli.py) against the JAX package on the CPU.

The torch side runs in one subprocess (tests/torch_port_tools.py, task
"tools"). Tolerances:
- C3: JAX's run_training resumed from the port's checkpoint (clip on: the
  paper preset; clip off: mini) logs the same losses, ends at the same
  step and writes bit-equal params and optimizer state as JAX resumed from
  JAX's own checkpoint of the same weights and moments; the port's own
  resume logs the same losses within the 4-decimal rounding of the log
  (2e-4); the port's tree is make_optimizer's; the old dict format loads;
- the random demos: every uniform weight bit-equal and the N(0, 1)
  embedding within ERF_INV_ULPS ulps on under 2% of its elements (as
  tests/test_torch_train.py holds init_params: XLA:CPU's log1p inside
  erf_inv rounds elsewhere), config equal, one f32 request's tokens
  equal;
- section-eval's dict equal; ablate: names, notes, steps equal, PPL and
  final loss within 1e-4 relative, MSE-Tune equal (NaN where both are);
- tokenize, analyze, the native loader and its Python fallback: equal;
- feed-bench: the same keys and the same corpus numbers;
- predict: equal labels; each new subcommand's --help exits 0 with JAX's
  flags (plus --device where the command has device work), and emotion,
  analyze and tokenize print what JAX's CLI prints.
"""

from __future__ import annotations

import contextlib
import dataclasses
import io
import json
import re
import shutil
import sys

import numpy as np
import pytest

import jax
import optax

from eamg_tpu.cli import main as jax_cli
from eamg_tpu.emotion.infer import predict as jax_predict
from eamg_tpu.serve.pipeline import (demo_pipeline, demo_pipeline_b3,
                                     packaged_demo_checkpoints)
from eamg_tpu.tokenizer import SchemeB2, SchemeB3
from eamg_tpu.tools.ablation import AblationConfig, run_ablation
from eamg_tpu.tools.analysis import analyze_corpus, write_report
from eamg_tpu.tools.corpus import build_corpus_csv
from eamg_tpu.midi.smf import Instrument, MidiSong, Note
from eamg_tpu.tools.feed_bench import run_feed_bench
from eamg_tpu.tools.metrics import estimate_bpm, tempo_mse
from eamg_tpu.tools.native_loader import explode_csv_native, native_available
from eamg_tpu.tools.section_metrics import measure_section_obedience
from eamg_tpu.train.data import iter_csv_tokens, write_synthetic_csv
from eamg_tpu.train.run import run_training
from eamg_tpu.train.trainer import make_optimizer, reference_preset
from eamg_tpu.utils.checkpoint import load_checkpoint, save_checkpoint

from port_harness import flatten, run_worker

GEOMETRY = {"d_model": 32, "n_head": 2, "n_layer": 1, "seq_len": 32}
# 3 port steps, then 2 resumed steps (B3's vocabulary is the corpus's
# whatever its rows, so the resumed run's config is the checkpoint's)
C3 = {"noclip": {"preset": "mini", "rows_train": 24, "rows_resume": 16},
      "clip": {"preset": "paper", "rows_train": 48, "rows_resume": 32}}
ABLATE = dict(n_rows=16, seq_len=32, d_model=32, n_head=2, n_layer=1,
              epochs=1, micro_batch=8, bpm_targets=[100, 140], gen_batch=1)
FEED = dict(rows=200, notes=10, steps=4, shards=2, micro_batch=4,
            d_model=32, n_head=2, n_layer=1, loss_chunk=None, seq_len=64)
REQUEST = ["we are so happy and overjoyed today.", 11]
SECTION = (3, 4)
TEXTS = ["I am so happy today", "this is terrifying", "thank you so much",
         "i miss her so much", "what a relief"]
CMDS = ["section-eval", "feed-bench", "ablate", "analyze", "tokenize",
        "emotion", "serve"]
HOST_ONLY = {"analyze", "tokenize"}
# songs for estimate_bpm: a steady 120 BPM eighth grid, a swung 90, a
# sparse one (too few onsets: None), and one whose intervals differ by
# rounding only
METRIC_SONGS = [
    [[0, False, [[90, 60 + i % 5, 0.25 * i, 0.25 * i + 0.2]
                 for i in range(16)], []]],
    [[40, False, [[80, 62, (2 / 3) * (i // 2) + (i % 2) * 0.4,
                   (2 / 3) * (i // 2) + (i % 2) * 0.4 + 0.1]
                  for i in range(20)], []]],
    [[0, False, [[90, 60, 0.0, 0.5], [90, 62, 1.0, 1.5]], []]],
    [[0, False, [[90, 60, 0.1 * i, 0.1 * i + 0.05]
                 for i in range(12)], []]]]
METRIC_TARGETS = [120.0, 90.0, 100.0, 150.0]
LOSS_LOG_ATOL = 2e-4
ERF_INV_ULPS = 3


def _jax_cli(argv) -> tuple:
    buf = io.StringIO()
    code = 0
    argv0 = list(sys.argv)
    with contextlib.redirect_stdout(buf), \
            contextlib.redirect_stderr(io.StringIO()):
        try:
            jax_cli(argv)
        except SystemExit as e:
            code = e.code
        finally:
            sys.argv = argv0
    return code, buf.getvalue()


def _flags(help_text: str) -> set:
    return set(re.findall(r"(?<![\w-])--[a-z][a-z-]*", help_text))


def _native_state(tcfg, params, adam):
    """JAX's own optimizer state for ``tcfg`` holding ``adam``'s count and
    moments (the schedule's count is the same count)."""
    count = jax.numpy.asarray(adam.count, jax.numpy.int32)

    def fill(s):
        if isinstance(s, optax.ScaleByAdamState):
            return s._replace(count=count, mu=adam.mu, nu=adam.nu)
        if isinstance(s, optax.ScaleByScheduleState):
            return s._replace(count=count)
        return s

    return jax.tree.map(
        fill, make_optimizer(tcfg).init(params),
        is_leaf=lambda s: isinstance(s, (optax.ScaleByAdamState,
                                         optax.ScaleByScheduleState)))


def _adam(tree):
    return next(s for s in jax.tree.leaves(
        tree, is_leaf=lambda s: isinstance(s, optax.ScaleByAdamState))
        if isinstance(s, optax.ScaleByAdamState))


def _losses(lines) -> list:
    return [float(m.group(1)) for m in
            (re.search(r"loss=([-+.\deE]+|nan)", ln) for ln in lines) if m]


def _python_explode(path, scheme, seq_len, strict):
    sch = (SchemeB3 if scheme == "b3" else SchemeB2)(
        seq_len=seq_len, strict_parity=strict)
    rows, lens = [], []
    for js in iter_csv_tokens(path):
        ids = sch.explode(js)
        lens.append(len(ids))
        rows.append(ids + [sch.vocab.pad_id] * (seq_len - len(ids)))
    return np.asarray(rows, np.int32), np.asarray(lens, np.int32)


@pytest.fixture(scope="module")
def results(tmp_path_factory, fixture_mid):
    tmp = tmp_path_factory.mktemp("tools")
    midi_dir = tmp / "midi"
    midi_dir.mkdir()
    shutil.copy(fixture_mid, midi_dir / fixture_mid.name)
    synth = tmp / "synth.csv"
    write_synthetic_csv(str(synth), 40, seed=3, n_notes=20)
    cases = {n: {**c, "geometry": GEOMETRY, "dir": str(tmp / f"port_{n}")}
             for n, c in C3.items()}
    inp = {"c3/cases": np.asarray(json.dumps(cases)),
           "c3/old_dir": np.asarray(str(tmp / "old_format")),
           "demo/request": np.asarray(json.dumps(REQUEST)),
           "section/args": np.asarray(SECTION),
           "ablate/cfg": np.asarray(json.dumps(ABLATE)),
           "corpus/tmp": np.asarray(str(tmp)),
           "corpus/midi_dir": np.asarray(str(midi_dir)),
           "corpus/synthetic": np.asarray(str(synth)),
           "feed/kw": np.asarray(json.dumps(FEED)),
           "metrics/songs": np.asarray(json.dumps(METRIC_SONGS)),
           "metrics/targets": np.asarray(json.dumps(METRIC_TARGETS)),
           "cli/cmds": np.asarray(json.dumps(CMDS)),
           "cli/runs": np.asarray(json.dumps({
               "emotion": ["emotion", "--text", TEXTS[0], "--seed", "3",
                           "--device", "cpu"],
               "analyze": ["analyze", "--csv", str(synth), "--out",
                           str(tmp / "port_an.txt")],
               "tokenize": ["tokenize", "--midi-dir", str(midi_dir),
                            "--out", str(tmp / "port_tok.csv")]})),
           "predict/texts": np.asarray(json.dumps(TEXTS)),
           "serve/argvs": np.asarray(json.dumps({
               "random": ["serve", "--random-demo", "--device", "cpu"],
               "random_coalesce": ["serve", "--random-demo", "--coalesce",
                                   "--engine-medusa", "--device", "cpu"]}))}
    got = run_worker("tools", inp, tmp, timeout=900)
    return got, tmp, midi_dir, synth


# ----------------------------------------------------------------------- C3

@pytest.mark.parametrize("name", list(C3))
def test_jax_resumes_from_the_ports_checkpoint(results, name):
    got, tmp, _, _ = results
    case = C3[name]
    port_final = tmp / f"port_{name}" / "final"
    port = load_checkpoint(str(port_final))
    assert json.loads(str(got[f"c3/{name}/train"]))["steps"] == 3
    tcfg = reference_preset(case["preset"])
    like = make_optimizer(tcfg).init(port["params"])
    assert jax.tree.structure(port["opt_state"]) == jax.tree.structure(like)
    adam = _adam(port["opt_state"])
    assert int(adam.count) == 3 and adam.count.dtype == np.int32
    own = tmp / f"jax_own_{name}"
    save_checkpoint(str(own), port["params"], port["vocab"], port["cfg"],
                    opt_state=_native_state(tcfg, port["params"], adam),
                    step=port["step"], extra=port["extra"])
    runs = {}
    for src, path in (("port", port_final), ("jax", own)):
        lines = []
        summary = run_training(
            case["preset"], synthetic_rows=case["rows_resume"],
            scheme="b3", epochs=1, geometry=GEOMETRY, log_every=1,
            log_fn=lines.append, out_dir=str(tmp / f"resumed_{name}_{src}"),
            resume_from=str(path))
        runs[src] = (summary, lines,
                     load_checkpoint(str(tmp / f"resumed_{name}_{src}"
                                         / "final")))
    (s_p, l_p, c_p), (s_j, l_j, c_j) = runs["port"], runs["jax"]
    assert s_p["steps"] == s_j["steps"] == 5
    assert l_p == l_j and len(_losses(l_p)) == 2
    assert s_p["final_loss"] == s_j["final_loss"]
    for a, b in zip(jax.tree.leaves(c_p["params"]),
                    jax.tree.leaves(c_j["params"])):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(jax.tree.leaves(c_p["opt_state"]),
                    jax.tree.leaves(c_j["opt_state"])):
        np.testing.assert_array_equal(a, b)
    # the port's own resume continues the same way
    port_log = json.loads(str(got[f"c3/{name}/port_resume_log"]))
    np.testing.assert_allclose(_losses(port_log), _losses(l_j), rtol=0,
                               atol=LOSS_LOG_ATOL)


def test_old_dict_optimizer_state_still_loads(results):
    got, _, _, _ = results
    assert int(got["c3/old/count"]) == 7
    np.testing.assert_array_equal(got["c3/old/mu"], np.full((2, 3), 0.5))
    np.testing.assert_array_equal(got["c3/old/nu"], np.full((2, 3), 0.25))
    assert bool(got["c3/old/params_equal"])


# --------------------------------------------------------------- the demos

@pytest.mark.parametrize("name", ["a", "b3"])
def test_random_demo_equals_jax(results, name):
    got, _, _, _ = results
    pipe = demo_pipeline() if name == "a" else demo_pipeline_b3()
    want = flatten(jax.tree.map(np.asarray, pipe.generator.params),
                   f"demo/{name}/p")
    assert set(want) == {k for k in got if k.startswith(f"demo/{name}/p/")}
    for k, w in want.items():
        if k.endswith("/tok_emb"):
            # N(0, 1) through erf_inv: XLA:CPU's log1p rounds elsewhere
            # (tests/test_torch_train.py holds init_params the same way)
            ulps = np.abs(got[k].view(np.int32).astype(np.int64)
                          - w.view(np.int32).astype(np.int64))
            assert ulps.max() <= ERF_INV_ULPS and (ulps > 0).mean() < 0.02
        else:
            np.testing.assert_array_equal(got[k], w, err_msg=k)
    assert json.loads(str(got[f"demo/{name}/cfg"])) == dataclasses.asdict(
        pipe.generator.cfg)
    r = pipe.generate(REQUEST[0], seed=REQUEST[1], render_audio=False)
    assert json.loads(str(got[f"demo/{name}/tokens"])) == list(r.tokens)
    assert len(r.tokens) > len(r.prompt_tokens)


def test_section_eval_equals_jax(results):
    got, _, _, _ = results
    want = measure_section_obedience(demo_pipeline(corrected=True),
                                     n_prompts=SECTION[0], seed=SECTION[1])
    assert json.loads(str(got["section/metrics"])) == want
    assert want["n_sections"] >= 3


def test_ablate_equals_jax(results):
    got, _, _, _ = results
    want = run_ablation(AblationConfig(**ABLATE, log_fn=lambda *_: None))
    rows = json.loads(str(got["ablate/rows"]))
    assert [r["name"] for r in rows] == [w.name for w in want]
    for r, w in zip(rows, want):
        assert r["notes"] == w.notes and r["train_steps"] == w.train_steps
        np.testing.assert_allclose(r["ppl"], w.ppl, rtol=1e-4)
        np.testing.assert_allclose(r["final_loss"], w.final_loss, rtol=1e-4)
        np.testing.assert_equal(r["mse_tune"], w.mse_tune)
        assert r["ms_per_token"] > 0
    # the uncached row is the same model: the same PPL by construction
    assert rows[0]["ppl"] == rows[1]["ppl"]
    assert int(got["ablate/table_lines"]) == 5


# ------------------------------------------------------------- the corpus

def test_tokenize_and_analyze_equal_jax(results):
    got, tmp, midi_dir, synth = results
    res = build_corpus_csv(str(midi_dir), str(tmp / "jax.csv"))
    assert json.loads(str(got["corpus/result"])) == res
    assert res["written"] == 1
    assert bytes(got["corpus/csv"]) == (tmp / "jax.csv").read_bytes()
    stats = analyze_corpus(str(synth), max_rows=None)
    assert json.loads(str(got["analyze/stats"])) == json.loads(
        json.dumps(stats, sort_keys=True))
    write_report(stats, str(tmp / "jax_report.txt"))
    assert str(got["analyze/report"]) == (tmp / "jax_report.txt").read_text(
        encoding="utf-8")


@pytest.mark.parametrize("scheme", ["b2", "b3"])
@pytest.mark.parametrize("strict", [True, False])
def test_native_loader_and_fallback_equal_jax(results, scheme, strict):
    got, _, _, synth = results
    k = f"explode/{scheme}/{int(strict)}"
    ids_p, lens_p = _python_explode(str(synth), scheme, 128, strict)
    np.testing.assert_array_equal(got[f"{k}/py_ids"], ids_p)
    np.testing.assert_array_equal(got[f"{k}/py_lens"], lens_p)
    assert bool(got["native/available"]) == native_available()
    want = explode_csv_native(str(synth), scheme, seq_len=128,
                              strict_parity=strict) \
        if native_available() else (ids_p, lens_p)
    np.testing.assert_array_equal(got[f"{k}/ids"], want[0])
    np.testing.assert_array_equal(got[f"{k}/lens"], want[1])


def _jax_song(spec) -> MidiSong:
    song = MidiSong()
    for prog, drum, notes, _ in spec:
        inst = Instrument(program=prog, is_drum=drum)
        inst.notes.extend(Note(v, p, s, e) for v, p, s, e in notes)
        song.instruments.append(inst)
    return song


def test_tempo_metrics_equal_jax(results):
    got, _, _, _ = results
    want = [estimate_bpm(_jax_song(sp)) for sp in METRIC_SONGS]
    assert json.loads(str(got["metrics/bpm"])) == want
    assert want[2] is None and want[0] is not None
    np.testing.assert_equal(float(got["metrics/mse"]),
                            tempo_mse(list(zip(METRIC_TARGETS, want))))
    # where numpy refuses the bins, the median interval: the mode up to
    # the bins' width on a grid, the same answer where the intervals are
    # equal but for rounding
    refused = json.loads(str(got["metrics/refused_bpm"]))
    assert refused[2] is None
    assert refused[3] == pytest.approx(want[3], rel=1e-9)
    assert refused[0] == pytest.approx(want[0], rel=0.05)


def test_feed_bench_same_keys_and_corpus(results):
    got, _, _, _ = results
    want = run_feed_bench(**FEED)
    out = json.loads(str(got["feed/result"]))
    assert set(out) == set(want)
    for k in ("rows", "csv_mb", "corpus_tokens", "native_loader"):
        assert out[k] == want[k], k
    for k in ("host_tokens_per_s", "python_tokens_per_s",
              "device_tokens_per_s", "streamed_step_ms"):
        assert out[k] > 0, k


# -------------------------------------------------------- predict and CLI

def test_predict_equals_jax(results):
    got, _, _, _ = results
    assert json.loads(str(got["predict/labels"])) == [jax_predict(t)
                                                      for t in TEXTS]
    assert bool(got["predict/same_object"])


@pytest.mark.parametrize("cmd", CMDS)
def test_subcommand_help_has_jax_flags(results, cmd):
    got, _, _, _ = results
    code, text = _jax_cli([cmd, "--help"])
    assert code == 0 and int(got[f"cli/help/{cmd}/code"]) == 0
    extra = set() if cmd in HOST_ONLY else {"--device"}
    assert _flags(str(got[f"cli/help/{cmd}/text"])) == _flags(text) | extra


@pytest.mark.parametrize("name", ["emotion", "analyze", "tokenize"])
def test_subcommand_output_equals_jax(results, name):
    got, tmp, midi_dir, synth = results
    argv = {"emotion": ["emotion", "--text", TEXTS[0], "--seed", "3"],
            "analyze": ["analyze", "--csv", str(synth), "--out",
                        str(tmp / "jax_an.txt")],
            "tokenize": ["tokenize", "--midi-dir", str(midi_dir), "--out",
                         str(tmp / "jax_tok.csv")]}[name]
    code, text = _jax_cli(argv)
    assert code in (0, None)
    assert int(got[f"cli/run/{name}/code"]) == 0
    port = str(got[f"cli/run/{name}/stdout"])
    if name == "emotion":
        assert port == text
    else:
        tag = "an.txt" if name == "analyze" else "tok.csv"
        assert port.replace(f"port_{tag}", f"jax_{tag}") == text
        assert (tmp / f"port_{tag}").read_bytes() == \
            (tmp / f"jax_{tag}").read_bytes()


def test_serve_random_demo_picks_jaxs_model(results):
    got, _, _, _ = results
    plain = json.loads(str(got["serve/random/cfg"]))
    assert plain == dataclasses.asdict(demo_pipeline().generator.cfg)
    assert not plain["causal"] and not bool(got["serve/random/engine"])
    co = json.loads(str(got["serve/random_coalesce/cfg"]))
    assert co == dataclasses.asdict(demo_pipeline(corrected=True)
                                    .generator.cfg)
    assert bool(got["serve/random_coalesce/engine"])
    assert "--engine-medusa ignored: the random demo pipeline has no " \
        "medusa heads" in str(got["serve/random_coalesce/stdout"])
    assert set(packaged_demo_checkpoints()) == {"a", "b3"}
