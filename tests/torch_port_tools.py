"""The PyTorch side of tests/test_torch_sf2.py and tests/test_torch_tools.py:
one task a file, run by tests/torch_port_worker.py in its subprocess
(torch never enters the pytest process). Everything runs on the CPU."""

from __future__ import annotations

import contextlib
import dataclasses
import io
import json
import os

import numpy as np

from torch_port_worker import CPU, _named_leaves, _raised

# ---------------------------------------------------------------------- sf2


def song_from_spec(spec):
    """[[program, is_drum, [[vel, pitch, start, end], ...],
    [[bend, time], ...]], ...] -> the port's MidiSong."""
    from eamg_tpu_torch.midi.smf import Instrument, MidiSong, Note, PitchBend

    song = MidiSong()
    for prog, drum, notes, bends in spec:
        inst = Instrument(program=prog, is_drum=drum)
        inst.notes.extend(Note(v, p, s, e) for v, p, s, e in notes)
        inst.pitch_bends.extend(PitchBend(pitch=b, time=t) for b, t in bends)
        song.instruments.append(inst)
    return song


def _font_json(sf) -> str:
    return json.dumps({
        "presets": {f"{b}/{p}": [dataclasses.asdict(v) for v in vs]
                    for (b, p), vs in sorted(sf.presets.items())},
        "info": sf.info, "n_mods_other": sf.n_mods_other})


def _wav_bytes(fn) -> np.ndarray:
    buf = io.BytesIO()
    fn(buf)
    return np.frombuffer(buf.getvalue(), np.uint8)


def _auto_checks(inp, out, font_path):
    """render_to_wav_auto with a soundfont and no binary (rung 2), and
    with EAMG_NO_SF2 (the additive synth)."""
    from eamg_tpu_torch.audio import fluidsynth as fs

    song = song_from_spec(json.loads(str(inp["auto/song"])))
    env = {"EAMG_SOUNDFONT": font_path,
           "EAMG_FLUIDSYNTH": "/nonexistent/fluidsynth"}
    saved = {k: os.environ.get(k) for k in (*env, "EAMG_NO_SF2",
                                            "EAMG_NO_FLUIDSYNTH")}
    try:
        os.environ.update(env)
        os.environ.pop("EAMG_NO_SF2", None)
        os.environ.pop("EAMG_NO_FLUIDSYNTH", None)
        fs._sf2_renderers.clear()
        out["auto/sf2"] = _wav_bytes(lambda f: fs.render_to_wav_auto(
            song, f, seed=3, device=CPU))
        out["auto/renderers"] = np.asarray(len(fs._sf2_renderers))
        os.environ["EAMG_NO_SF2"] = "1"
        out["auto/no_sf2"] = _wav_bytes(lambda f: fs.render_to_wav_auto(
            song, f, seed=3, device=CPU))
        # a file that is not a soundfont: the parser's ValueError falls
        # through to the additive synth, as in JAX
        del os.environ["EAMG_NO_SF2"]
        bad = font_path + ".bad.sf2"
        with open(bad, "wb") as f:
            f.write(b"RIFF\0\0\0\0notafont")
        os.environ["EAMG_SOUNDFONT"] = bad
        out["auto/bad_font"] = _wav_bytes(lambda f: fs.render_to_wav_auto(
            song, f, seed=3, device=CPU))
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        fs._sf2_renderers.clear()


def _native_voice_checks(inp, out, renderer):
    """One voice: the C++ twin against the port's tile (unfiltered)."""
    import torch

    from eamg_tpu_torch.audio import native_synth as ns
    from eamg_tpu_torch.audio.sampler import render_voices
    from eamg_tpu_torch.audio.sf2 import (_abs_cents_to_hz, _cb_to_gain,
                                          vel_to_atten_cb, vel_to_fc_cents)

    out["native/available"] = np.asarray(ns.native_synth_available())
    if not ns.native_synth_available():
        return
    n_total, d_samples = (int(x) for x in inp["native/sizes"])
    for i, spec in enumerate(json.loads(str(inp["native/songs"]))):
        rows, _ = renderer._voices_for(song_from_spec(spec))
        row = rows[0]
        out[f"native/{i}/port"] = render_voices(
            renderer.bank, torch.tensor([row], dtype=torch.float32),
            n_total, d_samples).numpy()
        out[f"native/{i}/cpp"] = ns.sf2_voice_native(
            renderer.bank.numpy(), row, n_total, d_samples)
    helpers = []
    for vel in (1, 17, 40, 64, 99, 127):
        for amt in (0.0, 480.0, 960.0):
            helpers.append((ns.vel2att_gain_native(vel, amt),
                            _cb_to_gain(vel_to_atten_cb(vel, amt))))
        for fc in (8321.0, 13500.0):
            for amt in (0.0, -1200.0, -2400.0):
                helpers.append((ns.vel2fc_hz_native(fc, vel, amt), min(
                    _abs_cents_to_hz(fc + vel_to_fc_cents(vel, amt)),
                    20000.0)))
    out["native/helpers"] = np.asarray(helpers, np.float64)


def task_sf2(inp, out):
    """tests/test_torch_sf2.py: parse_sf2 of the fixture font, the voice
    rows and the render of each case, render_to_wav_auto's rungs, the
    golden song's render and one voice against the C++ twin."""
    import tempfile

    from eamg_tpu_torch.audio.sampler import Sf2Renderer
    from eamg_tpu_torch.audio.sf2 import load_sf2, parse_sf2
    from eamg_tpu_torch.audio.synth import write_wav

    font = inp["font"].tobytes()
    sf = parse_sf2(font)
    out["parse/json"] = np.asarray(_font_json(sf))
    out["parse/samples"] = sf.samples
    out["parse/bad"] = _raised(lambda: parse_sf2(b"RIFF\0\0\0\0nope"))
    renderer = Sf2Renderer(sf, device=CPU)
    for name, case in json.loads(str(inp["cases"])).items():
        song = song_from_spec(case["song"])
        rows, left = renderer._voices_for(song)
        out[f"case/{name}/rows"] = np.asarray(rows, np.float64).reshape(
            -1, 20)
        out[f"case/{name}/leftovers"] = np.asarray(
            sum(len(i.notes) for i in left))
        wave = renderer.render_song(song, tail=case["tail"],
                                    seed=case["seed"])
        out[f"case/{name}/wave"] = wave
        out[f"case/{name}/wav"] = _wav_bytes(lambda f: write_wav(f, wave))
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "fixture.sf2")
        with open(path, "wb") as f:
            f.write(font)
        out["parse/load_equal"] = np.asarray(
            _font_json(load_sf2(path)) == _font_json(sf))
        _auto_checks(inp, out, path)
        out["method/wav"] = _wav_bytes(lambda f: renderer.render_to_wav(
            song_from_spec(json.loads(str(inp["auto/song"]))), f, seed=3))
    out["golden/wave"] = renderer.render_song(
        song_from_spec(json.loads(str(inp["golden/song"]))))
    _native_voice_checks(inp, out, renderer)


# -------------------------------------------------------------------- tools

def _c3_checks(inp, out):
    """Port runs of the test's cases: 3 steps saved, then (for comparison)
    the port's own 2-step resume; an optimizer state in the old dict
    format read back."""
    import pickle
    import shutil

    from eamg_tpu_torch.train.run import run_training
    from eamg_tpu_torch.utils.checkpoint import load_checkpoint

    for name, case in json.loads(str(inp["c3/cases"])).items():
        kw = dict(scheme="b3", epochs=1, log_every=1,
                  geometry=case["geometry"], device=CPU)
        lines = []
        out[f"c3/{name}/train"] = np.asarray(json.dumps(run_training(
            case["preset"], synthetic_rows=case["rows_train"],
            out_dir=case["dir"], log_fn=lines.append, **kw)))
        lines = []
        run_training(case["preset"], synthetic_rows=case["rows_resume"],
                     out_dir=case["dir"] + "_port_resume",
                     resume_from=case["dir"] + "/final",
                     log_fn=lines.append, **kw)
        out[f"c3/{name}/port_resume_log"] = np.asarray(json.dumps(lines))
    d = str(inp["c3/old_dir"])
    shutil.copytree(case["dir"] + "/final", d)
    ck = load_checkpoint(d)
    with open(os.path.join(d, "opt_state.pkl"), "wb") as f:
        pickle.dump({"count": np.asarray(7, np.int32),
                     "mu": {"w": np.full((2, 3), 0.5, np.float32)},
                     "nu": {"w": np.full((2, 3), 0.25, np.float32)}}, f)
    old = load_checkpoint(d)["opt_state"]
    out["c3/old/count"] = np.asarray(old["count"])
    out["c3/old/mu"] = old["mu"]["w"].numpy()
    out["c3/old/nu"] = old["nu"]["w"].numpy()
    out["c3/old/params_equal"] = np.asarray(all(
        bool((a == b).all()) for a, b in zip(
            _leaves(ck["params"]), _leaves(load_checkpoint(d)["params"]))))


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def _demo_checks(inp, out):
    """The random demo pipelines' weights and one request each, and the
    section metric on the corrected one."""
    from eamg_tpu_torch.serve import demo_pipeline, demo_pipeline_b3
    from eamg_tpu_torch.tools.section_metrics import (
        measure_section_obedience)

    text, seed = json.loads(str(inp["demo/request"]))
    for name, make in (("a", lambda: demo_pipeline(device=CPU)),
                       ("b3", lambda: demo_pipeline_b3(device=CPU))):
        pipe = make()
        out.update(_named_leaves(pipe.generator.params, f"demo/{name}/p"))
        out[f"demo/{name}/cfg"] = np.asarray(json.dumps(
            dataclasses.asdict(pipe.generator.cfg)))
        r = pipe.generate(text, seed=seed, render_audio=False)
        out[f"demo/{name}/tokens"] = np.asarray(json.dumps(r.tokens))
    pipe = demo_pipeline(corrected=True, device=CPU)
    n, sd = (int(x) for x in inp["section/args"])
    out["section/metrics"] = np.asarray(json.dumps(
        measure_section_obedience(pipe, n_prompts=n, seed=sd)))


def _ablation_checks(inp, out):
    from eamg_tpu_torch.tools.ablation import (AblationConfig,
                                               markdown_table, run_ablation)

    kw = json.loads(str(inp["ablate/cfg"]))
    rows = run_ablation(AblationConfig(**kw, log_fn=lambda *_: None),
                        device=CPU)
    out["ablate/rows"] = np.asarray(json.dumps(
        [dataclasses.asdict(r) for r in rows]))
    out["ablate/table_lines"] = np.asarray(
        markdown_table(rows).count("\n"))


def _corpus_checks(inp, out):
    """tokenize / analyze / the native loader and its fallback."""
    from eamg_tpu_torch.tools import native_loader as nl
    from eamg_tpu_torch.tools.analysis import analyze_corpus, write_report
    from eamg_tpu_torch.tools.corpus import build_corpus_csv

    tmp = str(inp["corpus/tmp"])
    res = build_corpus_csv(str(inp["corpus/midi_dir"]), f"{tmp}/port.csv")
    out["corpus/result"] = np.asarray(json.dumps(res))
    with open(f"{tmp}/port.csv", "rb") as f:
        out["corpus/csv"] = np.frombuffer(f.read(), np.uint8)
    synth = str(inp["corpus/synthetic"])
    stats = analyze_corpus(synth, max_rows=None)
    out["analyze/stats"] = np.asarray(json.dumps(stats, sort_keys=True))
    write_report(stats, f"{tmp}/port_report.txt")
    with open(f"{tmp}/port_report.txt", encoding="utf-8") as f:
        out["analyze/report"] = np.asarray(f.read())
    out["native/available"] = np.asarray(nl.native_available())
    for scheme in ("b2", "b3"):
        for strict in (True, False):
            k = f"explode/{scheme}/{int(strict)}"
            ids, lens = nl.explode_csv(synth, scheme, seq_len=128,
                                       strict_parity=strict)
            out[f"{k}/ids"], out[f"{k}/lens"] = ids, lens
            ids, lens = nl.explode_csv_python(synth, scheme, seq_len=128,
                                              strict_parity=strict)
            out[f"{k}/py_ids"], out[f"{k}/py_lens"] = ids, lens


def _metrics_checks(inp, out):
    """estimate_bpm and tempo_mse on the test's songs; estimate_bpm where
    numpy refuses the bins (newer numpy on a range of a few ulps)."""
    from unittest import mock

    from eamg_tpu_torch.tools import metrics

    songs = json.loads(str(inp["metrics/songs"]))
    bpms = [metrics.estimate_bpm(song_from_spec(sp)) for sp in songs]
    out["metrics/bpm"] = np.asarray(json.dumps(bpms))
    out["metrics/mse"] = np.asarray(metrics.tempo_mse(
        [(t, b) for t, b in zip(json.loads(str(inp["metrics/targets"])),
                                bpms)]))

    def refuse(*a, **k):
        raise ValueError("Too many bins for data range. Cannot create 48 "
                         "finite-sized bins.")

    with mock.patch.object(metrics.np, "histogram", refuse):
        out["metrics/refused_bpm"] = np.asarray(json.dumps(
            [metrics.estimate_bpm(song_from_spec(sp)) for sp in songs]))


def _feed_checks(inp, out):
    from eamg_tpu_torch.tools.feed_bench import run_feed_bench

    out["feed/result"] = np.asarray(json.dumps(run_feed_bench(
        **json.loads(str(inp["feed/kw"])), device=CPU)))


def _cli_out(argv) -> tuple:
    from eamg_tpu_torch import cli

    buf = io.StringIO()
    code = None
    with contextlib.redirect_stdout(buf), \
            contextlib.redirect_stderr(io.StringIO()):
        try:
            code = cli.main(argv)
        except SystemExit as e:
            code = e.code
    return code, buf.getvalue()


def _cli_checks(inp, out):
    """Each new subcommand's --help and the outputs of the cheap ones;
    serve's --random-demo pipelines."""
    from eamg_tpu_torch import cli
    from eamg_tpu_torch.emotion import default_classifier, predict
    from eamg_tpu_torch.serve.continuous import ContinuousBatcher

    for cmd in json.loads(str(inp["cli/cmds"])):
        code, text = _cli_out([cmd, "--help"])
        out[f"cli/help/{cmd}/code"] = np.asarray(code)
        out[f"cli/help/{cmd}/text"] = np.asarray(text)
    for name, argv in json.loads(str(inp["cli/runs"])).items():
        code, text = _cli_out(argv)
        out[f"cli/run/{name}/code"] = np.asarray(code)
        out[f"cli/run/{name}/stdout"] = np.asarray(text)
    texts = json.loads(str(inp["predict/texts"]))
    out["predict/labels"] = np.asarray(json.dumps(
        [predict(t, device=CPU) for t in texts]))
    out["predict/same_object"] = np.asarray(
        default_classifier(CPU) is default_classifier("cpu"))
    for name, argv in json.loads(str(inp["serve/argvs"])).items():
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            pipe = cli.pipeline_from_args(cli.parse_args(argv))
        out[f"serve/{name}/cfg"] = np.asarray(json.dumps(
            dataclasses.asdict(pipe.generator.cfg)))
        out[f"serve/{name}/engine"] = np.asarray(
            isinstance(pipe.batcher, ContinuousBatcher))
        out[f"serve/{name}/stdout"] = np.asarray(buf.getvalue())
        if pipe.batcher is not None:
            pipe.batcher.close()


def task_tools(inp, out):
    """tests/test_torch_tools.py: C3, the random demos, section-eval,
    ablate, the corpus tools, feed-bench, predict and the CLI."""
    _c3_checks(inp, out)
    _demo_checks(inp, out)
    _ablation_checks(inp, out)
    _corpus_checks(inp, out)
    _metrics_checks(inp, out)
    _feed_checks(inp, out)
    _cli_checks(inp, out)


TOOLS_TASKS = {"sf2": task_sf2, "tools": task_tools}
