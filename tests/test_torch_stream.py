"""The port's streaming decode, sections and SSE serving against the JAX
package, on the CPU.

Same inputs (numpy, from a seed) and the same weights (JAX parameter trees
as numpy arrays) go through the JAX package here and through
``eamg_tpu_torch`` in one subprocess (tests/torch_port_worker.py, task
``stream``); torch never enters this process.

Checked, with the tolerance and its reason:
- ``decode/stream.py::stream_tokens`` on a small f32 model (L2, d64,
  GQA-2): token-equal to JAX's ``stream_tokens``, greedy, three sampled
  seeds, temperature 0.7, repetition penalty 1.3, ``no_repeat_ngram`` 3,
  top-p and min-p, at chunks 8 and 32, an EOS, and a prompt at
  ``max_len - 1``; two streams of one graph key at once, the first held
  after its first token while the second runs to its end; the greedy stream token-equal to ``generate_kv``
  without refeed (JAX's own contract), the port's and JAX's;
- ``generate_full`` (the uncached loop, whose temperature and penalties
  now go to the sampler as tensors) at temperature 0.7 and repetition
  penalty 1.3: token-equal to JAX's;
- the engine's ``submit_stream``: its deltas, concatenated, equal
  ``submit()``'s result less the prompt, three rows at once; a stream
  closed after its first delta frees its slot;
- ``POST /generate?stream=1`` (the page's default request) on three
  servers, the solo Scheme-A ``demo_pipeline``, the same model causal
  behind a continuous engine (``serve --coalesce``), and the Scheme-B3
  ``demo_pipeline_b3``: ``text/event-stream``, events meta, tokens..., done
  in order; the done event's MIDI bytes equal JAX's ``generate_stream``'s
  for the same seed and the MIDI made from the concatenated deltas; the
  same seed twice gives the same bytes; ``sections=1``, streamed and not,
  gives JAX's MIDI bytes for a three-sentence prompt;
- the SSE contract: a malformed number answers 422 before any 200 header;
  a medusa stream on the coalescing server, whose causal model has Medusa
  heads attached, answers 200 and decodes solo; lookup and beams answer
  JAX's 422 (they do not stream); a grammar stream answers 200; a WAV
  stream's done event carries RIFF....WAVE.
"""

from __future__ import annotations

import base64
import io
import json

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from eamg_tpu.decode.loop import generate_full, generate_kv
from eamg_tpu.decode.stream import stream_tokens
from eamg_tpu.models.gpt import GPTConfig
from eamg_tpu.midi.smf import MidiSong
from eamg_tpu.serve.pipeline import (_merge_song, demo_pipeline,
                                     demo_pipeline_b3)
from eamg_tpu.tokenizer import SchemeB3, tokens_to_song

from port_harness import cfg_json, flatten, perturbed_params, run_worker

CFG = GPTConfig(vocab_size=97, seq_len=48, d_model=64, n_head=4, n_layer=2,
                n_kv_heads=2, causal=True)
MAX_LEN, EOS, PROMPT = 40, 3, [5, 9, 13, 7]
LONG_PROMPT = [int(i) for i in
               np.random.default_rng(11).integers(4, 97, MAX_LEN - 1)]
# name: stream_tokens keywords (prompt PROMPT unless given)
STREAMS = {
    "greedy_c8": dict(chunk=8, greedy=True),
    "greedy_c32": dict(chunk=32, greedy=True),
    **{f"seed{s}_c{c}": dict(chunk=c, seed=s, eos_id=EOS)
       for s in (0, 1, 2) for c in (8, 32)},
    "temp07_c8": dict(chunk=8, seed=6, temperature=0.7, top_k=20),
    "rep13_c8": dict(chunk=8, seed=4, penalties=[1.3, 0.0, 0.0]),
    "rep13_c32": dict(chunk=32, seed=4, penalties=[1.3, 0.2, 0.1]),
    "ngram3_c8": dict(chunk=8, seed=5, no_repeat_ngram=3, top_k=5),
    "ngram3_c32": dict(chunk=32, greedy=True, no_repeat_ngram=3),
    "top_p_min_p_c8": dict(chunk=8, seed=7, top_p=0.9, min_p=0.05),
    "long_prompt": dict(chunk=8, seed=8, prompt=LONG_PROMPT),
}
# two streams of one graph key at once: the first held after its first
# token while the second runs to its end
STALLED = ("seed1_c8", "seed2_c8")
FULL_SEEDS = (1, 2)
FULL = dict(temperature=0.7, penalties=(1.3, 0.0, 0.0), top_k=20)
# engine rows streamed at once: (prompt ids, seed, temperature)
ENGINE = {"slots": 4, "chunk": 8}
ENGINE_REQS = [([11, 12, 13], 101, 1.0), ([21, 22], 202, 0.8),
               ([31, 32, 33, 34, 35], 303, 1.2)]
TEXT1 = "I finally got the job, I am so happy!"
TEXT3 = ("I finally got the job, I am so happy! Then the rain came and I "
         "miss you. Why would they do that to me, I am furious.")
SEED1, SEED3 = 5, 7
CO_ENGINE = {"slots": 4, "chunk": 8}
SERVERS = ("a", "co", "b3")
# requests every server gets: name -> (query, form fields)
CALLS = {
    "stream": ("?stream=1&format=midi", {"prompt": TEXT1, "seed": SEED1}),
    "stream_again": ("?stream=1&format=midi",
                     {"prompt": TEXT1, "seed": SEED1}),
    "sections_stream": ("?format=midi", {"prompt": TEXT3, "seed": SEED3,
                                         "stream": "1", "sections": "1"}),
    "sections": ("?format=midi", {"prompt": TEXT3, "seed": SEED3,
                                  "sections": "1"}),
}
# ... and the solo Scheme-A server alone: name -> (query, fields, status,
# what the body holds or its error names)
CONTRACT = {
    "wav_stream": ("?stream=1", {"prompt": TEXT1, "seed": SEED1}, 200,
                   "RIFF"),
    "bad_seed": ("?stream=1", {"prompt": TEXT1, "seed": "abc"}, 422,
                 "seed"),
    "bad_top_p": ("?stream=1", {"prompt": TEXT1, "top_p": "x"}, 422,
                  "top_p"),
    "medusa": ("?stream=1", {"prompt": TEXT1, "medusa": "1"}, 200,
               "RIFF"),
    "lookup": ("", {"prompt": TEXT1, "stream": "1", "lookup": "true"}, 422,
               "lookup"),
    "grammar": ("?stream=1", {"prompt": TEXT1, "grammar": "1"}, 200,
                "RIFF"),
    "beams": ("?stream=1", {"prompt": TEXT1, "beams": "2"}, 422, "beams"),
}
# the contract's calls go to the solo Scheme-A server but these: the
# medusa stream needs a causal model with heads
CONTRACT_SERVER = {"medusa": "co"}


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _stream_cases(params, inp, ref):
    jp = jax.tree.map(jnp.asarray, params)
    spec = {}
    for name, kw in STREAMS.items():
        kw = dict(kw)
        prompt = kw.pop("prompt", PROMPT)
        if "penalties" in kw:
            kw["penalties"] = tuple(kw["penalties"])
        ref[("stream", name)] = np.asarray(list(stream_tokens(
            jp, CFG, prompt, MAX_LEN, **kw)), np.int64)
        spec[name] = {"prompt": prompt, **kw}
    inp["streams"] = np.asarray(json.dumps(spec))
    inp["stalled"] = np.asarray(json.dumps(STALLED))
    p = len(PROMPT)
    prompt = np.zeros((1, 16), np.int32)
    prompt[0, :p] = PROMPT
    buf, n = generate_kv(jp, jnp.asarray(prompt), p, jax.random.PRNGKey(0),
                         CFG, MAX_LEN, greedy=True, refeed_last_prompt=False)
    ref["kv_greedy"] = np.asarray(buf)[0, p:int(n)]
    for seed in FULL_SEEDS:
        buf, n = generate_full(jp, jnp.asarray(prompt), p,
                               jax.random.PRNGKey(seed), CFG, MAX_LEN,
                               eos_id=EOS, **FULL)
        ref[("full", seed)] = np.asarray(buf)[0, :int(n)]


def _pipe_inputs(pipe, tag, inp):
    gen = pipe.generator
    inp.update(flatten(_np_tree(gen.params), f"{tag}/p"))
    inp[f"{tag}/cfg"] = cfg_json(gen.cfg)
    inp[f"{tag}/vocab"] = np.asarray(json.dumps(gen.vocab.tok2id))


def _done(events):
    return base64.b64decode(events[-1]["midi_b64"])


def _ids(events):
    """The token deltas of a stream's events, concatenated."""
    return [i for e in events if e["event"] == "tokens" for i in e["ids"]]


def _pipeline_cases(inp, ref):
    pipes = {"a": demo_pipeline(), "b3": demo_pipeline_b3(),
             "co": demo_pipeline(corrected=True, coalesce="continuous",
                                 coalesce_opts=CO_ENGINE)}
    try:
        for tag, pipe in pipes.items():
            _pipe_inputs(pipe, tag, inp)
            ev = list(pipe.generate_stream(TEXT1, seed=SEED1,
                                           render_audio=False))
            ref[(tag, "stream")] = ev
            ref[(tag, "sections_stream")] = list(pipe.generate_stream(
                TEXT3, seed=SEED3, sections=True, render_audio=False))
            ref[(tag, "sections")] = pipe.generate_sections(
                TEXT3, seed=SEED3, render_audio=False).midi_bytes
    finally:
        pipes["co"].batcher.close()
    inp["co/engine"] = np.asarray(json.dumps(CO_ENGINE))
    inp["calls"] = np.asarray(json.dumps(CALLS))
    inp["contract"] = np.asarray(json.dumps(
        {k: v[:2] for k, v in CONTRACT.items()}))
    inp["contract_server"] = np.asarray(json.dumps(CONTRACT_SERVER))
    d = pipes["co"].generator.cfg.d_model
    heads = np.random.default_rng(3).standard_normal((4, 2, d, d))
    inp.update(flatten({"blocks": [
        {"w": (0.03 * h[0]).astype(np.float32),
         "b": (0.1 * h[1, 0]).astype(np.float32)} for h in heads]},
        "co/heads"))


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    rng = np.random.default_rng(1111)
    params = perturbed_params(CFG, rng)
    inp = {"model/cfg": cfg_json(CFG), "max_len": np.asarray(MAX_LEN),
           "eos": np.asarray(EOS), "prompt": np.asarray(PROMPT),
           "full_seeds": np.asarray(FULL_SEEDS),
           "full": np.asarray(json.dumps(FULL)),
           "engine": np.asarray(json.dumps(ENGINE)),
           "engine_reqs": np.asarray(json.dumps(ENGINE_REQS))}
    inp.update(flatten(params, "model/p"))
    ref = {}
    _stream_cases(params, inp, ref)
    _pipeline_cases(inp, ref)
    got = run_worker("stream", inp, tmp_path_factory.mktemp("stream"),
                     timeout=900)
    return got, ref


def _sse(body: np.ndarray) -> list:
    """An SSE body -> its events, each ``data: {json}`` and a blank line."""
    events = []
    for block in body.tobytes().split(b"\n\n"):
        if block:
            assert block.startswith(b"data: "), block[:40]
            events.append(json.loads(block[len(b"data: "):]))
    return events


@pytest.mark.parametrize("name", list(STREAMS))
def test_stream_tokens_match_jax(results, name):
    got, ref = results
    np.testing.assert_array_equal(got[f"stream/{name}"],
                                  ref[("stream", name)])


def test_stream_of_a_full_prompt_ends_at_max_len(results):
    got, _ = results
    assert len(got["stream/long_prompt"]) == 1


def test_stalled_stream_holds_back_no_other(results):
    """A stream whose consumer stops reading holds its own decode state
    only: a second stream of the same graph key runs to its end meanwhile,
    and both give JAX's tokens."""
    got, ref = results
    assert bool(got["stalled/other_ended"])
    np.testing.assert_array_equal(got["stalled/other"],
                                  ref[("stream", STALLED[1])])
    np.testing.assert_array_equal(got["stalled/held"],
                                  ref[("stream", STALLED[0])])


@pytest.mark.parametrize("chunk", [8, 32])
def test_greedy_stream_equals_generate_kv_without_refeed(results, chunk):
    got, ref = results
    a = got[f"stream/greedy_c{chunk}"]
    np.testing.assert_array_equal(a, got["kv_greedy"])
    np.testing.assert_array_equal(a, ref["kv_greedy"])


@pytest.mark.parametrize("seed", FULL_SEEDS)
def test_generate_full_with_tensor_divisors_matches_jax(results, seed):
    """C2's repaired loop: temperature 0.7 and repetition penalty 1.3 as
    device tensors give JAX's uncached stream."""
    got, ref = results
    np.testing.assert_array_equal(got[f"full/{seed}"], ref[("full", seed)])


@pytest.mark.parametrize("i", range(len(ENGINE_REQS)))
def test_engine_stream_deltas_equal_submit(results, i):
    got, _ = results
    prompt = ENGINE_REQS[i][0]
    row = got[f"engine/{i}/submit"]
    assert row[:len(prompt)].tolist() == prompt
    assert len(row) > len(prompt)
    np.testing.assert_array_equal(got[f"engine/{i}/deltas"],
                                  row[len(prompt):])
    assert int(got[f"engine/{i}/n_deltas"]) >= 1


def test_closed_engine_stream_frees_its_slot(results):
    got, _ = results
    assert int(got["cancel/first_delta"]) > 0
    assert int(got["cancel/cancelled"]) == 1
    assert int(got["cancel/served"]) == 0
    assert int(got["cancel/free"]) == ENGINE["slots"]
    assert int(got["cancel/after"]) > 0


@pytest.mark.parametrize("tag", SERVERS)
def test_sse_events_in_order(results, tag):
    got, _ = results
    assert int(got[f"http/{tag}/stream/status"]) == 200
    assert str(got[f"http/{tag}/stream/type"]).startswith(
        "text/event-stream")
    events = _sse(got[f"http/{tag}/stream/body"])
    kinds = [e["event"] for e in events]
    assert kinds[0] == "meta" and kinds[-1] == "done"
    assert set(kinds[1:-1]) == {"tokens"}, kinds
    n = [e["n_generated"] for e in events[1:-1]]
    assert n == sorted(n) and n[0] > 0


@pytest.mark.parametrize("tag", SERVERS)
def test_sse_done_midi_equals_jax(results, tag):
    got, ref = results
    events = _sse(got[f"http/{tag}/stream/body"])
    want = ref[(tag, "stream")]
    assert _ids(events) == _ids(want)
    if tag != "co":
        # a solo stream's deltas are its chunks; an engine row's are its
        # harvests, which depend on when the worker reads
        assert [e.get("ids") for e in events] == \
            [e.get("ids") for e in want]
    assert _done(events) == _done(want)


@pytest.mark.parametrize("tag", SERVERS)
def test_sse_done_midi_equals_the_deltas_midi(results, tag):
    """The done event's MIDI is the song of the meta event's prompt and the
    token deltas, concatenated (Scheme A: text tokens; B3: ids), its
    instruments pooled by program as every streamed song's are."""
    got, _ = results
    events = _sse(got[f"http/{tag}/stream/body"])
    ids = _ids(events)
    if tag == "b3":
        b3 = SchemeB3(seq_len=96)
        song = b3.decode_to_song(b3.vocab.encode(events[0]["prompt_tokens"])
                                 + ids)
    else:
        texts = [t for e in events if e["event"] == "tokens"
                 for t in e["texts"]]
        song = tokens_to_song(events[0]["prompt_tokens"] + texts)
    merged = MidiSong()
    _merge_song(merged, {}, song, 0.0)
    buf = io.BytesIO()
    merged.write(buf)
    assert _done(events) == buf.getvalue()


@pytest.mark.parametrize("tag", SERVERS)
def test_sse_same_seed_same_bytes(results, tag):
    """Every event of the two streams equal but the wall-clock timings."""
    got, _ = results
    a, b = (_sse(got[f"http/{tag}/{k}/body"])
            for k in ("stream", "stream_again"))
    for e in (a[-1], b[-1]):
        assert e.pop("timings_ms")["total"] > 0
    assert a == b


@pytest.mark.parametrize("tag", SERVERS)
def test_streamed_sections_midi_equal_jax(results, tag):
    got, ref = results
    events = _sse(got[f"http/{tag}/sections_stream/body"])
    want = ref[(tag, "sections_stream")]
    assert [e["event"] for e in events].count("meta") == 3
    assert [e["section"] for e in events if e["event"] == "meta"] == \
        [0, 1, 2]
    assert _ids(events) == _ids(want)
    assert _done(events) == _done(want)


@pytest.mark.parametrize("tag", SERVERS)
def test_sections_midi_equal_jax(results, tag):
    got, ref = results
    assert int(got[f"http/{tag}/sections/status"]) == 200
    assert got[f"http/{tag}/sections/body"].tobytes() == \
        ref[(tag, "sections")]


@pytest.mark.parametrize("name", list(CONTRACT))
def test_sse_request_contract(results, name):
    got, _ = results
    _, _, status, what = CONTRACT[name]
    assert int(got[f"contract/{name}/status"]) == status
    body = got[f"contract/{name}/body"]
    if status == 200:
        events = _sse(body)
        assert events[-1]["event"] == "done"
        wav = base64.b64decode(events[-1]["wav_b64"])
        assert wav[:4] == b"RIFF" and wav[8:12] == b"WAVE"
    else:
        # a JSON error, not an event stream: no 200 header was sent first
        assert str(got[f"contract/{name}/type"]).startswith(
            "application/json")
        assert what in json.loads(body.tobytes())["error"]
