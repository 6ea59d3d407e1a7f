"""The port's spans and counters (``eamg_tpu_torch/utils/logging.py``), and
the benchmark's readers of them (``perfbench/metrics/``), on the CPU.

The torch side runs in one subprocess (tests/torch_port_tracing.py).
Checked:
- with no profiler session, an engine's requests, a solo decode and a
  training step record no span, and a span given ``ms`` still adds its
  duration there, twice under one key;
- inside a session, a span on a thread started before the session is
  recorded with its thread, its parent and its ``rid``, inside the
  profiler's own record of a main-thread range that brackets it (1 ms);
- a tiny engine run under a session: each request has one
  ``engine.queue`` and one ``engine.join`` span, no join ends before its
  admission's issue, the harvests' tokens are the tokens served,
  ``row_steps`` is chunks x chunk x slots and the chunks' spans carry the
  same counts, the worker's spans nest under ``engine.loop`` and the
  loops follow each other without holes;
- the solo decode's ``decode.block`` / ``decode.block_flags``, the
  trainer's ``train.*`` and the pipeline's ``pipeline.lock_wait``;
- ``profiler_trace`` writes a thread's spans into its Chrome trace;
- the five readers on synthetic spans and device activities.
"""

from __future__ import annotations

import collections
import json
import os
import subprocess
import sys
import types

import pytest

from perfbench import core

from port_harness import REPO

WORKER = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "torch_port_tracing.py")
MS = 1_000_000


@pytest.fixture(scope="module")
def seen(tmp_path_factory):
    out = tmp_path_factory.mktemp("tracing") / "out.json"
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("XLA_", "JAX_"))}
    env.update(PYTHONPATH=str(REPO), OMP_NUM_THREADS="2")
    proc = subprocess.run([sys.executable, WORKER, str(out)], cwd=REPO,
                          env=env, capture_output=True, text=True,
                          timeout=600)
    assert proc.returncode == 0, proc.stderr[-6000:]
    with open(out, encoding="utf-8") as f:
        return json.load(f)


def _named(spans, name):
    return [s for s in spans if s["name"] == name]


def test_no_session_records_nothing(seen):
    off = seen["off"]
    assert off["spans"] == 0
    assert list(off["ms"]) == ["outer"] and off["ms"]["outer"] > 0


def test_thread_started_before_session_is_recorded(seen):
    th = seen["thread"]
    work = _named(th["spans"], "t.work")
    assert len(work) == 1
    w = work[0]
    assert (w["tid"], w["parent"], w["rid"], w["counts"]) == (
        th["tid"], "t.outer", 7, {"n": 3})
    lo, hi = th["bracket"]
    assert lo - MS <= w["start"] <= w["end"] <= hi + MS


def test_engine_requests_queue_and_join_once(seen):
    eng = seen["engine"]
    for name in ("engine.queue", "engine.join", "engine.admit"):
        rids = collections.Counter(s["rid"] for s in
                                   _named(eng["spans"], name))
        assert len(rids) == eng["requests"] and set(rids.values()) == {1}, \
            name


def test_engine_join_ends_after_its_admission(seen):
    spans = seen["engine"]["spans"]
    admitted = {s["rid"]: s["end"] for s in _named(spans, "engine.admit")}
    queued = {s["rid"]: s for s in _named(spans, "engine.queue")}
    for j in _named(spans, "engine.join"):
        assert j["end"] >= admitted[j["rid"]]
        assert j["start"] == queued[j["rid"]]["start"]
        assert queued[j["rid"]]["end"] <= admitted[j["rid"]]


def test_engine_harvest_tokens_are_the_tokens_served(seen):
    eng = seen["engine"]
    harvests = _named(eng["spans"], "engine.harvest")
    assert sum(s["counts"]["tokens"] for s in harvests) \
        == eng["served_tokens"] > 0
    assert sum(s["counts"]["served"] for s in harvests) == eng["requests"]


def test_engine_row_steps_count_every_slot(seen):
    eng = seen["engine"]
    assert eng["row_steps"] == eng["chunks"] * eng["chunk"] * eng["slots"]
    chunks = [s["counts"] for s in _named(eng["spans"], "engine.chunk")]
    assert len(chunks) == eng["chunks"]
    assert sum(c["slots"] * c["steps"] for c in chunks) == eng["row_steps"]
    assert all(1 <= c["rows"] <= c["slots"] for c in chunks)
    stats = eng["stats"]
    assert stats["live_row_steps"] == sum(c["rows"] * c["steps"]
                                          for c in chunks)
    assert stats["live_row_steps"] <= stats["row_steps"]
    assert stats["row_tokens"] == eng["served_tokens"]


def test_engine_worker_spans_tile_its_loop(seen):
    spans = seen["engine"]["spans"]
    tid = _named(spans, "engine.chunk")[0]["tid"]
    worker = [s for s in spans if s["tid"] == tid]
    assert {s["name"] for s in worker} <= {
        "engine.loop", "engine.wait_requests", "engine.admit",
        "engine.chunk", "engine.harvest_wait", "engine.harvest"}
    loops = sorted((s["start"], s["end"]) for s in
                   _named(worker, "engine.loop"))
    # the loop that was open when the session began is not recorded
    assert all(s["parent"] == "engine.loop" or s["start"] < loops[0][0]
               for s in worker if s["name"] != "engine.loop")
    for (_, end), (start, _) in zip(loops, loops[1:]):
        assert 0 <= start - end < 50 * MS


def test_solo_decode_block_spans(seen):
    spans = seen["solo_train"]
    blocks = _named(spans, "decode.block")
    assert all(b["counts"] == {"rows": 1, "steps": 32} for b in blocks)
    # flags after every block but the last of the budget's two; an early
    # EOS stops after the first
    flags = _named(spans, "decode.block_flags")
    assert len(flags) == 1 and len(blocks) in (1, 2)
    assert flags[0]["counts"]["inert"] >= 0
    assert blocks[0]["end"] <= flags[0]["start"]


def test_trainer_spans(seen):
    spans = seen["solo_train"]
    steps = _named(spans, "train.step")
    assert len(steps) == 2
    assert all(s["counts"] == {"tokens": 32} for s in steps)
    for name in ("train.forward", "train.backward", "train.optimizer"):
        part = _named(spans, name)
        assert len(part) == 2 and {s["parent"] for s in part} \
            == {"train.step"}, name
        for p, s in zip(part, steps):
            assert s["start"] <= p["start"] <= p["end"] <= s["end"]
    assert len(_named(spans, "train.data_wait")) == 3


def test_pipeline_lock_wait_span(seen):
    assert len(_named(seen["solo_train"], "pipeline.lock_wait")) == 1


def test_profile_trace_holds_a_worker_threads_spans(seen):
    prof = seen["profile"]
    work = _named(prof["events"], "t.work")
    assert len(work) == 1
    w = work[0]
    assert (w["ph"], w["tid"], w["args"]["rid"], w["args"]["parent"],
            w["args"]["n"]) == ("X", prof["tid"], 7, "t.outer", 3)
    outer = _named(prof["events"], "t.outer")[0]
    assert outer["ts"] <= w["ts"] and w["dur"] > 0


# ------------------------------------------------------------- the readers

def _span(name, start, end, tid=1, rid=None, parent=None, **counts):
    return types.SimpleNamespace(name=name, start_ns=start, end_ns=end,
                                 tid=tid, rid=rid, parent=parent,
                                 counts=counts)


# a worker (thread 1) through two chunks and a wait for requests; two
# requests submitted on thread 2; two training steps
SPANS = [
    _span("engine.loop", 0, 100),
    _span("engine.admit", 10, 20, rid=0, prompt_len=3),
    _span("engine.chunk", 20, 40, rows=2, slots=4, steps=10),
    _span("engine.harvest_wait", 40, 70),
    _span("engine.harvest", 70, 80, tokens=15, served=1),
    _span("engine.loop", 100, 200),
    _span("engine.admit", 100, 105, rid=1, prompt_len=4),
    _span("engine.chunk", 110, 130, rows=1, slots=4, steps=10),
    _span("engine.harvest_wait", 130, 160),
    _span("engine.harvest", 160, 170, tokens=5, served=1),
    _span("engine.loop", 200, 300),
    _span("engine.wait_requests", 205, 300),
    _span("engine.queue", 0, 5, tid=2, rid=0),
    _span("engine.join", 0, 70, tid=2, rid=0),
    _span("engine.queue", 50, 100, tid=2, rid=1),
    _span("engine.join", 50, 160, tid=2, rid=1),
    _span("train.step", 0, 2 * MS, tid=3, tokens=32),
    _span("train.step", 3 * MS, 7 * MS, tid=3, tokens=32),
]
# idle gaps (15, 30), (50, 150), (160, 250), (255, 400): 350 ns, of which
# under admit 10, chunk 30, harvest 20, loop 60 (host work 120), under
# harvest_wait 40, wait_requests 90, outside the worker 100
DEVICE = [("k", 0, 15), ("k", 30, 20), ("k", 150, 10), ("k", 250, 5),
          ("k", 400, 10)]
HOST = [(22, 30, "cudaGraphLaunch"), (112, 120, "cudaGraphLaunch"),
        (200_000, 200_010, "cudaGraphLaunch"), (25, 26, "cudaLaunchKernel")]


@pytest.mark.parametrize("family, want", [
    ("slot_occupancy", 100.0 * 30 / 80),
    ("row_step_use", 100.0 * 20 / 30),
    ("join_device_ms_p50", 90 / 1e6),
    ("idle_host_work", 100.0 * 120 / 350),
    ("step_issue_ms", 3.0),
])
def test_reader(family, want):
    reader = core.plugin("metrics", family)
    logged = []
    if family == "idle_host_work":
        got = reader.reading(SPANS, DEVICE, HOST, log=logged.append)
        assert "2 of 3 cudaGraphLaunch" in logged[1]
        assert "engine.harvest_wait 0.000 ms (11.43%)" in logged[0]
        assert "the split sums to 100.000%" in logged[0]
    elif family == "join_device_ms_p50":
        got = reader.reading(SPANS, log=logged.append)
        assert "2 joins" in logged[0]
    else:
        got = reader.reading(SPANS)
    assert got == pytest.approx(want, rel=1e-12)
    # spans of another cell's program: nothing to read
    other = SPANS[:12] if family == "step_issue_ms" else SPANS[-2:]
    args = (DEVICE,) if family == "idle_host_work" else ()
    assert reader.reading(other, *args) is None
    # no spans in the program (a checkout before them, or a run on no
    # card): the reader returns nothing
    assert reader.read(None, {}, {}, types.SimpleNamespace(
        device=[], host_spans=[])) is None
