"""HTTP service: the ``POST /generate`` contract on the stdlib server.

Port of ``eamg_tpu/serve/server.py``: ``POST /generate`` with form field
``prompt`` (multipart or urlencoded), ``format=wav|midi`` (form field or
query), and the sampling fields ``seed``, ``temperature``, ``top_k``,
``top_p``, ``min_p``, ``repetition_penalty``, ``frequency_penalty``,
``presence_penalty``, ``no_repeat_ngram`` and ``grammar`` (the served
scheme's FSM; these five ride the window batcher, and the engine when it
was built for them, else decode solo), ``sections`` (one conditioned
section a sentence), ``stream`` (form field or query: Server-Sent
Events, a ``meta`` event a section, ``tokens`` deltas as the decode's
chunks complete, then ``done`` with the MIDI and WAV as base64, the
page's default request), and the page's decode options, each decoded
solo: ``medusa`` (streamed a verify chunk at a time; with
``--engine-medusa`` it joins the engine), ``lookup`` and ``beams`` (0 to
16, with ``length_penalty``); ``GET /healthz``, ``GET /stats`` (with the
engine's counters under ``engine`` when requests are coalesced, and the
Medusa heads' acceptance probe under ``medusa_probe``), ``GET /profile``
(one request, "profile trace request" with seed 0 and no audio, under
``torch.profiler``: a Chrome trace written to ``?dir=`` or a new
temporary directory, answered with ``{"trace_dir", "view"}``) and the
static page at ``GET /`` (the JAX package's ``serve/static/index.html``,
read by path). Malformed input gets a 4xx,
never a 500, and a stream's malformed number gets its 422 before the 200
header is sent. JAX's 422s hold: lookup or beams with ``stream``, medusa
streamed with penalties or n-gram bans or without heads, and every
composition the pipeline refuses (lookup or medusa with grammar among
them). A full admission queue (``EngineOverloaded``) gets a 503 with
``Retry-After``, a stream's before its 200.
"""

from __future__ import annotations

import json
import os
import threading
import time
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path

from ..utils.logging import JsonLogger, LatencyStats
from .continuous import ContinuousBatcher, EngineOverloaded
from .pipeline import Pipeline

_STATIC_PAGE = (Path(__file__).resolve().parents[2] / "eamg_tpu" / "serve"
                / "static" / "index.html")

_CORS = {
    "Access-Control-Allow-Origin": "*",
    "Access-Control-Allow-Methods": "*",
    "Access-Control-Allow-Headers": "*",
}

MAX_BODY_BYTES = 2 << 20
MAX_PROMPT_CHARS = 20_000


def _parse_multipart(body: bytes, content_type: str) -> dict[str, str]:
    """Minimal multipart/form-data parser (text fields only)."""
    fields: dict[str, str] = {}
    boundary = None
    for part in content_type.split(";"):
        part = part.strip()
        if part.startswith("boundary="):
            boundary = part[len("boundary="):].strip('"')
    if not boundary:
        return fields
    for chunk in body.split(b"--" + boundary.encode()):
        chunk = chunk.strip(b"\r\n")
        if not chunk or chunk == b"--" or b"\r\n\r\n" not in chunk:
            continue
        header_blob, value = chunk.split(b"\r\n\r\n", 1)
        name = None
        for line in header_blob.split(b"\r\n"):
            if line.lower().startswith(b"content-disposition"):
                for item in line.split(b";"):
                    item = item.strip()
                    if item.startswith(b'name="'):
                        name = item[6:-1].decode("utf-8", "replace")
        if name is not None:
            fields[name] = value.decode("utf-8", "replace")
    return fields


def _num(fields, key, default, conv):
    raw = fields.get(key)
    if raw is None or raw == "":
        return default
    try:
        return conv(raw)
    except (TypeError, ValueError):
        raise ValueError(f"form field {key!r} must be a number, "
                         f"got {raw[:40]!r}") from None


def _parse_penalties(fields):
    """repetition_penalty / frequency_penalty / presence_penalty form
    fields -> (rep, freq, pres), or None when all are absent or neutral."""
    pen = (_num(fields, "repetition_penalty", 1.0, float),
           _num(fields, "frequency_penalty", 0.0, float),
           _num(fields, "presence_penalty", 0.0, float))
    return None if pen == (1.0, 0.0, 0.0) else pen


def _parse_ngram(fields) -> int:
    """no_repeat_ngram form field -> an int in [0, 8], as the JAX server
    bounds it (larger sizes ban next to nothing)."""
    n = _num(fields, "no_repeat_ngram", 0, int)
    if n < 0 or n > 8:
        raise ValueError("no_repeat_ngram must be in [0, 8]")
    return n


def _parse_grammar(fields) -> bool:
    """grammar form field -> bool: decode under the served scheme's FSM
    (``decode/grammar.py``); off by default. A form field only, as the JAX
    server reads it."""
    return fields.get("grammar", "").lower() in ("1", "true", "yes")


def _flag(fields: dict, qs: dict, name: str) -> bool:
    """A flag from the query or the form, on as "1"/"true"/"yes"."""
    return qs.get(name, [fields.get(name, "")])[0].strip().lower() in (
        "1", "true", "yes")


class _InflightCounter:
    """Count of /generate requests between accept and response written.
    Graceful shutdown waits on this and not on the engine alone: after a
    row's tokens arrive, the handler thread still renders the WAV and
    writes the response."""

    def __init__(self):
        self._n = 0
        self._cond = threading.Condition()

    def __enter__(self):
        with self._cond:
            self._n += 1

    def __exit__(self, *exc):
        with self._cond:
            self._n -= 1
            self._cond.notify_all()

    def wait_zero(self, timeout: float) -> bool:
        with self._cond:
            return self._cond.wait_for(lambda: self._n == 0, timeout)


def _engine_stats(batcher) -> dict:
    """The batcher's counters for /stats: its numbers, the join-delay
    percentiles, and the live load an operator tunes --slots and
    --max-queue by."""
    eng = {k: v for k, v in batcher.stats.items()
           if isinstance(v, (int, float))}
    jd = batcher.stats.get("join_delay_ms")
    # the worker appends to this deque while we copy it; a copy that
    # races raises RuntimeError, so retry the copy rather than lock the
    # worker's append
    for _ in range(8):
        try:
            jd = list(jd) if jd is not None else []
            break
        except RuntimeError:
            continue
    else:
        jd = []
    if jd:
        js = sorted(jd)
        eng["p50_join_ms"] = round(js[len(js) // 2], 1)
        eng["p95_join_ms"] = round(js[min(len(js) - 1,
                                          int(len(js) * 0.95))], 1)
    eng["queue_depth"] = batcher._q.qsize()
    if hasattr(batcher, "_free"):
        eng["free_slots"] = len(batcher._free)
    return eng


class EAMGHandler(BaseHTTPRequestHandler):
    pipeline: Pipeline = None  # injected by make_server
    quiet: bool = True
    stats: LatencyStats = None
    logger: JsonLogger = None
    inflight: _InflightCounter = None
    # seconds a socket read or write may block: a client that stops
    # reading a stream fails its writes, which closes the stream
    timeout = 120

    def log_message(self, fmt, *args):  # noqa: N802
        if not self.quiet:
            super().log_message(fmt, *args)

    def _send(self, code: int, body: bytes, content_type: str,
              extra: dict | None = None):
        self.send_response(code)
        self.send_header("Content-Type", content_type)
        self.send_header("Content-Length", str(len(body)))
        for k, v in {**_CORS, **(extra or {})}.items():
            self.send_header(k, v)
        self.end_headers()
        self.wfile.write(body)

    def _json(self, code: int, obj):
        self._send(code, json.dumps(obj).encode(), "application/json")

    def do_OPTIONS(self):  # noqa: N802
        self._send(204, b"", "text/plain")

    def do_GET(self):  # noqa: N802
        path = urllib.parse.urlparse(self.path).path
        if path in ("/", "/index.html") and _STATIC_PAGE.is_file():
            self._send(200, _STATIC_PAGE.read_bytes(),
                       "text/html; charset=utf-8")
        elif path == "/healthz":
            self._json(200, {"status": "ok"})
        elif path == "/stats":
            out = self.stats.summary()
            # the Medusa heads' acceptance probe: whether medusa=true is
            # predicted to win on this checkpoint
            probe = getattr(self.pipeline, "medusa_probe", None)
            if probe is not None:
                out["medusa_probe"] = probe
            batcher = getattr(self.pipeline, "batcher", None)
            if batcher is not None:
                out["engine"] = _engine_stats(batcher)
            self._json(200, out)
        elif path == "/profile":
            # a torch.profiler trace of one representative request
            import tempfile

            from ..utils.logging import profiler_trace

            qs = urllib.parse.parse_qs(urllib.parse.urlparse(self.path)
                                       .query)
            out_dir = qs.get("dir", [tempfile.mkdtemp(
                prefix="eamg_profile_")])[0]
            with profiler_trace(out_dir):
                self.pipeline.generate("profile trace request", seed=0,
                                       render_audio=False)
            self._json(200, {"trace_dir": out_dir,
                             "view": "open " + os.path.join(
                                 out_dir, "trace.json")
                             + " in chrome://tracing or Perfetto"})
        else:
            self._json(404, {"error": "not found"})

    def do_POST(self):  # noqa: N802
        parsed = urllib.parse.urlparse(self.path)
        if parsed.path != "/generate":
            self._json(404, {"error": "not found"})
            return
        try:
            with self.inflight:
                self._generate(parsed)
        except EngineOverloaded as exc:
            # load shedding: the admission queue is full; tell the client
            # to back off instead of queueing without bound
            self._send(503, json.dumps({"error": str(exc)}).encode(),
                       "application/json", {"Retry-After": "1"})
        except Exception as exc:  # pragma: no cover - defensive
            self._json(500, {"error": f"{type(exc).__name__}: {exc}"})

    def _generate(self, parsed):
        try:
            length = int(self.headers.get("Content-Length", 0))
        except ValueError:
            self._json(400, {"error": "bad Content-Length"})
            return
        if length > MAX_BODY_BYTES:
            remaining = min(length, 16 << 20)
            while remaining > 0:
                chunk = self.rfile.read(min(remaining, 1 << 16))
                if not chunk:
                    break
                remaining -= len(chunk)
            self._json(413, {"error": "request body too large"})
            return
        body = self.rfile.read(max(length, 0))
        ctype = self.headers.get("Content-Type", "")
        try:
            if ctype.startswith("multipart/form-data"):
                fields = _parse_multipart(body, ctype)
            else:
                fields = {k: v[0] for k, v in
                          urllib.parse.parse_qs(body.decode()).items()}
        except Exception:
            self._json(400, {"error": "malformed request body"})
            return
        prompt = fields.get("prompt", "")
        if not prompt:
            self._json(422, {"error": "form field 'prompt' required"})
            return
        if len(prompt) > MAX_PROMPT_CHARS:
            self._json(422, {"error": f"prompt too long (max "
                                      f"{MAX_PROMPT_CHARS} chars)"})
            return
        qs = urllib.parse.parse_qs(parsed.query)
        fmt = qs.get("format", [fields.get("format", "wav")])[0]
        if fmt not in ("wav", "midi"):
            self._json(422, {"error": "format must be wav or midi"})
            return
        try:
            sampling = dict(
                temperature=_num(fields, "temperature", 1.0, float),
                top_k=_num(fields, "top_k", 50, int),
                top_p=_num(fields, "top_p", 1.0, float),
                min_p=_num(fields, "min_p", 0.0, float),
                penalties=_parse_penalties(fields),
                no_repeat_ngram=_parse_ngram(fields),
                grammar=_parse_grammar(fields),
                seed=_num(fields, "seed", None, int))
            if not sampling["temperature"] > 0.0:
                raise ValueError("temperature must be > 0")
            # beam search: solo, 0 = off; length_penalty ranks the beams
            beams = _num(fields, "beams", 0, int)
            length_penalty = _num(fields, "length_penalty", 1.0, float)
            if beams < 0 or beams > 16:
                raise ValueError("beams must be in [0, 16]")
        except ValueError as exc:
            self._json(422, {"error": str(exc)})
            return
        t_start = time.perf_counter()
        sections = _flag(fields, qs, "sections")
        lookup, medusa = _flag(fields, qs, "lookup"), _flag(fields, qs,
                                                            "medusa")
        stream = _flag(fields, qs, "stream")
        refusal = self._refusal(stream, lookup, medusa, beams, sampling)
        if refusal is not None:
            self._json(422, {"error": refusal})
            return
        if stream:
            self._stream_generate(prompt, sampling, fmt, sections, t_start,
                                  medusa)
            return
        gen_fn = (self.pipeline.generate_sections if sections
                  else self.pipeline.generate)
        try:
            result = gen_fn(prompt, render_audio=fmt == "wav", lookup=lookup,
                            medusa=medusa, beams=beams,
                            length_penalty=length_penalty, **sampling)
        except ValueError as exc:
            # a composition the pipeline refuses (lookup with penalties,
            # medusa without heads, speculation on a quirk checkpoint...)
            self._json(422, {"error": str(exc)})
            return
        self.stats.observe(time.perf_counter() - t_start,
                           tokens=len(result.tokens))
        timings = {k: round(v, 1) for k, v in result.timings_ms.items()}
        self.logger.log("generate", emotion=result.label,
                        n_tokens=len(result.tokens), timings_ms=timings)
        extra = {"X-EAMG-Timings": json.dumps(timings),
                 "X-EAMG-Emotion": result.label,
                 "X-EAMG-Tokens": str(len(result.tokens))}
        if fmt == "midi":
            extra["Content-Disposition"] = \
                'attachment; filename="generated.mid"'
            self._send(200, result.midi_bytes, "audio/midi", extra)
        else:
            extra["Content-Disposition"] = \
                'attachment; filename="generated.wav"'
            self._send(200, result.wav_bytes, "audio/wav", extra)

    def _refusal(self, stream: bool, lookup: bool, medusa: bool,
                 beams: int, sampling: dict) -> str | None:
        """JAX's 422 for an option that does not stream or, streamed, does
        not compose; None when the request may go on. A stream's is sent
        before its 200 header."""
        if lookup and stream:
            return "lookup does not stream yet (whole-block speculation)"
        if beams and stream:
            return ("beams is a whole-block deterministic search; it does "
                    "not stream")
        if stream and medusa:
            if sampling["penalties"] is not None \
                    or sampling["no_repeat_ngram"] or sampling["grammar"]:
                return ("medusa does not compose with penalties, n-gram "
                        "bans or grammar")
            if self.pipeline.medusa_heads is None:
                return self.pipeline.medusa_unavailable or \
                    "this serving checkpoint ships no Medusa heads"
        return None

    def _stream_generate(self, prompt, sampling, fmt, sections, t_start,
                         medusa: bool = False):
        """``POST /generate?stream=1`` -> Server-Sent Events: one
        ``data: {json}`` event a ``generate_stream`` event, flushed as it
        comes. ``sampling`` arrives validated, so a malformed number has
        had its 422 before the 200 header is sent here."""
        # decide overload before committing to a 200 event stream; only a
        # stream that would ride the engine is shed (a race with the row's
        # enqueue becomes an SSE "error" event); a medusa stream rides it
        # only when the engine carries the heads
        batcher = getattr(self.pipeline, "batcher", None)
        if isinstance(batcher, ContinuousBatcher) \
                and batcher.accepts(
                    top_k=sampling["top_k"], top_p=sampling["top_p"],
                    min_p=sampling["min_p"],
                    penalties=sampling["penalties"],
                    no_repeat_ngram=sampling["no_repeat_ngram"],
                    grammar=sampling["grammar"], medusa=medusa) \
                and batcher.overloaded():
            batcher.stats["rejected"] += 1
            self._send(503, json.dumps(
                {"error": "engine admission queue full"}).encode(),
                "application/json", {"Retry-After": "1"})
            return
        self.send_response(200)
        for k, v in {**_CORS, "Content-Type": "text/event-stream",
                     "Cache-Control": "no-cache"}.items():
            self.send_header(k, v)
        self.end_headers()
        n_tokens, label = 0, ""
        stream = self.pipeline.generate_stream(
            prompt, render_audio=fmt == "wav", sections=sections,
            medusa=medusa, **sampling)
        try:
            for ev in stream:
                if ev["event"] == "done":
                    n_tokens, label = ev["n_tokens"], ev["label"]
                self.wfile.write(b"data: " + json.dumps(ev).encode()
                                 + b"\n\n")
                self.wfile.flush()
        except (BrokenPipeError, ConnectionResetError, TimeoutError):
            # the client went away or stopped reading: close() below throws
            # GeneratorExit down the generators, which cancels the engine
            # row, so its slot frees instead of decoding to the end
            return
        except Exception as exc:  # pragma: no cover - defensive
            err = {"event": "error", "error": f"{type(exc).__name__}: {exc}"}
            try:
                self.wfile.write(b"data: " + json.dumps(err).encode()
                                 + b"\n\n")
            except OSError:
                pass
            return
        finally:
            stream.close()
        self.stats.observe(time.perf_counter() - t_start, tokens=n_tokens)
        self.logger.log("generate_stream", emotion=label, n_tokens=n_tokens)


def make_server(pipeline: Pipeline, host: str = "127.0.0.1",
                port: int = 8000, quiet: bool = True) -> ThreadingHTTPServer:
    handler = type("BoundHandler", (EAMGHandler,),
                   {"pipeline": pipeline, "quiet": quiet,
                    "stats": LatencyStats(),
                    "logger": JsonLogger(component="serve"),
                    "inflight": _InflightCounter()})
    return ThreadingHTTPServer((host, port), handler)


def serve_forever_in_thread(server: ThreadingHTTPServer) -> threading.Thread:
    t = threading.Thread(target=server.serve_forever, daemon=True)
    t.start()
    return t


def shutdown_gracefully(server: ThreadingHTTPServer, pipeline: Pipeline,
                        timeout: float = 60.0) -> None:
    """After the accept loop has stopped: let queued and in-flight engine
    rows finish, let their handlers write their responses, then stop the
    batcher's worker and close the socket."""
    batcher = getattr(pipeline, "batcher", None)
    if batcher is not None:
        batcher.drain(timeout=timeout)
    server.RequestHandlerClass.inflight.wait_zero(timeout=timeout)
    if batcher is not None:
        batcher.close()
    server.server_close()
