"""The PyTorch side of the port's parity tests, run in a SUBPROCESS.

torch must not enter the pytest process (tests/conftest.py), so the
tests/test_torch_*.py files write their inputs (made with numpy from a
seed, and JAX parameter trees as numpy arrays) to an .npz, run

    python tests/torch_port_worker.py TASK IN.npz OUT.npz

with the repository root as cwd and PYTHONPATH, and compare OUT.npz with
the JAX package's results. Every check of one test file is one TASK, so a
file pays for one torch import. Everything runs on the CPU, where the
port's kernel wrappers take their plain versions.

Keys of the npz files are "/"-joined paths into nested dicts and lists
(``p/layers/0/attn/in_w``); see :func:`unflatten`.
"""

from __future__ import annotations

import io
import json
import sys

import numpy as np
import torch

CPU = "cpu"


def unflatten(npz, prefix: str):
    """Rebuild the nested tree stored under ``prefix/``: integer path
    parts are list indices."""
    root: dict = {}
    for key in npz.files:
        if not key.startswith(prefix + "/"):
            continue
        parts = key[len(prefix) + 1:].split("/")
        node = root
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = npz[key]

    def fix(n):
        if not isinstance(n, dict):
            return n
        if n and all(k.isdigit() for k in n):
            return [fix(n[str(i)]) for i in range(len(n))]
        return {k: fix(v) for k, v in n.items()}

    return fix(root)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _cfg(npz, key):
    from eamg_tpu_torch.models.gpt import GPTConfig

    return GPTConfig(**json.loads(str(npz[key])))


# ------------------------------------------------------------------ kernels

def task_kernels(inp, out):
    from eamg_tpu_torch.ops import attention, decode_attention, ffn, topk

    for name in sorted({k.split("/")[1] for k in inp.files
                        if k.startswith("attn/")}):
        a = unflatten(inp, f"attn/{name}")
        vl = _t(a["valid_len"]) if "valid_len" in a else None
        out[f"attn/{name}"] = attention.flash_attention(
            _t(a["q"]), _t(a["k"]), _t(a["v"]), vl,
            causal=bool(a["causal"])).numpy()
    for name in sorted({k.split("/")[1] for k in inp.files
                        if k.startswith("ffn/")}):
        a = unflatten(inp, f"ffn/{name}")
        out[f"ffn/{name}"] = ffn.fused_ffn(
            _t(a["x"]), _t(a["w1"]), _t(a["b1"]), _t(a["w2"]), _t(a["b2"]),
            activation=str(a["activation"])).numpy()
    for name in sorted({k.split("/")[1] for k in inp.files
                        if k.startswith("dec/")}):
        a = unflatten(inp, f"dec/{name}")
        out[f"dec/{name}"] = decode_attention.flash_decode(
            _t(a["q"]), _t(a["k"]), _t(a["v"]), _t(a["t"])).numpy()
    for name in sorted({k.split("/")[1] for k in inp.files
                        if k.startswith("topk/")}):
        a = unflatten(inp, f"topk/{name}")
        out[f"topk/{name}"] = topk.kth_value(_t(a["logits"]),
                                             int(a["k"])).numpy()
    for name in sorted({k.split("/")[1] for k in inp.files
                        if k.startswith("topp/")}):
        a = unflatten(inp, f"topp/{name}")
        out[f"topp/{name}"] = topk.top_p_threshold(_t(a["logits"]),
                                                   float(a["p"])).numpy()


# -------------------------------------------------------------------- slice

def _model_checks(inp, out, tag):
    from eamg_tpu_torch.decode.loop import generate_kv
    from eamg_tpu_torch.models import gpt
    from eamg_tpu_torch.utils import prng
    from eamg_tpu_torch.utils.checkpoint import params_from_jax

    cfg = _cfg(inp, f"{tag}/cfg")
    params = params_from_jax(unflatten(inp, f"{tag}/p"))
    ids = _t(inp[f"{tag}/ids"]).long()
    out[f"{tag}/forward"] = gpt.forward(params, ids, cfg).numpy()
    plen = int(inp[f"{tag}/plen"])
    cache = gpt.init_kv_cache(cfg, ids.shape[0], int(inp[f"{tag}/max_len"]))
    logits, cache = gpt.prefill(params, ids, cfg, cache, prompt_len=plen)
    out[f"{tag}/prefill"] = logits.numpy()
    steps = []
    last = ids[:, plen - 1:plen]
    for tok in inp[f"{tag}/forced"]:
        lg, cache = gpt.decode_step(params, last, cache, cfg)
        steps.append(lg.numpy())
        last = torch.full_like(last, int(tok))
    out[f"{tag}/decode"] = np.stack(steps)
    prompt = _t(inp[f"{tag}/gen_prompt"]).long()
    gplen = int(inp[f"{tag}/gen_plen"])
    max_len = int(inp[f"{tag}/gen_max_len"])
    buf, n = generate_kv(params, prompt, gplen, prng.PRNGKey(0), cfg,
                         max_len, greedy=True, eos_id=int(inp["eos"]))
    out[f"{tag}/greedy"] = buf[:, :n].numpy()
    for seed in inp["seeds"]:
        buf, n = generate_kv(params, prompt, gplen, prng.PRNGKey(int(seed)),
                             cfg, max_len, top_k=int(inp["top_k"]),
                             temperature=float(inp["temperature"]),
                             eos_id=int(inp["eos"]))
        out[f"{tag}/sampled{int(seed)}"] = buf[:, :n].numpy()
    f = json.loads(str(inp["filters"]))
    buf, n = generate_kv(params, prompt, gplen, prng.PRNGKey(f["seed"]), cfg,
                         max_len, top_k=f["top_k"],
                         temperature=f["temperature"], top_p=f["top_p"],
                         min_p=f["min_p"], eos_id=int(inp["eos"]),
                         presplit_keys=True)
    out[f"{tag}/filtered"] = buf[:, :n].numpy()


def _prng_checks(inp, out):
    from eamg_tpu_torch.utils import prng

    for seed in inp["prng_seeds"]:
        seed = int(seed)
        key = prng.PRNGKey(seed)
        out[f"prng/{seed}/key"] = np.asarray(key, np.uint32)
        out[f"prng/{seed}/split2"] = np.asarray(prng.split(key), np.uint32)
        out[f"prng/{seed}/split5"] = np.asarray(prng.split(key, 5),
                                                np.uint32)
        for i, shape in enumerate(json.loads(str(inp["prng_shapes"]))):
            out[f"prng/{seed}/bits{i}"] = prng.bits(key, shape).numpy() \
                .astype(np.uint32)
            out[f"prng/{seed}/uniform{i}"] = prng.uniform(
                key, shape, -2.0, 3.0).numpy()
        out[f"prng/{seed}/categorical"] = prng.categorical(
            key, _t(inp["prng_logits"])).numpy()


def _flagship_checks(inp, out):
    import dataclasses

    from eamg_tpu_torch.models import gpt
    from eamg_tpu_torch.serve.pipeline import DEMO_CKPT_A
    from eamg_tpu_torch.utils.checkpoint import load_checkpoint

    ck = load_checkpoint(DEMO_CKPT_A)
    shapes = []
    flat = [("", ck["params"])]
    while flat:
        path, node = flat.pop()
        if isinstance(node, dict):
            flat.extend((f"{path}/{k}", v) for k, v in node.items())
        elif isinstance(node, list):
            flat.extend((f"{path}/{i}", v) for i, v in enumerate(node))
        else:
            shapes.append(f"{path}:{tuple(node.shape)}:"
                          f"{str(node.dtype).replace('torch.', '')}")
    out["flagship/shapes"] = np.asarray(sorted(shapes))
    cfg = dataclasses.replace(ck["cfg"], dtype="float32")
    out["flagship/logits"] = gpt.forward(
        ck["params"], _t(inp["flagship/ids"]).long(), cfg).numpy()


def _classifier_checks(inp, out):
    from eamg_tpu_torch.emotion import EmotionClassifier

    clf = EmotionClassifier(device=CPU)
    texts = json.loads(str(inp["clf/texts"]))
    out["clf/probs"] = np.stack([clf._probs(t) for t in texts])
    out["clf/labels"] = np.asarray([clf.predict(t) for t in texts])
    lex = EmotionClassifier(backend="lexicon", device=CPU)
    out["clf/lexicon"] = np.asarray([lex.predict(t) for t in texts])


def _song(spec):
    from eamg_tpu_torch.midi.smf import Instrument, MidiSong, Note

    song = MidiSong()
    for prog, drum, notes in spec:
        inst = Instrument(program=prog, is_drum=drum)
        inst.notes.extend(Note(v, p, s, e) for v, p, s, e in notes)
        song.instruments.append(inst)
    return song


def _synth_checks(inp, out):
    from eamg_tpu_torch.audio.synth import render_song

    song = _song(json.loads(str(inp["synth/song"])))
    out["synth/wave"] = render_song(song, seed=int(inp["synth/seed"]),
                                    device=CPU)


def _pipeline(inp):
    from eamg_tpu_torch.decode import Generator
    from eamg_tpu_torch.emotion import EmotionClassifier
    from eamg_tpu_torch.serve import Pipeline
    from eamg_tpu_torch.tokenizer import Vocab
    from eamg_tpu_torch.utils.checkpoint import params_from_jax

    gen = Generator(params_from_jax(unflatten(inp, "pipe/p")),
                    _cfg(inp, "pipe/cfg"),
                    Vocab(json.loads(str(inp["pipe/vocab"]))), device=CPU)
    return Pipeline(gen, EmotionClassifier(device=CPU))


def _pipeline_checks(inp, out, pipe):
    for i, (text, seed) in enumerate(json.loads(str(inp["pipe/requests"]))):
        r = pipe.generate(text, seed=seed, render_audio=False)
        out[f"pipe/{i}/midi"] = np.frombuffer(r.midi_bytes, np.uint8)
        out[f"pipe/{i}/label"] = np.asarray(r.label)


def _server_checks(out, pipe):
    """POST /generate on the CPU pipeline: the HTTP contract."""
    import socket
    import urllib.error
    import urllib.parse
    import urllib.request

    from eamg_tpu_torch.serve import make_server, serve_forever_in_thread

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    server = make_server(pipe, "127.0.0.1", port)
    thread = serve_forever_in_thread(server)

    def call(method, path, fields=None):
        data = urllib.parse.urlencode(fields).encode() if fields else None
        req = urllib.request.Request(f"http://127.0.0.1:{port}{path}",
                                     data=data, method=method)
        try:
            with urllib.request.urlopen(req, timeout=300) as r:
                return r.status, r.read()
        except urllib.error.HTTPError as e:
            return e.code, e.read()

    try:
        calls = {
            "wav": ("POST", "/generate", {"prompt": "so happy", "seed": 3}),
            "midi": ("POST", "/generate?format=midi",
                     {"prompt": "so happy", "seed": 3}),
            "stream": ("POST", "/generate", {"prompt": "x", "stream": "1"}),
            "beams": ("POST", "/generate", {"prompt": "x", "beams": "4"}),
            "penalty": ("POST", "/generate",
                        {"prompt": "x", "repetition_penalty": "1.3"}),
            "bad_seed": ("POST", "/generate", {"prompt": "x",
                                               "seed": "abc"}),
            "no_prompt": ("POST", "/generate", {"seed": "1"}),
            "healthz": ("GET", "/healthz", None),
            "stats": ("GET", "/stats", None),
            "profile": ("GET", "/profile", None),
        }
        for name, (method, path, fields) in calls.items():
            status, body = call(method, path, fields)
            out[f"http/{name}/status"] = np.asarray(status)
            out[f"http/{name}/head"] = np.frombuffer(body[:12], np.uint8)
            if status >= 400:
                out[f"http/{name}/error"] = np.asarray(
                    json.loads(body)["error"])
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)


def task_slice(inp, out):
    for tag in json.loads(str(inp["model_tags"])):
        _model_checks(inp, out, tag)
    _prng_checks(inp, out)
    _flagship_checks(inp, out)
    _classifier_checks(inp, out)
    _synth_checks(inp, out)
    pipe = _pipeline(inp)
    _pipeline_checks(inp, out, pipe)
    _server_checks(out, pipe)


TASKS = {"kernels": task_kernels, "slice": task_slice}


def main():
    task, src, dst = sys.argv[1:4]
    torch.manual_seed(0)
    out: dict = {}
    with np.load(src, allow_pickle=False) as inp:
        TASKS[task](inp, out)
    buf = io.BytesIO()
    np.savez(buf, **out)
    with open(dst, "wb") as f:
        f.write(buf.getvalue())


if __name__ == "__main__":
    main()
