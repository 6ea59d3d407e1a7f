"""The PyTorch side of tests/test_torch_draft.py, test_torch_engine_medusa.py,
test_torch_medusa_tree.py and test_torch_train_medusa.py: one task a file,
run by tests/torch_port_worker.py in its subprocess (torch never enters
the pytest process). Everything runs on the CPU."""

from __future__ import annotations

import contextlib
import io
import json
import os
import tempfile
import threading

import numpy as np
import torch

from torch_port_worker import (CPU, _cfg, _free_port, _heads_from, _raised,
                               _t, unflatten)


def _params(inp, prefix):
    from eamg_tpu_torch.utils.checkpoint import params_from_jax

    return params_from_jax(unflatten(inp, prefix))


def _prompt(ids, width=16):
    p = torch.zeros((1, width), dtype=torch.int64)
    p[0, :len(ids)] = torch.tensor(ids)
    return p


# -------------------------------------------------------------------- draft

def task_draft(inp, out):
    """generate_speculative at each gamma, greedy and sampled; the plain
    greedy decode; Generator.generate_ids_speculative; cli generate
    --draft and its refusals."""
    from eamg_tpu_torch import cli
    from eamg_tpu_torch.decode import Generator
    from eamg_tpu_torch.decode.loop import generate_kv
    from eamg_tpu_torch.decode.speculative import generate_speculative
    from eamg_tpu_torch.tokenizer import Vocab
    from eamg_tpu_torch.utils import prng

    cfg_t, cfg_d = _cfg(inp, "t/cfg"), _cfg(inp, "d/cfg")
    pt, pd = _params(inp, "t/p"), _params(inp, "d/p")
    ids = [int(i) for i in inp["prompt"]]
    max_len = int(inp["max_len"])
    prompt = _prompt(ids)
    for name, (gamma, kw) in json.loads(str(inp["runs"])).items():
        kw = dict(kw)
        seed = kw.pop("seed", 0)
        buf, n = generate_speculative(pt, pd, prompt, len(ids),
                                      prng.PRNGKey(seed), cfg_t, cfg_d,
                                      max_len, gamma=gamma, **kw)
        out[f"run/{name}"] = buf[0, :n].numpy()
        # the eager loop (every iteration issued from the host) on the CPU
        # runs the code the card captures: the same tokens
        if name.endswith("_s0"):
            eb, en = generate_speculative(pt, pd, prompt, len(ids),
                                          prng.PRNGKey(seed), cfg_t, cfg_d,
                                          max_len, gamma=gamma, eager=True,
                                          **kw)
            out[f"eager/{name}"] = eb[0, :en].numpy()
    buf, n = generate_kv(pt, prompt, len(ids), prng.PRNGKey(0), cfg_t,
                         max_len, greedy=True, refeed_last_prompt=False)
    out["kv_greedy"] = buf[0, :n].numpy()
    vocab = Vocab({str(i): i for i in range(cfg_t.vocab_size)})
    tgt = Generator(pt, cfg_t, vocab, eos_token="3", pad_token="0",
                    device=CPU)
    drf = Generator(pd, cfg_d, vocab, eos_token="3", pad_token="0",
                    device=CPU)
    for name, kw in json.loads(str(inp["gen_runs"])).items():
        kw = dict(kw)
        p = kw.pop("prompt")
        out[f"gen/{name}"] = tgt.generate_ids_speculative(drf, p, **kw)[0]
    other = Generator(pd, cfg_d, Vocab({str(i): i for i in range(
        cfg_t.vocab_size - 1)}), device=CPU)
    out["gen/vocab_mismatch"] = _raised(
        lambda: tgt.generate_ids_speculative(other, ids, max_len=max_len))
    with tempfile.TemporaryDirectory() as tmp:
        for name, argv in json.loads(str(inp["cli"])).items():
            mid = os.path.join(tmp, f"{name}.mid")
            with contextlib.redirect_stdout(io.StringIO()):
                try:
                    code = cli.main(["generate", "--device", "cpu", *argv,
                                     "--out", mid])
                    out[f"cli/{name}/raised"] = np.asarray("none")
                except (AssertionError, SystemExit) as e:
                    code = -1
                    out[f"cli/{name}/raised"] = np.asarray(
                        f"{type(e).__name__}: {e}")
            out[f"cli/{name}/code"] = np.asarray(code)
            if os.path.exists(mid):
                with open(mid, "rb") as f:
                    out[f"cli/{name}/midi"] = np.frombuffer(f.read(),
                                                            np.uint8)


# ------------------------------------------------------------ engine medusa

def _engine_gen(inp):
    from eamg_tpu_torch.decode import Generator
    from eamg_tpu_torch.tokenizer import Vocab

    cfg = _cfg(inp, "model/cfg")
    return Generator(_params(inp, "model/p"), cfg,
                     Vocab({str(i): i for i in range(cfg.vocab_size)}),
                     eos_token="none", pad_token="0", device=CPU)


def _solo_medusa(gen, heads, ids, seed, max_len, gamma, **kw):
    from eamg_tpu_torch.decode.medusa import generate_medusa
    from eamg_tpu_torch.utils import prng

    buf, n, _ = generate_medusa(gen.params, heads, _prompt(ids), len(ids),
                                prng.PRNGKey(seed), gen.cfg, max_len,
                                gamma=gamma, top_k=50, eos_id=-1, pad_id=0,
                                **kw)
    return buf[0, :n].tolist()


def _ragged_checks(inp, out):
    """decode_block_ragged on a fused copy of the test's head-major ragged
    cache."""
    from eamg_tpu_torch.decode.ragged import decode_block_ragged

    cfg = _cfg(inp, "ragged/cfg")
    params = _params(inp, "ragged/p")
    c = unflatten(inp, "ragged/cache")
    B, _, M, _ = c["k"][0].shape
    kv = [torch.cat([_t(k).transpose(1, 2).reshape(B, M, -1),
                     _t(v).transpose(1, 2).reshape(B, M, -1)],
                    dim=2).contiguous() for k, v in zip(c["k"], c["v"])]
    cache = {"kv": kv, "lengths": _t(inp["ragged/lengths"]).int()}
    logits, hidden, cache = decode_block_ragged(
        params, _t(inp["ragged/block"]).long(), cache, cfg)
    out["ragged/logits"] = logits.numpy()
    out["ragged/hidden"] = hidden.numpy()
    out["ragged/lengths"] = cache["lengths"].numpy()
    for li, a in enumerate(cache["kv"]):
        out[f"ragged/kv/{li}"] = a.numpy()


def task_engine_medusa(inp, out):
    """The engine's Medusa rows: the cases of JAX's
    tests/test_continuous_medusa.py, each row against the port's solo
    decode here and JAX's in the test; decode_block_ragged."""
    import eamg_tpu_torch.serve.continuous as cont
    from eamg_tpu_torch.serve.continuous import ContinuousBatcher

    gen = _engine_gen(inp)
    heads = _heads_from(inp, "heads")
    gamma = len(heads["blocks"])
    base = dict(slots=2, chunk=4, max_len=24)

    def engine(**kw):
        return ContinuousBatcher(gen, **{**base, **kw})

    eng = engine(medusa_heads=heads)
    try:
        out["max_len"] = np.asarray(eng.max_len)
        for seed, ids in ((11, [1, 2, 3]), (22, [4, 5])):
            out[f"sampled/{seed}"] = np.asarray(eng.submit(ids, seed=seed,
                                                           medusa=True))
            out[f"sampled_solo/{seed}"] = np.asarray(_solo_medusa(
                gen, heads, ids, seed, eng.max_len, gamma))
        whole = eng.submit([2, 4, 6], seed=5, medusa=True)
        deltas = []
        for delta in eng.submit_stream([2, 4, 6], seed=5, medusa=True):
            deltas.extend(delta)
        out["stream/whole"] = np.asarray(whole)
        out["stream/deltas"] = np.asarray(deltas)
        out["medusa_graph"] = np.asarray("medusa_graph" in eng.state)
    finally:
        eng.close()
    eng = engine(greedy=True, medusa_heads=heads)
    try:
        out["greedy"] = np.asarray(eng.submit([3, 1, 4], seed=9,
                                              medusa=True))
        out["greedy_solo"] = np.asarray(_solo_medusa(
            gen, heads, [3, 1, 4], 9, eng.max_len, gamma, greedy=True))
    finally:
        eng.close()
    plain = engine(greedy=True, max_len=int(out["max_len"]))
    try:
        out["greedy_plain"] = np.asarray(plain.submit([3, 1, 4], seed=9))
    finally:
        plain.close()
    eng = engine(slots=4, medusa_heads=heads)
    try:
        reqs = json.loads(str(inp["mixed"]))
        results = [None] * len(reqs)

        def hit(i):
            p, s, m = reqs[i]
            results[i] = eng.submit(p, seed=s, medusa=m)

        threads = [threading.Thread(target=hit, args=(i,), daemon=True)
                   for i in range(len(reqs))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        for i, r in enumerate(results):
            out[f"mixed/{i}"] = np.asarray(r)
        out["mixed/served"] = np.asarray(eng.stats["served"])
    finally:
        eng.close()
    eng = engine(medusa_heads=heads)
    try:
        out["plain_only"] = np.asarray(eng.submit([1, 2, 3], seed=11))
        out["plain_only_graph"] = np.asarray("medusa_graph" in eng.state)
    finally:
        eng.close()
    plain = engine()
    try:
        out["val/plain_accepts"] = np.asarray(plain.accepts(medusa=True))
        out["val/plain_submit"] = _raised(
            lambda: plain.submit([1, 2], medusa=True))
    finally:
        plain.close()
    eng = engine(per_row_sampling=True, medusa_heads=heads)
    try:
        out["val/row_accepts"] = np.asarray(eng.accepts(medusa=True))
        out["val/penalties"] = _raised(lambda: eng.submit(
            [1, 2], medusa=True, penalties=(1.2, 0.0, 0.0)))
        out["top_p"] = np.asarray(eng.submit([1, 2, 3], seed=13,
                                             medusa=True, top_p=0.9))
        out["top_p_solo"] = np.asarray(_solo_medusa(
            gen, heads, [1, 2, 3], 13, eng.max_len, gamma, top_p=0.9))
    finally:
        eng.close()
    eng = engine(max_len=16, medusa_heads=heads)
    real = cont.ragged_chunk
    calls = {"n": 0}

    def boom(*a, **k):
        calls["n"] += 1
        if calls["n"] == 1:
            raise RuntimeError("injected backend failure")
        return real(*a, **k)

    cont.ragged_chunk = boom
    try:
        out["fail/raised"] = _raised(lambda: eng.submit([1, 2], seed=1,
                                                        timeout=60))
        out["fail/fields"] = np.asarray(json.dumps(
            sorted(k for k in ("h_last", "med_on") if k in eng.state)))
        out["fail/medusa"] = np.asarray(eng.submit([1, 2], seed=3,
                                                   timeout=120, medusa=True))
        out["fail/plain"] = np.asarray(eng.submit([3, 4], seed=2,
                                                  timeout=120))
    finally:
        cont.ragged_chunk = real
        eng.close()
    _ragged_checks(inp, out)


# ------------------------------------------------------------- tree verify

def task_medusa_tree(inp, out):
    """tree_tables, _top_b, decode_tree and generate_medusa_tree."""
    from eamg_tpu_torch.decode.loop import generate_kv
    from eamg_tpu_torch.decode.medusa import generate_medusa, init_medusa_heads
    from eamg_tpu_torch.decode.medusa_tree import (_top_b,
                                                   generate_medusa_tree,
                                                   tree_tables)
    from eamg_tpu_torch.models import gpt
    from eamg_tpu_torch.utils import prng

    for name, spec in json.loads(str(inp["trees"])).items():
        tb = tree_tables(tuple(tuple(e) for e in spec))
        for k, v in tb.items():
            out[f"tables/{name}/{k}"] = np.asarray(v)
    out["top_b"] = _top_b(_t(inp["top_b/logits"]),
                          int(inp["top_b/b"])).numpy()
    cfg = _cfg(inp, "model/cfg")
    params = _params(inp, "model/p")
    tb = tree_tables()
    depth, anc = torch.from_numpy(tb["depth"]).long(), torch.from_numpy(
        tb["anc"])
    for i in range(int(inp["n_trees"])):
        c = unflatten(inp, f"tree/{i}/cache")
        cache = {"k": [_t(a) for a in c["k"]], "v": [_t(a) for a in c["v"]],
                 "length": torch.tensor([int(inp[f"tree/{i}/t"])],
                                        dtype=torch.int32)}
        logits, h, cache = gpt.decode_tree(params, _t(inp[f"tree/{i}/ids"])
                                           .long(), depth, anc, cache, cfg)
        out[f"tree/{i}/logits"] = logits.numpy()
        out[f"tree/{i}/hidden"] = h.numpy()
        out[f"tree/{i}/length"] = cache["length"].numpy()
        for j, a in enumerate(cache["k"] + cache["v"]):
            out[f"tree/{i}/cache/{j}"] = a.numpy()
    heads = _heads_from(inp, "model/heads")
    ids = [int(i) for i in inp["prompt"]]
    max_len = int(inp["max_len"])
    for name, eos in json.loads(str(inp["runs"])).items():
        buf, n, steps = generate_medusa_tree(params, heads, _prompt(ids),
                                             len(ids), cfg, max_len,
                                             eos_id=eos)
        out[f"run/{name}/tokens"] = buf[0, :n].numpy()
        out[f"run/{name}/steps"] = np.asarray(steps)
    buf, n, steps = generate_medusa_tree(params, heads, _prompt(ids),
                                         len(ids), cfg, max_len, eager=True)
    out["eager/tokens"] = buf[0, :n].numpy()
    buf, n = generate_kv(params, _prompt(ids), len(ids), prng.PRNGKey(0),
                         cfg, max_len, greedy=True, refeed_last_prompt=False)
    out["kv_greedy"] = buf[0, :n].numpy()
    zero = init_medusa_heads(None, cfg, 4)
    _, n_t, s_t = generate_medusa_tree(params, zero, _prompt(ids), len(ids),
                                       cfg, max_len)
    _, n_l, s_l = generate_medusa(params, zero, _prompt(ids), len(ids),
                                  prng.PRNGKey(0), cfg, max_len, gamma=4,
                                  greedy=True)
    out["zero/tree"] = np.asarray([n_t, s_t])
    out["zero/linear"] = np.asarray([n_l, s_l])


# ----------------------------------------------------------- head training

def _profile_checks(inp, out, tmp):
    """GET /profile on an in-process server of a CPU pipeline."""
    import urllib.request

    from eamg_tpu_torch.decode import Generator
    from eamg_tpu_torch.emotion import EmotionClassifier
    from eamg_tpu_torch.serve import (Pipeline, make_server,
                                      serve_forever_in_thread,
                                      shutdown_gracefully)
    from eamg_tpu_torch.tokenizer import Vocab

    cfg = _cfg(inp, "ckpt/cfg")
    vocab = Vocab(json.loads(str(inp["ckpt/vocab"])))
    pipe = Pipeline(Generator(_params(inp, "ckpt/p"), cfg, vocab,
                              device=CPU),
                    EmotionClassifier(backend="lexicon", device=CPU))
    port = _free_port()
    server = make_server(pipe, "127.0.0.1", port)
    thread = serve_forever_in_thread(server)
    trace_dir = os.path.join(tmp, "profile")
    try:
        for name, query in (("dir", f"?dir={trace_dir}"), ("default", "")):
            with urllib.request.urlopen(
                    f"http://127.0.0.1:{port}/profile{query}",
                    timeout=300) as r:
                body = json.loads(r.read())
                out[f"profile/{name}/status"] = np.asarray(r.status)
            out[f"profile/{name}/keys"] = np.asarray(json.dumps(
                sorted(body)))
            out[f"profile/{name}/trace"] = np.asarray(os.path.isfile(
                os.path.join(body["trace_dir"], "trace.json")))
            with open(os.path.join(body["trace_dir"], "trace.json")) as f:
                events = json.load(f)["traceEvents"]
            out[f"profile/{name}/events"] = np.asarray(len(events))
            out[f"profile/{name}/at_dir"] = np.asarray(
                body["trace_dir"] == trace_dir)
    finally:
        server.shutdown()
        shutdown_gracefully(server, pipe)
        thread.join(timeout=30)


def task_train_medusa(inp, out):
    """train_medusa_heads on the test's checkpoint, its pickle, the head
    loss and one AdamW step, cli train-medusa and medusa-measure, and GET
    /profile."""
    from eamg_tpu_torch import cli
    from eamg_tpu_torch.tools.medusa import (MedusaSpec, head_optimizer,
                                             head_step, heads_leaves,
                                             medusa_head_loss,
                                             train_medusa_heads)
    from eamg_tpu_torch.utils.checkpoint import load_checkpoint

    ckpt = str(inp["ckpt/dir"])
    spec = MedusaSpec(**json.loads(str(inp["spec"])))
    logs = []
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "heads.pkl")
        res = train_medusa_heads(ckpt, path, spec, log_fn=logs.append,
                                 device=CPU)
        out["train/logs"] = np.asarray(json.dumps(logs))
        out["train/final_loss"] = np.asarray(res["final_loss"])
        out["train/probe"] = np.asarray(json.dumps(res["probe"]))
        for i, blk in enumerate(res["blocks"]):
            out[f"train/w/{i}"], out[f"train/b/{i}"] = blk["w"], blk["b"]
        with open(path, "rb") as f:
            out["train/pickle"] = np.frombuffer(f.read(), np.uint8)
        ck = load_checkpoint(ckpt)
        blocks = [{k: _t(v).clone() for k, v in b.items()}
                  for b in unflatten(inp, "loss/heads")["blocks"]]
        batch = _t(inp["loss/ids"]).long()
        out["loss/value"] = medusa_head_loss(
            ck["params"], blocks, batch, ck["cfg"], 0).numpy()
        opt = head_optimizer(spec)
        state = opt.init(heads_leaves(blocks))
        head_step(ck["params"], blocks, opt, state, batch, ck["cfg"], 0)
        for i, blk in enumerate(blocks):
            out[f"loss/step/w/{i}"] = blk["w"].numpy()
            out[f"loss/step/b/{i}"] = blk["b"].numpy()
        heads4 = os.path.join(tmp, "heads4.pkl")
        for name, argv in (
                ("train", ["train-medusa", "--ckpt", ckpt, "--out", heads4,
                           "--heads", "4", "--rows", "16", "--epochs", "1",
                           "--batch", "8", "--measure", "--max-len", "24"]),
                ("linear", ["medusa-measure", "--ckpt", ckpt, "--heads",
                            heads4, "--max-len", "24", "--reps", "1"]),
                ("tree", ["medusa-measure", "--ckpt", ckpt, "--heads",
                          heads4, "--max-len", "24", "--reps", "1",
                          "--tree"])):
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                code = cli.main([*argv, "--device", "cpu"])
            out[f"cli/{name}/code"] = np.asarray(code)
            out[f"cli/{name}/json"] = np.asarray(
                buf.getvalue().strip().splitlines()[-1])
        _profile_checks(inp, out, tmp)


SPEC2_TASKS = {"draft": task_draft, "engine_medusa": task_engine_medusa,
               "medusa_tree": task_medusa_tree,
               "train_medusa": task_train_medusa}
