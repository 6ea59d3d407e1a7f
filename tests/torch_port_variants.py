"""The PyTorch side of tests/test_torch_variants.py (int8 weights, the MoE
FFN, MoE in the GPT and in training) and tests/test_torch_convert.py (the
GQA converter, the reference .pt in and out, gqa-recover, the CLI): one
task a file, run by tests/torch_port_worker.py in its subprocess (torch
never enters the pytest process). Everything runs on the CPU."""

from __future__ import annotations

import contextlib
import io
import json

import numpy as np
import torch

from torch_port_worker import CPU, _cfg, _named_leaves, _raised, _t, \
    unflatten


def _params(inp, prefix):
    from eamg_tpu_torch.utils.checkpoint import params_from_jax

    return params_from_jax(unflatten(inp, prefix))


def _leaves(tree, prefix) -> dict:
    """A tree of tensors (int8 leaves among them) -> {"prefix/a/b": numpy};
    bf16 as its uint16 bits, so a comparison is bit for bit."""
    out = {}

    def walk(node, path):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, f"{path}/{k}")
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                walk(v, f"{path}/{i}")
        else:
            t = node.detach().cpu()
            out[path] = t.view(torch.int16).numpy().view(np.uint16) \
                if t.dtype == torch.bfloat16 else t.numpy()

    walk(tree, prefix)
    return out


def _cli(argv) -> tuple:
    from eamg_tpu_torch import cli

    buf = io.StringIO()
    code = 0
    with contextlib.redirect_stdout(buf), \
            contextlib.redirect_stderr(io.StringIO()):
        try:
            code = cli.main(argv)
        except SystemExit as e:
            code = e.code
    return code, buf.getvalue()


# --------------------------------------------------------------- variants

def _quant_checks(inp, out):
    from eamg_tpu_torch.models import quant
    from eamg_tpu_torch.utils.checkpoint import (load_checkpoint,
                                                 save_checkpoint)

    # int8 trees through checkpoints: the port writes one for JAX to read,
    # and reads the one JAX wrote
    ck = json.loads(str(inp["quant/ckpt"]))
    cfg = _cfg(inp, "quant/cfg")
    save_checkpoint(ck["port"], quant.quantize_params(
        _params(inp, "quant/p/f32")), {"a": 0}, cfg)
    out.update(_leaves(load_checkpoint(ck["jax"])["params"],
                       "quant/loaded"))
    moe = load_checkpoint(ck["jax_moe"])
    out.update(_leaves(moe["params"], "quant/moe_loaded"))
    out["quant/moe_cfg"] = np.asarray(json.dumps(moe["cfg"].__dict__))
    for dt in ("f32", "bf16"):
        w = _t(inp[f"quant/w/{dt}"], bf16=True)
        wq = quant.quantize_weight(w)
        out[f"quant/q/{dt}"] = wq["q"].numpy()
        out[f"quant/s/{dt}"] = wq["s"].numpy()
        out[f"quant/deq/{dt}"] = quant.dequantize_weight(wq).numpy()
        params = _params(inp, f"quant/p/{dt}")
        qp = quant.quantize_params(params)
        out.update(_leaves(qp, f"quant/qp/{dt}"))
        out[f"quant/err/{dt}"] = np.asarray(quant.quantization_error(params,
                                                                     qp))


def _int8_checks(inp, out):
    """forward, decode_block and greedy generate_kv on int8 trees."""
    from eamg_tpu_torch.decode.loop import generate_kv
    from eamg_tpu_torch.models import gpt
    from eamg_tpu_torch.utils import prng

    ids = _t(inp["int8/ids"]).long()
    for name in json.loads(str(inp["int8/cases"])):
        p = f"int8/{name}"
        cfg = _cfg(inp, f"{p}/cfg")
        params = _params(inp, f"{p}/p")
        out[f"{p}/logits"] = gpt.forward(params, ids, cfg).float().numpy()
        if name not in ("int8", "int8_gqa2"):
            continue
        cache = gpt.init_kv_cache(cfg, ids.shape[0], cfg.seq_len)
        gpt.prefill(params, ids[:, :6], cfg, cache)
        blk, _ = gpt.decode_block(params, ids[:, 6:9], cache, cfg)
        out[f"{p}/block"] = blk.numpy()
        prompt = _t(inp["int8/prompt"]).long()
        buf, n = generate_kv(params, prompt, 3, prng.PRNGKey(0), cfg, 20,
                             greedy=True, eos_id=-1, pad_id=0,
                             refeed_last_prompt=False)
        out[f"{p}/greedy"] = buf[:, :n].numpy()


def _moe_fn_checks(inp, out):
    from eamg_tpu_torch.parallel import moe

    for name in json.loads(str(inp["moe/cases"])):
        p = f"moe/{name}"
        spec = json.loads(str(inp[f"{p}/spec"]))
        cfg = moe.MoEConfig(**spec["cfg"])
        params = _params(inp, f"{p}/p")
        x = _t(inp[f"{p}/x"])
        gates, idx = moe._gates(params, x.reshape(-1, cfg.d_model), cfg)
        out[f"{p}/gates"] = gates.numpy()
        out[f"{p}/idx"] = idx.numpy()
        out[f"{p}/dispatch"] = moe._dispatch_tensors(
            idx.reshape(cfg.top_k, *x.shape[:2]).transpose(0, 1), cfg,
            spec["capacity"]).numpy()
        out[f"{p}/dense"] = moe.moe_mlp_dense(params, x, cfg,
                                              spec["capacity"]).numpy()
        out[f"{p}/dense_default"] = moe.moe_mlp_dense(params, x, cfg).numpy()
        out[f"{p}/pointwise"] = moe.moe_mlp_pointwise(params, x, cfg,
                                                      chunk=5).numpy()
        out[f"{p}/aux"] = np.asarray(float(moe.load_balance_loss(
            params, x.reshape(-1, cfg.d_model), cfg)))


def _moe_gpt_checks(inp, out):
    """init_params, forward, greedy decodes and the engine on MoE GPTs."""
    from eamg_tpu_torch.decode import Generator
    from eamg_tpu_torch.decode.loop import generate_full, generate_kv
    from eamg_tpu_torch.decode.ragged import generate_kv_ragged
    from eamg_tpu_torch.models import gpt
    from eamg_tpu_torch.serve.continuous import ContinuousBatcher
    from eamg_tpu_torch.tokenizer import Vocab
    from eamg_tpu_torch.utils import prng

    for name in json.loads(str(inp["moe_init/cases"])):
        cfg = _cfg(inp, f"moe_init/{name}/cfg")
        out.update(_leaves(gpt.init_params(prng.PRNGKey(5), cfg),
                           f"moe_init/{name}/p"))
    cfg = _cfg(inp, "moe_gpt/cfg")
    params = _params(inp, "moe_gpt/p")
    prompt = _t(inp["moe_gpt/prompt"]).long()
    ids = _t(inp["moe_gpt/ids"]).long()
    out["moe_gpt/logits"] = gpt.forward(params, ids, cfg).numpy()
    a, _ = generate_kv(params, prompt, 3, prng.PRNGKey(0), cfg, 16,
                       greedy=True, eos_id=-1, pad_id=0,
                       refeed_last_prompt=False)
    b, _ = generate_full(params, prompt, 3, prng.PRNGKey(0), cfg, 16,
                         greedy=True, eos_id=-1, pad_id=0)
    out["moe_gpt/greedy_kv"] = a.numpy()
    out["moe_gpt/greedy_full"] = b.numpy()

    # the continuous engine: a row beside another equals the solo decode
    ecfg = _cfg(inp, "moe_engine/cfg")
    gen = Generator(_params(inp, "moe_engine/p"), ecfg,
                    Vocab({str(i): i for i in range(ecfg.vocab_size)}),
                    eos_token="none", pad_token="0", device=CPU)
    reqs = json.loads(str(inp["moe_engine/requests"]))
    for i, (ids_i, seed) in enumerate(reqs):
        pr = torch.zeros((1, 16), dtype=torch.int64)
        pr[0, :len(ids_i)] = torch.tensor(ids_i)
        buf, n = generate_kv_ragged(gen.params, pr, [len(ids_i)],
                                    prng.key_rows([seed]), ecfg, 24,
                                    temperature=1.0, top_k=50, eos_id=-1,
                                    pad_id=0)
        out[f"moe_engine/solo/{i}"] = buf[0, :int(n[0])].numpy()
    eng = ContinuousBatcher(gen, slots=2, chunk=4, max_len=24)
    try:
        import threading

        got = {}

        def hit(i, ids_i, seed):
            got[i] = eng.submit(ids_i, seed=seed, timeout=600)

        threads = [threading.Thread(target=hit, args=(i, *r))
                   for i, r in enumerate(reqs)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        for i in range(len(reqs)):
            out[f"moe_engine/row/{i}"] = np.asarray(got[i])
        out["moe_engine/admitted"] = np.asarray(eng.stats["admitted"])
    finally:
        eng.close()


def _moe_train_checks(inp, out):
    from eamg_tpu_torch.train import trainer as tr

    cfg = _cfg(inp, "moe_train/cfg")
    params = tr.tree_map(lambda t: t.requires_grad_(),
                         _params(inp, "moe_train/p"))
    x, y = _t(inp["moe_train/x"]).long(), _t(inp["moe_train/y"]).long()
    loss, count = tr.loss_fn_moe(params, x[0, 0], y[0, 0], cfg, 0, 0.01)
    grads = torch.autograd.grad(loss, tr.tree_leaves(params))
    out["moe_train/loss"] = np.asarray(float(loss))
    out["moe_train/count"] = np.asarray(int(count))
    out.update(_named_leaves(tr.tree_unflatten(params, grads),
                             "moe_train/grad"))
    t = tr.Trainer(cfg, tr.TrainConfig(**json.loads(str(inp[
        "moe_train/tcfg"]))), _params(inp, "moe_train/p"), device=CPU)
    ms = [t.train_step(x[i], y[i]) for i in range(x.shape[0])]
    out["moe_train/steps"] = np.asarray([m["loss"] for m in ms])
    out.update(_named_leaves(t.params, "moe_train/params"))
    # the refusals JAX asserts: the chunked head or packed rows with the aux
    for k, v in (("loss_chunk", 73), ("pack", True)):
        out[f"moe_train/refuse/{k}"] = _raised(lambda: tr.make_train_step(
            cfg, tr.TrainConfig(**{k: v})))
    # cli train --experts on the host
    run = json.loads(str(inp["moe_train/cli"]))
    out["moe_train/cli_code"], out["moe_train/cli_stdout"] = map(
        np.asarray, _cli(run))


def task_variants(inp, out):
    """tests/test_torch_variants.py: int8 weights and MoE."""
    _quant_checks(inp, out)
    _int8_checks(inp, out)
    _moe_fn_checks(inp, out)
    _moe_gpt_checks(inp, out)
    _moe_train_checks(inp, out)


# ---------------------------------------------------------------- convert

def _gqa_checks(inp, out):
    from eamg_tpu_torch.models.gqa_convert import (convert_checkpoint_dir,
                                                   convert_mha_to_gqa)

    for name in json.loads(str(inp["gqa/cases"])):
        p = f"gqa/{name}"
        cfg = _cfg(inp, f"{p}/cfg")
        params = _params(inp, f"{p}/p")
        for kv in json.loads(str(inp[f"{p}/kv"])):
            got, gcfg = convert_mha_to_gqa(params, cfg, kv)
            out.update(_leaves(got, f"{p}/{kv}/p"))
            out[f"{p}/{kv}/n_kv_heads"] = np.asarray(gcfg.n_kv_heads)
        out[f"{p}/refuse/divisor"] = _raised(
            lambda: convert_mha_to_gqa(params, cfg, cfg.n_head + 1))
    src, dst = (str(inp[k]) for k in ("gqa_dir/src", "gqa_dir/dst"))
    convert_checkpoint_dir(src, dst, int(inp["gqa_dir/kv"]))
    gq, gcfg = convert_mha_to_gqa(
        _params(inp, "gqa/f32/p"), _cfg(inp, "gqa/f32/cfg"), 2)
    out["gqa_dir/refuse/gqa"] = _raised(
        lambda: convert_mha_to_gqa(gq, gcfg, 1))


def _pt_checks(inp, out):
    from eamg_tpu_torch.models import import_torch as it
    from eamg_tpu_torch.models.quant import quantize_params
    from eamg_tpu_torch.tools.convert import convert_reference_pt

    params = _params(inp, "pt/p")
    cfg = _cfg(inp, "pt/cfg")
    vocab = json.loads(str(inp["pt/vocab"]))
    tmp = str(inp["pt/tmp"])
    for dialect in ("trainer", "kv"):
        sd = it.export_state_dict(params, dialect)
        out[f"pt/{dialect}/keys"] = np.asarray(json.dumps(sorted(sd)))
        path = f"{tmp}/port_{dialect}.pt"
        it.export_reference_checkpoint(path, params, vocab, cfg,
                                       dialect=dialect)
        back, bcfg, bvocab = it.load_reference_checkpoint(path)
        out.update(_leaves(back, f"pt/{dialect}/back"))
        out[f"pt/{dialect}/back_cfg"] = np.asarray(json.dumps(
            bcfg.__dict__))
        out[f"pt/{dialect}/back_vocab"] = np.asarray(
            bvocab.tok2id == vocab)
    refusals = {"moe": _params(inp, "pt/moe_p"),
                "int8": quantize_params(params),
                "gqa": _params(inp, "pt/gqa_p")}
    for name, tree in refusals.items():
        out[f"pt/refuse/{name}"] = _raised(
            lambda: it.export_state_dict(tree))
    # the JAX-written .pt files -> checkpoint directories
    for name, (pt, dst, serving) in json.loads(str(inp["pt/convert"])
                                               ).items():
        convert_reference_pt(pt, dst, serving_arch=serving)


def _recover_checks(inp, out):
    from eamg_tpu_torch.tools.gqa_recover import (RecoveryConfig,
                                                  run_gqa_recovery)

    kw = json.loads(str(inp["recover/kw"]))
    res = run_gqa_recovery(RecoveryConfig(**kw, log_fn=lambda *_: None),
                           device=CPU)
    out["recover/result"] = np.asarray(json.dumps(res))


def _convert_cli_checks(inp, out):
    for cmd in json.loads(str(inp["cli/cmds"])):
        code, text = _cli([cmd, "--help"])
        out[f"cli/help/{cmd}/code"] = np.asarray(code)
        out[f"cli/help/{cmd}/text"] = np.asarray(text)
    for name, argv in json.loads(str(inp["cli/runs"])).items():
        code, text = _cli(argv)
        out[f"cli/run/{name}/code"] = np.asarray(code)
        out[f"cli/run/{name}/stdout"] = np.asarray(text)
    a, b = (torch.load(f, map_location="cpu", weights_only=True)
            for f in json.loads(str(inp["cli/pt_pair"])))
    same = (a["vocab"] == b["vocab"] and a["cfg"] == b["cfg"]
            and list(a["model"]) == list(b["model"])
            and all(torch.equal(a["model"][k], b["model"][k])
                    and a["model"][k].dtype == b["model"][k].dtype
                    for k in a["model"]))
    out["cli/pt_equal"] = np.asarray("equal" if same else "differ")


def task_convert(inp, out):
    """tests/test_torch_convert.py: convert-gqa, the .pt dialects,
    gqa-recover and their subcommands."""
    _gqa_checks(inp, out)
    _pt_checks(inp, out)
    _recover_checks(inp, out)
    _convert_cli_checks(inp, out)


VARIANTS_TASKS = {"variants": task_variants, "convert": task_convert}
