"""The PyTorch side of tests/test_torch_emotion_data.py (the corpus, the
situation generator, the tokenizer's training options, init_params and
init_lora, the converters, the CLI and a tiny distill_classifier) and
tests/test_torch_emotion_train.py (the training forward, the losses and
their gradients, the three trainers' steps and the finetune loop): one
task a file, run by tests/torch_port_worker.py in its subprocess (torch
never enters the pytest process). Everything runs on the CPU."""

from __future__ import annotations

import contextlib
import io
import json
import os
import pickle
import random
import sys
from unittest import mock

import numpy as np
import torch

from torch_port_worker import CPU, _named_leaves, _raised, unflatten

PACKAGED = os.path.join("eamg_tpu", "emotion", "ckpt_distilbert")


def _tensors(tree, dtype=None):
    if isinstance(tree, dict):
        return {k: _tensors(v, dtype) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_tensors(v, dtype) for v in tree]
    t = torch.from_numpy(np.array(tree))
    return t.to(dtype) if dtype is not None and t.is_floating_point() else t


def _cfg(inp, key):
    from eamg_tpu_torch.models.distilbert import DistilBertConfig

    return DistilBertConfig(**json.loads(str(inp[key])))


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


def _pickle_leaves(path, prefix) -> dict:
    with open(path, "rb") as f:
        tree = pickle.load(f)
    return _named_leaves(_tensors(tree), prefix)


# ------------------------------------------------------------------ data

def _corpus_checks(inp, out):
    from eamg_tpu_torch.emotion import distill_data as dd
    from eamg_tpu_torch.emotion import situation_gen as sg

    for name, kw in json.loads(str(inp["data/corpora"])).items():
        data = dd.make_corpus(**kw)
        out[f"data/corpus/{name}"] = np.asarray(json.dumps(data))
        vocab = dd.build_wordpiece_vocab(
            dd.tokenizer_corpus(data["train"][0]))
        out[f"data/vocab/{name}"] = np.asarray(json.dumps(vocab))
    out["data/label_banks"] = np.asarray(json.dumps(dd.label_banks()))
    out["data/situation_banks"] = np.asarray(json.dumps(
        dd.situation_banks()))
    with open(sg._EXAM_PATH, "rb") as f:
        out["data/exam_bytes"] = np.frombuffer(f.read(), np.uint8)
    gen = {"frozen_exam": sg.frozen_exam(),
           "built_exam": sg.build_frozen_exam(),
           "crosstalk": sg.generator_crosstalk()}
    for label in sorted(sg.SCHEMAS):
        for split in ("train", "eval"):
            rng = random.Random(5)
            gen[f"{label}/{split}/generate"] = sg.generate(label, rng, 12,
                                                           split)
            gen[f"{label}/{split}/next"] = rng.random()
            gen[f"{label}/{split}/schemas"] = sg.split_schemas(label, split)
            gen[f"{label}/{split}/count"] = sg.schema_count(label, split)
    out["data/generator"] = np.asarray(json.dumps(gen))


def _encode_checks(inp, out):
    from eamg_tpu_torch.models.distilbert import WordPieceTokenizer

    tok = WordPieceTokenizer(json.loads(str(inp["enc/vocab"])))
    texts = json.loads(str(inp["enc/texts"]))
    cues = json.loads(str(inp["enc/cues"]))
    for name, (p, with_cue, max_length) in json.loads(
            str(inp["enc/cases"])).items():
        rng = random.Random(11)
        encs = [tok.encode(t, max_length, rng=rng, piece_dropout=p,
                           cue=cues[i] if with_cue else None)
                for i, t in enumerate(texts)]
        for k in encs[0]:
            out[f"enc/{name}/{k}"] = np.stack([e[k] for e in encs])
        out[f"enc/{name}/next"] = np.asarray(rng.random())
    rng = random.Random(3)
    out["enc/dropout_tokens"] = np.asarray(json.dumps(
        [tok.tokenize_dropout(t, rng, 0.5) for t in texts]))
    out["enc/dropout_next"] = np.asarray(rng.random())


def _init_checks(inp, out):
    from eamg_tpu_torch.emotion.finetune import LoraSpec, init_lora
    from eamg_tpu_torch.models.distilbert import init_params
    from eamg_tpu_torch.utils import prng

    cfg = _cfg(inp, "init/cfg")
    out.update(_named_leaves(init_params(prng.PRNGKey(5), cfg, device=CPU),
                             "init/params"))
    spec = LoraSpec(**json.loads(str(inp["init/lora_spec"])))
    out.update(_named_leaves(init_lora(prng.PRNGKey(9), cfg, spec),
                             "init/lora"))


def _convert_checks(inp, out):
    from eamg_tpu_torch.models.distilbert import import_hf_state_dict
    from eamg_tpu_torch.tools.convert import convert_hf_distilbert

    cfg = _cfg(inp, "hf/cfg")
    sd = {k[len("hf/sd/"):]: torch.from_numpy(np.array(inp[k]))
          for k in inp.files if k.startswith("hf/sd/")}
    out.update(_named_leaves(_tensors(import_hf_state_dict(sd, cfg)),
                             "hf/imported"))
    # the port's export (written by the CLI checks) against JAX's, and
    # JAX's export converted by the port
    paths = json.loads(str(inp["hf/paths"]))
    convert_hf_distilbert(paths["jax_hf"], paths["port_from_jax"])
    a = torch.load(os.path.join(paths["port_hf"], "pytorch_model.bin"),
                   map_location="cpu", weights_only=True)
    b = torch.load(os.path.join(paths["jax_hf"], "pytorch_model.bin"),
                   map_location="cpu", weights_only=True)
    same = (list(a) == list(b)
            and all(a[k].dtype == b[k].dtype and torch.equal(a[k], b[k])
                    for k in a))
    out["hf/bin_equal"] = np.asarray("equal" if same else "differ")
    out["hf/n_keys"] = np.asarray(len(a))


def _cli_checks(inp, out):
    from eamg_tpu_torch import cli

    for cmd in json.loads(str(inp["cli/cmds"])):
        code, text = _cli([cmd, "--help"])
        out[f"cli/help/{cmd}/code"] = np.asarray(code)
        out[f"cli/help/{cmd}/text"] = np.asarray(text)
    # each subcommand's parsed defaults (its function stood in for)
    fns = {"distill-emotion": "_distill_emotion",
           "finetune-emotion": "_finetune_emotion",
           "convert-distilbert": "_convert_distilbert",
           "export-emotion-hf": "_export_emotion_hf"}
    for cmd, argv in json.loads(str(inp["cli/required"])).items():
        seen = {}
        with mock.patch.object(cli, fns[cmd],
                               lambda a: seen.update(vars(a)) or 0):
            cli.main([cmd] + argv)
        seen.pop("fn")
        out[f"cli/defaults/{cmd}"] = np.asarray(json.dumps(seen))
    for name, argv in json.loads(str(inp["cli/runs"])).items():
        code, text = _cli(argv)
        out[f"cli/run/{name}/code"] = np.asarray(code)
        out[f"cli/run/{name}/stdout"] = np.asarray(text)
    # --push without huggingface_hub: the gate's error, no upload tried
    paths = json.loads(str(inp["hf/paths"]))
    with mock.patch.dict(sys.modules, {"huggingface_hub": None}):
        out["cli/push_raised"] = _raised(lambda: cli.main(
            ["export-emotion-hf", "--ckpt", PACKAGED, "--out",
             paths["push_hf"], "--push", "a/b"]))


def _distill_checks(inp, out):
    from eamg_tpu_torch.emotion import EmotionClassifier
    from eamg_tpu_torch.emotion.train_scratch import (ScratchSpec,
                                                      distill_classifier,
                                                      scratch_optimizer)

    d = json.loads(str(inp["distill/dirs"]))
    spec = ScratchSpec(**json.loads(str(inp["distill/spec"])))
    lines = []
    metrics = distill_classifier(d["port"], spec=spec, log_fn=lines.append,
                                 device=CPU)
    out["distill/metrics"] = np.asarray(json.dumps(
        {k: (None if isinstance(v, float) and v != v else v)
         for k, v in metrics.items()}))
    out["distill/log"] = np.asarray(json.dumps(lines[:-1]))
    texts = json.loads(str(inp["distill/texts"]))
    for tag in ("port", "jax"):
        clf = EmotionClassifier(backend="distilbert", checkpoint_dir=d[tag],
                                device=CPU)
        out[f"distill/probs/{tag}"] = np.stack([clf._probs(t)
                                                for t in texts])
    # a recipe of one epoch: decay_steps == warmup_steps
    out["distill/one_epoch"] = _raised(lambda: scratch_optimizer(spec, 5, 5))


def task_emotion_data(inp, out):
    """tests/test_torch_emotion_data.py."""
    _corpus_checks(inp, out)
    _encode_checks(inp, out)
    _init_checks(inp, out)
    _cli_checks(inp, out)
    _convert_checks(inp, out)
    _distill_checks(inp, out)


# ----------------------------------------------------------------- train

def _forward_checks(inp, out):
    from eamg_tpu_torch.models import distilbert as db

    params = _tensors(unflatten(inp, "fw/params"))
    lora = _tensors(unflatten(inp, "fw/lora"))
    ids = torch.from_numpy(inp["fw/ids"])
    mask = torch.from_numpy(inp["fw/mask"])
    for pool in ("cls", "mean", "max"):
        cfg = _cfg(inp, f"fw/cfg/{pool}")
        out[f"fw/{pool}/plain"] = db.forward(params, ids, mask, cfg).numpy()
        out[f"fw/{pool}/lora"] = db.forward_train(
            params, ids, mask, cfg, lora=lora, lora_scale=2.0).detach() \
            .numpy()
    cfg = _cfg(inp, "fw/cfg/max")
    out["fw/token_logits"] = db.forward_token_logits(
        params, ids, mask, cfg).detach().numpy()
    out["fw/hidden"] = db.forward_hidden(params, ids, mask, cfg).detach() \
        .numpy()


def _loss_checks(inp, out):
    from eamg_tpu_torch.emotion.train_scratch import (classifier_loss,
                                                      mlm_loss)
    from eamg_tpu_torch.train.trainer import tree_leaves, tree_unflatten

    params = _tensors(unflatten(inp, "fw/params"))
    b = {k: torch.from_numpy(inp[f"loss/{k}"])
         for k in ("ids", "mask", "labels", "cue", "targets", "lm")}
    for case, (pool, suppress) in json.loads(
            str(inp["loss/cases"])).items():
        cfg = _cfg(inp, f"fw/cfg/{pool}")
        live = [p.clone().requires_grad_() for p in tree_leaves(params)]
        tree = tree_unflatten(params, live)
        if case == "mlm":
            loss = mlm_loss(tree, torch.from_numpy(inp["loss/ids_mlm"]),
                            b["mask"], b["targets"], b["lm"], cfg)
        else:
            loss, _ = classifier_loss(tree, b["ids"], b["mask"],
                                      b["labels"], b["cue"], cfg, 0.05,
                                      suppress)
        grads = torch.autograd.grad(loss, live, materialize_grads=True)
        out[f"loss/{case}/loss"] = loss.detach().numpy()
        out.update(_named_leaves(tree_unflatten(params, list(grads)),
                                 f"loss/{case}/grad"))


def _scratch_steps(inp, out):
    from eamg_tpu_torch.emotion.train_scratch import (ScratchSpec,
                                                      make_classifier_step,
                                                      make_mlm_step,
                                                      scratch_optimizer)
    from eamg_tpu_torch.train.trainer import tree_leaves

    spec = ScratchSpec(**json.loads(str(inp["steps/spec"])))
    sched = json.loads(str(inp["steps/schedules"]))
    for name in ("classifier", "mlm"):
        cfg = _cfg(inp, "fw/cfg/max")
        params = _tensors(unflatten(inp, "fw/params"))
        opt = scratch_optimizer(spec, *sched[name])
        state = opt.init(tree_leaves(params))
        step = make_classifier_step(cfg, spec, opt) if name == "classifier" \
            else make_mlm_step(cfg, opt)
        losses = []
        for i in range(3):
            batch = [torch.from_numpy(inp[f"steps/{i}/{k}"]) for k in
                     (("ids", "mask", "labels", "cue")
                      if name == "classifier"
                      else ("ids_mlm", "mask", "targets", "lm"))]
            losses.append(float(step(params, state, *batch)[0]))
        out[f"steps/{name}/losses"] = np.asarray(losses)
        out.update(_named_leaves(params, f"steps/{name}/params"))


def _finetune_steps(inp, out):
    from eamg_tpu_torch.emotion.finetune import (LoraSpec, init_lora,
                                                 make_finetune_step)
    from eamg_tpu_torch.models.distilbert import DistilBertConfig
    from eamg_tpu_torch.train.trainer import tree_leaves, tree_unflatten
    from eamg_tpu_torch.utils import prng

    with open(os.path.join(PACKAGED, "config.pkl"), "rb") as f:
        cfg = DistilBertConfig(**pickle.load(f))
    with open(os.path.join(PACKAGED, "params.pkl"), "rb") as f:
        raw = pickle.load(f)
    spec = LoraSpec()
    for base in ("f32", "f16"):
        frozen = _tensors(raw, torch.float32 if base == "f32" else None)
        trainable = {"lora": init_lora(prng.PRNGKey(spec.seed), cfg, spec),
                     **{h: {k: v.clone() for k, v in frozen[h].items()}
                        for h in ("pre_classifier", "classifier")}}
        step, opt = make_finetune_step(cfg, spec)
        state = opt.init(tree_leaves(trainable))
        for i in range(3):
            trainable, state, m = step(
                trainable, frozen, state,
                torch.from_numpy(inp[f"ft/{i}/ids"]),
                torch.from_numpy(inp[f"ft/{i}/mask"]),
                torch.from_numpy(inp[f"ft/{i}/labels"]))
            out[f"ft/{base}/{i}/loss"] = m["loss"].numpy()
            # copies: the next step updates the leaves in place
            out.update({k: v.copy() for k, v in _named_leaves(
                trainable, f"ft/{base}/{i}/trainable").items()})
        out.update(_named_leaves(
            {m: tree_unflatten(trainable, state[m]) for m in ("mu", "nu")},
            f"ft/{base}/moments"))


def _finetune_loop(inp, out):
    from eamg_tpu_torch.emotion.finetune import LoraSpec, finetune
    from eamg_tpu_torch.models.distilbert import WordPieceTokenizer

    cfg = _cfg(inp, "loop/cfg")
    params = unflatten(inp, "fw/params")
    before = {k: np.array(v) for k, v in _named_leaves(
        _tensors(params), "p").items()}
    tok = WordPieceTokenizer(json.loads(str(inp["loop/vocab"])))
    spec = LoraSpec(**json.loads(str(inp["loop/spec"])))
    merged, _, history = finetune(
        params, cfg, tok, json.loads(str(inp["loop/texts"])),
        json.loads(str(inp["loop/labels"])), spec=spec, eval_fraction=0.25,
        log_fn=lambda *_: None, device=CPU)
    out["loop/history"] = np.asarray(json.dumps(history))
    out.update(_named_leaves(merged, "loop/merged"))
    after = _named_leaves(_tensors(params), "p")
    out["loop/params_unchanged"] = np.asarray(all(
        np.array_equal(before[k], after[k]) for k in before))


def _finetune_cli(inp, out):
    paths = json.loads(str(inp["ftcli/paths"]))
    code, text = _cli(["finetune-emotion", "--base", PACKAGED, "--tsv",
                       paths["tsv"], "--out", paths["port"], "--epochs",
                       "1", "--log-every", "1", "--device", "cpu"])
    out["ftcli/code"] = np.asarray(code)
    out["ftcli/stdout"] = np.asarray(text)
    out.update(_pickle_leaves(os.path.join(paths["port"], "params.pkl"),
                              "ftcli/params"))


def task_emotion_train(inp, out):
    """tests/test_torch_emotion_train.py."""
    _forward_checks(inp, out)
    _loss_checks(inp, out)
    _scratch_steps(inp, out)
    _finetune_steps(inp, out)
    _finetune_loop(inp, out)
    _finetune_cli(inp, out)


EMOTION_TASKS = {"emotion_data": task_emotion_data,
                 "emotion_train": task_emotion_train}
