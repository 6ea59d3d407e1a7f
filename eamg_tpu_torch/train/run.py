"""End-to-end training runs mirroring the four reference trainers.

Port of ``eamg_tpu/train/run.py``. preset -> (scheme, geometry,
hyperparams):
- ``mini``    = train/train_mini.py    (Scheme A, d256 h4 L2, batch 8)
- ``large``   = train/train_large.py   (Scheme B1, d256 h8 L4, accum 8)
- ``large2``  = train/train_large2.py  (Scheme B2 fixed 8324 vocab, d512 L6)
- ``no_inst`` = train/train_no_inst.py (Scheme B3 + BPM/KEY controls)
- ``paper``   = Table-5 recipe on the large2 geometry

Checkpoints: every-N-steps ``latest`` overwrite, wall-clock hours,
per-epoch ``epN`` and ``final``; ``resume_from`` restores the params, the
optimizer state and the step. On a mesh (``mesh``, ``tp``, ``fsdp``: one
process a rank, see ``parallel/mesh.py``) every rank runs this function on
the same data; rank 0 alone logs and writes the checkpoints, which hold
the whole trees (assembled from the ranks' blocks), and a resume
re-shards a checkpoint onto any mesh. The initial params are JAX's for the same
seed (``models/gpt.py::init_params`` from a threefry key); vocabularies of
V >= 4096 train with the time-chunked CE of 73 positions, as in JAX.
Scheme B2/B3 CSVs are encoded by the Python encoder, which the JAX package
itself falls back to when its native parser is not built.
"""

from __future__ import annotations

import dataclasses
import json
import os

import numpy as np

from ..models.gpt import init_params, preset as model_preset
from ..tokenizer import SchemeB1, SchemeB2, SchemeB3, Vocab
from ..utils import prng
from ..utils.checkpoint import (CheckpointCadence, load_checkpoint,
                                save_checkpoint)
from ..utils.device import resolve_device
from .data import batches, iter_csv_tokens, packed_batches, synthetic_corpus
from .prefetch import PrefetchIterator
from .trainer import TrainConfig, Trainer, reference_preset

PRESET_SCHEME = {"mini": "a", "large": "b1", "large2": "b2",
                 "no_inst": "b3", "paper": "b2"}


def encode_corpus_csv(csv_path: str, scheme: str, seq_len: int,
                      max_rows: int | None = None):
    """CSV -> (encoded id rows as int32 arrays, Vocab) without holding the
    raw JSON strings. Data-dependent vocabularies (a/b1) stream the CSV
    twice: pass 1 builds the vocabulary, pass 2 encodes."""
    if scheme in ("b2", "b3"):
        sch = (SchemeB3 if scheme == "b3" else SchemeB2)(seq_len=seq_len)
        return ([np.asarray(sch.explode(js), np.int32)
                 for js in iter_csv_tokens(csv_path, max_rows=max_rows)],
                sch.vocab)
    if scheme == "a":
        vocab = Vocab.from_sequences(
            (json.loads(js)
             for js in iter_csv_tokens(csv_path, max_rows=max_rows)),
            pad_last=True)
        encoded = [np.asarray(vocab.encode(json.loads(js)[:seq_len]),
                              np.int32)
                   for js in iter_csv_tokens(csv_path, max_rows=max_rows)]
        return encoded, vocab
    if scheme == "b1":
        b1 = SchemeB1(seq_len=seq_len)
        vocab = Vocab.from_sequences(
            (b1.explode(js)
             for js in iter_csv_tokens(csv_path, max_rows=max_rows)),
            pad_last=False)
        encoded = [np.asarray(vocab.encode(b1.explode(js)), np.int32)
                   for js in iter_csv_tokens(csv_path, max_rows=max_rows)]
        return encoded, vocab
    raise ValueError(f"unknown scheme {scheme!r}")


def encode_corpus(rows: list[str], scheme: str, seq_len: int):
    """JSON token rows -> (encoded id lists, Vocab)."""
    if scheme == "a":
        seqs = [json.loads(js) for js in rows]
        vocab = Vocab.from_sequences(seqs, pad_last=True)  # mini dialect
        encoded = [vocab.encode(s[:seq_len]) for s in seqs]
    elif scheme == "b1":
        b1 = SchemeB1(seq_len=seq_len)
        exploded = [b1.explode(js) for js in rows]
        vocab = Vocab.from_sequences(exploded, pad_last=False)
        encoded = [vocab.encode(s) for s in exploded]
    elif scheme == "b2":
        b2 = SchemeB2(seq_len=seq_len)
        vocab = b2.vocab
        encoded = [b2.explode(js) for js in rows]
    elif scheme == "b3":
        b3 = SchemeB3(seq_len=seq_len)
        vocab = b3.vocab
        encoded = [b3.explode(js) for js in rows]
    else:
        raise ValueError(f"unknown scheme {scheme!r}")
    return encoded, vocab


def run_training(preset: str, csv_path: str | None = None,
                 synthetic_rows: int | None = None,
                 max_rows: int | None = None, out_dir: str = "ckpt_out",
                 scheme: str | None = None, epochs: int | None = None,
                 save_every_steps: int = 500,
                 save_hours: float | None = None,
                 seed: int = 0, log_every: int = 0, log_fn=print,
                 resume_from: str | None = None,
                 corrected: bool = False,
                 geometry: dict | None = None,
                 pack: bool = False, device=None, mesh=None,
                 tp: bool = False, fsdp: bool = False) -> dict:
    """Train ``preset`` on a corpus CSV or ``synthetic_rows`` synthetic
    songs -> {"steps", "final_loss", "vocab_size", "out_dir"}.
    ``geometry``: overrides of the preset's model shape (d_model, n_head,
    n_layer, seq_len, attn_block, and an MoE FFN's n_experts and
    moe_every; the MoE aux loss keeps the monolithic head, as in JAX). ``pack``: several whole songs a row
    (implies the corrected causal architecture). ``device`` None means the
    card. ``mesh``: a (data, model) ``DeviceMesh``, with ``tp`` (Megatron
    over the model axis) and ``fsdp`` (params and moments split over the
    data axis), as JAX's ``run_training`` takes them."""
    from ..parallel.multihost import is_main_process

    main = is_main_process()
    device = resolve_device(device)
    scheme = scheme or PRESET_SCHEME[preset]
    tcfg = reference_preset(preset)
    if epochs is not None:
        tcfg = dataclasses.replace(tcfg, epochs=epochs)

    rows = None if csv_path else synthetic_corpus(synthetic_rows or 256,
                                                  seed=seed)
    geometry = {k: v for k, v in (geometry or {}).items() if v}
    model_name = preset if preset != "paper" else "large2"
    seq_len = geometry.get("seq_len",
                           model_preset(model_name, vocab_size=1).seq_len)
    if csv_path:
        encoded, vocab = encode_corpus_csv(csv_path, scheme, seq_len,
                                           max_rows=max_rows)
    else:
        encoded, vocab = encode_corpus(rows, scheme, seq_len)
    cfg = model_preset(model_name, vocab_size=len(vocab))
    if geometry:
        if "seq_len" in geometry and cfg.pos_rows is not None:
            # presets with an explicit pos table tie it to seq_len
            geometry["pos_rows"] = geometry["seq_len"]
        cfg = dataclasses.replace(cfg, **geometry)
    if corrected or pack:
        # the corrected architecture: causal attention, no reference quirks
        cfg = dataclasses.replace(cfg, causal=True, batch_first_bug=False,
                                  pos_broadcast_bug=False)
    loss_chunk = 73 if cfg.vocab_size >= 4096 and not cfg.n_experts \
        else None
    tcfg = dataclasses.replace(tcfg, pad_id=vocab.pad_id, pack=pack,
                               loss_chunk=loss_chunk, tp=tp, fsdp=fsdp)

    if resume_from:
        # optimizer state and step count restored with the params
        ckpt = load_checkpoint(resume_from)
        if ckpt["cfg"] != cfg:
            raise ValueError(f"checkpoint config {ckpt['cfg']} != run "
                             f"config {cfg}")
        trainer = Trainer(cfg, tcfg, ckpt["params"], device=device,
                          mesh=mesh)
        if ckpt["opt_state"] is not None:
            trainer.load_opt_state(ckpt["opt_state"])
        trainer.step = ckpt["step"]
    else:
        params = init_params(prng.PRNGKey(seed), cfg, device=device)
        trainer = Trainer(cfg, tcfg, params, device=device, mesh=mesh)
    cadence = CheckpointCadence(every_steps=save_every_steps,
                                every_hours=save_hours)
    if main:
        os.makedirs(out_dir, exist_ok=True)

    def save(tag):
        # on a mesh every rank takes part in assembling the trees
        params, opt_state = trainer.checkpoint_trees()
        if main:
            save_checkpoint(os.path.join(out_dir, tag), params,
                            vocab.tok2id, cfg, opt_state=opt_state,
                            step=trainer.step, tcfg=tcfg,
                            extra={"preset": preset, "scheme": scheme})

    def due(step) -> bool:
        hit = cadence.should_save(step)
        if mesh is not None and save_hours:
            # rank 0's clock decides for every rank
            from ..parallel.multihost import broadcast_bytes

            hit = broadcast_bytes(b"1" if hit else b"0", 1) == b"1"
        return hit

    last_m = None
    for epoch in range(tcfg.epochs):
        if pack:
            epoch_batches = packed_batches(
                encoded, cfg.seq_len, vocab.pad_id, tcfg.micro_batch,
                tcfg.accum_steps, drop_last=False,
                shuffle_seed=seed + epoch)
        else:
            epoch_batches = ((x, y, None) for x, y in batches(
                encoded, cfg.seq_len, vocab.pad_id, tcfg.micro_batch,
                tcfg.accum_steps,
                drop_last=False,  # small corpora must still train
                shuffle_seed=seed + epoch))
        for x, y, seg in PrefetchIterator(epoch_batches, depth=2,
                                          device=device):
            # metrics stay on the device except where a number is logged
            last_m = trainer.train_step(x, y, seg=seg, sync=False)
            if main and log_every and trainer.step % log_every == 0:
                norm = (f" grad_norm={float(last_m['grad_norm']):.4f}"
                        if "grad_norm" in last_m else "")
                log_fn(f"[{preset}] epoch {epoch + 1}/{tcfg.epochs} "
                       f"step {trainer.step}: "
                       f"loss={float(last_m['loss']):.4f}{norm}")
            if due(trainer.step):
                save("latest")
        save(f"ep{epoch + 1}")
    save("final")
    last_loss = float(last_m["loss"]) if last_m is not None else float("nan")
    return {"steps": trainer.step, "final_loss": last_loss,
            "vocab_size": len(vocab), "out_dir": out_dir}
