"""Reference ``.pt`` checkpoints in and out: the state-dict dialects of the
reference's torch scripts.

Port of ``eamg_tpu/models/import_torch.py``, native to torch here: the
``.pt`` is read with ``torch.load(weights_only=True)`` and written with
``torch.save`` in this process (the JAX package does both in a subprocess,
since torch and XLA:CPU must not share one). The dialects:

- **trainer** (the reference's train_*.py and api.py): ``emb.weight, pos,
  tr.layers.N.self_attn.{in_proj_weight,in_proj_bias,out_proj.weight,
  out_proj.bias}, tr.layers.N.{linear1,linear2,norm1,norm2}.*,
  fc.{weight,bias}``;
- **kv** (api_cache.py's remap): ``tok_emb.weight, pos_emb,
  layers.N.attn.*, layers.N.{ln1,ln2}.*, layers.N.mlp.{0,2}.*,
  head.{weight,bias}``.

The parameter tree is in torch layout, so every tensor copies through
without a transpose. The payload is the reference's ``{"model":
state_dict, "vocab": tok2id[, "cfg"|"hparams"]}``.
"""

from __future__ import annotations

import re

import numpy as np
import torch

from ..tokenizer.vocab import Vocab
from .gpt import GPTConfig


def _f32(x) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().float().clone()
    return torch.from_numpy(np.asarray(x, np.float32).copy())


def remap_kv_dialect(sd: dict) -> dict:
    """kv dialect -> trainer dialect key names."""
    out = {}
    for k, v in sd.items():
        k2 = k.replace("tok_emb.weight", "emb.weight")
        k2 = k2.replace("pos_emb", "pos")
        k2 = k2.replace("head.", "fc.")
        k2 = re.sub(r"layers\.(\d+)\.attn", r"tr.layers.\1.self_attn", k2)
        k2 = re.sub(r"layers\.(\d+)\.ln1", r"tr.layers.\1.norm1", k2)
        k2 = re.sub(r"layers\.(\d+)\.ln2", r"tr.layers.\1.norm2", k2)
        k2 = re.sub(r"layers\.(\d+)\.mlp\.0", r"tr.layers.\1.linear1", k2)
        k2 = re.sub(r"layers\.(\d+)\.mlp\.2", r"tr.layers.\1.linear2", k2)
        out[k2] = v
    return out


def infer_geometry(sd: dict) -> dict:
    """The model's dimensions from a state dict (either dialect)."""
    if "tok_emb.weight" in sd:
        sd = remap_kv_dialect(sd)
    n_layer = max(int(k.split(".")[2]) for k in sd
                  if k.startswith("tr.layers.")) + 1
    vocab_size, d_model = tuple(sd["emb.weight"].shape)
    return dict(vocab_size=vocab_size, d_model=d_model, n_layer=n_layer,
                pos_rows=sd["pos"].shape[0],
                d_ff=sd["tr.layers.0.linear1.weight"].shape[0])


def import_state_dict(sd: dict, cfg: GPTConfig) -> dict:
    """A state dict (either dialect; tensors or arrays) -> the GPT
    parameter tree, f32 CPU tensors."""
    if "tok_emb.weight" in sd:
        sd = remap_kv_dialect(sd)

    def g(k):
        return _f32(sd[k])

    layers = []
    for i in range(cfg.n_layer):
        pre = f"tr.layers.{i}"
        layers.append({
            "attn": {"in_w": g(f"{pre}.self_attn.in_proj_weight"),
                     "in_b": g(f"{pre}.self_attn.in_proj_bias"),
                     "out_w": g(f"{pre}.self_attn.out_proj.weight"),
                     "out_b": g(f"{pre}.self_attn.out_proj.bias")},
            "ln1": {"g": g(f"{pre}.norm1.weight"),
                    "b": g(f"{pre}.norm1.bias")},
            "ln2": {"g": g(f"{pre}.norm2.weight"),
                    "b": g(f"{pre}.norm2.bias")},
            "mlp": {"w1": g(f"{pre}.linear1.weight"),
                    "b1": g(f"{pre}.linear1.bias"),
                    "w2": g(f"{pre}.linear2.weight"),
                    "b2": g(f"{pre}.linear2.bias")},
        })
    return {"tok_emb": g("emb.weight"), "pos": g("pos"), "layers": layers,
            "head": {"w": g("fc.weight"), "b": g("fc.bias")}}


def export_state_dict(params: dict, dialect: str = "trainer") -> dict:
    """The GPT parameter tree -> a state dict of CPU tensors in
    ``dialect``'s key names. Refuses (ValueError) what the reference
    architecture cannot hold: MoE layers, int8 ``{"q", "s"}`` weights and
    GQA (a fused in_proj that is not [3 D, D])."""
    if any("router" in p["mlp"] for p in params["layers"]):
        raise ValueError(
            "MoE layers have no torch state-dict dialect: the reference "
            "architecture is dense (export the dense layers only, or keep "
            "MoE checkpoints in the native directory format)")
    if any(isinstance(leaf, dict) for p in params["layers"]
           for grp in p.values() for leaf in grp.values()):
        raise ValueError(
            "quantized params ({'q','s'} leaves) have no torch state-dict "
            "dialect: dequantize first (the reference dialects are dense "
            "MHA float32)")
    for p in params["layers"]:
        if p["attn"]["in_w"].shape[0] != 3 * p["attn"]["in_w"].shape[1]:
            raise ValueError(
                "GQA checkpoints (n_kv_heads != n_head) have no torch "
                "state-dict dialect: the reference arch is dense MHA with a "
                "fused [3d, d] in_proj; convert back to MHA before "
                "exporting")

    def t(x):
        return x.detach().cpu() if isinstance(x, torch.Tensor) else \
            torch.from_numpy(np.ascontiguousarray(x))

    sd = {"emb.weight": t(params["tok_emb"]), "pos": t(params["pos"]),
          "fc.weight": t(params["head"]["w"]),
          "fc.bias": t(params["head"]["b"])}
    names = (("self_attn.in_proj_weight", "attn", "in_w"),
             ("self_attn.in_proj_bias", "attn", "in_b"),
             ("self_attn.out_proj.weight", "attn", "out_w"),
             ("self_attn.out_proj.bias", "attn", "out_b"),
             ("norm1.weight", "ln1", "g"), ("norm1.bias", "ln1", "b"),
             ("norm2.weight", "ln2", "g"), ("norm2.bias", "ln2", "b"),
             ("linear1.weight", "mlp", "w1"), ("linear1.bias", "mlp", "b1"),
             ("linear2.weight", "mlp", "w2"), ("linear2.bias", "mlp", "b2"))
    for i, p in enumerate(params["layers"]):
        for key, grp, leaf in names:
            sd[f"tr.layers.{i}.{key}"] = t(p[grp][leaf])
    if dialect != "kv":
        return sd
    remapped = {}
    for k, v in sd.items():
        k2 = k.replace("emb.weight", "tok_emb.weight")
        k2 = "pos_emb" if k == "pos" else k2
        k2 = k2.replace("fc.", "head.")
        k2 = re.sub(r"tr\.layers\.(\d+)\.self_attn", r"layers.\1.attn", k2)
        k2 = re.sub(r"tr\.layers\.(\d+)\.norm1", r"layers.\1.ln1", k2)
        k2 = re.sub(r"tr\.layers\.(\d+)\.norm2", r"layers.\1.ln2", k2)
        k2 = re.sub(r"tr\.layers\.(\d+)\.linear1", r"layers.\1.mlp.0", k2)
        k2 = re.sub(r"tr\.layers\.(\d+)\.linear2", r"layers.\1.mlp.2", k2)
        remapped[k2] = v
    return remapped


def load_reference_checkpoint(path, serving_arch: bool = False,
                              **cfg_overrides):
    """A reference ``.pt`` -> (params, cfg, Vocab). ``serving_arch`` builds
    api_cache.py's pre-LN / GELU serving config for the weights; otherwise
    the post-LN / ReLU arch they were trained with."""
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    sd = ckpt["model"]
    geom = infer_geometry(sd)
    meta = dict(ckpt.get("cfg") or {}) or dict(ckpt.get("hparams") or {})
    arch = dict(ln_placement="pre", activation="gelu") if serving_arch \
        else dict(ln_placement="post", activation="relu")
    cfg = GPTConfig(vocab_size=geom["vocab_size"],
                    seq_len=meta.get("seq_len", geom["pos_rows"] + 1),
                    d_model=geom["d_model"], n_head=meta.get("n_head", 8),
                    n_layer=geom["n_layer"], d_ff=geom["d_ff"],
                    pos_rows=geom["pos_rows"], **arch, **cfg_overrides)
    return import_state_dict(sd, cfg), cfg, Vocab(dict(ckpt["vocab"]))


def export_reference_checkpoint(path, params: dict, vocab_tok2id: dict,
                                cfg: GPTConfig,
                                dialect: str = "trainer") -> None:
    """Write a reference-format ``.pt`` that the reference's scripts load
    (``torch.load`` + a strict ``load_state_dict``): ``{"model":
    state_dict, "vocab": tok2id, "cfg": {the geometry}}``, floating
    tensors as float32 (the reference trains and serves f32)."""
    sd = {k: (v.float() if v.is_floating_point() else v).contiguous().clone()
          for k, v in export_state_dict(params, dialect=dialect).items()}
    torch.save({"model": sd, "vocab": dict(vocab_tok2id),
                "cfg": {"vocab_size": cfg.vocab_size, "seq_len": cfg.seq_len,
                        "d_model": cfg.d_model, "n_head": cfg.n_head,
                        "n_layer": cfg.n_layer,
                        "d_ff": cfg.d_ff or 4 * cfg.d_model}}, path)
