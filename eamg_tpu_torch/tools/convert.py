"""Checkpoint converters.

Port of ``eamg_tpu/tools/convert.py``:
- ``convert_reference_pt``: a reference ``.pt`` (trainer or kv dialect)
  -> a checkpoint directory of the JAX package's format;
- ``convert_hf_distilbert``: an HF DistilBERT (+PEFT LoRA) snapshot
  directory -> the emotion classifier's checkpoint directory
  (params.pkl of f32 numpy leaves, config.pkl, vocab.txt), offline.
  ``safetensors`` is imported only when a ``.safetensors`` file is there.
"""

from __future__ import annotations

import json
import os
import pickle
import shutil


def convert_reference_pt(pt_path: str, out_dir: str,
                         serving_arch: bool = False) -> None:
    from ..models.import_torch import load_reference_checkpoint
    from ..utils.checkpoint import save_checkpoint

    params, cfg, vocab = load_reference_checkpoint(
        pt_path, serving_arch=serving_arch)
    save_checkpoint(out_dir, params, vocab.tok2id, cfg,
                    extra={"source": os.path.basename(pt_path),
                           "serving_arch": serving_arch})


def convert_hf_distilbert(hf_dir: str, out_dir: str,
                          lora_alpha: float = 16.0) -> None:
    """HF snapshot dir (pytorch_model.bin / model.safetensors, config.json,
    vocab.txt, optional adapter_model weights) -> emotion ckpt dir."""
    import torch

    from ..models.distilbert import DistilBertConfig, import_hf_state_dict

    with open(os.path.join(hf_dir, "config.json")) as f:
        hf_cfg = json.load(f)
    cfg_kwargs = dict(
        vocab_size=hf_cfg.get("vocab_size", 30522),
        max_position_embeddings=hf_cfg.get("max_position_embeddings", 512),
        dim=hf_cfg.get("dim", 768),
        n_layers=hf_cfg.get("n_layers", 6),
        n_heads=hf_cfg.get("n_heads", 12),
        hidden_dim=hf_cfg.get("hidden_dim", 3072),
        num_labels=len(hf_cfg.get("id2label", {})) or 28,
    )
    cfg = DistilBertConfig(**cfg_kwargs)

    sd = {}
    for name in ("pytorch_model.bin", "adapter_model.bin"):
        p = os.path.join(hf_dir, name)
        if os.path.exists(p):
            sd.update(torch.load(p, map_location="cpu",
                                 weights_only=True))
    for name in ("model.safetensors", "adapter_model.safetensors"):
        p = os.path.join(hf_dir, name)
        if os.path.exists(p):
            from safetensors.torch import load_file

            sd.update(load_file(p))
    if not sd:
        raise FileNotFoundError(f"no model weights found in {hf_dir}")

    params = import_hf_state_dict(sd, cfg, lora_alpha=lora_alpha)
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "params.pkl"), "wb") as f:
        pickle.dump(params, f)
    with open(os.path.join(out_dir, "config.pkl"), "wb") as f:
        pickle.dump(cfg_kwargs, f)
    vocab_src = os.path.join(hf_dir, "vocab.txt")
    if os.path.exists(vocab_src):
        shutil.copy(vocab_src, os.path.join(out_dir, "vocab.txt"))
    else:
        raise FileNotFoundError("vocab.txt required for the WordPiece "
                                "tokenizer")
