"""Model export and publish.

Port of ``eamg_tpu/tools/publish.py`` (the reference's
Scripts/LoadFinalModel.py and Scripts/pushtoHF.py):

- :func:`export_emotion_hf`: an emotion checkpoint dir -> an HF-layout
  DistilBERT snapshot (config.json, pytorch_model.bin, vocab.txt), LoRA
  already merged, loadable by transformers; the tensors keep the
  checkpoint's dtypes;
- :func:`push_to_hub`: upload a folder to the Hub (needs the network and
  ``huggingface_hub``; raises ``RuntimeError`` without the package).
"""

from __future__ import annotations

import json
import os
import pickle
import shutil

# our param tree's names in a layer -> HF DistilBERT's module names
_LAYER_LINEARS = (("q", "attention.q_lin"), ("k", "attention.k_lin"),
                  ("v", "attention.v_lin"), ("out", "attention.out_lin"),
                  ("lin1", "ffn.lin1"), ("lin2", "ffn.lin2"))


def export_emotion_hf(ckpt_dir: str, out_dir: str,
                      id2label: dict | None = None) -> None:
    import numpy as np
    import torch

    from ..emotion.config import ID2LABEL

    with open(os.path.join(ckpt_dir, "config.pkl"), "rb") as f:
        cfg = pickle.load(f)
    with open(os.path.join(ckpt_dir, "params.pkl"), "rb") as f:
        params = pickle.load(f)

    id2label = id2label or ID2LABEL
    os.makedirs(out_dir, exist_ok=True)
    hf_cfg = {
        "architectures": ["DistilBertForSequenceClassification"],
        "model_type": "distilbert",
        "vocab_size": cfg["vocab_size"],
        "max_position_embeddings": cfg["max_position_embeddings"],
        "dim": cfg["dim"], "n_layers": cfg["n_layers"],
        "n_heads": cfg["n_heads"], "hidden_dim": cfg["hidden_dim"],
        "activation": "gelu", "dropout": 0.1, "attention_dropout": 0.1,
        "pad_token_id": 0,
        "id2label": {str(k): v for k, v in id2label.items()},
        "label2id": {v: k for k, v in id2label.items()},
    }
    with open(os.path.join(out_dir, "config.json"), "w") as f:
        json.dump(hf_cfg, f, indent=2)

    def t(x):
        return torch.tensor(np.asarray(x))

    sd = {
        "distilbert.embeddings.word_embeddings.weight": t(
            params["word_emb"]),
        "distilbert.embeddings.position_embeddings.weight": t(
            params["pos_emb"]),
        "distilbert.embeddings.LayerNorm.weight": t(params["emb_ln"]["g"]),
        "distilbert.embeddings.LayerNorm.bias": t(params["emb_ln"]["b"]),
        "pre_classifier.weight": t(params["pre_classifier"]["w"]),
        "pre_classifier.bias": t(params["pre_classifier"]["b"]),
        "classifier.weight": t(params["classifier"]["w"]),
        "classifier.bias": t(params["classifier"]["b"]),
    }
    for i, p in enumerate(params["layers"]):
        pre = f"distilbert.transformer.layer.{i}"
        for src, dst in _LAYER_LINEARS:
            sd[f"{pre}.{dst}.weight"] = t(p[src]["w"])
            sd[f"{pre}.{dst}.bias"] = t(p[src]["b"])
        sd[f"{pre}.sa_layer_norm.weight"] = t(p["sa_ln"]["g"])
        sd[f"{pre}.sa_layer_norm.bias"] = t(p["sa_ln"]["b"])
        sd[f"{pre}.output_layer_norm.weight"] = t(p["out_ln"]["g"])
        sd[f"{pre}.output_layer_norm.bias"] = t(p["out_ln"]["b"])
    torch.save(sd, os.path.join(out_dir, "pytorch_model.bin"))
    shutil.copy(os.path.join(ckpt_dir, "vocab.txt"),
                os.path.join(out_dir, "vocab.txt"))


def push_to_hub(folder: str, repo_id: str, token: str | None = None) -> None:
    """Upload a folder to the HF Hub (Scripts/pushtoHF.py:8-11). Gated:
    needs the network and huggingface_hub."""
    try:
        from huggingface_hub import HfApi
    except ImportError as exc:
        raise RuntimeError("huggingface_hub is not installed") from exc
    api = HfApi(token=token)
    api.upload_folder(folder_path=folder, repo_id=repo_id)
