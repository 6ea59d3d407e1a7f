"""Checkpoint converters: a reference ``.pt`` (trainer or kv dialect) ->
a checkpoint directory of the JAX package's format.

Port of ``eamg_tpu/tools/convert.py::convert_reference_pt``; the HF
DistilBERT converter belongs to the emotion-training slice.
"""

from __future__ import annotations

import os


def convert_reference_pt(pt_path: str, out_dir: str,
                         serving_arch: bool = False) -> None:
    from ..models.import_torch import load_reference_checkpoint
    from ..utils.checkpoint import save_checkpoint

    params, cfg, vocab = load_reference_checkpoint(
        pt_path, serving_arch=serving_arch)
    save_checkpoint(out_dir, params, vocab.tok2id, cfg,
                    extra={"source": os.path.basename(pt_path),
                           "serving_arch": serving_arch})
