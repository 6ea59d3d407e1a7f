"""The PyTorch side of tests/test_torch_orbax.py, run by
tests/torch_port_worker.py in its subprocess (torch never enters the
pytest process): the port's zstd decoders on the frames the test made with
``zstandard``, its raw frames back, the JAX-written Orbax trees restored,
the same trees written by the port, and a pipeline served from an Orbax
directory."""

from __future__ import annotations

import json
import os

import numpy as np

from torch_port_worker import CPU


def _leaves(tree, prefix: str, out: dict) -> None:
    """A loaded tree's leaves as numpy, bf16 as its uint16 bits."""
    import torch

    from eamg_tpu_torch.utils.orbax_io import _walk

    for keys, leaf in _walk(tree):
        name = f"{prefix}/" + "/".join(keys)
        if isinstance(leaf, torch.Tensor) and leaf.dtype == torch.bfloat16:
            out[name] = leaf.view(torch.int16).numpy().view(np.uint16)
        else:
            out[name] = np.asarray(leaf)


def _zstd_checks(inp, out) -> None:
    from eamg_tpu_torch.utils import zstd

    for name in json.loads(str(inp["zstd/frames"])):
        frame = inp[f"zstd/frame/{name}"].tobytes()
        out[f"zstd/native/{name}"] = np.frombuffer(zstd.decompress(frame),
                                                   np.uint8)
    for name in json.loads(str(inp["zstd/raw"])):
        data = inp[f"zstd/data/{name}"].tobytes()
        out[f"zstd/raw/{name}"] = np.frombuffer(zstd.compress_raw(data),
                                                np.uint8)


def task_orbax(inp, out) -> None:
    """tests/test_torch_orbax.py."""
    from eamg_tpu_torch.serve import pipeline_from_checkpoint
    from eamg_tpu_torch.train.trainer import TrainConfig
    from eamg_tpu_torch.utils import orbax_io
    from eamg_tpu_torch.utils.checkpoint import load_checkpoint

    _zstd_checks(inp, out)
    root = str(inp["orbax/root"])
    for tag in json.loads(str(inp["orbax/trees"])):
        ck = orbax_io.load_checkpoint_orbax(os.path.join(root, tag))
        same = load_checkpoint(os.path.join(root, tag))
        _leaves(ck["params"], f"{tag}/params", out)
        _leaves(same["params"], f"{tag}/via_load_checkpoint", out)
        opt = ck["opt_state"]
        out[f"{tag}/count"] = np.asarray(opt["count"])
        _leaves(opt["mu"], f"{tag}/mu", out)
        _leaves(opt["nu"], f"{tag}/nu", out)
        out[f"{tag}/meta"] = np.asarray(json.dumps(
            {"step": ck["step"], "extra": ck["extra"], "vocab": ck["vocab"],
             "d_model": ck["cfg"].d_model, "dtype": ck["cfg"].dtype,
             "n_kv_heads": ck["cfg"].n_kv_heads}))
        orbax_io.save_checkpoint_orbax(
            os.path.join(root, f"port_{tag}"), ck["params"], ck["vocab"],
            ck["cfg"], opt_state=opt, step=ck["step"] + 1,
            extra={"by": "port", **ck["extra"]},
            tcfg=TrainConfig(clip_norm=1.0))
    sharded = os.path.join(root, "sharded")
    _leaves(orbax_io.load_tree(sharded), "sharded", out)
    from eamg_tpu_torch.utils import ocdbt

    store = ocdbt.Store(sharded)
    out["sharded/chunks/w"] = np.asarray(sum(
        1 for k in store.entries if k.startswith("w/") and
        not k.endswith(".zarray")))
    midi = {}
    for name in ("pickle", "orbax"):
        pipe = pipeline_from_checkpoint(os.path.join(root, f"a_{name}"),
                                        device=CPU)
        res = pipe.generate("so happy today", seed=1, render_audio=False)
        midi[name] = np.frombuffer(res.midi_bytes, np.uint8)
        out[f"serve/{name}/midi"] = midi[name]
        out[f"serve/{name}/tokens"] = np.asarray(res.tokens)


ORBAX_TASKS = {"orbax": task_orbax}
