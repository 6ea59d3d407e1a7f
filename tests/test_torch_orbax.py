"""Orbax checkpoints in the port, without orbax, against the JAX package
on the CPU: ``utils/zstd.py``, ``utils/ocdbt.py``, ``utils/orbax_io.py``.

This process makes zstd frames with the ``zstandard`` module and Orbax
trees with JAX's ``utils/orbax_io.py`` (orbax 0.11, OCDBT and zarr v2);
the port's side runs in one subprocess (tests/torch_port_worker.py, task
``orbax``). Checked:

- the port's decoder (C++, ``csrc/zstd_host.cpp``) gives ``zstandard``'s
  input back, bit for bit: levels 1, 3 and 19, frames with and without a
  content size, f32 and bf16 weights, runs, repeats, text, empty input,
  frames over 128 KiB (several blocks); ``zstandard`` reads the port's
  raw frames;
- JAX-written trees (f32 and bf16, the optax state of ``TrainConfig(
  clip_norm=1.0)`` with its moments perturbed, step and extra) load in the
  port bit-equal, by ``load_checkpoint_orbax`` and by
  ``utils/checkpoint.py::load_checkpoint`` (which now reads ``meta.json``
  first); cfg, step, vocab and extra equal;
- the port writes the same trees; JAX's ``load_checkpoint_orbax`` and
  ``load_any_checkpoint`` restore them bit-equal, and JAX's
  ``coerce_opt_state`` rebuilds the optax state from them;
- a tree orbax wrote from arrays sharded over the 8 virtual devices
  (a zarr chunk a shard) loads in the port bit-equal;
- the port's ``pipeline_from_checkpoint`` on an Orbax copy of a tiny
  Scheme-A checkpoint gives the pickle directory's MIDI for the same seed.

The file takes about 35 s.
"""

from __future__ import annotations

import json

import numpy as np
import pytest
import zstandard

import jax
import jax.numpy as jnp

from eamg_tpu.models import GPTConfig, init_params
from eamg_tpu.tokenizer import Vocab
from eamg_tpu.train.trainer import TrainConfig, make_optimizer
from eamg_tpu.utils import save_checkpoint
from eamg_tpu.utils.orbax_io import (coerce_opt_state, load_any_checkpoint,
                                     load_checkpoint_orbax,
                                     save_checkpoint_orbax)

from port_harness import run_worker

LEVELS = (1, 3, 19)
TREES = {"f32": "float32", "bf16": "bfloat16"}
CFG = dict(vocab_size=96, seq_len=32, d_model=32, n_head=4, n_layer=2,
           pos_rows=32, causal=True, n_kv_heads=2)
TCFG = TrainConfig(clip_norm=1.0)


def _data(rng) -> dict:
    w = rng.standard_normal(40_000).astype(np.float32)
    return {
        "empty": b"",
        "f32": w[:6000].tobytes(),
        "bf16": (w.view(np.uint32) >> 16).astype(np.uint16).tobytes(),
        "runs": np.repeat(rng.integers(0, 4, 4000),
                          rng.integers(1, 40, 4000)).astype(np.uint8)
        .tobytes(),
        "repeats": (rng.integers(0, 256, 700, dtype=np.uint8).tobytes()
                    * 40),
        "text": " ".join(str(v) for v in rng.integers(0, 999, 30_000))
        .encode(),
        "big_f16": w.astype(np.float16).tobytes() * 4,   # 320 KB
    }


def _frames(data: dict) -> dict:
    """name -> a frame: each input at each level, with its content size
    (one-shot) and without (streamed)."""
    out = {}
    for level in LEVELS:
        c = zstandard.ZstdCompressor(level=level)
        for name, d in data.items():
            out[f"{name}/{level}/sized"] = c.compress(d)
            obj = c.compressobj()
            out[f"{name}/{level}/streamed"] = obj.compress(d) + obj.flush()
    return out


def _tree(dtype: str, key: int):
    cfg = GPTConfig(**CFG, dtype=dtype)
    params = jax.tree.map(lambda a: a.astype(dtype),
                          init_params(jax.random.PRNGKey(key), cfg))
    opt = make_optimizer(TCFG).init(params)
    keys = iter(jax.random.split(jax.random.PRNGKey(key + 10), 200))
    opt = jax.tree.map(
        lambda a: (a + 0.01 * jax.random.normal(next(keys), a.shape)
                   ).astype(a.dtype) if jnp.issubdtype(a.dtype, jnp.floating)
        else a + 5, opt)
    return cfg, params, opt


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    root = tmp_path_factory.mktemp("orbax")
    rng = np.random.default_rng(20)
    data = _data(rng)
    frames = _frames(data)
    inp = {"zstd/frames": np.asarray(json.dumps(list(frames))),
           "zstd/raw": np.asarray(json.dumps(list(data))),
           "orbax/root": np.asarray(str(root)),
           "orbax/trees": np.asarray(json.dumps(list(TREES)))}
    for name, f in frames.items():
        inp[f"zstd/frame/{name}"] = np.frombuffer(f, np.uint8)
    for name, d in data.items():
        inp[f"zstd/data/{name}"] = np.frombuffer(d, np.uint8)
    vocab = {f"t{i}": i for i in range(CFG["vocab_size"])}
    ref = {"data": data, "frames": frames, "trees": {}}
    for i, (tag, dtype) in enumerate(TREES.items()):
        cfg, params, opt = _tree(dtype, i)
        save_checkpoint_orbax(str(root / tag), params, vocab, cfg,
                              opt_state=opt, step=40 + i,
                              extra={"run": tag, "epoch": 3})
        ref["trees"][tag] = (cfg, params, opt)
    # a tiny Scheme-A checkpoint (tests/test_checkpoint_serving.py) as a
    # pickle directory and as its Orbax copy
    va = Vocab({"[PAD]": 0, "[START_SEQUENCE]": 1, "[END_SEQUENCE]": 2,
                "[BPM] 120.0": 3, "[KEY_SIGNATURE] C major": 4,
                "[INSTRUMENT] Violin": 5,
                "[NOTE] [PITCH:C4] [START:0.0] [END:0.5] "
                "[DURATION:0.5]": 6})
    cfg_a = GPTConfig(vocab_size=len(va), seq_len=32, d_model=32, n_head=4,
                      n_layer=1, pos_rows=32, causal=True)
    params_a = init_params(jax.random.PRNGKey(1), cfg_a)
    save_checkpoint(str(root / "a_pickle"), params_a, va.tok2id, cfg_a)
    save_checkpoint_orbax(str(root / "a_orbax"), params_a, va.tok2id, cfg_a)
    ref["vocab"] = vocab
    ref["sharded"] = _sharded_tree(str(root / "sharded"))
    got = run_worker("orbax", inp, root, timeout=600)
    ref["root"] = root
    return got, ref


def _sharded_tree(path: str) -> dict:
    """Arrays sharded over a (4 data x 2 model) mesh of the virtual
    devices, as a mesh trainer holds them, saved by orbax itself: a chunk a
    shard. -> their values."""
    import orbax.checkpoint as ocp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from eamg_tpu.parallel import make_mesh

    mesh = make_mesh(data=4, model=2)
    rng = np.random.default_rng(5)
    want = {"w": rng.standard_normal((12, 10)).astype(np.float32),
            "b": rng.standard_normal((16,)).astype(jnp.bfloat16),
            "n": {"i": np.arange(24, dtype=np.int32).reshape(8, 3)}}
    specs = {"w": P("data", "model"), "b": P("data"),
             "n": {"i": P("data", None)}}
    tree = jax.tree.map(lambda a, s: jax.device_put(
        a, NamedSharding(mesh, s)), want, specs)
    with ocp.PyTreeCheckpointer() as ckptr:
        ckptr.save(path, tree, force=True)
    return want


def _bits(a) -> np.ndarray:
    a = np.asarray(a)
    return a.view(np.uint16) if a.dtype == jnp.bfloat16 else a


def _named(tree, prefix: str) -> dict:
    out = {}
    for path, leaf in jax.tree_util.tree_leaves_with_path(tree):
        parts = [str(getattr(p, "key", getattr(p, "idx", p))) for p in path]
        out[f"{prefix}/" + "/".join(parts)] = _bits(leaf)
    return out


@pytest.mark.parametrize("level", LEVELS)
def test_zstd_decoder_equals_zstandard(results, level):
    got, ref = results
    n = 0
    for name, frame in ref["frames"].items():
        if f"/{level}/" not in name:
            continue
        want = ref["data"][name.split("/")[0]]
        assert zstandard.ZstdDecompressor().decompressobj().decompress(
            frame) == want
        assert got[f"zstd/native/{name}"].tobytes() == want, name
        n += 1
    assert n == 2 * len(ref["data"])


def test_frames_over_one_block_are_read(results):
    got, ref = results
    big = ref["data"]["big_f16"]
    assert len(big) > 2 * (128 << 10)
    for level in LEVELS:
        assert got[f"zstd/native/big_f16/{level}/streamed"].tobytes() == big


def test_raw_frames_read_by_zstandard(results):
    got, ref = results
    for name, data in ref["data"].items():
        frame = got[f"zstd/raw/{name}"].tobytes()
        assert zstandard.ZstdDecompressor().decompress(frame) == data
        assert zstandard.ZstdDecompressor().decompressobj().decompress(
            frame) == data


@pytest.mark.parametrize("tag", list(TREES))
@pytest.mark.parametrize("via", ["params", "via_load_checkpoint"])
def test_jax_written_params_load_bit_equal(results, tag, via):
    got, ref = results
    _, params, _ = ref["trees"][tag]
    want = _named(params, f"{tag}/{via}")
    assert want
    for name, a in want.items():
        np.testing.assert_array_equal(got[name], a)
        assert got[name].dtype == a.dtype


@pytest.mark.parametrize("tag", list(TREES))
def test_jax_written_opt_state_loads_bit_equal(results, tag):
    got, ref = results
    _, _, opt = ref["trees"][tag]
    adam = opt[1][0]                       # (clip's EmptyState, adamw chain)
    assert int(got[f"{tag}/count"]) == int(adam.count)
    for part in ("mu", "nu"):
        for name, a in _named(getattr(adam, part), f"{tag}/{part}").items():
            np.testing.assert_array_equal(got[name], a)


@pytest.mark.parametrize("tag", list(TREES))
def test_jax_written_meta_loads(results, tag):
    got, ref = results
    cfg, _, _ = ref["trees"][tag]
    meta = json.loads(str(got[f"{tag}/meta"]))
    assert meta["step"] == 40 + list(TREES).index(tag)
    assert meta["extra"] == {"run": tag, "epoch": 3}
    assert meta["vocab"] == ref["vocab"]
    assert (meta["d_model"], meta["dtype"], meta["n_kv_heads"]) == \
        (cfg.d_model, cfg.dtype, cfg.n_kv_heads)


@pytest.mark.parametrize("tag", list(TREES))
@pytest.mark.parametrize("loader", ["orbax", "any"])
def test_port_written_tree_loads_in_jax(results, tag, loader):
    _, ref = results
    cfg, params, opt = ref["trees"][tag]
    path = str(ref["root"] / f"port_{tag}")
    ck = (load_checkpoint_orbax if loader == "orbax"
          else load_any_checkpoint)(path)
    assert ck["step"] == 41 + list(TREES).index(tag)
    assert ck["extra"] == {"by": "port", "run": tag, "epoch": 3}
    assert ck["cfg"] == cfg and ck["vocab"] == ref["vocab"]
    a, b = _named(ck["params"], "p"), _named(params, "p")
    assert a.keys() == b.keys()
    for name in b:
        assert a[name].dtype == b[name].dtype
        np.testing.assert_array_equal(a[name], b[name])
    rebuilt = coerce_opt_state(ck["opt_state"],
                               make_optimizer(TCFG).init(ck["params"]))
    assert jax.tree.structure(rebuilt) == jax.tree.structure(opt)
    for x, y in zip(jax.tree.leaves(rebuilt), jax.tree.leaves(opt)):
        assert np.asarray(x).shape == np.asarray(y).shape
        np.testing.assert_array_equal(_bits(x), _bits(y))


def test_tree_of_sharded_arrays_loads_bit_equal(results):
    got, ref = results
    for name, a in _named(ref["sharded"], "sharded").items():
        assert got[name].dtype == a.dtype and got[name].shape == a.shape
        np.testing.assert_array_equal(got[name], a)
    assert int(got["sharded/chunks/w"]) == 8      # 4 x 2 shards of 3 x 5


def test_pipeline_serves_an_orbax_directory(results):
    got, _ = results
    midi = got["serve/orbax/midi"].tobytes()
    assert midi[:4] == b"MThd"
    assert midi == got["serve/pickle/midi"].tobytes()
    assert got["serve/orbax/tokens"].tolist() == \
        got["serve/pickle/tokens"].tolist()
