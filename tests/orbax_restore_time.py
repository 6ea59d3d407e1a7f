"""Time the port's Orbax restore on a flagship-size tree written by orbax.

    JAX_PLATFORMS=cpu PYTHONPATH=. python tests/orbax_restore_time.py \
        DIR

This process (JAX, orbax) writes demo_ckpt_a's params (bf16, d512 L6, V
8892) with the optax state of ``TrainConfig(clip_norm=1.0)`` on their f32
copies, its moments filled with seeded noise (so they compress as trained
moments do), through the JAX package's ``save_checkpoint_orbax`` into
``DIR/flagship``. A subprocess without JAX then restores it through the
port's ``utils/checkpoint.py::load_checkpoint`` with its C++ zstd decoder
and prints one JSON line: the tree's bytes on disk, the seconds of the
decoder's build and of the restore, the host's CPU and core count. A host measurement: no device is involved.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_RESTORE = r"""
import json, os, platform, sys, time
from eamg_tpu_torch.utils import zstd
from eamg_tpu_torch.utils.checkpoint import load_checkpoint
path = sys.argv[1]
t0 = time.perf_counter()
zstd._lib()
out = {"decoder_build_s": time.perf_counter() - t0}
t0 = time.perf_counter()
ck = load_checkpoint(path)
out["restore_s_native"] = time.perf_counter() - t0
out["leaves_dtype"] = str(ck["params"]["tok_emb"].dtype)
cpu = [l for l in open("/proc/cpuinfo") if l.startswith("model name")]
out["host"] = {"cpu": cpu[0].split(":", 1)[1].strip() if cpu else
               platform.processor(), "cores": os.cpu_count()}
print(json.dumps(out))
"""


def write_tree(path: str) -> None:
    import jax
    import jax.numpy as jnp

    from eamg_tpu.train.trainer import TrainConfig, make_optimizer
    from eamg_tpu.utils.checkpoint import load_checkpoint
    from eamg_tpu.utils.orbax_io import save_checkpoint_orbax

    ck = load_checkpoint(os.path.join(REPO, "eamg_tpu", "serve",
                                      "demo_ckpt_a"))
    params = ck["params"]
    opt = make_optimizer(TrainConfig(clip_norm=1.0)).init(
        jax.tree.map(lambda a: a.astype(jnp.float32), params))
    keys = iter(jax.random.split(jax.random.PRNGKey(1), 1000))
    opt = jax.tree.map(lambda a: 1e-3 * jax.random.normal(next(keys), a.shape)
                       if a.dtype == jnp.float32 else a, opt)
    save_checkpoint_orbax(path, params, ck["vocab"], ck["cfg"],
                          opt_state=opt, step=100)


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    path = os.path.join(os.path.abspath(argv[0]), "flagship")
    write_tree(path)
    size = sum(os.path.getsize(os.path.join(d, f))
               for d, _, fs in os.walk(path) for f in fs)
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("XLA_", "JAX_"))}
    env["PYTHONPATH"] = REPO
    res = subprocess.run([sys.executable, "-c", _RESTORE, path], cwd=REPO,
                         env=env, capture_output=True, text=True, check=True)
    out = json.loads(res.stdout.strip().splitlines()[-1])
    out["bytes_on_disk"] = size
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
