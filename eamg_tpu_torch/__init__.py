"""EAMG on PyTorch and CUDA: the port of ``eamg_tpu`` to an NVIDIA H100.

The JAX package ``eamg_tpu`` is the reference; this package keeps its
module names so each counterpart is easy to find, and imports nothing of
it (nor JAX). Device work runs on ``cuda`` unless the caller passes
``device="cpu"``; on the CPU every hand-written kernel is replaced by its
plain PyTorch version (``eamg_tpu_torch/ops``).
"""
