"""Decode attention's share of its roofline: ``work.py``'s least bytes of
the traced segment's decode steps (each live row's K and V at its
positions, its query and its output, in every layer) at 3.35 TB/s, over
the device time of the kernels named here, in %. K3 (``ops/
decode_attention.py``) and the engine's row 8 (``ops/decode_fold.py``)
both run these kernels of ``csrc/decode_kernels.cuh``."""

from perfbench import work

KERNELS = ("decode_heads_kernel", "decode_cluster_kernel")


def read(cell, window, traced, trace):
    seconds, count = trace.device_seconds(KERNELS)
    if not count or not traced.get("decode_attn_bytes"):
        return None
    return 100.0 * traced["decode_attn_bytes"] / work.PEAK_BYTES_PER_S \
        / seconds
