"""The parallel modes of the port, on ``torch.distributed`` (one process a
rank): ``multihost.py`` (process-group init, rank gating,
``broadcast_bytes``), ``mesh.py`` (the (data, model) mesh, JAX's sharding
specs, the blocks each rank stores), ``collectives.py`` (the collectives
that carry a gradient, the tensor-parallel context), ``pipeline.py``
(GPipe), ``ring_attention.py`` (sequence parallelism), ``moe.py`` (the
mixture-of-experts FFN and expert parallelism) and ``dryrun.py`` (every
mode on the flagship geometry). The modules import on demand: importing
this package imports none of them."""
