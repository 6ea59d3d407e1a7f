"""Training: the host data pipeline and synthetic corpora
(``train/data.py``), the trainer (``train/trainer.py``: the losses,
optax's AdamW arithmetic, gradient accumulation, ``Trainer``), the
background prefetch (``train/prefetch.py``) and the reference runs
(``train/run.py``). The mesh modes and MoE training are not in the port
yet."""
