"""Training: the host data pipeline and synthetic corpora
(``train/data.py``), the trainer (``train/trainer.py``: the losses,
optax's AdamW arithmetic, gradient accumulation, ``Trainer``), the
background prefetch (``train/prefetch.py``) and the reference runs
(``train/run.py``), on one device or on a mesh of ranks
(``parallel/mesh.py``)."""
