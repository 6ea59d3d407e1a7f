"""Offline tools of the port: the Medusa heads (``medusa.py``), the demo
trainer (``demo_a.py``), the §10.4 ablation (``ablation.py``,
``metrics.py``), the per-section metric (``section_metrics.py``), the
corpus tools (``corpus.py``, ``analysis.py``, ``native_loader.py``), the
feed-rate measure (``feed_bench.py``), the reference ``.pt`` converter
(``convert.py``) and the GQA conversion-and-recovery workflow
(``gqa_recover.py``)."""
