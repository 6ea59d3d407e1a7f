"""The GPT decoder and the DistilBERT emotion classifier; int8 weights
(``quant.py``), the MHA -> GQA converter (``gqa_convert.py``) and the
reference ``.pt`` dialects (``import_torch.py``)."""
