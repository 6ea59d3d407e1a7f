"""The parallel layers of the port: the mixture-of-experts FFN on one
device (``moe.py``)."""
