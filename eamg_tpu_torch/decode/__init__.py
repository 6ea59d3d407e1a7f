"""KV-cache decoding: sampling, the solo decode loop and ``Generator``, and
the ragged batched decode (``decode/ragged.py``)."""

from .api import Generator

__all__ = ["Generator"]
