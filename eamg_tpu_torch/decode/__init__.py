"""KV-cache decoding: sampling, the solo decode loop and ``Generator``, the
ragged batched decode (``decode/ragged.py``) and the chunked stream
(``decode/stream.py``)."""

from .api import Generator
from .stream import stream_tokens

__all__ = ["Generator", "stream_tokens"]
