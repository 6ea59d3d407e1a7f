"""KV-cache decoding: sampling, the solo decode loop and ``Generator``, the
ragged batched decode (``decode/ragged.py``), the chunked stream
(``decode/stream.py``), the speculative decoders (``decode/speculative.py``:
prompt lookup and the verify loop; ``decode/medusa.py``) and beam search
(``decode/beam.py``), the grammar's FSM (``decode/grammar.py``), and
teacher-forced replay and perplexity (``decode/replay.py``)."""

from .api import Generator
from .grammar import Grammar, grammar_for
from .stream import stream_tokens

__all__ = ["Generator", "Grammar", "grammar_for", "stream_tokens"]
