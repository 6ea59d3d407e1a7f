"""Solo KV-cache decoding: sampling, the decode loop and ``Generator``."""

from .api import Generator

__all__ = ["Generator"]
