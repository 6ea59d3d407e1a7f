"""Serving: the request pipeline, the batchers and the HTTP server."""

from .pipeline import Pipeline, pipeline_from_checkpoint
from .server import (make_server, serve_forever_in_thread,
                     shutdown_gracefully)

__all__ = ["Pipeline", "make_server", "pipeline_from_checkpoint",
           "serve_forever_in_thread", "shutdown_gracefully"]
