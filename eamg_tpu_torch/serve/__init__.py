"""Serving: the request pipeline, the batchers and the HTTP server."""

from .pipeline import (Pipeline, demo_pipeline, demo_pipeline_b3,
                       packaged_demo_checkpoint, packaged_demo_checkpoints,
                       pipeline_from_checkpoint)
from .server import (make_server, serve_forever_in_thread,
                     shutdown_gracefully)

__all__ = ["Pipeline", "demo_pipeline", "demo_pipeline_b3", "make_server",
           "packaged_demo_checkpoint", "packaged_demo_checkpoints",
           "pipeline_from_checkpoint", "serve_forever_in_thread",
           "shutdown_gracefully"]
