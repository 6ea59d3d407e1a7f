"""Command line of the port: ``python -m eamg_tpu_torch.cli serve``.

Serves ``POST /generate`` on a Scheme-A checkpoint of the JAX package's
format (default: the shipped flagship ``eamg_tpu/serve/demo_ckpt_a``) on
the CUDA device, or on the host with ``--device cpu``. ``--coalesce``
routes requests through the continuous-batching engine (or, with
``--coalesce window``, the 10 ms window batcher), with the JAX server's
engine options ``--slots``, ``--chunk``, ``--max-queue``,
``--fast-routing`` and ``--engine-top-p``. The JAX CLI's other
subcommands, and the engine modes for medusa, n-gram bans and grammar, are
not in the port yet.
"""

from __future__ import annotations

import argparse
import signal
import sys
import threading

# engine modes of the JAX server that the port's engine does not carry yet
_ENGINE_NOT_YET = ("engine_medusa", "engine_ngram", "engine_grammar")


def coalesce_opts_from_args(args) -> dict:
    """The batcher's options from the serve flags, as the JAX server maps
    them."""
    opts = {}
    if args.coalesce == "continuous":
        if args.slots is not None:
            opts["slots"] = args.slots
        if args.chunk is not None:
            opts["chunk"] = args.chunk
        if args.engine_top_p == "row":
            opts["per_row_sampling"] = True
        elif args.engine_top_p is not None:
            opts["top_p"] = float(args.engine_top_p)
    elif args.coalesce and args.slots is not None:
        opts["max_batch"] = args.slots
    if args.coalesce and args.max_queue is not None:
        opts["max_queue"] = args.max_queue
    return opts


def pipeline_from_args(args):
    """The serving pipeline that ``serve`` with these flags runs."""
    from .serve import pipeline_from_checkpoint
    from .serve.pipeline import DEMO_CKPT_A

    return pipeline_from_checkpoint(
        args.checkpoint or DEMO_CKPT_A, full_gm=args.full_gm,
        device=args.device, coalesce=args.coalesce,
        coalesce_opts=coalesce_opts_from_args(args),
        fast_routing=args.fast_routing)


def _serve(args) -> int:
    from .serve import make_server, shutdown_gracefully

    for name in _ENGINE_NOT_YET:
        if getattr(args, name):
            print(f"--{name.replace('_', '-')} is not yet in the PyTorch "
                  "port", file=sys.stderr)
            return 2
    pipeline = pipeline_from_args(args)
    print(f"warming up on {pipeline.device} (building the kernels)...",
          flush=True)
    pipeline.warmup()
    server = make_server(pipeline, args.host, args.port, quiet=False)
    print(f"EAMG (PyTorch) serving on http://{args.host}:{args.port}",
          flush=True)

    def _stop(signum, frame):
        print(f"signal {signum}: draining (send again to force-quit)...",
              flush=True)
        signal.signal(signum, signal.SIG_DFL)
        threading.Thread(target=server.shutdown, daemon=True).start()

    signal.signal(signal.SIGTERM, _stop)
    signal.signal(signal.SIGINT, _stop)
    try:
        server.serve_forever()
    finally:
        shutdown_gracefully(server, pipeline)
    return 0


def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(prog="eamg_tpu_torch.cli")
    sub = parser.add_subparsers(dest="cmd", required=True)
    s = sub.add_parser("serve", help="serve POST /generate")
    s.add_argument("--host", default="0.0.0.0")
    s.add_argument("--port", type=int, default=8000)
    s.add_argument("--checkpoint", default=None,
                   help="checkpoint dir (default: eamg_tpu/serve/"
                        "demo_ckpt_a)")
    s.add_argument("--device", default=None,
                   help="torch device (default cuda; 'cpu' runs the plain "
                        "versions of the kernels)")
    s.add_argument("--full-gm", action="store_true",
                   help="map all instrument families, not just the "
                        "reference's three")
    s.add_argument("--coalesce", nargs="?", const="continuous",
                   default=False, choices=["window", "continuous"],
                   help="batch concurrent requests into one ragged decode "
                        "(requires a causal model). '--coalesce' / "
                        "'--coalesce continuous' = persistent engine, "
                        "requests join a RUNNING decode; '--coalesce "
                        "window' = 10 ms grouping window")
    s.add_argument("--slots", type=int, default=None,
                   help="continuous engine: concurrent request rows "
                        "(default 8); window mode: max batch size")
    s.add_argument("--chunk", type=int, default=None,
                   help="continuous engine: decode steps between "
                        "admission/harvest boundaries (default 128; "
                        "smaller = faster join, larger = fewer harvests)")
    s.add_argument("--max-queue", type=int, default=None,
                   help="admission-queue bound before requests are shed "
                        "with 503 (default 256; 0 = unbounded)")
    s.add_argument("--fast-routing", action="store_true",
                   help="a lone request on an idle engine decodes through "
                        "the batch-1 ragged decode instead of the engine's "
                        "own shape: fewer rows per step, but same-seed "
                        "bytes may then differ by load on the card")
    s.add_argument("--engine-top-p", default=None,
                   help="continuous engine nucleus mode: a float fixes the "
                        "mass for the shared decode (mismatching requests "
                        "decode solo); 'row' filters top-p AND min-p per "
                        "row, so every request's values ride the engine")
    s.add_argument("--engine-medusa", action="store_true",
                   help="not yet in the port")
    s.add_argument("--engine-ngram", type=int, default=0,
                   help="not yet in the port")
    s.add_argument("--engine-grammar", action="store_true",
                   help="not yet in the port")
    return parser.parse_args(argv)


def main(argv=None) -> int:
    return _serve(parse_args(argv))


if __name__ == "__main__":
    sys.exit(main())
