"""Command line of the port: ``python -m eamg_tpu_torch.cli serve``.

Serves ``POST /generate`` on a Scheme-A checkpoint of the JAX package's
format (default: the shipped flagship ``eamg_tpu/serve/demo_ckpt_a``) on
the CUDA device, or on the host with ``--device cpu``. The JAX CLI's
other subcommands, and the serve options for coalescing and engine modes,
are not in the port yet.
"""

from __future__ import annotations

import argparse
import signal
import sys
import threading


def _serve(args) -> int:
    from .serve import make_server, pipeline_from_checkpoint
    from .serve.pipeline import DEMO_CKPT_A

    if args.coalesce:
        print("--coalesce is not yet in the PyTorch port", file=sys.stderr)
        return 2
    pipeline = pipeline_from_checkpoint(args.checkpoint or DEMO_CKPT_A,
                                        full_gm=args.full_gm,
                                        device=args.device)
    print(f"warming up on {pipeline.device} (building the kernels)...",
          flush=True)
    pipeline.warmup()
    server = make_server(pipeline, args.host, args.port, quiet=False)
    print(f"EAMG (PyTorch) serving on http://{args.host}:{args.port}",
          flush=True)

    def _stop(signum, frame):
        signal.signal(signum, signal.SIG_DFL)
        threading.Thread(target=server.shutdown, daemon=True).start()

    signal.signal(signal.SIGTERM, _stop)
    signal.signal(signal.SIGINT, _stop)
    try:
        server.serve_forever()
    finally:
        server.server_close()
    return 0


def main(argv=None) -> int:
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
                   default=False, help="not yet in the port")
    args = parser.parse_args(argv)
    return _serve(args)


if __name__ == "__main__":
    sys.exit(main())
