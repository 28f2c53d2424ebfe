"""Process shell: ``python -m repro_torch.serve`` boots the HTTP front end.

Prints one parseable banner line - ``SERVING host=<h> port=<p>`` - once
the socket is bound (port 0 picks a free port, so harnesses read the
banner rather than guessing), then serves until SIGTERM/SIGINT, which
trigger a clean shutdown: the acceptor stops, the engine thread drains
every staged batch, ``STOPPED`` is printed and the process exits 0.

The server runs on the CUDA card unless ``--device`` names another
device (``--device cpu`` for the plain PyTorch path).  Without a card
and without ``--device``, it exits with code 2 and the device rule's
message before printing a banner.
"""
from __future__ import annotations

import argparse
import signal
import sys
import threading


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.serve",
        description="HTTP serving front end for the streaming "
                    "spectral-clustering engine.")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=0,
                    help="0 = pick a free port (read the banner)")
    ap.add_argument("--pipeline", default="double_buffer",
                    choices=("double_buffer", "serialized"))
    ap.add_argument("--k", type=int, default=6)
    ap.add_argument("--num-clusters", type=int, default=4)
    ap.add_argument("--degree", type=int, default=15)
    ap.add_argument("--steps-per-tick", type=int, default=20)
    ap.add_argument("--tol", type=float, default=2e-3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device of the server (default: the CUDA "
                         "card; 'cpu' for the plain PyTorch path)")
    args = ap.parse_args(argv)

    # deferred: torch's import cost should not be paid for --help
    from repro_torch.device import resolve_device
    from repro_torch.serve.http import ServeHTTP
    from repro_torch.serve.server import Server, ServerConfig
    from repro_torch.stream.service import ServiceConfig

    try:
        device = resolve_device(args.device)
    except RuntimeError as e:
        print(f"python -m repro_torch.serve: {e}", file=sys.stderr)
        return 2
    cfg = ServerConfig(
        service=ServiceConfig(
            k=args.k, num_clusters=args.num_clusters, degree=args.degree,
            steps_per_tick=args.steps_per_tick, tol=args.tol,
            seed=args.seed),
        pipeline=args.pipeline)
    front = ServeHTTP(Server(cfg, device=device), host=args.host,
                      port=args.port)
    front.start()
    print(f"SERVING host={front.host} port={front.port}", flush=True)

    done = threading.Event()

    def _stop(signum, frame):
        done.set()

    signal.signal(signal.SIGTERM, _stop)
    signal.signal(signal.SIGINT, _stop)
    done.wait()
    front.stop()
    print("STOPPED", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
