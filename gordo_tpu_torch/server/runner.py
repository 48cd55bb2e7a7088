"""
Runs the port's WSGI app on the standard library's HTTP server, one
thread per request.

    python -m gordo_tpu_torch.server.runner --collection-dir <dir> [--port 5555]

``--device cpu`` serves from the CPU; the default is the card.
``--batch-wait-ms``, ``--queue-limit`` and ``--scorer-cache-size`` set
the fleet routes' dynamic batching and scorer cache (defaults: the
``GORDO_BATCH_WAIT_MS``, ``GORDO_BATCH_QUEUE_LIMIT`` and
``GORDO_SCORER_CACHE_SIZE`` environment variables, else 0, 64 and 16;
a wait of 0 turns batching off).
"""

import argparse
import logging
from socketserver import ThreadingMixIn
from wsgiref.simple_server import WSGIRequestHandler, WSGIServer, make_server

from gordo_tpu_torch.server.app import build_app

logger = logging.getLogger(__name__)


class ThreadingWSGIServer(ThreadingMixIn, WSGIServer):
    daemon_threads = True


class QuietHandler(WSGIRequestHandler):
    """Request lines go to the debug log instead of stderr."""

    def log_message(self, format, *args):
        logger.debug("%s - " + format, self.address_string(), *args)


def make_http_server(app, host: str = "127.0.0.1", port: int = 5555) -> WSGIServer:
    """A threaded HTTP server for ``app``; port 0 picks a free port
    (``server.server_port``). The caller runs ``serve_forever`` and, when
    done, ``shutdown`` and ``server_close``."""
    return make_server(
        host, port, app, server_class=ThreadingWSGIServer, handler_class=QuietHandler
    )


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--collection-dir", default=None)
    parser.add_argument("--host", default="0.0.0.0")
    parser.add_argument("--port", type=int, default=5555)
    parser.add_argument("--device", default=None)
    parser.add_argument("--batch-wait-ms", type=float, default=None,
                        help="longest wait of a fleet request for batch-mates (0: no batching)")
    parser.add_argument("--queue-limit", type=int, default=None,
                        help="batch capacity and admission bound of each batcher")
    parser.add_argument("--scorer-cache-size", type=int, default=None,
                        help="fleet scorers (and batchers) kept")
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    app = build_app(args.collection_dir, args.device, batch_wait_ms=args.batch_wait_ms,
                    batch_queue_limit=args.queue_limit,
                    scorer_cache_size=args.scorer_cache_size)
    server = make_http_server(app, args.host, args.port)
    logger.info("Serving on %s:%d", args.host, server.server_port)
    try:
        server.serve_forever()
    finally:
        server.server_close()


if __name__ == "__main__":
    main()
