"""
Runs the port's WSGI app on the standard library's HTTP server, one
thread per connection; connections are kept alive between requests
(HTTP/1.1), so a router's calls to a replica reuse them.

    python -m gordo_tpu_torch.server.runner --collection-dir <dir> [--port 5555]

``--device cpu`` serves from the CPU; the default is the card.
``--batch-wait-ms``, ``--queue-limit`` and ``--scorer-cache-size`` set
the fleet routes' dynamic batching and scorer cache (defaults: the
``GORDO_BATCH_WAIT_MS``, ``GORDO_BATCH_QUEUE_LIMIT`` and
``GORDO_SCORER_CACHE_SIZE`` environment variables, else 0, 64 and 16;
a wait of 0 turns batching off). ``--shard-manifest`` and
``--replica-id`` (``GORDO_SHARD_MANIFEST``, ``GORDO_REPLICA_ID``) serve
one replica's shard of the collection (``server/app.py``).
"""

import argparse
import io
import logging
from socketserver import ThreadingMixIn
from wsgiref.simple_server import ServerHandler, WSGIRequestHandler, WSGIServer, make_server

from gordo_tpu_torch.server.app import build_app

logger = logging.getLogger(__name__)


class ThreadingWSGIServer(ThreadingMixIn, WSGIServer):
    daemon_threads = True


class _Http11Handler(ServerHandler):
    http_version = "1.1"


class QuietHandler(WSGIRequestHandler):
    """Keeps a connection open across requests (HTTP/1.1, unless the
    client asks to close it); request lines go to the debug log instead
    of stderr. A request's body is read whole before the app runs, so a
    reply that leaves it unread does not desynchronise the connection
    (the app's replies always carry their Content-Length)."""

    protocol_version = "HTTP/1.1"
    # a reply goes out as two writes (headers, body): with Nagle's algorithm
    # the body would wait for the client's delayed ACK of the headers
    disable_nagle_algorithm = True

    def handle(self):
        self.close_connection = True
        self._handle_one()
        while not self.close_connection:
            self._handle_one()

    def _handle_one(self):
        self.raw_requestline = self.rfile.readline(65537)
        if not self.raw_requestline or len(self.raw_requestline) > 65536:
            self.close_connection = True
            return
        if not self.parse_request():
            return
        try:
            length = int(self.headers.get("Content-Length") or 0)
        except ValueError:
            length = 0
        body = io.BytesIO(self.rfile.read(length) if length > 0 else b"")
        handler = _Http11Handler(body, self.wfile, self.get_stderr(), self.get_environ(),
                                 multithread=True)
        handler.request_handler = self
        handler.run(self.server.get_app())

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
    parser.add_argument("--shard-manifest", default=None,
                        help="serve only this replica's shard of the manifest's replica set")
    parser.add_argument("--replica-id", default=None,
                        help="this replica's id on the ring (overrides the manifest's)")
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    app = build_app(args.collection_dir, args.device, batch_wait_ms=args.batch_wait_ms,
                    batch_queue_limit=args.queue_limit,
                    scorer_cache_size=args.scorer_cache_size,
                    shard_manifest=args.shard_manifest, replica_id=args.replica_id)
    server = make_http_server(app, args.host, args.port)
    logger.info("Serving on %s:%d", args.host, server.server_port)
    try:
        server.serve_forever()
    finally:
        server.server_close()


if __name__ == "__main__":
    main()
