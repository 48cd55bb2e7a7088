"""
HTTP/1.1 calls over kept-alive ``http.client`` connections, the one
transport of the port's router (to its replicas) and client (to a server
or router): the card's machine has no ``requests``.

Connections are pooled by (scheme, host, port), one call at a time on
each. A call on a pooled connection that the peer has since closed is
sent again, once, on a fresh one (``requests`` retries its pool the same
way). ``TCP_NODELAY`` is set on every connection: ``http.client`` writes
the headers and the body apart, and with Nagle's algorithm the body
would wait for the peer's delayed ACK of the headers (about 40 ms).

A call's ``timeout`` is set on its socket for that call, whichever call
opened the connection: a float bounds the connect and every read, a
``(connect, read)`` pair bounds them apart, and a read bound of None
waits as long as the peer takes.

:class:`WsgiTransport` has the same ``request``/``close`` interface and
calls WSGI apps in this process, mounted by host: a game day's plane
(``scenario/plane.py``) runs its replicas, router and client without a
socket. A host marked dead refuses, as a killed process's port does.
"""

import io

import http.client
import json
import socket
import threading
from typing import Dict, List, Optional, Tuple, Union
from urllib.parse import urlsplit

Timeout = Union[None, float, Tuple[Optional[float], Optional[float]]]


class Reply:
    """A peer's answer: status, headers (names lower-cased), body."""

    def __init__(self, status: int, headers: Dict[str, str], body: bytes):
        self.status = status
        self.headers = headers
        self.body = body

    def json(self):
        return json.loads(self.body or b"null")


class WsgiTransport:
    """In-process calls into WSGI apps mounted by ``host[:port]``; calls to
    one app are serialized (an app sees one request at a time, as one
    worker would). A call to a host in ``dead`` raises
    ``ConnectionRefusedError``, as a call to a killed process does."""

    def __init__(self):
        self.apps: Dict[str, object] = {}
        self.dead: set = set()
        self._locks: Dict[str, threading.Lock] = {}

    def mount(self, host: str, app) -> None:
        """Serve ``host`` with ``app`` (a fresh app replaces the old one,
        as a restarted process does)."""
        self.apps[host] = app
        self._locks.setdefault(host, threading.Lock())

    def request(self, method: str, url: str, body: Optional[bytes] = None,
                headers: Optional[Dict[str, str]] = None, timeout: Timeout = 30.0) -> Reply:
        parts = urlsplit(url)
        host = parts.netloc
        if host in self.dead or host not in self.apps:
            raise ConnectionRefusedError(f"{host} refuses connections")
        body = body or b""
        environ = {
            "REQUEST_METHOD": method,
            "PATH_INFO": parts.path or "/",
            "QUERY_STRING": parts.query,
            "SERVER_NAME": parts.hostname or "localhost",
            "SERVER_PORT": str(parts.port or 80),
            "SERVER_PROTOCOL": "HTTP/1.1",
            "CONTENT_LENGTH": str(len(body)),
            "wsgi.input": io.BytesIO(body),
            "wsgi.url_scheme": parts.scheme or "http",
            "wsgi.errors": io.StringIO(),
        }
        for name, value in (headers or {}).items():
            key = name.upper().replace("-", "_")
            if key == "CONTENT_TYPE":
                environ["CONTENT_TYPE"] = value
            else:
                environ[f"HTTP_{key}"] = value
        status_headers: List[tuple] = []

        def start_response(status, response_headers, exc_info=None):
            status_headers[:] = [status, response_headers]

        with self._locks[host]:
            chunks = self.apps[host](environ, start_response)
            try:
                data = b"".join(chunks)
            finally:
                if hasattr(chunks, "close"):
                    chunks.close()
        status, response_headers = status_headers
        return Reply(int(str(status).split(" ", 1)[0]),
                     {k.lower(): v for k, v in response_headers}, data)

    def close(self) -> None:
        pass


def _split_timeout(timeout: Timeout) -> Tuple[Optional[float], Optional[float]]:
    if isinstance(timeout, tuple):
        return timeout
    return timeout, timeout


class HttpTransport:
    """Pooled keep-alive calls (see the module's docstring)."""

    def __init__(self):
        self._idle: Dict[Tuple[str, str, int], List[http.client.HTTPConnection]] = {}
        self._lock = threading.Lock()

    @staticmethod
    def _connect(key: Tuple[str, str, int], connect_timeout: Optional[float]):
        scheme, host, port = key
        cls = http.client.HTTPSConnection if scheme == "https" else http.client.HTTPConnection
        conn = cls(host, port, timeout=connect_timeout)
        conn.connect()
        conn.sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        return conn

    def request(self, method: str, url: str, body: Optional[bytes] = None,
                headers: Optional[Dict[str, str]] = None, timeout: Timeout = 30.0) -> Reply:
        parts = urlsplit(url)
        scheme = parts.scheme or "http"
        key = (scheme, parts.hostname, parts.port or (443 if scheme == "https" else 80))
        target = (parts.path or "/") + (f"?{parts.query}" if parts.query else "")
        connect_timeout, read_timeout = _split_timeout(timeout)
        for attempt in (0, 1):
            with self._lock:
                pool = self._idle.setdefault(key, [])
                conn = pool.pop() if pool else None
            reused = conn is not None
            try:
                if conn is None:
                    conn = self._connect(key, connect_timeout)
                conn.sock.settimeout(read_timeout)
                conn.request(method, target, body=body, headers=headers or {})
                resp = conn.getresponse()
                data = resp.read()
            except TimeoutError:
                if conn is not None:
                    conn.close()
                raise  # the peer may still be working on it: never resent
            except (ConnectionError, http.client.HTTPException, OSError):
                if conn is not None:
                    conn.close()
                if reused and attempt == 0:
                    continue  # the peer closed the idle connection
                raise
            if resp.will_close:
                conn.close()
            else:
                with self._lock:
                    self._idle.setdefault(key, []).append(conn)
            return Reply(resp.status, {k.lower(): v for k, v in resp.getheaders()}, data)
        raise ConnectionError(f"no connection to {url}")  # not reached

    def close(self) -> None:
        with self._lock:
            pools, self._idle = self._idle, {}
        for pool in pools.values():
            for conn in pool:
                conn.close()
