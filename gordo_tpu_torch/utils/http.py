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
"""

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
