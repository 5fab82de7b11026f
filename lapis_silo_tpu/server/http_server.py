"""HTTP API server: /query (POST), /info (GET, ?details=true), port 8081.

Protocol parity with reference src/silo_api/ (Poco): response formats,
status codes, the data-version header on every data endpoint, 404/405 error
bodies, and the reader/writer snapshot swap (DatabaseMutex).

Two interchangeable front-ends serve the same router (server/router.py):
the native epoll server (native/silo_http.cpp, the default — the reference's
API layer is native too) and this pure-Python http.server fallback.
make_server()/make_coordinator_server() pick automatically; set
SILO_HTTP_IMPL=python|native to force one.
"""

from __future__ import annotations

import json
import logging
import os
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from ..storage.database import Database
from .router import CoordinatorBackend, DatabaseBackend, route_request

logger = logging.getLogger(__name__)


class DatabaseMutex:
    """Single-writer / multi-reader snapshot swap
    (reference src/silo_api/database_mutex.cpp)."""

    def __init__(self, database: Database | None = None):
        self._lock = threading.Lock()
        self._database = database if database is not None else Database.empty()
        self._listeners = []

    def get_database(self) -> Database:
        with self._lock:
            return self._database

    def set_database(self, database: Database):
        with self._lock:
            self._database = database
            listeners = list(self._listeners)
        for fn in listeners:  # outside the lock: listeners may be slow
            fn()

    def add_swap_listener(self, fn):
        """Call fn() after every set_database (e.g. the native count fast
        path clears its body map so no post-swap request matches stale)."""
        with self._lock:
            self._listeners.append(fn)


class SiloHTTPServer(ThreadingHTTPServer):
    # Hundreds of concurrent clients open fresh connections per request:
    # the stdlib default listen backlog of 5 resets the overflow, and
    # Nagle + delayed ACK adds ~40 ms to every small keep-alive response.
    daemon_threads = True
    request_queue_size = 1024


class SiloRequestHandler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"
    server_version = "lapis-silo-tpu"
    disable_nagle_algorithm = True

    # set by make_server / make_coordinator_server
    backend = None

    def log_message(self, fmt, *args):  # route to logging, not stderr
        logger.info("%s %s", self.address_string(), fmt % args)

    def _handle(self):
        length = int(self.headers.get("Content-Length", 0) or 0)
        body = self.rfile.read(length) if length else b""
        status, payload, data_version = route_request(
            self.backend, self.command, self.path, body)
        encoded = json.dumps(payload, ensure_ascii=False).encode("utf-8")
        self.send_response(status)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(encoded)))
        if data_version is not None:
            self.send_header("data-version", data_version)
        self.end_headers()
        self.wfile.write(encoded)

    do_GET = _handle
    do_POST = _handle
    # Any other method: 405 via the router (reference rest_resource.cpp)
    do_PUT = _handle
    do_DELETE = _handle
    do_PATCH = _handle
    do_HEAD = _handle


def _python_server(backend, port: int,
                   reuse_port: bool = False) -> ThreadingHTTPServer:
    handler = type("BoundSiloRequestHandler", (SiloRequestHandler,),
                   {"backend": backend})
    server_cls = SiloHTTPServer
    if reuse_port:
        server_cls = type("ReusePortSiloHTTPServer", (SiloHTTPServer,),
                          {"allow_reuse_port": True})
    return server_cls(("0.0.0.0", port), handler)


def _make(backend, port: int, reuse_port: bool = False):
    impl = os.environ.get("SILO_HTTP_IMPL", "native")
    if impl != "python":
        from .native_http import NativeHTTPServer, native_http_available

        if native_http_available():
            logger.info("HTTP front-end: native epoll server "
                        "(native/silo_http.cpp) on :%d", port)
            return NativeHTTPServer(backend, port=port, reuse_port=reuse_port)
        if impl == "native":
            logger.warning("native HTTP library unavailable; "
                           "falling back to the Python server")
    logger.info("HTTP front-end: Python http.server on :%d", port)
    return _python_server(backend, port, reuse_port=reuse_port)


def make_server(database_mutex: DatabaseMutex, port: int = 8081,
                reuse_port: bool = False):
    return _make(DatabaseBackend(database_mutex), port, reuse_port=reuse_port)


def make_coordinator_server(coordinator, port: int = 8081):
    """The same public /query + /info protocol, answered by a multi-host
    Coordinator (fan-out + merge) instead of a local database."""
    return _make(CoordinatorBackend(coordinator), port)
