"""Native epoll HTTP server (native/silo_http.cpp) protocol tests.

Asserts byte-level protocol parity between the native front-end and the
Python fallback (both serve server/router.py), plus native-only concerns:
keep-alive connection reuse, concurrent clients, large bodies, and
malformed requests.
"""

import http.client
import json
import socket
import threading

import pytest

from lapis_silo_tpu.server.http_server import DatabaseMutex, _python_server
from lapis_silo_tpu.server.router import DatabaseBackend


@pytest.fixture(scope="module")
def database(example_dataset_db):
    return example_dataset_db


@pytest.fixture(scope="module")
def native_server(database):
    from lapis_silo_tpu.server.native_http import (
        NativeHTTPServer,
        native_http_available,
    )

    if not native_http_available():
        pytest.skip("native HTTP library unavailable")
    server = NativeHTTPServer(DatabaseBackend(DatabaseMutex(database)), port=0)
    yield server
    server.shutdown()


@pytest.fixture(scope="module")
def python_server(database):
    server = _python_server(DatabaseBackend(DatabaseMutex(database)), port=0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    yield server
    server.shutdown()


def _request(port, method, path, body=None, conn=None):
    own = conn is None
    if own:
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
    conn.request(method, path, body=body,
                 headers={"Content-Type": "application/json"} if body else {})
    resp = conn.getresponse()
    data = resp.read()
    headers = {k.lower(): v for k, v in resp.getheaders()}
    if own:
        conn.close()
    return resp.status, headers, data


COUNT_QUERY = json.dumps(
    {"action": {"type": "Aggregated"}, "filterExpression": {"type": "True"}}
)


def test_query_and_info_match_python(native_server, python_server):
    nport = native_server.server_address[1]
    pport = python_server.server_address[1]
    for method, path, body in [
        ("GET", "/info", None),
        ("GET", "/info?details=true", None),
        ("POST", "/query", COUNT_QUERY),
        ("POST", "/query", "{invalid"),
        ("GET", "/nope", None),
        ("POST", "/info", None),
        ("GET", "/query", None),
        ("PUT", "/query", COUNT_QUERY),
        ("DELETE", "/info", None),
    ]:
        ns, nh, nb = _request(nport, method, path, body)
        ps, ph, pb = _request(pport, method, path, body)
        assert ns == ps, (method, path, ns, ps, nb, pb)
        assert nb == pb, (method, path)
        assert nh.get("data-version") == ph.get("data-version")
        assert nh["content-type"] == "application/json"


def test_keep_alive_reuse(native_server):
    port = native_server.server_address[1]
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
    try:
        for _ in range(5):
            status, headers, body = _request(port, "POST", "/query",
                                             COUNT_QUERY, conn=conn)
            assert status == 200
            assert json.loads(body)["queryResult"][0]["count"] == 100
            status, _headers, _body = _request(port, "GET", "/info", conn=conn)
            assert status == 200
    finally:
        conn.close()


def test_concurrent_clients(native_server):
    port = native_server.server_address[1]
    errors = []

    def hammer():
        try:
            conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
            for _ in range(20):
                status, _h, body = _request(port, "POST", "/query",
                                            COUNT_QUERY, conn=conn)
                assert status == 200
                assert json.loads(body)["queryResult"][0]["count"] == 100
            conn.close()
        except Exception as ex:  # noqa: BLE001
            errors.append(ex)

    threads = [threading.Thread(target=hammer) for _ in range(16)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors


def test_large_body(native_server):
    # a query with a deeply padded Or keeps the parser honest on bodies
    # spanning many recv() chunks
    port = native_server.server_address[1]
    children = [{"type": "NucleotideEquals", "position": 1 + (i % 100),
                 "symbol": "A"} for i in range(4000)]
    query = json.dumps({"action": {"type": "Aggregated"},
                        "filterExpression": {"type": "Or", "children": children}})
    assert len(query) > 200_000
    status, _h, body = _request(port, "POST", "/query", query)
    # may 400 (program too large -> host fallback covers it) or 200; it
    # must be a well-formed JSON answer either way
    assert status in (200, 500)
    json.loads(body)


def test_invalid_utf8_body_gets_400(native_server):
    port = native_server.server_address[1]
    raw = b'{"action": \xff\xfe}'
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
    conn.request("POST", "/query", body=raw)
    resp = conn.getresponse()
    body = resp.read()
    conn.close()
    assert resp.status == 400
    assert json.loads(body)["error"] == "Bad request"


def test_request_with_fin_after_body(native_server):
    # client sends the full request then shuts down its write side
    port = native_server.server_address[1]
    payload = COUNT_QUERY.encode()
    raw = (b"POST /query HTTP/1.1\r\nHost: x\r\nContent-Length: "
           + str(len(payload)).encode() + b"\r\n\r\n" + payload)
    s = socket.create_connection(("127.0.0.1", port), timeout=30)
    s.sendall(raw)
    s.shutdown(socket.SHUT_WR)
    data = b""
    while True:
        chunk = s.recv(65536)
        if not chunk:
            break
        data += chunk
    s.close()
    head, _, body = data.partition(b"\r\n\r\n")
    assert b"200 OK" in head.splitlines()[0]
    assert json.loads(body)["queryResult"][0]["count"] == 100


def test_malformed_request_line(native_server):
    port = native_server.server_address[1]
    s = socket.create_connection(("127.0.0.1", port), timeout=30)
    s.sendall(b"GARBAGE\r\n\r\n")
    data = s.recv(65536)
    s.close()
    assert b"400" in data.split(b"\r\n")[0]


def test_oversized_headers_rejected(native_server):
    port = native_server.server_address[1]
    s = socket.create_connection(("127.0.0.1", port), timeout=30)
    try:
        s.sendall(b"GET /info HTTP/1.1\r\nX-Filler: " + b"a" * (70 * 1024))
        data = s.recv(65536)
        assert b"431" in data.split(b"\r\n")[0]
    finally:
        s.close()


def test_concurrent_fasta_is_stable(native_server):
    """Concurrent Fasta queries decompress through shared stores; the
    per-thread zstd contexts/scratch must keep responses bit-identical
    (a shared grow-only buffer corrupted them under races)."""
    port = native_server.server_address[1]
    query = json.dumps({
        "action": {"type": "Fasta", "sequenceName": "testSecondSequence",
                   "orderByFields": ["gisaid_epi_isl"]},
        "filterExpression": {"type": "True"},
    })
    status, _h, want = _request(port, "POST", "/query", query)
    assert status == 200 and len(want) > 1000
    errors = []

    def hammer():
        try:
            conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
            for _ in range(8):
                s, _h, body = _request(port, "POST", "/query", query,
                                       conn=conn)
                assert s == 200 and body == want
            conn.close()
        except Exception as ex:  # noqa: BLE001
            errors.append(ex)

    threads = [threading.Thread(target=hammer) for _ in range(12)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors


def test_reuse_port_two_servers(database):
    """SO_REUSEPORT: two server instances share one port; the kernel
    load-balances fresh connections across both (the mechanism behind
    cli.py --apiProcesses multi-process serving)."""
    from lapis_silo_tpu.server.native_http import (
        NativeHTTPServer,
        native_http_available,
    )

    if not native_http_available():
        pytest.skip("native HTTP library unavailable")

    hits = [0, 0]
    backend = DatabaseBackend(DatabaseMutex(database))

    def make_router(i):
        from lapis_silo_tpu.server.router import route_request

        def router(method, target, body):
            hits[i] += 1
            return route_request(backend, method, target, body)

        return router

    # probe a high port with REUSEPORT
    # set so the pair can bind it afterwards
    probe = socket.socket()
    probe.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEPORT, 1)
    probe.bind(("127.0.0.1", 0))
    port = probe.getsockname()[1]

    a = NativeHTTPServer(router=make_router(0), port=port, reuse_port=True,
                         n_workers=4)
    try:
        b = NativeHTTPServer(router=make_router(1), port=port,
                             reuse_port=True, n_workers=4)
    finally:
        probe.close()
    try:
        body = json.dumps({"action": {"type": "Aggregated"},
                           "filterExpression": {"type": "True"}})
        for _ in range(64):  # fresh connection each -> rebalanced each
            status, _h, data = _request(port, "POST", "/query", body)
            assert status == 200
            assert json.loads(data) == {"queryResult": [{"count": 100}]}
        # P(all 64 on one side) ~ 2 * 2^-64 — both must have served
        assert hits[0] > 0 and hits[1] > 0, hits
    finally:
        a.shutdown()
        b.shutdown()


def test_query_500_body_is_title_case():
    """The reference's QueryHandler catches its own exceptions and titles
    the body "Internal Server Error" (query_handler.cpp:51-70); the outer
    ErrorRequestHandler — which wraps /info — uses lowercase
    (error_request_handler.cpp:28). Pin both casings through the router."""
    from lapis_silo_tpu.server.router import route_request

    class _View:
        data_version = "0000000000"

        def execute_query(self, query):
            raise RuntimeError("boom")

        def info(self, detailed=False, tpu=False):
            raise RuntimeError("boom")

    class _Backend:
        def resolve(self):
            return _View()

    status, body, _v = route_request(_Backend(), "POST", "/query", b"{}")
    assert status == 500
    assert body == {"error": "Internal Server Error", "message": "boom"}

    status, body, _v = route_request(_Backend(), "GET", "/info", b"")
    assert status == 500
    assert body == {"error": "Internal server error", "message": "boom"}
