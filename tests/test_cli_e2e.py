"""CLI end-to-end: --preprocessing writes a snapshot; the api stack loads it
through the watcher and serves /query (reference e2e docker flow)."""

import json
import os
import threading
import urllib.request

import pytest

from .conftest import REFERENCE_ROOT, reference_available


@pytest.fixture(scope="module")
def cli_output_dir(tmp_path_factory):
    if not reference_available():
        pytest.skip("reference data unavailable")
    from lapis_silo_tpu.config.yaml_subset import dump_mapping

    base = os.path.join(REFERENCE_ROOT, "testBaseData/exampleDataset/")
    work = tmp_path_factory.mktemp("cli_run")
    out = work / "output"
    pcfg = {
        "inputDirectory": base,
        "outputDirectory": str(out),
        "metadataFilename": "small_metadata_set.tsv",
        "pangoLineageDefinitionFilename": "pangolineage_alias.json",
        "referenceGenomeFilename": "reference_genomes.json",
    }
    pcfg_path = work / "preprocessing_config.yaml"
    pcfg_path.write_text(dump_mapping(pcfg))

    from lapis_silo_tpu import cli

    code = cli.main([
        "--preprocessing",
        "--preprocessingConfig", str(pcfg_path),
        "--databaseConfig", os.path.join(base, "database_config.yaml"),
    ])
    assert code == 0
    snapshots = [d for d in os.listdir(out) if d.isdigit()]
    assert len(snapshots) == 1
    return str(out)


def test_cli_preprocessing_and_serve(cli_output_dir):
    from lapis_silo_tpu.server.http_server import DatabaseMutex, make_server
    from lapis_silo_tpu.server.watcher import DatabaseDirectoryWatcher

    mutex = DatabaseMutex()
    watcher = DatabaseDirectoryWatcher(cli_output_dir, mutex, poll_seconds=3600)
    watcher.start()
    server = make_server(mutex, port=0)
    port = server.server_address[1]
    threading.Thread(target=server.serve_forever, daemon=True).start()
    try:
        body = json.dumps({
            "action": {"type": "Aggregated", "groupByFields": ["country"],
                       "orderByFields": ["country"]},
            "filterExpression": {"type": "True"},
        })
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}/query", data=body.encode(), method="POST")
        with urllib.request.urlopen(req) as resp:
            payload = json.loads(resp.read())
        assert sum(r["count"] for r in payload["queryResult"]) == 100
        assert any(r["country"] == "Switzerland" for r in payload["queryResult"])
    finally:
        server.shutdown()
        watcher.stop()


def test_cli_api_sigterm_graceful(cli_output_dir):
    """SIGTERM on the api process unwinds like Ctrl-C: server + watcher stop
    cleanly, exit code 0 (reference: Poco waitForTerminationRequest).
    Also covers NativeHTTPServer.server_close (cli.py's shutdown path)."""
    import signal
    import socket
    import subprocess
    import sys
    import time

    probe = socket.socket()
    probe.bind(("127.0.0.1", 0))
    port = probe.getsockname()[1]
    probe.close()
    wrapper = (
        "import sys; "
        "from lapis_silo_tpu.cli import main; "
        "sys.exit(main(['--api', '--dataDirectory', sys.argv[1], "
        "'--port', sys.argv[2]]))"
    )
    proc = subprocess.Popen(
        [sys.executable, "-c", wrapper, cli_output_dir, str(port)],
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        env=dict(os.environ, JAX_PLATFORMS="cpu"))
    try:
        up = False
        for _ in range(60):
            time.sleep(1)
            try:
                urllib.request.urlopen(f"http://127.0.0.1:{port}/info",
                                       timeout=2)
                up = True
                break
            except Exception:  # noqa: BLE001 — still starting
                pass
        assert up, "server never came up"
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=30) == 0
        proc = None
    finally:
        if proc is not None:
            proc.kill()


def test_cli_api_double_sigterm(cli_output_dir):
    """A second SIGTERM while the first one's cleanup is running (the
    process-group kill pattern: docker/systemd/killpg signal supervisor AND
    children) must not abort the `finally` unwind — exit code stays 0.
    Regression: the handler used to stay armed and re-raise inside
    server_close()."""
    import signal
    import socket
    import subprocess
    import sys
    import time

    probe = socket.socket()
    probe.bind(("127.0.0.1", 0))
    port = probe.getsockname()[1]
    probe.close()

    env = dict(os.environ, JAX_PLATFORMS="cpu")
    proc = subprocess.Popen(
        [sys.executable, "-m", "lapis_silo_tpu.cli", "--api",
         "--dataDirectory", cli_output_dir, "--port", str(port)],
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        env=env)
    try:
        up = False
        for _ in range(60):
            time.sleep(1)
            try:
                urllib.request.urlopen(f"http://127.0.0.1:{port}/info",
                                       timeout=2)
                up = True
                break
            except Exception:  # noqa: BLE001 — still starting
                pass
        assert up, "server never came up"
        proc.send_signal(signal.SIGTERM)
        time.sleep(0.2)  # first handler fired; cleanup is in flight
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=30) == 0
        proc = None
    finally:
        if proc is not None:
            proc.kill()


def test_cli_api_multiprocess(cli_output_dir):
    """--apiProcesses 2: the supervisor spawns two server processes sharing
    the port via SO_REUSEPORT; queries answer correctly and SIGTERM unwinds
    the whole tree with exit code 0."""
    import signal
    import socket
    import subprocess
    import sys
    import time

    probe = socket.socket()
    probe.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEPORT, 1)
    probe.bind(("127.0.0.1", 0))
    port = probe.getsockname()[1]

    env = dict(os.environ, JAX_PLATFORMS="cpu")
    proc = subprocess.Popen(
        [sys.executable, "-m", "lapis_silo_tpu.cli", "--api",
         "--dataDirectory", cli_output_dir, "--port", str(port),
         "--apiProcesses", "2"],
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        env=env)
    probe.close()
    try:
        up = False
        for _ in range(90):
            time.sleep(1)
            try:
                urllib.request.urlopen(f"http://127.0.0.1:{port}/info",
                                       timeout=2)
                up = True
                break
            except Exception:  # noqa: BLE001 — children still starting
                pass
        assert up, "no api process ever came up"
        body = json.dumps({"action": {"type": "Aggregated"},
                           "filterExpression": {"type": "True"}}).encode()
        for _ in range(8):  # fresh connections spread across both processes
            req = urllib.request.Request(
                f"http://127.0.0.1:{port}/query", data=body, method="POST")
            with urllib.request.urlopen(req, timeout=30) as resp:
                assert json.loads(resp.read()) == {
                    "queryResult": [{"count": 100}]}
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=30) == 0
        proc = None
        # port must be fully released (no orphan children still bound);
        # SO_REUSEADDR skips our own client sockets' TIME_WAIT but still
        # fails against a live orphan listener
        time.sleep(1)
        leftover = socket.socket()
        leftover.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        leftover.bind(("127.0.0.1", port))
        leftover.close()
    finally:
        if proc is not None:
            proc.kill()
