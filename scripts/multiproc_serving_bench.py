"""Front-end scaling benchmark for --apiProcesses (SO_REUSEPORT).

Launches the REAL cli --api stack (native epoll front-end + watcher +
snapshot load) with N server processes sharing one port, and hammers
/query with concurrent count queries. Runs on the CPU backend
(JAX_PLATFORMS=cpu): the thing --apiProcesses scales is the per-request
Python (JSON parse + route + result assembly) under the GIL. On a GPU
the CLI refuses N > 1 — every process would reserve most of the card's
memory — so this benchmark is CPU-only.

Env knobs: SILO_BENCH_CLIENTS (64), SILO_BENCH_SECONDS (8),
SILO_BENCH_PORT (18231), SILO_BENCH_PROCS ("1,2").
"""

import json
import os
import shutil
import signal
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
REFERENCE = "/root/reference/testBaseData/exampleDataset/"


def log(*args):
    print(*args, file=sys.stderr, flush=True)


def build_snapshot(work: str) -> str:
    from lapis_silo_tpu.config.yaml_subset import dump_mapping

    out = os.path.join(work, "output")
    pcfg = {
        "inputDirectory": REFERENCE,
        "outputDirectory": out,
        "metadataFilename": "small_metadata_set.tsv",
        "pangoLineageDefinitionFilename": "pangolineage_alias.json",
        "referenceGenomeFilename": "reference_genomes.json",
    }
    pcfg_path = os.path.join(work, "preprocessing_config.yaml")
    with open(pcfg_path, "w") as f:
        f.write(dump_mapping(pcfg))
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    subprocess.run(
        [sys.executable, "-m", "lapis_silo_tpu.cli", "--preprocessing",
         "--preprocessingConfig", pcfg_path,
         "--databaseConfig", os.path.join(REFERENCE, "database_config.yaml")],
        check=True, env=env, cwd=REPO)
    return out


QUERIES = [
    json.dumps({"action": {"type": "Aggregated"},
                "filterExpression": {"type": "NucleotideEquals",
                                     "position": 25, "symbol": "C"}}),
    json.dumps({"action": {"type": "Aggregated"},
                "filterExpression": {"type": "And", "children": [
                    {"type": "StringEquals", "column": "country",
                     "value": "Switzerland"},
                    {"type": "DateBetween", "column": "date",
                     "from": "2021-01-01", "to": "2021-06-01"}]}}),
    json.dumps({"action": {"type": "Aggregated", "groupByFields": ["division"]},
                "filterExpression": {"type": "True"}}),
]


def wait_ready(port: int, timeout: float = 120.0, n_procs: int = 1):
    """Ready = 4*n_procs CONSECUTIVE /info successes: with SO_REUSEPORT the
    kernel spreads connections over children, so one success only proves one
    child is live; a streak makes a 503 from a still-staging sibling very
    unlikely to slip into the measured window."""
    deadline = time.time() + timeout
    url = f"http://127.0.0.1:{port}/info"
    streak = 0
    while time.time() < deadline:
        try:
            with urllib.request.urlopen(url, timeout=5) as resp:
                info = json.loads(resp.read())
            if info.get("sequenceCount", 0) > 0:
                streak += 1
                if streak >= 4 * n_procs:
                    return
                continue
        except Exception:
            pass
        streak = 0
        time.sleep(0.25)
    raise TimeoutError("server never became ready")


def hammer(port: int, n_clients: int, seconds: float):
    url = f"http://127.0.0.1:{port}/query"
    stop_at = time.time() + seconds
    latencies: list[float] = []
    errors: list[str] = []
    lock = threading.Lock()

    def client(seed: int):
        i = seed
        local = []
        local_errors = []
        while time.time() < stop_at:
            body = QUERIES[i % len(QUERIES)].encode()
            req = urllib.request.Request(
                url, data=body, headers={"Content-Type": "application/json"})
            t0 = time.perf_counter()
            try:
                with urllib.request.urlopen(req, timeout=60) as resp:
                    resp.read()
            except Exception as ex:  # noqa: BLE001 — count, don't die silently
                local_errors.append(f"{type(ex).__name__}: {ex}")
                i += 1
                continue
            local.append(time.perf_counter() - t0)
            i += 1
        with lock:
            latencies.extend(local)
            errors.extend(local_errors)

    threads = [threading.Thread(target=client, args=(i,)) for i in range(n_clients)]
    t_start = time.time()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    elapsed = time.time() - t_start
    latencies.sort()
    if errors:
        log(f"hammer: {len(errors)} request errors "
            f"({len(latencies)} ok); first: {errors[0]}")
        if not latencies or len(errors) > len(latencies) * 0.01:
            raise RuntimeError(
                f"hammer error rate too high: {len(errors)} errors / "
                f"{len(latencies)} ok — first: {errors[0]}")
    qps = len(latencies) / elapsed
    p50 = latencies[len(latencies) // 2] * 1e3 if latencies else float("nan")
    p99 = latencies[int(len(latencies) * 0.99)] * 1e3 if latencies else float("nan")
    return qps, p50, p99


def run_config(data_dir: str, port: int, n_procs: int,
               n_clients: int, seconds: float):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    proc = subprocess.Popen(
        [sys.executable, "-m", "lapis_silo_tpu.cli", "--api",
         "--dataDirectory", data_dir, "--port", str(port),
         "--apiProcesses", str(n_procs)],
        env=env, cwd=REPO, start_new_session=True)
    try:
        wait_ready(port, n_procs=n_procs)
        hammer(port, n_clients, 2.0)  # warm-up
        qps, p50, p99 = hammer(port, n_clients, seconds)
        log(f"apiProcesses={n_procs}: {qps:.0f} req/s p50={p50:.1f}ms "
            f"p99={p99:.1f}ms ({n_clients} clients)")
        return qps, p50, p99
    finally:
        try:
            os.killpg(proc.pid, signal.SIGTERM)
        except ProcessLookupError:  # group already gone (startup crash):
            pass                    # don't mask the original exception
        try:
            proc.wait(timeout=15)
        except subprocess.TimeoutExpired:
            try:
                os.killpg(proc.pid, signal.SIGKILL)
            except ProcessLookupError:
                pass
            proc.wait()


def main():
    n_clients = int(os.environ.get("SILO_BENCH_CLIENTS", 64))
    seconds = float(os.environ.get("SILO_BENCH_SECONDS", 8))
    port = int(os.environ.get("SILO_BENCH_PORT", 18231))
    procs = [int(x) for x in os.environ.get("SILO_BENCH_PROCS", "1,2").split(",")]

    work = tempfile.mkdtemp(prefix="silo_mpbench_")
    try:
        data_dir = build_snapshot(work)
        results = {}
        for n in procs:
            results[n] = run_config(data_dir, port, n, n_clients, seconds)
            time.sleep(1)
        base = results[procs[0]][0]
        print(json.dumps({
            "metric": "multiproc_front_end_req_per_sec",
            "results": {str(n): {"qps": round(q, 1), "p50_ms": round(p50, 2),
                                 "p99_ms": round(p99, 2)}
                        for n, (q, p50, p99) in results.items()},
            "scaling_vs_1proc": {str(n): round(results[n][0] / base, 2)
                                 for n in procs},
        }))
    finally:
        shutil.rmtree(work, ignore_errors=True)


if __name__ == "__main__":
    main()
