"""Large-scale parity harness: device engine vs host oracle at >=1M rows,
all action types, one command.

Builds two independent rich synthetic corpora from one seed (the oracle
database never sees a device engine), runs randomized (filter x action)
pairs across every action kind, asserts full-response equality, and
records per-action latency percentiles — including the Details
row-materialization path whose [P, W] device->host readback cost was
unmeasured at scale.

Env knobs: SILO_PARITY_ROWS (1048576), SILO_PARITY_QUERIES (60),
SILO_PARITY_SEED (5), SILO_PARITY_CPU (0; 1 forces the CPU backend).
Output: one JSON line with pass/fail counts and per-action p50/p95 ms.

Also runnable in CI: SILO_SLOW=1 python -m pytest tests/test_large_parity.py
"""

import json
import os
import random
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def log(*args):
    print(*args, file=sys.stderr, flush=True)


def run(n_rows: int, n_queries: int, seed: int) -> dict:
    from tests.test_fuzz_actions import ACTION_KINDS, _canon, random_action
    from tests.test_fuzz_filters import random_filter

    from lapis_silo_tpu.query.engine import QueryEngine
    from lapis_silo_tpu.testing import synthetic_database

    t0 = time.time()
    db_dev = synthetic_database(n_rows=n_rows, length=1024, n_partitions=4,
                                seed=seed, rich=True)
    db_host = synthetic_database(n_rows=n_rows, length=1024, n_partitions=4,
                                 seed=seed, rich=True)
    log(f"corpora built in {time.time() - t0:.0f}s ({n_rows} rows)")
    dev = QueryEngine(db_dev, use_device=True)
    host = QueryEngine(db_host, use_device=False)

    rng = random.Random(seed * 1009)
    latencies: dict[str, list[float]] = {}
    checked = 0
    for i in range(n_queries):
        kind = ACTION_KINDS[i % len(ACTION_KINDS)]
        action, mode = random_action(rng, kind)
        if action["type"] == "Details" and "limit" not in action:
            # uncapped Details at 1M hits the 10k cap both sides — fine,
            # but cap half of them to keep multiset compares tractable
            if rng.random() < 0.5:
                action["limit"] = 10_000
        if action["type"] == "FastaAligned":
            # 1M-row FastaAligned exceeds the reference's 10k cap -> both
            # sides 400; pair it with a narrow filter instead
            filter_json = {"type": "And", "children": [
                {"type": "StringEquals", "column": "key",
                 "value": f"SEQ_{rng.randint(0, n_rows - 1)}"},
                random_filter(rng, db_dev)]}
        else:
            filter_json = random_filter(rng, db_dev)
        query = json.dumps({"filterExpression": filter_json, "action": action})
        t0 = time.perf_counter()
        dev_result = dev.execute(query)["queryResult"]
        dt = time.perf_counter() - t0
        host_result = host.execute(query)["queryResult"]
        if mode == "exact":
            assert dev_result == host_result, query
        else:
            assert _canon(dev_result) == _canon(host_result), query
        latencies.setdefault(action["type"], []).append(dt)
        checked += 1
        if (i + 1) % 10 == 0:
            log(f"{i + 1}/{n_queries} checked")

    summary = {"rows": n_rows, "queries_checked": checked, "actions": {}}
    for action_type, vals in sorted(latencies.items()):
        vals.sort()
        summary["actions"][action_type] = {
            "n": len(vals),
            "p50_ms": round(vals[len(vals) // 2] * 1e3, 1),
            "p95_ms": round(vals[min(len(vals) - 1, int(len(vals) * 0.95))] * 1e3, 1),
        }
    return summary


def main():
    if os.environ.get("SILO_PARITY_CPU", "0") == "1":
        os.environ["JAX_PLATFORMS"] = "cpu"
    n_rows = int(os.environ.get("SILO_PARITY_ROWS", 1_048_576))
    n_queries = int(os.environ.get("SILO_PARITY_QUERIES", 60))
    seed = int(os.environ.get("SILO_PARITY_SEED", 5))
    summary = run(n_rows, n_queries, seed)
    print(json.dumps(summary))


if __name__ == "__main__":
    main()
