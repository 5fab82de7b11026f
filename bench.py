"""Benchmark: mutation-filter count queries/sec on one device.

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline", "device"}.
Extra detail goes to stderr. Knobs (env):
  SILO_BENCH_ROWS        corpus size            (default 65536)
  SILO_BENCH_LENGTH      genome length          (default 29903)
  SILO_BENCH_PARTITIONS  partitions             (default 1)
  SILO_BENCH_QUERIES     measured queries       (default 512)
  SILO_BENCH_PASSES      throughput passes      (default 5)
  SILO_BENCH_PROFILE     directory for a jax.profiler trace of the passes

Every timing ends in a host pull. The headline is the median pass.
"""

from __future__ import annotations

import gc
import json
import os
import sys
import time

import numpy as np


def log(*args):
    print(*args, file=sys.stderr, flush=True)


def main():
    n_rows = int(os.environ.get("SILO_BENCH_ROWS", 65536))
    length = int(os.environ.get("SILO_BENCH_LENGTH", 29903))
    n_partitions = int(os.environ.get("SILO_BENCH_PARTITIONS", 1))
    n_queries = int(os.environ.get("SILO_BENCH_QUERIES", 512))
    n_passes = int(os.environ.get("SILO_BENCH_PASSES", 5))

    import jax

    from lapis_silo_tpu.compile_cache import configure

    log(f"compile cache: {configure()}")
    device = jax.devices()[0]
    log(f"devices: {jax.devices()}")

    from lapis_silo_tpu.ops import device_engine as de
    from lapis_silo_tpu.query.engine import Query
    from lapis_silo_tpu.testing import sample_count_queries, synthetic_database

    t0 = time.time()
    db = synthetic_database(n_rows=n_rows, length=length,
                            n_partitions=n_partitions)
    log(f"synthetic corpus built: {n_rows} rows x {length} positions "
        f"({n_partitions} partitions) in {time.time() - t0:.1f}s")

    t0 = time.time()
    engine = de.DeviceEngine(db)
    jax.block_until_ready(engine.bank)
    sparse_gb = (sum(a.nbytes for a in engine.sparse_stream) / 1e9
                 if engine.sparse_stream is not None else 0.0)
    log(f"bank resident: dense {engine.bank.nbytes / 1e9:.2f} GB "
        f"({engine.n_rows} rows) + sparse stream {sparse_gb:.2f} GB "
        f"({engine.n_sparse} rows) in {time.time() - t0:.1f}s")

    queries = [Query(q) for q in sample_count_queries(db, n_queries=n_queries)]
    programs = [engine.lower(q.filter)[0] for q in queries]
    total_len = sum(len(p.opcodes) + 1 for p in programs)
    bucket = next((b for b in de._BATCH_LEN_BUCKETS if b >= total_len),
                  de._BATCH_LEN_BUCKETS[-1])
    min_k, min_e = engine.sparse_floors(programs)
    floors = {"min_bucket": bucket, "min_sparse_k": min_k,
              "min_sparse_e": min_e}

    t0 = time.time()
    counts = engine.count_programs(programs, **floors)
    for program in programs:  # single-query executables
        engine.count_programs([program], min_bucket=bucket)
    log(f"warm-up (bucket {bucket}, sparse K>={min_k} E>={min_e}) "
        f"in {time.time() - t0:.1f}s")

    latencies = []
    for program in programs:
        t0 = time.perf_counter()
        engine.count_programs([program], min_bucket=bucket)
        latencies.append(time.perf_counter() - t0)
    latencies.sort()
    p50 = latencies[len(latencies) // 2]

    # Mutations over the dense bank: warm on one selective filter, time
    # another (full/empty filters take the stored-cardinality fast path)
    selective = [q for q, c in zip(queries, counts) if 0 < c < n_rows]
    selective = (selective + queries)[:2]
    engine.mutation_counts("nuc", "main", engine.evaluate(selective[0].filter))
    words = engine.evaluate(selective[1].filter)
    t0 = time.perf_counter()
    engine.mutation_counts("nuc", "main", words)
    mutations_s = time.perf_counter() - t0
    meta = engine.segment_meta[("nuc", "main")]
    seg_bytes = meta["n_stored"] * engine.n_flat_words * 4
    log(f"mutations: {mutations_s * 1e3:.1f} ms over "
        f"{seg_bytes / 1e9:.2f} GB of dense rows")

    # Throughput: the query mix, rotated into distinct wide dispatches
    # that pipeline (issued without blocking, pulled at the end)
    group_width = max(1, min(de.MAX_BATCH_QUERIES // len(programs), 8))
    big_bucket = next((b for b in de._BATCH_LEN_BUCKETS
                       if b >= group_width * total_len),
                      de._BATCH_LEN_BUCKETS[-1])

    def make_group(base_rot):
        progs, want = [], []
        for j in range(group_width):
            rot = (base_rot + j) % len(programs)
            progs.extend(programs[rot:] + programs[:rot])
            want.extend(counts[rot:] + counts[:rot])
        return progs, want

    engine.count_programs(make_group(0)[0], min_bucket=big_bucket,
                          min_sparse_k=min_k, min_sparse_e=min_e)

    def throughput_pass(pass_idx):
        in_flight, wants = [], []
        t_start = time.perf_counter()
        for g in range(3):
            progs, want = make_group((pass_idx * 3 + g) * group_width)
            in_flight.extend(engine.count_dispatches(progs, big_bucket,
                                                     min_k, min_e))
            wants.extend(want)
        for arr, _n in in_flight:
            arr.copy_to_host_async()
        got = [int(c) for arr, n in in_flight for c in np.asarray(arr)[:n]]
        total = time.perf_counter() - t_start
        assert got == wants, (got[:8], wants[:8])
        return len(wants) / total

    profile_dir = os.environ.get("SILO_BENCH_PROFILE")
    if profile_dir:
        jax.profiler.start_trace(profile_dir)
    gc.collect()
    gc.freeze()
    gc.disable()
    try:
        pass_qps = [throughput_pass(i) for i in range(n_passes)]
    finally:
        gc.enable()
        gc.unfreeze()
        if profile_dir:
            jax.profiler.stop_trace()
            log(f"profiler trace written to {profile_dir}")
    spread = sorted(pass_qps)
    qps = spread[len(spread) // 2]
    log(f"throughput passes: median={qps:.0f} min={spread[0]:.0f} "
        f"max={spread[-1]:.0f} (all: {[round(p) for p in pass_qps]})")
    log(f"queries: {len(queries)}  p50={p50 * 1e3:.2f} ms  "
        f"counts[:5]={counts[:5]}")

    print(json.dumps({
        "metric": "mutation_filter_count_queries_per_sec",
        "value": round(qps, 2),
        "unit": f"queries/s ({n_rows} seqs x {length} pos, batch "
                f"{len(queries)}, 1 device)",
        "vs_baseline": None,
        "device": {"platform": device.platform,
                   "kind": device.device_kind,
                   "count": len(jax.devices())},
    }))
    sys.stdout.flush()


if __name__ == "__main__":
    main()
