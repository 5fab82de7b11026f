"""Serving micro-batcher: concurrent count queries coalesce into batched
device dispatches with per-query results identical to the unbatched path."""

import json
import threading

import pytest

from .conftest import reference_available

pytestmark = pytest.mark.skipif(
    not reference_available(), reason="reference test data not available"
)

FILTERS = [
    {"type": "True"},
    {"type": "False"},
    {"type": "NucleotideEquals", "position": 25, "symbol": "T"},
    {"type": "StringEquals", "column": "country", "value": "Switzerland"},
    {"type": "And", "children": [
        {"type": "NucleotideEquals", "position": 241, "symbol": "T"},
        {"type": "Not", "child": {"type": "NucleotideEquals", "position": 25, "symbol": "T"}},
    ]},
    {"type": "DateBetween", "column": "date", "from": "2021-01-01", "to": "2021-03-31"},
    {"type": "HasNucleotideMutation", "position": 25},
    {"type": "IntBetween", "column": "age", "from": 20, "to": 70},
]


def _expected_counts(db):
    from lapis_silo_tpu.ops.device_engine import DeviceEngine
    from lapis_silo_tpu.query.engine import Query

    engine = DeviceEngine(db)
    out = []
    for f in FILTERS:
        q = Query(json.dumps({"filterExpression": f, "action": {"type": "Aggregated"}}))
        out.append(engine.count(q.filter))
    return engine, out


def test_coalesced_counts_match_unbatched(example_dataset_db):
    from lapis_silo_tpu.query.engine import Query

    engine, expected = _expected_counts(example_dataset_db)
    results = [None] * (len(FILTERS) * 4)
    errors = []

    def worker(i):
        f = FILTERS[i % len(FILTERS)]
        q = Query(json.dumps({"filterExpression": f, "action": {"type": "Aggregated"}}))
        try:
            results[i] = engine.count_coalesced(q.filter)
        except Exception as ex:  # noqa: BLE001
            errors.append(ex)

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(len(results))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors, errors
    for i, got in enumerate(results):
        assert got == expected[i % len(FILTERS)], FILTERS[i % len(FILTERS)]


def test_coalesced_error_isolation(example_dataset_db):
    """A query that can't lower to the device VM fails only its own caller;
    valid queries in the same batch still succeed."""
    from lapis_silo_tpu.query.engine import Query

    engine, expected = _expected_counts(example_dataset_db)

    # Build a program over the length limit: a 600-wide Or
    bad = {"type": "Or", "children": [
        {"type": "NucleotideEquals", "position": 25 + i, "symbol": "T"}
        for i in range(600)
    ]}
    bad_q = Query(json.dumps({"filterExpression": bad, "action": {"type": "Aggregated"}}))
    good_q = Query(json.dumps({"filterExpression": FILTERS[2],
                               "action": {"type": "Aggregated"}}))

    outcome = {}

    def run_bad():
        try:
            outcome["bad"] = engine.count_coalesced(bad_q.filter)
        except Exception as ex:  # noqa: BLE001
            outcome["bad_error"] = ex

    def run_good():
        outcome["good"] = engine.count_coalesced(good_q.filter)

    threads = [threading.Thread(target=run_bad), threading.Thread(target=run_good)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert outcome["good"] == expected[2]
    assert "bad_error" in outcome or isinstance(outcome.get("bad"), int)


def test_fast_count_path_still_exact(example_dataset_db):
    """QueryEngine's Aggregated fast path (now through the micro-batcher)
    matches the host action path."""
    import os

    from lapis_silo_tpu.query.engine import QueryEngine

    for f in FILTERS:
        q = json.dumps({"filterExpression": f, "action": {"type": "Aggregated"}})
        dev = QueryEngine(example_dataset_db, use_device=True).execute(q)
        os.environ["SILO_TPU_HOST_ONLY"] = "1"
        try:
            host = QueryEngine(example_dataset_db, use_device=False).execute(q)
        finally:
            os.environ.pop("SILO_TPU_HOST_ONLY", None)
        assert dev == host, f


def test_batch_split_fuzz(example_dataset_db, monkeypatch):
    """Wide batches that overflow the sparse-leaf cap / length buckets must
    split into sub-dispatches, pin to ladder rungs, and still return every
    query's count in order — fuzzed over random filter mixes with the caps
    shrunk so every split path triggers."""
    import numpy as np

    from lapis_silo_tpu.ops import device_engine as de
    from lapis_silo_tpu.query.engine import Query
    from lapis_silo_tpu.testing import sample_count_queries, synthetic_database

    db = synthetic_database(n_rows=768, length=512, n_partitions=3,
                            mutations_per_genome=4)
    engine = de.DeviceEngine(db, sparse_min_words=1)
    assert engine.n_sparse > 0
    # shrink the caps so a ~40-query batch crosses every split boundary
    monkeypatch.setattr(engine, "max_sparse_k", 16)
    engine.sparse_shape_ladder = [(4, 4096), (16, 32768)]
    rng = np.random.default_rng(3)
    for trial in range(4):
        queries = sample_count_queries(db, n_queries=40,
                                       seed=int(rng.integers(1 << 30)))
        programs = [engine.lower(Query(q).filter)[0] for q in queries]
        want = [engine.count(Query(q).filter) for q in queries]
        min_k, min_e = engine.sparse_floors(programs)
        got = engine.count_programs(programs, min_bucket=1024,
                                    min_sparse_k=min_k, min_sparse_e=min_e)
        assert got == want, trial
        # and through the raw dispatch API with no floors (rung auto-pin)
        got2 = engine.count_programs(
            [engine.lower(Query(q).filter)[0] for q in queries])
        assert got2 == want, trial


def test_wide_batch_single_dispatch_counts_exact():
    """A MAX_BATCH_QUERIES-wide batch (4096 queries, 65536-instruction
    bucket) packs into the expected dispatch count and returns counts
    identical to narrow batches — the wide-dispatch tier the bench and
    batched callers ride."""
    import jax

    from lapis_silo_tpu.ops import device_engine as de
    from lapis_silo_tpu.query.engine import Query
    from lapis_silo_tpu.testing import sample_count_queries, synthetic_database

    db = synthetic_database(n_rows=4096, length=512, n_partitions=2)
    engine = de.DeviceEngine(db, devices=jax.devices()[:1])
    base = [Query(q) for q in sample_count_queries(db, 512)]
    want_counts = engine.count_batch([q.filter for q in base])
    lowered = [engine.lower(q.filter)[0] for q in base]
    wide = []
    want = []
    for rot in range(8):  # 8 rotations -> 4096 queries
        wide.extend(lowered[rot:] + lowered[:rot])
        want.extend(want_counts[rot:] + want_counts[:rot])
    assert len(wide) == de.MAX_BATCH_QUERIES
    total_len = sum(len(p.opcodes) + 1 for p in wide)
    assert total_len <= de._BATCH_LEN_BUCKETS[-1], total_len
    dispatches = engine.count_dispatches(wide, de._BATCH_LEN_BUCKETS[-1])
    got = [int(c) for arr, nq in dispatches
           for c in __import__("numpy").asarray(arr)[:nq]]
    assert len(dispatches) == 1, "4096 queries must pack into ONE dispatch"
    assert got == want


def test_serving_max_bucket_splits_instead_of_compiling_wider():
    """Serving paths cap the instruction bucket (max_bucket=
    SERVE_LEN_BUCKET): a drained burst wider than the warmed executable
    SPLITS into multiple dispatches instead of landing on an unwarmed
    16384+ bucket (a minutes-long remote compile stall mid-serving)."""
    import jax
    import numpy as np

    from lapis_silo_tpu.ops import device_engine as de
    from lapis_silo_tpu.query.engine import Query
    from lapis_silo_tpu.testing import sample_count_queries, synthetic_database

    db = synthetic_database(n_rows=4096, length=512, n_partitions=2)
    engine = de.DeviceEngine(db, devices=jax.devices()[:1])
    base = [Query(q) for q in sample_count_queries(db, 512)]
    lowered = [engine.lower(q.filter)[0] for q in base] * 3  # 1536 queries
    total_len = sum(len(p.opcodes) + 1 for p in lowered)
    assert total_len > de.SERVE_LEN_BUCKET  # would otherwise pick 16384+
    results, device_idx, dispatches = engine.count_split(
        lowered, min_bucket=de.SERVE_LEN_BUCKET,
        max_bucket=de.SERVE_LEN_BUCKET)
    assert len(dispatches) >= 2, "burst must split at the serve bucket"
    for arr, _n in dispatches:
        assert arr.shape[0] == de.MAX_BATCH_QUERIES  # output vec shape
    counts = de.DeviceEngine.count_finish(results, device_idx, dispatches)
    want = engine.count_batch([q.filter for q in base])
    assert counts == want * 3
