"""Two-tier device bank: force the sparse tier (CSR-of-words stream +
PUSH_SPARSE densify-scatter) and check bit-identical results vs the host
oracle and the all-dense engine."""

import json

import numpy as np
import pytest

from .conftest import reference_available

pytestmark = pytest.mark.skipif(
    not reference_available(), reason="reference test data not available"
)

FILTERS = [
    {"type": "True"},
    {"type": "NucleotideEquals", "position": 25, "symbol": "T"},
    {"type": "NucleotideEquals", "position": 25, "symbol": "C"},  # majority leaf
    {"type": "HasNucleotideMutation", "position": 241},
    {"type": "And", "children": [
        {"type": "NucleotideEquals", "position": 241, "symbol": "T"},
        {"type": "Not", "child": {"type": "NucleotideEquals", "position": 25, "symbol": "T"}},
    ]},
    {"type": "N-Of", "numberOfMatchers": 2, "matchExactly": True, "children": [
        {"type": "NucleotideEquals", "position": 241, "symbol": "T"},
        {"type": "NucleotideEquals", "position": 3037, "symbol": "T"},
        {"type": "NucleotideEquals", "position": 14408, "symbol": "T"},
    ]},
    {"type": "Maybe", "child": {"type": "NucleotideEquals", "position": 26, "symbol": "A"}},
    {"type": "StringEquals", "column": "country", "value": "Switzerland"},
]


@pytest.fixture(scope="module")
def sparse_engine(example_dataset_db):
    from lapis_silo_tpu.ops.device_engine import DeviceEngine

    engine = DeviceEngine(example_dataset_db, sparse_min_words=1)
    assert engine.n_sparse > 0, "sparse tier not active"
    return engine


@pytest.fixture(scope="module")
def dense_engine(example_dataset_db):
    from lapis_silo_tpu.ops.device_engine import DeviceEngine

    return DeviceEngine(example_dataset_db)


@pytest.mark.parametrize("filter_json", FILTERS,
                         ids=lambda f: json.dumps(f)[:40])
def test_sparse_filter_matches_host(example_dataset_db, sparse_engine, filter_json):
    from lapis_silo_tpu.query import ast
    from lapis_silo_tpu.query.engine import Query
    from lapis_silo_tpu.query.ir import HostEvaluator

    db = example_dataset_db
    query = Query(json.dumps({"filterExpression": filter_json,
                              "action": {"type": "Aggregated"}}))
    device_words = sparse_engine.evaluate(query.filter)
    for partition, words in zip(db.partitions, device_words):
        node = query.filter.compile(db, partition, ast.NONE)
        host_words = HostEvaluator(partition.sequence_count).evaluate(node)
        np.testing.assert_array_equal(words, host_words, err_msg=str(filter_json))


def test_sparse_count_batch(example_dataset_db, sparse_engine, dense_engine):
    from lapis_silo_tpu.query.engine import Query

    queries = [Query(json.dumps({"filterExpression": f,
                                 "action": {"type": "Aggregated"}})).filter
               for f in FILTERS]
    got = sparse_engine.count_batch(queries)
    expected = [dense_engine.count(q) for q in queries]
    assert got == expected


def test_sparse_mutation_counts(example_dataset_db, sparse_engine, dense_engine):
    from lapis_silo_tpu.query.engine import Query

    query = Query(json.dumps({
        "filterExpression": {"type": "StringEquals", "column": "country",
                             "value": "Switzerland"},
        "action": {"type": "Aggregated"}}))
    filter_words = dense_engine.evaluate(query.filter)
    for kind, name in sparse_engine.segment_meta:
        got = sparse_engine.mutation_counts(kind, name, filter_words)
        expected = dense_engine.mutation_counts(kind, name, filter_words)
        np.testing.assert_array_equal(got, expected, err_msg=f"{kind}:{name}")


def test_sparse_tier_memory_is_smaller(sparse_engine, dense_engine):
    # the whole point: the sparse engine's dense bank holds far fewer rows
    assert sparse_engine.n_rows < dense_engine.n_rows / 2


def test_sparse_gate_uses_total_row_footprint():
    """The tier activates on partitions x words (a bank row's total bytes),
    so a 16-partition corpus is judged like the single-partition corpus of
    the same size (device_engine.py sparse_min_words / DENSE_BANK_SHARE)."""
    from lapis_silo_tpu.ops.device_engine import DeviceEngine
    from lapis_silo_tpu.testing import synthetic_database

    db = synthetic_database(n_rows=512, length=64, n_partitions=4)
    probe = DeviceEngine(db, sparse_min_words=1)
    footprint = probe.n_partitions * probe.n_words  # incl. device padding
    assert footprint > probe.n_words  # multi-partition: product > per-part W
    assert DeviceEngine(db, sparse_min_words=footprint).sparse_enabled
    assert not DeviceEngine(db, sparse_min_words=footprint + 1).sparse_enabled


def test_sparse_kernel_path_matches_dense(example_dataset_db, dense_engine,
                                          vm_kernel_reference):
    """The GPU configuration for sparse corpora — the XLA densify feeding
    the VM kernel's wrapper (kernel replaced by its reference) — must be
    bit-identical to the plain dense engine."""
    from lapis_silo_tpu.ops import device_engine as de
    from lapis_silo_tpu.query.engine import Query

    import jax

    engine = de.DeviceEngine(example_dataset_db, sparse_min_words=1,
                             devices=jax.devices()[:1])
    assert engine.n_sparse > 0 and engine.mesh is None

    queries = [Query(json.dumps({"filterExpression": f,
                                 "action": {"type": "Aggregated"}}))
               for f in FILTERS]
    batch = [q.filter for q in queries]
    assert engine.count_batch(batch) == dense_engine.count_batch(batch)


def _pool_engine(example_dataset_db, monkeypatch, budget_slots=None):
    from lapis_silo_tpu.ops import device_engine as de

    import jax

    if budget_slots is not None:
        # translate a slot count into the GB knob (row size known post-init
        # only; probe once)
        probe = de.DeviceEngine(example_dataset_db, sparse_min_words=1,
                                devices=jax.devices()[:1])
        row_bytes = 4 * probe.n_flat_words
        monkeypatch.setenv("SILO_LEAF_POOL_GB",
                           repr(budget_slots * row_bytes / 2**30))
    engine = de.DeviceEngine(example_dataset_db, sparse_min_words=1,
                             devices=jax.devices()[:1])
    assert engine.pool_slots > 0, "leaf pool inactive"
    return engine


def test_leaf_pool_caches_across_batches(example_dataset_db, dense_engine,
                                         monkeypatch):
    """Second identical batch must answer entirely from resident pool rows:
    zero new densify work, bit-identical counts (the dynamic hot-leaf form
    of per-row dense/sparse placement)."""
    from lapis_silo_tpu.query.engine import Query

    engine = _pool_engine(example_dataset_db, monkeypatch)
    batch = [Query(json.dumps({"filterExpression": f,
                               "action": {"type": "Aggregated"}})).filter
             for f in FILTERS]
    want = dense_engine.count_batch(batch)
    first = engine.count_batch(batch)
    assert first == want
    updates = engine.pool_update_dispatches + engine.pool_fused_chunks
    assert updates > 0, "pool update never ran"
    misses = engine.pool_misses
    second = engine.count_batch(batch)
    assert second == want
    assert engine.pool_misses == misses, "warm batch missed the pool"
    assert (engine.pool_update_dispatches + engine.pool_fused_chunks
            == updates), "warm batch re-densified"


def test_pool_update_k_cap_splits_miss_bursts(example_dataset_db,
                                              dense_engine, monkeypatch):
    """A miss burst wider than the update K cap (the densify-block cap)
    must split into K-capped update chunks, none padded past the cap's
    bucket. Up to _POOL_CHUNK_BUCKETS[-1] chunks fuse into the VM
    dispatch; the overflow runs as eager _pool_update_jit dispatches."""
    from lapis_silo_tpu.ops import device_engine as de
    from lapis_silo_tpu.query.engine import Query

    engine = _pool_engine(example_dataset_db, monkeypatch)
    assert engine._pool_update_k_cap == engine.max_sparse_k
    engine._pool_update_k_cap = 4  # force splitting with a tiny cap
    engine.max_sparse_k = 1        # poolless route can never win -> pooled
    monkeypatch.setattr(de.vm, "_POOL_CHUNK_BUCKETS", (0, 1))
    de.vm._pooled_update_vm_jit.cache_clear()
    seen_k = []
    real_jit = de._pool_update_jit

    def counting_jit(k_bucket, n_partitions, n_words, mesh=None,
                     e_budget=0):
        run = real_jit(k_bucket, n_partitions, n_words, mesh, e_budget)

        def wrapper(*args, **kwargs):
            seen_k.append(k_bucket)
            return run(*args, **kwargs)

        return wrapper

    monkeypatch.setattr(de, "_pool_update_jit", counting_jit)
    filters = [{"type": "Or", "children": [
        {"type": "NucleotideEquals", "position": 3000 + i * 11 + 1,
         "symbol": s} for i in range(16) for s in ("A", "C", "T", "G")
    ]}]
    batch = [Query(json.dumps({"filterExpression": f,
                               "action": {"type": "Aggregated"}})).filter
             for f in filters]
    got = engine.count_batch(batch)
    want = dense_engine.count_batch(batch)
    assert got == want
    assert seen_k, "overflow chunks never dispatched eagerly"
    assert all(k <= 4 for k in seen_k), seen_k
    assert engine.pool_fused_chunks > 0, "no chunk fused into the VM"
    de._interpreter.cache_clear()
    real_jit.cache_clear()


def test_pool_scan_resistance(example_dataset_db, dense_engine, monkeypatch):
    """Segmented LRU: a cold scan (every leaf touched once) must not flush
    the repeatedly-hit working set. Hot leaves promoted by a second touch
    survive scan rounds that overflow the pool; the hot re-run misses
    nothing and stays bit-identical."""
    from lapis_silo_tpu.ops import device_engine as de
    from lapis_silo_tpu.query.engine import Query

    engine = _pool_engine(example_dataset_db, monkeypatch,
                                    budget_slots=64)

    def filt(f):
        return Query(json.dumps({"filterExpression": f,
                                 "action": {"type": "Aggregated"}})).filter

    # discover positions whose filters really carry sparse leaves (most
    # positions in the 100-seq corpus have no variation and lower to
    # constants — no device work, nothing pooled)
    leafy = []
    total_leaves = 0
    for pos in range(1, 29904, 7):
        f = {"type": "HasNucleotideMutation", "position": pos}
        program, _ = engine.lower(filt(f))
        if program.sparse_leaves:
            leafy.append(f)
            total_leaves += len(program.sparse_leaves)
        if total_leaves > 4 * engine.pool_slots:
            break
    assert total_leaves > 4 * engine.pool_slots, (
        "corpus too uniform for a scan test")
    hot_f, scan_fs = leafy[:2], leafy[2:]
    hot = [filt(f) for f in hot_f]
    want_hot = dense_engine.count_batch(hot)
    assert engine.count_batch(hot) == want_hot   # touch 1: probation
    assert engine.count_batch(hot) == want_hot   # touch 2: promoted
    hot_resident = set(engine._leaf_slot)
    assert hot_resident & set(engine._protected), "no promotion happened"
    # scan: every remaining leafy filter once — several pool-loads of
    # one-touch leaves
    for i in range(0, len(scan_fs), 8):
        scan = [filt(f) for f in scan_fs[i : i + 8]]
        assert engine.count_batch(scan) == dense_engine.count_batch(scan)
    m0 = engine.pool_misses
    assert engine.count_batch(hot) == want_hot
    assert engine.pool_misses == m0, (
        "scan evicted the protected working set")
    de._interpreter.cache_clear()


def test_leaf_pool_eviction_stays_correct(example_dataset_db, dense_engine,
                                          monkeypatch):
    """A pool far smaller than the leaf universe must evict and refill
    without ever answering wrong: cycle query sets that overflow it."""
    from lapis_silo_tpu.ops import device_engine as de
    from lapis_silo_tpu.query.engine import Query

    engine = _pool_engine(example_dataset_db, monkeypatch,
                                    budget_slots=64)
    assert engine.pool_slots == 64
    rounds = []
    for base in (100, 2000, 4000, 100, 2000):
        rounds.append([
            {"type": "Or", "children": [
                {"type": "NucleotideEquals", "position": base + i * 7 + 1,
                 "symbol": s} for i in range(4) for s in ("A", "T")
            ]}
        ])
    for filters in rounds:
        batch = [Query(json.dumps({"filterExpression": f,
                                   "action": {"type": "Aggregated"}})).filter
                 for f in filters]
        got = engine.count_batch(batch)
        want = dense_engine.count_batch(batch)
        assert got == want, filters
    assert len(engine._leaf_slot) <= engine.pool_slots
    de._interpreter.cache_clear()


def test_cold_sweep_bypasses_pool(example_dataset_db, dense_engine,
                                  monkeypatch):
    """A batch whose leaf set is mostly misses AND larger than
    max_sparse_k rides the fused-densify path: counts stay exact, NO pool
    updates run, and previously resident hot leaves stay resident (a
    full-corpus sweep must not churn the serving working set)."""
    import json

    from lapis_silo_tpu.ops import device_engine as de
    from lapis_silo_tpu.query.engine import Query

    engine = _pool_engine(example_dataset_db, monkeypatch)
    engine.max_sparse_k = 4       # tiny cap: 5+ distinct cold leaves trip it
    engine._pool_update_k_cap = 1  # pooled route would cost 1 dispatch/miss

    # resident hot set: one small batch, leaves enter the pool (an Or of
    # two leaves — a single leaf answers from stored cardinalities with
    # no dispatch and would never touch the pool)
    hot = [Query(json.dumps({
        "filterExpression": {"type": "Or", "children": [
            {"type": "NucleotideEquals", "position": 3001, "symbol": "A"},
            {"type": "NucleotideEquals", "position": 3012, "symbol": "T"},
        ]},
        "action": {"type": "Aggregated"}})).filter]
    engine.count_batch(hot)
    hot_resident = dict(engine._leaf_slot)
    assert hot_resident, "hot leaves never became resident"
    updates_before = engine.pool_update_dispatches

    cold = [Query(json.dumps({
        "filterExpression": {"type": "Or", "children": [
            {"type": "NucleotideEquals", "position": 3000 + i * 17 + 1,
             "symbol": s} for i in range(8) for s in ("A", "C", "T", "G")
        ]},
        "action": {"type": "Aggregated"}})).filter]
    lowered = [engine.lower(f)[0] for f in cold]
    distinct = {r for p in lowered for r in p.sparse_leaves}
    assert len(distinct) > engine.max_sparse_k, "cold set too small"

    got = engine.count_batch(cold)
    want = dense_engine.count_batch(cold)
    assert got == want
    assert engine.pool_update_dispatches == updates_before, \
        "cold sweep ran pool updates instead of bypassing"
    assert dict(engine._leaf_slot) == hot_resident, \
        "cold sweep churned the resident hot set"

    # the hot batch still answers from the pool, bit-identical
    assert engine.count_batch(hot) == dense_engine.count_batch(hot)
    de._interpreter.cache_clear()
