"""DeviceEngine with the word axis sharded over 8 virtual CPU devices must
be bit-identical to the single-device engine."""

import json

import jax
import numpy as np
import pytest


@pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 virtual devices")
def test_sharded_engine_matches_single_device():
    from lapis_silo_tpu.ops.device_engine import DeviceEngine
    from lapis_silo_tpu.query.engine import Query
    from lapis_silo_tpu.testing import sample_count_queries, synthetic_database

    db = synthetic_database(n_rows=2048, length=256, n_partitions=3)
    single = DeviceEngine(db, devices=jax.devices()[:1])
    sharded = DeviceEngine(db, devices=jax.devices()[:8])
    assert sharded.mesh is not None
    queries = [Query(q) for q in sample_count_queries(db, 16)]
    for query in queries:
        assert single.count(query.filter) == sharded.count(query.filter)
    batch = [q.filter for q in queries]
    assert single.count_batch(batch) == sharded.count_batch(batch)
    # mutation histogram across the mesh
    filt = Query(json.dumps({"action": {"type": "Aggregated"},
                             "filterExpression": {"type": "True"}})).filter
    words_single = single.evaluate(filt)
    words_sharded = sharded.evaluate(filt)
    for a, b in zip(words_single, words_sharded):
        np.testing.assert_array_equal(a, b)
    m1 = single.mutation_counts("nuc", "main", words_single)
    m2 = sharded.mutation_counts("nuc", "main", words_sharded)
    np.testing.assert_array_equal(m1, m2)


@pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 virtual devices")
def test_sharded_engine_sparse_tier_matches_single_device():
    """Two-tier bank over the mesh: the sparse CSR stream + densify path
    must stay bit-identical when the word axis is sharded."""
    from lapis_silo_tpu.ops.device_engine import DeviceEngine
    from lapis_silo_tpu.query.engine import Query
    from lapis_silo_tpu.testing import sample_count_queries, synthetic_database

    db = synthetic_database(n_rows=2048, length=256, n_partitions=3,
                            mutations_per_genome=2)
    single = DeviceEngine(db, devices=jax.devices()[:1], sparse_min_words=1)
    sharded = DeviceEngine(db, devices=jax.devices()[:8], sparse_min_words=1)
    assert sharded.mesh is not None and sharded.n_sparse > 0
    queries = [Query(q) for q in sample_count_queries(db, 12)]
    batch = [q.filter for q in queries]
    assert single.count_batch(batch) == sharded.count_batch(batch)
    filt = Query(json.dumps({"action": {"type": "Aggregated"},
                             "filterExpression": {"type": "True"}})).filter
    m1 = single.mutation_counts("nuc", "main", single.evaluate(filt))
    m2 = sharded.mutation_counts("nuc", "main", sharded.evaluate(filt))
    np.testing.assert_array_equal(m1, m2)


@pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 virtual devices")
def test_sharded_pool_and_sparse_mutations_kernel(monkeypatch):
    """Mesh scale tier: the hot-leaf pool (word-sharded like the bank,
    window-local sharded updates, pool-resident VM reads) and the sharded
    sparse-Mutations reduction (entry-split XLA gather + psum) must run on
    the 8-device mesh — spy-asserted — and stay bit-exact vs the
    single-device engine."""
    from lapis_silo_tpu.ops import device_engine as de
    from lapis_silo_tpu.ops import reductions
    from lapis_silo_tpu.query.engine import Query
    from lapis_silo_tpu.testing import sample_count_queries, synthetic_database

    calls = {"pool_update_mesh": 0, "sparse_mutations_sharded": 0}
    real_pool_jit = de._pool_update_jit

    def spy_pool_jit(k_bucket, n_partitions, n_words, mesh=None,
                     e_budget=0):
        if mesh is not None:
            calls["pool_update_mesh"] += 1
        return real_pool_jit(k_bucket, n_partitions, n_words, mesh,
                             e_budget)

    real_sharded = reductions._sparse_mutation_counts_sharded_jit

    def spy_sharded(*args, **kwargs):
        calls["sparse_mutations_sharded"] += 1
        return real_sharded(*args, **kwargs)

    monkeypatch.setattr(de, "_pool_update_jit", spy_pool_jit)
    monkeypatch.setattr(reductions, "_sparse_mutation_counts_sharded_jit",
                        spy_sharded)
    db = synthetic_database(n_rows=2048, length=256, n_partitions=3,
                            mutations_per_genome=2)
    single = de.DeviceEngine(db, devices=jax.devices()[:1],
                             sparse_min_words=1)
    sharded = de.DeviceEngine(db, devices=jax.devices()[:8],
                              sparse_min_words=1)
    assert sharded.mesh is not None and sharded.n_sparse > 0
    assert sharded.pool_slots > 0, "mesh pool must be active"
    queries = [Query(q) for q in sample_count_queries(db, 12)]
    batch = [q.filter for q in queries]
    want = single.count_batch(batch)
    assert sharded.count_batch(batch) == want
    assert calls["pool_update_mesh"] > 0, \
        "sharded pool update never dispatched"
    misses_after_cold = sharded.pool_misses
    # repeat: the same leaves must now be pool hits, not re-densified
    assert sharded.count_batch(batch) == want
    assert sharded.pool_hits > 0, "no pool-resident reads"
    assert sharded.pool_misses == misses_after_cold, \
        "hot leaves re-densified"
    filt = Query(json.dumps({
        "action": {"type": "Aggregated"},
        "filterExpression": {"type": "HasNucleotideMutation",
                             "position": 7}})).filter
    m1 = single.mutation_counts("nuc", "main", single.evaluate(filt))
    m2 = sharded.mutation_counts("nuc", "main", sharded.evaluate(filt))
    np.testing.assert_array_equal(m1, m2)
    assert calls["sparse_mutations_sharded"] > 0, \
        "sharded sparse-Mutations reduction never reached"


def _oracle_count(db, filter_expr):
    from lapis_silo_tpu.ops import bitset
    from lapis_silo_tpu.query import ast
    from lapis_silo_tpu.query.ir import HostEvaluator

    total = 0
    db.uniform_compile = True
    try:
        for partition in db.partitions:
            node = filter_expr.compile(db, partition, ast.NONE)
            total += int(bitset.popcount(
                HostEvaluator(partition.sequence_count).evaluate(node)))
    finally:
        db.uniform_compile = False
    return total


@pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 virtual devices")
@pytest.mark.parametrize("sparse", [False, True])
def test_sharded_engine_kernel_path_matches_xla(vm_kernel_reference,
                                                monkeypatch, sparse):
    """The mesh engine on the GPU path (the VM kernel's wrapper under
    shard_map, the kernel replaced by its jnp reference) must match the
    host oracle bit for bit — dense, and two-tier with the pool."""
    from lapis_silo_tpu.ops.device_engine import DeviceEngine
    from lapis_silo_tpu.query.engine import Query
    from lapis_silo_tpu.testing import sample_count_queries, synthetic_database

    calls = {"sharded": 0}
    real = vm_kernel_reference.vm_run_sharded

    def spy(*args, **kwargs):
        calls["sharded"] += 1
        return real(*args, **kwargs)

    monkeypatch.setattr(vm_kernel_reference, "vm_run_sharded", spy)
    db = synthetic_database(n_rows=2048, length=256, n_partitions=3,
                            mutations_per_genome=2 if sparse else 30)
    kernel = DeviceEngine(db, devices=jax.devices()[:8],
                          sparse_min_words=1 if sparse else None)
    assert kernel.mesh is not None and kernel.bank.ndim == 2
    assert (kernel.n_sparse > 0) == sparse
    queries = [Query(q) for q in sample_count_queries(db, 12)]
    batch = [q.filter for q in queries]
    want = [_oracle_count(db, f) for f in batch]
    assert kernel.count_batch(batch) == want
    assert kernel.count_batch(batch) == want  # pool-resident repeat
    assert calls["sharded"] > 0, "vm_run_sharded was never reached"


@pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 virtual devices")
def test_conformance_corpus_through_vm_run_sharded(example_dataset_db,
                                                   vm_kernel_reference,
                                                   monkeypatch):
    """End-to-end conformance sample on the GPU path's mesh form: the
    exampleDataset corpus executed through the VM kernel wrapper under
    shard_map over the 8-device mesh (kernel replaced by its reference)
    must produce the reference's exact expected responses."""
    import os

    from .test_conformance import QUERIES_DIR, deep_equal

    from lapis_silo_tpu.ops import device_engine as de
    from lapis_silo_tpu.query.engine import QueryEngine

    calls = {"sharded": 0}
    real = vm_kernel_reference.vm_run_sharded

    def spy(*args, **kwargs):
        calls["sharded"] += 1
        return real(*args, **kwargs)

    monkeypatch.setattr(vm_kernel_reference, "vm_run_sharded", spy)
    db = example_dataset_db
    saved_engine = db._engine
    saved_device_engine = getattr(db, "device_engine", None)
    try:
        db._engine = None
        engine = QueryEngine(db)
        kernel_engine = de.DeviceEngine(db, devices=jax.devices()[:8])
        assert kernel_engine.mesh is not None
        engine._device_engine = kernel_engine
        db.device_engine = kernel_engine
        sample = [
            "And.json", "nOf_2of3_aggregated.json", "HasAAMutation.json",
            "nOf_2of3_mutations.json", "sequenceStartEndMutations.json",
            "GroupByLineageOrderByCountLimit.json", "DetailsOrderByLimit.json",
            "fastaAligned.json", "insertionsAction.json", "Maybe.json",
        ]
        ran = 0
        for case_file in sample:
            path = os.path.join(QUERIES_DIR, case_file)
            if not os.path.exists(path):
                continue
            with open(path) as f:
                case = json.load(f)
            response = engine.execute(json.dumps(case["query"]))
            deep_equal({"queryResult": case["expectedQueryResult"]},
                       response, case_file)
            ran += 1
        assert ran >= 8, f"only {ran} corpus cases found"
        assert calls["sharded"] > 0, "vm_run_sharded was never reached"
    finally:
        db._engine = saved_engine
        db.device_engine = saved_device_engine
