"""Device filter VM vs host evaluator: bit-identical results, no fallback."""

import json
import os

import numpy as np
import pytest

from .conftest import REFERENCE_ROOT

QUERIES_DIR = os.path.join(REFERENCE_ROOT, "endToEndTests/test/queries")

REPRESENTATIVE = [
    {"type": "True"},
    {"type": "NucleotideEquals", "position": 25, "symbol": "T"},
    {"type": "And", "children": [
        {"type": "StringEquals", "column": "country", "value": "Switzerland"},
        {"type": "Not", "child": {"type": "NucleotideEquals", "position": 25, "symbol": "T"}},
    ]},
    {"type": "N-Of", "numberOfMatchers": 2, "matchExactly": False, "children": [
        {"type": "NucleotideEquals", "position": 241, "symbol": "T"},
        {"type": "NucleotideEquals", "position": 3037, "symbol": "T"},
        {"type": "NucleotideEquals", "position": 14408, "symbol": "T"},
    ]},
    # threshold-circuit edges: k == n (all), exact match, negated child,
    # nested N-Of, single child
    {"type": "N-Of", "numberOfMatchers": 3, "matchExactly": False, "children": [
        {"type": "NucleotideEquals", "position": 241, "symbol": "T"},
        {"type": "NucleotideEquals", "position": 3037, "symbol": "T"},
        {"type": "NucleotideEquals", "position": 14408, "symbol": "T"},
    ]},
    {"type": "N-Of", "numberOfMatchers": 2, "matchExactly": True, "children": [
        {"type": "NucleotideEquals", "position": 241, "symbol": "T"},
        {"type": "Not", "child": {"type": "NucleotideEquals", "position": 3037,
                                  "symbol": "T"}},
        {"type": "NucleotideEquals", "position": 14408, "symbol": "T"},
        {"type": "StringEquals", "column": "country", "value": "Switzerland"},
    ]},
    {"type": "N-Of", "numberOfMatchers": 2, "matchExactly": False, "children": [
        {"type": "N-Of", "numberOfMatchers": 1, "matchExactly": True,
         "children": [
             {"type": "NucleotideEquals", "position": 241, "symbol": "T"},
             {"type": "NucleotideEquals", "position": 3037, "symbol": "T"},
         ]},
        {"type": "NucleotideEquals", "position": 14408, "symbol": "T"},
        {"type": "DateBetween", "column": "date", "from": "2021-01-01",
         "to": "2021-06-01"},
    ]},
    {"type": "Maybe", "child": {"type": "NucleotideEquals", "position": 26, "symbol": "A"}},
    {"type": "IntBetween", "column": "age", "from": 20, "to": 70},
    {"type": "FloatBetween", "column": "qc_value", "from": 0.9, "to": 0.99},
    {"type": "DateBetween", "column": "date", "from": "2021-01-01", "to": "2021-03-31"},
    {"type": "PangoLineage", "column": "pango_lineage", "value": "B.1.1.7",
     "includeSublineages": True},
    {"type": "InsertionContains", "column": "nucleotideInsertions",
     "position": 25701, "value": "CC.*"},
]


@pytest.mark.parametrize("filter_json", REPRESENTATIVE, ids=lambda f: f["type"])
def test_device_matches_host(example_dataset_db, filter_json):
    from lapis_silo_tpu.ops.device_engine import DeviceEngine
    from lapis_silo_tpu.query import ast
    from lapis_silo_tpu.query.engine import Query
    from lapis_silo_tpu.query.ir import HostEvaluator

    db = example_dataset_db
    query = Query(json.dumps({"filterExpression": filter_json,
                              "action": {"type": "Aggregated"}}))
    engine = DeviceEngine(db)
    device_words = engine.evaluate(query.filter)  # raises on fallback
    for partition, words in zip(db.partitions, device_words):
        node = query.filter.compile(db, partition, ast.NONE)
        host_words = HostEvaluator(partition.sequence_count).evaluate(node)
        np.testing.assert_array_equal(words, host_words, err_msg=str(filter_json))


def test_host_count_fast_paths(example_dataset_db):
    """host_count answers single-leaf and metadata-only counts without a
    dispatch, bit-identical to the device/oracle path."""
    from lapis_silo_tpu.ops.device_engine import DeviceEngine
    from lapis_silo_tpu.query.engine import Query
    from lapis_silo_tpu.query.ir import HostEvaluator
    from lapis_silo_tpu.ops import bitset

    engine = DeviceEngine(example_dataset_db)
    host_answerable = [
        {"type": "True"},
        {"type": "False"},
        {"type": "NucleotideEquals", "position": 25, "symbol": "T"},
        {"type": "NucleotideEquals", "position": 25, "symbol": "."},
        {"type": "AminoAcidEquals", "position": 4, "symbol": "L",
         "sequenceName": "E"},
        {"type": "StringEquals", "column": "country", "value": "Switzerland"},
        {"type": "And", "children": [
            {"type": "StringEquals", "column": "country", "value": "Switzerland"},
            {"type": "IntBetween", "column": "age", "from": 20, "to": 70},
        ]},
        {"type": "DateBetween", "column": "date", "from": "2021-01-01",
         "to": "2021-03-31"},
    ]
    for filter_json in host_answerable + REPRESENTATIVE:
        query = Query(json.dumps({"filterExpression": filter_json,
                                  "action": {"type": "Aggregated"}}))
        program, _ = engine.lower(query.filter)
        got = engine.host_count(program)
        # oracle: per-partition host evaluation
        want = 0
        db = example_dataset_db
        db.uniform_compile = True
        try:
            from lapis_silo_tpu.query import ast
            for partition in db.partitions:
                ir_node = query.filter.compile(db, partition, ast.NONE)
                want += int(bitset.popcount(
                    HostEvaluator(partition.sequence_count).evaluate(ir_node)))
        finally:
            db.uniform_compile = False
        if got is not None:
            assert got == want, filter_json
        # count_programs must agree regardless of which path answered
        assert engine.count_programs([program]) == [want], filter_json
    # the plain-leaf and metadata-only cases must actually take the fast path
    for filter_json in host_answerable:
        query = Query(json.dumps({"filterExpression": filter_json,
                                  "action": {"type": "Aggregated"}}))
        program, _ = engine.lower(query.filter)
        assert engine.host_count(program) is not None, filter_json


def test_evaluate_compact_matches_evaluate():
    """Fused nonzero-word extraction (compact output mode) returns the
    same per-partition bitsets as the full pull — selective, wide (cap
    overflow fallback), trivial, and empty filters."""
    import json

    from lapis_silo_tpu.ops.device_engine import DeviceEngine
    from lapis_silo_tpu.query.engine import Query
    from lapis_silo_tpu.testing import synthetic_database

    db = synthetic_database(n_rows=2048, length=512, n_partitions=2, seed=5)
    engine = DeviceEngine(db)
    engine.COMPACT_MIN_WORDS = 0  # force the compact path on a small corpus
    filters = [
        {"type": "NucleotideEquals", "position": 17, "symbol": "A"},
        {"type": "HasNucleotideMutation", "position": 300},
        {"type": "Not", "child": {"type": "HasNucleotideMutation",
                                  "position": 3}},  # wide: overflows caps
        {"type": "True"},
        {"type": "False"},
        {"type": "And", "children": [
            {"type": "StringEquals", "column": "country", "value": "Spain"},
            {"type": "IntBetween", "column": "age", "from": 10, "to": 30}]},
    ]
    for cap in (8, 16384):
        engine.COMPACT_CAP_WORDS = cap
        for f in filters:
            flt = Query(json.dumps({"filterExpression": f,
                                    "action": {"type": "Aggregated"}})).filter
            got = engine.evaluate_compact(flt)
            want = engine.evaluate(flt)
            assert len(got) == len(want)
            for g, w in zip(got, want):
                import numpy as np

                np.testing.assert_array_equal(g, w, err_msg=f"{f} cap={cap}")
