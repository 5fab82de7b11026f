"""Exhaustive (expression type x action type) cross-product: every one of
the 21 query-expression types appears under every action kind at least once
per run, device engine vs host oracle."""

import json
import random

from tests.test_fuzz_actions import ACTION_KINDS, _canon, random_action
from tests.test_fuzz_filters import (
    ALL_EXPRESSION_TYPES,
    LEAF_KINDS,
    random_filter,
)

COMBINATOR_TYPES = {"And", "Or", "Not", "N-Of", "Maybe", "Exact"}


def test_every_expression_under_every_action():
    from lapis_silo_tpu.query.engine import QueryEngine
    from lapis_silo_tpu.testing import synthetic_database

    db_dev = synthetic_database(n_rows=640, length=222, n_partitions=2,
                                seed=77, rich=True)
    db_host = synthetic_database(n_rows=640, length=222, n_partitions=2,
                                 seed=77, rich=True)
    dev = QueryEngine(db_dev, use_device=True)
    host = QueryEngine(db_host, use_device=False)

    rng = random.Random(20260820)
    covered: set[tuple[str, str]] = set()
    for action_kind in ACTION_KINDS:
        for leaf_kind in LEAF_KINDS:
            action, mode = random_action(rng, action_kind)
            seen: set = set()
            filter_json = random_filter(rng, db_dev, force_leaf=leaf_kind,
                                        seen=seen)
            query = json.dumps({"filterExpression": filter_json,
                                "action": action})
            dev_rows = dev.execute(query)["queryResult"]
            host_rows = host.execute(query)["queryResult"]
            if mode == "exact":
                assert dev_rows == host_rows, query
            else:
                assert _canon(dev_rows) == _canon(host_rows), query
            for expr_type in seen:
                covered.add((expr_type, action["type"]))

    action_types = {a for _, a in covered}
    assert len(action_types) == 7, action_types
    leaf_types = ALL_EXPRESSION_TYPES - COMBINATOR_TYPES
    for action_type in action_types:
        missing = {t for t in leaf_types
                   if (t, action_type) not in covered}
        assert not missing, (action_type, missing)
