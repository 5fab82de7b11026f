"""Device determinism: the same query twice returns identical bits (the
The replacement here for the reference's data-race tooling, SURVEY §5.2)."""

import json


def test_same_query_twice_identical(example_dataset_db):
    db = example_dataset_db
    query = json.dumps({
        "action": {"type": "Mutations", "minProportion": 0.001},
        "filterExpression": {"type": "N-Of", "numberOfMatchers": 1,
                             "matchExactly": False, "children": [
                                 {"type": "HasNucleotideMutation", "position": 241},
                                 {"type": "HasNucleotideMutation", "position": 3037},
                             ]},
    })
    first = db.execute_query(query)
    second = db.execute_query(query)
    assert json.dumps(first, sort_keys=True) == json.dumps(second, sort_keys=True)
    assert len(first["queryResult"]) > 0
