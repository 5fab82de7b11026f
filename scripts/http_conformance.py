"""Replay the reference conformance corpus OVER THE WIRE against a
running server (the shipped artifact, e.g. the Docker image), plus the
JS harness's protocol assertions.

  python scripts/http_conformance.py --url http://localhost:18081 \
      [--reference /root/reference] [--expect-count 100]

Reference analog: endToEndTests/test/query.test.js run by the CI
docker-compose files (docker-compose-for-tests-preprocessing-from-*.yml)
— the corpus executed against the real container over HTTP, not
in-process. Exit 0 only when every case matches byte-semantically.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import time
import urllib.error
import urllib.request


def deep_equal(expected, actual, path=""):
    if isinstance(expected, float) or isinstance(actual, float):
        assert isinstance(actual, (int, float)) and isinstance(
            expected, (int, float)), (path, expected, actual)
        assert math.isclose(expected, actual, rel_tol=1e-12, abs_tol=1e-15), (
            path, expected, actual)
        return
    if isinstance(expected, dict):
        assert isinstance(actual, dict), (path, expected, actual)
        assert set(expected) == set(actual), (path, set(expected), set(actual))
        for key in expected:
            deep_equal(expected[key], actual[key], f"{path}.{key}")
        return
    if isinstance(expected, list):
        assert isinstance(actual, list), (path, expected, actual)
        assert len(expected) == len(actual), (path, len(expected), len(actual))
        for i, (e, a) in enumerate(zip(expected, actual)):
            deep_equal(e, a, f"{path}[{i}]")
        return
    assert expected == actual, (path, expected, actual)


def request(url, method="GET", body=None, timeout=60):
    req = urllib.request.Request(url, method=method,
                                 data=body.encode() if body else None)
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return resp.status, dict(resp.headers), resp.read().decode()
    except urllib.error.HTTPError as err:
        return err.code, dict(err.headers), err.read().decode()


def wait_ready(base, timeout_s=180.0, expect_count=None):
    deadline = time.time() + timeout_s
    while time.time() < deadline:
        try:
            status, _h, body = request(base + "/info")
            if status == 200:
                info = json.loads(body)
                if expect_count is None or info.get(
                        "sequenceCount") == expect_count:
                    return info
        except OSError:
            pass
        time.sleep(1.0)
    raise SystemExit(f"server at {base} never became ready")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--url", required=True)
    ap.add_argument("--reference",
                    default=os.environ.get("SILO_REFERENCE_ROOT",
                                           "/root/reference"))
    ap.add_argument("--expect-count", type=int, default=100)
    args = ap.parse_args()
    base = args.url.rstrip("/")
    queries_dir = os.path.join(args.reference, "endToEndTests/test/queries")
    invalid_dir = os.path.join(args.reference,
                               "endToEndTests/test/invalidQueries")

    info = wait_ready(base, expect_count=args.expect_count)
    print(f"ready: /info {info}")

    # warm the query path with a generous budget before the timed replay:
    # the FIRST query can sit behind device start-up and compiles —
    # server behavior is correct, only slow once
    status, _h, _b = request(
        base + "/query", "POST",
        '{"action":{"type":"Aggregated"},'
        '"filterExpression":{"type":"True"}}', timeout=300)
    assert status == 200, status

    passed = 0
    for case_file in sorted(os.listdir(queries_dir)):
        with open(os.path.join(queries_dir, case_file)) as f:
            case = json.load(f)
        status, headers, body = request(base + "/query", "POST",
                                        json.dumps(case["query"]))
        assert status == 200, (case_file, status, body[:200])
        assert headers.get("data-version", "").isdigit(), (case_file, headers)
        deep_equal({"queryResult": case["expectedQueryResult"]},
                   json.loads(body), case_file)
        passed += 1
    print(f"queries: {passed} cases OK")

    invalid = 0
    for case_file in sorted(os.listdir(invalid_dir)):
        with open(os.path.join(invalid_dir, case_file)) as f:
            case = json.load(f)
        status, _h, body = request(base + "/query", "POST",
                                   json.dumps(case["query"]))
        assert status == 400, (case_file, status, body[:200])
        got = json.loads(body)
        assert got["error"] == "Bad request", (case_file, got)
        assert got["message"] == case["expectedError"]["message"], (
            case_file, got["message"])
        invalid += 1
    print(f"invalidQueries: {invalid} cases OK")

    # protocol assertions (reference query.test.js + server handler chain)
    status, _h, body = request(base + "/query", "POST", "not json at all")
    assert status == 400, (status, body[:200])
    status, _h, body = request(base + "/query", "GET")
    assert status == 405, (status, body[:200])
    got = json.loads(body)
    assert got["error"] == "Method not allowed", got
    status, _h, body = request(base + "/no-such-route")
    assert status == 404, (status, body[:200])
    print("protocol assertions OK")
    print(f"TOTAL: {passed} + {invalid} cases + protocol, all OK over HTTP")


if __name__ == "__main__":
    main()
