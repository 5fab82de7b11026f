"""Coordinated multi-host snapshot version flip (SURVEY §5.3/§2.10): every
host stages new snapshot versions locally; the FlipController commits the
slice to a new version only when ALL hosts have it, so queries never mix
versions. A restarted/failed host re-stages and is re-committed (failed-host
re-load). The reference is single-node and has no analog — this is the
Multi-host generalization of database_directory_watcher.cpp's hot reload."""

import json

import pytest


def _make_db(counts_tag: str):
    """A tiny single-partition database whose content differs per tag (so
    the test can tell which version answered)."""
    from lapis_silo_tpu.testing import synthetic_database

    n_rows = {"v1": 48, "v2": 64}[counts_tag]
    return synthetic_database(n_rows=n_rows, length=64, n_partitions=1)


def _save(db, directory: str, version: str) -> None:
    from lapis_silo_tpu.storage.database import DataVersion
    from lapis_silo_tpu.storage.snapshot import save_database

    db.data_version = DataVersion(version)
    save_database(db, directory)


COUNT_QUERY = json.dumps(
    {"action": {"type": "Aggregated"}, "filterExpression": {"type": "True"}}
)


@pytest.fixture()
def two_host_slice(tmp_path):
    from lapis_silo_tpu.parallel.multihost import start_replicated_worker

    dirs = [str(tmp_path / "hostA"), str(tmp_path / "hostB")]
    workers = [
        start_replicated_worker(d, start_watcher=False) for d in dirs
    ]
    urls = [f"http://127.0.0.1:{s.server_address[1]}"
            for s, _w, _m in workers]
    yield dirs, workers, urls
    for server, _w, _m in workers:
        server.shutdown()


def test_coordinated_flip(two_host_slice):
    from lapis_silo_tpu.parallel.multihost import Coordinator, FlipController

    dirs, workers, urls = two_host_slice
    watchers = [w for _s, w, _m in workers]
    controller = FlipController(urls)
    # schema context for merging; no local partitions
    coordinator = Coordinator(_make_db("v1"), urls, include_local=False,
                              flip_retries=2, flip_retry_seconds=0.05)

    # nothing staged anywhere: no flip
    assert controller.check_once() is None

    # v1 lands on both hosts -> staged, then committed together
    for d, w in zip(dirs, watchers):
        _save(_make_db("v1"), d, "1000000001")
        w.check_once()
        assert w.versions() == {"serving": "", "staged": "1000000001"}
    assert controller.check_once() == "1000000001"
    assert all(w.versions()["serving"] == "1000000001" for w in watchers)
    result = coordinator.execute_query(COUNT_QUERY)
    assert result["queryResult"] == [{"count": 2 * 48}]

    # v2 lands on host A only: staged there, but the slice must NOT flip
    _save(_make_db("v2"), dirs[0], "1000000002")
    watchers[0].check_once()
    assert controller.check_once() is None
    assert watchers[0].versions() == {"serving": "1000000001",
                                      "staged": "1000000002"}
    # queries still answer consistently from v1
    result = coordinator.execute_query(COUNT_QUERY)
    assert result["queryResult"] == [{"count": 2 * 48}]

    # v2 lands on host B too -> the slice flips together
    _save(_make_db("v2"), dirs[1], "1000000002")
    watchers[1].check_once()
    assert controller.check_once() == "1000000002"
    assert all(w.versions()["serving"] == "1000000002" for w in watchers)
    result = coordinator.execute_query(COUNT_QUERY)
    assert result["queryResult"] == [{"count": 2 * 64}]

    # idempotent: nothing new -> no further flips
    assert controller.check_once() is None


def test_failed_host_reload(two_host_slice):
    """A worker that lost its in-memory state (restart) re-stages the newest
    snapshot and rejoins the serving version on the next controller poll."""
    from lapis_silo_tpu.parallel.multihost import (
        FlipController,
        start_replicated_worker,
    )

    dirs, workers, urls = two_host_slice
    watchers = [w for _s, w, _m in workers]
    controller = FlipController(urls)
    for d, w in zip(dirs, watchers):
        _save(_make_db("v1"), d, "1000000001")
        w.check_once()
    assert controller.check_once() == "1000000001"

    # "restart" host B: fresh worker process over the same shard directory
    workers[1][0].shutdown()
    server, watcher, mutex = start_replicated_worker(dirs[1],
                                                     start_watcher=False)
    try:
        urls[1] = f"http://127.0.0.1:{server.server_address[1]}"
        controller = FlipController(urls)
        watcher.check_once()  # re-stages 1000000001
        assert watcher.versions() == {"serving": "", "staged": "1000000001"}
        assert controller.check_once() == "1000000001"
        assert watcher.versions()["serving"] == "1000000001"
        assert mutex.get_database().partitions  # actually serving data
    finally:
        server.shutdown()


def test_mid_flip_version_mismatch_retries(two_host_slice):
    """If a query lands in the inconsistency window (one host flipped, the
    other not yet), the coordinator retries and then surfaces a clear
    error rather than merging mixed-version partials."""
    from lapis_silo_tpu.parallel.multihost import Coordinator, FlipController

    dirs, workers, urls = two_host_slice
    watchers = [w for _s, w, _m in workers]
    controller = FlipController(urls)
    for d, w in zip(dirs, watchers):
        _save(_make_db("v1"), d, "1000000001")
        w.check_once()
    assert controller.check_once() == "1000000001"
    for d, w in zip(dirs, watchers):
        _save(_make_db("v2"), d, "1000000002")
        w.check_once()
    # simulate a torn flip: commit only host A
    assert watchers[0].commit("1000000002")
    coordinator = Coordinator(_make_db("v1"), urls, include_local=False,
                              flip_retries=2, flip_retry_seconds=0.01)
    with pytest.raises(RuntimeError, match="disagree on data version"):
        coordinator.execute_query(COUNT_QUERY)
    # the controller heals the tear (re-commit is idempotent) ...
    assert controller.check_once() == "1000000002"
    # ... and queries work again
    result = coordinator.execute_query(COUNT_QUERY)
    assert result["queryResult"] == [{"count": 2 * 64}]
