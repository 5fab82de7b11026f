"""Platform plumbing: device-memory budgets, the compile cache, the YAML
config reader, the one-process-per-card rule, and the absence of silent
host fallbacks."""

import glob
import os

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class _FakeDevice:
    def __init__(self, platform, stats):
        self.platform = platform
        self._stats = stats

    def memory_stats(self):
        return self._stats


@pytest.mark.parametrize("limit_gb", [16, 60])
def test_budgets_follow_bytes_limit(monkeypatch, limit_gb):
    from lapis_silo_tpu.ops import device_engine as de

    monkeypatch.delenv("SILO_DENSE_BANK_BUDGET_GB", raising=False)
    dev = _FakeDevice("gpu", {"bytes_limit": limit_gb << 30})
    assert de.device_memory_bytes(dev) == limit_gb << 30
    assert de.dense_bank_budget_bytes(dev) == int(
        de.DENSE_BANK_SHARE * (limit_gb << 30))
    monkeypatch.setenv("SILO_DENSE_BANK_BUDGET_GB", "4")
    assert de.dense_bank_budget_bytes(dev) == 4 << 30


def test_budget_without_memory_stats_raises():
    from lapis_silo_tpu.ops import device_engine as de

    with pytest.raises(RuntimeError, match="no memory limit"):
        de.device_memory_bytes(_FakeDevice("gpu", None))
    # the CPU backend's memory is the host's
    assert de.device_memory_bytes(_FakeDevice("cpu", None)) > 0


def test_engine_pool_sized_from_device_memory(monkeypatch):
    """The pool takes what the bank and stream leave of the device's
    bytes_limit, less headroom, capped — and nothing below the floor."""
    import jax

    from lapis_silo_tpu.ops import device_engine as de
    from lapis_silo_tpu.testing import synthetic_database

    db = synthetic_database(n_rows=2048, length=256, n_partitions=2,
                            mutations_per_genome=2)
    monkeypatch.delenv("SILO_LEAF_POOL_GB", raising=False)
    monkeypatch.setattr(de, "device_memory_bytes", lambda device: 1 << 30)
    engine = de.DeviceEngine(db, devices=jax.devices()[:1],
                             sparse_min_words=1)
    assert engine.pool_slots == min(engine.n_sparse, 8192)
    monkeypatch.setattr(de, "device_memory_bytes",
                        lambda device: 4 * engine.n_rows
                        * engine.n_flat_words)
    starved = de.DeviceEngine(db, devices=jax.devices()[:1],
                              sparse_min_words=1)
    assert starved.pool_slots == 0


@pytest.mark.parametrize("env_set", [True, False])
def test_compile_cache_branches(monkeypatch, tmp_path, env_set):
    import jax

    from lapis_silo_tpu import compile_cache

    before = jax.config.jax_compilation_cache_dir
    try:
        if env_set:
            monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
            jax.config.update("jax_compilation_cache_dir", "unchanged")
            assert compile_cache.configure() == str(tmp_path)
            assert jax.config.jax_compilation_cache_dir == "unchanged"
        else:
            monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
            path = compile_cache.configure()
            assert path == os.path.join(REPO, ".jax_cache")
            assert jax.config.jax_compilation_cache_dir == path
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


@pytest.mark.parametrize("path", sorted(glob.glob(
    os.path.join(REPO, "docker", "*.yaml"))), ids=os.path.basename)
def test_yaml_reader_on_shipped_configs(path):
    from lapis_silo_tpu.config import yaml_subset

    data = yaml_subset.load_file(path)
    assert isinstance(data, dict) and data
    assert all(isinstance(v, str) for v in data.values())
    assert yaml_subset.load(yaml_subset.dump_mapping(data)) == data


def test_yaml_reader_database_config_shape():
    from lapis_silo_tpu.config import yaml_subset
    from lapis_silo_tpu.config.database_config import parse_database_config

    text = """
schema:
  instanceName: test  # a comment
  metadata:
    - name: key
      type: string
    - name: "country"
      type: string
      generateIndex: true
    -
      name: date
      type: date
  primaryKey: key
  dateToSortBy: date
"""
    data = yaml_subset.load(text)
    assert data["schema"]["metadata"][1] == {
        "name": "country", "type": "string", "generateIndex": True}
    config = parse_database_config(data)
    assert [m.name for m in config.schema.metadata] == ["key", "country",
                                                        "date"]
    for bad in ("a: b\n  c: d\n", "key: {x: 1}\n", "- a\nb: c\n"):
        with pytest.raises(yaml_subset.YamlError):
            yaml_subset.load(bad)


def test_api_processes_refused_on_gpu(monkeypatch):
    from lapis_silo_tpu import cli

    monkeypatch.setattr(cli, "_probe_platform", lambda: "gpu")
    monkeypatch.delenv("SILO_API_CHILD", raising=False)
    args = cli.argparse.Namespace(apiProcesses=2, runtimeConfig=None,
                                  dataDirectory=None, port=None)
    with pytest.raises(SystemExit, match="one API process per device"):
        cli.handle_api(args)


def test_device_import_error_propagates(monkeypatch):
    """A broken device stack is an error, not a silent switch to host-only
    serving; only an empty database (NotImplementedError) serves from the
    host."""
    import json

    from lapis_silo_tpu.ops import device_engine as de
    from lapis_silo_tpu.query.engine import QueryEngine
    from lapis_silo_tpu.storage.database import Database
    from lapis_silo_tpu.testing import synthetic_database

    def broken(*args, **kwargs):
        raise ImportError("no device stack")

    monkeypatch.setattr(de, "DeviceEngine", broken)
    engine = QueryEngine(synthetic_database(n_rows=64, length=32),
                         use_device=True)
    query = json.dumps({"action": {"type": "Aggregated"},
                        "filterExpression": {"type": "True"}})
    with pytest.raises(ImportError):
        engine.execute(query)
    assert engine._use_device

    empty = QueryEngine(Database.empty(), use_device=True)
    monkeypatch.undo()
    assert empty.execute(query) == {"queryResult": [{"count": 0}]}
    assert not empty._use_device
