"""Versioned snapshot persistence: flat arrays + JSON manifest.

The replacement for the reference's boost-archive snapshots
(src/silo/database.cpp:369-601): a directory ``<out>/<unix-ts>/`` holding

- ``manifest.json``        config, alias table, reference genomes, layout
- ``dictionaries.json``    shared column dictionaries
- ``P<i>_columns.npz``     per-partition typed column arrays
- ``P<i>_<kind>_<seg>.npy``  per-partition dense bitplanes (mmap-able,
  laid out exactly as they will be device_put)
- ``P<i>_unaligned_<seg>.bin/.idx.npy``  zstd blob store
- ``data_version.silo``    written LAST — the atomic commit marker, exactly
  the reference's publication protocol (database_directory_watcher.cpp).
"""

from __future__ import annotations

import json
import logging
import os
import tempfile

import numpy as np

from ..config.database_config import ColumnType, parse_database_config
from .columns import (
    DateColumnPartition,
    Dictionary,
    FloatColumnPartition,
    IndexedStringColumnPartition,
    InsertionColumnPartition,
    IntColumnPartition,
    PangoLineageColumnPartition,
    StringColumnPartition,
)
from .database import Database, DataVersion
from .pango_alias import PangoLineageAliasLookup
from .partition import DatabasePartition
from .reference_genomes import ReferenceGenomes
from ..ops.bitset import words_for as bitset_words_for
from .segment import SegmentIndex
from .unaligned import UnalignedPartitionStore

MANIFEST = "manifest.json"
DATA_VERSION_FILE = "data_version.silo"

# Plane tensors compress extremely well (majority rows are all-ones runs,
# mutation rows mostly zero); chunked zstd keeps save/load streaming.
_PLANES_CHUNK = 64 << 20


def _save_words(path: str, array: np.ndarray):
    """Chunked-zstd u32 tensor (shape in a JSON header)."""
    from ..common import zstd

    raw = array.reshape(-1).view(np.uint8)
    with open(path, "wb") as f:
        header = json.dumps({"shape": list(array.shape), "dtype": "uint32"})
        f.write(len(header).to_bytes(4, "little"))
        f.write(header.encode())
        for start in range(0, len(raw), _PLANES_CHUNK):
            chunk = zstd.compress(raw[start : start + _PLANES_CHUNK].tobytes(), level=1)
            f.write(len(chunk).to_bytes(8, "little"))
            f.write(chunk)


def _load_words(path: str) -> np.ndarray:
    from concurrent.futures import ThreadPoolExecutor

    from ..common import zstd

    with open(path, "rb") as f:
        header_len = int.from_bytes(f.read(4), "little")
        header = json.loads(f.read(header_len))
        out = np.empty(int(np.prod(header["shape"])), dtype=np.uint32)
        view = out.view(np.uint8)
        offset = 0
        # Decompress chunks straight into the destination array (the
        # bytes->join->frombuffer->copy chain made 4 passes over ~10 GB of
        # plane data at 10M — half the load time), CONCURRENTLY: each
        # frame's output offset is known from its header content size, and
        # ZSTD_decompress releases the GIL through ctypes, so two workers
        # saturate both cores while the main thread streams file reads.
        with ThreadPoolExecutor(max_workers=2) as pool:
            pending = []
            while True:
                size_bytes = f.read(8)
                if not size_bytes:
                    break
                data = f.read(int.from_bytes(size_bytes, "little"))
                n = zstd.frame_content_size(data)
                if n is None:
                    # content size absent (not a frame we write): serialize
                    for fut in pending:
                        fut.result()
                    pending.clear()
                    n = zstd.decompress_into(data, view[offset:])
                else:
                    if len(pending) >= 3:
                        pending.pop(0).result()

                    def job(data=data, dest=view[offset:offset + n], n=n):
                        got = zstd.decompress_into(data, dest)
                        assert got == n, (got, n)

                    pending.append(pool.submit(job))
                offset += n
            for fut in pending:
                fut.result()
        assert offset == view.nbytes, (offset, view.nbytes)
    return out.reshape(header["shape"])


def _save_unaligned(path_base: str, store) -> None:
    """P<pid>_unaligned_<name> pair: .bin (concatenated zstd blobs) +
    .idx.npz (offsets, present)."""
    blob = b"".join(b or b"" for b in store.blobs)
    offsets = np.zeros(len(store.blobs) + 1, dtype=np.int64)
    present = np.zeros(len(store.blobs), dtype=bool)
    acc = 0
    for i, b in enumerate(store.blobs):
        present[i] = b is not None
        acc += len(b) if b else 0
        offsets[i + 1] = acc
    with open(path_base + ".bin", "wb") as f:
        f.write(blob)
    np.savez(path_base + ".idx.npz", offsets=offsets, present=present)


def _load_unaligned(path_base: str, reference: str):
    from .unaligned import UnalignedPartitionStore

    with open(path_base + ".bin", "rb") as f:
        blob = f.read()
    idx = np.load(path_base + ".idx.npz")
    store = UnalignedPartitionStore(reference)
    offsets, present = idx["offsets"], idx["present"]
    store.blobs = [
        blob[offsets[i] : offsets[i + 1]] if present[i] else None
        for i in range(len(present))
    ]
    return store


def _save_segment(path_no_ext: str, segment: SegmentIndex):
    store = segment.store
    meta = {"sym_ids": segment.sym_ids, "pos_ids": segment.pos_ids,
            "majority": segment.majority, "counts": segment.counts}
    if store.kind == "csr":
        meta["csr_idx"] = store.idx
        meta["csr_offsets"] = store.offsets
        _save_words(path_no_ext + ".rows.zst", store.words)
    else:
        _save_words(path_no_ext + ".rows.zst", store.rows)
    np.savez(path_no_ext + ".meta.npz", **meta)


def _load_segment(path_no_ext: str, alphabet, reference_ids,
                  n_rows: int) -> SegmentIndex:
    from .rowstore import CsrRowStore, DenseRowStore

    meta_path = path_no_ext + ".meta.npz"
    if os.path.exists(meta_path):
        meta = np.load(meta_path)
        words = _load_words(path_no_ext + ".rows.zst")
        if "csr_idx" in meta:
            store = CsrRowStore(bitset_words_for(n_rows), meta["csr_idx"],
                                words, meta["csr_offsets"])
        else:
            store = DenseRowStore(words)
        return SegmentIndex(alphabet, reference_ids, n_rows, meta["majority"],
                            meta["sym_ids"], meta["pos_ids"], store,
                            counts=meta["counts"])
    # legacy dense formats (v1 snapshots)
    legacy_npy = path_no_ext + ".npy"
    if os.path.exists(legacy_npy):
        planes = np.load(legacy_npy)
    else:
        planes = _load_words(path_no_ext + ".planes.zst")
    return SegmentIndex.from_dense(alphabet, reference_ids, n_rows, planes)


def save_database(db: Database, output_directory: str) -> str:
    """Writes a new versioned snapshot; returns its directory."""
    version = db.data_version.value or DataVersion.mine().value
    final_dir = os.path.join(output_directory, version)
    os.makedirs(output_directory, exist_ok=True)
    tmp_dir = tempfile.mkdtemp(prefix=f".{version}_", dir=output_directory)

    # /info size model: content-determined per immutable snapshot, so it is
    # computed once HERE (offline ingest) and stored — the serving process's
    # first /info (the watcher's pre-live warm-up; 35.7 s at 10M x 32)
    # becomes a file read. Computed CONCURRENTLY with the partition writes
    # below (numpy/zstd release the GIL). SILO_SNAPSHOT_STATS=0 skips
    # (loaders recompute lazily, exactly as for older snapshots).
    stats_future = None
    if os.environ.get("SILO_SNAPSHOT_STATS", "1") != "0":
        import concurrent.futures

        stats_pool = concurrent.futures.ThreadPoolExecutor(1)
        stats_future = stats_pool.submit(db._nuc_roaring_stats)
        stats_pool.shutdown(wait=False)

    try:
        return _save_database_body(db, version, final_dir, tmp_dir, stats_future)
    except BaseException:
        # Failure path: don't leave the stats worker computing (~36 s at
        # 10M) with nothing to join it — cancel if still queued, else wait,
        # so errors propagate promptly and process exit isn't delayed.
        if stats_future is not None and not stats_future.cancel():
            concurrent.futures.wait([stats_future])
        raise


def _save_database_body(db, version, final_dir, tmp_dir, stats_future):
    manifest = {
        "formatVersion": 2,
        "databaseConfig": db.config.to_dict(),
        "aliasKey": db.alias_key.to_dict(),
        "referenceGenomes": db.reference_genomes.to_dict(),
        "partitions": [
            {"id": p.partition_id, "sequenceCount": p.sequence_count}
            for p in db.partitions
        ],
        "unalignedSegments": sorted(db.unaligned_nuc_sequences.keys()),
    }
    with open(os.path.join(tmp_dir, MANIFEST), "w") as f:
        json.dump(manifest, f)

    dictionaries = {}
    for name, d in db.dictionaries.items():
        if isinstance(d, tuple):  # pango: (unaliased, aliased)
            dictionaries[name] = {"unaliased": d[0].values, "aliased": d[1].values}
        else:
            dictionaries[name] = {"values": d.values}
    with open(os.path.join(tmp_dir, "dictionaries.json"), "w") as f:
        json.dump(dictionaries, f)

    # Partition ids may be global while this database holds only a shard of
    # them (multi-host: each host snapshots its own partitions) — store
    # lists are indexed by LOCAL position, file names by global id.
    for local_idx, partition in enumerate(db.partitions):
        pid = partition.partition_id
        column_arrays = {}
        for name, column in partition.columns.items():
            if isinstance(column, (IntColumnPartition, FloatColumnPartition,
                                   DateColumnPartition)):
                column_arrays[name] = column.values
            else:
                column_arrays[name] = column.ids
        np.savez(os.path.join(tmp_dir, f"P{pid}_columns.npz"), **column_arrays)
        for kind, segments in (("nuc", partition.nuc_sequences),
                               ("aa", partition.aa_sequences)):
            for name, segment in segments.items():
                _save_segment(
                    os.path.join(tmp_dir, f"P{pid}_{kind}_{name}"), segment
                )
        for name, stores in db.unaligned_nuc_sequences.items():
            _save_unaligned(os.path.join(tmp_dir, f"P{pid}_unaligned_{name}"),
                            stores[local_idx])

    if stats_future is not None:
        from . import roaring_stats

        names = []
        arrays = {}
        for local_idx, per in enumerate(stats_future.result()):
            for seg_name, st in per.items():
                i = len(names)
                names.append([local_idx, seg_name])
                for field, arr in roaring_stats.stats_to_arrays(st).items():
                    arrays[f"s{i}_{field}"] = arr
        np.savez(os.path.join(tmp_dir, "roaring_stats.npz"), **arrays)
        with open(os.path.join(tmp_dir, "roaring_stats.json"), "w") as f:
            json.dump({"names": names}, f)

    # Commit: data_version written last, then atomic rename into place.
    with open(os.path.join(tmp_dir, DATA_VERSION_FILE), "w") as f:
        f.write(version)
    os.rename(tmp_dir, final_dir)
    return final_dir


def _load_roaring_stats(snapshot_dir: str, db) -> None:
    """Install the snapshot's precomputed /info size model, if present and
    covering every (partition, nuc segment); otherwise leave it lazy
    (older snapshots, or SILO_SNAPSHOT_STATS=0 saves, recompute on first
    /info exactly as before)."""
    json_path = os.path.join(snapshot_dir, "roaring_stats.json")
    npz_path = os.path.join(snapshot_dir, "roaring_stats.npz")
    if not (os.path.exists(json_path) and os.path.exists(npz_path)):
        return
    from . import roaring_stats

    try:
        with open(json_path) as f:
            names = json.load(f)["names"]
        loaded = [dict() for _ in db.partitions]
        fields = ("per_symbol_portable", "scalars", "census", "bitset_gap",
                  "bitset_missing", "bitset_other")
        with np.load(npz_path) as arrays:
            for i, (local_idx, seg_name) in enumerate(names):
                loaded[local_idx][seg_name] = roaring_stats.stats_from_arrays(
                    {field: arrays[f"s{i}_{field}"] for field in fields})
        for per, partition in zip(loaded, db.partitions):
            if set(per) != set(partition.nuc_sequences):
                raise ValueError("stats do not cover every nuc segment")
        db._roaring_stats = loaded
    except Exception:  # noqa: BLE001 — corrupt sidecar: fall back to lazy
        logging.getLogger(__name__).warning(
            "ignoring unreadable roaring_stats sidecar in %s", snapshot_dir,
            exc_info=True)


def load_database(snapshot_dir: str) -> Database:
    with open(os.path.join(snapshot_dir, MANIFEST)) as f:
        manifest = json.load(f)
    version_path = os.path.join(snapshot_dir, DATA_VERSION_FILE)
    with open(version_path) as f:
        version = f.read().strip()

    config = parse_database_config(manifest["databaseConfig"])
    alias_key = PangoLineageAliasLookup(manifest["aliasKey"])
    ref = manifest["referenceGenomes"]
    genomes = ReferenceGenomes(
        {e["name"]: e["sequence"] for e in ref["nucleotideSequences"]},
        {e["name"]: e["sequence"] for e in ref["genes"]},
    )
    db = Database(config, alias_key, genomes)

    with open(os.path.join(snapshot_dir, "dictionaries.json")) as f:
        raw_dictionaries = json.load(f)

    def make_dict(values):
        d = Dictionary()
        d.values = list(values)
        d._ids = None  # built lazily on first value lookup
        return d

    pango_dicts = {}
    for name, data in raw_dictionaries.items():
        if "unaliased" in data:
            pango_dicts[name] = (make_dict(data["unaliased"]), make_dict(data["aliased"]))
            db.dictionaries[name] = pango_dicts[name]
        else:
            db.dictionaries[name] = make_dict(data["values"])

    from ..common.symbols import AMINO_ACID, NUCLEOTIDE

    for meta in manifest["partitions"]:
        pid, n = meta["id"], meta["sequenceCount"]
        partition = DatabasePartition(pid, n)
        columns_npz = np.load(os.path.join(snapshot_dir, f"P{pid}_columns.npz"))
        for metadata in config.schema.metadata:
            ct = metadata.column_type()
            arr = columns_npz[metadata.name]
            if ct == ColumnType.STRING:
                col = StringColumnPartition(db.dictionaries[metadata.name])
                col.load_ids(arr)
            elif ct == ColumnType.INDEXED_STRING:
                col = IndexedStringColumnPartition(db.dictionaries[metadata.name])
                col.load_ids(arr)
            elif ct == ColumnType.DATE:
                col = DateColumnPartition(metadata.name == config.schema.date_to_sort_by)
                col._values = list(arr)
                col.finalize()
            elif ct == ColumnType.INT:
                col = IntColumnPartition()
                col._values = list(arr)
                col.finalize()
            elif ct == ColumnType.FLOAT:
                col = FloatColumnPartition()
                col._values = list(arr)
                col.finalize()
            elif ct == ColumnType.INDEXED_PANGOLINEAGE:
                unaliased, aliased = pango_dicts[metadata.name]
                col = PangoLineageColumnPartition(alias_key, unaliased, aliased)
                col.load_ids(arr)
            elif ct == ColumnType.NUC_INSERTION:
                col = InsertionColumnPartition(
                    db.dictionaries[metadata.name],
                    config.default_nucleotide_sequence, NUCLEOTIDE, "nuc_insertion")
                col.load_ids(arr)
            elif ct == ColumnType.AA_INSERTION:
                col = InsertionColumnPartition(
                    db.dictionaries[metadata.name], None, AMINO_ACID, "aa_insertion")
                col.load_ids(arr)
            partition.columns[metadata.name] = col

        for kind, names, alphabet, refs in (
            ("nuc", genomes.nucleotide_ids, NUCLEOTIDE, genomes.nucleotide_ids),
            ("aa", genomes.aa_ids, AMINO_ACID, genomes.aa_ids),
        ):
            for name in names:
                segment = _load_segment(
                    os.path.join(snapshot_dir, f"P{pid}_{kind}_{name}"),
                    alphabet, refs[name], n,
                )
                if kind == "nuc":
                    partition.nuc_sequences[name] = segment
                else:
                    partition.aa_sequences[name] = segment
        partition.validate()
        db.partitions.append(partition)

    for name in manifest["unalignedSegments"]:
        reference = genomes.raw_nucleotide_sequences[name]
        db.unaligned_nuc_sequences[name] = [
            _load_unaligned(
                os.path.join(snapshot_dir, f"P{meta['id']}_unaligned_{name}"),
                reference)
            for meta in manifest["partitions"]
        ]

    db.data_version = DataVersion(version)
    _load_roaring_stats(snapshot_dir, db)
    return db


def find_newest_snapshot(data_directory: str) -> str | None:
    """Newest valid snapshot dir: name is digits, contains a matching
    data_version.silo (reference database_directory_watcher.cpp:30-111)."""
    best = None
    if not os.path.isdir(data_directory):
        return None
    for entry in sorted(os.listdir(data_directory)):
        path = os.path.join(data_directory, entry)
        if not (entry.isdigit() and os.path.isdir(path)):
            continue
        version_file = os.path.join(path, DATA_VERSION_FILE)
        try:
            with open(version_file) as f:
                if f.read().strip() != entry:
                    continue
        except OSError:
            continue
        if best is None or entry > best[0]:
            best = (entry, path)
    return best[1] if best else None
