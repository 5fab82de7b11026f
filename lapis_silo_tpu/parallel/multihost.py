"""Multi-host serving: partition shards across hosts, query broadcast,
collective-merged results.

The reference is single-node; SURVEY §2.10/§5.8 defines the multi-device
generalization this module provides:

- every host holds a subset of partitions (its local Database + DeviceEngine
  over its own devices; within a host, words shard via parallel/mesh);
- the coordinator broadcasts the query JSON to all hosts (DCN control
  plane), each host executes its partitions and returns a *partial result*;
- partials merge exactly like the reference merges per-partition results
  (sum of cardinalities, hash-map group merges, count-matrix sums, row
  concatenation in partition order), then ordering/offset/limit apply once
  at the coordinator.

The control plane is plain HTTP so it works across processes/machines; the
same merge code paths are exercised in-process by the test harness.
"""

from __future__ import annotations

import json
import logging
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from ..common.symbols import NUCLEOTIDE
from ..ops import bitset
from ..query import actions as actions_mod
from ..query.engine import Query
from ..query.errors import QueryParseError


# ---------------------------------------------------------------------------
# Worker side: execute a query on local partitions, return a partial result.
# ---------------------------------------------------------------------------


def execute_partial(database, query_string: str) -> dict:
    """Run the filter on all local partitions and reduce the action to a
    mergeable partial. The partial carries the host's data version so the
    coordinator can detect (and wait out) a mid-flip inconsistency."""
    partial = _execute_partial(database, query_string)
    partial["dataVersion"] = database.data_version.value
    return partial


def _execute_partial(database, query_string: str) -> dict:
    query = Query(query_string)
    action = query.action
    engine = database._engine
    if engine is None:
        from ..query.engine import QueryEngine

        engine = database._engine = QueryEngine(database)
    bitmaps = engine._evaluate_filter(query)

    if isinstance(action, actions_mod.Aggregated):
        if not action.group_by_fields:
            return {"kind": "count",
                    "count": sum(bitset.popcount(w) for w in bitmaps)}
        rows = action.execute(database, bitmaps)
        return {"kind": "groups", "rows": rows}
    if isinstance(action, actions_mod.Mutations):
        return _mutations_partial(database, action, bitmaps)
    if isinstance(action, actions_mod.InsertionAggregation):
        rows = action.execute(database, bitmaps)
        return {"kind": "insertion_counts", "rows": rows}
    if isinstance(action, actions_mod.Details):
        action_no_slice = actions_mod.Details(action.fields)
        action_no_slice.order_by_fields = action.order_by_fields
        # workers pre-trim to limit+offset rows when a limit exists
        if action.limit is not None:
            action_no_slice.limit = action.limit + (action.offset or 0)
        rows = action_no_slice.execute_and_order(database, bitmaps)
        return {"kind": "rows_sorted", "rows": rows}
    # Fasta / FastaAligned: rows in partition order
    rows = action.execute(database, bitmaps)
    return {"kind": "rows", "rows": rows}


def _mutations_partial(database, action, bitmaps) -> dict:
    stores = database.nuc_sequences if action.alphabet is NUCLEOTIDE \
        else database.aa_sequences
    names = action.sequence_names or sorted(stores.keys())
    for name in names:
        actions_mod.check_query(
            name in stores,
            f"Database does not contain the {action.alphabet.name_lower} sequence "
            f"with name: '{name}'",
        )
    kind = "nuc" if action.alphabet is NUCLEOTIDE else "aa"
    device_engine = getattr(database, "device_engine", None)
    counts = {}
    for name in names:
        if device_engine is not None:
            matrix = device_engine.mutation_counts(kind, name, bitmaps)
        else:
            matrix = None
            for partition, words in zip(database.partitions, bitmaps):
                if not words.any():
                    continue
                segments = (partition.nuc_sequences if kind == "nuc"
                            else partition.aa_sequences)
                part = segments[name].mutation_counts(words)
                matrix = part if matrix is None else matrix + part
        if matrix is not None:
            counts[name] = np.asarray(matrix, dtype=np.int64)
    return {"kind": "mutation_counts", "alphabet": kind, "counts": counts}


# ---------------------------------------------------------------------------
# Partial wire encoding. Counts/groups/rows are small JSON; a Mutations
# partial is a [symbols, positions] count matrix per segment (~16 x 30k
# int64 for SARS-CoV-2 nuc — tens of MB as JSON text per worker per
# query), and round-3 measurements put the coordinator's JSON parse+merge
# of those tables at core-scale work. Matrices now travel as a raw binary frame —
# a small JSON header plus concatenated little-endian array bytes — so the
# coordinator merge is frombuffer + array sum, not JSON.
# ---------------------------------------------------------------------------

_PARTIAL_MAGIC = b"SILOPART1\n"


def encode_partial(partial: dict):
    """dict -> wire payload: binary frame for array-carrying partials,
    the dict itself (JSON-serialized by the server layer) otherwise."""
    if partial.get("kind") != "mutation_counts":
        return partial
    header = {k: v for k, v in partial.items() if k != "counts"}
    arrays = []
    blobs = []
    for name, matrix in partial["counts"].items():
        matrix = np.ascontiguousarray(matrix, dtype=np.int64)
        arrays.append({"name": name, "shape": list(matrix.shape)})
        blobs.append(matrix.tobytes())
    header["arrays"] = arrays
    head = json.dumps(header).encode("utf-8")
    return b"".join([_PARTIAL_MAGIC, len(head).to_bytes(4, "little"), head]
                    + blobs)


def decode_partial(raw: bytes) -> dict:
    """Wire payload -> dict (array partials come back as np.int64)."""
    if not raw.startswith(_PARTIAL_MAGIC):
        return json.loads(raw)
    off = len(_PARTIAL_MAGIC)
    head_len = int.from_bytes(raw[off : off + 4], "little")
    off += 4
    partial = json.loads(raw[off : off + head_len])
    off += head_len
    counts = {}
    for desc in partial.pop("arrays"):
        n = int(np.prod(desc["shape"]))
        counts[desc["name"]] = np.frombuffer(
            raw, dtype=np.int64, count=n, offset=off).reshape(desc["shape"])
        off += n * 8
    partial["counts"] = counts
    return partial


# Batched fan-out frame (/internal/partial_batch): the coordinator
# coalesces concurrent public queries into ONE request per worker, so the
# per-query control-plane cost (HTTP routing + dispatch on both sides —
# ~350 us/worker/query measured in --overhead) divides by the batch width.
# Body: JSON array of query strings. Response: SILOBATCH1 frame of
# per-query items, each `u16 status + u32 len + payload` where payload is
# a JSON body (errors included) or a SILOPART binary partial.
_BATCH_MAGIC = b"SILOBATCH1\n"


def encode_partial_batch(items: list[tuple[int, object]]) -> bytes:
    """items: (status, payload dict|bytes) per query, in request order."""
    chunks = [_BATCH_MAGIC, len(items).to_bytes(4, "little")]
    for status, payload in items:
        if not isinstance(payload, (bytes, bytearray)):
            payload = json.dumps(payload).encode("utf-8")
        chunks.append(status.to_bytes(2, "little"))
        chunks.append(len(payload).to_bytes(4, "little"))
        chunks.append(bytes(payload))
    return b"".join(chunks)


def decode_partial_batch(raw: bytes) -> list[tuple[int, bytes]]:
    assert raw.startswith(_BATCH_MAGIC), raw[:16]
    off = len(_BATCH_MAGIC)
    n = int.from_bytes(raw[off : off + 4], "little")
    off += 4
    items = []
    for _ in range(n):
        status = int.from_bytes(raw[off : off + 2], "little")
        length = int.from_bytes(raw[off + 2 : off + 6], "little")
        off += 6
        items.append((status, raw[off : off + length]))
        off += length
    return items


def execute_partial_batch(database, queries: list[str]) -> bytes:
    """Worker side of the batched fan-out: each query executes
    independently; per-query errors travel as per-item statuses so one
    bad query cannot poison its batch-mates."""
    items: list[tuple[int, object]] = []
    for query in queries:
        try:
            items.append((200, encode_partial(
                execute_partial(database, query))))
        except QueryParseError as ex:
            items.append((400, {"error": "Bad request", "message": str(ex)}))
        except Exception as ex:  # noqa: BLE001 — keep serving
            items.append((500, {"error": "Internal server error",
                                "message": str(ex)}))
    return encode_partial_batch(items)


# ---------------------------------------------------------------------------
# Coordinator side: merge partials, apply ordering/slicing once.
# ---------------------------------------------------------------------------


def merge_partials(database, query_string: str, partials: list[dict]) -> dict:
    """`database` is the coordinator's schema context (config + reference
    genomes; it may also own local partitions, in which case its own partial
    is simply one of `partials`)."""
    query = Query(query_string)
    action = query.action
    action.validate_order_by(database)
    kind = partials[0]["kind"] if partials else "rows"

    if kind == "count":
        rows = [{"count": sum(p["count"] for p in partials)}]
    elif kind == "groups":
        merged: dict[tuple, dict] = {}
        for partial in partials:
            for row in partial["rows"]:
                key = tuple(sorted(
                    ((k, v) for k, v in row.items() if k != "count"),
                    key=lambda kv: kv[0],
                ))
                if key in merged:
                    merged[key]["count"] += row["count"]
                else:
                    merged[key] = dict(row)
        rows = list(merged.values())
    elif kind == "mutation_counts":
        rows = _merge_mutations(database, action, partials)
    elif kind == "insertion_counts":
        merged = {}
        for partial in partials:
            for row in partial["rows"]:
                key = (row["sequenceName"], row["position"], row["insertions"])
                if key in merged:
                    merged[key]["count"] += row["count"]
                else:
                    merged[key] = dict(row)
        rows = [merged[k] for k in sorted(merged)]
    elif kind == "rows_sorted":
        rows = _merge_sorted_rows(database, action, partials)
        if action.offset is not None and action.offset >= len(rows):
            return {"queryResult": []}
        return {"queryResult": action._apply_offset_and_limit(rows)}
    else:  # plain rows, partition order == host order
        rows = [row for partial in partials for row in partial["rows"]]
        total_limit = {"Fasta": 10000, "FastaAligned": 10000}.get(
            type(action).__name__)
        if total_limit is not None and len(rows) > total_limit:
            raise QueryParseError(
                f"{type(action).__name__} action currently limited to "
                f"{total_limit} sequences")

    if action.offset is not None and action.offset >= len(rows):
        return {"queryResult": []}
    action._apply_sort(rows)
    return {"queryResult": action._apply_offset_and_limit(rows)}


def _merge_mutations(database, action, partials) -> list[dict]:
    alphabet = action.alphabet
    stores = database.nuc_sequences if alphabet is NUCLEOTIDE else database.aa_sequences
    names = action.sequence_names or sorted(stores.keys())
    out = []
    for name in names:
        total_matrix = None
        for partial in partials:
            if name not in partial["counts"]:
                continue
            matrix = np.asarray(partial["counts"][name], dtype=np.int64)
            total_matrix = matrix if total_matrix is None else total_matrix + matrix
        if total_matrix is None:
            continue
        reference_ids = np.asarray(stores[name])
        valid_ids = np.asarray(alphabet.valid_mutation_ids)
        sub = total_matrix[valid_ids]                      # [S, L]
        totals = sub.sum(axis=0)                           # [L]
        # threshold per position: ceil(total * minProportion) - 1 in
        # float64, exactly the reference's double math
        # (mutations.cpp:185-233); minProportion 0 -> plain count > 0
        if action.min_proportion == 0:
            thresholds = np.zeros_like(totals)
        else:
            thresholds = (np.ceil(totals.astype(np.float64)
                                  * action.min_proportion) - 1).astype(
                totals.dtype)
        mask = (sub > thresholds[None, :]) & (totals[None, :] > 0)
        mask &= valid_ids[:, None] != reference_ids[None, :]
        # row order parity: position-major, then valid-symbol order —
        # transpose before nonzero (row-major walk)
        pos_idx, sym_idx = np.nonzero(mask.T)
        for pos, si in zip(pos_idx.tolist(), sym_idx.tolist()):
            count = int(sub[si, pos])
            out.append({
                "mutation": alphabet.to_char(int(reference_ids[pos]))
                + str(pos + 1) + alphabet.to_char(int(valid_ids[si])),
                "sequenceName": name,
                "proportion": count / int(totals[pos]),
                "count": count,
            })
    return out


def _merge_sorted_rows(database, action, partials) -> list[dict]:
    """k-way merge of per-host typed-sorted Details rows."""
    metadata = action._field_metadata(database)
    by_name = {m.name: m for m in metadata}

    def typed_key(row):
        values = []
        for fld in action.order_by_fields:
            value = row.get(fld.name)
            m = by_name[fld.name]
            ct = m.column_type().value
            if ct == "date":
                from ..common.dates import string_to_date

                values.append(string_to_date(value) if value else 0)
            elif ct == "int":
                values.append(value if value is not None else -(2**31))
            elif ct == "float":
                values.append(float(value) if value is not None else float("nan"))
            else:
                values.append(value if value is not None else "")
        return actions_mod._TypedKey(
            tuple(values), tuple(f.ascending for f in action.order_by_fields))

    lists = [p["rows"] for p in partials]
    if not action.order_by_fields:
        return [row for rows in lists for row in rows]
    cursors = [0] * len(lists)
    merged: list[dict] = []
    cap = (action.limit + (action.offset or 0)) if action.limit is not None else None
    while cap is None or len(merged) < cap:
        best = None
        for li, rows in enumerate(lists):
            if cursors[li] >= len(rows):
                continue
            key = typed_key(rows[cursors[li]])
            if best is None or key < best[0]:
                best = (key, li)
        if best is None:
            break
        merged.append(lists[best[1]][cursors[best[1]]])
        cursors[best[1]] += 1
    return merged


# ---------------------------------------------------------------------------
# HTTP plumbing: worker endpoint + coordinator fan-out.
# ---------------------------------------------------------------------------


class StagedSnapshotWatcher:
    """Phase 1 of the two-phase multi-host version flip (SURVEY §5.3/§2.10:
    all hosts of a slice must start serving a new snapshot version together;
    the reference, being single-node, has no analog). Polls this host's
    data directory like the single-host watcher, but loads the newest
    snapshot into a *staging* slot without serving it; `commit(v)` (phase 2,
    broadcast by the FlipController once every host has v) atomically
    publishes the staged database to the serving mutex. A host that
    restarts simply re-stages the newest snapshot and is re-committed on
    the controller's next poll — that is the failed-host re-load path."""

    def __init__(self, data_directory: str, mutex, poll_seconds: float = 2.0):
        from ..storage import snapshot as snapshot_mod

        self._snapshot = snapshot_mod
        self.data_directory = data_directory
        self.mutex = mutex
        self.poll_seconds = poll_seconds
        self._lock = threading.Lock()
        self._staged: tuple[str, object] | None = None
        self._serving_version = ""
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="silo-staged-watcher")

    def start(self):
        self.check_once()
        self._thread.start()

    def stop(self):
        self._stop.set()

    def _run(self):
        while not self._stop.wait(self.poll_seconds):
            self.check_once()

    def check_once(self):
        try:
            newest = self._snapshot.find_newest_snapshot(self.data_directory)
            if newest is None:
                return
            version = newest.rstrip("/").rsplit("/", 1)[-1]
            with self._lock:
                staged_version = self._staged[0] if self._staged else ""
                if version <= max(self._serving_version, staged_version):
                    return
            database = self._snapshot.load_database(newest)
            # shared pre-live warm-up (device executables + the /info size
            # model): the coordinator's first /info fan-out must not stall
            # on segment_stats, and the first committed query must not
            # stall on a remote XLA compile — same reasoning as the
            # single-host watcher
            from ..server.watcher import DatabaseDirectoryWatcher

            DatabaseDirectoryWatcher._warmup(database)
            with self._lock:
                self._staged = (version, database)
        except Exception:  # parity: a bad snapshot never kills the host
            logging.getLogger(__name__).exception(
                "staging snapshot failed; keeping current state")

    def versions(self) -> dict:
        with self._lock:
            return {
                "serving": self._serving_version,
                "staged": self._staged[0] if self._staged else "",
            }

    def commit(self, version: str) -> bool:
        with self._lock:
            if version == self._serving_version:
                return True  # idempotent re-commit
            if self._staged is None or self._staged[0] != version:
                return False
            _, database = self._staged
            self.mutex.set_database(database)
            self._serving_version = version
            self._staged = None
            return True


class WorkerHandler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"
    mutex = None                 # DatabaseMutex-like: .get_database()
    watcher = None               # StagedSnapshotWatcher | None (fixed worker)

    def log_message(self, *args):
        pass

    def _send_json(self, status: int, payload):
        if isinstance(payload, (bytes, bytearray)):
            body, ctype = bytes(payload), "application/octet-stream"
        else:
            body, ctype = json.dumps(payload).encode(), "application/json"
        self.send_response(status)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self):
        if self.path == "/internal/info":
            self._send_json(200, self.mutex.get_database().info())
        elif self.path == "/internal/detailed_info":
            self._send_json(200, self.mutex.get_database().detailed_info())
        elif self.path == "/internal/version":
            if self.watcher is not None:
                self._send_json(200, self.watcher.versions())
            else:
                version = self.mutex.get_database().data_version.value
                self._send_json(200, {"serving": version, "staged": ""})
        else:
            self.send_error(404)

    def do_POST(self):
        if self.path == "/internal/commit":
            length = int(self.headers.get("Content-Length", 0))
            version = json.loads(self.rfile.read(length))["version"]
            if self.watcher is not None:
                committed = self.watcher.commit(version)
            else:  # fixed worker: "committed" iff it already serves that version
                committed = self.mutex.get_database().data_version.value == version
            self._send_json(200 if committed else 409, {"committed": committed})
            return
        if self.path == "/internal/partial_batch":
            length = int(self.headers.get("Content-Length", 0))
            queries = json.loads(self.rfile.read(length))
            self._send_json(200, execute_partial_batch(
                self.mutex.get_database(), queries))
            return
        if self.path != "/internal/partial":
            self.send_error(404)
            return
        length = int(self.headers.get("Content-Length", 0))
        query = self.rfile.read(length).decode("utf-8")
        try:
            body_payload = encode_partial(
                execute_partial(self.mutex.get_database(), query))
            status = 200
        except QueryParseError as ex:
            body_payload = {"error": "Bad request", "message": str(ex)}
            status = 400
        except Exception as ex:  # noqa: BLE001
            body_payload = {"error": "Internal server error", "message": str(ex)}
            status = 500
        self._send_json(status, body_payload)


class _FanoutBatcher:
    """Doorbell batching of the Coordinator's worker fan-out — the
    control-plane analog of the device micro-batcher. A caller enqueues
    its query and the first thread to arrive becomes the leader: it
    drains the pending list in groups, issues ONE partial_batch request
    per worker per group, and distributes results; later arrivals park on
    their entry's event and are batched into the NEXT group. A lone query
    degenerates to one request per worker (the pre-batching behavior, on
    the batch endpoint)."""

    MAX_BATCH = 64

    def __init__(self, coordinator):
        self._coord = coordinator
        self._lock = threading.Lock()
        self._pending: list[dict] = []
        self._leader_running = False

    def gather(self, db, query_string: str) -> list[dict]:
        entry = {"q": query_string, "db": db, "result": None, "error": None,
                 "done": threading.Event()}
        with self._lock:
            self._pending.append(entry)
            leader = not self._leader_running
            if leader:
                self._leader_running = True
        if leader:
            try:
                while True:
                    with self._lock:
                        batch = self._pending[: self.MAX_BATCH]
                        del self._pending[: len(batch)]
                        if not batch:
                            self._leader_running = False
                            break
                    try:
                        # one db snapshot per group: entries racing a flip
                        # get version-checked (and retried) by their own
                        # execute_query loop
                        self._coord._batch_fanout(batch[0]["db"], batch)
                    except Exception as ex:  # noqa: BLE001
                        for e in batch:
                            if e["error"] is None and e["result"] is None:
                                e["error"] = ex
                    finally:
                        for e in batch:
                            e["done"].set()
            except BaseException:
                with self._lock:
                    self._leader_running = False
                raise
        entry["done"].wait()
        if entry["error"] is not None:
            raise entry["error"]
        return entry["result"]


class _FixedMutex:
    """get_database() over an immutable database (fixed single-snapshot
    workers, the pre-flip deployment mode)."""

    def __init__(self, database):
        self._database = database

    def get_database(self):
        return self._database

    def set_database(self, database):
        self._database = database


def _worker_router(mutex, watcher):
    """Native-server router for the worker control plane (the same protocol
    WorkerHandler speaks): (status, payload, data_version=None) tuples."""

    def route(method: str, target: str, body: bytes):
        path = target.split("?", 1)[0]
        if method == "GET":
            if path == "/internal/info":
                return 200, mutex.get_database().info(), None
            if path == "/internal/detailed_info":
                return 200, mutex.get_database().detailed_info(), None
            if path == "/internal/version":
                if watcher is not None:
                    return 200, watcher.versions(), None
                version = mutex.get_database().data_version.value
                return 200, {"serving": version, "staged": ""}, None
            return 404, {"error": "Not found",
                         "message": f"Resource {path} does not exist"}, None
        if method == "POST":
            if path == "/internal/commit":
                version = json.loads(body)["version"]
                if watcher is not None:
                    committed = watcher.commit(version)
                else:
                    committed = (mutex.get_database().data_version.value
                                 == version)
                return (200 if committed else 409,
                        {"committed": committed}, None)
            if path == "/internal/partial_batch":
                return (200, execute_partial_batch(
                    mutex.get_database(), json.loads(body)), None)
            if path == "/internal/partial":
                try:
                    return (200, encode_partial(execute_partial(
                        mutex.get_database(),
                        body.decode("utf-8", "replace"))), None)
                except QueryParseError as ex:
                    return 400, {"error": "Bad request",
                                 "message": str(ex)}, None
                except Exception as ex:  # noqa: BLE001 — keep serving
                    return 500, {"error": "Internal server error",
                                 "message": str(ex)}, None
        return 404, {"error": "Not found",
                     "message": f"Resource {path} does not exist"}, None

    return route


def _start_worker_server(mutex, watcher, port: int):
    """Native epoll server when available (the fan-out hot path: every
    public query pays one worker round trip per host), Python fallback."""
    import os

    if os.environ.get("SILO_HTTP_IMPL", "native") != "python":
        from ..server.native_http import NativeHTTPServer, native_http_available

        if native_http_available():
            return NativeHTTPServer(router=_worker_router(mutex, watcher),
                                    port=port)
    handler = type("BoundWorkerHandler", (WorkerHandler,),
                   {"mutex": mutex, "watcher": watcher})
    server = ThreadingHTTPServer(("0.0.0.0", port), handler)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    return server


def start_worker(database, port: int = 0):
    return _start_worker_server(_FixedMutex(database), None, port)


def start_replicated_worker(data_directory: str, port: int = 0,
                            poll_seconds: float = 2.0,
                            start_watcher: bool = True):
    """A worker that hot-reloads its shard's snapshots under coordinated
    flips. Returns (server, watcher, mutex); the worker serves an empty
    database until the controller commits the first version."""
    from ..server.http_server import DatabaseMutex

    mutex = DatabaseMutex()
    watcher = StagedSnapshotWatcher(data_directory, mutex, poll_seconds)
    if start_watcher:
        watcher.start()
    server = _start_worker_server(mutex, watcher, port)
    return server, watcher, mutex


class _WorkerClient:
    """Persistent keep-alive connections to one worker (an http.client
    pool). urllib opened a fresh TCP connection per fan-out request — at
    fan-out rates the handshakes and TIME_WAIT churn tax every public
    query with one round trip's worth of setup per host."""

    def __init__(self, url: str):
        from urllib.parse import urlparse

        parsed = urlparse(url)
        self._host = parsed.hostname
        self._port = parsed.port or 80
        self._pool: list = []
        self._lock = threading.Lock()

    def request(self, method: str, path: str, body: bytes | None = None,
                timeout: float | None = None) -> tuple[int, bytes]:
        """timeout=None blocks indefinitely (like the urllib path this
        replaces — a partial may legitimately wait out a minutes-long
        remote XLA compile on the worker). The timeout applies per REQUEST
        via settimeout, not per pooled connection — connections created by
        a short-timeout caller (version polls) are reused by unbounded
        callers and vice versa."""
        import http.client

        with self._lock:
            conn = self._pool.pop() if self._pool else None
        for attempt in (0, 1):
            if conn is None:
                conn = http.client.HTTPConnection(
                    self._host, self._port, timeout=timeout)
            try:
                conn.timeout = timeout
                if conn.sock is not None:
                    conn.sock.settimeout(timeout)
                conn.request(method, path, body=body)
                resp = conn.getresponse()
                data = resp.read()
                status = resp.status
                break
            except (http.client.RemoteDisconnected, http.client.BadStatusLine,
                    ConnectionResetError, BrokenPipeError) as ex:
                # ONLY stale keep-alive failures retry (the server closed
                # the pooled connection between requests). Timeouts and
                # mid-response errors must NOT retry: the worker may have
                # executed the request already.
                try:
                    conn.close()
                except Exception:  # noqa: BLE001
                    pass
                conn = None
                if attempt:
                    raise ex
            except Exception:
                try:
                    conn.close()
                except Exception:  # noqa: BLE001
                    pass
                raise
        with self._lock:
            self._pool.append(conn)
        return status, data


_worker_clients: dict = {}
_worker_clients_lock = threading.Lock()


def _client_for(url: str) -> _WorkerClient:
    with _worker_clients_lock:
        client = _worker_clients.get(url)
        if client is None:
            client = _worker_clients[url] = _WorkerClient(url)
        return client


class FlipController:
    """Phase 2 of the coordinated version flip: polls every host's
    (serving, staged) versions; when all hosts have the SAME newest version
    available, broadcasts commit so the slice flips together. Hosts whose
    newest differs (one shard directory written, another not yet) block the
    flip — queries keep answering from the old consistent version."""

    def __init__(self, worker_urls: list[str],
                 local_watcher: StagedSnapshotWatcher | None = None,
                 poll_seconds: float = 2.0):
        self.worker_urls = worker_urls
        self.local_watcher = local_watcher
        self.poll_seconds = poll_seconds
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="silo-flip-controller")

    def start(self):
        self._thread.start()

    def stop(self):
        self._stop.set()

    def _run(self):
        while not self._stop.wait(self.poll_seconds):
            try:
                self.check_once()
            except Exception:  # noqa: BLE001 — keep polling through failures
                logging.getLogger(__name__).exception("flip poll failed")

    def _worker_versions(self, url: str) -> dict:
        status, data = _client_for(url).request("GET", "/internal/version",
                                                timeout=10)
        if status != 200:
            raise RuntimeError(f"version poll failed: HTTP {status}")
        return json.loads(data)

    def _worker_commit(self, url: str, version: str) -> bool:
        status, data = _client_for(url).request(
            "POST", "/internal/commit",
            body=json.dumps({"version": version}).encode())
        if status != 200:
            return False
        return json.loads(data).get("committed", False)

    def check_once(self) -> str | None:
        """One poll: returns the committed version if a flip happened."""
        states = []
        try:
            for url in self.worker_urls:
                states.append(self._worker_versions(url))
        except Exception:  # a host is down: never flip the others without it
            return None
        if self.local_watcher is not None:
            states.append(self.local_watcher.versions())
        if not states:
            return None
        target = min(max(s["serving"], s["staged"]) for s in states)
        if not target or all(s["serving"] == target for s in states):
            return None
        # every host must actually hold the target version
        if any(target not in (s["serving"], s["staged"]) for s in states):
            return None
        ok = all(self._worker_commit(url, target) for url in self.worker_urls)
        if self.local_watcher is not None:
            ok = self.local_watcher.commit(target) and ok
        if not ok:
            logging.getLogger(__name__).warning(
                "partial flip to %s; will re-commit next poll", target)
            return None
        logging.getLogger(__name__).info("slice flipped to version %s", target)
        return target


class Coordinator:
    """Fans a query out to workers (including, optionally, local partitions)
    and merges partials. Worker errors propagate: a 400 re-raises as
    QueryParseError so the API layer answers exactly like single-host."""

    def __init__(self, database, worker_urls: list[str], include_local: bool = True,
                 flip_retries: int = 5, flip_retry_seconds: float = 0.5):
        # `database` may be a Database or a mutex-like with get_database()
        # (hot-reloading deployments).
        self._database_source = database
        self.worker_urls = worker_urls
        self._include_local_requested = include_local
        self.flip_retries = flip_retries
        self.flip_retry_seconds = flip_retry_seconds

    @property
    def database(self):
        src = self._database_source
        return src.get_database() if hasattr(src, "get_database") else src

    @property
    def include_local(self):
        return self._include_local_requested and bool(self.database.partitions)

    def execute_query(self, query_string: str) -> dict:
        """Fan out + merge; during a version flip hosts may briefly disagree
        on data version — partials are version-checked and the fan-out
        retried until the slice is consistent again."""
        last_error = None
        for _ in range(self.flip_retries):
            # ONE snapshot for the whole attempt: a flip landing between
            # gather and merge must not merge v1 partials with v2 schema
            # context (reference genomes, dictionaries).
            db = self.database
            partials = self._gather_partials(db, query_string)
            versions = {p.get("dataVersion", "") for p in partials}
            if len(versions) <= 1:
                return merge_partials(db, query_string, partials)
            last_error = RuntimeError(
                f"hosts disagree on data version {sorted(versions)}; "
                "flip in progress")
            time.sleep(self.flip_retry_seconds)
        raise last_error

    def _executor(self):
        ex = getattr(self, "_fanout_executor", None)
        if ex is None:
            import os
            from concurrent.futures import ThreadPoolExecutor

            # Each in-flight PUBLIC query holds one task per worker for the
            # full worker-side duration, and the workers' micro-batch depth
            # equals their concurrently blocked requests — so the pool must
            # cover (target public concurrency) x (workers), not CPUs.
            per_worker = int(os.environ.get("SILO_FANOUT_DEPTH", "128"))
            ex = self._fanout_executor = ThreadPoolExecutor(
                max_workers=max(1, len(self.worker_urls)) * per_worker,
                thread_name_prefix="silo-fanout")
        return ex

    def _gather_partials(self, db, query_string: str) -> list[dict]:
        batcher = getattr(self, "_fanout_batcher", None)
        if batcher is None:
            batcher = self._fanout_batcher = _FanoutBatcher(self)
        return batcher.gather(db, query_string)

    def _batch_fanout(self, db, entries: list[dict]) -> None:
        """One batched fan-out for a group of concurrent public queries:
        ONE /internal/partial_batch request per worker carrying the
        group's DISTINCT query strings (serving traffic repeats filters),
        local partials computed once per distinct query. Fills each
        entry's `result` (host-ordered partial list) or `error`."""
        uniq: dict[str, int] = {}
        order: list[str] = []
        for entry in entries:
            if entry["q"] not in uniq:
                uniq[entry["q"]] = len(order)
                order.append(entry["q"])
        body = json.dumps(order).encode()
        offset = 1 if (self._include_local_requested and db.partitions) else 0
        # per worker: list over unique queries of (status, raw payload)
        worker_items: list[list | None] = [None] * len(self.worker_urls)
        worker_errors: list[Exception | None] = [None] * len(self.worker_urls)

        def fetch(i, url):
            try:
                status, raw = _client_for(url).request(
                    "POST", "/internal/partial_batch", body=body)
                if status != 200:
                    raise RuntimeError(
                        f"worker partial_batch failed: HTTP {status}")
                items = decode_partial_batch(raw)
                if len(items) != len(order):
                    raise RuntimeError(
                        f"worker returned {len(items)} partials "
                        f"for {len(order)} queries")
                worker_items[i] = items
            except Exception as ex:  # noqa: BLE001
                worker_errors[i] = ex

        futures = [self._executor().submit(fetch, i, url)
                   for i, url in enumerate(self.worker_urls)]
        local_results: list = [None] * len(order)  # dict | Exception
        if offset:
            for qi, query in enumerate(order):
                try:
                    local_results[qi] = execute_partial(db, query)
                except Exception as ex:  # noqa: BLE001
                    local_results[qi] = ex
        for f in futures:
            f.result()

        def item_error(status: int, raw: bytes) -> Exception:
            try:
                payload = json.loads(raw)
            except Exception:  # noqa: BLE001 — non-JSON error body
                payload = {"message": raw.decode(errors="replace")[:500]}
            if status == 400:
                return QueryParseError(payload["message"])
            return RuntimeError(payload.get("message", f"HTTP {status}"))

        for entry in entries:
            qi = uniq[entry["q"]]
            try:
                partials: list[dict] = []
                if offset:
                    local = local_results[qi]
                    if isinstance(local, Exception):
                        raise local
                    partials.append(local)
                for wi in range(len(self.worker_urls)):
                    if worker_errors[wi] is not None:
                        raise worker_errors[wi]
                    status, raw = worker_items[wi][qi]
                    if status != 200:
                        raise item_error(status, raw)
                    partials.append(decode_partial(raw))
                entry["result"] = partials
            except Exception as ex:  # noqa: BLE001
                entry["error"] = ex

    def _worker_get(self, url: str, path: str) -> dict:
        status, data = _client_for(url).request("GET", path)
        if status != 200:
            raise RuntimeError(f"worker {path} failed: HTTP {status}")
        return json.loads(data)

    def info(self) -> dict:
        total = self.database.info() if self.include_local else {
            "sequenceCount": 0, "totalSize": 0, "nBitmapsSize": 0}
        for url in self.worker_urls:
            info = self._worker_get(url, "/internal/info")
            for key in total:
                total[key] += info.get(key, 0)
        return total

    def detailed_info(self) -> dict:
        """/info?details=true across the slice: numeric leaves (byte
        counts, per-section sizes) sum across hosts, structure and string
        leaves are identical everywhere."""
        parts = [self.database.detailed_info()] if self.include_local else []
        for url in self.worker_urls:
            parts.append(self._worker_get(url, "/internal/detailed_info"))
        merged = parts[0]
        for part in parts[1:]:
            merged = _sum_numeric_tree(merged, part)
        return merged


_INVARIANT_INFO_KEYS = {"sectionLength"}  # identical per host, never summed


def _sum_numeric_tree(a, b):
    if isinstance(a, dict):
        return {k: (a[k] if k in _INVARIANT_INFO_KEYS
                    else _sum_numeric_tree(a[k], b[k])) if k in b else a[k]
                for k in a}
    if isinstance(a, list):
        if len(a) != len(b):  # ragged across hosts (different lengths): keep longer
            longer, shorter = (a, b) if len(a) >= len(b) else (b, a)
            return [_sum_numeric_tree(longer[i], shorter[i])
                    if i < len(shorter) else longer[i]
                    for i in range(len(longer))]
        return [_sum_numeric_tree(x, y) for x, y in zip(a, b)]
    if isinstance(a, bool) or not isinstance(a, (int, float)):
        return a
    return a + b
