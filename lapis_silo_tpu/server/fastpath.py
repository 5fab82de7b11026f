"""Count fast path for the native HTTP server.

The reference serves queries entirely in native code
(src/silo_api/query_handler.cpp:22-74); this repo's
equivalent splits the request path in two:

- C++ (native/silo_http.cpp) matches exact `POST /query` bodies against a
  registered map and queues hits for the drainer — zero Python per request.
- ONE Python drainer thread (here) pops whole batches, resolves each opaque
  handle to a pre-lowered filter program, answers the batch with a single
  device dispatch (DeviceEngine.count_programs), and hands the counts back
  for C++ to format and write.

Registration happens on the slow path: after the Python router answers a
`POST /query` 200, `maybe_register` checks the query is count-shaped
(Aggregated, no group-by, no offset/limit effects) and — once per distinct
body per snapshot generation — registers body -> (generation << 20 | index)
with the C++ map.

Snapshot swaps (the watcher) are handled by the drainer alone: it clears the
C++ map (after which no old-generation task can enter the queue), drains the
queue to empty answering with the OLD generation's programs/engine/version
(each request sees one consistent snapshot, exactly like the slow path), and
only then retires the old table and bumps the generation.
"""

from __future__ import annotations

import ctypes
import json
import logging
import os
import threading
import time

logger = logging.getLogger(__name__)

try:
    MAX_BATCH = max(256, int(os.environ.get("SILO_FASTPATH_BATCH", "2048")))
except ValueError:
    MAX_BATCH = 2048
# drain width cap (SILO_FASTPATH_BATCH): default half of
# device_engine.MAX_BATCH_QUERIES (4096) — serving favors latency; with
# max_bucket pinned to SERVE_LEN_BUCKET a wider pop splits into multiple
# pipelined dispatches anyway, but fewer pops = less host CPU per request
# on a core-bound box (the round-5 80.9k req/s ceiling)
_GEN_SHIFT = 20
_IDX_MASK = (1 << _GEN_SHIFT) - 1
_GEN_MASK = (1 << (32 - _GEN_SHIFT)) - 1
_NEGATIVE_CACHE_MAX = 65536
# registrations per generation are bounded too: the C++ map stores full
# body bytes and the table a lowered program each — a client iterating
# distinct count queries must not grow server memory without limit
# (overflow just stays on the slow path)
_POSITIVE_CACHE_MAX = 65536


def fastpath_symbols_available(lib) -> bool:
    return all(
        hasattr(lib, name)
        for name in ("silo_fastpath_register", "silo_fastpath_clear",
                     "silo_fastpath_wait", "silo_fastpath_respond_counts",
                     "silo_fastpath_respond_error")
    )


class _Generation:
    """One snapshot generation: the database/engine it serves, an append-only
    program table (index = low handle bits), and the data-version bytes."""

    def __init__(self, gen: int, epoch: int, database, engine):
        self.gen = gen
        self.epoch = epoch  # swap epoch at creation; any later swap retires
        self.database = database
        self.engine = engine
        self.version = (database.data_version.value or "").encode("ascii")
        self.programs: list = []
        self.registered: set[bytes] = set()
        self.negative: set[bytes] = set()


class _CompletionPump:
    """Dedicated completion thread (round 5): the serving breakdown showed
    the single drainer thread spending ~80% of loaded time BLOCKED in
    `_complete`'s device readback — time
    it was not popping or dispatching new work. The pump takes finished
    dispatches off the drainer's hands so readbacks overlap dispatching.
    Bounded: submit() blocks at `capacity` in-flight batches (the pipeline
    depth). A batch stays at the queue head until fully answered, so
    drain() waits for true quiescence (generation retire needs that)."""

    def __init__(self, fastpath: "CountFastPath", capacity: int):
        self._fp = fastpath
        self._capacity = max(1, capacity)
        self._cv = threading.Condition()
        self._queue: list = []
        self._stopped = False
        self._thread = threading.Thread(
            target=self._run, name="silo-fastpath-complete", daemon=True)
        self._thread.start()

    def submit(self, batch) -> None:
        with self._cv:
            while len(self._queue) >= self._capacity and not self._stopped:
                self._cv.wait()
            self._queue.append(batch)
            self._cv.notify_all()

    def idle(self) -> bool:
        with self._cv:
            return not self._queue

    def drain(self) -> None:
        """Block until every submitted batch is fully answered."""
        with self._cv:
            while self._queue and not self._stopped:
                self._cv.wait()

    def stop(self, timeout: float = 10.0) -> None:
        with self._cv:
            self._stopped = True
            self._cv.notify_all()
        self._thread.join(timeout)

    def _run(self) -> None:
        while True:
            with self._cv:
                while not self._queue and not self._stopped:
                    self._cv.wait()
                if not self._queue:
                    return  # stopped and drained
                batch = self._queue[0]  # stays queued until answered
            try:
                self._fp._complete(batch)
            except Exception:  # noqa: BLE001 — no connection may hang
                logger.exception("fast-path completion failed")
                # _complete pops groups as it answers them: the remaining
                # groups are exactly the unanswered ones
                for group in list(batch):
                    try:
                        self._fp._respond_error(
                            group[1], 500,
                            {"error": "Internal Server Error",
                             "message": "fast-path completion failed"})
                    except Exception:  # noqa: BLE001 — best effort
                        pass
                del batch[:]
            with self._cv:
                self._queue.pop(0)
                self._cv.notify_all()


class CountFastPath:
    """Owns the drainer thread and the registration state for one native
    HTTP server instance."""

    def __init__(self, lib, server_id: int, database_mutex):
        self._lib = lib
        self._sid = server_id
        self._mutex = database_mutex
        self._reg_lock = threading.Lock()
        self._state: _Generation | None = None
        self._tables: dict[int, _Generation] = {}
        self._next_gen = 0
        # Bumped (under _reg_lock) by the mutex swap listener BEFORE it
        # clears the C++ map. A generation whose epoch is stale must be
        # retired even when the database object looks current again —
        # swap A->B->A inside one drainer tick would otherwise leave
        # `registered` claiming bodies the C++ map no longer holds (and a
        # racing registration could resurrect pre-swap programs).
        self._swap_epoch = 0
        self._keys = (ctypes.c_uint64 * MAX_BATCH)()
        self._handles = (ctypes.c_uint32 * MAX_BATCH)()
        self._counts = (ctypes.c_int64 * MAX_BATCH)()
        lib.silo_fastpath_wait.restype = ctypes.c_int
        lib.silo_fastpath_wait.argtypes = [
            ctypes.c_int, ctypes.POINTER(ctypes.c_uint64),
            ctypes.POINTER(ctypes.c_uint32), ctypes.c_int, ctypes.c_int,
        ]
        lib.silo_fastpath_register.restype = None
        lib.silo_fastpath_register.argtypes = [
            ctypes.c_int, ctypes.c_char_p, ctypes.c_int64, ctypes.c_uint32,
        ]
        lib.silo_fastpath_clear.restype = None
        lib.silo_fastpath_clear.argtypes = [ctypes.c_int]
        lib.silo_fastpath_respond_counts.restype = None
        lib.silo_fastpath_respond_counts.argtypes = [
            ctypes.c_int, ctypes.POINTER(ctypes.c_uint64),
            ctypes.POINTER(ctypes.c_int64), ctypes.c_int, ctypes.c_char_p,
        ]
        lib.silo_fastpath_respond_error.restype = None
        lib.silo_fastpath_respond_error.argtypes = [
            ctypes.c_int, ctypes.POINTER(ctypes.c_uint64), ctypes.c_int,
            ctypes.c_int, ctypes.c_char_p, ctypes.c_int64,
        ]
        # Swap-freshness parity with the slow path: clearing the C++ map the
        # moment the watcher installs a new snapshot means no NEW request can
        # match a stale body; already-queued tasks are in-flight and answered
        # with the old (consistent) snapshot, exactly like slow-path requests
        # that resolved just before the swap. (Without this the drainer's
        # 250 ms poll bounds staleness instead.) A racing registration can
        # re-add an old-generation body; the drainer's _retire clears again
        # under _reg_lock, which closes that window for good.
        if hasattr(database_mutex, "add_swap_listener"):
            database_mutex.add_swap_listener(self._on_swap)
        self._pump: _CompletionPump | None = None  # set by the drain loop
        self._thread = threading.Thread(
            target=self._drain_loop, name="silo-fastpath", daemon=True)
        self._thread.start()

    def _on_swap(self) -> None:
        """Mutex swap listener (watcher thread). Bump-then-clear: any
        registration completing after the bump aborts on the epoch check;
        one completing before it is wiped by the clear."""
        with self._reg_lock:
            self._swap_epoch += 1
        self._lib.silo_fastpath_clear(self._sid)

    # -- registration (called from native worker threads) ---------------------

    def maybe_register(self, body: bytes) -> None:
        """Register `body` for the fast path if its response is a pure count.
        Called after the slow path answered it with a 200 — so the query is
        known-valid and the device engine exists."""
        try:
            self._maybe_register(body)
        except Exception:  # noqa: BLE001 — registration is best-effort
            logger.exception("fast-path registration failed")

    def _maybe_register(self, body: bytes) -> None:
        state = self._state
        if state is None or state.database is not self._mutex.get_database():
            return  # drainer will swap generations shortly
        key = bytes(body)
        if key in state.registered or key in state.negative:
            return
        if len(state.registered) >= _POSITIVE_CACHE_MAX:
            return  # table full for this generation: stay on the slow path
        data = self._count_shaped(key)
        if data is None:
            if len(state.negative) < _NEGATIVE_CACHE_MAX:
                state.negative.add(key)
            return
        from ..query import ast

        filter_expr = ast.parse_expression(data["filterExpression"])
        filter_key = json.dumps(data["filterExpression"], sort_keys=True,
                                separators=(",", ":"))
        engine = state.engine
        program = engine.lower_cached(filter_expr, filter_key)[0]
        with self._reg_lock:
            if state is not self._state or state.epoch != self._swap_epoch:
                return  # generation retired / snapshot swapped mid-register
            idx = len(state.programs)
            if idx > _IDX_MASK:
                return  # table full: stop registering this generation
            state.programs.append(program)
            handle = ((state.gen & _GEN_MASK) << _GEN_SHIFT) | idx
            self._lib.silo_fastpath_register(self._sid, key, len(key), handle)
            state.registered.add(key)

    @staticmethod
    def _count_shaped(key: bytes):
        """The parsed query dict when the response is exactly [{"count": N}]
        with no post-processing — Aggregated, no group-by, offset absent/0,
        limit absent/>=1 (orderBy on a single count row is the identity, and
        the slow path already validated it) — else None."""
        from ..query.actions import Aggregated, parse_action

        try:
            data = json.loads(key)
            action = parse_action(data["action"])
        except Exception:  # noqa: BLE001 — slow path answered; stay out
            return None
        if not isinstance(data.get("filterExpression"), dict):
            return None
        if not isinstance(action, Aggregated) or action.group_by_fields:
            return None
        if action.offset not in (None, 0):
            return None
        if action.limit is not None and action.limit < 1:
            return None
        # sparse-leaf programs ride the engine's shape ladder; they are
        # still a single dispatch, so no further restriction is needed
        return data

    # -- drainer ---------------------------------------------------------------

    def _ensure_state(self) -> _Generation | None:
        """Swap generations when the watcher installed a new snapshot. Runs
        ONLY in the drainer thread."""
        database = self._mutex.get_database()
        state = self._state
        if (state is not None and state.database is database
                and state.epoch == self._swap_epoch):
            return state
        engine = getattr(database, "device_engine", None)
        if engine is None:
            # The slow path creates the engine on the first device query;
            # until then there is nothing to register or answer.
            if state is not None:
                self._retire(state)
            return None
        with self._reg_lock:
            gen = self._next_gen
            self._next_gen += 1
            new_state = _Generation(gen, self._swap_epoch, database, engine)
            # keyed by the MASKED generation — handles carry only
            # _GEN_MASK bits, so an unmasked key would stop matching after
            # 4096 snapshot swaps (every registered body would 500 forever)
            self._tables[gen & _GEN_MASK] = new_state
            self._state = new_state
        return new_state

    def _retire(self, state: _Generation) -> None:
        """Clear the C++ map and answer every queued old-generation task,
        then drop retired tables. After silo_fastpath_clear returns, no task
        for a cleared entry can enter the queue (fp_mu covers match+push),
        so one empty poll proves the queue holds no old handles."""
        with self._reg_lock:
            if self._state is state:
                self._state = None  # stop registrations into the old table
        self._lib.silo_fastpath_clear(self._sid)
        if self._pump is not None:
            # old-generation batches already handed to the completion pump
            # answer from their own table references; wait them out before
            # this method drops the retired tables below
            self._pump.drain()
        while True:
            n = self._lib.silo_fastpath_wait(
                self._sid, self._keys, self._handles, MAX_BATCH, 20)
            if n <= 0:
                break
            dispatched = self._dispatch(self._pop_copy(n))
            if dispatched is not None:
                self._complete(dispatched)
        keep = (self._state.gen & _GEN_MASK) if self._state is not None else None
        self._tables = {g: t for g, t in self._tables.items() if g == keep}

    def _pop_copy(self, n: int) -> list[tuple[int, int]]:
        """Copy popped (key, handle) pairs out of the shared ctypes buffers
        — the next silo_fastpath_wait reuses them."""
        return [(self._keys[i], self._handles[i]) for i in range(n)]

    def _drain_loop(self) -> None:
        # k-deep pipeline (SILO_FASTPATH_DEPTH, default 2): batch k
        # dispatches while up to depth-1 earlier batches' readbacks are in
        # flight. With more connections than one batch holds, dispatch and
        # readback overlap the device work; deeper pipelines
        # trade p99 latency for throughput until the device VM saturates
        # (~12 ms per 512-query batch).
        #
        # The loop body is fully guarded: an uncaught exception would kill
        # the only thread that pops fast-path tasks while the C++ map keeps
        # matching bodies — every matched connection would then hang
        # forever (the slow path never sees a matched body).
        import collections
        import os

        # depth 3 measured best on hardware: 25,015 req/s with p99 115 ms
        # vs 16,881/135.8 at depth 2 and 26,735/140.8 at depth 4 — the
        # marginal batch past 3 buys ~7% for worse tail latency
        try:
            depth = max(1, int(os.environ.get("SILO_FASTPATH_DEPTH", "3")))
        except ValueError:
            # a malformed value must not kill the only thread that answers
            # fast-path matches (matched connections would hang forever)
            logger.warning("invalid SILO_FASTPATH_DEPTH=%r; using 3",
                           os.environ.get("SILO_FASTPATH_DEPTH"))
            depth = 3
        # SILO_FASTPATH_STATS=1: periodic drainer-occupancy summaries to
        # stderr — pop widths, per-phase time split (wait / dispatch /
        # complete), and GC gen-2 collections observed by this thread.
        # The round-5 serving-cap breakdown instrument; off by default.
        stats_on = os.environ.get("SILO_FASTPATH_STATS") == "1"
        stats = {"batches": 0, "tasks": 0, "wait_s": 0.0, "dispatch_s": 0.0,
                 "complete_s": 0.0, "widths": collections.Counter(),
                 "t0": time.perf_counter(), "gen2_0": 0}
        if stats_on:
            import gc as _gc

            stats["gen2_0"] = _gc.get_stats()[2]["collections"]

        def _stats_tick(n, t_wait, t_disp, t_comp):
            stats["batches"] += 1
            stats["tasks"] += n
            stats["wait_s"] += t_wait
            stats["dispatch_s"] += t_disp
            stats["complete_s"] += t_comp
            stats["widths"][1 << max(0, (n - 1).bit_length())] += 1
            if stats["batches"] % 256 == 0:
                import gc as _gc
                import sys as _sys

                wall = time.perf_counter() - stats["t0"]
                gen2 = _gc.get_stats()[2]["collections"] - stats["gen2_0"]
                print(
                    f"[fastpath-stats] {stats['tasks']} tasks / "
                    f"{stats['batches']} polls in {wall:.1f}s "
                    f"({stats['tasks'] / max(wall, 1e-9):.0f} req/s): "
                    f"wait {stats['wait_s']:.1f}s "
                    f"dispatch {stats['dispatch_s']:.1f}s "
                    f"complete {stats['complete_s']:.1f}s; "
                    f"pop-width histogram (pow2 buckets) "
                    f"{dict(sorted(stats['widths'].items()))}; "
                    f"gen2 collections {gen2}",
                    file=_sys.stderr, flush=True)

        # Completion pump (round 5, default on): readbacks block in a
        # dedicated thread so the drainer keeps popping + dispatching.
        # SILO_FASTPATH_PUMP=0 restores the single-thread pipeline for A/B.
        use_pump = os.environ.get("SILO_FASTPATH_PUMP", "1") != "0"
        if use_pump:
            self._pump = _CompletionPump(self, depth)
        inflight: collections.deque = collections.deque()
        current = None  # batch popped for completion; entries pop as answered
        while True:
            t_wait0 = time.perf_counter()
            n = self._lib.silo_fastpath_wait(
                self._sid, self._keys, self._handles, MAX_BATCH,
                250 if (use_pump or not inflight) else 0)
            t_wait = time.perf_counter() - t_wait0
            if n < 0:
                if use_pump:
                    self._pump.drain()
                    self._pump.stop()
                while inflight:
                    try:
                        self._complete(inflight.popleft())
                    except Exception:  # noqa: BLE001 — shutting down
                        logger.exception("fast-path final drain failed")
                return  # server stopping
            dispatched = None
            try:
                t_disp0 = time.perf_counter()
                dispatched = self._dispatch(self._pop_copy(n)) if n else None
                t_disp = time.perf_counter() - t_disp0
                t_comp0 = time.perf_counter()
                if dispatched is not None:
                    if use_pump:
                        # hand off; blocks only when `depth` batches are
                        # already awaiting readback (backpressure)
                        self._pump.submit(dispatched)
                        dispatched = None
                    else:
                        inflight.append(dispatched)
                        dispatched = None
                        while len(inflight) >= depth:
                            current = inflight.popleft()
                            self._complete(current)
                            current = None
                elif not use_pump and inflight:
                    # no new work: drain the oldest in-flight batch
                    current = inflight.popleft()
                    self._complete(current)
                    current = None
                if stats_on:
                    _stats_tick(n, t_wait, t_disp,
                                time.perf_counter() - t_comp0)
                if n == 0 and not inflight and (
                        not use_pump or self._pump.idle()):
                    # idle moment: generation maintenance
                    state = self._state
                    if state is not None and (
                            state.epoch != self._swap_epoch
                            or state.database is not self._mutex.get_database()):
                        self._retire(state)
                    if self._state is None:
                        self._ensure_state()
            except Exception:  # noqa: BLE001 — the drainer must survive
                logger.exception("fast-path drain iteration failed")
                # no task may be dropped silently: a matched connection the
                # drainer never answers hangs forever. `current` is the
                # batch that blew up mid-_complete — _complete pops entries
                # as it answers them, so re-walking it covers exactly the
                # still-unanswered groups (no double answer possible). In
                # pump mode submitted batches are the pump's to answer;
                # only the not-yet-submitted dispatch needs covering here.
                pending_batches = list(inflight)
                inflight.clear()
                if current:
                    pending_batches.append(current)
                    current = None
                if dispatched:
                    pending_batches.append(dispatched)
                for pending in pending_batches:
                    for entry in pending:
                        try:
                            self._respond_error(
                                entry[1], 500,
                                {"error": "Internal Server Error",
                                 "message": "fast-path drain failed"})
                        except Exception:  # noqa: BLE001 — best effort
                            pass
                time.sleep(0.05)  # never spin on a persistent fault

    def _dispatch(self, tasks: list[tuple[int, int]]):
        """Phase 1 (non-blocking): group tasks by generation, coalesce
        identical bodies into one program slot (same instant, same snapshot
        — pure fan-out, not a cache), answer host-computable programs'
        slots inline, and enqueue ONE device dispatch per group. Returns
        the in-flight batch for _complete."""
        from ..ops.device_engine import SERVE_LEN_BUCKET

        by_gen: dict[int, list[tuple[int, int]]] = {}
        for key, handle in tasks:
            by_gen.setdefault((handle >> _GEN_SHIFT) & _GEN_MASK,
                              []).append((key, handle))
        batch = []
        for gen, group in by_gen.items():
            table = self._tables.get(gen)
            keys = [key for key, _ in group]
            if table is None:
                self._respond_error(
                    keys, 500, {"error": "Internal Server Error",
                                "message": "fast-path generation retired"})
                continue
            try:
                slot_of: dict[int, int] = {}
                task_slot: list[int] = []
                programs = []
                for _, handle in group:
                    handle_idx = handle & _IDX_MASK
                    slot = slot_of.get(handle_idx)
                    if slot is None:
                        slot = len(programs)
                        slot_of[handle_idx] = slot
                        programs.append(table.programs[handle_idx])
                    task_slot.append(slot)
                engine = table.engine
                min_k, min_e = engine.sparse_floors(programs)
                split = engine.count_split(
                    programs, min_bucket=SERVE_LEN_BUCKET,
                    min_sparse_k=min_k, min_sparse_e=min_e,
                    max_bucket=SERVE_LEN_BUCKET)
                batch.append((table, keys, task_slot, split))
            except Exception as ex:  # noqa: BLE001 — parity: JSON 500
                logger.exception("fast-path batch dispatch failed")
                self._respond_error(
                    keys, 500, {"error": "Internal Server Error",
                                "message": str(ex)})
        return batch or None

    def _complete(self, batch) -> None:
        """Phase 2 (blocking): pull each group's device counts to the host,
        fan them out to the coalesced tasks, hand C++ the answers. Entries
        pop as they are answered so a mid-batch crash cannot double-answer
        a connection from the drain loop's recovery path."""
        while batch:
            # Peek, answer, THEN pop: if the respond call itself raises,
            # the group stays in `batch` where the drain loop's recovery
            # walk can still answer it — popping first would strand its
            # connections in neither `current` nor `inflight`. The pop
            # immediately follows the respond with no fallible statement
            # between, so a group can never be answered twice either.
            table, keys, task_slot, split = batch[0]
            try:
                slot_counts = table.engine.count_finish(*split)
                counts = [slot_counts[s] for s in task_slot]
            except Exception as ex:  # noqa: BLE001 — parity: JSON 500
                logger.exception("fast-path batch readback failed")
                self._respond_error(
                    keys, 500, {"error": "Internal Server Error",
                                "message": str(ex)})
                batch.pop(0)
                continue
            ckeys = (ctypes.c_uint64 * len(keys))(*keys)
            vals = (ctypes.c_int64 * len(keys))(*counts)
            self._lib.silo_fastpath_respond_counts(
                self._sid, ckeys, vals, len(keys), table.version)
            batch.pop(0)

    def _respond_error(self, keys: list[int], status: int, payload: dict) -> None:
        body = json.dumps(payload, ensure_ascii=False).encode("utf-8")
        ckeys = (ctypes.c_uint64 * len(keys))(*keys)
        self._lib.silo_fastpath_respond_error(
            self._sid, ckeys, len(keys), status, body, len(body))

    def stop(self, timeout: float = 10.0) -> None:
        """Join the drainer after silo_http_stop woke it (wait returns -1).
        Without the join, a daemon thread blocked in a ctypes call at
        interpreter exit aborts the process (pthread_exit unwinding through
        C++ frames). The drain loop stops its own completion pump on the
        way out; the extra stop here covers a drainer that died early."""
        self._thread.join(timeout)
        if self._pump is not None:
            self._pump.stop(timeout)
