"""Query engine driver.

Parity with reference src/silo/query_engine/query_engine.cpp: parse the JSON
query, compile the filter per partition, evaluate to packed bitsets, hand
them to the action. On the device engine the per-partition loop becomes
one program over the flat word axis (sharded over a mesh when several
devices are present), with counts merged by psum.
"""

from __future__ import annotations

import json
import logging
import time

from . import ast
from .actions import parse_action
from .errors import QueryParseError
from .ir import HostEvaluator

performance_logger = logging.getLogger("lapis_silo_tpu.performance")


class Query:
    def __init__(self, query_string: str):
        def _reject_constant(name):
            # nlohmann rejects NaN/Infinity literals that Python's json
            # accepts by default; force the reference behavior
            raise ValueError(f"invalid constant {name}")

        try:
            data = json.loads(query_string, parse_constant=_reject_constant)
        except ValueError as ex:
            # reference query.cpp:24-26 wraps nlohmann's ex.what(); replicate
            # its exact message text (query/nlohmann_errors.py)
            from .nlohmann_errors import parse_error_message

            message = parse_error_message(query_string) or str(ex)
            raise QueryParseError(
                f"The query was not a valid JSON: {message}") from ex
        if (
            not isinstance(data, dict)
            or not isinstance(data.get("filterExpression"), dict)
            or not isinstance(data.get("action"), dict)
        ):
            raise QueryParseError("Query json must contain filterExpression and action.")
        self.filter = ast.parse_expression(data["filterExpression"])
        self.action = parse_action(data["action"])
        # canonical key for the device engine's lowered-program cache:
        # serving workloads repeat filters, and lowering walks every
        # partition in pure Python
        self.filter_key = json.dumps(
            data["filterExpression"], sort_keys=True, separators=(",", ":"))


class QueryEngine:
    def __init__(self, database, use_device: bool | None = None):
        self.database = database
        if use_device is None:
            import os

            use_device = os.environ.get("SILO_TPU_HOST_ONLY", "0") != "1"
        self._device_engine = None
        self._use_device = use_device
        # queries a device path declined (ProgramTooLarge /
        # StructureMismatch) and the host answered instead
        self.host_fallbacks = 0

    def _device(self):
        """The DeviceEngine, built on first use. An empty database has no
        device path (NotImplementedError): serving stays on the host."""
        if self._device_engine is None:
            from ..ops.device_engine import DeviceEngine

            try:
                self._device_engine = DeviceEngine(self.database)
            except NotImplementedError:
                self._use_device = False
                return None
            self.database.device_engine = self._device_engine
        return self._device_engine

    def _declined(self, ex: Exception) -> bool:
        """True (and counted) when a device path declined this one query;
        anything else propagates."""
        from ..ops.device_engine import ProgramTooLarge, StructureMismatch

        if isinstance(ex, (ProgramTooLarge, StructureMismatch)):
            self.host_fallbacks += 1
            return True
        return False

    def _evaluate_filter(self, query: Query) -> list:
        """Compile + evaluate the filter per partition -> packed bitsets."""
        db = self.database
        engine = self._device() if self._use_device else None
        if engine is not None:
            try:
                # fused nonzero-word extraction: selective filters on large
                # corpora transfer KBs instead of the whole [P, W] bitset
                # (falls back internally when the result is wide)
                return engine.evaluate_compact(query.filter)
            except Exception as ex:
                if not self._declined(ex):
                    raise
        results = []
        for partition in db.partitions:
            node = query.filter.compile(db, partition, ast.NONE)
            evaluator = HostEvaluator(partition.sequence_count)
            results.append(evaluator.evaluate(node))
        return results

    def execute(self, query_string: str) -> dict:
        query = Query(query_string)
        t0 = time.perf_counter()
        fast = self._try_fast_count(query)
        if fast is not None:
            return fast
        bitmaps = self._device_filter_for_mutations(query)
        if bitmaps is None:
            bitmaps = self._evaluate_filter(query)
        t1 = time.perf_counter()
        rows = query.action.execute_and_order(self.database, bitmaps)
        t2 = time.perf_counter()
        performance_logger.info(
            "filter time [microseconds]: %d, action time [microseconds]: %d",
            int((t1 - t0) * 1e6),
            int((t2 - t1) * 1e6),
        )
        return {"queryResult": rows}

    def _device_filter_for_mutations(self, query: Query):
        """Mutations only needs device reductions — keep the filter bitset
        on device (a DeviceFilter handle) instead of pulling [P, W] words
        over the host link (tens of MB at 10M sequences)."""
        from .actions import Mutations

        if not (self._use_device and isinstance(query.action, Mutations)):
            return None
        engine = self._device()
        if engine is None:
            return None
        try:
            return engine.device_filter(query.filter)
        except Exception as ex:
            if self._declined(ex):
                return None
            raise

    def _try_fast_count(self, query: Query) -> dict | None:
        """Aggregated on the device engine. Without group-by: fused filter +
        popcount (micro-batched), only a scalar crosses the host boundary.
        With group-by: one segment-sum dispatch over cached per-column
        group codes."""
        from .actions import Aggregated

        action = query.action
        if not (self._use_device and isinstance(action, Aggregated)):
            return None
        engine = self._device()
        if engine is None:
            return None
        try:
            action.validate_order_by(self.database)
            if action.group_by_fields:
                groups = engine.group_counts(
                    query.filter, action.group_by_fields
                )
                if groups is None:
                    return None  # unsupported column kinds: host path
                rows = action.rows_from_group_counts(self.database, groups)
            else:
                rows = [{"count": engine.count_coalesced(
                    query.filter, key=query.filter_key)}]
        except Exception as ex:
            if self._declined(ex):
                return None
            raise
        if action.offset is not None and action.offset >= len(rows):
            return {"queryResult": []}
        action._apply_sort(rows)
        return {"queryResult": action._apply_offset_and_limit(rows)}
