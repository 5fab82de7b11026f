"""Filter IR: the compiled, per-partition form of a filter expression.

The expression tree compiles (per partition) into this small algebra over
packed-u32 bitsets. The IR has two interchangeable evaluators:

- the host evaluator in this file (numpy; test oracle + small corpora)
- the device evaluator in ops/device_engine.py (JAX/XLA and CUDA; the
  production path — same bit-level semantics, one fused program per query
  structure)

Negation semantics mirror the reference operator layer exactly
(src/silo/query_engine/operators/*.cpp):
- every operator negates to a true complement over [0, row_count) ...
- ... EXCEPT a single-predicate Selection, which negates by flipping the
  comparator (selection.cpp:126-131). For float columns with NaN nulls the
  two differ, and the corpus pins the reference behavior.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ..ops import bitset

# Comparators (reference operators/selection.h)
EQUALS = "=="
NOT_EQUALS = "!="
LESS = "<"
HIGHER_OR_EQUALS = ">="
HIGHER = ">"
LESS_OR_EQUALS = "<="

_NEGATED = {
    EQUALS: NOT_EQUALS,
    NOT_EQUALS: EQUALS,
    LESS: HIGHER_OR_EQUALS,
    HIGHER_OR_EQUALS: LESS,
    HIGHER: LESS_OR_EQUALS,
    LESS_OR_EQUALS: HIGHER,
}


class Node:
    def negate(self) -> "Node":
        return Not(self)


@dataclass
class Full(Node):
    def negate(self):
        return Empty()


@dataclass
class Empty(Node):
    def negate(self):
        return Full()


@dataclass
class Plane(Node):
    """A borrowed packed bitset row: a (symbol, position) plane row, an
    indexed-column value bitmap, or a precomputed host bitmap (insertion
    search). `words` is uint32[W] with clear tail bits.

    `static_ref` = (kind, segment_name, symbol_id, position) marks rows that
    live in the device-resident static plane bank (the same row id in every
    partition); None means per-partition dynamic data that the device engine
    uploads per query."""

    words: np.ndarray
    label: str = ""
    static_ref: tuple | None = None


@dataclass
class Predicate:
    """Elementwise column comparison, vectorized over rows."""

    values: np.ndarray  # typed column array (int32/uint32/float64/int32 ids)
    comparator: str
    value: object  # comparison constant (same domain as values)

    def negate(self) -> "Predicate":
        return Predicate(self.values, _NEGATED[self.comparator], self.value)

    def mask(self) -> np.ndarray:
        v = self.values
        c = self.value
        if self.comparator == EQUALS:
            return v == c
        if self.comparator == NOT_EQUALS:
            return v != c
        if self.comparator == LESS:
            return v < c
        if self.comparator == HIGHER_OR_EQUALS:
            return v >= c
        if self.comparator == HIGHER:
            return v > c
        if self.comparator == LESS_OR_EQUALS:
            return v <= c
        raise ValueError(self.comparator)


@dataclass
class Selection(Node):
    """AND of predicates, optionally intersected with a child node."""

    predicates: list[Predicate]
    child: Node | None = None

    def negate(self):
        if self.child is None and len(self.predicates) == 1:
            return Selection([self.predicates[0].negate()])
        return Not(self)


@dataclass
class And(Node):
    children: list[Node] = field(default_factory=list)


@dataclass
class Or(Node):
    children: list[Node] = field(default_factory=list)


@dataclass
class Not(Node):
    child: Node

    def negate(self):
        return self.child


@dataclass
class Threshold(Node):
    """k-of-n over children; match_exactly => exactly k (reference
    operators/threshold.cpp via per-bit counting, which covers every N-Of
    rewrite case uniformly)."""

    k: int
    match_exactly: bool
    children: list[Node] = field(default_factory=list)


def simplify(node: Node) -> Node:
    """Constant folding, parity-safe (mirrors the Empty/Full shortcuts of
    and.cpp/or.cpp; performance-only, never changes results)."""
    if isinstance(node, And):
        children = [simplify(c) for c in node.children]
        if any(isinstance(c, Empty) for c in children):
            return Empty()
        children = [c for c in children if not isinstance(c, Full)]
        if not children:
            return Full()
        if len(children) == 1:
            return children[0]
        return And(children)
    if isinstance(node, Or):
        children = [simplify(c) for c in node.children]
        if any(isinstance(c, Full) for c in children):
            return Full()
        children = [c for c in children if not isinstance(c, Empty)]
        if not children:
            return Empty()
        if len(children) == 1:
            return children[0]
        return Or(children)
    if isinstance(node, Not):
        child = simplify(node.child)
        if isinstance(child, Full):
            return Empty()
        if isinstance(child, Empty):
            return Full()
        if isinstance(child, Not):
            return child.child
        return Not(child)
    if isinstance(node, Threshold):
        return Threshold(node.k, node.match_exactly, [simplify(c) for c in node.children])
    if isinstance(node, Selection) and node.child is not None:
        return Selection(node.predicates, simplify(node.child))
    return node


class HostEvaluator:
    """Reference evaluator over numpy bitsets (bit-identical to the device
    path; used as the oracle and for small partitions)."""

    def __init__(self, n_rows: int):
        self.n_rows = n_rows
        self.n_words = bitset.words_for(n_rows)
        self.full = bitset.full_mask(n_rows)

    def evaluate(self, node: Node) -> np.ndarray:
        if isinstance(node, Full):
            return self.full.copy()
        if isinstance(node, Empty):
            return bitset.empty_mask(self.n_rows)
        if isinstance(node, Plane):
            return node.words
        if isinstance(node, Not):
            return np.bitwise_and(np.bitwise_not(self.evaluate(node.child)), self.full)
        if isinstance(node, And):
            result = self.evaluate(node.children[0]).copy()
            for child in node.children[1:]:
                result &= self.evaluate(child)
            return result
        if isinstance(node, Or):
            result = bitset.empty_mask(self.n_rows)
            for child in node.children:
                result |= self.evaluate(child)
            return result
        if isinstance(node, Selection):
            mask = np.ones(self.n_rows, dtype=bool)
            for pred in node.predicates:
                mask &= pred.mask()
            words = bitset.pack_bool(mask, self.n_words)
            if node.child is not None:
                words &= self.evaluate(node.child)
            return words
        if isinstance(node, Threshold):
            counts = np.zeros(self.n_rows, dtype=np.int32)
            for child in node.children:
                counts += bitset.unpack_words(self.evaluate(child), self.n_rows)
            mask = counts == node.k if node.match_exactly else counts >= node.k
            return bitset.pack_bool(mask, self.n_words)
        raise TypeError(f"Unknown IR node {type(node)}")
