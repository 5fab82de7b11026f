"""Filter-IR -> register-machine lowering.

Compiles the per-partition IR (query/ir.py) into one partition-uniform
VM program: static bank/sparse leaf loads, host-evaluated dynamic rows,
implicit-majority reconstruction (NOT of OR(siblings)), and the N-Of
bit-sliced threshold adder circuit. Split out of device_engine.py; the
engine's `lower`/`lower_cached` delegate here. Reference analog: the
operator-tree construction of src/silo/query_engine/filter_expressions/*.
"""

from __future__ import annotations

from ..query import ir
from .vm import (
    B_BANK, B_DYN, B_FULL, B_SPARSE, B_ZERO,
    M_AND, M_ANDN, M_MOVB, M_OR, M_XOR, MAX_REGS,
    _DYN_BUCKETS, _LEN_BUCKETS, _Program, ProgramTooLarge,
    StructureMismatch,
)

def _static_ref_source(engine, program: _Program, ref: tuple):
    """(bsrc, operand) for a (kind, name, sym, pos) plane if it is a
    single gatherable source under the compact two-tier layout, else
    None (majority symbols need sibling reconstruction)."""
    kind, name, sym, pos = ref
    meta = engine.segment_meta[(kind, name)]
    row = int(meta["row_map"][sym, pos])
    if row >= 0:
        return (B_BANK, row)
    if row == -1:
        sparse_id = int(meta["sparse_map"][sym, pos])
        if sparse_id >= 0:
            # densified from the resident CSR stream pre-VM; the
            # per-query upload is just the (start, len) pair
            return (B_SPARSE, program.add_sparse(sparse_id))
        # no sequence has this symbol here, in any partition
        return (B_ZERO, 0)
    return None  # majority

def _emit_static_ref(engine, program: _Program, ref: tuple, dst: int) -> int:
    """Emit instructions for one (kind, name, sym, pos) plane, leaving
    the result in reg[dst]; returns the register high-water mark."""
    source = _static_ref_source(engine, program, ref)
    if source is not None:
        program.load(dst, *source)
        return dst + 1
    # majority symbol: reconstruct as NOT(OR(stored sibling rows)),
    # siblings drawn from both tiers
    kind, name, sym, pos = ref
    meta = engine.segment_meta[(kind, name)]
    emitted = 0
    for sibling_sym in range(meta["s_count"]):
        srow = int(meta["row_map"][sibling_sym, pos])
        sparse_id = int(meta["sparse_map"][sibling_sym, pos])
        if srow >= 0:
            source = (B_BANK, srow)
        elif sparse_id >= 0:
            source = (B_SPARSE, program.add_sparse(sparse_id))
        else:
            continue
        if emitted == 0:
            program.load(dst, *source)
        else:
            program.alu_src(M_OR, dst, dst, *source)
        emitted += 1
    if not emitted:
        program.load(dst, B_FULL)
        return dst + 1
    program.alu_src(M_XOR, dst, dst, B_FULL)  # NOT
    return dst + 1

def lower(engine, filter_expr) -> tuple[_Program, int]:
    """Compile the expression per partition (uniform mode) and flatten
    the synchronized IRs into one program. Serialized: uniform_compile is
    shared database state and the HTTP server lowers concurrently."""
    from ..query import ast
    from ..query.ir import HostEvaluator

    db = engine.db
    with engine._lower_lock:
        db.uniform_compile = True
        try:
            irs = [
                filter_expr.compile(db, partition, ast.NONE)
                for partition in db.partitions
            ]
        finally:
            db.uniform_compile = False

    program = _Program()
    evaluators = [HostEvaluator(n) for n in engine.part_rows]
    max_regs = _emit(engine, irs, program, evaluators, 0)
    if len(program.opcodes) > _LEN_BUCKETS[-1]:
        raise ProgramTooLarge(len(program.opcodes))
    if len(program.dyn_rows) > _DYN_BUCKETS[-1]:
        raise ProgramTooLarge(f"dyn rows {len(program.dyn_rows)}")
    if len(program.sparse_leaves) > engine.sparse_batch_cap:
        raise ProgramTooLarge(f"sparse leaves {len(program.sparse_leaves)}")
    if max_regs > MAX_REGS:
        raise ProgramTooLarge(f"registers {max_regs}")
    program.max_regs = max_regs
    return program, max_regs

def _as_source(engine, nodes: list, program: _Program, evaluators):
    """If the node set lowers to ONE gatherable b-operand, return
    (bsrc, operand) — the caller fuses it into its ALU op (one
    instruction per filter leaf). Returns None for subtrees."""
    node = nodes[0]
    node_type = type(node)
    if any(type(other) is not node_type for other in nodes[1:]):
        raise StructureMismatch([type(n).__name__ for n in nodes])
    if node_type is ir.Full:
        return (B_FULL, 0)
    if node_type is ir.Empty:
        return (B_ZERO, 0)
    if node_type is ir.Plane:
        refs = {n.static_ref for n in nodes}
        if len(refs) == 1 and node.static_ref is not None:
            return _static_ref_source(engine, program, node.static_ref)
        return (B_DYN, program.add_dyn([engine._pad(n.words) for n in nodes]))
    if node_type is ir.Selection and node.child is None:
        if any(n.child is not None for n in nodes):
            raise StructureMismatch("selection child")
        rows = [
            engine._pad(evaluator.evaluate(ir.Selection(n.predicates)))
            for evaluator, n in zip(evaluators, nodes)
        ]
        return (B_DYN, program.add_dyn(rows))
    return None

def _emit(engine, nodes: list, program: _Program, evaluators, dst: int) -> int:
    """Emit instructions leaving the subtree's result in reg[dst];
    returns the register high-water mark (registers are allocated like
    a stack: a node may freely use dst and everything above it)."""
    source = _as_source(engine, nodes, program, evaluators)
    if source is not None:
        program.load(dst, *source)
        return dst + 1
    node = nodes[0]
    node_type = type(node)
    if node_type is ir.Plane:
        # static ref needing majority reconstruction
        return _emit_static_ref(engine, program, node.static_ref, dst)
    if node_type is ir.Not:
        hw = _emit(engine, [n.child for n in nodes], program, evaluators, dst)
        program.alu_src(M_XOR, dst, dst, B_FULL)
        return hw
    if node_type in (ir.And, ir.Or):
        arity = len(node.children)
        if any(len(n.children) != arity for n in nodes):
            raise StructureMismatch("boolean arity")
        if arity == 0:
            # uniform mode skips ir.simplify, so empty And/Or reach here:
            # And identity = Full, Or identity = Empty
            program.load(dst, B_FULL if node_type is ir.And else B_ZERO)
            return dst + 1
        mode = M_AND if node_type is ir.And else M_OR
        hw = _emit(engine, [n.children[0] for n in nodes], program, evaluators,
                        dst)
        for i in range(1, arity):
            child = [n.children[i] for n in nodes]
            src = _as_source(engine, child, program, evaluators)
            if src is not None:
                program.alu_src(mode, dst, dst, *src)
            else:
                hw = max(hw, _emit(engine, child, program, evaluators, dst + 1))
                program.alu(mode, dst, dst, dst + 1)
        return hw
    if node_type is ir.Selection:
        # child is not None (childless Selections fuse as sources).
        # Predicates are host-evaluated into a dynamic row per partition.
        if any(n.child is None for n in nodes):
            raise StructureMismatch("selection child")
        rows = [
            engine._pad(evaluator.evaluate(ir.Selection(n.predicates)))
            for evaluator, n in zip(evaluators, nodes)
        ]
        idx = program.add_dyn(rows)
        hw = _emit(engine, [n.child for n in nodes], program, evaluators, dst)
        program.alu_src(M_AND, dst, dst, B_DYN, idx)
        return hw
    if node_type is ir.Threshold:
        arity = len(node.children)
        if any(
            len(n.children) != arity
            or n.k != node.k
            or n.match_exactly != node.match_exactly
            for n in nodes
        ):
            raise StructureMismatch("threshold")
        return _emit_threshold(engine, nodes, program, evaluators, dst)
    raise StructureMismatch(f"unknown node {node_type}")

def _emit_threshold(engine, nodes: list, program: _Program, evaluators,
                    dst: int) -> int:
    """k-of-n as a bit-sliced counter circuit over word registers (the
    device form of the reference's Threshold DP over bitmaps,
    threshold.cpp:64-137): P = ceil(log2(max(n, k)+1)) counter planes
    live in reg[dst..dst+P-1]; each child's result increments the
    counter with a ripple-carry adder (2 ALU ops per plane); a
    constant-comparator circuit (k is known at lowering) reduces the
    planes to the >= / == mask, landing in reg[dst]."""
    node = nodes[0]
    n, k = len(node.children), node.k
    planes_bits = max(1, max(n, k).bit_length())
    planes = [dst + j for j in range(planes_bits)]
    c0, c1, tmp = dst + planes_bits, dst + planes_bits + 1, dst + planes_bits + 2
    if tmp + 1 > MAX_REGS:
        raise ProgramTooLarge(f"threshold registers {tmp + 1}")
    for p in planes:
        program.load(p, B_ZERO)
    hw = tmp + 1
    for i in range(n):
        # child value = the incoming carry
        child = [m.children[i] for m in nodes]
        src = _as_source(engine, child, program, evaluators)
        if src is not None:
            program.load(c0, *src)
        else:
            hw = max(hw, _emit(engine, child, program, evaluators, c0))
        cur, nxt = c0, c1
        for p in planes:
            program.alu(M_AND, nxt, p, cur)   # carry out
            program.alu(M_XOR, p, p, cur)     # sum bit
            cur, nxt = nxt, cur
    # comparator, MSB down: eq in c0, (for >=) strictly-greater in c1
    program.load(c0, B_FULL)
    if not node.match_exactly:
        program.load(c1, B_ZERO)
    for j in reversed(range(planes_bits)):
        p = planes[j]
        if (k >> j) & 1:
            program.alu(M_AND, c0, c0, p)
        else:
            if not node.match_exactly:
                program.alu(M_AND, tmp, c0, p)
                program.alu(M_OR, c1, c1, tmp)
            program.alu(M_ANDN, c0, c0, p)
    if node.match_exactly:
        program.alu(M_MOVB, dst, 0, c0)
    else:
        program.alu(M_OR, dst, c1, c0)
    return hw
