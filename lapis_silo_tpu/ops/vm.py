"""Filter-VM ISA + interpreter/densify executable builders.

The register-machine instruction set, program container, shape buckets,
and the jitted executable builders (XLA while_loop interpreter, the CUDA
kernel route of ops/vm_kernel.py, densify / pool-update programs). Pure
functions of shapes — no engine state — split out of device_engine.py so
the engine module carries only placement, lowering glue, dispatch, and
the pool. See device_engine.py's module docstring for the design.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from . import sparse_stream

# Opcodes — a REGISTER machine, not a stack machine: every instruction
# performs exactly ONE unconditional register write
#     reg[dst] = mode(reg[ra], b)     b = one of six gatherable sources
# so the while_loop interpreter has no lax.switch over carried buffers. A
# switch-based stack VM measured ~66 us/instruction of pure overhead at
# W=32768 (the branch joins copy every carried buffer each instruction);
# the branchless select form is bounded by the actual word traffic — and
# since the per-instruction cost is opcode-independent, loads FUSE into
# the ALU op (one instruction per filter leaf, not two).
ALU = 0          # reg[dst] = mode(reg[ra], b(bsrc, operand/rb))
EMIT_COUNT = 1   # out[operand] = popcount(reg[ra]); used by batched queries
NOP = 2

# b-operand sources (regspec bits 28..31)
B_REG = 0     # reg[rb]
B_BANK = 1    # bank[operand]            (static plane row)
B_DYN = 2     # dyn[operand]             (per-query dynamic row)
B_SPARSE = 3  # sparse_rows[operand]     (densified sparse-tier row)
B_FULL = 4    # full_mask
B_ZERO = 5    # 0

# ALU modes (regspec bits 24..27). NOT(x) = XOR with b = full_mask (exact
# under the invariant that rows carry no bits beyond the valid sequences).
M_MOVB = 0  # b
M_AND = 1   # a & b
M_OR = 2    # a | b
M_XOR = 3   # a ^ b          (bit-sliced threshold adders; NOT via B_FULL)
M_ANDN = 4  # a & (b ^ full_mask)

# no-write destination sentinel: the register file carries one trailing
# trash slot and dynamic_update_index clamps out-of-range indices onto it
NO_DST = 255

# ---------------------------------------------------------------------------
# Wire format. _Program keeps the roomy host encoding above (operand i32 +
# regspec dst|ra<<8|rb<<16|mode<<24|bsrc<<28); what travels to the device is
# TWO i32 per instruction — operand, and a packed word that folds the opcode
# into a narrowed regspec.
# Packed layout (28 bits used):
#   dst bits 0-5 (NO_DST saturates to 63 -> still clamps onto the trash
#   slot), ra 6-11, rb 12-17, mode 18-21, bsrc 22-25, opcode 26-27.
# ---------------------------------------------------------------------------
WIRE_DST_MASK = 0x3F
WIRE_RA_SHIFT, WIRE_RB_SHIFT = 6, 12
WIRE_MODE_SHIFT, WIRE_BSRC_SHIFT, WIRE_OP_SHIFT = 18, 22, 26


def pack_wire(opcodes, regspec):
    """Vectorized host regspec+opcode -> packed wire word (int32)."""
    spec = np.asarray(regspec, dtype=np.int64)
    dst = np.minimum(spec & 0xFF, WIRE_DST_MASK)
    packed = (dst
              | (((spec >> 8) & 0x3F) << WIRE_RA_SHIFT)
              | (((spec >> 16) & 0x3F) << WIRE_RB_SHIFT)
              | (((spec >> 24) & 0xF) << WIRE_MODE_SHIFT)
              | (((spec >> 28) & 0xF) << WIRE_BSRC_SHIFT)
              | (np.asarray(opcodes, dtype=np.int64) << WIRE_OP_SHIFT))
    return packed.astype(np.int32)


# a padded wire slot: opcode NOP, dst -> trash, b-source B_REG (no DMA)
WIRE_NOP = int(pack_wire(np.int64(NOP), np.int64(NO_DST)))


def wire_opcode(packed):
    return (packed >> WIRE_OP_SHIFT) & 0x3


def wire_bsrc(packed):
    return (packed >> WIRE_BSRC_SHIFT) & 0xF


def pack_code_array(bucket: int, opcodes, operands, regspec) -> np.ndarray:
    """[2, bucket] wire code block: row 0 = operands, row 1 = packed words
    (NOP-padded tail)."""
    code = np.zeros((2, bucket), dtype=np.int32)
    code[1, :] = WIRE_NOP
    n = len(opcodes)
    if n:
        code[0, :n] = operands
        code[1, :n] = pack_wire(opcodes, regspec)
    return code

_LEN_BUCKETS = (16, 64, 256, 512)
# batched-count instruction buckets: the top rungs serve explicitly wide
# batched callers; serving paths pin SERVE_LEN_BUCKET
_BATCH_LEN_BUCKETS = (64, 256, 1024, 4096, 8192, 16384, 32768, 65536)
# the bucket serving paths converge on (one executable for all traffic)
SERVE_LEN_BUCKET = 8192
_DYN_BUCKETS = (1, 4, 16, 64, 256)
# sparse-leaf count per dispatch and per-leaf segment-length budget (the
# leaves gather straight from the device-resident CSR stream; the per-query
# upload is just leaf ids or (start, len) pairs). The engine caps K so the
# densified [K, PW] block stays under _SPARSE_K_BYTE_CAP (max_sparse_k).
_SPARSE_K_BUCKETS = (0, 4, 16, 64, 256, 1024, 2048, 4096)
# densified-block cap: sets max_sparse_k = the widest K bucket whose
# [K, PW] block fits. Wide batches split at max_sparse_k; a bigger cap
# saves splits but drags the ladder's E floor up to the worst case
# (top-max_k leaves).
_SPARSE_K_BYTE_CAP = 384 << 20
# flat per-partition entry budgets for the ragged densify. The densify's
# gather, scatter and cumsum passes run over the whole static budget, not
# the live entries, so bucket granularity multiplies sparse-batch cost;
# ~2x-stepped rungs keep the slack bounded. Each rung in live use is one
# (lazily compiled) executable.
_SPARSE_E_BUCKETS = (0, 4096, 32768, 262144, 1 << 19, 1 << 20, 1 << 21,
                     1 << 22, 1 << 23, 1 << 24)
# Per-dispatch query cap (the EMIT_COUNT output vector's length).
MAX_BATCH_QUERIES = 4096
MAX_REGS = 32
# register-file buckets: one executable per bucket; N-Of threshold circuits
# use ceil(log2(max(n,k)+1)) + 3 registers above their operand slot
_REG_BUCKETS = (4, 8, 16, MAX_REGS)
# instructions executed per while_loop iteration (callers round n_instr up
# to a multiple of this; iterations start at multiples of it, so the padded
# NOP tail inside the bucket is never overshot)
_UNROLL = 4


def _round_instr(n: int) -> int:
    return -(-n // _UNROLL) * _UNROLL

# Rows whose word-level density (nnz words / W, totalled over partitions)
# is below 1/SPARSE_DENSITY_CUTOFF move to the sparse tier. The tier
# auto-activates only when the projected ALL-DENSE bank would exceed the
# dense-bank budget (DeviceEngine: a share of device memory, override
# SILO_DENSE_BANK_BUDGET_GB) — dense count dispatches beat the densify
# path whenever dense fits.
SPARSE_DENSITY_CUTOFF = 8


def vm_path() -> str:
    """The VM's device path, from the platform JAX runs on: 'kernel' (the
    CUDA filter VM, ops/vm_kernel.py) on a GPU, 'xla' (the while_loop
    interpreter) on the CPU, where tests and references run. Any other
    platform has no path."""
    platform = jax.devices()[0].platform
    if platform == "gpu":
        return "kernel"
    if platform == "cpu":
        return "xla"
    raise RuntimeError(f"no device path for platform {platform!r}")


class StructureMismatch(Exception):
    """Per-partition IRs diverged structurally; caller falls back to host."""


class ProgramTooLarge(Exception):
    pass


class _Program:
    def __init__(self):
        self.opcodes: list[int] = []
        self.operands: list[int] = []
        self.regspec: list[int] = []  # dst | ra<<8 | rb<<16 | mode<<24
        self.dyn_rows: list[list[np.ndarray]] = []  # per dyn leaf: per partition words
        # per sparse leaf: the global sparse-row id — its per-partition
        # (start, len) slice of the device-resident CSR stream is resolved
        # at dispatch assembly and gathered+scattered on device
        self.sparse_leaves: list[int] = []
        self._sparse_cache: dict = {}
        self.max_regs = MAX_REGS

    def emit(self, opcode: int, operand: int = 0, dst: int = NO_DST,
             ra: int = 0, rb: int = 0, mode: int = 0, bsrc: int = B_REG):
        self.opcodes.append(opcode)
        self.operands.append(operand)
        self.regspec.append(
            dst | (ra << 8) | (rb << 16) | (mode << 24) | (bsrc << 28)
        )

    def alu(self, mode: int, dst: int, ra: int, rb: int = 0):
        """reg[dst] = mode(reg[ra], reg[rb])"""
        self.emit(ALU, 0, dst, ra, rb, mode)

    def alu_src(self, mode: int, dst: int, ra: int, bsrc: int, operand: int = 0):
        """reg[dst] = mode(reg[ra], <bsrc source>)"""
        self.emit(ALU, operand, dst, ra, 0, mode, bsrc)

    def load(self, dst: int, bsrc: int, operand: int = 0):
        """reg[dst] = <bsrc source>"""
        self.emit(ALU, operand, dst, 0, 0, M_MOVB, bsrc)

    def add_dyn(self, rows_per_partition: list[np.ndarray]) -> int:
        self.dyn_rows.append(rows_per_partition)
        return len(self.dyn_rows) - 1

    def add_sparse(self, sparse_row_id: int) -> int:
        cached = self._sparse_cache.get(sparse_row_id)
        if cached is not None:
            return cached
        self.sparse_leaves.append(sparse_row_id)
        leaf = len(self.sparse_leaves) - 1
        self._sparse_cache[sparse_row_id] = leaf
        return leaf



@functools.lru_cache(maxsize=None)
def _pool_update_jit(k_bucket: int, n_partitions: int, n_words: int,
                     mesh=None, e_budget: int = 0):
    """In-place hot-leaf-pool update: densify up to k_bucket leaves from
    the resident CSR stream and write them into their pool slots with
    `.at[slots].set`. The pool is donated, so XLA aliases the buffer.

    The per-leaf (start, len) bounds are static per snapshot, so they live
    device-resident (`bounds` [n_sparse + 1, 2, P] i32, uploaded once) and
    the dispatch ships only leaf ids + slots — 2 x k_bucket i32 in one
    packed blob. Padded ids point at the table's trailing all-zero
    sentinel row (no entries) with slots -> the scratch row. `e_budget` is
    the densify's static entry budget (the engine's worst case for K
    leaves).

    With `mesh`, the pool is word-sharded like the bank and each device
    densifies its own shard under shard_map via the window-local scatter
    (_densify_one with w_off): the stream is replicated, so no
    communication happens at all."""

    def gather_bounds(bounds, blob):
        ids = blob[:k_bucket]
        slots = blob[k_bucket:]
        b = bounds[ids]                      # [K, 2, P]
        return b[:, 0, :].reshape(-1), b[:, 1, :].reshape(-1), slots

    if mesh is None:
        def run(pool, stream_comb, bounds, blob):
            starts, lens, slots = gather_bounds(bounds, blob)
            rows = _densify_one(k_bucket, e_budget, n_words, n_partitions,
                                stream_comb, starts, lens)
            return pool.at[slots].set(rows)

        return jax.jit(run, donate_argnums=0)

    from jax.sharding import PartitionSpec as P

    n_dev = mesh.devices.size
    assert n_words % n_dev == 0, (n_words, n_dev)
    local_w = n_words // n_dev

    def local(pool_l, stream_full, starts_r, lens_r, slots_r):
        d = jax.lax.axis_index("seq")
        rows = _densify_one(k_bucket, e_budget, n_words, n_partitions,
                            stream_full, starts_r, lens_r,
                            w_off=d * local_w, local_words=local_w)
        return pool_l.at[slots_r].set(rows)

    sharded = jax.shard_map(
        local, mesh=mesh,
        in_specs=(P(None, "seq"), P(), P(), P(), P()),
        out_specs=P(None, "seq"), check_vma=False)

    def run(pool, stream_comb, bounds, blob):
        starts, lens, slots = gather_bounds(bounds, blob)
        return sharded(pool, stream_comb, starts, lens, slots)

    return jax.jit(run, donate_argnums=0)


# fused pool-update chunk counts: one executable per rung; misses beyond
# the top rung dispatch eagerly (rare — >4 x k_cap misses in one batch)
_POOL_CHUNK_BUCKETS = (0, 1, 2, 4)


@functools.lru_cache(maxsize=None)
def _pooled_update_vm_jit(program_len: int, n_rows: int, n_dyn: int,
                          pool_slots: int, n_words: int, output: str,
                          n_regs: int, n_chunks: int, k_bucket: int,
                          n_partitions: int, e_budget: int):
    """ONE dispatch for a pooled sparse batch: densify up to n_chunks
    update chunks into their (donated) pool slots, then run the VM over
    the refreshed pool — all inside a single XLA program.

    Blob layout: [code 2 x L, n_instr, then n_chunks x (k_bucket ids +
    k_bucket slots)]; padded ids point at the bounds table's sentinel
    row (len 0) with slots -> the scratch row."""
    vm = _interpreter(program_len, n_rows, n_dyn, pool_slots + 1, n_words,
                      output, n_regs, mesh=None)
    code_len = 2 * program_len

    def run(pool, bank, dyn, stream_comb, bounds, blob,
            full_masks):
        off = code_len + 1
        for c in range(n_chunks):
            ids = blob[off + 2 * c * k_bucket
                       : off + (2 * c + 1) * k_bucket]
            slots = blob[off + (2 * c + 1) * k_bucket
                         : off + (2 * c + 2) * k_bucket]
            b = bounds[ids]                      # [K, 2, P]
            rows = _densify_one(k_bucket, e_budget, n_words, n_partitions,
                                stream_comb, b[:, 0, :].reshape(-1),
                                b[:, 1, :].reshape(-1))
            pool = pool.at[slots].set(rows)
        counts = vm(blob[: code_len + 1], bank, dyn, pool, full_masks)
        return counts, pool

    return jax.jit(run, donate_argnums=0)


def _densify_one(n_sparse_k: int, n_sparse_e: int, n_words: int,
                 n_per_leaf: int, stream_comb, starts, lens,
                 w_off=None, local_words: int | None = None):
    """[K, PW] densified sparse-tier rows (global word space), via a FLAT
    ragged gather+scatter over an E-entry budget: work scales with the
    entry count, not the K x max-row-length rectangle. Slot -> segment
    mapping comes from a marker scatter + cummax (no searchsorted: its
    binary search would gather log K times per slot). The stream is
    PARTITION-major, so each leaf is n_per_leaf contiguous slices,
    seg = leaf * n_per_leaf + partition.

    `w_off` / `local_words` select the WINDOW-LOCAL form (mesh shard_map
    callers): only entries whose global word index falls in
    [w_off, w_off + local_words) scatter, into [K, local_words] rows in
    local coordinates — every device scans the replicated stream but
    writes only its own word shard, so a sharded densify needs no
    communication at all."""
    n_seg = n_sparse_k * n_per_leaf
    lens = lens.astype(jnp.int32)
    cum = jnp.cumsum(lens)                                    # [K*P] inclusive
    total = cum[-1]
    row_start = jnp.concatenate(
        [jnp.zeros(1, jnp.int32), cum[:-1]])                  # [K*P]
    seed_pos = jnp.where(lens > 0, row_start, n_sparse_e)
    delta = starts - row_start
    slots = jnp.arange(n_sparse_e, dtype=jnp.int32)
    s_idx = jnp.arange(n_seg, dtype=jnp.int32)
    # seed each segment's first slot with its index+1 (empty segments have
    # seed_pos = E -> dropped; non-empty starts are unique), cummax fills
    seed = jnp.zeros(n_sparse_e, jnp.int32).at[seed_pos].max(
        s_idx + 1, mode="drop")
    seg = jax.lax.cummax(seed) - 1                            # [E]
    seg_c = jnp.clip(seg, 0, n_seg - 1)
    src = jnp.clip(slots + delta[seg_c], 0,
                   stream_comb.shape[0] * 64 - 1)
    valid = (slots < total) & (seg >= 0)
    row = sparse_stream.comb_idx_row(src)
    gi = stream_comb[row, src & 127].astype(jnp.int32)
    gw = stream_comb[row + sparse_stream.COMBINE_WORD_ROW_OFF, src & 127]
    leaf = seg_c // n_per_leaf
    out_words = n_words if local_words is None else local_words
    if w_off is not None:
        valid = valid & (gi >= w_off) & (gi < w_off + out_words)
        gi = gi - w_off
    flat = jnp.where(valid, leaf * out_words + gi, n_sparse_k * out_words)
    out = jnp.zeros(n_sparse_k * out_words, jnp.uint32).at[flat].set(
        gw, mode="drop")
    return out.reshape(n_sparse_k, out_words)


@functools.lru_cache(maxsize=16)
def _densify_jit(n_sparse_k: int, n_sparse_e: int, n_words: int,
                 n_per_leaf: int):
    """Standalone densify executable (used by paths that keep densify as
    its own dispatch)."""
    return jax.jit(functools.partial(_densify_one, n_sparse_k,
                                     n_sparse_e, n_words, n_per_leaf))


@functools.lru_cache(maxsize=64)
def _interpreter(program_len: int, n_rows: int, n_dyn: int, n_sparse_k: int,
                 n_words: int, output: str = "words",
                 n_regs: int = MAX_REGS, n_sparse_e: int = 0,
                 n_per_leaf: int = 1, mesh=None,
                 resident_bounds: bool = False):
    """Jitted register-machine executable for one shape bucket, over the
    FLAT global word axis (n_words = partitions x per-partition words).
    output='words' returns the [PW] bitset (reg[0]); output='count' fuses
    the popcount reduction into the same executable (one dispatch);
    'multi_count' returns per-query EMIT_COUNT outputs.

    With n_sparse_e > 0 the sparse-leaf densification runs INSIDE the same
    executable (stream + per-leaf bounds in, [K, PW] block scattered on
    device) — sparse-touching queries stay a single dispatch. Otherwise
    densified rows arrive as a [K, PW] input.

    The VM body follows vm_path(): on a GPU the CUDA kernel
    (vm_kernel.vm_run; under shard_map with psum-merged counts on a mesh),
    on the CPU the XLA while_loop interpreter."""
    use_kernel = vm_path() == "kernel"
    if use_kernel:
        from . import vm_kernel

        vm_kernel.ensure_registered()

    def run_one(code, bank, dyn, sparse_rows, full_masks, n_instr):
        if use_kernel:
            split = output == "multi_count"
            if mesh is not None:
                return vm_kernel.vm_run_sharded(
                    mesh, code, n_instr, bank, dyn, sparse_rows, full_masks,
                    n_regs, split)
            return vm_kernel.vm_run(code, n_instr, bank, dyn, sparse_rows,
                                    full_masks, n_regs, split)
        base_run = build_run_one_with_emit(
            program_len, n_rows, n_dyn, n_words, n_sparse_k=n_sparse_k,
            n_regs=n_regs, with_emit=output == "multi_count")
        return base_run(code, bank, dyn, sparse_rows, full_masks, n_instr)

    def finish(words, outs):
        if output == "count":
            return jax.lax.population_count(words).astype(jnp.int32).sum(dtype=jnp.int32)
        if output == "multi_count":
            return outs  # [MAX_BATCH_QUERIES]
        if output.startswith("compact"):
            # row extraction fused into the SAME dispatch: selective
            # filters transfer (n_nonzero_words, first-cap indices, their
            # words) — KBs — instead of the full [PW] bitset; the caller
            # falls back to a full pull when the result overflows the cap
            cap = int(output.split(":")[1])
            nz = words != 0
            n_nz = nz.sum(dtype=jnp.int32)
            idx = jnp.nonzero(nz, size=cap, fill_value=0)[0].astype(jnp.int32)
            return n_nz, idx, words[idx], words
        return words

    code_len = 2 * program_len
    if n_sparse_e and n_sparse_k:
        densify = functools.partial(_densify_one, n_sparse_k, n_sparse_e,
                                    n_words, n_per_leaf)
        n_seg = n_sparse_k * n_per_leaf

        def densify_and_run(code, starts, lens, n_instr, bank, dyn,
                            stream_comb, full_masks):
            sparse_rows = densify(stream_comb, starts, lens)
            words, outs = run_one(code, bank, dyn, sparse_rows, full_masks,
                                  n_instr)
            return finish(words, outs)

        if resident_bounds:
            def run_fused_resident(blob, bank, dyn, stream_comb,
                                   full_masks, bounds):
                # per-leaf (start, len) bounds are static per snapshot and
                # live device-resident — the upload carries LEAF IDS only.
                # Padded ids point at the table's trailing all-zero
                # sentinel row.
                code = blob[:code_len].reshape(2, program_len)
                ids = blob[code_len : code_len + n_sparse_k]
                n_instr = blob[-1]
                b = bounds[ids]                      # [K, 2, P]
                starts = b[:, 0, :].reshape(-1)
                lens = b[:, 1, :].reshape(-1)
                return densify_and_run(code, starts, lens, n_instr, bank,
                                       dyn, stream_comb,
                                       full_masks)

            return jax.jit(run_fused_resident)

        def run_fused(blob, bank, dyn, stream_comb,
                      full_masks):
            # ONE packed upload: code + per-leaf bounds + n_instr
            code = blob[:code_len].reshape(2, program_len)
            starts = blob[code_len : code_len + n_seg]
            lens = blob[code_len + n_seg : code_len + 2 * n_seg]
            n_instr = blob[-1]
            return densify_and_run(code, starts, lens, n_instr, bank, dyn,
                                   stream_comb, full_masks)

        return jax.jit(run_fused)

    def run(blob, bank, dyn, sparse_rows, full_masks):
        # packed upload: code (2 x L) + trailing n_instr in one array
        code = blob[:code_len].reshape(2, program_len)
        words, outs = run_one(code, bank, dyn, sparse_rows, full_masks,
                              blob[code_len])
        return finish(words, outs)

    return jax.jit(run)


def build_run_one(program_len: int, n_rows: int, n_dyn: int, n_words: int,
                  n_regs: int = MAX_REGS):
    """VM body returning only the result words (the form parallel/mesh.py
    and __graft_entry__ jit over a mesh); executes the full padded program
    (NOPs write only the trash register)."""
    full = build_run_one_with_emit(program_len, n_rows, n_dyn, n_words,
                                   n_regs=n_regs, with_emit=False)

    def run_one(code, bank, dyn, full_mask):
        sparse_rows = jnp.zeros((1, dyn.shape[-1]), jnp.uint32)
        words, _outs = full(code, bank, dyn, sparse_rows, full_mask,
                            code.shape[1])
        return words

    return run_one


def build_run_one_with_emit(program_len: int, n_rows: int, n_dyn: int, n_words: int,
                            n_sparse_k: int = 0, n_regs: int = MAX_REGS,
                            with_emit: bool = True, unroll: int = _UNROLL):
    """The single-partition register-machine body (un-jitted). Returns
    (reg[0] words, EMIT_COUNT output vector). `n_instr` is a traced scalar:
    the while_loop executes only the real instructions, so one compiled
    executable serves every program length up to `program_len`.

    Every instruction is BRANCHLESS: it gathers the candidate rows, selects
    one by opcode/mode, and performs a single unconditional register write
    (no-write opcodes carry dst=NO_DST, which the clamped index maps onto a
    trailing trash slot). A lax.switch formulation measured ~66 us/instr of
    pure overhead at W=32768 — the branch joins copied every carried buffer
    per instruction; this form is bounded by actual word traffic.

    `start` (traced, default 0) begins execution mid-stream; with
    unroll=1 the loop stops exactly at n_instr (vm_kernel.reference_call
    runs query chunks this way)."""

    def run_one(code, bank, dyn, sparse_rows, full_mask, n_instr, start=0):
        operands, packed = code[0], code[1]
        zero_row = jnp.zeros((n_words,), jnp.uint32)

        def step(state):
            ip, regs, out = state
            operand = operands[ip]
            spec = packed[ip]
            opcode = (spec >> WIRE_OP_SHIFT) & 0x3
            dst = spec & WIRE_DST_MASK
            ra = (spec >> WIRE_RA_SHIFT) & 0x3F
            rb = (spec >> WIRE_RB_SHIFT) & 0x3F
            mode = (spec >> WIRE_MODE_SHIFT) & 0xF
            bsrc = (spec >> WIRE_BSRC_SHIFT) & 0xF

            # dynamic row slices (no vmap in sight — the partition axis is
            # folded into the word axis, so these lower to real
            # dynamic-slice ops, not gathers over the whole array)
            a = jax.lax.dynamic_index_in_dim(
                regs, jnp.minimum(ra, n_regs - 1), 0, keepdims=False)
            bank_row = jax.lax.dynamic_index_in_dim(
                bank, jnp.clip(operand, 0, n_rows - 1), 0, keepdims=False)
            dyn_row = jax.lax.dynamic_index_in_dim(
                dyn, jnp.clip(operand, 0, n_dyn - 1), 0, keepdims=False)
            sparse_row = jax.lax.dynamic_index_in_dim(
                sparse_rows, jnp.clip(operand, 0, max(n_sparse_k, 1) - 1), 0,
                keepdims=False)

            b = jnp.where(
                bsrc == B_REG, jax.lax.dynamic_index_in_dim(
                    regs, jnp.minimum(rb, n_regs - 1), 0, keepdims=False),
                jnp.where(
                    bsrc == B_BANK, bank_row,
                    jnp.where(
                        bsrc == B_DYN, dyn_row,
                        jnp.where(
                            bsrc == B_SPARSE, sparse_row,
                            jnp.where(bsrc == B_FULL, full_mask, zero_row),
                        ),
                    ),
                ),
            )
            val = jnp.where(
                mode == M_MOVB, b,
                jnp.where(
                    mode == M_AND, a & b,
                    jnp.where(
                        mode == M_OR, a | b,
                        jnp.where(mode == M_XOR, a ^ b, a & (b ^ full_mask)),
                    ),
                ),
            )
            # single unconditional write; dst=NO_DST clamps onto the trash
            # slot (index n_regs), so no-write opcodes stay branchless
            regs = jax.lax.dynamic_update_index_in_dim(
                regs, val, jnp.minimum(dst, n_regs), 0
            )
            if with_emit:
                count = jax.lax.population_count(a).astype(jnp.int32).sum(
                    dtype=jnp.int32)
                oi = jnp.where(opcode == EMIT_COUNT, operand,
                               MAX_BATCH_QUERIES)
                out = out.at[oi].set(count, mode="drop")
            return ip + 1, regs, out

        def step_unrolled(state):
            # execute `unroll` instructions per loop iteration to amortize
            # the while_loop's fixed per-iteration overhead (callers round
            # n_instr up; NOPs only write the trash slot)
            for _ in range(unroll):
                state = step(state)
            return state

        regs0 = jnp.zeros((n_regs + 1, n_words), jnp.uint32)
        out0 = jnp.zeros((MAX_BATCH_QUERIES,), jnp.int32)
        _, regs, out = jax.lax.while_loop(
            lambda state: state[0] < n_instr,
            step_unrolled,
            (jnp.asarray(start, jnp.int32), regs0, out0),
        )
        return regs[0], out

    return run_one

