"""Device (JAX/XLA) execution engine for filters and heavy reductions.

Design:

- The whole index lives on device as ONE static plane bank
  ``bank[P, R, W]`` (uint32): P partitions (padded to a common word count
  W), R = every (segment, symbol, position) row. Filters never re-upload
  index data.
- A filter compiles to a tiny *postfix program* over packed words — a stack
  machine with AND/OR/NOT/threshold-count ops. The interpreter is traced
  ONCE per (program-length bucket, depth, W) and reused for every query with
  that shape: no per-query XLA compiles. Per-partition data that is not in
  the static bank (indexed-column value bitmaps, metadata predicate masks,
  insertion search results) is packed into a small per-query dynamic bank
  ``dyn[P, D, W]``.
- Partitions fold into one flat word axis; on several devices that axis
  shards over a mesh and per-device results merge with psum.
- The VM runs as a CUDA kernel on a GPU (ops/vm_kernel.py) and as the XLA
  while_loop interpreter on the CPU (vm.vm_path).
- Mutations' per-(symbol, position) counts are one fused
  ``popcount(bank & filter)`` reduction over the whole bank — a
  bandwidth-bound pass that XLA emits as one fusion.

Replaces the reference's per-operator Roaring evaluation
(src/silo/query_engine/operators/*.cpp) and the TBB loops of
src/silo/query_engine/actions/mutations.cpp:140-166.
"""

from __future__ import annotations

import os

import jax
import jax.numpy as jnp
import numpy as np

from . import bitset


# Re-exported VM/reduction surface: the ISA, buckets, program container,
# and executable builders moved to ops/vm.py and ops/reductions.py; every
# existing `device_engine.X` reference (tests, scripts, __graft_entry__)
# keeps working through these names.
from .vm import (  # noqa: F401
    ALU, EMIT_COUNT, NOP,
    B_REG, B_BANK, B_DYN, B_SPARSE, B_FULL, B_ZERO,
    M_MOVB, M_AND, M_OR, M_XOR, M_ANDN, NO_DST,
    _LEN_BUCKETS, _BATCH_LEN_BUCKETS, SERVE_LEN_BUCKET, _DYN_BUCKETS,
    _SPARSE_K_BUCKETS, _SPARSE_K_BYTE_CAP,
    _SPARSE_E_BUCKETS, MAX_BATCH_QUERIES, MAX_REGS, _REG_BUCKETS, _UNROLL,
    SPARSE_DENSITY_CUTOFF,
    StructureMismatch, ProgramTooLarge, _Program,
    _round_instr, _pool_update_jit, _densify_one,
    _densify_jit, _interpreter, build_run_one, build_run_one_with_emit,
    pack_wire, pack_code_array, wire_opcode, wire_bsrc, WIRE_NOP,
)
from . import sparse_stream, vm
from .reductions import (  # noqa: F401
    _popcount_words_jit, _group_counts_jit, _boundary_sums,
    _sparse_mutation_counts_jit, _mutation_counts_jit,
)
from .vm_kernel import WORD_QUANTUM

# Shares of one device's memory (memory_stats()["bytes_limit"]). The dense
# bank may take DENSE_BANK_SHARE before the sparse tier turns on (override:
# SILO_DENSE_BANK_BUDGET_GB). The hot-leaf pool takes what the bank and the
# stream leave, less POOL_HEADROOM_SHARE for dispatch blocks and outputs,
# at most POOL_CEILING_SHARE (the donated pool's copy worst case), and
# nothing when that is under POOL_FLOOR_SHARE.
DENSE_BANK_SHARE = 0.75
POOL_CEILING_SHARE = 0.375
POOL_FLOOR_SHARE = 1 / 16
POOL_HEADROOM_SHARE = 1 / 8


def device_memory_bytes(device) -> int:
    """The memory one device offers JAX: its allocator's bytes_limit; on
    the CPU backend (tests, references) the host's physical memory."""
    stats = device.memory_stats()
    if stats and stats.get("bytes_limit"):
        return int(stats["bytes_limit"])
    if device.platform == "cpu":
        return os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES")
    raise RuntimeError(f"{device} reports no memory limit (memory_stats "
                       f"returned {stats!r})")


def dense_bank_budget_bytes(device) -> int:
    env = os.environ.get("SILO_DENSE_BANK_BUDGET_GB")
    if env is not None:
        return int(float(env) * 2**30)
    return int(DENSE_BANK_SHARE * device_memory_bytes(device))

class DeviceEngine:
    def __init__(self, database, devices=None, sparse_min_words: int | None = None):
        self.db = database
        partitions = database.partitions
        if not partitions:
            raise NotImplementedError("empty database")
        self.n_partitions = len(partitions)
        self.part_rows = [p.sequence_count for p in partitions]
        self.n_words = max(bitset.words_for(p.sequence_count) for p in partitions)

        # Multi-device: shard the packed GLOBAL word axis (partitions
        # folded into words) across all local devices — every VM op is
        # word-local; reductions become all-reduces inserted by XLA. One
        # device -> plain placement.
        devices = devices if devices is not None else jax.devices()
        n_dev = len(devices)
        if n_dev > 1:
            from jax.sharding import Mesh, NamedSharding, PartitionSpec

            self.mesh = Mesh(np.asarray(devices), ("seq",))
            self._words_sharding = NamedSharding(self.mesh, PartitionSpec("seq"))
            self._bank_sharding = NamedSharding(
                self.mesh, PartitionSpec(None, "seq"))
        else:
            self.mesh = None
            self._words_sharding = None
            self._bank_sharding = None
        # every device's share of the flat word axis splits into the VM
        # kernel's 16-byte vectors
        quantum = WORD_QUANTUM * n_dev
        self.n_words = -(-self.n_words // quantum) * quantum

        # COMPACT bank layout (the device analog of the reference's
        # majority-symbol deletion, position.cpp:101-127): per segment, keep
        # only (symbol, position) rows that have any bit in any partition AND
        # are not the (globally decided) majority symbol at that position.
        # - empty rows    -> LOAD_ZERO at compile time
        # - majority rows -> NOT(OR(stored sibling rows)) at compile time,
        #   and |filter| - sum(stored counts) in the Mutations reduction.
        # Global (cross-partition) decisions keep the program structure
        # partition-uniform.
        segments: list[tuple[str, str]] = [
            ("nuc", name) for name in sorted(database.nuc_sequences)
        ] + [("aa", name) for name in sorted(database.aa_sequences)]
        # TWO-TIER split (the CSR-of-words scale design): stored rows with
        # low word-level density move out of the dense bank into a flat CSR
        # stream — filter leaves densify them with one batched scatter
        # inside the dispatch (LOAD_SPARSE), Mutations reduces them with a
        # segment-sum. Rows that are some partition's implicit majority stay
        # dense (their content is a word-dense complement).
        segment_totals: dict[tuple[str, str], np.ndarray] = {}
        for kind, name in segments:
            totals = None
            for partition in partitions:
                seg = (partition.nuc_sequences[name] if kind == "nuc"
                       else partition.aa_sequences[name])
                cnt = seg.set_bits_matrix()  # cheap: stored counts + implicit
                totals = cnt if totals is None else totals + cnt
            segment_totals[(kind, name)] = totals
        if sparse_min_words is not None:
            # explicit threshold (tests): gate on the total row footprint
            self.sparse_enabled = (
                self.n_partitions * self.n_words >= sparse_min_words
            )
        else:
            # Auto: sparse only when the ALL-DENSE bank would not fit the
            # dense-bank budget — a dense count needs no densify pass, so
            # dense wins whenever it fits. Projected rows = stored rows if
            # every present (symbol, position) row stayed dense.
            projected_rows = 0
            for totals in segment_totals.values():
                present = totals > 0
                majority = np.argmax(totals, axis=0)
                present[majority, np.arange(totals.shape[1])] = False
                projected_rows += int(present.sum())
            projected_bytes = 4 * self.n_partitions * projected_rows * self.n_words
            self.sparse_enabled = (
                projected_bytes > dense_bank_budget_bytes(devices[0]))

        # per segment: row_map[S, L] (-1 empty/sparse, -2 majority, else
        # dense bank row), sparse_map[S, L] (-1 or global sparse row id),
        # majority[L], dense (sym_ids, pos_ids) in bank-row order,
        # sparse (sparse_sym_ids, sparse_pos_ids) with sparse_base.
        self.segment_meta: dict[tuple[str, str], dict] = {}
        offset = 0
        n_sparse = 0
        for kind, name in segments:
            totals = segment_totals[(kind, name)]
            majority = np.argmax(totals, axis=0)  # [L]
            s_count, length = totals.shape
            present = totals > 0
            present[majority, np.arange(length)] = False  # majority not stored
            sym_ids, pos_ids = np.nonzero(present)
            # pos-major order for cache-friendly sibling lookups
            order = np.lexsort((sym_ids, pos_ids))
            sym_ids, pos_ids = sym_ids[order], pos_ids[order]
            if self.sparse_enabled and len(sym_ids):
                total_nnz = np.zeros(len(sym_ids), dtype=np.int64)
                is_majority_somewhere = np.zeros(len(sym_ids), dtype=bool)
                for partition in partitions:
                    seg = (partition.nuc_sequences[name] if kind == "nuc"
                           else partition.aa_sequences[name])
                    local = seg.row_map[sym_ids, pos_ids]
                    is_majority_somewhere |= local == -2
                    stored_mask = local >= 0
                    nnz = seg.store.row_nnz()
                    total_nnz[stored_mask] += nnz[local[stored_mask]]
                sparse_mask = (~is_majority_somewhere) & (
                    total_nnz * SPARSE_DENSITY_CUTOFF
                    <= self.n_partitions * self.n_words
                )
            else:
                sparse_mask = np.zeros(len(sym_ids), dtype=bool)
            dense_sel = ~sparse_mask
            row_map = np.full((s_count, length), -1, dtype=np.int64)
            row_map[majority, np.arange(length)] = -2
            row_map[sym_ids[dense_sel], pos_ids[dense_sel]] = offset + np.arange(
                int(dense_sel.sum())
            )
            sparse_map = np.full((s_count, length), -1, dtype=np.int64)
            sparse_map[sym_ids[sparse_mask], pos_ids[sparse_mask]] = (
                n_sparse + np.arange(int(sparse_mask.sum()))
            )
            self.segment_meta[(kind, name)] = {
                "offset": offset, "n_stored": int(dense_sel.sum()),
                "length": length, "s_count": s_count, "row_map": row_map,
                "majority": majority, "totals": totals.astype(np.int64),
                "sym_ids": sym_ids[dense_sel], "pos_ids": pos_ids[dense_sel],
                "sparse_map": sparse_map, "sparse_base": n_sparse,
                "sparse_sym_ids": sym_ids[sparse_mask],
                "sparse_pos_ids": pos_ids[sparse_mask],
            }
            offset += int(dense_sel.sum())
            n_sparse += int(sparse_mask.sum())
        self.n_rows = max(offset, 1)
        self.n_sparse = n_sparse

        # Ingest-time row cardinalities (the reference's stored-cardinality
        # fast path, aggregated.cpp:58-66): a bank/sparse row's popcount
        # equals its (symbol, position) total from the segment count
        # matrices — dense rows reconstruct local-majority slices, which
        # totals already include — so single-leaf count queries need no
        # device work at all (DeviceEngine.host_count).
        dense_counts = np.zeros(self.n_rows, dtype=np.int64)
        sparse_counts = np.zeros(max(n_sparse, 1), dtype=np.int64)
        for meta in self.segment_meta.values():
            if meta["n_stored"]:
                dense_counts[
                    meta["offset"] : meta["offset"] + meta["n_stored"]
                ] = meta["totals"][meta["sym_ids"], meta["pos_ids"]]
            n_seg_sparse = len(meta["sparse_sym_ids"])
            if n_seg_sparse:
                sparse_counts[
                    meta["sparse_base"] : meta["sparse_base"] + n_seg_sparse
                ] = meta["totals"][meta["sparse_sym_ids"],
                                   meta["sparse_pos_ids"]]
        self._dense_row_counts = dense_counts
        self._sparse_row_counts = sparse_counts

        # Build bank[R, P*W]: GLOBAL WORD SPACE — the partition axis folds
        # into the word axis (every VM op is word-local; partition p's
        # sequences occupy the word slot [p*W, (p+1)*W)). Rows are
        # contiguous, which is what both the XLA row gathers and the CUDA
        # VM kernel's per-instruction row loads want.
        self.n_flat_words = self.n_partitions * self.n_words
        bank = np.zeros((self.n_rows, self.n_partitions, self.n_words),
                        dtype=np.uint32)
        for pi, partition in enumerate(partitions):
            w = bitset.words_for(partition.sequence_count)
            for kind, name in segments:
                seg = (
                    partition.nuc_sequences[name]
                    if kind == "nuc"
                    else partition.aa_sequences[name]
                )
                meta = self.segment_meta[(kind, name)]
                start, n_stored = meta["offset"], meta["n_stored"]
                if not n_stored:
                    continue
                # The host segment is compact too: gather its stored rows;
                # where the global row is this partition's implicit majority,
                # reconstruct (rare: per-partition majority disagreeing with
                # the global pick); elsewhere the row is empty here.
                idx = seg.row_map[meta["sym_ids"], meta["pos_ids"]]  # [n_stored]
                stored = np.nonzero(idx >= 0)[0]
                bank[start + stored, pi, :w] = seg.store.materialize(idx[stored])
                for j in np.nonzero(idx == -2)[0]:
                    bank[start + j, pi, :w] = seg.plane(
                        int(meta["sym_ids"][j]), int(meta["pos_ids"][j])
                    )
        self.bank = jax.device_put(
            bank.reshape(self.n_rows, self.n_flat_words), self._bank_sharding)
        full = np.zeros((self.n_partitions, self.n_words), dtype=np.uint32)
        for pi, partition in enumerate(partitions):
            w = bitset.words_for(partition.sequence_count)
            full[pi, :w] = partition.full
        self.full_masks = jax.device_put(
            full.reshape(self.n_flat_words), self._words_sharding)
        self._full_host = full  # [P, W]; host_count interprets against it

        # Flat GLOBAL sparse-tier CSR stream, device-resident: entries
        # (word idx in GLOBAL word space, word), sorted PARTITION-major
        # (partition, leaf, word). A leaf's entries are n_partitions
        # contiguous slices addressed by the per-(leaf, partition) bounds
        # (seg = leaf * P + pi). Serves BOTH the Mutations segmented
        # reduction (cumsum + boundary gather, no scatter) and LOAD_SPARSE
        # filter leaves (densify).
        if n_sparse:
            idx_chunks, word_chunks = [], []
            starts_pp = np.zeros((n_sparse, self.n_partitions), dtype=np.int64)
            lens_pp = np.zeros((n_sparse, self.n_partitions), dtype=np.int64)
            offset_e = 0
            for pi, partition in enumerate(partitions):
                for kind, name in segments:
                    meta = self.segment_meta[(kind, name)]
                    if not len(meta["sparse_sym_ids"]):
                        continue
                    seg = (partition.nuc_sequences[name] if kind == "nuc"
                           else partition.aa_sequences[name])
                    local = seg.row_map[meta["sparse_sym_ids"],
                                        meta["sparse_pos_ids"]]
                    stored = np.nonzero(local >= 0)[0]
                    if not len(stored):
                        continue
                    idx_arr, words_arr, lengths = seg.store.gather_rows_csr(
                        local[stored]
                    )
                    g_ids = (meta["sparse_base"] + stored).astype(np.int64)
                    within = np.zeros(len(lengths), dtype=np.int64)
                    np.cumsum(lengths[:-1], out=within[1:])
                    starts_pp[g_ids, pi] = offset_e + within
                    lens_pp[g_ids, pi] = lengths
                    offset_e += int(lengths.sum())
                    idx_chunks.append(
                        idx_arr.astype(np.int64) + pi * self.n_words)
                    word_chunks.append(words_arr)
            if idx_chunks:
                idx = np.concatenate(idx_chunks)
                words = np.concatenate(word_chunks)
            else:
                idx = np.zeros(0, np.int64)
                words = np.zeros(0, np.uint32)
            self.sparse_lengths = lens_pp.sum(axis=1)  # per-leaf totals
            self.sparse_starts_pp = starts_pp
            self.sparse_lengths_pp = lens_pp
            # (densify's gather clips indices and masks by each leaf's
            # length, so over-reads never escape; pad words stay 0 so they
            # contribute nothing to the Mutations reduction.) The combined
            # stream needs E to be a COMBINE_BLOCK multiple; on a mesh the
            # sharded Mutations reduction splits the ENTRY axis evenly.
            quantum_e = sparse_stream.COMBINE_BLOCK * n_dev
            nnz_pad = -(-max(1, len(idx)) // quantum_e) * quantum_e
            sp_idx = np.zeros(nnz_pad, dtype=np.int32)
            sp_words = np.zeros(nnz_pad, dtype=np.uint32)
            sp_idx[: len(idx)] = idx
            sp_words[: len(words)] = words
            # ONE combined device array (sparse_stream.combine_stream). On
            # a mesh the stream is REPLICATED per device (the dense bank is
            # what dominates device memory; replication lets both the
            # window-local sharded densify and the entry-split sharded
            # Mutations reduction run with zero stream communication).
            self.sparse_stream = (
                self._put_repl(sparse_stream.combine_stream(sp_idx, sp_words)),)
            # Mutations-reduction bounds: one (start, len) per
            # (leaf, partition) segment, flattened seg = leaf * P + pi
            self._sparse_bounds_dev = (
                self._put_repl(starts_pp.reshape(-1).astype(np.int32)),
                self._put_repl(lens_pp.reshape(-1).astype(np.int32)),
            )
        else:
            self.sparse_starts_pp = self.sparse_lengths_pp = None
            self.sparse_stream = None
            self.sparse_lengths = None
            self._sparse_bounds_dev = None
        self._sparse_counts_memo: tuple | None = None
        self._filters_memo: tuple | None = None
        # Serving floors: pin the sparse K/M buckets corpus-wide so every
        # dispatch shape collapses onto one executable per output kind
        # (shapes must not proliferate compiles under live traffic).
        self.max_sparse_k = max(
            (b for b in _SPARSE_K_BUCKETS
             if b * self.n_flat_words * 4 <= _SPARSE_K_BYTE_CAP),
            default=_SPARSE_K_BUCKETS[1])
        if n_sparse:
            self.floor_sparse_k = self.max_sparse_k
            # Shape LADDER: the fused densify costs per gathered/scattered
            # budget ENTRY per dispatch, so pinning every dispatch to the
            # max floors would make single sparse queries pay the whole
            # corpus's worst case. Queries ride the smallest rung covering their leaves' TOTAL
            # entry count; each rung is one (lazily compiled) executable.
            lens_desc = np.sort(self.sparse_lengths)[::-1]
            e_small_needed = int(lens_desc[:16].sum())
            e_big_needed = int(lens_desc[: self.max_sparse_k].sum())
            e_bucket = lambda n: next(  # noqa: E731
                (b for b in _SPARSE_E_BUCKETS if b >= n),
                _SPARSE_E_BUCKETS[-1])
            e_small = e_bucket(e_small_needed)
            self.floor_sparse_e = e_bucket(e_big_needed)
            # typical-case rung sized by the MEDIAN leaf (the defensive
            # top-k sizing above covers any 16 leaves, but would make a
            # light 3-leaf query densify the worst case's slot budget);
            # queries whose leaves exceed a rung
            # simply fall through to the next one
            e_typ = e_bucket(4 * float(np.median(self.sparse_lengths)))
            self.sparse_shape_ladder = []
            for shape in ((4, e_typ), (16, e_small),
                          (16, self.floor_sparse_e),
                          (self.floor_sparse_k, self.floor_sparse_e)):
                if shape not in self.sparse_shape_ladder:
                    self.sparse_shape_ladder.append(shape)
        else:
            self.floor_sparse_k = 0
            self.floor_sparse_e = 0
            self.sparse_shape_ladder = []
        self._filter_cache: dict = {}
        import threading

        self._lower_lock = threading.Lock()
        self._batcher: _MicroBatcher | None = None
        from collections import OrderedDict

        self._program_memo: "OrderedDict[str, tuple]" = OrderedDict()
        self._program_memo_lock = threading.Lock()

        # HOT-LEAF POOL: a device-resident [C+1, PW] cache of densified
        # sparse-leaf rows, LRU-managed by leaf id. Serving workloads
        # repeat filters, so the same leaves come back batch after batch —
        # with the pool they densify ONCE (in place, via the pool update)
        # and every later dispatch reads the resident row like a bank row.
        # This is the dynamic form of per-leaf dense/sparse placement: hot
        # rows live dense, cold rows stream. Sized from device memory
        # (see the *_SHARE constants; override SILO_LEAF_POOL_GB).
        # Per-DEVICE accounting: the bank and pool shard over the mesh
        # (1/n_dev of their words per device); the stream is replicated.
        env_pool_gb = os.environ.get("SILO_LEAF_POOL_GB")
        if env_pool_gb is not None:
            pool_budget = float(env_pool_gb) * 2**30
        else:
            limit = device_memory_bytes(devices[0])
            bank_bytes = 4 * self.n_rows * self.n_flat_words // n_dev
            stream_bytes = (sum(int(a.nbytes) for a in self.sparse_stream)
                            if self.sparse_stream is not None else 0)
            free = limit - bank_bytes - stream_bytes
            pool_budget = min(POOL_CEILING_SHARE * limit,
                              free - POOL_HEADROOM_SHARE * limit)
            if pool_budget < POOL_FLOOR_SHARE * limit:
                # no real headroom (huge bank or stream): run the poolless
                # densify path instead of pushing the device past its
                # memory at init
                pool_budget = 0
        row_bytes = 4 * self.n_flat_words // n_dev
        want_slots = int(pool_budget // row_bytes)
        self.pool_slots = 0
        # Mesh engines keep the pool too: it shards along the word axis
        # exactly like the bank, updates densify per shard (window-local
        # scatter, zero communication), and the VM reads resident pool
        # rows like a second bank.
        if (n_sparse > 0
                and os.environ.get("SILO_LEAF_POOL", "1") != "0"
                and want_slots >= 64):
            # never more slots than leaves exist (+1 scratch), cap the
            # upside so small corpora don't allocate pointlessly
            self.pool_slots = min(want_slots, n_sparse, 8192)
        self.leaf_pool = None  # allocated on first use (_ensure_resident)
        # per-leaf (start, len) bounds are static per snapshot: resident
        # on device so a pool update ships only leaf ids + slots.
        # Trailing all-zero sentinel row serves padded ids. Built lazily
        # with the pool.
        self._leaf_bounds_table = None
        self._pool_e_budgets: dict[int, int] = {}
        self._leaf_slot: "OrderedDict[int, int]" = OrderedDict()  # LRU
        # Segmented LRU: leaves hit on a SECOND distinct call promote into
        # _protected (recency-ordered, capped at 80% of slots); eviction
        # takes probationary (unprotected) LRU victims first, so a cold
        # full-corpus scan — every leaf touched once — cannot flush the
        # repeatedly-hit serving working set out of the pool.
        self._protected: "OrderedDict[int, None]" = OrderedDict()
        self._protected_cap = max(1, (self.pool_slots * 4) // 5)
        self._free_slots: list[int] = []
        self._pool_lock = threading.RLock()
        # observability: cumulative miss/update traffic (a working set
        # slightly over the slot count shows up as steady-state miss churn
        # here long before it shows up in latency)
        self.pool_hits = 0
        self.pool_misses = 0
        self.pool_update_dispatches = 0
        self.pool_fused_chunks = 0
        # pool updates chunk misses at the densify-block cap: each chunk
        # materializes a [K, PW] block before it lands in the pool
        self._pool_update_k_cap = self.max_sparse_k
        # batch-wide sparse-leaf cap: poolless engines split at the densify
        # block cap; pooled ones at the slot count (all of a dispatch's
        # leaves must be resident simultaneously)
        self.sparse_batch_cap = self.pool_slots or self.max_sparse_k

    def stats(self) -> dict:
        """Placement and pool counters for /info?tpu=true."""
        device = (self.mesh.devices.flat[0] if self.mesh is not None
                  else self.bank.devices().pop())
        return {
            "platform": device.platform,
            "deviceKind": device.device_kind,
            "devices": 1 if self.mesh is None else int(self.mesh.devices.size),
            "vmPath": vm.vm_path(),
            "denseRows": int(self.n_rows),
            "sparseRows": int(self.n_sparse),
            "poolSlots": int(self.pool_slots),
            "poolHits": int(self.pool_hits),
            "poolMisses": int(self.pool_misses),
        }

    # -- hot-leaf pool -----------------------------------------------------

    def _alloc_pool(self) -> jax.Array:
        """The zeroed [C+1, PW] pool, word-sharded like the bank on a mesh
        (allocated straight into the sharded layout — a host round-trip
        for a multi-GB pool would be pointless)."""
        shape = (self.pool_slots + 1, self.n_flat_words)
        if self.mesh is None:
            return jnp.zeros(shape, jnp.uint32)
        return jax.jit(lambda: jnp.zeros(shape, jnp.uint32),
                       out_shardings=self._bank_sharding)()

    def _pool_e_budget(self, k_bucket: int) -> int:
        """Static per-(snapshot, K bucket) entry budget for the pool
        update's densify (worst case: the K longest leaves) — one
        executable per K bucket, shared by warm-up and every runtime
        chunk."""
        cached = self._pool_e_budgets.get(k_bucket)
        if cached is None:
            lens_desc = np.sort(self.sparse_lengths)[::-1]
            needed = max(int(lens_desc[:k_bucket].sum()), 1)
            cached = next((b for b in _SPARSE_E_BUCKETS if b >= needed),
                          1 << (int(needed - 1).bit_length()))
            self._pool_e_budgets[k_bucket] = cached
        return cached

    def _plan_residency(self, leaf_ids: list[int]):
        """Slot-assign every leaf (LRU bookkeeping) and return
        (leaf id -> slot, update chunks): each chunk is an (ids, slots)
        pair of <= _pool_update_k_cap misses to densify. The caller fuses
        the chunks into the VM dispatch (one XLA program may hold several
        densify blocks) so a cold sub-batch costs ONE dispatch; overflow
        chunks beyond the fused bucket run eagerly. Caller holds
        _pool_lock; stream ordering makes it safe to overwrite an evicted
        slot while earlier-enqueued VMs still reference it — they execute
        first on the single device queue."""
        C = self.pool_slots
        if self.leaf_pool is None:
            self.leaf_pool = self._alloc_pool()
            self._free_slots = list(range(C))
        slot_map: dict[int, int] = {}
        misses: list[int] = []
        for leaf in leaf_ids:
            slot = self._leaf_slot.get(leaf)
            if slot is not None:
                self._leaf_slot.move_to_end(leaf)
                # second distinct touch -> protected segment (SLRU)
                self._protected[leaf] = None
                self._protected.move_to_end(leaf)
                if len(self._protected) > self._protected_cap:
                    self._protected.popitem(last=False)  # demote, stays resident
                slot_map[leaf] = slot
            else:
                misses.append(leaf)
        self.pool_hits += len(slot_map)
        self.pool_misses += len(misses)
        if not misses:
            return slot_map, []
        needed = set(leaf_ids)
        n_evict = len(misses) - len(self._free_slots)
        victims: list[int] = []
        if n_evict > 0:
            # one pass in global LRU order: probationary victims first,
            # protected LRU only when probation can't cover the misses
            protected_spare: list[int] = []
            for old in self._leaf_slot:
                if old in needed:
                    continue
                if old in self._protected:
                    protected_spare.append(old)
                else:
                    victims.append(old)
                    if len(victims) == n_evict:
                        break
            if len(victims) < n_evict:
                victims.extend(protected_spare[: n_evict - len(victims)])
            if len(victims) < n_evict:
                raise ProgramTooLarge(
                    f"leaf pool ({C} slots) smaller than one batch")
        victims.reverse()  # pop() below takes probationary-LRU first
        for leaf in misses:
            if self._free_slots:
                slot = self._free_slots.pop()
            else:
                old = victims.pop()
                slot = self._leaf_slot.pop(old)
                self._protected.pop(old, None)
            self._leaf_slot[leaf] = slot
            slot_map[leaf] = slot
        step = self._pool_update_k_cap
        chunks = [(misses[i : i + step],
                   [slot_map[leaf] for leaf in misses[i : i + step]])
                  for i in range(0, len(misses), step)]
        return slot_map, chunks

    def _drop_pool(self):
        """A failed update must not leave the cache claiming leaves are
        resident (their slots were never written — every later hit would
        silently read wrong rows), and a donated-then-failed execution
        may have invalidated the pool handle itself. The pool is a cache:
        drop it wholesale and let the next dispatch reallocate."""
        self.leaf_pool = None
        self._leaf_slot.clear()
        self._protected.clear()
        self._free_slots = []

    def _eager_update_chunks(self, chunks) -> None:
        """Dispatch update chunks as standalone executions (overflow past
        the fused bucket, and warm-up). Caller holds _pool_lock."""
        C = self.pool_slots
        n_p = self.n_partitions
        bounds = self._ensure_bounds_dev()
        try:
            for chunk, slots in chunks:
                k_bucket = next(b for b in _SPARSE_K_BUCKETS[1:]
                                if b >= len(chunk))
                blob = np.full(2 * k_bucket, self.n_sparse, dtype=np.int32)
                blob[: len(chunk)] = chunk
                blob[k_bucket:] = C  # pad slots -> scratch row
                blob[k_bucket : k_bucket + len(slots)] = slots
                run = _pool_update_jit(k_bucket, n_p, self.n_flat_words,
                                       self.mesh,
                                       self._pool_e_budget(k_bucket))
                self.leaf_pool = run(
                    self.leaf_pool, self.sparse_stream[0],
                    bounds, jax.device_put(blob))
                self.pool_update_dispatches += 1
        except Exception:
            self._drop_pool()
            raise

    def _ensure_bounds_dev(self):
        if self._leaf_bounds_table is None:
            table = np.zeros((self.n_sparse + 1, 2, self.n_partitions),
                             dtype=np.int32)
            table[: self.n_sparse, 0, :] = self.sparse_starts_pp
            table[: self.n_sparse, 1, :] = self.sparse_lengths_pp
            self._leaf_bounds_table = self._put_repl(table)
        return self._leaf_bounds_table

    def warm_pool_updates(self):
        """Pre-compile every pool-update K bucket (the watcher calls this
        before a snapshot goes live): a no-op update per bucket — zero
        lengths, every slot pointed at the scratch row — touches the
        executable without changing any resident leaf."""
        if not self.pool_slots:
            return
        with self._pool_lock:
            if self.leaf_pool is None:
                self.leaf_pool = self._alloc_pool()
                self._free_slots = list(range(self.pool_slots))
            n_p = self.n_partitions
            bounds = self._ensure_bounds_dev()
            for k_bucket in _SPARSE_K_BUCKETS[1:]:
                if k_bucket > min(self.pool_slots, self._pool_update_k_cap):
                    break
                blob = np.full(2 * k_bucket, self.n_sparse, dtype=np.int32)
                blob[k_bucket:] = self.pool_slots  # scratch row
                run = _pool_update_jit(k_bucket, n_p, self.n_flat_words,
                                       self.mesh, self._pool_e_budget(k_bucket))
                self.leaf_pool = run(
                    self.leaf_pool, self.sparse_stream[0],
                    bounds, jax.device_put(blob))

    def _rewrite_sparse_operands(self, code: np.ndarray,
                                 leaf_ids: list[int],
                                 slot_map: dict[int, int]) -> np.ndarray:
        """B_SPARSE operands index the program's leaf list; the pooled VM
        reads pool slots instead."""
        mask = ((vm.wire_opcode(code[1]) == ALU)
                & (vm.wire_bsrc(code[1]) == B_SPARSE))
        if not mask.any():
            return code
        table = np.asarray([slot_map[leaf] for leaf in leaf_ids],
                           dtype=code.dtype)
        code = code.copy()
        code[0, mask] = table[code[0, mask]]
        return code

    # -- lowering ---------------------------------------------------------

    # -- lowering (ops/lowering.py) ---------------------------------------

    def lower(self, filter_expr):
        """Compile a filter to ONE partition-uniform VM program; see
        ops/lowering.py."""
        from . import lowering

        return lowering.lower(self, filter_expr)


    def _pad(self, words: np.ndarray) -> np.ndarray:
        if len(words) == self.n_words:
            return words
        out = np.zeros(self.n_words, dtype=np.uint32)
        out[: len(words)] = words
        return out

    # -- execution ----------------------------------------------------------

    def evaluate(self, filter_expr) -> list[np.ndarray]:
        """Returns per-partition packed bitsets (host numpy, trimmed)."""
        device_words = self.evaluate_device(filter_expr)
        host = np.ascontiguousarray(np.asarray(device_words)).reshape(
            self.n_partitions, self.n_words)
        return [
            host[pi, : bitset.words_for(n)] for pi, n in enumerate(self.part_rows)
        ]

    # device->host transfers below this size don't beat the fused-extract
    # dispatch's own cost; small corpora just pull the full bitset
    COMPACT_MIN_WORDS = 131072
    COMPACT_CAP_WORDS = 16384

    def evaluate_compact(self, filter_expr) -> list[np.ndarray]:
        """evaluate() for row-materializing actions at scale (SURVEY "hard
        parts": popcount-prefix-sum + index gather): the VM dispatch fuses
        a nonzero-word extraction, so a selective filter on a 10M-row
        corpus transfers ~KBs of (index, word) pairs — not the full [P, W]
        bitset — and the action reconstructs it host-side. Overflowing the
        cap falls back to pulling the full bitset (already computed, same
        dispatch: no second device pass)."""
        if self.n_flat_words < self.COMPACT_MIN_WORDS:
            return self.evaluate(filter_expr)
        program, _regs = self.lower(filter_expr)
        if len(program.opcodes) == 1 and program.opcodes[0] == ALU:
            spec = program.regspec[0]
            if ((spec >> 24) & 0xF == M_MOVB
                    and (spec >> 28) & 0xF in (B_FULL, B_ZERO)):
                return self.evaluate(filter_expr)  # trivial short-circuits
        (bucket, n_dyn, code, dyn, n_instr, k, m, sp,
         n_regs) = self._prepare_program(program)
        shape = (n_dyn, self.n_flat_words)
        dyn_dev = self._zero_dyn(shape) if dyn is None else self._put_dyn(dyn)
        cap = self.COMPACT_CAP_WORDS
        n_nz, idx, vals, words = self._dispatch(
            bucket, n_dyn, code, dyn_dev, k, m, sp, n_regs,
            f"compact:{cap}", n_instr,
            sparse_leaf_ids=program.sparse_leaves)
        if int(n_nz) > cap:
            host = np.ascontiguousarray(np.asarray(words))
        else:
            n = int(n_nz)
            host = np.zeros(self.n_flat_words, dtype=np.uint32)
            host[np.asarray(idx)[:n]] = np.asarray(vals)[:n]
        host = host.reshape(self.n_partitions, self.n_words)
        return [
            host[pi, : bitset.words_for(nr)]
            for pi, nr in enumerate(self.part_rows)
        ]

    def _prepare(self, filter_expr):
        return self._prepare_program(self.lower(filter_expr)[0])

    def _prepare_program(self, program: _Program):
        """(bucket, n_dyn, code[2, bucket] wire block, dyn host array |
        None, n_instr, sparse_k, sparse_m, sparse descriptor arrays,
        n_regs)."""
        n = len(program.opcodes)
        bucket = next(b for b in _LEN_BUCKETS if b >= n)
        code = vm.pack_code_array(bucket, program.opcodes, program.operands,
                                  program.regspec)
        n_dyn = next(b for b in _DYN_BUCKETS if b >= len(program.dyn_rows))
        if program.dyn_rows:
            dyn = np.zeros((n_dyn, self.n_partitions, self.n_words),
                           dtype=np.uint32)
            for di, rows in enumerate(program.dyn_rows):
                for pi, row in enumerate(rows):
                    dyn[di, pi] = row
            dyn = dyn.reshape(n_dyn, self.n_flat_words)
        else:
            dyn = None
        if self.pool_slots:
            sparse_k, sparse_m, sparse_arrays = (
                len(program.sparse_leaves), 0, None)
        else:
            sparse_k, sparse_m, sparse_arrays = self._assemble_sparse(
                program.sparse_leaves, *self.sparse_floors([program])
            )
        n_regs = next(b for b in _REG_BUCKETS if b >= program.max_regs)
        return (bucket, n_dyn, code, dyn, n, sparse_k, sparse_m, sparse_arrays,
                n_regs)

    def sparse_floors(self, programs) -> tuple[int, int]:
        """Smallest ladder rung covering the programs' sparse needs; falls
        back to natural (unpinned) buckets when nothing fits. Pooled
        engines have no densify shapes to pin."""
        leaves = sorted({r for p in programs for r in p.sparse_leaves})
        if not leaves or not self.sparse_shape_ladder or self.pool_slots:
            return (0, 0)
        k_act = len(leaves)
        e_act = int(self.sparse_lengths[leaves].sum())
        for k, e in self.sparse_shape_ladder:
            if k_act <= k and e_act <= e:
                return (k, e)
        return (0, 0)

    def _assemble_sparse(self, sparse_leaves: list[int], min_sparse_k: int = 0,
                         min_sparse_e: int = 0):
        """Per-query sparse-leaf descriptors: (start, len) into the resident
        GLOBAL CSR stream — n_partitions contiguous slices per leaf
        (partition-major stream), flattened seg = leaf * P + pi. Returns
        (K_bucket, E_bucket, (starts, lens) numpy [K*P] arrays), E being the
        flat ragged-entry budget. The floors let callers share one compiled
        executable across differently-shaped queries."""
        if not sparse_leaves:
            # no sparse leaves: skip the densify dispatch entirely (floors
            # only pin buckets for queries that DO touch the sparse tier)
            return 0, 0, None
        min_sparse_k = min(min_sparse_k, self.max_sparse_k)
        min_sparse_e = min(min_sparse_e, _SPARSE_E_BUCKETS[-1])
        k_bucket = next(
            b for b in _SPARSE_K_BUCKETS
            if b >= max(len(sparse_leaves), min_sparse_k)
        )
        ids = np.asarray(sparse_leaves, dtype=np.int64)
        n_p = self.n_partitions
        starts = np.zeros(k_bucket * n_p, dtype=np.int64)
        lens = np.zeros(k_bucket * n_p, dtype=np.int64)
        if len(ids):
            starts[: len(ids) * n_p] = self.sparse_starts_pp[ids].reshape(-1)
            lens[: len(ids) * n_p] = self.sparse_lengths_pp[ids].reshape(-1)
        e_needed = max(int(lens.sum()), min_sparse_e)
        try:
            e_bucket = next(b for b in _SPARSE_E_BUCKETS if b >= e_needed)
        except StopIteration:
            raise ProgramTooLarge(f"sparse entries {e_needed}") from None
        if len(ids) and int(starts.max() + lens.max()) > np.iinfo(np.int32).max:
            # stream offsets travel as int32 (program blob); a >2^31-entry
            # stream (8.6 GB of indices alone) is beyond one chip anyway
            raise ProgramTooLarge("sparse stream offsets exceed int32")
        ids_padded = np.full(k_bucket, self.n_sparse, dtype=np.int32)
        ids_padded[: len(ids)] = ids
        return k_bucket, max(e_bucket, 1), (starts.astype(np.int32),
                                            lens.astype(np.int32),
                                            ids_padded)

    def _zero_sparse_rows(self) -> jax.Array:
        """Cached [1, PW] zeros: the sparse-rows operand of dispatches whose
        queries touch no sparse leaf (word-sharded like dyn rows)."""
        key = "zero_sparse_rows"
        cached = self._filter_cache.get(key)
        if cached is None:
            cached = self._put_dyn(np.zeros(
                (1, self.n_flat_words), dtype=np.uint32))
            self._filter_cache[key] = cached
        return cached

    def _dyn_sharding(self, ndim: int):
        if self.mesh is None:
            return None
        from jax.sharding import NamedSharding, PartitionSpec

        spec = [None] * (ndim - 1) + ["seq"]
        return NamedSharding(self.mesh, PartitionSpec(*spec))

    def _put_dyn(self, array: np.ndarray) -> jax.Array:
        return jax.device_put(array, self._dyn_sharding(array.ndim))

    def _put_repl(self, array: np.ndarray) -> jax.Array:
        """device_put REPLICATED across the mesh (plain placement off-mesh)
        — for resident tables every device reads whole (the sparse CSR
        stream, the leaf-bounds tables)."""
        if self.mesh is None:
            return jax.device_put(array)
        from jax.sharding import NamedSharding, PartitionSpec

        return jax.device_put(array, NamedSharding(
            self.mesh, PartitionSpec(*(None,) * array.ndim)))

    def _zero_dyn(self, shape) -> jax.Array:
        """Cached all-zero dynamic bank: the hot path for data-free queries
        transfers only the tiny program array."""
        key = ("zero_dyn", shape)
        cached = self._filter_cache.get(key)
        if cached is None:
            cached = self._put_dyn(np.zeros(shape, dtype=np.uint32))
            self._filter_cache[key] = cached
        return cached

    def evaluate_device(self, filter_expr) -> jax.Array:
        """Returns the FLAT [PW] global-word filter bitset on device
        (partition p's words live at [p*W, (p+1)*W); reshape host-side or
        inside a consuming jit)."""
        program, _regs = self.lower(filter_expr)
        # trivial filters skip the VM dispatch (and its executable) entirely
        if len(program.opcodes) == 1 and program.opcodes[0] == ALU:
            spec = program.regspec[0]
            if (spec >> 24) & 0xF == M_MOVB:
                if (spec >> 28) & 0xF == B_FULL:
                    return self.full_masks
                if (spec >> 28) & 0xF == B_ZERO:
                    return self._zero_dyn((self.n_flat_words,))
        (bucket, n_dyn, code, dyn, n_instr, k, m, sp,
         n_regs) = self._prepare_program(program)
        shape = (n_dyn, self.n_flat_words)
        dyn_dev = self._zero_dyn(shape) if dyn is None else self._put_dyn(dyn)
        return self._dispatch(bucket, n_dyn, code, dyn_dev, k, m, sp, n_regs,
                              "words", n_instr,
                              sparse_leaf_ids=program.sparse_leaves)

    def _dispatch(self, bucket, n_dyn, code, dyn_dev, k, m, sp, n_regs,
                  output, n_instr, sparse_leaf_ids=None, use_pool=True):
        """ONE device dispatch for the whole query (or batch): when the
        program touches the sparse tier, the leaf densification fuses into
        the same executable. All per-query integer data (program +
        sparse-leaf bounds) travels as ONE packed upload.

        With the hot-leaf pool active, sparse leaves instead resolve to
        resident pool rows: misses densify in place (one pool-update
        dispatch per ≤1024 misses), and the VM — ONE executable per bucket,
        shared by sparse and dense traffic — reads the pool like a second
        bank. Repeated leaves never densify again."""
        rounded = np.int32(_round_instr(n_instr))
        if self.pool_slots and k and use_pool:
            assert sparse_leaf_ids is not None
            with self._pool_lock:
                slot_map, chunks = self._plan_residency(sparse_leaf_ids)
                code = self._rewrite_sparse_operands(code, sparse_leaf_ids,
                                                     slot_map)
                if chunks and self.mesh is not None:
                    # mesh pools update EAGERLY (each chunk is one sharded
                    # window-local densify dispatch): the fused update+VM
                    # executable serves the single-device path
                    self._eager_update_chunks(chunks)
                    chunks = []
                if len(chunks) > vm._POOL_CHUNK_BUCKETS[-1]:
                    # overflow past the fused bucket: eager updates first
                    cut = len(chunks) - vm._POOL_CHUNK_BUCKETS[-1]
                    self._eager_update_chunks(chunks[:cut])
                    chunks = chunks[cut:]
                if not chunks:
                    run = _interpreter(bucket, self.n_rows, n_dyn,
                                       self.pool_slots + 1,
                                       self.n_flat_words, output, n_regs,
                                       mesh=self.mesh)
                    blob = np.append(code.reshape(-1), rounded)
                    return run(jax.device_put(blob), self.bank, dyn_dev,
                               self.leaf_pool, self.full_masks)
                # fuse the update chunks into the VM dispatch: ONE
                # execution refreshes the pool slots and runs the batch
                nb = next(b for b in vm._POOL_CHUNK_BUCKETS
                          if b >= len(chunks))
                k_cap = self._pool_update_k_cap
                blob = np.full(2 * bucket + 1 + 2 * nb * k_cap,
                               self.n_sparse, dtype=np.int32)
                blob[: 2 * bucket] = code.reshape(-1)
                blob[2 * bucket] = rounded
                off = 2 * bucket + 1
                for c in range(nb):
                    base = off + 2 * c * k_cap
                    blob[base + k_cap : base + 2 * k_cap] = self.pool_slots
                    if c < len(chunks):
                        ids, slots = chunks[c]
                        blob[base : base + len(ids)] = ids
                        blob[base + k_cap : base + k_cap + len(slots)] = slots
                run = vm._pooled_update_vm_jit(
                    bucket, self.n_rows, n_dyn, self.pool_slots,
                    self.n_flat_words, output, n_regs, nb, k_cap,
                    self.n_partitions, self._pool_e_budget(k_cap))
                try:
                    counts, self.leaf_pool = run(
                        self.leaf_pool, self.bank, dyn_dev,
                        self.sparse_stream[0],
                        self._ensure_bounds_dev(), jax.device_put(blob),
                        self.full_masks)
                except Exception:
                    self._drop_pool()
                    raise
                self.pool_fused_chunks += len(chunks)
                return counts
        if k:
            starts, lens, ids = sp
            if self.mesh is None:
                # single-device: bounds gather from the resident table —
                # the blob ships leaf ids (K i32), not 2 x K x P bounds
                run = _interpreter(bucket, self.n_rows, n_dyn, k,
                                   self.n_flat_words, output, n_regs, m,
                                   self.n_partitions, None,
                                   resident_bounds=True)
                blob = np.concatenate([
                    code.reshape(-1), ids, rounded.reshape(1)])
                return run(jax.device_put(blob), self.bank, dyn_dev,
                           self.sparse_stream[0],
                           self.full_masks, self._ensure_bounds_dev())
            run = _interpreter(bucket, self.n_rows, n_dyn, k,
                               self.n_flat_words, output, n_regs, m,
                               self.n_partitions, self.mesh)
            blob = np.concatenate([
                code.reshape(-1),
                starts.reshape(-1),
                lens.reshape(-1),
                rounded.reshape(1),
            ])
            return run(jax.device_put(blob), self.bank, dyn_dev,
                       self.sparse_stream[0],
                       self.full_masks)
        run = _interpreter(bucket, self.n_rows, n_dyn, 0, self.n_flat_words,
                           output, n_regs, mesh=self.mesh)
        blob = np.append(code.reshape(-1), rounded)
        return run(jax.device_put(blob), self.bank, dyn_dev,
                   self._zero_sparse_rows(), self.full_masks)

    def count_async(self, filter_expr, program: _Program | None = None) -> jax.Array:
        """Fused filter + popcount in ONE device dispatch; returns the scalar
        device array without blocking. `program` skips re-lowering when the
        caller already has it."""
        if program is None:
            program = self.lower(filter_expr)[0]
        (bucket, n_dyn, code, dyn, n_instr, k, m, sp, n_regs) = (
            self._prepare_program(program))
        shape = (n_dyn, self.n_flat_words)
        dyn_dev = self._zero_dyn(shape) if dyn is None else self._put_dyn(dyn)
        return self._dispatch(bucket, n_dyn, code, dyn_dev, k, m, sp, n_regs,
                              "count", n_instr,
                              sparse_leaf_ids=program.sparse_leaves)

    def count_batch(self, filter_exprs: list, min_bucket: int = 0,
                    min_sparse_k: int = 0, min_sparse_e: int = 0) -> list[int]:
        """Batched counts: MANY queries in ONE device dispatch. The query
        programs concatenate into a single instruction stream (each ends
        with EMIT_COUNT) — one scan executes them all back-to-back, so the
        per-dispatch round-trip amortizes across the whole batch.

        The `min_*` floors pin the program-length / sparse-leaf / segment
        buckets so callers can share ONE compiled executable across batch
        shapes."""
        return self.count_programs(
            [self.lower(f)[0] for f in filter_exprs], min_bucket,
            min_sparse_k, min_sparse_e,
        )

    def host_count(self, program: _Program,
                   allow_interpret: bool = True) -> int | None:
        """A count answerable with NO device dispatch, or None.

        (a) single static-row loads — the reference's stored-cardinality
        fast path (aggregated.cpp:58-66): a bare NucleotideEquals /
        indexed-value count is the row's ingest-time popcount;
        (b) programs touching no bank/sparse rows (metadata-only filters:
        dyn rows are host-evaluated already) — interpreted over numpy
        words. `allow_interpret=False` skips (b): inside a wide batch the
        dispatch RTT is already amortized and ~0.2 ms of serial host
        numpy per program is the worse trade.
        """
        n = len(program.opcodes)
        if n == 1 and program.opcodes[0] == ALU:
            spec = program.regspec[0]
            if (spec >> 24) & 0xF == M_MOVB:
                bsrc = (spec >> 28) & 0xF
                operand = program.operands[0]
                if bsrc == B_BANK:
                    return int(self._dense_row_counts[operand])
                if bsrc == B_SPARSE:
                    return int(self._sparse_row_counts[
                        program.sparse_leaves[operand]])
                if bsrc == B_FULL:
                    return sum(self.part_rows)
                if bsrc == B_ZERO:
                    return 0
                if bsrc == B_DYN:
                    return sum(int(bitset.popcount(row))
                               for row in program.dyn_rows[operand])
        if not allow_interpret or n > 64:  # keep host-side cost bounded
            return None
        for i in range(n):
            if program.opcodes[i] != ALU:
                return None
            if (program.regspec[i] >> 28) & 0xF in (B_BANK, B_SPARSE):
                return None
        full = self._full_host  # [P, W]
        n_regs = program.max_regs
        regs = np.zeros((n_regs + 1,) + full.shape, dtype=np.uint32)
        for i in range(n):
            spec = program.regspec[i]
            dst = min(spec & 0xFF, n_regs)
            ra = min((spec >> 8) & 0xFF, n_regs - 1) if n_regs else 0
            rb = min((spec >> 16) & 0xFF, n_regs - 1) if n_regs else 0
            mode = (spec >> 24) & 0xF
            bsrc = (spec >> 28) & 0xF
            a = regs[ra]
            if bsrc == B_REG:
                b = regs[rb]
            elif bsrc == B_DYN:
                b = np.stack(program.dyn_rows[program.operands[i]])
            elif bsrc == B_FULL:
                b = full
            else:  # B_ZERO
                b = np.zeros_like(full)
            if mode == M_MOVB:
                regs[dst] = b
            elif mode == M_AND:
                regs[dst] = a & b
            elif mode == M_OR:
                regs[dst] = a | b
            elif mode == M_XOR:
                regs[dst] = a ^ b
            else:  # M_ANDN
                regs[dst] = a & (b ^ full)
        return int(bitset.popcount(regs[0].reshape(-1)))

    def count_split(self, lowered: list[_Program], min_bucket: int = 0,
                    min_sparse_k: int = 0, min_sparse_e: int = 0,
                    max_bucket: int | None = None):
        """Phase 1 of a batched count (non-blocking): answer host-computable
        programs (stored cardinalities, metadata-only filters — they'd
        otherwise drag their sparse leaves into the batch's densify budget)
        and enqueue the device dispatches with async readbacks started.
        Returns (results-with-None-at-device-slots, device_idx, dispatches);
        finish with count_finish — the split lets serving loops dispatch
        batch k while batch k-1's readback is in flight."""
        results: list[int | None] = [None] * len(lowered)
        device_idx: list[int] = []
        device_programs: list[_Program] = []
        allow_interpret = len(lowered) <= 8
        for i, program in enumerate(lowered):
            host = self.host_count(program, allow_interpret=allow_interpret)
            if host is None:
                device_idx.append(i)
                device_programs.append(program)
            else:
                results[i] = host
        dispatches = []
        if device_programs:
            dispatches = self.count_dispatches(device_programs, min_bucket,
                                               min_sparse_k, min_sparse_e,
                                               max_bucket=max_bucket)
            # Overlap the device->host readbacks: issuing the copies async
            # first lets N reads share one wait.
            for counts, _q in dispatches:
                try:
                    counts.copy_to_host_async()
                except Exception:  # noqa: BLE001 — optional fast path
                    pass
        return results, device_idx, dispatches

    @staticmethod
    def count_finish(results, device_idx, dispatches) -> list[int]:
        """Phase 2 (blocking): pull the dispatch counts and fill the device
        slots of a count_split result."""
        flat = (int(c) for counts, q in dispatches
                for c in np.asarray(counts)[:q])
        for i, count in zip(device_idx, flat):
            results[i] = count
        return results

    def count_programs(self, lowered: list[_Program], min_bucket: int = 0,
                       min_sparse_k: int = 0, min_sparse_e: int = 0,
                       max_bucket: int | None = None) -> list[int]:
        """count_batch over already-lowered programs (the micro-batcher
        lowers per query so one bad query can't poison a whole batch)."""
        return self.count_finish(*self.count_split(
            lowered, min_bucket, min_sparse_k, min_sparse_e,
            max_bucket=max_bucket))

    def count_dispatches(self, lowered: list[_Program], min_bucket: int = 0,
                         min_sparse_k: int = 0, min_sparse_e: int = 0,
                         max_bucket: int | None = None,
                         force_poolless: bool = False,
                         ) -> list[tuple[jax.Array, int]]:
        """Non-blocking form: returns (device counts array, n_queries) per
        dispatch — dispatches pipeline (jax is async), so a serving loop
        can keep the device busy while earlier batches' results are still
        in flight. Callers slice each array [:n_queries].

        `max_bucket` caps the instruction bucket by SPLITTING wider
        batches into multiple dispatches: serving paths pass
        SERVE_LEN_BUCKET so a drained burst can never land on an
        unwarmed 16384+ executable (a minutes-long remote compile stall
        mid-serving); batched offline callers leave it None."""
        q = len(lowered)
        if q > MAX_BATCH_QUERIES:
            out = []
            for i in range(0, q, MAX_BATCH_QUERIES):
                out.extend(self.count_dispatches(
                    lowered[i : i + MAX_BATCH_QUERIES],
                    min_bucket, min_sparse_k, min_sparse_e,
                    max_bucket=max_bucket))
            return out
        # Cold-sweep pool bypass: when a batch's leaf set is mostly
        # MISSES and the fused-densify path would take FEWER dispatches
        # than pool updates + VM, ride it — no separate updates, no pool
        # writes, and the resident hot working set survives the sweep.
        # Mostly-hit batches — the serving norm — keep riding the pool.
        if self.pool_slots and not force_poolless:
            distinct = {r for p in lowered for r in p.sparse_leaves}
            if len(distinct) > self.max_sparse_k:
                with self._pool_lock:
                    misses = sum(1 for leaf in distinct
                                 if leaf not in self._leaf_slot)
                pooled_n = -(-misses // max(self._pool_update_k_cap, 1)) + 1
                poolless_n = -(-len(distinct) // max(self.max_sparse_k, 1))
                if (2 * misses > len(distinct) and misses > 0
                        and poolless_n < pooled_n):
                    return self.count_dispatches(
                        lowered, min_bucket, min_sparse_k, min_sparse_e,
                        max_bucket=max_bucket, force_poolless=True)
        # Split greedily if the concatenated stream or dyn-row count would
        # overflow the bucket cap (each program alone always fits: lower()
        # enforces the single-program limits).
        len_cap = max_bucket or _BATCH_LEN_BUCKETS[-1]
        sparse_cap = (self.max_sparse_k if force_poolless
                      else self.sparse_batch_cap)
        total = sum(len(p.opcodes) + 1 for p in lowered)
        total_dyn = sum(len(p.dyn_rows) for p in lowered)
        total_sparse = len({r for p in lowered for r in p.sparse_leaves})
        if q > 1 and (total > len_cap or total_dyn > _DYN_BUCKETS[-1]
                      or total_sparse > sparse_cap):
            acc_len = acc_dyn = 0
            acc_sparse: set[int] = set()
            split = q
            for i, p in enumerate(lowered):
                acc_len += len(p.opcodes) + 1
                acc_dyn += len(p.dyn_rows)
                acc_sparse.update(p.sparse_leaves)
                if i and (acc_len > len_cap
                          or acc_dyn > _DYN_BUCKETS[-1]
                          or len(acc_sparse) > sparse_cap):
                    split = i
                    break
            # Sub-batches KEEP the caller's min_bucket pin: split points
            # vary per batch, so "natural" buckets would proliferate
            # executables and land fresh compiles mid-pipeline.
            return self.count_dispatches(lowered[:split], min_bucket,
                                         min_sparse_k, min_sparse_e,
                                         max_bucket=max_bucket,
                                         force_poolless=force_poolless) + \
                self.count_dispatches(lowered[split:], min_bucket,
                                      min_sparse_k, min_sparse_e,
                                      max_bucket=max_bucket,
                                      force_poolless=force_poolless)
        programs = []
        all_dyn_rows: list[list[np.ndarray]] = []
        all_sparse_leaves: list[int] = []
        sparse_slots: dict[int, int] = {}  # global sparse row -> merged slot
        total_len = 0
        for program in lowered:
            dyn_base = len(all_dyn_rows)
            opcodes, operands = list(program.opcodes), list(program.operands)
            for i, opcode in enumerate(opcodes):
                if opcode != ALU:
                    continue
                bsrc = (program.regspec[i] >> 28) & 0xF
                if bsrc == B_DYN:
                    operands[i] += dyn_base
                elif bsrc == B_SPARSE:
                    # dedupe by global sparse row across the whole batch —
                    # queries in a batch frequently share leaves
                    row_id = program.sparse_leaves[operands[i]]
                    slot = sparse_slots.get(row_id)
                    if slot is None:
                        slot = len(all_sparse_leaves)
                        sparse_slots[row_id] = slot
                        all_sparse_leaves.append(row_id)
                    operands[i] = slot
            all_dyn_rows.extend(program.dyn_rows)
            programs.append((opcodes, operands, list(program.regspec)))
            total_len += len(opcodes) + 1
        if total_len > _BATCH_LEN_BUCKETS[-1]:
            raise ProgramTooLarge(total_len)
        bucket = next(b for b in _BATCH_LEN_BUCKETS if b >= max(total_len, min_bucket))
        # Flat-concatenate the whole batch and pack ONCE: a pack_wire call
        # per program pays numpy small-array overhead thousands of times
        # per dispatch.
        flat_ops: list[int] = []
        flat_opers: list[int] = []
        flat_spec: list[int] = []
        for qi, (opcodes, operands, regspec) in enumerate(programs):
            flat_ops.extend(opcodes)
            flat_opers.extend(operands)
            flat_spec.extend(regspec)
            # every program leaves its result in reg[0] (lowered with dst=0)
            flat_ops.append(EMIT_COUNT)
            flat_opers.append(qi)
            flat_spec.append(NO_DST)  # ra = 0 implied
        code = vm.pack_code_array(bucket, flat_ops, flat_opers, flat_spec)
        n_dyn = next(b for b in _DYN_BUCKETS if b >= len(all_dyn_rows))
        if all_dyn_rows:
            dyn = np.zeros((n_dyn, self.n_partitions, self.n_words),
                           dtype=np.uint32)
            for di, rows in enumerate(all_dyn_rows):
                for pi, row in enumerate(rows):
                    dyn[di, pi] = row
            dyn_dev = self._put_dyn(dyn.reshape(n_dyn, self.n_flat_words))
        else:
            dyn_dev = self._zero_dyn((n_dyn, self.n_flat_words))
        # Unpinned floors (a batch too wide for any ladder rung split into
        # sub-dispatches): pin each SUB-dispatch to the smallest rung that
        # covers it, so live traffic converges onto the ladder's compiled
        # executables instead of arbitrary natural (K, E) shapes (each new
        # shape is a compile).
        if self.pool_slots and not force_poolless:
            # pooled leaves need no densify shapes: k only routes the
            # dispatch into the pool branch (slots replace descriptors)
            k, m, sp = len(all_sparse_leaves), 0, None
        else:
            if (not min_sparse_k and not min_sparse_e and all_sparse_leaves
                    and self.sparse_shape_ladder):
                k_act = len(all_sparse_leaves)
                e_act = int(self.sparse_lengths[all_sparse_leaves].sum())
                for ladder_k, ladder_e in self.sparse_shape_ladder:
                    if k_act <= ladder_k and e_act <= ladder_e:
                        min_sparse_k, min_sparse_e = ladder_k, ladder_e
                        break
            k, m, sp = self._assemble_sparse(all_sparse_leaves, min_sparse_k,
                                             min_sparse_e)
        n_regs = next(b for b in _REG_BUCKETS
                      if b >= max(p.max_regs for p in lowered))
        if os.environ.get("SILO_DEBUG_DISPATCH") == "1":
            import sys

            print(f"[dispatch] q={q} instr={len(flat_ops)} bucket={bucket} "
                  f"dyn={len(all_dyn_rows)}/{n_dyn} "
                  f"sparse_k={len(all_sparse_leaves)}/{k} e={m} "
                  f"regs={n_regs}", file=sys.stderr, flush=True)
        counts = self._dispatch(bucket, n_dyn, code, dyn_dev, k, m, sp,
                                n_regs, "multi_count", len(flat_ops),
                                sparse_leaf_ids=all_sparse_leaves,
                                use_pool=not force_poolless)
        return [(counts, q)]

    def count(self, filter_expr) -> int:
        """Fused filter + popcount on device (Aggregated without group-by:
        nothing but one scalar crosses back to the host) — or, for
        host-answerable programs, no device work at all (host_count)."""
        program, _regs = self.lower(filter_expr)
        host = self.host_count(program)
        if host is not None:
            return host
        return int(self.count_async(filter_expr, program=program))

    def device_filter(self, filter_expr) -> "DeviceFilter":
        """Evaluate the filter and KEEP it on device — actions that only
        need device reductions (Mutations) never transfer the [P, W] bitset
        over the host link."""
        return DeviceFilter(self, self.evaluate_device(filter_expr))

    # -- group-by (Aggregated with groupByFields) -------------------------

    _GROUP_BUCKETS = (64, 1024, 16384, 1 << 20)

    def group_codes_for(self, column_names: list[str]):
        """Cached per-partition combined group codes for a column list:
        (codes_dev [P, N_pad] int32, n_groups, decode(group_id) ->
        per-column raw code tuple). Returns None when a column kind can't
        be coded densely or the key space is too large."""
        key = ("group_codes", tuple(column_names))
        cached = self._filter_cache.get(key)
        if cached is not None:
            return cached if cached != "unsupported" else None
        sizes = []
        per_column_codes = []  # per column: list per partition of int64[N]
        per_column_values = []  # per column: sorted unique raw codes | None
        for name in column_names:
            columns = [p.columns[name] for p in self.db.partitions]
            kind = columns[0].kind
            if kind in ("string", "indexed_string", "indexed_pango_lineage",
                        "nuc_insertion", "aa_insertion"):
                codes = [c.ids.astype(np.int64) for c in columns]
                size = max((int(c.max()) + 1 if len(c) else 1) for c in codes)
                per_column_values.append(None)
            elif kind in ("date", "int", "float"):
                if kind == "float":
                    # canonicalize before taking bit patterns: -0.0 == 0.0
                    # and every NaN must be ONE group (host groups by value)
                    raws = []
                    for c in columns:
                        vals = c.values.copy()
                        vals[vals == 0.0] = 0.0
                        vals[np.isnan(vals)] = np.nan
                        raws.append(vals.view(np.int64))
                else:
                    raws = [c.values.astype(np.int64) for c in columns]
                uniq = np.unique(np.concatenate(raws)) if raws else np.zeros(0)
                codes = [np.searchsorted(uniq, r) for r in raws]
                size = max(len(uniq), 1)
                per_column_values.append(uniq)
            else:
                self._filter_cache[key] = "unsupported"
                return None
            sizes.append(size)
            per_column_codes.append(codes)
        n_groups = 1
        for s in sizes:
            n_groups *= s
        if n_groups > self._GROUP_BUCKETS[-1]:
            self._filter_cache[key] = "unsupported"
            return None
        n_pad = self.n_words * 32
        combined = np.full((self.n_partitions, n_pad), n_groups, dtype=np.int32)
        for pi, partition in enumerate(self.db.partitions):
            acc = np.zeros(partition.sequence_count, dtype=np.int64)
            for ci in range(len(column_names)):
                acc = acc * sizes[ci] + per_column_codes[ci][pi]
            combined[pi, : partition.sequence_count] = acc

        def decode(group_id: int):
            out = []
            for ci in range(len(column_names) - 1, -1, -1):
                group_id, code = divmod(group_id, sizes[ci])
                if per_column_values[ci] is not None:
                    code = int(per_column_values[ci][code])
                out.append(code)
            return tuple(reversed(out))

        result = (jax.device_put(combined), n_groups, decode)
        self._filter_cache[key] = result
        return result

    def group_counts(self, filter_expr, column_names: list[str]):
        """Aggregated-with-groupBy fast path: ONE extra device dispatch —
        filter bits expand to a per-sequence mask, segment-sum over the
        cached combined group codes. Returns {group_id: count} (host) or
        None when unsupported for these columns."""
        prepared = self.group_codes_for(column_names)
        if prepared is None:
            return None
        codes_dev, n_groups, decode = prepared
        bucket = next(b for b in self._GROUP_BUCKETS if b >= n_groups)
        words = self.evaluate_device(filter_expr)  # flat [PW]
        per_part = np.asarray(_group_counts_jit(words, codes_dev, bucket + 1))
        per_part = per_part[:, :n_groups]  # [P, G]
        totals = per_part.sum(axis=0, dtype=np.int64)
        hits = np.nonzero(totals)[0]
        # Row order identical to the host path (and so to the pinned
        # corpus): groups appear when first seen scanning partitions in
        # order, sorted by code within each partition's novel set.
        first_partition = np.argmax(per_part[:, hits] > 0, axis=0)
        order = np.lexsort((hits, first_partition))
        return [(decode(int(g)), int(totals[g])) for g in hits[order]]

    def lower_cached(self, filter_expr, key: str | None = None):
        """lower() with an LRU memo keyed by the filter's canonical JSON:
        serving workloads repeat filters, and lowering walks every
        partition in pure Python (the GIL is the scarce resource under
        concurrent HTTP load). Lowered programs are read-only downstream
        (count_dispatches copies the instruction lists it rewrites)."""
        if key is None:
            return self.lower(filter_expr)
        memo = self._program_memo
        with self._program_memo_lock:
            hit = memo.get(key)
            if hit is not None:
                memo.move_to_end(key)
                return hit
        result = self.lower(filter_expr)
        with self._program_memo_lock:
            memo[key] = result
            if len(memo) > 4096:
                memo.popitem(last=False)
        return result

    def count_coalesced(self, filter_expr, key: str | None = None) -> int:
        """Count through the serving micro-batcher: concurrent callers are
        coalesced into ONE device dispatch (EMIT_COUNT program concat).

        Batches form naturally: while one dispatch is in flight, arriving
        queries queue up and the dispatcher drains them all at once — no
        artificial batching delay is added."""
        with self._lower_lock:
            if self._batcher is None:
                self._batcher = _MicroBatcher(self)
            batcher = self._batcher
        return batcher.count(filter_expr, key)

    # -- heavy reductions -----------------------------------------------------

    def _filters_for(self, filter_words) -> jax.Array:
        """Device [PW] flat global-word filter for a host word list or
        DeviceFilter (memoized by identity — one Mutations query calls
        mutation_counts once per segment with the same filter)."""
        if isinstance(filter_words, DeviceFilter):
            return filter_words.words  # already flat [PW]
        key = tuple(id(w) for w in filter_words)
        memo = self._filters_memo
        if memo is not None and memo[0] == key:
            return memo[2]
        dyn = np.zeros((self.n_partitions, self.n_words), dtype=np.uint32)
        for pi, words in enumerate(filter_words):
            dyn[pi, : len(words)] = words
        filters = self._put_dyn(dyn.reshape(self.n_flat_words))
        # hold a reference to the keyed arrays so ids stay valid
        self._filters_memo = (key, list(filter_words), filters)
        return filters

    def _sparse_counts(self, filter_words) -> np.ndarray:
        """int32[n_sparse]: popcount(row & filter) for every sparse-tier row
        (all segments), via ONE segment-sum over the flat CSR stream."""
        key = (id(filter_words) if isinstance(filter_words, DeviceFilter)
               else tuple(id(w) for w in filter_words))
        memo = self._sparse_counts_memo
        if memo is not None and memo[0] == key:
            return memo[2]
        filters = self._filters_for(filter_words)
        (stream_comb,) = self.sparse_stream
        starts, lens = self._sparse_bounds_dev
        if self.mesh is not None:
            # sharded form: the entry axis splits across devices, each
            # reduces its chunk against the all-gathered filter, per-leaf
            # partials psum
            from .reductions import _sparse_mutation_counts_sharded_jit

            run = _sparse_mutation_counts_sharded_jit(
                self.mesh, self.n_partitions)
            out = run(stream_comb, filters, starts, lens)
        else:
            out = _sparse_mutation_counts_jit(stream_comb, filters, starts,
                                              lens, self.n_partitions)
        out = np.asarray(out, dtype=np.int64)
        self._sparse_counts_memo = (key, filter_words, out)
        return out

    def mutation_counts(self, kind: str, name: str, filter_words):
        """counts[S, L] for one segment (see mutation_counts_many)."""
        return self.mutation_counts_many(kind, [name], filter_words)[name]

    def mutation_counts_many(self, kind: str, names: list[str], filter_words):
        """{name: counts[S, L]}: per (symbol, position) popcount of plane &
        filter, summed over partitions, for MANY segments of one kind. THE
        flagship reduction — one fused popcount pass over the dense tier
        plus a segment-sum over the sparse-tier CSR stream. Majority rows
        reconstruct as |filter| - sum(stored counts at pos) (reference
        mutations.cpp:74-96, exact under the one-symbol-per-position
        invariant).

        All device dispatches are issued up front and read back with
        overlapped transfers (a bare AminoAcidMutations query touches ~25
        gene segments)."""
        if isinstance(filter_words, DeviceFilter):
            filter_total = filter_words.popcount()
        else:
            filter_total = sum(bitset.popcount(w) for w in filter_words)
        full = filter_total == sum(self.part_rows)
        results: dict[str, np.ndarray] = {}
        pending = []
        need_sparse = False
        for name in names:
            meta = self.segment_meta[(kind, name)]
            # Full/empty-filter fast paths (the reference's full-partition
            # path uses stored cardinalities, mutations.cpp:36-73): filter
            # words are always masked to valid sequences, so popcount == N
            # iff the filter is everything — answer from the ingest-time
            # count matrix with no device work at all.
            if full:
                results[name] = meta["totals"].copy()
                continue
            if filter_total == 0:
                results[name] = np.zeros(
                    (meta["s_count"], meta["length"]), dtype=np.int64)
                continue
            dev = None
            if meta["n_stored"]:
                filters = self._filters_for(filter_words)
                dev = _mutation_counts_jit(
                    self.bank, filters, meta["offset"], meta["n_stored"])
            need_sparse = need_sparse or bool(len(meta["sparse_sym_ids"]))
            pending.append((name, meta, dev))
        # one sparse reduction covers every segment's sparse rows (memoized
        # per filter); its sync readback overlaps the dense dispatches above
        sparse_all = (self._sparse_counts(filter_words)
                      if need_sparse and pending else None)
        for _name, _meta, dev in pending:
            if dev is not None:
                try:
                    dev.copy_to_host_async()
                except Exception:  # noqa: BLE001 — optional fast path
                    pass
        for name, meta, dev in pending:
            length, s_count = meta["length"], meta["s_count"]
            counts = np.zeros((s_count, length), dtype=np.int64)
            per_pos = np.zeros(length, dtype=np.int64)
            if dev is not None:
                stored = np.asarray(dev, dtype=np.int64)[: meta["n_stored"]]
                counts[meta["sym_ids"], meta["pos_ids"]] = stored
                np.add.at(per_pos, meta["pos_ids"], stored)
            n_seg_sparse = len(meta["sparse_sym_ids"])
            if n_seg_sparse:
                seg_sparse = sparse_all[
                    meta["sparse_base"] : meta["sparse_base"] + n_seg_sparse
                ]
                counts[meta["sparse_sym_ids"], meta["sparse_pos_ids"]] = (
                    seg_sparse)
                np.add.at(per_pos, meta["sparse_pos_ids"], seg_sparse)
            counts[meta["majority"], np.arange(length)] = (
                filter_total - per_pos)
            results[name] = counts
        return results


class DeviceFilter:
    """A filter result resident on device: FLAT [PW] global words + lazy
    reductions. Accepted by DeviceEngine.mutation_counts in place of host
    word lists."""

    def __init__(self, engine: DeviceEngine, words: jax.Array):
        self.engine = engine
        self.words = words
        self._popcount: int | None = None

    def popcount(self) -> int:
        if self._popcount is None:
            self._popcount = int(_popcount_words_jit(self.words))
        return self._popcount




class _MicroBatcher:
    """Coalesces concurrent count() callers into single-dispatch batches.

    The dispatcher thread loops: drain everything queued (up to
    MAX_BATCH_QUERIES), lower each query individually (so a ProgramTooLarge
    / StructureMismatch fails only its own caller), execute the batch in one
    device dispatch, deliver results. Queries arriving while a dispatch is
    in flight form the next batch — throughput scales with concurrency while
    a lone query still sees single-dispatch latency.

    Holds only a weakref to the engine so a snapshot swap that drops the
    engine also ends the thread.
    """

    def __init__(self, engine: "DeviceEngine"):
        import threading
        import weakref

        self._engine_ref = weakref.ref(engine)
        self._cv = threading.Condition()
        self._queue: list[dict] = []
        self._thread = threading.Thread(
            target=self._loop, name="silo-microbatch", daemon=True
        )
        self._thread.start()

    def count(self, filter_expr, key: str | None = None) -> int:
        import threading

        item = {"filter": filter_expr, "key": key, "done": threading.Event(),
                "result": None, "error": None}
        with self._cv:
            self._queue.append(item)
            self._cv.notify()
        item["done"].wait()
        if item["error"] is not None:
            raise item["error"]
        return item["result"]

    def _loop(self):
        while True:
            with self._cv:
                while not self._queue:
                    if not self._cv.wait(timeout=1.0) and self._engine_ref() is None:
                        return
                batch = self._queue[:MAX_BATCH_QUERIES]
                del self._queue[: len(batch)]
            engine = self._engine_ref()
            if engine is None:
                for item in batch:
                    item["error"] = RuntimeError("device engine was dropped")
                    item["done"].set()
                return
            ready = []
            for item in batch:
                try:
                    item["program"] = engine.lower_cached(
                        item["filter"], item.get("key"))[0]
                    ready.append(item)
                except Exception as ex:  # noqa: BLE001 — per-query isolation
                    item["error"] = ex
                    item["done"].set()
            if not ready:
                continue
            try:
                # pinned buckets: batch shapes collapse onto the shape
                # LADDER (small batches ride the small densify rung)
                programs = [item["program"] for item in ready]
                min_k, min_e = engine.sparse_floors(programs)
                counts = engine.count_programs(
                    programs,
                    min_bucket=SERVE_LEN_BUCKET,
                    min_sparse_k=min_k,
                    min_sparse_e=min_e,
                    max_bucket=SERVE_LEN_BUCKET,
                )
                for item, count in zip(ready, counts):
                    item["result"] = count
            except Exception as ex:  # noqa: BLE001
                for item in ready:
                    item["error"] = ex
            for item in ready:
                item["done"].set()
            del engine

