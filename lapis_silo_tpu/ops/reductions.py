"""Heavy-reduction executables: Mutations/popcount/group-by jits.

Device-side reduction programs used by DeviceEngine.mutation_counts_many,
group_counts, and DeviceFilter — pure jitted XLA functions over resident
arrays, split out of device_engine.py: the dense popcount reduction plus
the segment-sum over the sparse CSR stream (reference analog: the TBB
loops of src/silo/query_engine/actions/mutations.cpp:140-166).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from . import sparse_stream

@jax.jit
def _popcount_words_jit(words):
    return jax.lax.population_count(words).astype(jnp.int32).sum(dtype=jnp.int32)


@functools.partial(jax.jit, static_argnums=(2,))
def _group_counts_jit(words, codes, num_segments):
    """counts[p, g] = number of filter-set sequences in partition p with
    combined group code g. words: FLAT [PW] u32 (reshaped to codes' [P,
    W*32] layout inside the jit — free), codes [P, W*32] int32 (padding
    rows carry an out-of-range code mapped to the last segment)."""
    n_partitions = codes.shape[0]
    words = words.reshape(n_partitions, -1)

    def one(words_p, codes_p):
        bits = ((words_p[:, None] >> jnp.arange(32, dtype=jnp.uint32)[None, :])
                & jnp.uint32(1)).astype(jnp.int32).reshape(-1)
        return jax.ops.segment_sum(
            bits, jnp.minimum(codes_p, num_segments - 1),
            num_segments=num_segments,
        )

    return jax.vmap(one)(words, codes)  # [P, num_segments]



def _boundary_sums(vals_u32, starts, lens):
    """Segmented sums of a flat per-entry value stream whose segments are
    contiguous (start, len) slices: inclusive cumsum + boundary gather, no
    scatter. uint32 wraparound keeps boundary
    differences exact: every true per-segment sum <= sequence count < 2**32.
    Trailing pad entries carry zero values, so they never perturb the cumsum
    below any segment's upper boundary."""
    c = jnp.cumsum(vals_u32)
    last = c.shape[0] - 1
    hi = c[jnp.clip(starts + lens - 1, 0, last)]
    lo = jnp.where(starts > 0, c[jnp.clip(starts - 1, 0, last)],
                   jnp.uint32(0))
    return jnp.where(lens > 0, hi - lo, jnp.uint32(0))


@functools.partial(jax.jit, static_argnums=(4,))
def _sparse_mutation_counts_jit(stream_comb, filters, starts, lens,
                                n_per_leaf):
    """Segmented popcount over the flat GLOBAL sparse-tier CSR stream:
    counts[r] = sum over row r's stored words of popcount(word &
    filter[global word idx]). The stream is PARTITION-major, so each leaf
    is n_per_leaf (start, len) segments, seg = leaf * P + pi — boundary
    sums per segment, then a per-leaf partition reduce on device."""
    sp_idx, sp_words = sparse_stream.split_stream(stream_comb)
    vals = jax.lax.population_count(
        sp_words & filters[sp_idx]).astype(jnp.uint32)
    per_seg = _boundary_sums(vals, starts, lens)
    return per_seg.reshape(-1, n_per_leaf).sum(
        axis=1, dtype=jnp.uint32)


@functools.lru_cache(maxsize=None)
def _sparse_mutation_counts_sharded_jit(mesh, n_per_leaf: int):
    """Segmented sparse-tier popcount over a word-sharded Mesh: the ENTRY
    axis of the (replicated) combined stream splits across devices — each
    device all-gathers the word-sharded filter (small next to the dense
    bank traffic a Mutations query already moves), reduces its own entry
    chunk with an XLA gather, computes boundary sums over its chunk with
    the (leaf, partition) segments CLIPPED to its entry range, and the
    per-leaf partials psum-merge. Every entry is counted by exactly one
    device, so the merge is exact. The engine pads the entry count to
    split evenly across the mesh."""
    from jax.sharding import PartitionSpec as P

    n_dev = mesh.devices.size

    def local(stream_full, filters_l, starts, lens):
        rows_local = stream_full.shape[0] // n_dev
        e_local = rows_local * 64
        d = jax.lax.axis_index("seq")
        filters_full = jax.lax.all_gather(filters_l, "seq", tiled=True)
        chunk = jax.lax.dynamic_slice_in_dim(
            stream_full, d * rows_local, rows_local, 0)
        sp_idx, sp_words = sparse_stream.split_stream(chunk)
        vals = jax.lax.population_count(
            sp_words & filters_full[sp_idx]).astype(jnp.uint32)
        e0 = d * e_local
        ls = jnp.clip(starts - e0, 0, e_local)
        le = jnp.clip(starts + lens - e0, 0, e_local)
        per_seg = _boundary_sums(vals, ls, jnp.maximum(le - ls, 0))
        partial = per_seg.reshape(-1, n_per_leaf).sum(
            axis=1, dtype=jnp.uint32)
        return jax.lax.psum(partial, "seq")

    sharded = jax.shard_map(
        local, mesh=mesh,
        in_specs=(P(), P("seq"), P(), P()),
        out_specs=P(), check_vma=False)
    return jax.jit(sharded)


@functools.partial(jax.jit, static_argnums=(2, 3))
def _mutation_counts_jit(bank, filters, start, n_seg_rows):
    """bank [R, PW] & filter [PW]: per-row popcount over the global word
    space (= the reference's per-partition and_cardinality sums,
    mutations.cpp:36-137, already summed over partitions). `start` and the
    row count are static, so the segment is a static slice that XLA can
    fuse with the AND, the popcount and the row sum."""
    segment = bank[start : start + n_seg_rows]
    masked = segment & filters[None, :]
    counts = jax.lax.population_count(masked).astype(jnp.int32)
    return counts.sum(axis=1, dtype=jnp.int32)
