"""Multi-chip execution: shard the index over a jax.sharding.Mesh.

The device generalization of the reference's single-node partition model
(SURVEY §2.10): the *sequence-id axis* (the packed word axis W) shards across
devices — every filter-VM op is word-local, so the program runs without any
communication; only the final reductions (counts, per-position mutation
histograms) cross devices, as XLA-inserted all-reduces.

This also covers the partition axis: partitions FOLD into the flat global
word axis (partition p owns word slots [p*W, (p+1)*W)), words shard — so a
database with ONE giant partition scales across a pod exactly like one
with 32.
"""

from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..ops import device_engine as de


def make_mesh(devices=None, axis: str = "seq") -> Mesh:
    devices = devices if devices is not None else jax.devices()
    return Mesh(np.asarray(devices), (axis,))


class ShardedQueryStep:
    """The full query step — filter VM + count + per-position mutation
    histogram — jitted over a mesh with the word axis sharded.

    This is the 'training step' analog for the driver's multi-chip dry-run:
    it exercises real shardings (data axis = packed sequence words) and the
    collective merges (psum-style all-reduces inserted by XLA).
    """

    def __init__(self, mesh: Mesh, n_partitions: int, n_rows: int, n_dyn: int,
                 n_words: int, program_len: int, axis: str = "seq"):
        if n_words % mesh.devices.size != 0:
            raise ValueError(
                f"n_words={n_words} must be a multiple of mesh size "
                f"{mesh.devices.size} (pad the word axis)"
            )
        del n_partitions  # folded into the flat global word axis
        self.mesh = mesh
        self.axis = axis
        run_one = de.build_run_one(program_len, n_rows, n_dyn, n_words)

        def step(code, bank, dyn, full_masks, seg_slice):
            words = run_one(code, bank, dyn, full_masks)  # [PW]
            count = jax.lax.population_count(words).astype(jnp.int32).sum(dtype=jnp.int32)
            segment = jax.lax.dynamic_slice(
                bank, (seg_slice, 0), (64, bank.shape[1])
            )
            mutation_counts = (
                jax.lax.population_count(segment & words[None, :])
                .astype(jnp.int32)
                .sum(axis=1, dtype=jnp.int32)
            )
            return words, count, mutation_counts

        sharded = NamedSharding(mesh, P(None, axis))  # [R|D, PW]
        words_sharding = NamedSharding(mesh, P(axis))
        replicated = NamedSharding(mesh, P())
        self.jitted = jax.jit(
            step,
            in_shardings=(replicated, sharded, sharded, words_sharding, None),
            out_shardings=(words_sharding, replicated, replicated),
        )

    def __call__(self, code, bank, dyn, full_masks, seg_slice=0):
        # this path has no sparse-tier stream: a B_SPARSE-source program
        # would silently read zeros — fail loudly instead
        host_code = np.asarray(code)
        assert not ((de.wire_opcode(host_code[1]) == de.ALU)
                    & (de.wire_bsrc(host_code[1]) == de.B_SPARSE)).any(), \
            "ShardedQueryStep cannot execute sparse-tier programs"
        return self.jitted(code, bank, dyn, full_masks, seg_slice)
