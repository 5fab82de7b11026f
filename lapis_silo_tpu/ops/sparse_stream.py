"""Layout of the device-resident sparse-tier CSR stream.

The stream holds one (global word index, word) entry per stored word of
every sparse row. Both halves live in ONE [2E/128, 128] u32 array,
8-row block-interleaved: each 1024-entry group stores its 8 index rows
(bit-identical i32 -> u32) followed by its 8 word rows. Entry position p
maps to index row (p >> 10) * 16 + ((p >> 7) & 7), word row = index row
+ 8, lane p & 127. This module is the single definition of that address
arithmetic: the densify gather (vm._densify_one) and the Mutations
reduction (reductions.py) both route through it.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

COMBINE_BLOCK = 1024  # entries per interleaved (8 idx + 8 word row) group
COMBINE_GROUP_ROWS = 16   # buffer rows per COMBINE_BLOCK entries
COMBINE_WORD_ROW_OFF = 8  # a position's word row = its idx row + this


def comb_idx_row(p):
    """Index row of stream entry position p. The word row is
    `comb_idx_row(p) + COMBINE_WORD_ROW_OFF`, the lane is `p & 127`.
    Works on python ints, numpy arrays, and traced jax values."""
    return ((p >> 10) * COMBINE_GROUP_ROWS) + ((p >> 7) & 7)


def split_stream(comb):
    """Inverse of combine_stream: (idx int32 [E], words u32 [E]) from the
    combined [2E/128, 128] array (numpy or jnp)."""
    v = comb.reshape(-1, 2, COMBINE_WORD_ROW_OFF, 128)
    if isinstance(comb, np.ndarray):
        return (v[:, 0].reshape(-1).view(np.int32).copy(),
                v[:, 1].reshape(-1))
    return (v[:, 0].reshape(-1).astype(jnp.int32),
            v[:, 1].reshape(-1))


def combine_stream(sp_idx, sp_words):
    """Pack (idx [E] i32, words [E] u32) into the interleaved [2E/128, 128]
    u32 array. Works on numpy (engine init) and jnp (tests) inputs; E must
    be a multiple of COMBINE_BLOCK."""
    e = sp_idx.shape[0]
    assert e % COMBINE_BLOCK == 0, e
    if isinstance(sp_idx, np.ndarray):
        comb = np.empty((e // 64, 128), np.uint32)
        v = comb.reshape(e // COMBINE_BLOCK, 2, 8, 128)
        v[:, 0] = sp_idx.reshape(-1, 8, 128).view(np.uint32)
        v[:, 1] = sp_words.reshape(-1, 8, 128)
        return comb
    return jnp.concatenate(
        [sp_idx.reshape(-1, 1, 8, 128).astype(jnp.uint32),
         sp_words.reshape(-1, 1, 8, 128)], axis=1).reshape(-1, 128)
