"""Device match-candidate finder (encode phase A) — pure XLA, jittable.

The reference encoder's match finder is a 2^17-entry hash table storing
16-bit positions, probed and updated serially per position
(tsq_encode.cpp:222-229). Serial hash-table recency is hostile to a
data-parallel machine, so the device formulation replaces it with an
*exact* windowed predecessor search:

    cand[i] = the nearest j < i with hash4(j) == hash4(i)

computed by sorting (hash, position) pairs — sorted neighbors with equal
hash are adjacent, so the predecessor is one shifted compare away. This
finds a candidate at least as close as any the reference's lossy table
could return, which is why greedy emission from these candidates compresses
at least as well (validated in tests + bench).

Phase B (XOR match extension + greedy token emission with the rep-anchor
rules) runs on host in the native core (tsq_encode_with_candidates); the
byte-compare extension is cache-resident and cheap there, while the sort is
the bandwidth-heavy part that belongs on the device.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..format import HASH_MASK

# Positions are block-local (< 2^22); hashes are 17 bits. A single int32
# key cannot hold both, so sort an int64 key = hash << 23 | position.
_POS_BITS = 23


def hash4_words(v4: jax.Array) -> jax.Array:
    return (v4 ^ (v4 >> 12)) & HASH_MASK


def bytes_to_v4(block_i32: jax.Array) -> jax.Array:
    """Per-position little-endian 4-byte windows from a byte array (i32).

    block_i32: (N,) i32 holding byte values. Returns (N,) i32 where
    v4[i] = LE32(bytes[i:i+4]) with ZEROS shifted in past the end — the
    format's buffer contract (native build_candidates reads zeroed
    slack, csrc/tsq_core.h kEncInSlack). A plain roll() wraps the
    block's FIRST bytes into the last three windows instead, which can
    hand those positions accidentally "verified" candidates and change
    emitted bytes near the block tail.
    """
    b0 = block_i32
    b1 = jnp.roll(block_i32, -1).at[-1:].set(0)
    b2 = jnp.roll(block_i32, -2).at[-2:].set(0)
    b3 = jnp.roll(block_i32, -3).at[-3:].set(0)
    return b0 | (b1 << 8) | (b2 << 16) | (b3 << 24)


@functools.partial(jax.jit, static_argnames=())
def find_candidates(block_bytes: jax.Array) -> jax.Array:
    """cand[i] = nearest j < i with equal 4-byte hash, verified equal v4;
    -1 where no valid candidate exists. block_bytes: (N,) i32 byte values.
    """
    n = block_bytes.shape[0]
    v4 = bytes_to_v4(block_bytes)
    h = hash4_words(v4)
    pos = jnp.arange(n, dtype=jnp.int32)

    # Stable sort keyed on the hash: positions stay ascending within equal
    # hashes, so the sorted predecessor is the nearest earlier occurrence.
    # (int64 keys are unavailable without x64 mode; multi-operand stable
    # sort avoids them.) Carrying v4 through the sort lets the hash-
    # collision check (the reference verifies at probe time,
    # tsq_encode.cpp:250) run on sorted NEIGHBORS — no gather.
    shash, spos, sv4 = jax.lax.sort((h, pos, v4), dimension=0,
                                    is_stable=True, num_keys=1)

    prev_pos = jnp.roll(spos, 1).at[0].set(-1)
    prev_hash = jnp.roll(shash, 1).at[0].set(-1)
    prev_v4 = jnp.roll(sv4, 1)
    ok = jnp.logical_and(prev_hash == shash, prev_v4 == sv4)
    cand_sorted = jnp.where(ok, prev_pos, -1)

    # un-permute with a second sort (spos is a permutation of [0, n))
    _, cand = jax.lax.sort((spos, cand_sorted), dimension=0,
                           is_stable=True, num_keys=1)
    return cand


def find_candidates_host(block: bytes) -> np.ndarray:
    """Host wrapper: bytes -> candidate array (numpy int32).

    The block is zero-padded to a power-of-two length (>= 4 KiB) so that
    blocks of nearby sizes share one compiled program; trailing zeros only
    follow the block, so its own candidates do not change.
    """
    n = max(4096, 1 << (len(block) + 4 - 1).bit_length())
    arr = np.zeros(n, np.int32)
    arr[:len(block)] = np.frombuffer(block, dtype=np.uint8)
    cand = np.asarray(find_candidates(jnp.asarray(arr)))
    return cand[:len(block)]

