"""Fully data-parallel device decode (decode phase B, XLA formulation).

This is the prefix-sum/scatter/gather decode of SURVEY.md §7.2: the
byte-granular copy-reconstruction loop of the reference decoder
(tsq_decode.cpp:42-315) re-expressed as a handful of bulk array passes
with NO sequential per-token loop at all:

  1. segment ids     — byte i belongs to token t(i) (dst starts are sorted;
                       one scatter-max + cummax pass)
  2. source map      — match bytes point at an earlier OUTPUT byte
                       P0[i] = src_t + (i - dst_t); literal bytes are fixed
                       points P0[i] = i (their payload offset is kept aside)
  3. pointer doubling — P <- P[P] until fixpoint. Every chain ends at a
                       literal byte because every output byte originates
                       from some payload byte; the format's anchor rule
                       (match source ends strictly before the pair anchor,
                       tsq_encode.cpp:293) guarantees P[i] < i for match
                       bytes, so the map is acyclic and doubling converges
                       in ceil(log2(chain depth)) rounds.
  4. one u8 gather   — out[i] = payload[paysrc[P[i]]].

This is the device decode: every operation is plain jnp/lax that XLA
compiles for whatever backend JAX runs on (the GPU in production, the CPU
in tests). The anchor rule is what makes decode a pointer-doubling problem
with no sequential per-token loop.

The block batch is FLATTENED into one long byte axis with per-block global
offsets (block b occupies bytes [b*n_out, (b+1)*n_out)); every
gather/scatter below is 1-D and unbatched. Chains never cross block
boundaries because tokens are block-local. It shards over the mesh with
shard_map (parallel/pipeline.py).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..format import BLOCK_SZ, OUTPUT_SZ

# Static shapes for full-size blocks. Token capacity: the worst case is one
# symbol per 2 output bytes at 4 MiB (alternating 1-byte literals would blow
# the 5 MiB payload bound first; real streams sit near size/6..size/10).
OUT_N = BLOCK_SZ
PAY_N = OUTPUT_SZ
MAX_TOKENS = BLOCK_SZ // 2 + 8

_take = functools.partial(jnp.take, mode="clip")


def _segment_ids(dst: jax.Array, n_total: int) -> jax.Array:
    """Per-byte token index: t(i) with dst[t] <= i < dst[t+1], flat layout.

    dst is ascending across the flat batch (strictly for live tokens;
    padding tokens carry an out-of-range sentinel and are dropped):
    scatter-max of token indices at their start bytes, then an inclusive
    cummax.
    """
    T = dst.shape[0]
    ids = jnp.zeros(n_total, jnp.int32).at[dst].max(
        jnp.arange(T, dtype=jnp.int32), mode="drop")
    return jax.lax.cummax(ids, axis=0)


@functools.partial(jax.jit, static_argnames=("n_total", "rounds"))
def decode_flat_xla(dst, src, lit, payload_u8, n_total: int | None = None,
                    *, rounds: int = 23):
    """Decode a flat batch of token streams to bytes — no sequential loop.

    dst, src, lit: (T,) i32 token fields in GLOBAL byte coordinates (block
    b's positions offset by b*n_out; literal `src` offset into the flat
    payload by b*pay_n). dst strictly ascending; padding tokens carry
    dst >= n_total and lit = 1. payload_u8: (P,) uint8 flat payloads.
    Returns (n_total,) uint8; the caller reshapes to (B, n_out) and slices.

    ``rounds`` is the FIXED pointer-doubling trip count: 23 covers any
    chain depth <= 2^23 (> the 4 MiB block), so even adversarial RLE-style
    streams converge. Extra rounds past convergence are no-ops (literal
    bytes are fixed points).
    """
    if n_total is None:
        n_total = dst.shape[0]  # pragma: no cover - callers always pass it
    i = jnp.arange(n_total, dtype=jnp.int32)
    t = _segment_ids(dst, n_total)

    token_dst = _take(dst, t)
    token_src = _take(src, t)
    is_lit_b = _take(lit, t) == 1

    s = token_src + (i - token_dst)
    # Match bytes point strictly earlier (format invariant); the clamps only
    # engage on corrupt streams and keep the map acyclic so doubling still
    # terminates (output is then garbage, matching upstream's tolerance).
    P = jnp.where(is_lit_b, i, jnp.maximum(jnp.minimum(s, i - 1), 0))
    paysrc = jnp.where(is_lit_b, s, 0)

    P = jax.lax.fori_loop(0, rounds, lambda _, P: _take(P, P), P)

    return _take(payload_u8, _take(paysrc, P))


@functools.partial(jax.jit, static_argnames=("n_out", "rounds"))
def decode_batch_xla(dst, src, ln, lit, payload_u8, *, n_out: int = OUT_N,
                     rounds: int = 23):
    """Batch decode: (B,T) block-local tokens + (B,P) payloads -> (B,n_out).

    Flattens to global coordinates on-device (cheap elementwise ops) and
    runs the 1-D decode. The batch axis is the block data-parallel axis;
    parallel/pipeline.py wraps this in shard_map over the mesh.
    """
    del ln  # lengths are implied by consecutive dst starts
    B, T = dst.shape
    pay_n = payload_u8.shape[1]
    if B * max(n_out, pay_n) >= 2 ** 31:
        # flat positions are int32
        raise ValueError(f"{B} blocks exceed the int32 flat index space")
    boff = jnp.arange(B, dtype=jnp.int32)[:, None]
    gdst = jnp.reshape(dst + boff * n_out, (B * T,))
    gsrc = jnp.reshape(src + boff * jnp.where(lit == 1, pay_n, n_out),
                       (B * T,))
    glit = jnp.reshape(lit, (B * T,))
    flat_pay = jnp.reshape(payload_u8, (B * pay_n,))
    out = decode_flat_xla(gdst, gsrc, glit, flat_pay, B * n_out,
                          rounds=rounds)
    return jnp.reshape(out, (B, n_out))


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def pack_token_batch(parsed, n_out: int):
    """Pad a list of (dst, src, ln, lit) token arrays into batch planes.

    Returns (dst, src, ln, lit) of shape (B, T) i32, block-local, with the
    padding convention decode_batch_xla expects (pad: dst = n_out, lit = 1,
    src = 0). T is bucketed to limit recompiles.
    """
    B = len(parsed)
    T = _round_up(max(len(p[0]) for p in parsed) + 1, 8192)
    dst = np.full((B, T), n_out, dtype=np.int32)
    src = np.zeros((B, T), dtype=np.int32)
    ln = np.zeros((B, T), dtype=np.int32)
    lit = np.ones((B, T), dtype=np.int32)
    for b, (d, s, l, q) in enumerate(parsed):
        n = len(d)
        dst[b, :n] = d
        src[b, :n] = s
        ln[b, :n] = l
        lit[b, :n] = q
    return dst, src, ln, lit


def pack_payload_batch(payloads, pay_n: int | None = None):
    """Pad payload byte strings to a common length (bucketed)."""
    B = len(payloads)
    P = pay_n or _round_up(max(len(p) for p in payloads) + 1, 1 << 16)
    out = np.zeros((B, P), dtype=np.uint8)
    for b, p in enumerate(payloads):
        out[b, :len(p)] = np.frombuffer(p, dtype=np.uint8)
    return out
