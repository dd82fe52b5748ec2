"""Dense visited-set ops — the tensor replacement for the reference's per-query
visited hash set (SURVEY.md §2 "Visited set", §2 native-component item 3).

Two modes, chosen by the search engine:

- **exact**: one bit per node slot, uint32[B, N_cap/32].  Correct but the
  buffer is B·N_cap/8 bytes, and XLA cannot alias the scatter inside a
  while_loop — every iteration pays a full copy of that buffer.  Right
  choice for small indexes.
- **hashed**: a fixed 2^b-bit bitmap per query (Knuth multiplicative hash,
  high bits).  Collisions make a fresh candidate look visited — a tunable
  ~1% skip rate — in exchange for a bitmap that is orders of magnitude
  smaller, which is what makes the while_loop copy affordable at scale.
  This is SURVEY.md §7's "bloom-style hashing" mitigation, made the default
  for large N by the engine.

The scatter-add trick: setting bits via .at[word].add(1 << bit) equals
bitwise-OR iff every masked (word, bit) pair is distinct and currently 0.
Callers guarantee it by deduplicating on the *test index* (id or hash) and
pre-filtering with bitset_test, so two distinct ids that collide in hash
space are collapsed by the dedup before the scatter.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

KNUTH = jnp.uint32(2654435761)  # 2^32 / golden ratio


def hash_ids(ids: jax.Array, bits_log2: int) -> jax.Array:
    """Multiplicative hash into [0, 2^bits_log2): high bits of id * KNUTH."""
    h = jnp.maximum(ids, 0).astype(jnp.uint32) * KNUTH
    return (h >> jnp.uint32(32 - bits_log2)).astype(jnp.int32)


def bitset_new(batch: int, n_bits: int) -> jax.Array:
    """Fresh all-zeros bitset: uint32[batch, n_bits/32]."""
    assert n_bits % 32 == 0, "bitset size must be a multiple of 32"
    return jnp.zeros((batch, n_bits // 32), dtype=jnp.uint32)


def bitset_test(bits: jax.Array, idx: jax.Array, valid: jax.Array) -> jax.Array:
    """bool[B, K]: whether each index's bit is set (False where not valid)."""
    safe = jnp.maximum(idx, 0)
    word = safe >> 5
    bit = (safe & 31).astype(jnp.uint32)
    w = jnp.take_along_axis(bits, word, axis=1)
    hit = (w >> bit) & jnp.uint32(1)
    return jnp.where(valid, hit.astype(jnp.bool_), False)


def bitset_set(bits: jax.Array, idx: jax.Array, mask: jax.Array) -> jax.Array:
    """Set bits of `idx[b, k]` where `mask[b, k]` (see OR-via-add note above).

    Word indices DO repeat (distinct ids sharing a 32-bit word; masked-off
    entries all collapsing to word 0 with value 0), so this must be a plain
    accumulating scatter-add — `unique_indices=True` would be undefined
    behavior here.  Bit positions within a word are still unique after the
    caller's dedup, so accumulation equals bitwise OR."""
    safe = jnp.maximum(idx, 0)
    word = jnp.where(mask, safe >> 5, 0)
    bit = (safe & 31).astype(jnp.uint32)
    val = jnp.where(mask, jnp.uint32(1) << bit, jnp.uint32(0))
    return jax.vmap(lambda b, w, v: b.at[w].add(v))(bits, word, val)


def first_occurrence_mask(ids: jax.Array) -> jax.Array:
    """bool[B, K]: True on the first occurrence of each value within its row.

    Deduplicates before `bitset_set` so the scatter-add stays an exact OR;
    K is small so the O(K²) elementwise comparison is cheap."""
    eq = ids[:, :, None] == ids[:, None, :]  # [B, K, K]
    k = ids.shape[1]
    earlier = jnp.tril(jnp.ones((k, k), dtype=bool), k=-1)
    return ~jnp.any(eq & earlier, axis=2)
