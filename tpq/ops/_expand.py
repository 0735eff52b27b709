"""Segment expansion — the static-shape replacement for the reference's
data-dependent "emit one output row per match" loops (SURVEY.md §3.2,
§7.3.3).

Given per-source-row match segments (offset into the output, count), build
gather indices for an output of static capacity:

  out slot t belongs to source row seg(t), with within-segment rank
  rank(t) = t - offset[seg(t)].

Implemented with a vectorized binary search (searchsorted) over the
exclusive-cumsum offsets — gathers only.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def barrier(x):
    """`jax.lax.optimization_barrier` at operator phase boundaries.

    Barriers pin each phase's results to materialized buffers, so XLA
    does not sink sort/searchsorted producers into large consumer
    fusions; this is the dataflow the roofline model (B2) accounts for.
    """
    return jax.lax.optimization_barrier(x)


def exclusive_cumsum(x: jnp.ndarray) -> jnp.ndarray:
    from tpq.ops.scan import cumsum_i32

    if x.dtype == jnp.int32:
        return cumsum_i32(x) - x
    return jnp.cumsum(x) - x


def searchsorted(a: jnp.ndarray, v: jnp.ndarray, side: str = "left") -> jnp.ndarray:
    """`jnp.searchsorted` with method='sort' for large query sets: it
    lowers to the concat+stable-sort rank trick instead of the default
    method's while loop over the full query array."""
    return jnp.searchsorted(a, v, side=side, method="sort")


def expand_segments(counts: jnp.ndarray, capacity: int):
    """counts: int32[n] — matches per source row (0 for invalid rows).

    Returns (seg_id, rank, total, valid):
      seg_id: int32[capacity] — source row for each output slot (clamped >=0)
      rank:   int32[capacity] — within-segment position
      total:  int32 scalar — true number of output rows (may exceed capacity
              => overflow; caller must check)
      valid:  bool[capacity] — slot < total
    """
    with jax.named_scope("expand"):
        return _expand_segments(counts, capacity)


def _expand_segments(counts: jnp.ndarray, capacity: int):
    counts = counts.astype(jnp.int32)
    offsets = barrier(exclusive_cumsum(counts))
    total = offsets[-1] + counts[-1]
    slot = jnp.arange(capacity, dtype=jnp.int32)
    # Output slot t belongs to the last source row j with offsets[j] <= t
    # (ties from empty segments resolve to the largest j, which is the
    # non-empty one: an empty j shares its offset with j+1).
    seg_id = (searchsorted(offsets, slot, side="right") - 1).astype(jnp.int32)
    seg_id = jnp.maximum(seg_id, 0)
    seg_id = barrier(seg_id)
    rank = slot - offsets[seg_id]
    valid = slot < total
    return seg_id, rank, total, valid
