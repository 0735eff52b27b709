"""C3 — radix partition: histogram + stable reorder into padded
per-partition planes (SURVEY.md §2.1 C3; BASELINE.json:L5
"radix-partitioned build tables").

Two pieces:

  * `radix_histogram` — per-bucket row counts (`segment_sum` of ones),
    for partition planning, exchange sizing and skew stats without
    materializing any reorder.

  * `partition_padded` — stable reorder of rows into a [npart, part_cap]
    padded layout: one stable multi-operand `lax.sort` by bucket +
    searchsorted starts + 2-D gather. This is the building block under
    the shuffle exchange bucketing (D2).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

I32 = jnp.int32


def radix_histogram(bucket: jnp.ndarray, nbuckets: int) -> jnp.ndarray:
    """int32 counts of each bucket id in [0, nbuckets); ids outside the
    range (e.g. the padding sentinel) are ignored."""
    return jax.ops.segment_sum(jnp.ones(bucket.shape, I32), bucket,
                               num_segments=nbuckets)


def partition_starts(bucket_sorted: jnp.ndarray, npart: int) -> jnp.ndarray:
    """Exclusive prefix layout of a bucket-sorted column: starts[p] = first
    row of partition p; starts[npart] = end of live rows."""
    return jnp.searchsorted(bucket_sorted, jnp.arange(npart + 1, dtype=I32)).astype(I32)


def padded_gather(col: jnp.ndarray, starts: jnp.ndarray, npart: int, cap: int):
    """[N]-sorted column -> [npart, cap] padded planes + validity mask."""
    i = jnp.arange(cap, dtype=I32)[None, :]
    src = jnp.minimum(starts[:-1][:, None] + i, col.shape[0] - 1)
    valid = i < (starts[1:] - starts[:-1])[:, None]
    return col[src], valid


def partition_padded(bucket: jnp.ndarray, npart: int, part_cap: int,
                     extra_keys: tuple[jnp.ndarray, ...] = ()):
    """Stable-partition row indices by bucket id (sentinel id == npart is
    padding and lands at the end). Returns (rowid2d [npart, part_cap],
    valid2d, starts, overflow_flag). `extra_keys` refine the order within
    a bucket (e.g. (slot, key) for the robin-hood layout)."""
    n = bucket.shape[0]
    idx = jnp.arange(n, dtype=I32)
    operands = jax.lax.optimization_barrier((bucket, *extra_keys)) + (idx,)
    sorted_ops = jax.lax.sort(operands, num_keys=1 + len(extra_keys), is_stable=True)
    bucket_s, idx_s = sorted_ops[0], sorted_ops[-1]
    starts = partition_starts(bucket_s, npart)
    part_len = starts[1:] - starts[:-1]
    overflow = jnp.any(part_len > part_cap)
    rowid2d, valid2d = padded_gather(idx_s, starts, npart, part_cap)
    return rowid2d, valid2d, starts, overflow
