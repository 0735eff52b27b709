"""D2 — distributed shuffle exchange (SURVEY.md §2.2 D2).

The communication backend is XLA's collective set, reached through
`shard_map` (XLA hands it to NCCL over NVLink on the GPU) —
BASELINE.json:L5 "distributed shuffle exchange".

Two semantically identical forms (SURVEY.md §5.8 ladder):
  * dense `all_to_all` with per-destination padding (the default;
    static shapes everywhere);
  * `ppermute` ring — the overlap-friendly variant (D3).
The ladder's `ragged_all_to_all` rung is not here: on four H100s it
lowered but repeated calls of one compiled program disagreed
(ROADMAP, "Where things stand").

All functions here run INSIDE a shard_map body: arrays are the local
shard, `axis` is the mesh axis name.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from tpq.columnar import Table
from tpq.ops._expand import exclusive_cumsum
from tpq.ops.filter import compact


def bucket_by_dest(table: Table, dest: jnp.ndarray, nbuckets: int, bucket_capacity: int):
    """Scatter local rows into a [nbuckets * bucket_capacity] send layout,
    rows of bucket d contiguous at d*bucket_capacity. Returns
    (bucketed_cols, counts[nbuckets], overflow_count).

    Stable within bucket (sort-by-dest reorder, SURVEY.md §7.3.4: sort-based
    reorder keeps the exchange deterministic).
    """
    cap = table.capacity
    dest = jnp.where(table.valid_mask(), dest, nbuckets)  # pads to sentinel
    dest = jax.lax.optimization_barrier(dest)  # keep producers out of the sort
    order = jnp.argsort(dest, stable=True)
    dest_sorted = dest[order]
    ones = (dest_sorted < nbuckets).astype(jnp.int32)
    counts_ext = jax.ops.segment_sum(ones, dest_sorted, num_segments=nbuckets + 1)
    counts = counts_ext[:nbuckets].astype(jnp.int32)
    offsets = exclusive_cumsum(counts_ext.astype(jnp.int32))
    pos_in_bucket = jnp.arange(cap, dtype=jnp.int32) - offsets[jnp.minimum(dest_sorted, nbuckets)]
    in_range = (dest_sorted < nbuckets) & (pos_in_bucket < bucket_capacity)
    overflow = jnp.sum((dest_sorted < nbuckets) & ~in_range, dtype=jnp.int32)
    flat_idx = jnp.where(in_range, dest_sorted * bucket_capacity + pos_in_bucket,
                         nbuckets * bucket_capacity)
    out_cols = {}
    for name, col in table.columns.items():
        out_cols[name] = (
            jnp.zeros(nbuckets * bucket_capacity, col.dtype)
            .at[flat_idx].set(col[order], mode="drop")
        )
    counts = jnp.minimum(counts, bucket_capacity)
    return out_cols, counts, overflow


def exchange_dense(table: Table, dest: jnp.ndarray, axis: str, nchips: int,
                   bucket_capacity: int):
    """Dense all_to_all exchange. Returns (local Table of received rows with
    capacity nchips*bucket_capacity, send_overflow scalar)."""
    bucketed, counts, overflow = bucket_by_dest(table, dest, nchips, bucket_capacity)
    recv_counts = jax.lax.all_to_all(counts, axis, split_axis=0, concat_axis=0, tiled=True)
    recv_cols = {}
    for name, col in bucketed.items():
        col2 = col.reshape(nchips, bucket_capacity)
        recv = jax.lax.all_to_all(col2, axis, split_axis=0, concat_axis=0)
        recv_cols[name] = recv.reshape(nchips * bucket_capacity)
    slot = jnp.arange(nchips * bucket_capacity, dtype=jnp.int32)
    valid = (slot % bucket_capacity) < recv_counts[slot // bucket_capacity]
    received = Table(recv_cols, nchips * bucket_capacity)
    return compact(received, valid), overflow


def ring_hops(table: Table, dest: jnp.ndarray, axis: str, nchips: int,
              bucket_capacity: int):
    """`ppermute`-ring exchange, hop by hop (SURVEY.md §5.8), the
    overlap-friendly variant: hop t moves exactly the rows
    that are t ring-steps from home, so a consumer can join hop t-1's
    rows while hop t is on the wire (D3's structural overlap — the
    ring-attention communication skeleton applied to join state,
    SURVEY.md §2.2 checklist).

    Yields nchips (bucket Table, its true row count) pairs: hop 0 is the
    local bucket, hop t>0 arrives from ring predecessor i-t. Total bytes
    on the wire equal the dense all_to_all's; they are just spread over
    n-1 schedulable hops.
    """
    bucketed, counts, overflow = bucket_by_dest(table, dest, nchips, bucket_capacity)
    me = jax.lax.axis_index(axis)
    cols2d = {n: c.reshape(nchips, bucket_capacity) for n, c in bucketed.items()}

    def bucket_for(offset: int):
        """My bucket destined for chip (me + offset) % nchips."""
        j = (me + offset) % nchips
        cols = {n: jax.lax.dynamic_slice_in_dim(c, j, 1, axis=0)[0]
                for n, c in cols2d.items()}
        return cols, counts[j]

    hops = []
    local_cols, local_cnt = bucket_for(0)
    hops.append((Table(local_cols, local_cnt), overflow))
    for t in range(1, nchips):
        # Receiver i's hop-t bucket lives on shard (i+t): every shard
        # sends its bucket destined for its t-step ring predecessor
        # (me - t), and the perm routes source j -> dest (j - t).
        perm_t = [(j, (j - t) % nchips) for j in range(nchips)]
        send_cols, send_cnt = bucket_for((nchips - t) % nchips)
        recv_cols = {n: jax.lax.ppermute(c, axis, perm_t)
                     for n, c in send_cols.items()}
        recv_cnt = jax.lax.ppermute(send_cnt, axis, perm_t)
        hops.append((Table(recv_cols, recv_cnt), jnp.int32(0)))
    return hops


def exchange_ring(table: Table, dest: jnp.ndarray, axis: str, nchips: int,
                  bucket_capacity: int):
    """Ring exchange materialized to one received Table (same contract as
    exchange_dense); the hop-level generator `ring_hops` is what the
    overlapped join consumes."""
    hops = ring_hops(table, dest, axis, nchips, bucket_capacity)
    overflow = hops[0][1]
    cols = {n: jnp.concatenate([h.columns[n] for h, _ in hops])
            for n in hops[0][0].names}
    slot = jnp.arange(nchips * bucket_capacity, dtype=jnp.int32)
    cnts = jnp.stack([h.num_rows for h, _ in hops])
    valid = (slot % bucket_capacity) < cnts[slot // bucket_capacity]
    received = Table(cols, nchips * bucket_capacity)
    return compact(received, valid), overflow


def exchange(table: Table, dest: jnp.ndarray, axis: str, nchips: int,
             bucket_capacity: int, impl: str = "dense"):
    if impl == "dense":
        return exchange_dense(table, dest, axis, nchips, bucket_capacity)
    if impl == "ring":
        return exchange_ring(table, dest, axis, nchips, bucket_capacity)
    raise ValueError(f"unknown exchange impl {impl!r}")
