"""PAD / PACK — order-preserving layout movers, in plain `jnp`.

  * pad(planes, dest, n_live, out_len) — move row k of a COMPACT live
    prefix to slot dest[k], inserting gaps: one scatter per plane plus an
    occupancy scatter, with every dead or out-of-range row dropped.

  * pack(planes, occ) — compact live rows to the front, preserving
    order: an exclusive cumsum of `occ` gives each live row its slot, and
    one scatter per plane moves it there. Slots past the live prefix are
    zero.

Callers: `hash_aggregate` (PACK of the group rows) and the chunked
config-4 accumulator in `tpq/bench/scale_bench.py` (PAD of each chunk's
group table onto its key slots).
"""

from __future__ import annotations

import jax.numpy as jnp

I32 = jnp.int32


def pad(planes: list[jnp.ndarray], dest: jnp.ndarray, n_live,
        out_len: int):
    """Place row k (k < n_live) of each compact plane at slot dest[k].

    planes: 1-D arrays, equal length N >= n_live. dest: int[N], strictly
    increasing and in [0, out_len) over the live prefix (caller's
    contract; live dests outside [0, out_len) are dropped and must be
    counted as overflow upstream). Rows k >= n_live are ignored.
    Returns ([out_len] planes, occ int32[out_len] 0/1).
    """
    n = planes[0].shape[0]
    d = dest.astype(I32)
    live = (jnp.arange(n, dtype=I32) < n_live) & (d >= 0) & (d < out_len)
    idx = jnp.where(live, d, out_len)
    outs = [jnp.zeros(out_len, p.dtype).at[idx].set(p, mode="drop")
            for p in planes]
    occ = jnp.zeros(out_len, I32).at[idx].set(1, mode="drop")
    return outs, occ


def pack(planes: list[jnp.ndarray], occ: jnp.ndarray):
    """Compact live rows (occ != 0) of each plane to the front, order
    preserved. Returns ([N] planes zero-padded after the live prefix,
    total int32)."""
    n = planes[0].shape[0]
    keep = occ != 0
    k = keep.astype(I32)
    slot = jnp.cumsum(k, dtype=I32) - k
    idx = jnp.where(keep, slot, n)
    outs = [jnp.zeros(n, p.dtype).at[idx].set(p, mode="drop")
            for p in planes]
    return outs, jnp.sum(k, dtype=I32)
