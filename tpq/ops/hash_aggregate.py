"""C8 — hash aggregate: group-by key -> count + per-payload sum
(SURVEY.md §2.1 C8; BASELINE.json:L5,L10 "hash aggregate (group-by
count/sum)"; oracle twin: oracle/main.cc aggregate()).

Realization: co-sort by key, then compute every per-group statistic AT
RUN-END POSITIONS with scans only — no gathers:

  * run starts by neighbor compare; run start index rs by cummax;
  * count at an end position = i - rs + 1;
  * sum over the run = c[i] - B, where c is the inclusive cumsum and B is
    a fill-forward (associative scan) of "cumsum just before my run's
    start" sampled at run starts;
  * PACK (tpq/kernels/move.py: exclusive cumsum + scatter) compacts the
    group rows to the front, carrying key/count/sums as 32-bit planes.

Sums are wrapping int64 (associative-safe — no float reorder
nondeterminism, SURVEY.md §4.4.4). Output columns: key, count,
sum_<payload>... in input payload order; groups emitted in ascending key
order (canonical already — PACK preserves order).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from tpq.columnar import Table
from tpq.ops.merge_join import sort_table_by_key
from tpq.ops.scan import cummax_i32, fill_forward, u64_cumsum_planes
from tpq.ops.union_join import col_planes, planes_col

I32 = jnp.int32
I64 = jnp.int64
U32 = jnp.uint32

def hash_aggregate(t: Table, key: str = "key") -> Table:
    """Group t by `key`; count + sum every other column (wrapping int64).
    Output capacity = input capacity (ngroups <= nrows always).

    Plane-native pipeline: every per-group statistic is computed on u32
    planes (u64-with-carry scans, borrow-chain run sums) and the planes
    feed the PACK mover directly; int64 columns are reconstructed only
    for the packed group rows."""
    cap = t.capacity
    with jax.named_scope("agg_sort"):
        ts = sort_table_by_key(t, key)
    k = ts.col(key)
    valid = ts.valid_mask()
    i = jnp.arange(cap, dtype=I32)

    is_start = valid & jnp.concatenate([jnp.ones(1, bool), k[1:] != k[:-1]])
    # a run ends where the next row starts a new run, is padding, or at cap-1
    nxt_new = jnp.concatenate([is_start[1:] | ~valid[1:], jnp.ones(1, bool)])
    is_end = valid & nxt_new
    rs = cummax_i32(jnp.where(is_start, i, -1))  # my run's start index

    # per-column inclusive cumsums as u32 plane pairs; `pre` = cumsum just
    # before my run's start, fill-forwarded from run-start positions
    names = [n for n in ts.names if n != key]
    cum_pairs: list[tuple[jnp.ndarray, jnp.ndarray]] = []
    pre_planes: list[jnp.ndarray] = []
    zero1 = jnp.zeros(1, U32)
    for n in names:
        lo, hi = col_planes(ts.col(n).astype(I64))
        lo = jnp.where(valid, lo, 0)
        hi = jnp.where(valid, hi, 0)
        clo, chi = u64_cumsum_planes(lo, hi)
        cum_pairs.append((clo, chi))
        pre_planes += [jnp.concatenate([zero1, clo[:-1]]),
                       jnp.concatenate([zero1, chi[:-1]])]
    filled = fill_forward(is_start, pre_planes) if pre_planes else []

    # output planes in column order: key, count, sum_<n>... — masking by
    # is_end is unnecessary (PACK drops every row with occ == 0)
    layout: list[tuple[str, int, object]] = [(key, 0, k.dtype)]
    flat: list[jnp.ndarray] = list(col_planes(k))
    layout[0] = (key, len(flat), k.dtype)
    cnt = (i - rs + 1).astype(U32)
    flat += [cnt, jnp.zeros(cap, U32)]
    layout.append(("count", 2, I64))
    for j, n in enumerate(names):
        clo, chi = cum_pairs[j]
        blo, bhi = filled[2 * j].astype(U32), filled[2 * j + 1].astype(U32)
        slo = clo - blo
        borrow = (clo < blo).astype(U32)
        flat += [slo, chi - bhi - borrow]
        layout.append((f"sum_{n}", 2, I64))

    # compact group rows (at end positions) to the front with PACK
    from tpq.kernels.move import pack

    with jax.named_scope("pack"):
        packed, n_groups = pack(flat, is_end)
    cols, pos = {}, 0
    for n, npl, dt in layout:
        cols[n] = planes_col(tuple(packed[pos + j].astype(U32)
                                   for j in range(npl)), dt)
        pos += npl
    return Table(cols, n_groups.astype(I32))
