"""C7 — sort-merge equi-join (SURVEY.md §2.1 C7).

Reference capability: sort-merge join with radix-sorted runs + two-cursor
merge (BASELINE.json:L5 "radix sort for the merge path"; oracle twin:
oracle/main.cc merge_join). A cursor merge is serial control flow; the
vectorized form instead:

  1. co-sort both relations by key in ONE union sort (`lax.sort`,
     SURVEY.md §7.3.4) — the sorted union IS the merge;
  2. detect equal-key runs with neighbor compares and scans;
  3. emit the per-key cross product with fill-forward scans + a small
     compacted tail (tpq/ops/union_join.py) — no per-row loops.

Join semantics match the oracle exactly: inner equi-join on "key",
duplicates produce the full cross product per key; output columns
key, r_<R payloads>, s_<S payloads>.

Output capacity is static (worst case |R|x|S| is unrepresentable —
SURVEY.md §7.4.3): callers pass out_capacity; `num_rows` returned may
exceed it, which callers must treat as overflow and renegotiate.
"""

from __future__ import annotations

import jax.numpy as jnp

from tpq.columnar import Table
from tpq.ops._expand import barrier

I64_MAX = jnp.iinfo(jnp.int64).max


def sort_table_by_key(t: Table, key: str = "key") -> Table:
    """Stable co-sort of all columns by `key`; padding rows sort last.

    ONE stable sort with a SINGLE sort key and all other columns carried
    as 32-bit planes — the sort applies the permutation to the data; no
    argsort+gather. Padding ordering needs no second key: padding rows
    are a suffix of the input (Table invariant) with their keys where'd
    to the dtype max, so every valid row either has a smaller key or, at
    a real MAX-key tie, precedes the padding by stability — valid rows
    always end up in the first num_rows slots. The ORIGINAL padding keys are not preserved (padding
    contents are unspecified by contract)."""
    import jax

    from tpq.ops.union_join import col_planes, planes_col

    k_eff = barrier(jnp.where(t.valid_mask(), t.col(key),
                              jnp.iinfo(t.col(key).dtype).max))
    names = [n for n in t.names if n != key]
    layout: list[tuple[str, int]] = []
    flat: list[jnp.ndarray] = []
    for name in names:
        ps = col_planes(t.col(name))
        layout.append((name, len(ps)))
        flat += list(ps)
    res = jax.lax.sort((k_eff, *flat), num_keys=1, is_stable=True)
    cols, pos = {key: res[0]}, 1
    for name, cnt in layout:
        cols[name] = planes_col(tuple(res[pos + j] for j in range(cnt)),
                                t.col(name).dtype)
        pos += cnt
    return Table(cols, t.num_rows)


def merge_join(r: Table, s: Table, out_capacity: int,
               key: str = "key") -> Table:
    """Inner equi-join R ⋈ S on `key`. Returns Table with static capacity
    `out_capacity`; .num_rows is the true match count (check overflow).

    Realized by the union-sort engine (tpq/ops/union_join.py): the union
    sort IS the merge (both relations co-sorted by key), emission is
    scan-based."""
    from tpq.ops.union_join import union_join

    return union_join(r, s, out_capacity, key=key)
