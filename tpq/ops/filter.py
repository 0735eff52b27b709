"""C9 — filter: predicate -> mask -> compaction (SURVEY.md §2.1 C9).

Reference capability: filter (BASELINE.json:L5,L10); oracle twin:
oracle/main.cc filter(). Realization: vectorized predicate, then one
stable multi-operand sort by the keep flag — static capacity preserved,
new num_rows as a device scalar (never a host sync).
"""

from __future__ import annotations

from typing import Callable

import jax
import jax.numpy as jnp

from tpq.columnar import Table

_OPS: dict[str, Callable] = {
    "lt": lambda a, b: a < b,
    "le": lambda a, b: a <= b,
    "gt": lambda a, b: a > b,
    "ge": lambda a, b: a >= b,
    "eq": lambda a, b: a == b,
    "ne": lambda a, b: a != b,
}


def compact(t: Table, keep: jnp.ndarray) -> Table:
    """Keep rows where `keep` (bool[capacity]); stable order.

    ONE multi-operand stable sort by the keep flag, carrying every column
    as 32-bit planes — the sort applies the permutation to the data
    directly, with no argsort+gather."""
    from tpq.ops._expand import barrier
    from tpq.ops.union_join import col_planes, planes_col

    keep = keep & t.valid_mask()
    flag = barrier(jnp.where(keep, 0, 1).astype(jnp.uint8))
    names = list(t.names)
    layout: list[tuple[str, int]] = []
    flat: list[jnp.ndarray] = []
    for name in names:
        ps = col_planes(t.col(name))
        layout.append((name, len(ps)))
        flat += list(ps)
    with jax.named_scope("filter_compact"):
        res = jax.lax.sort((flag, *flat), num_keys=1, is_stable=True)
    n_out = jnp.sum(keep, dtype=jnp.int32)
    cols, pos = {}, 1
    for name, cnt in layout:
        cols[name] = planes_col(tuple(res[pos + j] for j in range(cnt)),
                                t.col(name).dtype)
        pos += cnt
    return Table(cols, n_out)


def filter_table(t: Table, col: str, op: str, value) -> Table:
    """Rows of t where `col <op> value`; op in lt/le/gt/ge/eq/ne."""
    c = t.col(col)
    keep = _OPS[op](c, jnp.asarray(value, c.dtype))
    return compact(t, keep)
