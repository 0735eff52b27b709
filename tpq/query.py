"""C10 — pipeline composer (SURVEY.md §2.1 C10; BASELINE.json:L10
"full pipeline query: filter -> hash join -> hash aggregate").

The reference runs operators as separate timed phases over materialized
relations (SURVEY.md §3.1). This design instead composes the whole
pipeline into ONE jitted program so XLA fuses across operator
boundaries — the filter's compaction feeds the join's partitioning
without a round trip to HBM-materialized intermediates where fusion
allows, and there is exactly one dispatch.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from tpq.columnar import Table
from tpq.ops import filter_table, hash_aggregate, hash_join, merge_join


def full_pipeline(
    dim: Table,
    fact: Table,
    filter_col: str,
    filter_op: str,
    filter_value,
    out_capacity: int,
    algo: str = "hash",
) -> Table:
    """filter(fact) -> join(dim, fact') -> aggregate(by key).

    Output: one row per surviving key group with count + sums over all
    joined payload columns (oracle pipeline: oracle filter | join |
    aggregate chained on files).

    Fusion decision (SURVEY.md §2.1 C10): for the hash path the filter
    is PUSHED DOWN into the join as a predicate mask (`probe_keep`); the
    merge path filters materially first.
    """
    if algo == "hash":
        from tpq.ops.filter import _OPS

        c = fact.col(filter_col)
        keep = _OPS[filter_op](c, jnp.asarray(filter_value, c.dtype))
        joined = hash_join(dim, fact, out_capacity, probe_keep=keep)
    elif algo == "merge":
        fact_f = filter_table(fact, filter_col, filter_op, filter_value)
        joined = merge_join(dim, fact_f, out_capacity)
    else:
        raise ValueError(f"unknown algo {algo!r}")
    return hash_aggregate(joined)


def jit_pipeline(out_capacity: int, filter_col="key", filter_op="lt", algo="hash"):
    """Returns a jitted (dim, fact, filter_value) -> Table pipeline."""

    @jax.jit
    def run(dim: Table, fact: Table, filter_value) -> Table:
        return full_pipeline(dim, fact, filter_col, filter_op, filter_value,
                             out_capacity, algo)

    return run
