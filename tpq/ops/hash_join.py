"""C6 — hash equi-join (SURVEY.md §2.1 C6; BASELINE.json:L5 "hash join
(build+probe with open-addressing/robin-hood tables)"; oracle twin:
oracle/main.cc hash_join()).

The reference's per-tuple build/probe loop becomes the union-sort engine
(tpq/ops/union_join.py): both relations are co-sorted by key, equal-key
runs take the place of hash buckets, and matches are emitted with scans
and a small compacted tail. It is exact for any key distribution,
Zipf skew included: heavy keys past the inline rounds fall through to
full expansion, and no per-partition capacity can overflow.

Semantics (oracle-exact): inner join on `key`; duplicate keys on both
sides yield the full per-key cross product; output columns key,
r_<R payloads...>, s_<S payloads...>; static out_capacity with overflow
visible as num_rows > capacity.
"""

from __future__ import annotations

from tpq.columnar import Table


def hash_join(
    r: Table,
    s: Table,
    out_capacity: int,
    key: str = "key",
    probe_keep=None,
) -> Table:
    """Inner equi-join R ⋈ S on `key`.

    probe_keep (bool[s.capacity], optional): pushed-down probe-side
    filter — semantically join(r, filter(s, keep)); the probe side is
    compacted before the join.
    """
    from tpq.ops.union_join import union_join

    if probe_keep is not None:
        from tpq.ops.filter import compact

        s = compact(s, probe_keep)
    return union_join(r, s, out_capacity, key=key)
