"""L3 operators vs the C++ oracle — the bit-exactness contract
(SURVEY.md §4.4): canonical-order byte equality on shared seed-stable
relations, across sizes, skew, duplicates, and edge cases.
"""

import numpy as np
import pytest

from tpq import Table
from tpq.columnar import canonicalize
from tpq import colio, datagen
from tpq.ops import filter_table, hash_aggregate, hash_join, merge_join

from conftest import assert_tables_equal


def _dump_for_oracle(tmp_path, name, cols):
    p = tmp_path / f"{name}.tpqc"
    colio.dump(str(p), cols)
    return p


def _join_case(oracle, tmp_path, r_cols, s_cols, join_fn, out_capacity, tag):
    pr = _dump_for_oracle(tmp_path, f"{tag}_r", r_cols)
    ps = _dump_for_oracle(tmp_path, f"{tag}_s", s_cols)
    po = tmp_path / f"{tag}_out.tpqc"
    oracle("join", algo="hash", left=pr, right=ps, out=po)
    expected = colio.load(str(po))

    out = join_fn(Table.from_numpy(r_cols), Table.from_numpy(s_cols), out_capacity)
    n = int(out.num_rows)
    assert n <= out_capacity, f"{tag}: overflow {n} > {out_capacity}"
    assert_tables_equal(canonicalize(out), expected, tag)


# both operator entry points (C6 hash_join, C7 merge_join) over the
# shared union-sort engine
JOIN_FNS = {"merge": merge_join, "hash": hash_join}


# Cold-compile budget: every (impl, shape) pair is a distinct XLA:CPU
# compile. The fast suite keeps both entry points on the canonical case
# and the tiny edge shapes, and marks the remaining cross-shape
# combinations slow — they still run in the full suite.
_JOIN_CASES = [
    (1000, 1500, 300, "uniform", 1 << 14),
    (1000, 1500, 2_000_000, "uniform", 1 << 10),  # mostly no matches
    (2048, 2048, 64, "uniform", 1 << 17),  # heavy duplicates
    (2000, 1500, 1000, "zipf", 1 << 17),  # skewed
    (1, 1, 1, "uniform", 1 << 4),
    (7, 1, 3, "uniform", 1 << 4),
]
_FAST_JOINS = {(impl, ci) for impl in ("merge", "hash") for ci in (0, 4, 5)}


def _join_matrix():
    for impl in ("merge", "hash"):
        for ci, case in enumerate(_JOIN_CASES):
            marks = [] if (impl, ci) in _FAST_JOINS else [pytest.mark.slow]
            yield pytest.param(impl, *case, marks=marks,
                               id=f"{impl}-case{ci}")


@pytest.mark.parametrize("impl,nr,ns,nkeys,kind,cap", list(_join_matrix()))
def test_join_matches_oracle(oracle, tmp_path, impl, nr, ns, nkeys, kind, cap):
    r = datagen.gen_relation_np(nr, nkeys, payloads=2, seed=11, kind=kind)
    s = datagen.gen_relation_np(ns, nkeys, payloads=1, seed=22, kind=kind)
    _join_case(oracle, tmp_path, r, s, JOIN_FNS[impl], cap, f"{impl}_{nr}x{ns}k{nkeys}{kind}")


@pytest.mark.parametrize("impl", ["merge", "hash"])
def test_join_empty_sides(oracle, tmp_path, impl):
    r = datagen.gen_relation_np(0, 10, payloads=1, seed=1)
    s = datagen.gen_relation_np(100, 10, payloads=1, seed=2)
    _join_case(oracle, tmp_path, r, s, JOIN_FNS[impl], 1 << 10, f"{impl}_empty_r")
    _join_case(oracle, tmp_path, s, r, JOIN_FNS[impl], 1 << 10, f"{impl}_empty_s")


@pytest.mark.parametrize("impl", ["merge", "hash"])
def test_join_edge_keys(oracle, tmp_path, impl):
    """INT64_MIN/MAX keys must not collide with the padding sentinel
    (SURVEY.md §4.2 adversarial inputs)."""
    im, ix = np.iinfo(np.int64).min, np.iinfo(np.int64).max
    r = {"key": np.array([im, ix, ix, 0, -1, 5], dtype=np.int64),
         "p0": np.arange(6, dtype=np.int64)}
    s = {"key": np.array([ix, im, 5, 5, 7, ix, 0], dtype=np.int64),
         "p0": np.arange(7, dtype=np.int64) * 10}
    _join_case(oracle, tmp_path, r, s, JOIN_FNS[impl], 1 << 8, f"{impl}_edge")


@pytest.mark.slow  # two engine compiles at tiny shapes; per-key
# cross-product duplicates stay covered by the fast case0 tests
def test_join_all_equal_keys(oracle, tmp_path):
    """Worst-case duplicates: |R|x|S| cross product within one key."""
    r = {"key": np.zeros(64, dtype=np.int64), "p0": np.arange(64, dtype=np.int64)}
    s = {"key": np.zeros(32, dtype=np.int64), "p0": np.arange(32, dtype=np.int64)}
    for impl in ("merge", "hash"):
        _join_case(oracle, tmp_path, r, s, JOIN_FNS[impl], 4096, f"{impl}_allequal")


def test_join_overflow_detected():
    r = Table.from_numpy({"key": np.zeros(64, dtype=np.int64)})
    s = Table.from_numpy({"key": np.zeros(64, dtype=np.int64)})
    out = merge_join(r, s, out_capacity=128)  # true size 4096
    assert int(out.num_rows) == 4096  # > capacity => caller sees overflow


@pytest.mark.parametrize(
    "rows,nkeys,kind", [(4096, 128, "uniform"), (4096, 1024, "zipf"), (1, 1, "uniform")]
)
def test_aggregate_matches_oracle(oracle, tmp_path, rows, nkeys, kind):
    t = datagen.gen_relation_np(rows, nkeys, payloads=2, seed=33, kind=kind)
    pin = _dump_for_oracle(tmp_path, f"agg_{rows}_{nkeys}", t)
    po = tmp_path / f"agg_{rows}_{nkeys}_out.tpqc"
    oracle("aggregate", **{"in": pin, "out": po})
    expected = colio.load(str(po))
    out = hash_aggregate(Table.from_numpy(t))
    assert_tables_equal(canonicalize(out), expected, f"agg_{rows}_{nkeys}_{kind}")


def test_aggregate_edge_keys(oracle, tmp_path):
    ix = np.iinfo(np.int64).max
    t = {"key": np.array([ix, ix, 3, 3, 3], dtype=np.int64),
         "p0": np.array([1, 2, 3, 4, 5], dtype=np.int64)}
    pin = _dump_for_oracle(tmp_path, "agg_edge", t)
    po = tmp_path / "agg_edge_out.tpqc"
    oracle("aggregate", **{"in": pin, "out": po})
    out = hash_aggregate(Table.from_numpy(t))
    assert_tables_equal(canonicalize(out), colio.load(str(po)), "agg_edge")


@pytest.mark.parametrize("op,value", [("lt", 50), ("ge", 100), ("eq", 7), ("ne", 7)])
def test_filter_matches_oracle(oracle, tmp_path, op, value):
    t = datagen.gen_relation_np(2048, 200, payloads=2, seed=44)
    pin = _dump_for_oracle(tmp_path, f"filt_{op}", t)
    po = tmp_path / f"filt_{op}_out.tpqc"
    oracle("filter", **{"in": pin, "col": "key", "op": op, "value": value, "out": po})
    out = filter_table(Table.from_numpy(t), "key", op, value)
    assert_tables_equal(canonicalize(out), colio.load(str(po)), f"filter_{op}")


@pytest.mark.slow  # determinism is also implied by the
# byte-exact oracle equality asserted across the suite
def test_determinism_two_runs():
    """§5.2 determinism: same inputs run twice => byte-identical device
    output (catches nondeterministic scatter ordering)."""
    r = datagen.gen_relation_np(2000, 100, payloads=1, seed=1)
    s = datagen.gen_relation_np(2000, 100, payloads=1, seed=2)
    for fn in (merge_join, hash_join):
        a = fn(Table.from_numpy(r), Table.from_numpy(s), 1 << 17)
        b = fn(Table.from_numpy(r), Table.from_numpy(s), 1 << 17)
        for k in a.columns:
            assert np.array_equal(np.asarray(a.columns[k]), np.asarray(b.columns[k]))
