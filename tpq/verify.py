"""Scale-proportional verification (SURVEY.md §4.4.4).

The C++ oracle proves bit-exactness up to ~10M rows in seconds. Beyond
that (configs 2, 4 and 5) a full oracle run is infeasible, so
verification becomes:

  1. key-range slicing — the inner join commutes with key-range
     restriction: sigma_[a,b)(R join S) == sigma_[a,b)(R) join
     sigma_[a,b)(S). Slice both inputs to a few narrow ranges, run the
     oracle on the slices (thousands of rows), and byte-compare against
     the engine output restricted to the same range.
  2. order-invariant multiset checksum — a commutative reduction over
     per-row mixes, computable shard-local + psum'd on device without
     materializing a canonical order. Two engine runs (or engine vs
     engine-on-different-mesh) must agree exactly; integer adds are
     associative-safe (SURVEY.md §4.4.4).
  3. ground truth from the seed streams — the exact join cardinality and
     the exact filter->join->aggregate group table, computed on the host
     from the same seed-stable streams the engine's inputs come from.
"""

from __future__ import annotations

import numpy as np

import jax.numpy as jnp

from tpq.columnar import Table

_MIX = np.uint64(0x9E3779B97F4A7C15)


def _mix64(x: jnp.ndarray) -> jnp.ndarray:
    """splitmix64-style finalizer (vectorized, u64)."""
    x = x.astype(jnp.uint64)
    x = (x ^ (x >> jnp.uint64(30))) * jnp.uint64(0xBF58476D1CE4E5B9)
    x = (x ^ (x >> jnp.uint64(27))) * jnp.uint64(0x94D049BB133111EB)
    return x ^ (x >> jnp.uint64(31))


def multiset_checksum(t: Table) -> jnp.ndarray:
    """Order-invariant u64 checksum of the live rows: sum over rows of
    mix(row-hash), where the row-hash folds every column (name order is
    part of the contract). Wrapping adds commute, so any row order —
    including per-shard partials combined by psum — yields the same
    value."""
    acc = jnp.zeros(t.capacity, jnp.uint64)
    for i, name in enumerate(t.names):
        col = t.columns[name].astype(jnp.uint64)
        acc = _mix64(acc + col + jnp.uint64(i + 1) * _MIX)
    valid = t.valid_mask()
    return jnp.sum(jnp.where(valid, acc, jnp.uint64(0)))


def multiset_checksum_np(cols: dict[str, np.ndarray]) -> int:
    """Numpy twin of multiset_checksum (host-side / oracle-output side)."""
    names = list(cols.keys())
    n = len(cols[names[0]]) if names else 0
    acc = np.zeros(n, np.uint64)

    def mix(x):
        x = x.astype(np.uint64)
        x = (x ^ (x >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
        x = (x ^ (x >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
        return x ^ (x >> np.uint64(31))

    with np.errstate(over="ignore"):
        for i, name in enumerate(names):
            acc = mix(acc + cols[name].astype(np.uint64) + np.uint64(i + 1) * _MIX)
        return int(acc.sum(dtype=np.uint64))


def slice_by_key(cols: dict[str, np.ndarray], lo: int, hi: int,
                 key: str = "key") -> dict[str, np.ndarray]:
    """Host-side key-range restriction sigma_[lo,hi)."""
    m = (cols[key] >= lo) & (cols[key] < hi)
    return {n: c[m] for n, c in cols.items()}


def sample_key_ranges(keys: np.ndarray, n_ranges: int = 4,
                      target_rows: int = 2048, seed: int = 0):
    """Pick n_ranges [lo, hi) key windows that each cover ~target_rows of
    `keys` (sampled quantile estimate, no full sort of the relation)."""
    rng = np.random.default_rng(seed)
    sample = rng.choice(keys, size=min(len(keys), 1 << 16), replace=False)
    sample.sort()
    frac = target_rows / max(1, len(keys))
    step = max(1, int(len(sample) * frac))
    ranges = []
    for _ in range(n_ranges):
        i = int(rng.integers(0, max(1, len(sample) - step)))
        lo, hi = int(sample[i]), int(sample[min(len(sample) - 1, i + step)]) + 1
        if lo < hi:
            ranges.append((lo, hi))
    return ranges


def join_count(r_keys: np.ndarray, s_keys: np.ndarray, nkeys: int) -> int:
    """Exact inner-join cardinality sum_k cnt_R(k) * cnt_S(k) for keys in
    [0, nkeys)."""
    cr = np.bincount(r_keys, minlength=nkeys).astype(np.int64)
    cs = np.bincount(s_keys, minlength=nkeys).astype(np.int64)
    return int((cr * cs).sum())


def pipeline_expected_groups(n_dim: int, n_fact: int, fact_payloads: int,
                             filter_value: int, dim_seed: int = 1,
                             fact_seed: int = 2) -> dict[str, np.ndarray]:
    """Exact group table of filter(key < filter_value) -> join -> aggregate
    over the config-4 relations (dim: n_dim uniform keys in [0, n_dim), one
    payload; fact: n_fact rows keyed into the same domain), from the
    seed-stable streams. Columns key, count, sum_r_p0, sum_s_p<j>..., in
    ascending key order; sums wrap as int64."""
    from tpq import datagen

    fk = datagen.uniform_keys(n_fact, n_dim, seed=fact_seed)
    pays = datagen.payload_cols(n_fact, fact_payloads, seed=fact_seed)
    dk = datagen.uniform_keys(n_dim, n_dim, seed=dim_seed)
    dp = datagen.payload_cols(n_dim, 1, seed=dim_seed)
    keep = fk < filter_value
    fk2 = fk[keep]
    dmult = np.bincount(dk, minlength=n_dim).astype(np.int64)
    # exact wrapping int sums via np.add.at on int64
    dsum = np.zeros(n_dim, np.int64)
    np.add.at(dsum, dk, dp["p0"])
    cnt = np.zeros(n_dim, np.int64)
    np.add.at(cnt, fk2, dmult[fk2])
    sum_r = np.zeros(n_dim, np.int64)
    np.add.at(sum_r, fk2, dsum[fk2])
    live = cnt > 0
    out = {"key": np.nonzero(live)[0].astype(np.int64), "count": cnt[live],
           "sum_r_p0": sum_r[live]}
    for j in range(fact_payloads):
        v = np.zeros(n_dim, np.int64)
        np.add.at(v, fk2, pays[f"p{j}"][keep] * dmult[fk2])
        out[f"sum_s_p{j}"] = v[live]
    return out


def assert_groups_equal(got: dict[str, np.ndarray],
                        expected: dict[str, np.ndarray]) -> None:
    """Byte equality of two group tables, after ordering `got` by key."""
    order = np.argsort(got["key"], kind="stable")
    assert list(got) == list(expected), (list(got), list(expected))
    for name, want in expected.items():
        have = np.asarray(got[name])[order]
        assert have.shape == want.shape, f"{name}: {have.shape} vs {want.shape}"
        assert np.array_equal(have, want), f"group column {name} differs"
