"""L2 data-movement tests (SURVEY.md §4.2): histogram, radix partition
and hashing against numpy; adversarial inputs (sentinels, empties,
overflowing partitions)."""

import numpy as np
import pytest
import jax.numpy as jnp

from tpq import datagen
from tpq.hashing import hash_keys
from tpq.kernels.radix_partition import partition_padded, radix_histogram


@pytest.mark.parametrize("n,nbuckets", [
    (1 << 14, 64),   # with sentinel ids sprinkled in
    (0, 8),          # empty input
    (5000, 37),      # nbuckets not a power of two
])
def test_radix_histogram_matches_bincount(n, nbuckets):
    rng = np.random.default_rng(0)
    bucket = rng.integers(0, nbuckets, n).astype(np.int32)
    # out-of-range ids (the padding sentinel, negatives) must be ignored
    bucket[::17] = nbuckets
    bucket[5::31] = -1
    h = np.asarray(radix_histogram(jnp.asarray(bucket), nbuckets))
    inr = bucket[(bucket >= 0) & (bucket < nbuckets)]
    assert np.array_equal(h, np.bincount(inr, minlength=nbuckets))


def test_partition_padded_stable_and_complete():
    rng = np.random.default_rng(1)
    n = 1 << 12
    bucket = rng.integers(0, 16, n).astype(np.int32)
    rowid2d, valid2d, starts, overflow = partition_padded(jnp.asarray(bucket), 16, 1 << 10)
    assert not bool(overflow)
    rowid2d, valid2d = np.asarray(rowid2d), np.asarray(valid2d)
    seen = []
    for p in range(16):
        rows = rowid2d[p][valid2d[p]]
        assert np.all(bucket[rows] == p)
        assert np.all(np.diff(rows) > 0), "stability: original order preserved"
        seen.append(rows)
    assert len(np.concatenate(seen)) == n


def test_partition_overflow_flag():
    bucket = jnp.zeros(1024, jnp.int32)  # all one bucket
    _, _, _, overflow = partition_padded(bucket, 16, 256)
    assert bool(overflow)


def test_hash_keys_range():
    keys = jnp.asarray(datagen.uniform_keys(1 << 12, 1 << 40, seed=9))
    for bits in (1, 4, 11):
        h = np.asarray(hash_keys(keys, bits))
        assert h.min() >= 0 and h.max() < (1 << bits)
