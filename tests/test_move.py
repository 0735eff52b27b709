"""PAD/PACK movers (tpq/kernels/move.py) vs explicit numpy placement."""

import numpy as np
import jax.numpy as jnp
import pytest

from tpq.kernels.move import pack, pad


def _pad_case(n_live, out_len, nplanes, seed, n_alloc=None):
    rng = np.random.default_rng(seed)
    n_alloc = n_alloc or n_live
    dest = np.sort(rng.choice(out_len, size=n_live, replace=False)).astype(np.int32)
    planes = [rng.integers(1, 1 << 30, size=n_alloc).astype(np.int32)
              for _ in range(nplanes)]
    return planes, dest, n_live, out_len


@pytest.mark.parametrize("n_live,out_len,nplanes,seed", [
    (3000, 4096, 1, 0),
    (5000, 8192, 3, 1),
    (0, 2048, 2, 2),
    (2048, 2048, 2, 3),  # dense
    (1, 2048, 1, 4),
    (777, 1000, 2, 5),   # lengths not a multiple of 128
])
def test_pad_matches_numpy(n_live, out_len, nplanes, seed):
    planes, dest, n_live, out_len = _pad_case(n_live, out_len, nplanes, seed)
    dpad = np.zeros(max(len(dest), 1), np.int32) if n_live == 0 else dest
    outs, occ = pad([jnp.asarray(p) for p in planes],
                    jnp.asarray(dpad if n_live else np.zeros(len(planes[0]), np.int32)),
                    n_live, out_len)
    occ = np.asarray(occ).astype(bool)
    want_occ = np.zeros(out_len, bool)
    want_occ[dest[:n_live]] = True
    np.testing.assert_array_equal(occ, want_occ)
    for p, o in zip(planes, outs):
        want = np.zeros(out_len, np.int32)
        want[dest[:n_live]] = p[:n_live]
        np.testing.assert_array_equal(np.asarray(o), want)


def test_pad_with_dead_suffix():
    """Rows past n_live (garbage from a padded sort) must not leak."""
    planes, dest, n_live, out_len = _pad_case(1000, 4096, 2, 7, n_alloc=1500)
    full_dest = np.full(1500, out_len, np.int32)
    full_dest[:n_live] = dest
    outs, occ = pad([jnp.asarray(p) for p in planes], jnp.asarray(full_dest),
                    n_live, out_len)
    assert int(np.asarray(occ).sum()) == n_live
    want = np.zeros(out_len, np.int32)
    want[dest] = planes[0][:n_live]
    np.testing.assert_array_equal(np.asarray(outs[0]), want)


def test_pad_last_slot_and_out_of_range_dest():
    """A live row may land on slot out_len-1; a live dest at or past
    out_len (or negative) is dropped, never wrapped."""
    p = jnp.asarray(np.array([11, 22, 33, 44], np.int32))
    dest = jnp.asarray(np.array([-1, 5, 9, 10], np.int32))
    (o,), occ = pad([p], dest, 4, 10)
    want = np.zeros(10, np.int32)
    want[5], want[9] = 22, 33
    np.testing.assert_array_equal(np.asarray(o), want)
    np.testing.assert_array_equal(np.asarray(occ), (want != 0).astype(np.int32))


@pytest.mark.parametrize("n,density,nplanes,seed", [
    (4096, 0.6, 1, 0),
    (10000, 0.3, 4, 1),
    (2048, 0.0, 2, 2),   # all dead
    (2048, 1.0, 2, 3),
    (1000, 0.5, 3, 4),   # length not a multiple of 128
])
def test_pack_matches_numpy(n, density, nplanes, seed):
    rng = np.random.default_rng(seed)
    occ = (rng.random(n) < density).astype(np.int32)
    planes = [rng.integers(1, 1 << 30, size=n).astype(np.int32)
              for _ in range(nplanes)]
    outs, total = pack([jnp.asarray(p) for p in planes], jnp.asarray(occ))
    k = int(occ.sum())
    assert int(total) == k
    for p, o in zip(planes, outs):
        o = np.asarray(o)
        np.testing.assert_array_equal(o[:k], p[occ.astype(bool)])
        assert (o[k:] == 0).all()


def test_pad_pack_roundtrip():
    rng = np.random.default_rng(11)
    n_live, out_len = 3000, 8192
    dest = np.sort(rng.choice(out_len, size=n_live, replace=False)).astype(np.int32)
    p = rng.integers(1, 1 << 30, size=n_live).astype(np.int32)
    padded, occ = pad([jnp.asarray(p)], jnp.asarray(dest), n_live, out_len)
    packed, total = pack(padded, occ)
    assert int(total) == n_live
    np.testing.assert_array_equal(np.asarray(packed[0])[:n_live], p)
