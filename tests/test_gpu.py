"""GPU smoke suite (SURVEY.md §4.5): small configs compiled for the card —
compile + numerics only. Marked `gpu`: skipped on any other device, run
on the card by `python chip_smoke.py` (one process; the persistent
compilation cache keeps reruns warm)."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from tpq import Table, datagen, colio
from tpq.columnar import canonicalize
from tpq.ops import filter_table, hash_aggregate, hash_join, merge_join
from tpq.query import jit_pipeline

from conftest import assert_tables_equal

pytestmark = pytest.mark.gpu


@pytest.fixture(scope="module")
def relations():
    r = datagen.gen_relation_np(1024, 1024, payloads=1, seed=1)
    s = datagen.gen_relation_np(2048, 1024, payloads=2, seed=2)
    return r, s


def _oracle_join(oracle, tmp_path, r, s, algo="hash"):
    pr, ps, po = (tmp_path / f"{n}.tpqc" for n in ("r", "s", "o"))
    colio.dump(str(pr), r)
    colio.dump(str(ps), s)
    oracle("join", algo=algo, left=pr, right=ps, out=po)
    return colio.load(str(po))


@pytest.mark.parametrize("algo", ["hash", "merge"])
def test_join_on_gpu(oracle, tmp_path, relations, algo):
    r, s = relations
    R, S = Table.from_numpy(r), Table.from_numpy(s)
    expected = _oracle_join(oracle, tmp_path, r, s)
    join = hash_join if algo == "hash" else merge_join
    out = jax.jit(lambda a, b: join(a, b, 1 << 13))(R, S)
    assert_tables_equal(canonicalize(out), expected, f"gpu_{algo}")


def test_aggregate_filter_pipeline_on_gpu(oracle, tmp_path, relations):
    r, s = relations
    R, S = Table.from_numpy(r), Table.from_numpy(s)
    out = jax.jit(lambda t: hash_aggregate(t))(S)
    pin = tmp_path / "agg_in.tpqc"
    po = tmp_path / "agg_out.tpqc"
    colio.dump(str(pin), s)
    oracle("aggregate", **{"in": pin, "out": po})
    assert_tables_equal(canonicalize(out), colio.load(str(po)), "gpu_agg")

    fo = jax.jit(lambda t: filter_table(t, "key", "lt", 512))(S)
    assert int(fo.num_rows) == int((s["key"] < 512).sum())

    pipe = jit_pipeline(1 << 13)
    res = pipe(R, S, 512)
    assert int(res.num_rows) > 0


def test_u32_planes_roundtrip_on_gpu():
    """The 2xu32 plane split/rejoin every sort and gather relies on, on
    int64 keys at 1M rows, against numpy."""
    from tpq.ops.union_join import col_planes, planes_col

    rng = np.random.default_rng(3)
    keys = rng.integers(np.iinfo(np.int64).min, np.iinfo(np.int64).max,
                        1 << 20, dtype=np.int64)
    lo, hi = jax.jit(col_planes)(jnp.asarray(keys))
    u = keys.view(np.uint64)
    assert np.array_equal(np.asarray(lo), (u & 0xFFFFFFFF).astype(np.uint32))
    assert np.array_equal(np.asarray(hi), (u >> 32).astype(np.uint32))
    back = jax.jit(lambda a, b: planes_col((a, b), jnp.int64))(lo, hi)
    assert np.array_equal(np.asarray(back), keys)


def test_movers_and_histogram_on_gpu():
    """PAD, PACK and the histogram compiled for the card, against numpy."""
    from tpq.kernels.move import pack, pad
    from tpq.kernels.radix_partition import radix_histogram

    rng = np.random.default_rng(4)
    n, out_len = 1 << 20, 1 << 21
    dest = np.sort(rng.choice(out_len, size=n, replace=False)).astype(np.int32)
    p = rng.integers(0, 1 << 31, n).astype(np.uint32)
    (o,), occ = jax.jit(lambda a, d: pad([a], d, n, out_len))(
        jnp.asarray(p), jnp.asarray(dest))
    want = np.zeros(out_len, np.uint32)
    want[dest] = p
    assert np.array_equal(np.asarray(o), want)
    assert int(np.asarray(occ).sum()) == n

    (q,), total = jax.jit(lambda a, m: pack([a], m))(o, occ)
    assert int(total) == n
    assert np.array_equal(np.asarray(q)[:n], p)

    ids = rng.integers(0, 1000, n).astype(np.int32)
    hist = jax.jit(lambda b: radix_histogram(b, 997))(jnp.asarray(ids))
    assert np.array_equal(np.asarray(hist), np.bincount(ids, minlength=1000)[:997])


def test_determinism_on_gpu(relations):
    r, s = relations
    R, S = Table.from_numpy(r), Table.from_numpy(s)
    f = jax.jit(lambda a, b: hash_join(a, b, 1 << 13))
    a, b = f(R, S), f(R, S)
    for k in a.columns:
        assert np.array_equal(np.asarray(a.columns[k]), np.asarray(b.columns[k]))
