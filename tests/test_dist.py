"""D1-D5 on 8 simulated CPU devices (SURVEY.md §4.3): collective semantics
are identical to a real slice; tests prove the multi-chip code paths and
oracle-exactness of the distributed join."""

import numpy as np
import pytest

import jax

from tpq import colio, datagen
from tpq.columnar import canonicalize, Table
from tpq.dist import make_mesh
from tpq.dist.dist_join import DistTable, dist_hash_join

from conftest import assert_tables_equal


requires_multidevice = pytest.mark.skipif(
    len(jax.devices()) < 8, reason="needs 8 (simulated) devices"
)


def _canon_np(cols: dict) -> dict:
    names = list(cols.keys())
    order = np.lexsort(tuple(cols[n] for n in reversed(names)))
    return {n: cols[n][order] for n in names}


# Cold-compile budget: each (algo, impl) variant compiles a fresh
# 8-shard shard_map program. The fast suite keeps (hash, dense) and marks
# the cross combinations slow; the ring rung stays fast via
# test_ring_exchange_equals_dense.
_DIST_MATRIX = [
    ("hash", "dense"),
    pytest.param("merge", "ring", marks=pytest.mark.slow),
    pytest.param("merge", "dense", marks=pytest.mark.slow),
    pytest.param("hash", "ring", marks=pytest.mark.slow),
]


@requires_multidevice
@pytest.mark.parametrize("algo,exchange_impl", _DIST_MATRIX)
def test_dist_join_matches_oracle(oracle, tmp_path, algo, exchange_impl):
    mesh = make_mesh(8)
    r = datagen.gen_relation_np(5000, 700, payloads=1, seed=31)
    s = datagen.gen_relation_np(8000, 700, payloads=2, seed=32)

    pr, ps, po = (tmp_path / f"{algo}_{n}.tpqc" for n in ("r", "s", "o"))
    colio.dump(str(pr), r)
    colio.dump(str(ps), s)
    oracle("join", algo="hash", left=pr, right=ps, out=po)
    expected = colio.load(str(po))

    R = DistTable.from_numpy(r, mesh)
    S = DistTable.from_numpy(s, mesh)
    out, overflow = dist_hash_join(R, S, mesh, out_capacity_per_shard=1 << 15,
                                   algo=algo, exchange_impl=exchange_impl)
    assert int(np.asarray(overflow).sum()) == 0
    got = _canon_np(out.to_numpy())
    assert_tables_equal(got, expected, f"dist_{algo}_{exchange_impl}")


@requires_multidevice
@pytest.mark.slow  # covered by the faster skew-split test; ~2 min compile
def test_dist_join_zipf_skew_correct(oracle, tmp_path):
    """theta=1.0 skew: one chip owns the heavy key; correctness must hold
    even before skew-splitting (D4) makes it fast."""
    mesh = make_mesh(8)
    r = datagen.gen_relation_np(3000, 5000, payloads=1, seed=41, kind="zipf")
    s = datagen.gen_relation_np(3000, 5000, payloads=1, seed=42, kind="zipf")
    pr, ps, po = (tmp_path / f"z_{n}.tpqc" for n in ("r", "s", "o"))
    colio.dump(str(pr), r)
    colio.dump(str(ps), s)
    oracle("join", algo="hash", left=pr, right=ps, out=po)
    # shard owning zipf keys 0+1 emits ~145k join rows (325*339 + 168*175 +
    # ...) — needs 1<<18 output capacity; 1<<17 correctly trips overflow.
    R = DistTable.from_numpy(r, mesh, local_capacity=4096)
    S = DistTable.from_numpy(s, mesh, local_capacity=4096)
    out, overflow = dist_hash_join(R, S, mesh, out_capacity_per_shard=1 << 18,
                                   exchange_capacity=4096)
    assert int(np.asarray(overflow).sum()) == 0
    assert_tables_equal(_canon_np(out.to_numpy()), colio.load(str(po)), "dist_zipf")


@requires_multidevice
def test_ring_exchange_equals_dense():
    """Rung 3 (ppermute ring) delivers exactly the rows rung 2 does —
    same multiset per destination shard."""
    from functools import partial
    from jax import shard_map
    from jax.sharding import NamedSharding, PartitionSpec as P

    from tpq.dist.exchange import exchange
    from tpq.dist.mesh import AXIS, owner_of

    mesh = make_mesh(8)
    rng = np.random.default_rng(7)
    n, cap = 4096, 512
    cols = {"key": rng.integers(0, 1 << 40, size=n).astype(np.int64),
            "p0": rng.integers(0, 1 << 30, size=n).astype(np.int64)}
    T = DistTable.from_numpy(cols, mesh)

    def run(impl):
        @partial(shard_map, mesh=mesh,
                 in_specs=({k: P(AXIS) for k in cols}, P(AXIS)),
                 out_specs=({k: P(AXIS) for k in cols}, P(AXIS), P(AXIS)))
        def body(c, nrows):
            t = Table(c, nrows[0])
            recv, ovf = exchange(t, owner_of(t.col("key"), 8), AXIS, 8, cap,
                                 impl=impl)
            recv = recv.with_capacity(8 * cap)
            return dict(recv.columns), recv.num_rows[None].astype(np.int32), ovf[None]

        c, nrows, ovf = body(T.columns, T.shard_rows)
        assert int(np.asarray(ovf).sum()) == 0
        return DistTable(c, nrows).to_numpy()

    dense, ring = run("dense"), run("ring")
    assert_tables_equal(_canon_np(dense), _canon_np(ring), "ring_vs_dense")


@requires_multidevice
@pytest.mark.slow  # two full ring-join compiles; the renegotiation
# test and dryrun_multichip keep the contract covered
def test_ring_join_output_overflow_not_silent():
    """Round-2 regression (MULTICHIP_r02 rc=1): the final with_capacity
    clamped num_rows BEFORE the overflow check, so the ring variant
    silently dropped 15,111 of 62,545 join rows with overflow == 0.
    Contract (SURVEY.md §5.3): either the full result or overflow != 0."""
    mesh = make_mesh(8)
    r = datagen.gen_relation_np(1024, 600, payloads=1, seed=1, kind="zipf")
    s = datagen.gen_relation_np(2048, 600, payloads=1, seed=2, kind="zipf")
    import collections

    rc = collections.Counter(r["key"].tolist())
    sc = collections.Counter(s["key"].tolist())
    expected = sum(rc[k] * sc[k] for k in rc)
    R = DistTable.from_numpy(r, mesh)
    S = DistTable.from_numpy(s, mesh)

    out, overflow = dist_hash_join(R, S, mesh, out_capacity_per_shard=1 << 15,
                                   exchange_impl="ring")
    got_rows = len(out.to_numpy()["key"])
    # under-capacity: MUST report overflow rather than quietly truncate
    assert got_rows == expected or int(np.asarray(overflow).sum()) > 0, \
        f"silent row loss: {got_rows}/{expected} rows, overflow==0"

    out, overflow = dist_hash_join(R, S, mesh, out_capacity_per_shard=1 << 17,
                                   exchange_impl="ring")
    assert int(np.asarray(overflow).sum()) == 0
    assert len(out.to_numpy()["key"]) == expected


@requires_multidevice
@pytest.mark.slow  # two full ring compiles; the overflow-not-silent test
def test_dist_renegotiation_recovers_ring_overflow():
    """§5.3 closure for the distributed path: start from the capacity that
    overflows and let the host wrapper grow it to the full result."""
    from tpq.dist.dist_join import dist_hash_join_renegotiated

    mesh = make_mesh(8)
    r = datagen.gen_relation_np(1024, 600, payloads=1, seed=1, kind="zipf")
    s = datagen.gen_relation_np(2048, 600, payloads=1, seed=2, kind="zipf")
    import collections

    rc = collections.Counter(r["key"].tolist())
    sc = collections.Counter(s["key"].tolist())
    expected = sum(rc[k] * sc[k] for k in rc)
    R = DistTable.from_numpy(r, mesh)
    S = DistTable.from_numpy(s, mesh)
    out, retries = dist_hash_join_renegotiated(
        R, S, mesh, out_capacity_per_shard=1 << 14, exchange_impl="ring")
    assert len(out.to_numpy()["key"]) == expected
    assert retries >= 1  # 1<<14 cannot hold the skewed shard's output


@requires_multidevice
def test_exchange_overflow_detected():
    mesh = make_mesh(8)
    # all rows share one key -> all land on one chip; tiny bucket capacity
    cols = {"key": np.zeros(4096, dtype=np.int64)}
    R = DistTable.from_numpy(cols, mesh)
    out, overflow = dist_hash_join(R, R, mesh, out_capacity_per_shard=1 << 10,
                                   exchange_capacity=128)
    assert int(np.asarray(overflow).sum()) > 0


@requires_multidevice
def test_dist_empty_relation():
    mesh = make_mesh(8)
    r = datagen.gen_relation_np(0, 10, payloads=1, seed=1)
    s = datagen.gen_relation_np(64, 10, payloads=1, seed=2)
    R = DistTable.from_numpy(r, mesh)
    S = DistTable.from_numpy(s, mesh)
    out, overflow = dist_hash_join(R, S, mesh, out_capacity_per_shard=256)
    assert int(np.asarray(overflow).sum()) == 0
    assert len(out.to_numpy()["key"]) == 0


@requires_multidevice
@pytest.mark.parametrize(
    "n_chunks", [4, pytest.param(1, marks=pytest.mark.slow)])
def test_dist_join_skew_split_matches_oracle(oracle, tmp_path, n_chunks):
    """D4 + D3: zipf theta=1.0 with heavy-hitter splitting and chunked
    (overlappable) exchange - still oracle-exact."""
    from tpq.dist.dist_join import SkewConfig

    mesh = make_mesh(8)
    r = datagen.gen_relation_np(4096, 5000, payloads=1, seed=51, kind="zipf")
    s = datagen.gen_relation_np(4096, 5000, payloads=1, seed=52, kind="zipf")
    pr, ps, po = (tmp_path / f"sk{n_chunks}_{n}.tpqc" for n in ("r", "s", "o"))
    colio.dump(str(pr), r)
    colio.dump(str(ps), s)
    oracle("join", algo="merge", left=pr, right=ps, out=po)
    R = DistTable.from_numpy(r, mesh)
    S = DistTable.from_numpy(s, mesh)
    out, overflow = dist_hash_join(
        R, S, mesh, out_capacity_per_shard=1 << 17, exchange_capacity=2048,
        skew=SkewConfig(candidates_per_shard=8, threshold=256,
                        replica_capacity_per_shard=2048),
        n_chunks=n_chunks)
    assert int(np.asarray(overflow).sum()) == 0
    assert_tables_equal(_canon_np(out.to_numpy()), colio.load(str(po)),
                        f"dist_skew_{n_chunks}")


@requires_multidevice
@pytest.mark.slow  # 3 shard_map compiles at 8192 rows (~2 min cold)
def test_planned_capacities_no_hand_tuning():
    """plan_dist_capacities sizes ex_cap/out_cap exactly from the data
    (radix_histogram + keys-only cardinality pass) — the zipf case that
    needs hand-tuned capacities elsewhere runs with none given and no
    overflow (VERDICT r2 item 9)."""
    from tpq.dist.dist_join import dist_hash_join_planned, plan_dist_capacities

    mesh = make_mesh(8)
    r = datagen.gen_relation_np(8192, 50_000, payloads=1, seed=61, kind="zipf")
    s = datagen.gen_relation_np(8192, 50_000, payloads=1, seed=62, kind="zipf")
    R = DistTable.from_numpy(r, mesh)
    S = DistTable.from_numpy(s, mesh)
    ex_cap, out_cap = plan_dist_capacities(R, S, mesh)
    # zipf head: one destination owns key 0's ~700+ rows -> ex_cap must
    # exceed the uniform-share guess (8192/8 = 1024 would be fine, but the
    # hot bucket is what the histogram must have caught)
    import collections
    rc = collections.Counter(r["key"].tolist())
    sc = collections.Counter(s["key"].tolist())
    expected = sum(rc[k] * sc[k] for k in rc)
    assert out_cap >= expected / 8  # some shard owns a big slice

    out, overflow = dist_hash_join_planned(R, S, mesh)
    assert int(np.asarray(overflow).sum()) == 0
    assert len(out.to_numpy()["key"]) == expected


@requires_multidevice
@pytest.mark.slow  # two 8192-row joins; divert semantics also covered above
def test_skew_split_actually_diverts_heavy_keys():
    """The heavy path must carry the zipf head: with a tiny exchange
    capacity that WOULD overflow on the unsplit join, the split join
    must not overflow."""
    from tpq.dist.dist_join import SkewConfig

    mesh = make_mesh(8)
    r = datagen.gen_relation_np(8192, 50_000, payloads=1, seed=61, kind="zipf")
    s = datagen.gen_relation_np(8192, 50_000, payloads=1, seed=62, kind="zipf")
    R = DistTable.from_numpy(r, mesh)
    S = DistTable.from_numpy(s, mesh)
    # key 0 appears ~9% of 8192 = ~750 times per side; exchange buckets of
    # 512 per destination overflow without splitting...
    _, ovf_nosplit = dist_hash_join(R, S, mesh, out_capacity_per_shard=1 << 17,
                                    exchange_capacity=512)
    assert int(np.asarray(ovf_nosplit).sum()) > 0
    # ...and survive with the heavy keys diverted to the replica path.
    _, ovf_split = dist_hash_join(
        R, S, mesh, out_capacity_per_shard=1 << 17, exchange_capacity=512,
        skew=SkewConfig(candidates_per_shard=8, threshold=128,
                        replica_capacity_per_shard=4096))
    assert int(np.asarray(ovf_split).sum()) == 0


def test_chip_smoke_dist_phase_on_4_device_submesh(oracle_bin, tmp_path):
    """Rehearsal of chip_smoke.py's four-card phase (config 5's path:
    dist_hash_join_renegotiated, one shard per device, exact count and
    key-range slices vs the oracle) on 4 of the 8 virtual CPU devices."""
    import chip_smoke

    res = chip_smoke.dist_join_check(1 << 13, 4, slices=2,
                                     workdir=tmp_path, oracle=oracle_bin)
    assert "count-exact" in res and "over 4 devices" in res
