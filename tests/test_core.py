"""Unit tests for L1/L2 foundations: columnar, hashing, datagen, colio."""

import numpy as np
import jax.numpy as jnp
import pytest

from tpq import Table
from tpq.columnar import canonicalize, next_pow2
from tpq import colio, datagen, hashing


def test_next_pow2():
    assert next_pow2(0) == 8
    assert next_pow2(8) == 8
    assert next_pow2(9) == 16
    assert next_pow2(1_000_000) == 1 << 20


def test_table_roundtrip():
    cols = {"key": np.arange(10, dtype=np.int64), "p0": np.arange(10, dtype=np.int64) * 7}
    t = Table.from_numpy(cols)
    assert t.capacity == 16
    assert int(t.num_rows) == 10
    out = t.to_numpy()
    assert np.array_equal(out["key"], cols["key"])
    assert np.array_equal(out["p0"], cols["p0"])


def test_table_jit_pytree():
    import jax

    t = Table.from_numpy({"key": np.arange(5, dtype=np.int64)})

    @jax.jit
    def double(tbl: Table) -> Table:
        return Table({"key": tbl.col("key") * 2}, tbl.num_rows)

    out = double(t)
    assert np.array_equal(out.to_numpy()["key"], np.arange(5) * 2)


def test_canonicalize_sorts_lexicographically():
    t = Table.from_numpy(
        {"a": np.array([2, 1, 2, 1], dtype=np.int64), "b": np.array([0, 5, -1, 4], dtype=np.int64)}
    )
    c = canonicalize(t)
    assert c["a"].tolist() == [1, 1, 2, 2]
    assert c["b"].tolist() == [4, 5, -1, 0]


def test_hash32_matches_numpy_twin():
    keys = np.array([0, 1, -1, 2**62, -(2**62), 123456789, np.iinfo(np.int64).max,
                     np.iinfo(np.int64).min], dtype=np.int64)
    for bits in (8, 16, 32):
        for salt in (0, 17):
            a = np.asarray(hashing.hash_keys(jnp.asarray(keys), bits, salt))
            b = hashing.np_hash_keys(keys, bits, salt)
            assert np.array_equal(a, b), (bits, salt)


def test_hash_distribution_rough_uniformity():
    keys = datagen.uniform_keys(1 << 16, 1 << 60, seed=3)
    h = hashing.np_hash_keys(keys, 8)
    counts = np.bincount(h, minlength=256)
    # expected 256/bucket; loose 5-sigma-ish band
    assert counts.min() > 120 and counts.max() < 420, (counts.min(), counts.max())


def test_colio_roundtrip(tmp_path):
    cols = {
        "key": np.array([1, -2, 3], dtype=np.int64),
        "x": np.array([0.5, 1.5, -2.5], dtype=np.float32),
    }
    p = tmp_path / "t.tpqc"
    colio.dump(str(p), cols)
    out = colio.load(str(p))
    assert list(out.keys()) == ["key", "x"]
    assert np.array_equal(out["key"], cols["key"])
    assert np.array_equal(out["x"], cols["x"])


def test_datagen_parity_with_oracle(oracle, tmp_path):
    """Seed-stable bitstream contract, SURVEY.md §4.4.3: same seeds => byte-
    identical columns, C++ vs Python."""
    for kind, nkeys, theta in [("uniform", 1000, 1.0), ("zipf", 512, 1.0), ("zipf", 100, 0.8)]:
        py = datagen.gen_relation_np(4096, nkeys, payloads=3, seed=99, kind=kind, theta=theta)
        p_py = tmp_path / f"{kind}_{nkeys}_py.tpqc"
        p_cc = tmp_path / f"{kind}_{nkeys}_cc.tpqc"
        colio.dump(str(p_py), py)
        oracle("datagen", kind=kind, rows=4096, nkeys=nkeys, payloads=3, seed=99,
               theta=theta, out=p_cc)
        assert p_py.read_bytes() == p_cc.read_bytes(), (kind, nkeys, theta)


def test_zipf_is_skewed():
    keys = datagen.zipf_keys(100_000, 10_000, theta=1.0, seed=5)
    counts = np.bincount(keys, minlength=10_000)
    # rank-0 key should dominate: ~ n / (H_n) ≈ 100k/9.8 ≈ 10k hits
    assert counts[0] > 5_000
    assert counts[0] > 50 * max(1, counts[5000])


def test_device_datagen_matches_numpy():
    """The on-device generator (config-2/4 scale benches) is byte-equal
    to the numpy/native stream, including at a chunk offset."""
    import numpy as np

    from tpq import datagen

    ref = datagen.gen_relation_np(5000, 700, payloads=3, seed=9)
    dev = datagen.gen_relation_device(5000, 700, payloads=3, seed=9)
    for k in ref:
        assert np.array_equal(np.asarray(dev.col(k))[:5000], ref[k]), k
    # chunk offset: rows [2000, 5000) of the same stream
    dev2 = datagen.gen_relation_device(3000, 700, payloads=3, seed=9,
                                       row_offset=2000)
    for k in ref:
        assert np.array_equal(np.asarray(dev2.col(k))[:3000], ref[k][2000:]), k


def test_tiled_scans_match_flat():
    """tpq/ops/scan.py tiled decomposition == flat scan / numpy, including
    non-tiled fallback sizes and wrap semantics. FLAT_MAX is patched down
    so the tiled path is exercised at test sizes (in production it only
    engages at >= 2M rows, where the flat form's compile explodes)."""
    import jax.numpy as jnp

    from tpq.ops import scan as scan_mod
    from tpq.ops.scan import (cummax_i32, cumsum_i32, fill_forward,
                              u64_cumsum_planes)

    orig, scan_mod.FLAT_MAX = scan_mod.FLAT_MAX, 1024
    try:
        _run_scan_cases(np.random.default_rng(9), jnp, cummax_i32,
                        cumsum_i32, fill_forward, u64_cumsum_planes)
    finally:
        scan_mod.FLAT_MAX = orig
    # and once with the production threshold (flat path at these sizes)
    _run_scan_cases(np.random.default_rng(10), jnp, cummax_i32,
                    cumsum_i32, fill_forward, u64_cumsum_planes)


def _run_scan_cases(rng, jnp, cummax_i32, cumsum_i32, fill_forward,
                    u64_cumsum_planes):
    for n in (7, 512, 4 * 512, 20 * 512, 20 * 512 + 256):
        x = rng.integers(-(1 << 30), 1 << 30, n).astype(np.int32)
        assert np.array_equal(np.asarray(cumsum_i32(jnp.asarray(x))),
                              np.cumsum(x, dtype=np.int32)), n
        assert np.array_equal(np.asarray(cummax_i32(jnp.asarray(x))),
                              np.maximum.accumulate(x)), n
        v = rng.integers(0, 1 << 63, n, dtype=np.uint64)
        lo = jnp.asarray((v & 0xFFFFFFFF).astype(np.uint32))
        hi = jnp.asarray((v >> 32).astype(np.uint32))
        clo, chi = u64_cumsum_planes(lo, hi)
        got = (np.asarray(chi).astype(np.uint64) << 32) | np.asarray(clo)
        assert np.array_equal(got, np.cumsum(v, dtype=np.uint64)), n
        valid = jnp.asarray(rng.random(n) < 0.3)
        p = jnp.asarray(rng.integers(0, 1 << 31, n).astype(np.uint32))
        (f,) = fill_forward(valid, [p])
        # positions before the first valid sample are unspecified (no
        # engine consumer reads them) — compare from the first valid on
        exp = np.zeros(n, np.uint32)
        last = 0
        vnp, pnp = np.asarray(valid), np.asarray(p)
        for i in range(n):
            if vnp[i]:
                last = pnp[i]
            exp[i] = last
        if vnp.any():
            first = int(np.argmax(vnp))
            assert np.array_equal(np.asarray(f)[first:], exp[first:]), n


@pytest.mark.parametrize("env", [None, "/var/cache/tpq-test"])
def test_compile_cache_dir_rule(monkeypatch, env):
    """JAX_COMPILATION_CACHE_DIR when set, else <repo>/.jaxcache; the
    package configures JAX with exactly that."""
    import jax

    import tpq

    assert jax.config.jax_compilation_cache_dir == tpq.compile_cache_dir()
    if env is None:
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        assert tpq.compile_cache_dir() == str(tpq.REPO_ROOT / ".jaxcache")
    else:
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", env)
        assert tpq.compile_cache_dir() == env
