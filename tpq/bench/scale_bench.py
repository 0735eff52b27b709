"""Configs 2 and 4 at full scale (BASELINE.json:L8,L10), chunked so the
100M-row probe side never has to be joined in one program.

Both benches:
  * generate relations ON-DEVICE (tpq/datagen.py device twins — byte-
    identical to the oracle's stream), one compiled generator per chunk
    with the row offset traced,
  * join every probe chunk against the whole build (dim) table through
    `hash_join` — the chunk size bounds the union sort and the candidate
    buffers, not the build side,
  * verify against host-side numpy ground truth computed from the same
    seed-stable streams (full-scale count check for the join; exact
    per-group count/sum table compare for the pipeline — tpq/verify.py).

Timing excludes generation of the build side and verification; per-chunk
outputs are consumed (reduced) on device so chunk buffers recycle.
"""

from __future__ import annotations

import time

import jax
import jax.numpy as jnp

from tpq import datagen
from tpq.bench import roofline
from tpq.bench.device import require_gpu
from tpq.columnar import Table, next_pow2
from tpq.ops import hash_join

I32 = jnp.int32
I64 = jnp.int64


def _consume(t: Table) -> jnp.ndarray:
    """Device-side reduction over EVERY output column (so XLA cannot
    dead-code-eliminate any of the join's materialization) — wrapping
    i32 sums of each column's bit planes."""
    import jax.lax as lax

    acc = t.num_rows.astype(I32)
    mask = t.valid_mask()
    for c in t.columns.values():
        planes = lax.bitcast_convert_type(c, I32)
        acc = acc ^ jnp.sum(jnp.where(mask[:, None], planes, 0), dtype=I32)
    return acc


def _chunk_generator(chunk_rows: int, nkeys: int, payloads: int, seed: int,
                     n_total: int):
    """gen_c(ci) -> Table of rows [ci*chunk_rows, ...) of the seed stream."""
    gen_chunk = jax.jit(lambda off: datagen.gen_relation_device(
        chunk_rows, nkeys, payloads, seed=seed, capacity=chunk_rows,
        row_offset=off).columns)

    def gen_c(ci):
        rows = min(chunk_rows, n_total - ci * chunk_rows)
        return Table(gen_chunk(jnp.uint64(ci * chunk_rows)), rows)

    return gen_c


def bench_build_sweep(n_build: int = 10_000_000, n_probe: int = 100_000_000,
                      payloads: int = 4, chunk_rows: int = 1 << 24,
                      verify: bool = True, hbm_bw: float | None = None,
                      log=print) -> dict:
    """Config 2: 10M x 100M, 4 payload cols, probe streamed in chunks."""
    if hbm_bw is None:
        hbm_bw = roofline.measure_hbm_bw(size_mb=256, iters=5)
    r_cap = next_pow2(n_build)
    R = Table(jax.jit(lambda: datagen.gen_relation_device(
        n_build, n_build, payloads, seed=1, capacity=r_cap).columns)(), n_build)
    # matches ~ 1 per probe row at these key domains; 1.25x slack
    out_cap = chunk_rows + chunk_rows // 4
    nchunks = (n_probe + chunk_rows - 1) // chunk_rows
    gen_c = _chunk_generator(chunk_rows, n_build, payloads, 2, n_probe)

    @jax.jit
    def join_chunk(r, s_cols, s_rows):
        out = hash_join(r, Table(s_cols, s_rows), out_cap)
        return out.num_rows, _consume(out)

    # compile + warm off the clock
    t0 = time.perf_counter()
    s0 = gen_c(0)
    jax.block_until_ready(join_chunk(R, s0.columns, s0.num_rows))
    compile_s = time.perf_counter() - t0
    del s0
    log(f"[build_sweep] compiled + warmed in {compile_s:.1f} s")

    # timed sweep: per-chunk (gen + join + consume), dispatched
    # back-to-back with one block at the end. On-device gen is ~2
    # streaming passes and is INCLUDED, slightly understating the join's
    # own rows/s. Chunk refs are dropped as soon as the join is
    # dispatched so at most two chunks' buffers overlap.
    t0 = time.perf_counter()
    counts, accs = [], []
    for ci in range(nchunks):
        sc = gen_c(ci)
        rows_c, acc_c = join_chunk(R, sc.columns, sc.num_rows)
        del sc
        counts.append(rows_c)
        accs.append(acc_c)
    jax.block_until_ready((counts, accs))
    elapsed = time.perf_counter() - t0
    chunk_counts = [int(c) for c in counts]
    total = sum(chunk_counts)

    report = {
        "config": "build_sweep_10m_100m",
        "n_build": n_build, "n_probe": n_probe, "payloads": payloads,
        "nchunks": nchunks, "chunk_rows": chunk_rows,
        "compile_s": compile_s,
        "elapsed_ms": elapsed * 1e3,
        "probe_rows_per_sec": n_probe / elapsed,
        "out_rows": total,
        "chunk_overflow": any(c > out_cap for c in chunk_counts),
        "hbm_bw_gbps": hbm_bw,
    }
    ncols = payloads + 1
    bm = roofline.hash_join_bytes(r_cap, ncols, nchunks * chunk_rows,
                                  ncols, nchunks * out_cap)
    sol_ms = sum(b.total for b in bm.values()) / hbm_bw / 1e6
    report["sol_ms"] = sol_ms
    report["roofline_pct"] = 100.0 * sol_ms / report["elapsed_ms"]

    if verify:
        from tpq.verify import join_count

        expected = join_count(datagen.uniform_keys(n_build, n_build, seed=1),
                              datagen.uniform_keys(n_probe, n_build, seed=2),
                              n_build)
        report["expected_rows"] = expected
        report["count_exact"] = (expected == total
                                 and not report["chunk_overflow"])
        assert report["count_exact"], (expected, total, chunk_counts, out_cap)
    log(report)
    return report


def bench_pipeline(n_dim: int = 1 << 20, n_fact: int = 100_000_000,
                   fact_payloads: int = 2, chunk_rows: int = 1 << 22,
                   filter_value: int = 1 << 19, verify: bool = True,
                   hbm_bw: float | None = None, log=print) -> dict:
    """Config 4: filter -> hash join -> hash aggregate over a 100M-row
    fact table, chunked:

      * the filter is PUSHED DOWN into the join (`probe_keep`, as in
        tpq/query.py's fusion);
      * per-chunk group tables land in a DENSE [n_state] accumulator:
        after `key < filter_value` every group key is in
        [0, filter_value), and a chunk's aggregate emits ascending
        unique keys, so PAD places them at their key slot and u32
        carry-chain adds fold them in — no re-aggregation sort ever
        sees more than one chunk.
    """
    from tpq.kernels.move import pad
    from tpq.ops.filter import compact
    from tpq.ops.hash_aggregate import hash_aggregate
    from tpq.ops.union_join import col_planes, planes_col

    if hbm_bw is None:
        hbm_bw = roofline.measure_hbm_bw(size_mb=256, iters=5)
    dim_cap = next_pow2(n_dim)
    dim = Table(jax.jit(lambda: datagen.gen_relation_device(
        n_dim, n_dim, 1, seed=1, capacity=dim_cap).columns)(), n_dim)
    # ~live_frac of fact rows survive the filter; ~1 match per surviving
    # row, 1.5x slack
    live_frac = min(1.0, filter_value / n_dim)
    out_cap = max(1 << 13, int(chunk_rows * live_frac * 3 // 2))
    r_names = [n for n in dim.names if n != "key"]
    gen_c = _chunk_generator(chunk_rows, n_dim, fact_payloads, 2, n_fact)

    n_state = next_pow2(min(filter_value, n_dim))
    vnames = (["count"] + [f"sum_r_{n}" for n in r_names]
              + [f"sum_s_p{j}" for j in range(fact_payloads)])
    nplanes = 2 * len(vnames)

    @jax.jit
    def chunk_step(dim, state, f_cols, f_rows):
        fact = Table(f_cols, f_rows)
        kc = fact.col("key")
        keep = kc < jnp.asarray(filter_value, kc.dtype)
        joined = hash_join(dim, fact, out_cap, probe_keep=keep)
        ok = joined.num_rows <= out_cap
        agg = hash_aggregate(joined.with_capacity(out_cap), key="key")
        planes = []
        for n in vnames:
            planes += list(col_planes(agg.col(n)))
        dest = jnp.clip(agg.col("key"), 0, n_state - 1).astype(I32)
        padded, _ = pad(planes, dest, agg.num_rows, n_state)
        new_state, carry = [], None
        for j, (a, b) in enumerate(zip(state, padded)):
            if j % 2 == 0:
                lo = a + b
                carry = (lo < a).astype(jnp.uint32)
                new_state.append(lo)
            else:
                new_state.append(a + b + carry)
        return new_state, ok

    @jax.jit
    def finalize(state):
        cols = {"key": jnp.arange(n_state, dtype=I64)}
        for j, n in enumerate(vnames):
            cols[n] = planes_col((state[2 * j], state[2 * j + 1]), I64)
        return compact(Table(cols, n_state), cols["count"] > 0)

    state0 = [jnp.zeros(n_state, jnp.uint32) for _ in range(nplanes)]
    nchunks = (n_fact + chunk_rows - 1) // chunk_rows

    t0 = time.perf_counter()
    f0 = gen_c(0)
    jax.block_until_ready(chunk_step(dim, state0, f0.columns, f0.num_rows))
    jax.block_until_ready(finalize(state0).num_rows)
    compile_s = time.perf_counter() - t0
    del f0
    log(f"[pipeline] compiled + warmed in {compile_s:.1f} s")

    t0 = time.perf_counter()
    state = state0
    oks = []
    for ci in range(nchunks):
        fc = gen_c(ci)
        state, ok = chunk_step(dim, state, fc.columns, fc.num_rows)
        del fc
        oks.append(ok)
    final = jax.block_until_ready(finalize(state))
    elapsed = time.perf_counter() - t0

    report = {
        "config": "pipeline_100m",
        "n_dim": n_dim, "n_fact": n_fact, "nchunks": nchunks,
        "compile_s": compile_s,
        "elapsed_ms": elapsed * 1e3,
        "fact_rows_per_sec": n_fact / elapsed,
        "groups": int(final.num_rows),
        "chunk_overflow": not all(bool(o) for o in oks),
        "hbm_bw_gbps": hbm_bw,
    }
    nf = fact_payloads + 1
    bm_filter = roofline.filter_bytes(nchunks * chunk_rows, nf).total
    bm_join = sum(b.total for b in roofline.hash_join_bytes(
        dim_cap, 2, nchunks * chunk_rows, nf, nchunks * out_cap).values())
    bm_agg = roofline.aggregate_bytes(nchunks * out_cap, 4).total
    sol_ms = (bm_filter + bm_join + bm_agg) / hbm_bw / 1e6
    report["sol_ms"] = sol_ms
    report["roofline_pct"] = 100.0 * sol_ms / report["elapsed_ms"]

    if verify:
        from tpq.verify import assert_groups_equal, pipeline_expected_groups

        assert not report["chunk_overflow"], "a chunk's join overflowed out_cap"
        expected = pipeline_expected_groups(n_dim, n_fact, fact_payloads,
                                            filter_value)
        assert_groups_equal(final.to_numpy(), expected)
        report["groups_exact"] = True
    log(report)
    return report


def main(argv=None):
    import argparse
    import json

    p = argparse.ArgumentParser()
    p.add_argument("which", choices=["sweep", "pipeline"])
    p.add_argument("--json-out", default=None)
    p.add_argument("--chunk-rows", type=int, default=None)
    p.add_argument("--no-verify", action="store_true")
    args = p.parse_args(argv)
    dev = require_gpu()
    if args.which == "sweep":
        rep = bench_build_sweep(chunk_rows=args.chunk_rows or 1 << 24,
                                verify=not args.no_verify)
    else:
        rep = bench_pipeline(chunk_rows=args.chunk_rows or 1 << 22,
                             verify=not args.no_verify)
    rep["device"] = dev
    print(json.dumps({"device": dev, "config": rep["config"]}))
    if args.json_out:
        with open(args.json_out, "w") as f:
            json.dump(rep, f, indent=2, default=str)
    return rep


if __name__ == "__main__":
    main()
