"""D3 overlap evidence (VERDICT r2 item 7; BASELINE.json:L5
"double-buffered pipelines").

Measures the chunked-exchange and ring-hop variants of the distributed
join against the monolithic dense exchange on whatever mesh is
available: the 8-device CPU sim proves the code paths (XLA:CPU runs
collectives synchronously, so no overlap shows there); on the cards of
one host the same entry measures the exchange/compute overlap. A
profiler trace with named phases can be captured via `trace_dir`.
"""

from __future__ import annotations

import jax

from tpq import datagen
from tpq.bench.device import device_info
from tpq.bench.timing import time_call
from tpq.dist.dist_join import DistTable, dist_hash_join


def _time_join(R, S, mesh, n: int, reps: int = 3, **kwargs) -> float:
    @jax.jit
    def step(rc, rn, sc, sn):
        out, ovf = dist_hash_join(DistTable(rc, rn), DistTable(sc, sn),
                                  mesh, **kwargs)
        return out.columns, out.shard_rows, ovf

    args = (R.columns, R.shard_rows, S.columns, S.shard_rows)
    sec, _, _ = time_call(step, args, warmup=1, iters=reps)
    return sec


def run_overlap_matrix(mesh, rows_per_shard: int = 1 << 14,
                       out_capacity_per_shard: int = 1 << 16,
                       trace_dir: str | None = None) -> list[dict]:
    """exchange/compute-overlap measurement matrix:
    dense n_chunks=1 (no overlap) vs n_chunks=4 (chunk-pipelined
    exchange, D3) vs ring (hop-pipelined, D2 rung 3)."""
    nchips = mesh.devices.size
    n = rows_per_shard * nchips
    r = datagen.gen_relation_np(n, n, payloads=1, seed=71)
    s = datagen.gen_relation_np(n, n, payloads=1, seed=72)
    R = DistTable.from_numpy(r, mesh)
    S = DistTable.from_numpy(s, mesh)

    variants = [
        ("dense_1chunk", dict(exchange_impl="dense", n_chunks=1)),
        ("dense_4chunks", dict(exchange_impl="dense", n_chunks=4)),
        ("ring_hops", dict(exchange_impl="ring")),
    ]
    rows = []
    base_ms = None
    for name, kw in variants:
        from contextlib import nullcontext

        ctx = (jax.profiler.trace(trace_dir) if trace_dir and name == "ring_hops"
               else nullcontext())
        with ctx:
            sec = _time_join(R, S, mesh, n,
                             out_capacity_per_shard=out_capacity_per_shard,
                             **kw)
        row = {"variant": name, "n_chips": nchips,
               "rows_total": 2 * n, "elapsed_ms": round(sec * 1e3, 3)}
        if base_ms is None:
            base_ms = row["elapsed_ms"]
        row["vs_dense_1chunk"] = round(row["elapsed_ms"] / base_ms, 3)
        rows.append(row)
    return rows


def main(argv=None):
    import argparse
    import json

    p = argparse.ArgumentParser()
    p.add_argument("--rows-per-shard", type=int, default=1 << 14)
    p.add_argument("--json-out", default=None)
    p.add_argument("--trace-dir", default=None)
    args = p.parse_args(argv)

    from tpq.dist import make_mesh

    mesh = make_mesh(len(jax.devices()))
    rows = run_overlap_matrix(mesh, rows_per_shard=args.rows_per_shard,
                              trace_dir=args.trace_dir)
    for row in rows:
        print(row)
    if args.json_out:
        with open(args.json_out, "w") as f:
            json.dump({"overlap_matrix": rows,
                       "device": device_info()}, f, indent=2)
    return rows


if __name__ == "__main__":
    main()
