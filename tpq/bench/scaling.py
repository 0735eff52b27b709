"""Weak-scaling harness (SURVEY.md §2.2 D5; BASELINE.json:L5 ">=70%
weak-scaling efficiency at N>=2 hosts", L11 config 5).

Runs the distributed hash join over meshes of 1..N chips with the
per-chip row count held fixed (weak scaling), and reports rows/s/chip
plus efficiency relative to N=1. The mesh is whatever `jax.devices()`
holds: the cards of one host, or every host after
`tpq.dist.multihost.init` — mesh size is the only difference.
"""

from __future__ import annotations

import numpy as np

import jax

from tpq import datagen
from tpq.bench.timing import time_call
from tpq.columnar import next_pow2
from tpq.dist.dist_join import DistTable, dist_hash_join
from tpq.dist.mesh import make_mesh


def run_weak_scaling(rows_per_chip: int = 1 << 16,
                     mesh_sizes: tuple[int, ...] = (1, 2, 4, 8),
                     payloads: int = 1,
                     exchange_impl: str = "dense",
                     algo: str = "hash",
                     n_chunks: int = 1,
                     seed: int = 77) -> list[dict]:
    """Returns one record per mesh size:
    {n_chips, rows_total, elapsed_ms, rows_per_sec_per_chip, efficiency}."""
    avail = len(jax.devices())
    rows = []
    base_rate = None
    for n in mesh_sizes:
        if n > avail:
            continue
        mesh = make_mesh(n)
        total = rows_per_chip * n
        r = datagen.gen_relation_np(total, max(64, total), payloads=payloads,
                                    seed=seed)
        s = datagen.gen_relation_np(total, max(64, total), payloads=payloads,
                                    seed=seed + 1)
        R = DistTable.from_numpy(r, mesh)
        S = DistTable.from_numpy(s, mesh)
        out_cap = next_pow2(max(256, 4 * rows_per_chip))
        if out_cap % max(1, n_chunks):
            out_cap = next_pow2(out_cap * n_chunks)

        def fn(Rc, Rn, Sc, Sn):
            out, ovf = dist_hash_join(
                DistTable(Rc, Rn), DistTable(Sc, Sn), mesh,
                out_capacity_per_shard=out_cap, algo=algo,
                exchange_impl=exchange_impl, n_chunks=n_chunks)
            return out.columns, out.shard_rows, ovf

        jfn = jax.jit(fn)
        args = (R.columns, R.shard_rows, S.columns, S.shard_rows)
        _, _, ovf = jfn(*args)  # compile + overflow check
        assert int(np.asarray(ovf).sum()) == 0, "scaling bench overflowed"
        sec, _, _ = time_call(jfn, args, warmup=1, iters=5)
        rate_per_chip = total / sec / n
        if base_rate is None:
            base_rate = rate_per_chip
        rows.append({
            "n_chips": n,
            "rows_total": total,
            "elapsed_ms": sec * 1e3,
            "rows_per_sec_per_chip": rate_per_chip,
            "efficiency": rate_per_chip / base_rate,
            "exchange_impl": exchange_impl,
            "n_chunks": n_chunks,
        })
    return rows
