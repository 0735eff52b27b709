"""D5 — end-to-end distributed hash join (SURVEY.md §2.2 D5, §3.3;
BASELINE.json:L11 config 5).

partition-by-owner -> (skew split, D4) -> shuffle exchange (D2, chunked
for overlap, D3) -> local join (C6), the whole body one shard_map over
the mesh. Results stay row-sharded (left on the producing chip); tests
gather and canonicalize.

DistTable is the sharded twin of Table: columns are globally-shaped
arrays sharded P('x') on the row axis, plus a per-shard row-count vector
(also P('x')) standing in for the scalar num_rows.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache, partial

import jax
import jax.numpy as jnp
import numpy as np
from jax import shard_map
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from tpq.columnar import Table, next_pow2
from tpq.dist.exchange import exchange, ring_hops
from tpq.dist.mesh import AXIS, owner_of
from tpq.dist.overlap import chunk_table, concat_tables
from tpq.dist.skew import detect_heavy_keys, is_key_in, replicate_rows
from tpq.ops import hash_join, merge_join
from tpq.ops.filter import compact
from tpq.ops.merge_join import I64_MAX


@dataclass(frozen=True)
class SkewConfig:
    """D4 knobs: candidate nomination width, global heaviness threshold
    (rows across both sides), replica capacity per shard."""

    candidates_per_shard: int = 16
    threshold: int = 1 << 12
    replica_capacity_per_shard: int = 1 << 12


@dataclass
class DistTable:
    """Row-sharded table: each of nchips shards owns local_capacity rows."""

    columns: dict[str, jax.Array]  # global shape [nchips * local_capacity]
    shard_rows: jax.Array  # int32[nchips] — live rows per shard

    @property
    def nshards(self) -> int:
        return self.shard_rows.shape[0]

    @property
    def local_capacity(self) -> int:
        return next(iter(self.columns.values())).shape[0] // self.nshards

    @classmethod
    def from_numpy(cls, cols: dict[str, np.ndarray], mesh: Mesh,
                   local_capacity: int | None = None) -> "DistTable":
        nchips = mesh.devices.size
        n = len(next(iter(cols.values())))
        per = (n + nchips - 1) // nchips
        local_cap = local_capacity or next_pow2(per)
        sharding = NamedSharding(mesh, P(AXIS))
        out, counts = {}, []
        for i in range(nchips):
            counts.append(max(0, min(per, n - i * per)))
        for name, c in cols.items():
            buf = np.zeros(nchips * local_cap, dtype=c.dtype)
            for i in range(nchips):
                buf[i * local_cap:i * local_cap + counts[i]] = c[i * per:i * per + counts[i]]
            out[name] = jax.device_put(buf, sharding)
        shard_rows = jax.device_put(np.asarray(counts, np.int32), sharding)
        return cls(out, shard_rows)

    def to_numpy(self) -> dict[str, np.ndarray]:
        """Gather + concatenate live rows of every shard (test/debug path)."""
        counts = np.asarray(self.shard_rows)
        local_cap = self.local_capacity
        out = {}
        for name, c in self.columns.items():
            c = np.asarray(c)
            out[name] = np.concatenate(
                [c[i * local_cap:i * local_cap + counts[i]] for i in range(len(counts))])
        return out


def _local_join(algo: str, r: Table, s: Table, cap: int, key: str) -> Table:
    if algo == "hash":
        return hash_join(r, s, cap, key=key)
    return merge_join(r, s, cap, key=key)


def dist_hash_join(
    r: DistTable,
    s: DistTable,
    mesh: Mesh,
    out_capacity_per_shard: int,
    exchange_capacity: int | None = None,
    algo: str = "hash",
    exchange_impl: str = "dense",
    key: str = "key",
    skew: SkewConfig | None = None,
    n_chunks: int = 1,
) -> tuple[DistTable, jax.Array]:
    """Distributed inner equi-join. Returns (row-sharded result,
    overflow counts int32[nchips] — nonzero means a shard's exchange
    bucket, skew replica, or join output overflowed and capacities must
    be renegotiated (SURVEY.md §5.3))."""
    nchips = mesh.devices.size
    ex_cap = exchange_capacity or max(128, next_pow2(2 * r.local_capacity // max(1, nchips) * 2))
    assert out_capacity_per_shard % n_chunks == 0
    program = _dist_join_program(mesh, tuple(r.columns), tuple(s.columns),
                                 out_capacity_per_shard, ex_cap, algo,
                                 exchange_impl, key, skew, n_chunks)
    out_cols, out_counts, overflow = program(
        r.columns, r.shard_rows, s.columns, s.shard_rows)
    return DistTable(out_cols, out_counts), overflow


@lru_cache(maxsize=16)
def _dist_join_program(mesh: Mesh, r_names: tuple, s_names: tuple,
                       out_capacity_per_shard: int, ex_cap: int, algo: str,
                       exchange_impl: str, key: str, skew: SkewConfig | None,
                       n_chunks: int):
    """The jitted shard_map body of dist_hash_join, one per static
    configuration (an eager shard_map would dispatch it op by op, and a
    fresh jit per call would retrace it every time)."""
    nchips = mesh.devices.size
    r_spec = {n: P(AXIS) for n in r_names}
    s_spec = {n: P(AXIS) for n in s_names}
    out_names = [key] + [f"r_{n}" for n in r_names if n != key] \
        + [f"s_{n}" for n in s_names if n != key]
    out_spec = {n: P(AXIS) for n in out_names}

    @partial(
        shard_map,
        mesh=mesh,
        in_specs=(r_spec, P(AXIS), s_spec, P(AXIS)),
        out_specs=(out_spec, P(AXIS), P(AXIS)),
    )
    def body(r_cols, r_n, s_cols, s_n):
        R = Table(r_cols, r_n[0])
        S = Table(s_cols, s_n[0])
        overflow = jnp.int32(0)

        r_heavy = jnp.zeros(R.capacity, bool)
        s_heavy = jnp.zeros(S.capacity, bool)
        heavy_out = None
        if skew is not None:
            rk = jnp.sort(jnp.where(R.valid_mask(), R.col(key), I64_MAX))
            sk = jnp.sort(jnp.where(S.valid_mask(), S.col(key), I64_MAX))
            heavy_keys, _ = detect_heavy_keys(
                rk, R.num_rows, sk, S.num_rows, AXIS,
                skew.candidates_per_shard, skew.threshold)
            r_heavy = is_key_in(R.col(key), heavy_keys) & R.valid_mask()
            s_heavy = is_key_in(S.col(key), heavy_keys) & S.valid_mask()
            # heavy build rows -> replicated everywhere; heavy probe rows
            # stay local; the pair is emitted on the probe row's home chip.
            R_rep, rep_ovf = replicate_rows(R, r_heavy, AXIS,
                                            skew.replica_capacity_per_shard)
            S_local_heavy = compact(S, s_heavy)
            heavy_out = _local_join(algo, R_rep, S_local_heavy,
                                    out_capacity_per_shard, key)
            overflow += rep_ovf + (heavy_out.num_rows > out_capacity_per_shard).astype(jnp.int32)

        # light path: hash exchange (heavy rows diverted out of the buckets)
        dest_r = jnp.where(r_heavy, nchips, owner_of(R.col(key), nchips))
        dest_s = jnp.where(s_heavy, nchips, owner_of(S.col(key), nchips))
        R2, r_ovf = exchange(R, dest_r, AXIS, nchips, ex_cap,
                             impl="dense" if exchange_impl == "ring" else exchange_impl)
        overflow += r_ovf

        outs = []
        if exchange_impl == "ring":
            # Hop-pipelined ring (D3 proper): S arrives one ring hop at a
            # time; hop t's ppermute is independent of hop t-1's local
            # join, so XLA's async collectives overlap wire and probe.
            hop_cap = next_pow2(max(128, 2 * out_capacity_per_shard // nchips))
            dc = jnp.where(S.valid_mask(), dest_s, nchips)
            for S2, hop_ovf in ring_hops(S, dc, AXIS, nchips, ex_cap):
                overflow += hop_ovf
                out_c = _local_join(algo, R2, S2, hop_cap, key)
                overflow += (out_c.num_rows > out_c.capacity).astype(jnp.int32)
                out_c = Table(out_c.columns, jnp.minimum(out_c.num_rows, out_c.capacity))
                outs.append(out_c)
        else:
            chunk_cap = out_capacity_per_shard // n_chunks
            s_chunks = chunk_table(S, n_chunks) if n_chunks > 1 else [S]
            dest_chunks = chunk_table(Table({"d": dest_s}, S.num_rows), n_chunks) \
                if n_chunks > 1 else [Table({"d": dest_s}, S.num_rows)]
            for Sc, Dc in zip(s_chunks, dest_chunks):
                # chunked exchanges are mutually independent: XLA overlaps
                # chunk i+1's all-to-all with chunk i's probe (D3).
                dc = jnp.where(jnp.arange(Sc.capacity) < Sc.num_rows, Dc.col("d"), nchips)
                S2, s_ovf = exchange(Sc, dc, AXIS, nchips, ex_cap, impl=exchange_impl)
                overflow += s_ovf
                out_c = _local_join(
                    algo, R2, S2,
                    chunk_cap if n_chunks > 1 else out_capacity_per_shard, key)
                overflow += (out_c.num_rows > out_c.capacity).astype(jnp.int32)
                out_c = Table(out_c.columns, jnp.minimum(out_c.num_rows, out_c.capacity))
                outs.append(out_c)

        if heavy_out is not None:
            heavy_out = Table(heavy_out.columns,
                              jnp.minimum(heavy_out.num_rows, out_capacity_per_shard))
            outs.append(heavy_out)
        merged, valid = concat_tables(outs)
        # compact against the slot mask, not merged.num_rows: valid rows are
        # scattered per-chunk, so valid_mask() (a prefix mask) must not apply
        out = compact(Table(merged.columns, merged.capacity), valid)
        # overflow MUST be read off the pre-clamp row count: with_capacity
        # clamps num_rows, which made this check a tautology and silently
        # dropped rows (round-2 MULTICHIP failure; SURVEY.md §5.3 contract:
        # overflow visible as num_rows > capacity)
        out_overflow = (out.num_rows > out_capacity_per_shard).astype(jnp.int32)
        out = out.with_capacity(out_capacity_per_shard)
        n_out = jnp.minimum(out.num_rows, out_capacity_per_shard)[None]
        return dict(out.columns), n_out.astype(jnp.int32), (overflow + out_overflow)[None]

    return jax.jit(body)


def plan_dist_capacities(
    r: DistTable,
    s: DistTable,
    mesh: Mesh,
    key: str = "key",
    safety: float = 1.25,
) -> tuple[int, int]:
    """Exact capacity planning for the distributed join (SURVEY §5.3;
    VERDICT r2 item 9: size ex_cap/out_cap from the histogram the engine
    already computes, not from the local_capacity guess).

    Two cheap jitted passes over KEYS ONLY:
      1. per-(sender, destination) row counts via `radix_histogram` (C3)
         -> exchange bucket capacity =
         max over senders+destinations;
      2. a keys-only exchange at that capacity, then the exact per-owner
         join cardinality sum_k cnt_R(k)*cnt_S(k) (sorted counts, no
         scatter) -> output capacity per shard.
    Returns (exchange_capacity, out_capacity_per_shard), each padded by
    `safety` and rounded to a power of two. Renegotiation remains the
    backstop; with exact planning it should never fire."""
    from tpq.kernels.radix_partition import radix_histogram
    from tpq.dist.skew import _count_keys_in

    nchips = mesh.devices.size

    @partial(shard_map, mesh=mesh,
             in_specs=(P(AXIS), P(AXIS), P(AXIS), P(AXIS)),
             out_specs=P(AXIS))
    def count_pass(rk, r_n, sk, s_n):
        out = []
        for k, n in ((rk, r_n), (sk, s_n)):
            valid = jnp.arange(k.shape[0], dtype=jnp.int32) < n[0]
            dest = jnp.where(valid, owner_of(k, nchips), nchips)
            # histogram over nchips+1 slots; the sentinel slot absorbs padding
            hist = radix_histogram(dest, nchips + 1)
            out.append(jnp.max(hist[:nchips]))
        m = jnp.maximum(out[0], out[1])
        return jax.lax.pmax(m, AXIS)[None]

    per_bucket = int(np.asarray(jax.jit(count_pass)(
        r.columns[key], r.shard_rows, s.columns[key], s.shard_rows))[0])
    ex_cap = next_pow2(max(128, int(per_bucket * safety)))

    @partial(shard_map, mesh=mesh,
             in_specs=(P(AXIS), P(AXIS), P(AXIS), P(AXIS)),
             out_specs=P(AXIS))
    def cardinality_pass(rk, r_n, sk, s_n):
        from tpq.ops.merge_join import I64_MAX

        def keys_to_me(k, n):
            t = Table({key: k}, n[0])
            dest = jnp.where(t.valid_mask(), owner_of(k, nchips), nchips)
            recv, ovf = exchange(t, dest, AXIS, nchips, ex_cap, impl="dense")
            return recv, ovf

        R2, r_ovf = keys_to_me(rk, r_n)
        S2, s_ovf = keys_to_me(sk, s_n)
        rk2 = jnp.sort(jnp.where(R2.valid_mask(), R2.col(key), I64_MAX))
        sk2 = jnp.sort(jnp.where(S2.valid_mask(), S2.col(key), I64_MAX))
        cnt_s = _count_keys_in(sk2, S2.num_rows, rk2)
        live = jnp.arange(rk2.shape[0], dtype=jnp.int32) < R2.num_rows
        total = jnp.sum(jnp.where(live, cnt_s, 0).astype(jnp.int64))
        total = jnp.maximum(total, (r_ovf + s_ovf).astype(jnp.int64))
        return jax.lax.pmax(total, AXIS)[None]

    per_out = int(np.asarray(jax.jit(cardinality_pass)(
        r.columns[key], r.shard_rows, s.columns[key], s.shard_rows))[0])
    out_cap = next_pow2(max(256, int(per_out * safety)))
    return ex_cap, out_cap


def dist_hash_join_planned(
    r: DistTable,
    s: DistTable,
    mesh: Mesh,
    key: str = "key",
    **kwargs,
) -> tuple[DistTable, jax.Array]:
    """Distributed join with capacities planned exactly from the data
    (plan_dist_capacities) instead of caller-supplied guesses."""
    ex_cap, out_cap = plan_dist_capacities(r, s, mesh, key=key)
    return dist_hash_join(r, s, mesh, out_capacity_per_shard=out_cap,
                          exchange_capacity=ex_cap, key=key, **kwargs)


def dist_hash_join_renegotiated(
    r: DistTable,
    s: DistTable,
    mesh: Mesh,
    out_capacity_per_shard: int,
    exchange_capacity: int | None = None,
    max_retries: int = 6,
    **kwargs,
) -> tuple[DistTable, int]:
    """Distributed join under the §5.3 renegotiation contract (VERDICT r2
    item 1/9): run, read the psum'd overflow scalar back, and if any
    shard's exchange bucket / replica buffer / join output overflowed,
    re-run with every static capacity doubled. Overflow is a COUNT of
    violated capacities, not a size, so growth is geometric; each retry
    costs one extra compile of the shard_map body. Returns
    (result, retries_used)."""
    out_cap = out_capacity_per_shard
    ex_cap = exchange_capacity
    skew = kwargs.get("skew")
    for attempt in range(max_retries + 1):
        out, overflow = dist_hash_join(
            r, s, mesh, out_capacity_per_shard=out_cap,
            exchange_capacity=ex_cap, **kwargs)
        if int(np.asarray(overflow).sum()) == 0:
            return out, attempt
        out_cap *= 2
        if ex_cap is not None:
            ex_cap *= 2
        if skew is not None:
            kwargs["skew"] = skew = SkewConfig(
                candidates_per_shard=skew.candidates_per_shard,
                threshold=skew.threshold,
                replica_capacity_per_shard=2 * skew.replica_capacity_per_shard)
    raise RuntimeError(
        f"distributed renegotiation failed after {max_retries} retries "
        f"(last out_capacity_per_shard {out_cap // 2})")
