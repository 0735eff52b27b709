"""Union-sort equi-join — the shared engine under C6 (hash_join) and
C7 (merge_join).

Every large row movement is a multi-operand sort or a scan; the only
gathers are the small ones of the tail and the fallback:

  1. UNION SORT — one stable multi-operand sort of the concatenated
     relations by (invalid, key, side), CARRYING all payload columns as
     32-bit planes. The sort applies the permutation to the data; no
     argsort+gather.
  2. RUN STRUCTURE — equal keys form runs; R rows precede S rows within
     a run (side is a sort key). Per-position scans give: run starts
     (neighbor compare), run-start index rs (cummax), and the number of
     R rows in each run m (cumsum + cummax base subtraction).
  3. INLINE EMISSION (matches with R-multiplicity <= dmax) — the d-th
     R row of a run sits at rs+d, so its payload equals a fill-forward
     over the union of `payload` shifted left by d and sampled at run
     starts. One `lax.associative_scan` with a select combiner fills
     all rounds/planes at once; candidate (S row, d) is valid iff
     d < m. No gather.
  4. TAIL (m > dmax, rare for realistic key distributions) — tail S
     rows are compacted into a small static buffer (sort by flag), then
     expanded with *small* gathers (cost scales with the tail capacity,
     not the relation).
  5. COMPACTION — one stable multi-operand sort by validity brings the
     true matches to the front of the static out_capacity buffer.
  6. FALLBACK — if the tail exceeds its static capacities (adversarial
     duplicate-heavy data, e.g. all-equal keys), a `lax.cond` routes the
     whole emission through the classic expand+gather path (slow but
     exact; only the taken branch executes).

Join semantics are oracle-exact (oracle/main.cc hash_join/merge_join):
inner equi-join on `key`, duplicates yield the full per-key cross
product, output columns key, r_<R payloads...>, s_<S payloads...>,
static out_capacity with overflow surfaced as num_rows > out_capacity
(SURVEY.md §7.4.3, §5.3).

No sentinel keys anywhere: padding is ordered by an explicit invalid
plane (leading sort key), so INT64_MIN/MAX are ordinary key values.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from tpq.columnar import Table
from tpq.ops._expand import barrier, exclusive_cumsum, expand_segments

I32 = jnp.int32
I64 = jnp.int64


# ---------------------------------------------------------------------------
# 32-bit plane packing (sorts and gathers move i64 columns as two u32
# planes)
# ---------------------------------------------------------------------------

def col_planes(col: jnp.ndarray) -> tuple[jnp.ndarray, ...]:
    """Column -> tuple of 32-bit planes (exact roundtrip via planes_col)."""
    if col.dtype == jnp.int64 or col.dtype == jnp.uint64:
        k = col.astype(jnp.uint64)
        lo = (k & jnp.uint64(0xFFFFFFFF)).astype(jnp.uint32)
        hi = (k >> jnp.uint64(32)).astype(jnp.uint32)
        return (lo, hi)
    if col.dtype in (jnp.int32, jnp.uint32):
        return (col,)
    if col.dtype == jnp.bool_:
        return (col.astype(jnp.uint32),)
    raise TypeError(f"unsupported column dtype {col.dtype}")


def planes_col(planes: tuple[jnp.ndarray, ...], dtype) -> jnp.ndarray:
    if dtype == jnp.int64 or dtype == jnp.uint64:
        lo, hi = planes
        return ((hi.astype(jnp.uint64) << jnp.uint64(32))
                | lo.astype(jnp.uint64)).astype(dtype)
    (p,) = planes
    if dtype == jnp.bool_:
        return p != 0
    return p.astype(dtype)


def fill_forward(sample_valid: jnp.ndarray, planes: list[jnp.ndarray]):
    """Per-plane fill-forward: position i gets plane values from the most
    recent j <= i with sample_valid[j]. Tiled scan (tpq/ops/scan.py)."""
    from tpq.ops.scan import fill_forward as _ff

    return _ff(sample_valid, planes)


# ---------------------------------------------------------------------------
# the join
# ---------------------------------------------------------------------------

def union_join(
    r: Table,
    s: Table,
    out_capacity: int,
    key: str = "key",
    dmax: int = 2,
    tail_rows_cap: int | None = None,
    tail_out_cap: int | None = None,
) -> Table:
    """Inner equi-join R ⋈ S on `key` (see module docstring)."""
    cr, cs = r.capacity, s.capacity
    u = cr + cs
    if tail_rows_cap is None:
        tail_rows_cap = max(1024, u >> 4)
    if tail_out_cap is None:
        tail_out_cap = max(2048, min(out_capacity, u >> 3))
    tail_rows_cap = min(tail_rows_cap, u)  # can't have more tail rows than S rows

    r_names = [n for n in r.names if n != key]
    s_names = [n for n in s.names if n != key]

    # ---- union sort: (invalid, key, side) keys, payload planes carried ----
    inv = jnp.concatenate([(~r.valid_mask()), (~s.valid_mask())]).astype(I32)
    k = jnp.concatenate([r.col(key), s.col(key)])
    side = jnp.concatenate([jnp.zeros(cr, I32), jnp.ones(cs, I32)])

    zr = jnp.zeros(cr, jnp.uint32)
    zs = jnp.zeros(cs, jnp.uint32)
    val_ops: list[jnp.ndarray] = []
    r_slices: dict[str, slice] = {}
    s_slices: dict[str, slice] = {}
    for n in r_names:
        ps = col_planes(r.col(n))
        r_slices[n] = slice(len(val_ops), len(val_ops) + len(ps))
        val_ops += [jnp.concatenate([p, zs]) for p in ps]
    for n in s_names:
        ps = col_planes(s.col(n))
        s_slices[n] = slice(len(val_ops), len(val_ops) + len(ps))
        val_ops += [jnp.concatenate([zr, p]) for p in ps]

    ops = jax.lax.optimization_barrier((inv, k, side, *val_ops))
    with jax.named_scope("union_sort"):
        sorted_ops = jax.lax.sort(ops, num_keys=3, is_stable=True)
    inv_s, k_s, side_s = sorted_ops[0], sorted_ops[1], sorted_ops[2]
    vals_s = list(sorted_ops[3:])
    inv_s, k_s, side_s = barrier((inv_s, k_s, side_s))

    valid = inv_s == 0
    is_r = (side_s == 0) & valid
    is_s = (side_s == 1) & valid

    # ---- run structure (all scans, no gathers) ----
    from tpq.ops.scan import cummax_i32, cumsum_i32

    i = jnp.arange(u, dtype=I32)
    nr = jnp.concatenate([jnp.ones(1, bool), k_s[1:] != k_s[:-1]]) | (~valid)
    cr_ex = cumsum_i32(is_r.astype(I32)) - is_r.astype(I32)
    base = cummax_i32(jnp.where(nr, cr_ex, -1))
    m = cr_ex - base                      # R rows before position i in its run
    rs = cummax_i32(jnp.where(nr, i, -1))
    m_s = jnp.where(is_s, m, 0)           # per-S-row match count

    total64 = jnp.sum(m_s.astype(I64))
    total = jnp.minimum(total64, jnp.int64(2**31 - 1)).astype(I32)
    covered = jnp.sum(jnp.minimum(m_s, dmax).astype(I64))
    tail_rows = jnp.sum((m_s > dmax).astype(I32))
    tail_out64 = total64 - covered
    small_ok = (tail_rows <= tail_rows_cap) & (tail_out64 <= tail_out_cap)

    kp = barrier(col_planes(k_s))  # 1 plane (i32 keys) or 2 (i64)
    r_plane_idx = [pi for n in r_names for pi in range(r_slices[n].start, r_slices[n].stop)]
    s_plane_idx = [pi for n in s_names for pi in range(s_slices[n].start, s_slices[n].stop)]

    out_names = ([key]
                 + [f"r_{n}" for n in r_names]
                 + [f"s_{n}" for n in s_names])
    out_dtypes = ([k.dtype]
                  + [r.col(n).dtype for n in r_names]
                  + [s.col(n).dtype for n in s_names])

    def _make_table(named_planes: dict[str, tuple[jnp.ndarray, ...]], num_rows) -> Table:
        cols = {}
        for n, dt in zip(out_names, out_dtypes):
            cols[n] = planes_col(named_planes[n], dt)
        return Table(cols, num_rows)

    # ---- inline path: dmax fill-forward rounds + small tail ----
    def inline_path(_):
        # fill-forward all rounds in ONE scan: samples at run starts of the
        # R payload planes shifted left by d give "payload of the d-th R row
        # of my run" at every later position of the run.
        shifted: list[jnp.ndarray] = []
        for d in range(dmax):
            for pi in r_plane_idx:
                shifted.append(jnp.roll(vals_s[pi], -d) if d else vals_s[pi])
        filled = fill_forward(nr, shifted) if shifted else []
        nrp = len(r_plane_idx)

        cand_valid = [is_s & (m > d) for d in range(dmax)]

        # ---- small tail: S rows with m > dmax, compacted then expanded ----
        def tail(_):
            flag = jnp.where(is_s & (m > dmax), 0, 1).astype(I32)
            flag = barrier(flag)
            _, idx_t_full = jax.lax.sort((flag, i), num_keys=1, is_stable=True)
            idx_t = idx_t_full[:tail_rows_cap]
            t_valid = jnp.arange(tail_rows_cap, dtype=I32) < tail_rows
            m_t = m[idx_t]
            rs_t = rs[idx_t]
            counts_t = jnp.where(t_valid, m_t - dmax, 0)
            seg, rank, _, vout = expand_segments(counts_t, tail_out_cap)
            r_pos = jnp.minimum(rs_t[seg] + dmax + rank, u - 1)
            tp: dict[str, tuple[jnp.ndarray, ...]] = {}
            tp[key] = tuple(p[idx_t][seg] for p in kp)
            for n in r_names:
                sl = r_slices[n]
                tp[f"r_{n}"] = tuple(vals_s[pi][r_pos] for pi in range(sl.start, sl.stop))
            for n in s_names:
                sl = s_slices[n]
                tp[f"s_{n}"] = tuple(vals_s[pi][idx_t][seg] for pi in range(sl.start, sl.stop))
            return vout, tp

        def no_tail(_):
            # Under shard_map, cond branches must agree on varying-axis types;
            # derive the zeros from a shard-varying input so this branch
            # matches `tail` (which reads the sorted shard data).
            vz = (side_s[0] * 0).astype(jnp.uint32)
            z = jnp.zeros(tail_out_cap, jnp.uint32) + vz
            tp = {n: tuple(z for _ in col_planes(jnp.zeros(1, dt)))
                  for n, dt in zip(out_names, out_dtypes)}
            return z != 0, tp

        t_vout, t_planes = jax.lax.cond(tail_out64 > 0, tail, no_tail, operand=None)

        # ---- assemble candidates: dmax*U inline + tail_out_cap ----
        valid_all = jnp.concatenate(cand_valid + [t_vout])
        planes_all: dict[str, jnp.ndarray | tuple] = {}
        planes_all[key] = tuple(
            jnp.concatenate([p] * dmax + [t_planes[key][j]])
            for j, p in enumerate(kp))
        for ni, n in enumerate(r_names):
            sl = r_slices[n]
            nplanes = sl.stop - sl.start
            offs = sum(r_slices[nn].stop - r_slices[nn].start for nn in r_names[:ni])
            planes_all[f"r_{n}"] = tuple(
                jnp.concatenate([filled[d * nrp + offs + j] for d in range(dmax)]
                                + [t_planes[f"r_{n}"][j]])
                for j in range(nplanes))
        for n in s_names:
            sl = s_slices[n]
            planes_all[f"s_{n}"] = tuple(
                jnp.concatenate([vals_s[pi]] * dmax + [t_planes[f"s_{n}"][pi - sl.start]])
                for pi in range(sl.start, sl.stop))

        # ---- compact: one stable sort by validity ----
        length = dmax * u + tail_out_cap
        if length < out_capacity:
            pad = out_capacity - length
            valid_all = jnp.concatenate([valid_all, jnp.zeros(pad, bool)])
            planes_all = {n: tuple(jnp.concatenate([p, jnp.zeros(pad, p.dtype)])
                                   for p in ps)
                          for n, ps in planes_all.items()}
        sortkey = barrier(jnp.where(valid_all, 0, 1).astype(I32))
        flat, layout = [], []
        for n in out_names:
            ps = planes_all[n]
            layout.append((n, len(ps)))
            flat += list(ps)
        with jax.named_scope("compact_sort"):
            res = jax.lax.sort((sortkey, *flat), num_keys=1, is_stable=True)
        outp, pos = {}, 1
        for n, cnt in layout:
            outp[n] = tuple(res[pos + j][:out_capacity] for j in range(cnt))
            pos += cnt
        # zero the padding region (rows >= total) for determinism
        live = jnp.arange(out_capacity, dtype=I32) < jnp.minimum(total, out_capacity)
        outp = {n: tuple(jnp.where(live, p, 0) for p in ps) for n, ps in outp.items()}
        return _make_table(outp, total)

    # ---- fallback path: full expand + gather (adversarial duplicates) ----
    def fallback_path(_):
        seg, rank, _, vout = expand_segments(m_s, out_capacity)
        r_pos = jnp.minimum(rs[seg] + rank, u - 1)
        outp: dict[str, tuple[jnp.ndarray, ...]] = {}
        outp[key] = tuple(jnp.where(vout, p[seg], 0) for p in kp)
        for n in r_names:
            sl = r_slices[n]
            outp[f"r_{n}"] = tuple(jnp.where(vout, vals_s[pi][r_pos], 0)
                                   for pi in range(sl.start, sl.stop))
        for n in s_names:
            sl = s_slices[n]
            outp[f"s_{n}"] = tuple(jnp.where(vout, vals_s[pi][seg], 0)
                                   for pi in range(sl.start, sl.stop))
        return _make_table(outp, total)

    return jax.lax.cond(small_ok, inline_path, fallback_path, operand=None)
