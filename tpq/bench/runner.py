"""B1 — config-driven benchmark runner (SURVEY.md §2.4 B1, §3.4).

Runs the BASELINE.json:L6-L12 named presets (tpq/config.py): generates
seed-stable relations, compiles the operator (or the fused config-4
pipeline) ahead of time, times warmup+iters calls that each end in
block_until_ready, accounts each run against the copy rate measured in
the same process (B2), and emits structured records (B6) + md/json
report (B3). Every report names the device it ran on.

CLI:  python -m tpq.bench.runner --config=single_chip_1m [--algo=...]
      [--iters=N] [--trace-dir=...] [--json-out=...] [--check]
"""

from __future__ import annotations

import time

import jax

from tpq import Table
from tpq import datagen
from tpq.bench import roofline
from tpq.bench.device import device_info, require_gpu
from tpq.bench.report import emit_json, markdown_table
from tpq.bench.timing import time_call
from tpq.config import PRESETS, BenchConfig, RelationSpec
from tpq.log import GLOBAL_LOG
from tpq.ops import hash_join, merge_join
from tpq.query import jit_pipeline
from tpq.trace import annotate, trace_if

# Uniform relations are generated on the device (byte-identical to the
# host stream over the live rows); only Zipf keys come from the host.
_gen_uniform_device = jax.jit(datagen.gen_relation_device,
                              static_argnames=("rows", "nkeys", "payloads", "seed"))


def gen(spec: RelationSpec) -> Table:
    if spec.kind == "uniform":
        return _gen_uniform_device(rows=spec.rows, nkeys=spec.nkeys,
                                   payloads=spec.payloads, seed=spec.seed)
    return datagen.gen_relation(spec.rows, spec.nkeys, spec.payloads, spec.seed,
                                spec.kind, spec.theta)


def out_capacity_for(cfg: BenchConfig) -> int:
    from tpq.columnar import next_pow2

    base = max(cfg.r.rows, cfg.s.rows)
    return next_pow2(int(base * cfg.join.out_capacity_factor))


def memory_stats(compiled) -> dict | None:
    """Byte sizes from `compiled.memory_analysis()` (None where the
    backend reports none)."""
    m = compiled.memory_analysis()
    if m is None:
        return None
    return {k: int(getattr(m, k)) for k in (
        "argument_size_in_bytes", "output_size_in_bytes",
        "temp_size_in_bytes", "alias_size_in_bytes",
        "generated_code_size_in_bytes") if hasattr(m, k)}


def _quiet(_msg: str) -> None:
    pass


def run_config(cfg: BenchConfig, hbm_bw: float | None = None,
               trace_dir: str | None = None, log=_quiet) -> tuple[dict, Table]:
    """Compile, time and account one preset. Returns (report, the last
    call's output Table). `log` receives progress lines, the compiled
    program's memory analysis first of all."""
    if hbm_bw is None:
        hbm_bw = roofline.measure_hbm_bw(size_mb=256, iters=5)
    r, s = gen(cfg.r), gen(cfg.s)
    jax.block_until_ready((r.columns, s.columns))
    out_cap = out_capacity_for(cfg)

    if cfg.pipeline:
        fn = jit_pipeline(out_cap, algo=cfg.join.algo)
        args = (r, s, cfg.filter_value)
        op = "pipeline"
        bytes_model = (
            roofline.filter_bytes(s.capacity, len(s.columns)).total
            + sum(b.total for b in roofline.hash_join_bytes(
                r.capacity, len(r.columns), s.capacity, len(s.columns), out_cap).values())
            + roofline.aggregate_bytes(out_cap, 2 + (len(r.columns) - 1) + (len(s.columns) - 1)).total
        )
    else:
        join = hash_join if cfg.join.algo == "hash" else merge_join
        model = (roofline.hash_join_bytes if cfg.join.algo == "hash"
                 else roofline.merge_join_bytes)
        fn = jax.jit(lambda r_, s_: join(r_, s_, out_cap))
        args = (r, s)
        op = f"join_{cfg.join.algo}"
        bytes_model = sum(b.total for b in model(
            r.capacity, len(r.columns), s.capacity, len(s.columns), out_cap).values())

    t0 = time.perf_counter()
    compiled = fn.lower(*args).compile()
    compile_s = time.perf_counter() - t0
    mem = memory_stats(compiled)
    log(f"[{cfg.name}] {op}: compiled in {compile_s:.1f} s; "
        f"memory_analysis {mem}")

    with trace_if(trace_dir), annotate(op):
        dt, samples, out = time_call(compiled, args, cfg.warmup, cfg.iters)
    res = roofline.RooflineResult(op, dt, bytes_model, hbm_bw, cfg.s.rows)
    rec = res.row()
    GLOBAL_LOG.emit(config=cfg.name, **rec)
    report = {
        "config": cfg.name,
        "device": device_info(),
        "hbm_bw_gbps": hbm_bw,
        "out_capacity": out_cap,
        "out_rows": int(out.num_rows),
        "compile_s": compile_s,
        "memory": mem,
        "elapsed_ms_samples": [t * 1e3 for t in samples],
        "ops": [rec],
    }
    return report, out


def main(argv=None):
    import argparse

    p = argparse.ArgumentParser()
    p.add_argument("--config", default="single_chip_1m", choices=sorted(PRESETS))
    p.add_argument("--algo", default=None, choices=[None, "hash", "merge"])
    p.add_argument("--iters", type=int, default=None)
    p.add_argument("--trace-dir", default=None)
    p.add_argument("--json-out", default=None)
    p.add_argument("--log-jsonl", default=None)
    p.add_argument("--scaling", default=None, metavar="N1,N2,...",
                   help="weak-scaling mode: run dist_hash_join at these mesh "
                        "sizes (per-chip rows fixed) and print rows/s/chip + "
                        "efficiency; other config flags are ignored")
    p.add_argument("--rows-per-chip", type=int, default=1 << 16)
    p.add_argument("--exchange", default="dense",
                   choices=["dense", "ring"])
    p.add_argument("--n-chunks", type=int, default=1)
    p.add_argument("--check", default=None, metavar="BASELINE_JSON",
                   help="perf-regression mode (SURVEY.md §4.5): compare "
                        "rows_per_sec per op against a stored report; exit 1 "
                        "on regression beyond --tolerance")
    p.add_argument("--tolerance", type=float, default=0.25,
                   help="allowed fractional slowdown in --check mode")
    args = p.parse_args(argv)

    dev = require_gpu()
    if args.scaling:
        from tpq.bench.scaling import run_weak_scaling
        from tpq.dist import multihost

        multihost.init()  # no-op single-process; wires a cluster if env set
        sizes = tuple(int(x) for x in args.scaling.split(","))
        rows = run_weak_scaling(rows_per_chip=args.rows_per_chip,
                                mesh_sizes=sizes,
                                exchange_impl=args.exchange,
                                n_chunks=args.n_chunks)
        print(f"# weak scaling on {dev}")
        print(markdown_table(rows, ["n_chips", "rows_total", "elapsed_ms",
                                    "rows_per_sec_per_chip", "efficiency"]))
        if args.json_out:
            emit_json(args.json_out, {"device": dev, "scaling": rows})
        return {"device": dev, "scaling": rows}

    cfg = PRESETS[args.config]
    from dataclasses import replace

    if args.algo:
        cfg = replace(cfg, join=replace(cfg.join, algo=args.algo))
    if args.iters:
        cfg = replace(cfg, iters=args.iters)
    if args.log_jsonl:
        GLOBAL_LOG.path = args.log_jsonl

    report, _ = run_config(cfg, trace_dir=args.trace_dir, log=print)
    print(f"# {cfg.name} on {report['device']} "
          f"(copy rate {report['hbm_bw_gbps']:.0f} GB/s measured)")
    print(markdown_table(report["ops"],
                         ["op", "elapsed_ms", "sol_ms", "roofline_pct", "rows_per_sec"]))
    if args.json_out:
        emit_json(args.json_out, report)
    if args.check:
        import json
        import sys

        with open(args.check) as f:
            base = json.load(f)
        base_ops = {op["op"]: op for op in base.get("ops", [])}
        failed = []
        for op in report["ops"]:
            ref = base_ops.get(op["op"])
            if ref is None:
                continue
            floor = ref["rows_per_sec"] * (1.0 - args.tolerance)
            status = "OK" if op["rows_per_sec"] >= floor else "REGRESSED"
            print(f"check {op['op']}: {op['rows_per_sec']:.3e} rows/s vs "
                  f"baseline {ref['rows_per_sec']:.3e} (floor {floor:.3e}) {status}")
            if status != "OK":
                failed.append(op["op"])
        if failed:
            print(f"perf regression in: {', '.join(failed)}", file=sys.stderr)
            sys.exit(1)
    return report


if __name__ == "__main__":
    main()
