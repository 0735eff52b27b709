"""Smoke test of tpq on NVIDIA GPUs, through the entry points a user calls.

    python chip_smoke.py             # one card: GPU tests + configs 1-4
    python chip_smoke.py --chips 4   # four cards: config 5's distributed
                                     # join and what it is compared with

Everything runs in this one process (a second JAX process could not open
the card). Each phase prints one line with its result and its time on
the card, beside the card's name and power limit; the last line is

    {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}

printed only when every phase passed. The script exits nonzero, printing
no such line, when JAX finds no GPU, when it is run outside a checkout of
the repository, or when any phase fails. Every comparison is exact: all
outputs are integers (keys, payloads, counts, wrapping int64 sums).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
import traceback
from pathlib import Path

REPO = Path(__file__).resolve().parent
ORACLE_SRC = REPO / "oracle" / "main.cc"
ORACLE_BIN = REPO / "oracle" / "build" / "oracle"

# Config 5 on four cards: rows per side. At 1B x 1B a card's program
# needs ~75 GB (arguments, outputs and the union sort's temporaries), more
# than the ~64 GB a JAX process gets; 2**29 per side (~38 GB a card) is
# the largest power-of-two scale that fits (PERF.md, "Cells").
MULTICHIP_ROWS = 1 << 29

DEFAULT_PHASES = ("device", "gpu_tests", "config1_single_chip_1m",
                  "config3_zipf_skew", "config4_pipeline_100m",
                  "config2_build_sweep_10m_100m")
MULTICHIP_PHASES = ("device", "config5_dist_4cards")


def contract_line(info: dict) -> str:
    """The last line of a passing run: exactly the contract's keys."""
    return json.dumps({"ok": True, "device": {
        "platform": info["platform"], "kind": info["device_kind"],
        "count": info["count"]}})


def select_phases(chips: int) -> tuple[str, ...]:
    if chips == 1:
        return DEFAULT_PHASES
    if chips == 4:
        return MULTICHIP_PHASES
    raise ValueError(f"--chips must be 1 or 4, got {chips}")


def run_phases(phases, info: dict, card: str) -> int:
    """Run (name, fn) phases in order; fn returns a result string. Prints
    one line per phase and, if all passed, the contract line. Returns the
    exit code."""
    failed = []
    for name, fn in phases:
        t0 = time.perf_counter()
        try:
            result = fn()
        except Exception:
            traceback.print_exc()
            failed.append(name)
            print(f"[{name}] FAILED after {time.perf_counter() - t0:.1f} s wall "
                  f"| {card}", flush=True)
            continue
        print(f"[{name}] ok: {result} ({time.perf_counter() - t0:.1f} s wall) "
              f"| {card}", flush=True)
    print(f"card: {card}", flush=True)
    if failed:
        print(f"chip_smoke: FAILED phases: {', '.join(failed)}", flush=True)
        return 1
    print(contract_line(info), flush=True)
    return 0


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------

def build_oracle() -> Path:
    """Build the C++ oracle (plain -O2) unless an up-to-date one exists."""
    srcs = sorted((REPO / "oracle").glob("*.cc")) + sorted((REPO / "oracle").glob("*.h"))
    if ORACLE_BIN.exists() and all(ORACLE_BIN.stat().st_mtime > f.stat().st_mtime
                                   for f in srcs):
        return ORACLE_BIN
    ORACLE_BIN.parent.mkdir(parents=True, exist_ok=True)
    subprocess.run(["g++", "-std=c++17", "-O2", "-Wall", "-o", str(ORACLE_BIN),
                    str(ORACLE_SRC)], check=True)
    return ORACLE_BIN


def oracle_join(r: dict, s: dict, workdir: Path, oracle: Path | None = None) -> dict:
    """`oracle join --algo=hash` on host columns; canonical-order output."""
    from tpq import colio

    pr, ps, po = (workdir / f"{n}.tpqc" for n in ("r", "s", "o"))
    colio.dump(str(pr), r)
    colio.dump(str(ps), s)
    subprocess.run([str(oracle or build_oracle()), "join", "--algo=hash", f"--left={pr}",
                    f"--right={ps}", f"--out={po}"], check=True)
    return colio.load(str(po))


def assert_equal(got: dict, want: dict, tag: str) -> None:
    """Byte equality of two canonical tables (names, dtypes, values)."""
    from tpq.columnar import tables_equal

    if not tables_equal(got, want):
        raise AssertionError(f"{tag}: differs from the reference "
                             f"({len(next(iter(got.values())))} vs "
                             f"{len(next(iter(want.values())))} rows)")


def _timing(report: dict) -> str:
    op = report["ops"][0]
    return (f"{op['elapsed_ms']:.3f} ms median on the card, "
            f"compile {report['compile_s']:.1f} s, "
            f"temp {_gb(report['memory'], 'temp_size_in_bytes')} GB")


def _gb(mem: dict | None, key: str) -> str:
    if not mem or key not in mem:
        return "n/a"
    return f"{mem[key] / 1e9:.2f}"


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def phase_device() -> str:
    import jax
    import jaxlib

    from tpq import compile_cache_dir

    return (f"{len(jax.devices())} x {jax.devices()[0].device_kind}; "
            f"jax {jax.__version__}, jaxlib {jaxlib.__version__}; "
            f"XLA_FLAGS={os.environ.get('XLA_FLAGS', '')!r}; "
            f"XLA_PYTHON_CLIENT_MEM_FRACTION="
            f"{os.environ.get('XLA_PYTHON_CLIENT_MEM_FRACTION', '(default)')}; "
            f"compile cache {compile_cache_dir()}")


def phase_gpu_tests() -> str:
    """tests/test_gpu.py in this process (no xdist: one process per card)."""
    import pytest

    class Tally:
        passed = failed = skipped = 0

        def pytest_runtest_logreport(self, report):
            if report.skipped:
                self.skipped += 1
            elif report.failed:
                self.failed += 1
            elif report.when == "call":
                self.passed += 1

    tally = Tally()
    t0 = time.perf_counter()
    rc = pytest.main(["-q", "-o", "addopts=", "-p", "no:xdist",
                      "-p", "no:cacheprovider", "--rootdir", str(REPO),
                      str(REPO / "tests" / "test_gpu.py")], plugins=[tally])
    if rc != 0 or tally.failed or tally.skipped or not tally.passed:
        raise RuntimeError(f"tests/test_gpu.py: exit {rc}, {tally.passed} passed, "
                           f"{tally.failed} failed, {tally.skipped} skipped")
    return (f"tests/test_gpu.py {tally.passed} passed "
            f"in {(time.perf_counter() - t0) * 1e3:.0f} ms")


def _join_vs_oracle(cfg_name: str, algos: tuple[str, ...]) -> str:
    from dataclasses import replace

    from tpq import datagen
    from tpq.bench.runner import run_config
    from tpq.columnar import canonicalize
    from tpq.config import PRESETS

    cfg = PRESETS[cfg_name]
    host = [datagen.gen_relation_np(sp.rows, sp.nkeys, sp.payloads, sp.seed,
                                    sp.kind, sp.theta) for sp in (cfg.r, cfg.s)]
    with tempfile.TemporaryDirectory() as d:
        expected = oracle_join(host[0], host[1], Path(d))
    parts = []
    for algo in algos:
        report, out = run_config(replace(cfg, join=replace(cfg.join, algo=algo)),
                                 log=print)
        if report["out_rows"] > report["out_capacity"]:
            raise AssertionError(f"{algo}: {report['out_rows']} rows overflow "
                                 f"capacity {report['out_capacity']}")
        assert_equal(canonicalize(out), expected, f"{cfg_name}/{algo}")
        parts.append(f"{algo}_join {report['out_rows']} rows byte-equal to the "
                     f"oracle, {_timing(report)}")
    return "; ".join(parts)


def phase_config1() -> str:
    """Config 1: 1M x 1M uniform int64, 1 payload; hash and merge joins."""
    return _join_vs_oracle("single_chip_1m", ("hash", "merge"))


def phase_config3() -> str:
    """Config 3: 1M uniform build x 1M Zipf(1.0) probe through hash_join."""
    return _join_vs_oracle("zipf_skew", ("hash",))


def phase_config4() -> str:
    """Config 4: filter -> join -> aggregate over the 100M-row fact table in
    one jitted call; the group table must equal the seed-stream truth."""
    from tpq.bench.runner import run_config
    from tpq.config import PRESETS
    from tpq.verify import assert_groups_equal, pipeline_expected_groups

    cfg = PRESETS["pipeline_100m"]
    report, out = run_config(cfg, log=print)
    got = out.to_numpy()
    expected = pipeline_expected_groups(cfg.r.rows, cfg.s.rows, cfg.s.payloads,
                                        cfg.filter_value, cfg.r.seed, cfg.s.seed)
    assert_groups_equal(got, expected)
    return (f"{cfg.s.rows} fact rows -> {len(got['key'])} groups exact vs the "
            f"seed streams, {_timing(report)}")


def phase_config2() -> str:
    """Config 2: 10M x 100M, 4 payloads, chunked, count-exact."""
    from tpq.bench.scale_bench import bench_build_sweep

    rep = bench_build_sweep(log=print)
    return (f"{rep['out_rows']} rows count-exact in {rep['nchunks']} chunks, "
            f"{rep['elapsed_ms']:.3f} ms on the card, "
            f"compile+warm {rep['compile_s']:.1f} s")


def dist_join_check(total_rows: int, n_dev: int, slices: int = 4,
                    workdir: Path | None = None,
                    oracle: Path | None = None) -> str:
    """Config 5's path at `total_rows` per side over make_mesh(n_dev):
    dist_hash_join_renegotiated with the default dense exchange, then an
    exact count from the seed streams and key-range slices against the
    oracle (tpq/verify.py)."""
    import numpy as np

    from tpq import datagen
    from tpq.bench.timing import time_call
    from tpq.columnar import canonical_order
    from tpq.config import PRESETS
    from tpq.dist.dist_join import (DistTable, dist_hash_join,
                                    dist_hash_join_renegotiated)
    from tpq.dist.mesh import make_mesh
    from tpq.verify import join_count, sample_key_ranges, slice_by_key

    cfg = PRESETS["dist_1b"]
    mesh = make_mesh(n_dev)
    r = datagen.gen_relation_np(total_rows, total_rows, cfg.r.payloads, cfg.r.seed)
    s = datagen.gen_relation_np(total_rows, total_rows, cfg.s.payloads, cfg.s.seed)
    R = DistTable.from_numpy(r, mesh)
    S = DistTable.from_numpy(s, mesh)
    for t in (R, S):  # one shard per card
        for col in t.columns.values():
            shards = col.addressable_shards
            if (len({sh.device for sh in shards}) != n_dev
                    or any(sh.data.shape[0] != t.local_capacity for sh in shards)):
                raise AssertionError("DistTable.from_numpy did not place one "
                                     "shard per device")
    expected = join_count(r["key"], s["key"], total_rows)
    per = R.local_capacity

    def round_up(x):
        return -(-int(x) // 1024) * 1024

    ex_cap = round_up(per / n_dev * 1.02 + 1024)
    out_cap = round_up(expected / n_dev * 1.02 + 1024)
    t0 = time.perf_counter()
    out, retries = dist_hash_join_renegotiated(
        R, S, mesh, out_capacity_per_shard=out_cap, exchange_capacity=ex_cap)
    first_s = time.perf_counter() - t0
    got = out.to_numpy()
    if len(got["key"]) != expected:
        raise AssertionError(f"{len(got['key'])} rows, expected {expected}")
    del out
    out_cap <<= retries
    ex_cap <<= retries

    def call():  # the program compiled above, from dist_hash_join's cache
        o, ovf = dist_hash_join(R, S, mesh, out_capacity_per_shard=out_cap,
                                exchange_capacity=ex_cap)
        return o.shard_rows, ovf

    dt, _, (rows, ovf) = time_call(call, (), warmup=1, iters=3)
    if int(np.asarray(ovf).sum()) or int(np.asarray(rows).sum()) != expected:
        raise AssertionError("timed run disagrees with the first")

    workdir = workdir or Path(tempfile.mkdtemp())
    for i, (lo, hi) in enumerate(sample_key_ranges(r["key"], n_ranges=slices,
                                                   target_rows=2048, seed=7)):
        wd = workdir / f"slice{i}"
        wd.mkdir(parents=True, exist_ok=True)
        want = oracle_join(slice_by_key(r, lo, hi), slice_by_key(s, lo, hi), wd,
                           oracle)
        assert_equal(canonical_order(slice_by_key(got, lo, hi)), want,
                     f"slice [{lo},{hi})")
    return (f"dense exchange: {total_rows} x {total_rows} over {n_dev} devices, "
            f"{expected} rows count-exact, {slices} key-range slices byte-equal "
            f"to the oracle, {dt * 1e3:.3f} ms median on the cards "
            f"(first call incl. compile {first_s:.1f} s, {retries} retries)")


def phase_config5() -> str:
    """Config 5 on four cards: the default dense exchange at
    MULTICHIP_ROWS per side."""
    return dist_join_check(MULTICHIP_ROWS, 4)


PHASES = {
    "device": phase_device,
    "gpu_tests": phase_gpu_tests,
    "config1_single_chip_1m": phase_config1,
    "config3_zipf_skew": phase_config3,
    "config4_pipeline_100m": phase_config4,
    "config2_build_sweep_10m_100m": phase_config2,
    "config5_dist_4cards": phase_config5,
}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--chips", type=int, default=1, choices=(1, 4),
                   help="1 (default): GPU tests and configs 1-4 on one card; "
                        "4: only config 5's distributed join on four cards")
    args = p.parse_args(argv)
    if not (REPO / "tpq" / "__init__.py").is_file():
        print(f"chip_smoke.py: no tpq package next to {Path(__file__).name}; "
              "run it from a checkout of the repository", file=sys.stderr)
        return 2
    # before JAX initialises: the test suite's conftest reads it
    os.environ["TPQ_TEST_PLATFORM"] = "gpu"
    if str(REPO) not in sys.path:
        sys.path.insert(0, str(REPO))
    from tpq.bench.device import card_name_and_power, require_gpu

    info = require_gpu(min_count=args.chips)
    card = card_name_and_power()
    return run_phases([(n, PHASES[n]) for n in select_phases(args.chips)],
                      info, card)


if __name__ == "__main__":
    sys.exit(main())
