"""B2 — per-operator speed-of-light roofline accounting
(BASELINE.json:L5 "per-operator speed-of-light roofline accounting
(bytes moved vs HBM BW)"; SURVEY.md §2.4 B2, §6).

Two halves:
  * measure_hbm_bw(): the copy rate a streaming elementwise kernel
    reaches on the device the process runs on, measured in the same
    process as the operator it is compared with;
  * analytic per-operator byte models: minimum device-memory traffic
    each operator must move given relation shapes, from which measured
    wall-clock yields a % of that copy rate.

Byte models follow BASELINE.md derivations D1-D3 (padding slots do move
bytes and are charged — models take static capacities, not logical
rows, so the roofline is honest about padding).
"""

from __future__ import annotations

from dataclasses import dataclass

import jax
import jax.numpy as jnp


def measure_hbm_bw(size_mb: int = 256, iters: int = 10) -> float:
    """Device-memory read+write GB/s of a saxpy-style streaming kernel
    over `size_mb` MiB, median of `iters` timed calls."""
    from tpq.bench.timing import time_call

    n = size_mb * 1024 * 1024 // 4
    x = jnp.arange(n, dtype=jnp.float32)

    @jax.jit
    def stream(x):
        return x * 1.0000001 + 1.0

    sec, _, _ = time_call(stream, (x,), warmup=2, iters=iters)
    bytes_moved = 2 * n * 4  # read + write
    return bytes_moved / sec / 1e9


@dataclass(frozen=True)
class OpBytes:
    """Minimum HBM bytes one operator execution must move."""

    read: int
    write: int

    @property
    def total(self) -> int:
        return self.read + self.write


def row_bytes(ncols: int, itemsize: int = 8) -> int:
    return ncols * itemsize


def filter_bytes(cap_in: int, ncols: int) -> OpBytes:
    # read every column once, write the compacted copy once
    b = row_bytes(ncols)
    return OpBytes(read=cap_in * b, write=cap_in * b)


def probe_bytes(cap_probe: int, ncols_probe: int, cap_out: int, ncols_out: int) -> OpBytes:
    """D1: probe streams the probe side once and writes the output once
    (the build side is charged by the caller)."""
    return OpBytes(read=cap_probe * row_bytes(ncols_probe), write=cap_out * row_bytes(ncols_out))


def partition_bytes(cap: int, ncols: int, passes: int = 1) -> OpBytes:
    """D2: each radix pass reads and rewrites every column."""
    b = cap * row_bytes(ncols) * passes
    return OpBytes(read=b, write=b)


def sort_bytes(cap: int, ncols: int, passes: int) -> OpBytes:
    """Radix sort = `passes` full read+write sweeps over (key + permuted
    columns)."""
    b = cap * row_bytes(ncols) * passes
    return OpBytes(read=b, write=b)


def hash_join_bytes(cap_r: int, ncols_r: int, cap_s: int, ncols_s: int,
                    cap_out: int, partition_passes: int = 1) -> dict[str, OpBytes]:
    """Per-phase byte model of the partitioned hash join (SURVEY.md §3.2):
    partition both sides, build (read R once), probe (stream S, write out)."""
    ncols_out = 1 + (ncols_r - 1) + (ncols_s - 1)
    return {
        "partition_r": partition_bytes(cap_r, ncols_r, partition_passes),
        "partition_s": partition_bytes(cap_s, ncols_s, partition_passes),
        "build": OpBytes(read=cap_r * row_bytes(ncols_r), write=0),
        "probe": probe_bytes(cap_s, ncols_s, cap_out, ncols_out),
    }


def merge_join_bytes(cap_r: int, ncols_r: int, cap_s: int, ncols_s: int,
                     cap_out: int, sort_passes: int = 6) -> dict[str, OpBytes]:
    ncols_out = 1 + (ncols_r - 1) + (ncols_s - 1)
    return {
        "sort_r": sort_bytes(cap_r, ncols_r, sort_passes),
        "merge": OpBytes(read=cap_s * row_bytes(ncols_s) + cap_r * row_bytes(ncols_r),
                         write=cap_out * row_bytes(ncols_out)),
    }


def aggregate_bytes(cap: int, ncols: int) -> OpBytes:
    # read input once; output (groups) bounded by input capacity
    b = cap * row_bytes(ncols)
    return OpBytes(read=b, write=cap * row_bytes(ncols + 1))


@dataclass
class RooflineResult:
    op: str
    elapsed_s: float
    bytes_model: int
    hbm_bw_gbps: float
    rows: int

    @property
    def achieved_gbps(self) -> float:
        return self.bytes_model / self.elapsed_s / 1e9

    @property
    def roofline_frac(self) -> float:
        return self.achieved_gbps / self.hbm_bw_gbps

    @property
    def sol_time_s(self) -> float:
        return self.bytes_model / (self.hbm_bw_gbps * 1e9)

    def row(self) -> dict:
        return {
            "op": self.op,
            "elapsed_ms": self.elapsed_s * 1e3,
            "sol_ms": self.sol_time_s * 1e3,
            "model_bytes": self.bytes_model,
            "achieved_gbps": self.achieved_gbps,
            "hbm_bw_gbps": self.hbm_bw_gbps,
            "roofline_pct": 100.0 * self.roofline_frac,
            "rows": self.rows,
            "rows_per_sec": self.rows / self.elapsed_s if self.elapsed_s else 0.0,
        }
