"""Benchmark entry: config-1 equi-join throughput on one NVIDIA GPU.

Prints ONE JSON line on stdout:
  {"metric": ..., "value": N, "unit": ..., "vs_baseline": N,
   "device": {"platform": ..., "device_kind": ..., "count": N}}

Headline (BASELINE.json:L2): single-card equi-join throughput on the
config-1 relation pair (uniform int64 1M x 1M, 1 payload col), probe-side
rows/s. The reference has no retrievable published numbers
(BASELINE.json:L13 "published": {}; BASELINE.md row 1), so vs_baseline is
defined against the byte-model time at the copy rate measured in the same
process x 80% (BASELINE.md rows 3/9/10). Exits nonzero, printing no
result, when JAX finds no GPU.

Everything else (per-op table, copy rate) goes to stderr.
"""

import json
import sys


def main():
    from tpq.bench import roofline
    from tpq.bench.device import require_gpu
    from tpq.bench.runner import run_config
    from tpq.config import PRESETS

    dev = require_gpu()
    hbm_bw = roofline.measure_hbm_bw(size_mb=256, iters=5)
    print(f"measured copy rate: {hbm_bw:.0f} GB/s on {dev}", file=sys.stderr)

    cfg = PRESETS["single_chip_1m"]
    report, _ = run_config(cfg, hbm_bw=hbm_bw)
    op = report["ops"][0]
    for line in json.dumps(report, indent=2, default=str).splitlines():
        print(line, file=sys.stderr)

    rows_per_sec = op["rows_per_sec"]
    # acceptance: >= 80% of the byte-model speed-of-light for this config
    sol_rows_per_sec = op["rows"] / (op["sol_ms"] / 1e3)
    vs_baseline = rows_per_sec / (0.8 * sol_rows_per_sec)
    print(json.dumps({
        "metric": "hash_join_probe_rows_per_sec_1chip",
        "value": round(rows_per_sec),
        "unit": "rows/s",
        "vs_baseline": round(vs_baseline, 4),
        "device": dev,
    }))


if __name__ == "__main__":
    main()
