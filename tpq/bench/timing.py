"""Device timing for the benchmarks: warm-up calls, then
`jax.block_until_ready` around each timed call, reporting the median.

JAX dispatches asynchronously, so a call returns before the device has
finished; blocking on the result inside the timed region is what makes
the host clock measure the device work. Warm-up calls take compilation
and first-touch allocation out of the window.
"""

from __future__ import annotations

import statistics
import time

import jax


def time_call(fn, args, warmup: int = 1, iters: int = 5):
    """Median seconds of `fn(*args)` over `iters` timed calls after
    `warmup` untimed ones. Returns (median_s, per-call seconds, the last
    call's output)."""
    if iters < 1:
        raise ValueError(f"iters must be >= 1, got {iters}")
    out = None
    for _ in range(warmup):
        out = jax.block_until_ready(fn(*args))
    samples = []
    for _ in range(iters):
        t0 = time.perf_counter()
        out = jax.block_until_ready(fn(*args))
        samples.append(time.perf_counter() - t0)
    return statistics.median(samples), samples, out
