"""Benchmark plumbing on the CPU: the measurement entry points refuse to
run without a GPU, and the timing helper blocks and reports the median."""

import time

import jax.numpy as jnp
import pytest

from tpq.bench.timing import time_call


def _bench_main():
    import bench

    bench.main()


def _runner_main():
    from tpq.bench.runner import main

    main([])


def _scale_bench_main():
    from tpq.bench.scale_bench import main

    main(["sweep"])


@pytest.mark.parametrize("entry", [_bench_main, _runner_main, _scale_bench_main],
                         ids=["bench", "runner", "scale_bench"])
def test_entry_points_refuse_cpu(entry, capsys):
    with pytest.raises(SystemExit) as e:
        entry()
    assert "no GPU" in str(e.value.code) and "cpu" in str(e.value.code)
    assert capsys.readouterr().out == ""


def test_time_call_reports_median_of_timed_calls():
    delays = iter([0.0, 0.01, 0.05, 0.03])  # first is the warm-up call
    calls = []

    def fn(x):
        d = next(delays)
        time.sleep(d)
        calls.append(d)
        return x + d

    med, samples, out = time_call(fn, (jnp.float32(1),), warmup=1, iters=3)
    assert len(calls) == 4 and len(samples) == 3
    assert 0.03 <= med < 0.05
    assert samples[0] < samples[1] and samples[2] < samples[1]
    assert float(out) == pytest.approx(1.03)
    with pytest.raises(ValueError):
        time_call(fn, (jnp.float32(1),), warmup=0, iters=0)
