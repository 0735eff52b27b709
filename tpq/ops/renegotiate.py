"""Capacity renegotiation — the engine's only "elasticity" (SURVEY.md §5.3).

Every operator uses static output capacities (SURVEY.md §7.3.3) and
surfaces overflow as `num_rows > capacity` instead of dynamic shapes.
This host-side wrapper closes the loop: run the jitted op, read the one
scalar back, and if the static capacity was exceeded re-run with the
capacity doubled (rounded to the true total when known). Deterministic —
the re-run recomputes from the same inputs; nothing is resumed.

Descends from the reference's implicit contract that a join always
returns its full result (oracle/main.cc writes every match); here the
price is one extra compile + run on the rare overflow, not dynamic
shapes in the hot path.
"""

from __future__ import annotations

from typing import Callable

from tpq.columnar import Table, next_pow2


def run_renegotiated(make_fn: Callable[[int], Callable[..., Table]],
                     args: tuple,
                     out_capacity: int,
                     max_retries: int = 8) -> Table:
    """Run `make_fn(capacity)(*args)` and grow capacity until the result
    fits.

    `make_fn(capacity)` must return a (jit-compatible) callable producing a
    Table whose `num_rows` is the TRUE total row count even when it exceeds
    the static capacity (all tpq operators guarantee this). Each retry uses
    capacity >= max(2*previous, true_total) so at most one retry happens
    when the operator reports exact totals.
    """
    cap = next_pow2(out_capacity)
    for _ in range(max_retries + 1):
        out = make_fn(cap)(*args)
        total = int(out.num_rows)  # host sync — this wrapper is host-side by design
        if total <= cap:
            return out
        cap = next_pow2(max(2 * cap, total))
    raise RuntimeError(
        f"renegotiation failed after {max_retries} retries (last capacity {cap})")
