"""C1 — columnar SoA Table/Batch types (SURVEY.md §2.1 C1).

A `Table` is a dict of equal-capacity 1-D device arrays plus a `num_rows`
scalar. Capacities are static (power-of-two padded) so every consumer jits
with fixed shapes; `num_rows` may be a traced device scalar. Rows at index
>= num_rows are padding with unspecified contents — operators mask by
num_rows, never by sentinel values.

Descends from the reference's relation structs (benchmark relations of
int64 keys + payload columns, BASELINE.json:L7-L8); redesigned as SoA
columns because XLA wants contiguous per-column vectors, not
array-of-struct rows.
"""

from __future__ import annotations

from typing import Iterable, Mapping

import jax
import jax.numpy as jnp
import numpy as np


def next_pow2(n: int) -> int:
    """Smallest power of two >= max(n, 8)."""
    n = max(int(n), 8)
    return 1 << (n - 1).bit_length()


@jax.tree_util.register_pytree_node_class
class Table:
    """SoA columnar batch: named 1-D columns + a row-count scalar.

    Invariants:
      * all columns share one static capacity (len of each array);
      * `num_rows` is an int32 scalar (python int or traced) <= capacity;
      * column insertion order is semantically meaningful (it defines the
        canonical lexicographic order used for oracle comparison).
    """

    __slots__ = ("columns", "num_rows")

    def __init__(self, columns: Mapping[str, jax.Array], num_rows):
        columns = dict(columns)
        if not columns:
            raise ValueError("Table needs at least one column")
        caps = {v.shape[0] for v in columns.values()}
        if len(caps) != 1:
            raise ValueError(f"column capacities differ: { {k: v.shape for k, v in columns.items()} }")
        self.columns = columns
        self.num_rows = jnp.asarray(num_rows, jnp.int32)

    # -- pytree protocol ---------------------------------------------------
    def tree_flatten(self):
        names = tuple(self.columns.keys())
        return (tuple(self.columns[n] for n in names), self.num_rows), names

    @classmethod
    def tree_unflatten(cls, names, children):
        cols, num_rows = children
        obj = object.__new__(cls)
        obj.columns = dict(zip(names, cols))
        obj.num_rows = num_rows
        return obj

    # -- basic accessors ---------------------------------------------------
    @property
    def capacity(self) -> int:
        return next(iter(self.columns.values())).shape[0]

    @property
    def names(self) -> tuple[str, ...]:
        return tuple(self.columns.keys())

    def col(self, name: str) -> jax.Array:
        return self.columns[name]

    def __repr__(self):
        cols = ", ".join(f"{k}:{v.dtype}" for k, v in self.columns.items())
        return f"Table(cap={self.capacity}, num_rows={self.num_rows}, [{cols}])"

    # -- construction ------------------------------------------------------
    @classmethod
    def from_numpy(cls, columns: Mapping[str, np.ndarray], capacity: int | None = None) -> "Table":
        """Host import: pads every column to a shared pow2 capacity."""
        columns = dict(columns)
        n = len(next(iter(columns.values())))
        cap = capacity if capacity is not None else next_pow2(n)
        if cap < n:
            raise ValueError(f"capacity {cap} < rows {n}")
        out = {}
        for k, v in columns.items():
            v = np.asarray(v)
            if v.ndim != 1 or len(v) != n:
                raise ValueError(f"column {k}: want 1-D of len {n}, got {v.shape}")
            buf = np.zeros(cap, dtype=v.dtype)
            buf[:n] = v
            out[k] = jnp.asarray(buf)
        return cls(out, n)

    def to_numpy(self) -> dict[str, np.ndarray]:
        """Host export, trimmed to num_rows (forces a device sync)."""
        n = int(self.num_rows)
        return {k: np.asarray(v)[:n] for k, v in self.columns.items()}

    # -- shape utilities ---------------------------------------------------
    def valid_mask(self) -> jax.Array:
        """bool[capacity], True for live rows."""
        return jnp.arange(self.capacity, dtype=jnp.int32) < self.num_rows

    def with_padding(self, fills: Mapping[str, object]) -> "Table":
        """Returns a Table whose padding region is set to given fill values
        (per column). Columns not named keep their padding as-is."""
        mask = self.valid_mask()
        cols = {}
        for k, v in self.columns.items():
            if k in fills:
                cols[k] = jnp.where(mask, v, jnp.asarray(fills[k], v.dtype))
            else:
                cols[k] = v
        return Table(cols, self.num_rows)

    def select(self, names: Iterable[str]) -> "Table":
        return Table({n: self.columns[n] for n in names}, self.num_rows)

    def rename(self, mapping: Mapping[str, str]) -> "Table":
        return Table({mapping.get(k, k): v for k, v in self.columns.items()}, self.num_rows)

    def gather(self, idx: jax.Array, num_rows) -> "Table":
        """New table whose row i is self row idx[i]; capacity = len(idx)."""
        return Table({k: v[idx] for k, v in self.columns.items()}, num_rows)

    def with_capacity(self, capacity: int) -> "Table":
        """Grow (zero-pad) or shrink (must not cut live rows — caller's duty
        when num_rows is traced; checked when concrete) the static capacity."""
        cap = self.capacity
        if capacity == cap:
            return self
        cols = {}
        for k, v in self.columns.items():
            if capacity > cap:
                cols[k] = jnp.concatenate([v, jnp.zeros(capacity - cap, v.dtype)])
            else:
                cols[k] = v[:capacity]
        return Table(cols, jnp.minimum(self.num_rows, capacity))


# ---------------------------------------------------------------------------
# canonical order (oracle contract, SURVEY.md §4.4)
# ---------------------------------------------------------------------------

def canonicalize(table: Table) -> dict[str, np.ndarray]:
    """Host-side canonical form: rows lexicographically sorted by columns in
    insertion order (first column = primary). Byte-equality of this form is
    the bit-exactness contract vs the C++ oracle (oracle/join.cc emits the
    same ordering)."""
    return canonical_order(table.to_numpy())


def canonical_order(cols: dict[str, np.ndarray]) -> dict[str, np.ndarray]:
    """Host columns sorted lexicographically by columns in insertion order."""
    names = list(cols.keys())
    if names:
        # np.lexsort: last key is primary -> reverse
        order = np.lexsort(tuple(cols[n] for n in reversed(names)))
        cols = {n: cols[n][order] for n in names}
    return cols


def tables_equal(a: dict[str, np.ndarray], b: dict[str, np.ndarray]) -> bool:
    if list(a.keys()) != list(b.keys()):
        return False
    return all(
        a[k].dtype == b[k].dtype and a[k].shape == b[k].shape and np.array_equal(a[k], b[k])
        for k in a
    )
