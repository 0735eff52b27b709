"""Tiled associative scans — the form of every cap-length scan in the
engine.

A flat `associative_scan` over an N-row vector lowers to ~log2(N)
stages of odd-length slice/concat graphs, whose compile time grows with
N. `tiled_scan` decomposes an inclusive scan over any associative combiner
into: an axis-1 scan over [N/B, B] tiles (log2(B) stages of clean 2D
ops), a flat scan over the N/B block totals (small), and one broadcast
prefix-combine. Exact for any associative combiner — no identity
element needed (row 0 keeps its in-block scan; rows > 0 combine with
the previous block's running prefix).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

U32 = jnp.uint32
FLAT_MAX = 1 << 21  # rows; >= this, the tiled decomposition kicks in


def tiled_scan(comb, xs: tuple, block: int = 512) -> tuple:
    """Inclusive associative scan over equal-length 1-D operands.

    comb((a0..ak), (b0..bk)) -> (c0..ck) must be associative and
    elementwise (it is applied to 2-D tiles and broadcast (m,1)-vs-(m,B)
    in the prefix-combine step).

    Below FLAT_MAX rows, or when n is not a multiple of `block`, the
    flat form is used.
    """
    n = xs[0].shape[0]
    if n < FLAT_MAX or n % block:
        return tuple(jax.lax.associative_scan(comb, xs))
    m = n // block
    xs2 = tuple(x.reshape(m, block) for x in xs)
    cs = jax.lax.associative_scan(comb, xs2, axis=1)
    totals = tuple(c[:, -1] for c in cs)
    pref = jax.lax.associative_scan(comb, totals)  # inclusive, length m
    shifted = tuple(p[:-1, None] for p in pref)    # block i-1 prefix
    tail = tuple(c[1:] for c in cs)
    combined = comb(shifted, tail)
    out = tuple(
        jnp.concatenate([c[:1], cmb], axis=0).reshape(n)
        for c, cmb in zip(cs, combined))
    return out


def cummax_i32(x: jnp.ndarray, block: int = 512) -> jnp.ndarray:
    """Tiled jax.lax.cummax for int32 vectors."""
    (out,) = tiled_scan(lambda a, b: (jnp.maximum(a[0], b[0]),), (x,),
                        block=block)
    return out


def cumsum_i32(x: jnp.ndarray, block: int = 512) -> jnp.ndarray:
    """Tiled inclusive int32 cumsum (wraps mod 2^32, same as jnp.cumsum)."""
    (out,) = tiled_scan(lambda a, b: (a[0] + b[0],), (x,), block=block)
    return out


def u64_cumsum_planes(lo: jnp.ndarray, hi: jnp.ndarray,
                      block: int = 512):
    """Inclusive cumsum of u64 values held as (lo, hi) u32 planes.
    Bit-identical to jnp.cumsum on the u64 column (both wrap mod 2^64)."""

    def comb(a, b):
        lo_s = a[0] + b[0]
        carry = (lo_s < b[0]).astype(U32)
        return (lo_s, a[1] + b[1] + carry)

    return tiled_scan(comb, (lo, hi), block=block)


def fill_forward(sample_valid: jnp.ndarray, planes: list,
                 block: int = 512) -> list:
    """Per-plane fill-forward: position i gets plane values from the most
    recent j <= i with sample_valid[j]. Tiled form of the associative
    "last valid wins" scan; any number of planes."""

    def comb(a, b):
        av, bv = a[0], b[0]
        return (av | bv,) + tuple(jnp.where(bv, bx, ax)
                                  for ax, bx in zip(a[1:], b[1:]))

    res = tiled_scan(comb, (sample_valid, *planes), block=block)
    return list(res[1:])
