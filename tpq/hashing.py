"""C2 — SIMD-friendly multiplicative hashing (SURVEY.md §2.1 C2).

The reference uses multiplicative (Fibonacci/Knuth) hashing on int64 keys
(BASELINE.json:L5 "SIMD-friendly multiplicative hashing"). The hot path
hashes in 2xu32 lanes (SURVEY.md §7.4.4); a full-u64 path exists for
host/x64 checks.

All hash functions take a `salt` so independent passes (radix partition
levels, distributed owner mapping, table slots) decorrelate.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

# Knuth's multiplier: 2^64 / phi, odd.
PHI64 = 0x9E3779B97F4A7C15
# 32-bit golden-ratio multipliers (odd), distinct per lane.
PHI32_A = 0x9E3779B9
PHI32_B = 0x85EBCA6B
PHI32_C = 0xC2B2AE35


def hash_u64(keys: jnp.ndarray, bits: int, salt: int = 0) -> jnp.ndarray:
    """Full 64-bit Fibonacci hash -> top `bits` bits, as int32.

    Requires x64 mode (enabled at package import). Used at boundaries and
    as the reference implementation for the 32-bit path's tests.
    """
    k = keys.astype(jnp.uint64) ^ jnp.uint64(salt)
    h = k * jnp.uint64(PHI64)
    return (h >> jnp.uint64(64 - bits)).astype(jnp.int32)


def hash32_pair(lo: jnp.ndarray, hi: jnp.ndarray, salt: int = 0) -> jnp.ndarray:
    """Mix (lo, hi) u32 halves of an i64 key into one u32 hash.

    Pure 32-bit ops. murmur3-style
    finalizer over a golden-ratio combine; passes avalanche sanity tests
    (tests/test_hashing.py).
    """
    lo = lo.astype(jnp.uint32)
    hi = hi.astype(jnp.uint32)
    h = (lo ^ jnp.uint32(salt & 0xFFFFFFFF)) * jnp.uint32(PHI32_A)
    h = h ^ (hi * jnp.uint32(PHI32_B))
    h = h ^ (h >> jnp.uint32(16))
    h = h * jnp.uint32(PHI32_B)
    h = h ^ (h >> jnp.uint32(13))
    h = h * jnp.uint32(PHI32_C)
    h = h ^ (h >> jnp.uint32(16))
    return h


def split_i64(keys: jnp.ndarray) -> tuple[jnp.ndarray, jnp.ndarray]:
    """i64 -> (lo_u32, hi_u32) halves."""
    k = keys.astype(jnp.uint64)
    lo = (k & jnp.uint64(0xFFFFFFFF)).astype(jnp.uint32)
    hi = (k >> jnp.uint64(32)).astype(jnp.uint32)
    return lo, hi


def hash_keys(keys: jnp.ndarray, bits: int, salt: int = 0) -> jnp.ndarray:
    """Hash i64 keys -> int32 bucket ids in [0, 2^bits), 32-bit ops only
    after the initial split. The engine's standard bucket function."""
    lo, hi = split_i64(keys)
    h = hash32_pair(lo, hi, salt)
    return (h >> jnp.uint32(32 - bits)).astype(jnp.int32) if bits < 32 else h.astype(jnp.int32)


def np_hash_keys(keys: np.ndarray, bits: int, salt: int = 0) -> np.ndarray:
    """NumPy twin of hash_keys for host-side tests."""
    with np.errstate(over="ignore"):
        k = keys.astype(np.uint64)
        lo = (k & np.uint64(0xFFFFFFFF)).astype(np.uint32)
        hi = (k >> np.uint64(32)).astype(np.uint32)
        h = (lo ^ np.uint32(salt & 0xFFFFFFFF)) * np.uint32(PHI32_A)
        h = h ^ (hi * np.uint32(PHI32_B))
        h = h ^ (h >> np.uint32(16))
        h = h * np.uint32(PHI32_B)
        h = h ^ (h >> np.uint32(13))
        h = h * np.uint32(PHI32_C)
        h = h ^ (h >> np.uint32(16))
    if bits < 32:
        return (h >> np.uint32(32 - bits)).astype(np.int32)
    return h.astype(np.int32)
