"""D1 — device mesh + hash-partitioned table placement (SURVEY.md §2.2 D1).

"tables hash-partitioned per chip" (BASELINE.json:L5): row ownership is
owner(key) = hash(key) mod nchips, with a dedicated salt so the owner
mapping is independent of the radix-partition and table-slot hashes
(C2's hash-family parameterization).

The communication backend IS the XLA collective set reached through
shard_map on this mesh (SURVEY.md §5.8). The cards of one host are
joined all to all, so the mesh is 1-D and follows the algorithm.
Multi-host: `jax.distributed.initialize` per host changes only
`jax.devices()`; mesh construction is identical.
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from tpq.hashing import hash_keys

OWNER_SALT = 0xC41C0DE5

AXIS = "x"


def make_mesh(n_devices: int | None = None, axis: str = AXIS) -> Mesh:
    devs = jax.devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    return Mesh(np.array(devs), (axis,))


def row_sharding(mesh: Mesh, axis: str = AXIS) -> NamedSharding:
    """Rows split across chips (partitioned parallelism — the DP analog,
    SURVEY.md §2.2 checklist)."""
    return NamedSharding(mesh, P(axis))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def owner_of(keys, nchips: int):
    """Destination chip per row: top bits of the salted 32-bit hash,
    reduced mod nchips. Pow2 nchips uses a cheap mask."""
    h = hash_keys(keys, 32, salt=OWNER_SALT)
    if nchips & (nchips - 1) == 0:
        return (h & (nchips - 1)).astype(jax.numpy.int32)
    return (h.astype(jax.numpy.uint32) % jax.numpy.uint32(nchips)).astype(jax.numpy.int32)
