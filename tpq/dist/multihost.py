"""Multi-host wiring (SURVEY.md §4.3, §5.8; BASELINE.json:L11 config 5).

On a multi-host cluster each host runs one Python process; calling
`init()` wires them into one JAX runtime, after which `jax.devices()`
spans every host and every mesh/shard_map/collective in tpq works
unchanged — mesh size is the ONLY difference between the 8-device
simulated run and an N-host run.

Nothing tells JAX of a cluster on its own: the coordinator address,
process count and process id follow the standard jax.distributed
contract, so a multi-host launch is a config change, not a code change.
"""

from __future__ import annotations

import os

import jax


def init(coordinator_address: str | None = None,
         num_processes: int | None = None,
         process_id: int | None = None) -> bool:
    """Initialize jax.distributed from args or TPQ_COORDINATOR /
    TPQ_NUM_PROCESSES / TPQ_PROCESS_ID env vars. Returns True if a
    multi-process runtime was initialized, False for the single-process
    no-op (absent coordinator => local run)."""
    coordinator_address = coordinator_address or os.environ.get("TPQ_COORDINATOR")
    if num_processes is None and "TPQ_NUM_PROCESSES" in os.environ:
        num_processes = int(os.environ["TPQ_NUM_PROCESSES"])
    if process_id is None and "TPQ_PROCESS_ID" in os.environ:
        process_id = int(os.environ["TPQ_PROCESS_ID"])
    if coordinator_address is None and num_processes is None:
        return False
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
    )
    return True
