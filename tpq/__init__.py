"""tpq — a vectorized query-execution engine on JAX.

Built from scratch against the capability set of dryman/HashMergeJoin
(reference mount empty — spec is BASELINE.json; see SURVEY.md §0):
hash join, sort-merge join, hash aggregate and filter over columnar SoA
batches, with a distributed shuffle exchange across a device mesh. Every
operator is plain `jnp`/`lax` compiled by XLA.

Layering (SURVEY.md §1.2):
  L1 columnar   — tpq.columnar
  L2 movement   — tpq.kernels.* (radix partition, PAD/PACK)
  L3 operators  — tpq.ops.*
  L4 distributed— tpq.dist.*
  L5 query      — tpq.query
  L6 bench      — tpq.bench.*

int64 keys are first-class: we enable jax_enable_x64 at import. Sorts,
gathers and sums move int64 columns as 2xu32 planes internally; i64 only
at boundaries.
"""

import os
from pathlib import Path

import jax

REPO_ROOT = Path(__file__).resolve().parent.parent


def compile_cache_dir() -> str:
    """The persistent compilation cache: `JAX_COMPILATION_CACHE_DIR` if
    set, else `<repo>/.jaxcache` (a fixed path, so later processes on the
    same checkout hit it)."""
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or str(REPO_ROOT / ".jaxcache")


jax.config.update("jax_enable_x64", True)
jax.config.update("jax_compilation_cache_dir", compile_cache_dir())
jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)

from tpq.columnar import Table  # noqa: E402,F401

__version__ = "0.1.0"
