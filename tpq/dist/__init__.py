"""L4 distributed: mesh placement, shuffle exchange, skew handling,
distributed join (SURVEY.md §2.2 D1-D5). The reference is single-node
shared-memory; everything here is new scope mandated by
BASELINE.json:L5,L11."""

from tpq.dist.mesh import make_mesh, owner_of  # noqa: F401
from tpq.dist.dist_join import dist_hash_join  # noqa: F401
